"""cape_tpu_torch — the PyTorch/CUDA port of `cape_tpu` for NVIDIA Hopper.

Two slices are ported: the serving path (ResNet-50 -> deformable encoder
-> geometric support encoder -> KV-cached autoregressive decode ->
`CAPEPredictor.predict`) and the teacher-forced training step
(`CAPE.forward`, `losses`, `train`), with hand-written CUDA kernels
(`ops/csrc/`) for the three MSDA Pallas kernels they run: the gather, its
scatter backward and the whole-op forward. The package imports PyTorch and
numpy only: nothing of JAX and nothing of `cape_tpu`. Entry points run on
the card (`device="cuda"`) unless the caller passes `device="cpu"`, where
every kernel runs its plain PyTorch version.
"""

from .config import CAPEConfig, tiny_test_config
from .models.cape import CAPE, autoregressive_decode
from .serve import CAPEPredictor

__all__ = ["CAPEConfig", "tiny_test_config", "CAPE", "autoregressive_decode",
           "CAPEPredictor"]
