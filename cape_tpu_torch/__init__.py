"""cape_tpu_torch — the PyTorch/CUDA port of `cape_tpu` for NVIDIA Hopper.

Four paths are ported: the serving path (ResNet-50 -> deformable encoder
-> geometric support encoder -> KV-cached autoregressive decode ->
`CAPEPredictor.predict`), the teacher-forced training step
(`CAPE.forward`, `losses`, `train`), the evaluation path (MP-100
episodes on disk -> `data` -> `eval.evaluate_cape` -> PCK@0.2) and the
training entry point (`cli.train` -> `train.loop.train_loop` with the
train-time augmentation and checkpoints; `cli.evaluate`, `cli.visualize`,
`CAPEPredictor.from_checkpoint`), with
hand-written CUDA kernels (`ops/csrc/`) for the seven Pallas kernels of
`cape_tpu`. The package imports PyTorch and numpy only: nothing of JAX and
nothing of `cape_tpu`. Entry points run on the card (`device="cuda"`)
unless the caller passes `device="cpu"`, where every kernel runs its plain
PyTorch version.
"""

from .config import CAPEConfig, tiny_test_config
from .models.cape import CAPE, autoregressive_decode
from .serve import CAPEPredictor

__all__ = ["CAPEConfig", "tiny_test_config", "CAPE", "autoregressive_decode",
           "CAPEPredictor"]
