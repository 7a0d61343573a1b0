"""Kernels of the serving path and the MSDA core around them.

`gather.quad_gather` and `msda_kernel.msda_forward` launch hand-written
CUDA kernels (`csrc/`) on CUDA tensors and run their plain PyTorch
versions on CPU tensors; `_build` compiles the kernels at first use.
"""

from .gather import quad_gather
from .msda import (
    ms_deform_attn,
    ms_deform_attn_core,
    ms_deform_attn_core_naive,
    ms_deform_attn_core_prequad,
    precompute_quad_slab,
)
from .msda_kernel import ms_deform_attn_pallas, msda_forward

__all__ = [
    "quad_gather", "msda_forward", "ms_deform_attn", "ms_deform_attn_core",
    "ms_deform_attn_core_naive", "ms_deform_attn_core_prequad",
    "precompute_quad_slab", "ms_deform_attn_pallas",
]
