"""Kernels of the serving and training paths and the MSDA core around them.

`gather.quad_gather` (with its backward `gather.quad_scatter`) and
`msda_kernel.msda_forward` launch hand-written CUDA kernels (`csrc/`) on
CUDA tensors and run their plain PyTorch versions on CPU tensors; `_build`
compiles the kernels at first use.
"""

from .gather import quad_gather, quad_scatter
from .msda import (
    ms_deform_attn,
    ms_deform_attn_core,
    ms_deform_attn_core_naive,
    ms_deform_attn_core_prequad,
    precompute_quad_slab,
)
from .msda_kernel import ms_deform_attn_pallas, msda_forward

__all__ = [
    "quad_gather", "quad_scatter", "msda_forward", "ms_deform_attn",
    "ms_deform_attn_core", "ms_deform_attn_core_naive",
    "ms_deform_attn_core_prequad", "precompute_quad_slab",
    "ms_deform_attn_pallas",
]
