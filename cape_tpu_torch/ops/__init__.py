"""Kernels of the serving and training paths and the MSDA core around them.

`gather.quad_gather` (with its backward `gather.quad_scatter`),
`msda_kernel.msda_forward`, `msda_kernel.msda_backward`, the Swin
backbone's `window_attn.window_attention` and the ViTDet backbone's
`rel_attn.rel_attention` (forward and backward each) and the decode's
`decode_step.layer_step` (one v1 decoder layer's step) launch
hand-written CUDA kernels (`csrc/`) on CUDA tensors and run their plain
PyTorch versions on CPU tensors; `_build` compiles the kernels at first
use.
"""

from .gather import quad_gather, quad_scatter
from .msda import (
    ms_deform_attn,
    ms_deform_attn_core,
    ms_deform_attn_core_naive,
    ms_deform_attn_core_prequad,
    precompute_quad_slab,
)
from .msda_kernel import ms_deform_attn_pallas, msda_backward, msda_forward
from .rel_attn import rel_attention
from .window_attn import window_attention



def launch_counters():
    """Every kernel's launch counter: name -> (its wrapper, the wrapper's
    counter attribute). A wrapper adds one where it launches its kernel;
    a replayed CUDA graph adds the launches it holds (`graphs`)."""
    from . import (decode_step, gather, msda_fused, msda_kernel, rel_attn,
                   window_attn)

    return {"quad_gather": (gather.quad_gather, "launches"),
            "quad_scatter": (gather.quad_scatter, "launches"),
            "msda_forward": (msda_kernel.msda_forward, "launches"),
            "msda_backward": (msda_kernel.msda_backward, "launches"),
            "fused_fwd": (msda_fused.fused_level_sample, "launches"),
            "fused_bwd": (msda_fused.fused_level_sample, "bwd_launches"),
            "quadfused_fwd": (msda_fused.quadfused_level_sample, "launches"),
            "quadfused_bwd": (msda_fused.quadfused_level_sample,
                              "bwd_launches"),
            "window_attn_fwd": (window_attn.window_attn_forward,
                                "launches"),
            "window_attn_bwd": (window_attn.window_attn_backward,
                                "launches"),
            "rel_attn_fwd": (rel_attn.rel_attn_forward, "launches"),
            "rel_attn_bwd": (rel_attn.rel_attn_backward, "launches"),
            "decode_layer": (decode_step.layer_step, "launches")}


__all__ = [
    "launch_counters",
    "quad_gather", "quad_scatter", "msda_forward", "msda_backward",
    "ms_deform_attn",
    "ms_deform_attn_core", "ms_deform_attn_core_naive",
    "ms_deform_attn_core_prequad", "precompute_quad_slab",
    "ms_deform_attn_pallas", "rel_attention", "window_attention",
]
