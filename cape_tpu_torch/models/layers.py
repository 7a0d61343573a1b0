"""Layers with the JAX package's dtype semantics, and seeded initialisers.

Flax modules compute in their `dtype`: a `Dense(dtype=bf16)` casts its
input to bf16, a `LayerNorm(dtype=bf16)` normalises in fp32 and returns
bf16. The decoder relies on that (its token embedding comes out fp32 and
meets bf16 layers), so `Dense` and `LayerNorm` here cast the same way.
A module's dtype is the dtype of its parameters.

Initialisers draw from an explicit CPU `torch.Generator`, so a seed gives
the same weights on the CPU and on the card. Dropout draws its masks from
the explicit generator a training call passes down (never the global RNG);
`generator=None` is the JAX package's `deterministic=True`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class Dense(nn.Linear):
    """`nn.Linear` that casts its input to the weight dtype (flax Dense)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm(eps=1e-5)` returning the weight dtype; an input of
    another dtype is normalised in fp32 (flax LayerNorm)."""

    def __init__(self, d: int):
        super().__init__(d, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.weight.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate); the identity when `generator` is None or
    the rate is 0. The mask is drawn from `generator` on `x`'s device."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    if keep <= 0.0:
        return torch.zeros_like(x)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


# -- seeded initialisers (draw on the CPU, copy into the parameter) -------
def _fill(p: torch.Tensor, value: torch.Tensor) -> None:
    with torch.no_grad():
        p.copy_(value.to(p.dtype))


def normal_(p: torch.Tensor, std: float, g: torch.Generator) -> None:
    _fill(p, torch.randn(p.shape, generator=g) * std)


def zeros_(p: torch.Tensor) -> None:
    with torch.no_grad():
        p.zero_()


def ones_(p: torch.Tensor) -> None:
    with torch.no_grad():
        p.fill_(1.0)


def _fans(w: torch.Tensor):
    """(fan_in, fan_out) of a Linear (out, in) or Conv (O, I, kh, kw)."""
    rf = w[0, 0].numel() if w.dim() > 2 else 1
    return w.shape[1] * rf, w.shape[0] * rf


def lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's default Dense kernel init (normal, var 1/fan_in)."""
    normal_(w, math.sqrt(1.0 / _fans(w)[0]), g)


def he_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax `he_normal` (normal, var 2/fan_in): the backbone convs."""
    normal_(w, math.sqrt(2.0 / _fans(w)[0]), g)


def xavier_uniform_(w: torch.Tensor, g: torch.Generator) -> None:
    fan_in, fan_out = _fans(w)
    a = math.sqrt(6.0 / (fan_in + fan_out))
    _fill(w, (torch.rand(w.shape, generator=g) * 2 - 1) * a)


def default_init_(module: nn.Module, g: torch.Generator) -> None:
    """flax's defaults on every layer of `module`: Dense/Conv kernels
    lecun normal (convs without bias are re-initialised by the backbone),
    biases zero, norm scales one; modules with an `init_weights(g)` then
    apply their own (the behaviour-setting inits of the JAX package)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, g)
            if m.bias is not None:
                zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            ones_(m.weight)
            zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, 1.0, g)
    for m in module.modules():
        init = getattr(m, "init_weights", None)
        if init is not None:
            init(g)
