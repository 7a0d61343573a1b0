"""Model modules of the serving path."""

from .cape import CAPE, autoregressive_decode, level_shapes

__all__ = ["CAPE", "autoregressive_decode", "level_shapes"]
