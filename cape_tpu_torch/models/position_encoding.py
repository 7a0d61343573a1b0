"""Positional encodings: the port of `cape_tpu.models.position_encoding`.

- `image_sine_pe_2d`: `PositionEmbeddingSine` with an all-valid mask
  (numpy; a function of (h, w) only, since every image is a fixed square).
- `interleaved_1d_table`: support-encoder sequence PE (numpy).
- `coords_sine_embed`: sine embedding of support (x, y), [pos_y | pos_x].
- `query_sine_embed`: decoder query PE from reference points.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def image_sine_pe_2d(h: int, w: int, d_model: int, temperature: float = 10000.0,
                     scale: float = 2 * math.pi) -> np.ndarray:
    """(h, w, d_model) sine PE for a fully-valid feature map."""
    num_pos_feats = d_model // 2
    y_embed = np.arange(1, h + 1, dtype=np.float32)[:, None] * np.ones((1, w), np.float32)
    x_embed = np.ones((h, 1), np.float32) * np.arange(1, w + 1, dtype=np.float32)[None, :]
    eps = 1e-6
    y_embed = (y_embed - 0.5) / (y_embed[-1:, :] + eps) * scale
    x_embed = (x_embed - 0.5) / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])], axis=3
                     ).reshape(h, w, num_pos_feats)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])], axis=3
                     ).reshape(h, w, num_pos_feats)
    return np.concatenate([pos_y, pos_x], axis=2)


def interleaved_1d_table(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) table, sin/cos interleaved (torch-tutorial style)."""
    pe = np.zeros((max_len, d_model), np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def _dim_t(num_feats: int, temperature: float,
           device: torch.device) -> torch.Tensor:
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                           / num_feats)


def _interleave(p: torch.Tensor) -> torch.Tensor:
    """sin of even dims / cos of odd dims, interleaved along the last."""
    out = torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                      dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1])


def coords_sine_embed(coords: torch.Tensor, num_feats: int,
                      temperature: float = 10000.0,
                      scale: float = 2 * math.pi) -> torch.Tensor:
    """Sine embedding of continuous (x, y) in [0,1].

    Args:
        coords: (..., 2) with (x, y) order.
    Returns:
        (..., 2*num_feats) = concat(pos_y, pos_x).
    """
    coords = coords.float()
    dim_t = _dim_t(num_feats, temperature, coords.device)
    px = (coords[..., 0] * scale)[..., None] / dim_t
    py = (coords[..., 1] * scale)[..., None] / dim_t
    return torch.cat([_interleave(py), _interleave(px)], dim=-1)


def query_sine_embed(ref_points: torch.Tensor, num_pos_feats: int = 128,
                     temperature: float = 10000.0) -> torch.Tensor:
    """Decoder query PE of reference points.

    Args:
        ref_points: (..., 2) in [0,1].
    Returns:
        (..., 2*num_pos_feats), coordinate-major layout matching
        `get_query_pos_embed` (`deformable_transformer_v2.py:1006-1021`).
    """
    dim_t = _dim_t(num_pos_feats, temperature, ref_points.device)
    pos = (ref_points.float() * (2 * math.pi))[..., None] / dim_t  # (..., 2, F)
    out = _interleave(pos)
    return out.reshape(*ref_points.shape[:-1], 2 * num_pos_feats)
