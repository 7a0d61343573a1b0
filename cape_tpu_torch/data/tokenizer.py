"""Discrete coordinate tokenizer: the vocabulary layout and special ids.

Copy of `cape_tpu.data.tokenizer.DiscreteTokenizer` (the port imports
nothing of `cape_tpu`). Vocab layout: `num_bins^2` grid cells, then
BOS/EOS/SEP/PAD specials (`datasets/discrete_tokenizer.py:20-28`); the
flattened 2D index is `x_idx * num_bins + y_idx` (x-major,
`mp100_cape.py:709-713`). The serving path re-tokenizes on the device
(`models/cape.autoregressive_decode`); training targets come from the
host-side `tokenize_keypoints` (numpy), a copy of the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .token_types import TokenType


@dataclass(frozen=True)
class DiscreteTokenizer:
    """Vocabulary layout + special token ids.

    `num_bins` bins per axis; grid-cell ids occupy [0, num_bins^2) and the
    four specials follow (`discrete_tokenizer.py:16-28`, add_cls is never
    used for CAPE).
    """

    num_bins: int
    seq_len: int

    @property
    def bos(self) -> int:
        return self.num_bins * self.num_bins + 0

    @property
    def eos(self) -> int:
        return self.num_bins * self.num_bins + 1

    @property
    def sep(self) -> int:
        return self.num_bins * self.num_bins + 2

    @property
    def pad(self) -> int:
        return self.num_bins * self.num_bins + 3

    @property
    def vocab_size(self) -> int:
        return self.num_bins * self.num_bins + 4

    def __len__(self) -> int:
        return self.vocab_size

    # ------------------------------------------------------------------
    def quantize(self, coords01: np.ndarray) -> np.ndarray:
        """[0,1] coordinates -> continuous grid coordinates in [0, num_bins-1]."""
        q = np.asarray(coords01, dtype=np.float64) * (self.num_bins - 1)
        return np.clip(q, 0.0, self.num_bins - 1)

    def corner_ids(self, q: np.ndarray):
        """4-corner flattened ids + fractional deltas for quantized coords.

        Args:
            q: (..., 2) continuous grid coords in [0, num_bins-1].
        Returns:
            (idx11, idx21, idx12, idx22, dx, dy) where idxAB uses A=x corner
            (1=floor, 2=ceil), B=y corner; dx/dy are x/y fractional parts.
            Index formula matches `mp100_cape.py:709-713`.
        """
        nb = self.num_bins
        xf = np.clip(np.floor(q[..., 0]), 0, nb - 1).astype(np.int32)
        yf = np.clip(np.floor(q[..., 1]), 0, nb - 1).astype(np.int32)
        xc = np.clip(np.ceil(q[..., 0]), 0, nb - 1).astype(np.int32)
        yc = np.clip(np.ceil(q[..., 1]), 0, nb - 1).astype(np.int32)
        idx11 = xf * nb + yf
        idx21 = xc * nb + yf
        idx12 = xf * nb + yc
        idx22 = xc * nb + yc
        dx = (q[..., 0] - xf).astype(np.float32)
        dy = (q[..., 1] - yf).astype(np.float32)
        return idx11, idx21, idx12, idx22, dx, dy

    def detokenize(self, idx11: np.ndarray, dx: np.ndarray, dy: np.ndarray) -> np.ndarray:
        """Inverse of quantize+corner_ids for round-trip testing."""
        nb = self.num_bins
        xf = idx11 // nb
        yf = idx11 % nb
        x = (xf + dx) / (nb - 1)
        y = (yf + dy) / (nb - 1)
        return np.stack([x, y], axis=-1)


def tokenize_keypoints(
    tokenizer: DiscreteTokenizer,
    keypoints: np.ndarray,
    height: float,
    width: float,
    visibility: Optional[np.ndarray] = None,
    category_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Build the full 14-key sequence-target dict for one instance.

    Parity with `MP100CAPE._tokenize_keypoints` (`mp100_cape.py:625-832`).
    ALL keypoints (including invisible ones) are tokenized so indices stay
    aligned with skeleton edges; visibility only gates the loss.

    Args:
        keypoints: (N, 2) pixel coordinates relative to the (cropped) image.
        height/width: image dims used for [0,1] normalization.
        visibility: (N,) COCO flags (0 unlabeled / 1 occluded / 2 visible);
            defaults to all-visible.
    Returns:
        dict of numpy arrays, every sequence of shape (seq_len,) except
        `target_seq` of (seq_len, 2):
        seq11/seq21/seq12/seq22 (int32 input token ids, BOS-prefixed),
        delta_{x,y}{1,2} (float32), target_seq (float32 coords in [0,1]),
        token_labels (int32, -1 pad), mask (bool valid-token),
        visibility_mask (bool, loss gate), target_polygon_labels (int32).
    """
    L = tokenizer.seq_len
    kpts = np.asarray(keypoints, dtype=np.float64).reshape(-1, 2)
    n = kpts.shape[0]
    if visibility is None:
        visibility = np.full((n,), 2, dtype=np.int32)
    visibility = np.asarray(visibility).reshape(-1).astype(np.int32)
    if visibility.shape[0] != n:
        raise ValueError(
            f"visibility length {visibility.shape[0]} != keypoints {n}"
        )
    # 1 BOS + n coords + 1 trailing SEP->EOS must fit the static length.
    if n + 2 > L:
        raise ValueError(
            f"{n} keypoints need {n + 2} tokens but seq_len={L}"
        )

    norm = kpts / np.array([width, height], dtype=np.float64)
    q = tokenizer.quantize(norm)
    idx11, idx21, idx12, idx22, dx, dy = tokenizer.corner_ids(q)

    def seq_of(ids: np.ndarray) -> np.ndarray:
        s = np.full((L,), tokenizer.pad, dtype=np.int32)
        s[0] = tokenizer.bos
        s[1 : 1 + n] = ids
        return s

    # token_labels: coord for each keypoint, then the trailing SEP converted
    # to EOS (`mp100_cape.py:727-741`); -1 padding.
    token_labels = np.full((L,), -1, dtype=np.int32)
    token_labels[:n] = TokenType.coord
    token_labels[n] = TokenType.eos

    target_seq = np.zeros((L, 2), dtype=np.float32)
    target_seq[:n] = np.clip(norm, 0.0, 1.0).astype(np.float32)

    mask = np.zeros((L,), dtype=bool)
    mask[: n + 1] = True

    visibility_mask = np.zeros((L,), dtype=bool)
    visibility_mask[:n] = visibility > 0
    visibility_mask[n] = True  # EOS always supervised (`mp100_cape.py:770-785`)

    # deltas: position 0 is BOS (0), positions 1..n are fractional parts
    # (`mp100_cape.py:789-807`).
    delta_x1 = np.zeros((L,), dtype=np.float32)
    delta_y1 = np.zeros((L,), dtype=np.float32)
    delta_x1[1 : 1 + n] = dx
    delta_y1[1 : 1 + n] = dy

    target_polygon_labels = np.full((L,), -1, dtype=np.int32)
    target_polygon_labels[:n] = category_id

    return {
        "seq11": seq_of(idx11),
        "seq21": seq_of(idx21),
        "seq12": seq_of(idx12),
        "seq22": seq_of(idx22),
        "target_seq": target_seq,
        "token_labels": token_labels,
        "mask": mask,
        "visibility_mask": visibility_mask,
        "target_polygon_labels": target_polygon_labels,
        "delta_x1": delta_x1,
        "delta_x2": (1.0 - delta_x1).astype(np.float32),
        "delta_y1": delta_y1,
        "delta_y2": (1.0 - delta_y1).astype(np.float32),
    }
