"""Plain data arithmetic of the benchmark: the keypoint tokenizer the
traffic generator uses for training targets, and the reference's own
crop, resize, decode-input tokens, keypoint extraction and PCK.

Vocabulary: `num_bins**2` grid cells (id = x_bin * num_bins + y_bin),
then BOS, EOS, SEP and PAD. A coordinate in [0, 1] becomes the four
corners of its cell on the (num_bins - 1) grid with its fractional parts
as bilinear weights.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

COORD, SEP, EOS = 0, 1, 2


def specials(nb: int) -> Dict[str, int]:
    base = nb * nb
    return {"bos": base, "eos": base + 1, "sep": base + 2, "pad": base + 3}


def tokenize(keypoints01: np.ndarray, visibility: np.ndarray, nb: int,
             seq_len: int) -> Dict[str, np.ndarray]:
    """Teacher-forcing inputs and targets of one instance: BOS, one token a
    keypoint, then the EOS label; every array (seq_len,) or (seq_len, 2)."""
    sp = specials(nb)
    n = len(keypoints01)
    if n + 2 > seq_len:
        raise ValueError(f"{n} keypoints need {n + 2} tokens")
    q = np.clip(np.asarray(keypoints01, np.float64) * (nb - 1), 0, nb - 1)
    xf = np.clip(np.floor(q[:, 0]), 0, nb - 1).astype(np.int32)
    yf = np.clip(np.floor(q[:, 1]), 0, nb - 1).astype(np.int32)
    xc = np.clip(np.ceil(q[:, 0]), 0, nb - 1).astype(np.int32)
    yc = np.clip(np.ceil(q[:, 1]), 0, nb - 1).astype(np.int32)
    out = {}
    for key, ids in (("seq11", xf * nb + yf), ("seq21", xc * nb + yf),
                     ("seq12", xf * nb + yc), ("seq22", xc * nb + yc)):
        s = np.full((seq_len,), sp["pad"], np.int32)
        s[0] = sp["bos"]
        s[1:1 + n] = ids
        out[key] = s
    dx = np.zeros((seq_len,), np.float32)
    dy = np.zeros((seq_len,), np.float32)
    dx[1:1 + n] = q[:, 0] - xf
    dy[1:1 + n] = q[:, 1] - yf
    out.update(delta_x1=dx, delta_y1=dy, delta_x2=(1 - dx).astype(np.float32),
               delta_y2=(1 - dy).astype(np.float32))
    labels = np.full((seq_len,), -1, np.int32)
    labels[:n] = COORD
    labels[n] = EOS
    target = np.zeros((seq_len, 2), np.float32)
    target[:n] = np.clip(keypoints01, 0, 1)
    mask = np.zeros((seq_len,), bool)
    mask[:n + 1] = True
    vis = np.zeros((seq_len,), bool)
    vis[:n] = np.asarray(visibility) > 0
    vis[n] = True
    poly = np.full((seq_len,), -1, np.int32)
    poly[:n] = 0
    out.update(token_labels=labels, target_seq=target, mask=mask,
               visibility_mask=vis, target_polygon_labels=poly)
    return out


def crop_resize(img: np.ndarray, bbox, size: int, qdtype=None):
    """Crop to the clamped integer box, then a bilinear resize with
    half-pixel centres and no antialias, rounded to uint8 (through `qdtype`
    first, for the control). Returns the image and the (origin, scale)
    that map model coordinates back."""
    H, W = img.shape[:2]
    bx, by = max(0, int(bbox[0])), max(0, int(bbox[1]))
    bw, bh = min(int(bbox[2]), W - bx), min(int(bbox[3]), H - by)
    crop = torch.from_numpy(np.ascontiguousarray(
        img[by:by + bh, bx:bx + bw])).permute(2, 0, 1)[None].float()
    out = F.interpolate(crop, size=(size, size), mode="bilinear",
                        align_corners=False)
    if qdtype is not None:
        out = out.to(qdtype).float()
    out = out[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    return out.numpy(), (float(bx), float(by)), (bw / float(size),
                                                 bh / float(size))


def decode_inputs(logits: torch.Tensor, coords: torch.Tensor, T: int,
                  nb: int, min_len: int) -> Dict[str, torch.Tensor]:
    """The token inputs of positions 0..T-1 that a greedy decode feeds
    itself: BOS, then position t's input made from step t-1's class and
    coordinate (EOS before `min_len` counts as a coordinate)."""
    sp = specials(nb)
    B = logits.shape[0]
    dev = logits.device
    cls = logits[:, :T - 1].argmax(-1)
    pos = torch.arange(T - 1, device=dev)[None]
    is_coord = (cls == COORD) | ((cls == EOS) & (pos < min_len))
    special = torch.where((cls == EOS) & (pos >= min_len), sp["eos"],
                          sp["sep"])
    q = coords[:, :T - 1].clamp(0, 1) * (nb - 1)
    xf, yf = q[..., 0].floor(), q[..., 1].floor()
    xc, yc = q[..., 0].ceil(), q[..., 1].ceil()
    dx = torch.where(is_coord, q[..., 0] - xf, 0.0)
    dy = torch.where(is_coord, q[..., 1] - yf, 0.0)
    seq = {}
    bos = torch.full((B, 1), sp["bos"], dtype=torch.long, device=dev)
    for key, (a, b) in (("seq11", (xf, yf)), ("seq12", (xf, yc)),
                        ("seq21", (xc, yf)), ("seq22", (xc, yc))):
        ids = torch.where(is_coord, (a * nb + b).long(), special)
        seq[key] = torch.cat([bos, ids], 1)
    zero = torch.zeros((B, 1), device=dev)
    seq["delta_x1"] = torch.cat([zero, dx], 1)
    seq["delta_y1"] = torch.cat([zero, dy], 1)
    seq["delta_x2"] = 1 - seq["delta_x1"]
    seq["delta_y2"] = 1 - seq["delta_y1"]
    return seq


def extract_keypoints(logits: np.ndarray, coords: np.ndarray,
                      length: int, n: int) -> np.ndarray:
    """The coordinates at positions classed as coordinates before the
    length, in order, cut or zero-padded to `n`."""
    sel = (logits[:length].argmax(-1) == COORD)
    k = coords[:length][sel][:n].astype(np.float64)
    return np.concatenate([k, np.zeros((n - len(k), 2))], 0)


def pck_counts(pred: Sequence[np.ndarray], gt: Sequence[np.ndarray],
               bbox_wh: np.ndarray, vis: Sequence[np.ndarray],
               size: int, threshold: float = 0.2) -> List[int]:
    """(correct, visible): distance in pixels over the bbox diagonal below
    the threshold, over visible keypoints."""
    correct = visible = 0
    for p, g, (bw, bh), v in zip(pred, gt, bbox_wh, vis):
        m = np.asarray(v) > 0
        d = np.linalg.norm((p[m] - g[m]) * size, axis=-1) / np.sqrt(
            float(bw) ** 2 + float(bh) ** 2)
        correct += int((d < threshold).sum())
        visible += int(m.sum())
    return [correct, visible]
