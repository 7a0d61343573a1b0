"""The comparisons that decide `correct`: the program's outputs against the
plain reference's, each reading beside its limit.

A decode is judged by teacher-forcing the reference over the tokens the
program fed itself (`reference.data.decode_inputs`), in float32 with TF32
off: at every position before a sample's length, the widest gap between
the served coordinate and the reference's (`coords_gap`, in units of the
model frame), the widest gap between a served class logit and the
reference's (`logits_gap`), and by how much the reference's logit of the
served class lies below its best (`class_gap`). The control's readings are
the same gaps of the reference computed in `qdtype` against the float32
one.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from reference.data import decode_inputs
from reference.model import RefCAPE


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for the reference, restored after."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def reference(c: Dict, weights: Dict[str, torch.Tensor], device,
              qdtype: Optional[torch.dtype] = None) -> RefCAPE:
    with torch.device("meta"):
        ref = RefCAPE(c, qdtype)
    ref = ref.to_empty(device=device)
    ref.load_state_dict(weights, strict=True)
    return ref.eval()


def param_shapes(c: Dict) -> Dict[str, torch.Size]:
    with torch.device("meta"):
        ref = RefCAPE(c)
    return {k: v.shape for k, v in ref.state_dict().items()}


def support_arrays(support01: np.ndarray, skeleton, c: Dict):
    """The padded (coords, mask, edges) of a 1-shot prototype."""
    K, E = c["max_support_keypoints"], c["max_skeleton_edges"]
    n = len(support01)
    coords = np.zeros((K, 2), np.float32)
    coords[:n] = np.clip(support01, 0.0, 1.0)
    mask = np.ones((K,), bool)
    mask[:n] = False
    edges = np.full((E, 2), -1, np.int32)
    if skeleton:
        sk = np.asarray(skeleton, np.int32)[:E]
        edges[:len(sk)] = sk
    return coords, mask, edges


@torch.no_grad()
def decode_gaps(ref: RefCAPE, images, coords, mask, edges, logits, pcoords,
                lengths, c: Dict, qref: Optional[RefCAPE] = None) -> Dict:
    """The gaps of one decoded batch (tensors on the reference's device):
    images (B, S, S, 3) uint8, support (B, K, 2)/(B, K)/(B, E, 2), the
    served logits (B, L, 3) and coordinates (B, L, 2), lengths (B,)."""
    nb = math.isqrt(c["vocab_size"])
    T = int(lengths.max())
    logits, pcoords = logits[:, :T].float(), pcoords[:, :T].float()
    seq = decode_inputs(logits, pcoords, T, nb, c["min_decode_len"])
    cls, refs = ref(images, coords, mask, edges, seq)
    rl, rc = cls[-1], refs[-1].clamp(0.0, 1.0)
    active = torch.arange(T, device=rl.device)[None] < lengths[:, None]
    best = rl.amax(-1)
    out = {"coords_gap": float((pcoords - rc).abs().amax(-1)[active].max()),
           "logits_gap": float((logits - rl).abs().amax(-1)[active].max()),
           "class_gap": float((best - rl.gather(
               -1, logits.argmax(-1, keepdim=True))[..., 0])[active].max()),
           "tokens": int(active.sum())}
    if qref is not None:
        qc, qr = qref(images, coords, mask, edges, seq)
        out["control"] = {
            "coords_gap": float((qr[-1].clamp(0.0, 1.0) - rc).abs()
                                .amax(-1)[active].max()),
            "logits_gap": float((qc[-1] - rl).abs().amax(-1)[active].max()),
            "class_gap": float((best - rl.gather(
                -1, qc[-1].argmax(-1, keepdim=True))[..., 0])[active].max())}
    return out


def merge_max(parts: List[Dict], keys) -> Dict:
    out = {k: max(p[k] for p in parts) for k in keys}
    if parts and "control" in parts[0]:
        out["control"] = {k: max(p["control"][k] for p in parts)
                          for k in parts[0]["control"]}
    return out


def verdict(readings: Dict[str, float], limits: Dict[str, float],
            present: bool = False) -> Dict:
    """{name: {value, limit}} for every limited reading, and whether all
    are within their limits (a reading that is not a number fails). With
    `present`, only the limits of the readings there: a control or a fault
    computes some of a cell's numbers, and has to fail one of them."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        if present and name not in readings:
            continue
        v = readings.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return {"correct": ok, "checks": checks}
