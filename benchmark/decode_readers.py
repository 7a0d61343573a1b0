"""What the decode-layer metric readers (`metrics/decode_layer_*.py`)
share: the decode's layer-step kernel (`ops.decode_step.layer_step`,
`csrc/decode_layer.cu`: one launch a v1 decoder layer a token) in a
traced serving or evaluation run.

A launch's least time is its bytes at the HBM's rate (its FLOPs, ~24 M at
batch 8, are nothing beside them). Its bytes, from the configuration and
the cell's batch alone: the layer's parameters as the model holds them
(bf16, the sampling offsets' projection fp32), one quad row of 4 Dh a
(episode, head, level, point), the new K and V rows, the layer's input
(fp32 at the first layer, out of the token embedding, bf16 after) and its
bf16 output. The cached keys and values and the support's are left out:
how many a step reads depends on its position and the keypoint count. So
the bound is a floor, and the share can only read low.

The kernel's traced time is the union of its events' intervals, not their
sum: a launch starts while the layer before it runs (a programmatic
dependent launch) and waits there for its input, so the events of one
token's layers overlap. What the union still holds of those waits (a
layer's start before the first's, at a token's head) makes the share read
lower still.
"""

from __future__ import annotations

from typing import Dict, Optional

import counts
import program
from trace import busy_us

#: the kernel's name as the device trace gives it
KERNEL = "decode_layer_kernel"


def launch_bytes(c: Dict, images: int, first: bool) -> float:
    """One launch's bytes at a batch of `images`, the first layer's
    (`first`: fp32 input) or another's."""
    d, F_, H = c["hidden_dim"], c["dim_feedforward"], c["nheads"]
    hlp = H * c["num_feature_levels"] * c["dec_n_points"]
    e = 2 if c["bf16"] else 4
    params = (4 * (d * d + d) + 2 * d        # self-attention, norm2
              + 2 * (d * d + d) + 2 * d      # support q and out, its norm
              + hlp * d + hlp                # attention weights
              + d * d + d + 2 * d            # output projection, norm1
              + 2 * d * F_ + F_ + d + 2 * d)  # FFN, norm3
    if c["query_pos_type"] == "sine":
        params += d * d + d + 2 * d          # pos_trans and its norm
    if c["dec_qkv_proj"]:
        params += 3 * d * d                  # the pre-projections
    if c["with_poly_refine"]:
        params += 2 * (d * d + d) + 2 * d + 2   # the coordinates' head
    offsets = 4 * (2 * hlp * d + 2 * hlp)    # fp32
    rows = images * hlp * 4 * (d // H) * e
    io = images * d * (2 * e + (4 if first else e) + e)   # k, v, in, out
    return params * e + offsets + rows + io


def roofline(run, per: str) -> Optional[float]:
    """The kernel's least time at every traced launch over the union of its
    traced intervals, %; None unless the launches are a whole number of tokens (`dec_layers`
    a token) and the program's counter `decode.layer_step` shows the
    kernel route took the decode."""
    if not run.trace:
        return None
    c = run.c
    hits = [ev for ev in run.trace["events"] if KERNEL in ev[0]]
    n, secs = len(hits), busy_us(hits) * 1e-6
    routed = program.counter("decode.layer_step")
    layers = c["dec_layers"]
    if not n or n % layers or not routed or secs <= 0 \
            or not run.traced_work.get(per):
        return None
    images = run.t["batch"]
    token = launch_bytes(c, images, True) + \
        (layers - 1) * launch_bytes(c, images, False)
    return 100.0 * (n // layers) * token / counts.HBM_BYTES_PER_S / secs
