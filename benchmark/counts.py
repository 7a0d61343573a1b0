"""The work the model's algorithm needs, from the configuration and the
cell's shapes alone, whatever implements it; and the card's peaks.

FLOPs count the multiply-adds (x 2) of the convolutions, the linear
layers and the attention products; the bilinear sampling, norms and
elementwise work are left out, as `torch.utils.flop_counter` leaves them.
A decode token at position t attends over the t + 1 positions written; a
teacher-forced pass computes its full L x L causal product. A backward is
counted as twice its forward.

Bytes of a row gather (`quad_gather`): each table row read once (at most
the level's cells, and at most one a gathered row), the int32 indices read
once and the gathered rows written once.

Of a whole MSDA call (the op `ops.msda.ms_deform_attn` computes, whatever
implements it), a (batch, head) at a time: each value row (one cell's Dh
values) read once, at most the level's cells and at most the four corners
of each sample; the fp32 (x, y) locations and the weights read once; the
output written once. Its backward also reads the output's gradient once
and writes the locations' and weights' gradients once and the value's
gradient whole. FLOPs: 2 Dh (forward) and 4 Dh (backward) a corner, every
corner counted in range (the shapes do not say which fall outside),
against the fp32 peak.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from reference import backbones

#: NVIDIA H100 SXM, dense, at the 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _shapes(c: Dict) -> List[Tuple[int, int]]:
    return [(c["image_size"] // s, c["image_size"] // s)
            for s in (8, 16, 32, 64)][:c["num_feature_levels"]]


def _conv(cin, cout, k, hw_out) -> float:
    return 2.0 * cin * cout * k * k * hw_out


def image_flops(c: Dict) -> float:
    """One image through the backbone (its module's `flops`), the input
    projections and the deformable encoder."""
    d, F_, H = c["hidden_dim"], c["dim_feedforward"], c["nheads"]
    sh = _shapes(c)
    S = sum(h * w for h, w in sh)
    backbone = backbones.module(c["backbone"])
    f = backbone.flops(c)
    chans = backbone.channels(c)
    for (h, w), cin in zip(sh, chans):
        f += _conv(cin, d, 1, h * w)
    if len(sh) > 3:
        f += _conv(chans[-1], d, 3, sh[3][0] * sh[3][1])
    hlp = H * len(sh) * c["enc_n_points"]
    per_tok = 2.0 * d * (3 * hlp + 2 * d + 2 * F_)
    return f + c["enc_layers"] * S * per_tok


def support_flops(c: Dict) -> float:
    """One support set, padded to `max_support_keypoints`."""
    d, F_ = c["hidden_dim"], c["dim_feedforward"]
    N = c["max_support_keypoints"]
    f = 2.0 * N * (2 * d + d * d)
    if c["use_geometric_encoder"]:
        if c["use_gcn_preenc"]:
            f += c["num_gcn_layers"] * (2.0 * N * d * 2 * d
                                        + 2.0 * 2 * N * N * d)
    else:
        f += 2.0 * N * 2 * d * d
    layer = 2.0 * N * (4 * d * d + 2 * d * F_) + 2.0 * 2 * N * N * d
    return f + c["support_encoder_layers"] * layer


def _dec_layer(c: Dict, q: int, keys: float) -> float:
    """One v1 decoder layer for `q` queries whose self-attention reads
    `keys` keys in all (summed over the queries)."""
    d, F_, H = c["hidden_dim"], c["dim_feedforward"], c["nheads"]
    N = c["max_support_keypoints"]
    hlp = H * c["num_feature_levels"] * c["dec_n_points"]
    per_q = 2.0 * d * (3 * d + 4 * d        # pre-projections, self-attn
                       + 2 * d              # support q and out
                       + 3 * hlp + d        # offsets, weights, out
                       + 2 * F_             # ffn
                       + d                  # query position transform
                       + 2 * d + 2)         # coordinate head
    return q * per_q + 2.0 * 2 * keys * d + 2.0 * 2 * q * N * d


def decoder_static_flops(c: Dict) -> float:
    """Per image: each decoder layer's value projection of the memory and
    key/value projections of the support."""
    d, N = c["hidden_dim"], c["max_support_keypoints"]
    S = sum(h * w for h, w in _shapes(c))
    return c["dec_layers"] * (2.0 * S * d * d + 2 * 2.0 * N * d * d)


def decode_token_flops(c: Dict, pos: int) -> float:
    """Per image, the token at position `pos` (its class head read from
    the last layer only)."""
    return c["dec_layers"] * _dec_layer(c, 1, pos + 1) + \
        2.0 * c["hidden_dim"] * 3


def decode_flops(c: Dict, images: int, tokens: int) -> float:
    """A batch's decode: the image and support encoders, the static
    projections and `tokens` tokens."""
    per = image_flops(c) + support_flops(c) + decoder_static_flops(c) + \
        sum(decode_token_flops(c, t) for t in range(tokens))
    return images * per


def train_forward_flops(c: Dict, images: int) -> float:
    """A teacher-forced forward of `images` query images over `seq_len`
    positions (every layer's class head)."""
    L, d = c["seq_len"], c["hidden_dim"]
    S = sum(h * w for h, w in _shapes(c))
    dec = c["dec_layers"] * (_dec_layer(c, L, L * L) + 2.0 * S * d * d
                             + 2.0 * L * d * 3) \
        + c["dec_layers"] * 2 * 2.0 * c["max_support_keypoints"] * d * d
    return images * (image_flops(c) + support_flops(c) + dec)


def train_update_flops(c: Dict, images: int) -> float:
    """One real update: `accumulation_steps` micro-steps of `images`
    images, forward and backward."""
    return 3.0 * c["accumulation_steps"] * train_forward_flops(c, images)


# -- kernel bytes --------------------------------------------------------
def _elt(c: Dict) -> int:
    return 2 if c["bf16"] else 4


def gather_bytes(c: Dict, bh: int, cells: int, rows: int) -> float:
    C = 4 * (c["hidden_dim"] // c["nheads"])
    return bh * (min(cells, rows) * C * _elt(c) + rows * 4
                 + rows * C * _elt(c))


def least_s(nbytes: float, flops: float, peak_flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def encoder_gather_s(c: Dict, images: int) -> float:
    """The least time of one image batch's encoder gathers."""
    S = sum(h * w for h, w in _shapes(c))
    bh = images * c["nheads"]
    P = c["enc_n_points"]
    return c["enc_layers"] * sum(
        gather_bytes(c, bh, h * w, S * P) / HBM_BYTES_PER_S
        for h, w in _shapes(c))


def token_gather_s(c: Dict, images: int) -> float:
    """One decode token's gather of one layer: every level's points of
    every (batch, head) from the packed slab in one launch."""
    S = sum(h * w for h, w in _shapes(c))
    rows = c["num_feature_levels"] * c["dec_n_points"]
    return gather_bytes(c, images * c["nheads"], S, rows) / HBM_BYTES_PER_S


def msda_bytes_flops(c: Dict, images: int, queries: int, points: int,
                     backward: bool = False) -> Tuple[float, float]:
    """(bytes, FLOPs) of one whole-op MSDA call, forward or backward, of
    `images` images and `queries` queries with `points` points a level."""
    H = c["nheads"]
    Dh, e = c["hidden_dim"] // H, _elt(c)
    bh = images * H
    samples = queries * points * c["num_feature_levels"]
    rows = sum(min(h * w, 4 * queries * points) for h, w in _shapes(c))
    io = samples * (2 * 4 + e)
    out = queries * Dh * e
    corners = 4.0 * bh * samples
    if not backward:
        return bh * (rows * Dh * e + io + out), 2 * Dh * corners
    cells = sum(h * w for h, w in _shapes(c))
    return (bh * (rows * Dh * e + 2 * io + out + cells * Dh * e),
            4 * Dh * corners)


def train_msda_s(c: Dict, images: int) -> float:
    """The least time of one micro-step's MSDA calls, forward and
    backward, at every encoder and teacher-forced decoder site."""
    S = sum(h * w for h, w in _shapes(c))
    t = 0.0
    for layers, q, P in ((c["enc_layers"], S, c["enc_n_points"]),
                         (c["dec_layers"], c["seq_len"], c["dec_n_points"])):
        for backward in (False, True):
            b, f = msda_bytes_flops(c, images, q, P, backward)
            t += layers * least_s(b, f, PEAK_FP32_FLOPS)
    return t
