"""`counts.py` against `torch.utils.flop_counter.FlopCounterMode` over the
plain reference at the program's test size, and its byte counts against
the arithmetic spelled out; the training MSDA roofline's reading of the
trace."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import check as checks
import common
import counts
import readers
import tiny
import traffic

SEQ = ("seq11", "seq12", "seq21", "seq22", "delta_x1", "delta_x2",
       "delta_y1", "delta_y2")


def _ref(cell, **over):
    f = tiny.files(cell, **over)
    c = f["config"]["cape"]
    init = dict(f["config"]["assumed"]["init"], **f["traffic"]["init"])
    w = common.make_weights(checks.param_shapes(c), c, init, 3, "cpu")
    return c, checks.reference(c, w, "cpu")


def _counted(fn) -> float:
    with FlopCounterMode(display=False) as m:
        fn()
    return float(m.get_total_flops())


@pytest.mark.parametrize("cell,over", [
    ("cape-geo.train-update", {}),
    ("cape-legacy.eval-kpt", {}),
    ("cape-geo.train-update", {"use_gcn_preenc": False}),
])
def test_teacher_forced_forward_flops(cell, over):
    c, ref = _ref(cell, **over)
    t = dict(tiny.files(cell)["traffic"], kind="train", episodes=1,
             queries=2, pool=1, keypoints=[[4, 1]], jitter=0.03, unlabeled=0.1,
             block=8)
    b = traffic.train(t, c, 1)[0]
    x = {k: torch.as_tensor(v) for k, v in b.items() if k != "targets"}
    seq = {k: torch.as_tensor(b["targets"][k]) for k in SEQ}
    seq = {k: v.long() if k.startswith("seq") else v for k, v in seq.items()}
    with torch.no_grad():
        got = _counted(lambda: ref(x["query_images"], x["support_coords"],
                                   x["support_mask"], x["skeleton_edges"],
                                   seq))
    assert got == pytest.approx(counts.train_forward_flops(c, 2), rel=1e-9)


def test_image_and_support_flops():
    c, ref = _ref("cape-geo.serve-b8")
    imgs = torch.zeros(1, c["image_size"], c["image_size"], 3,
                       dtype=torch.uint8)
    with torch.no_grad():
        assert _counted(lambda: ref.encode_image(imgs)) == pytest.approx(
            counts.image_flops(c), rel=1e-9)
        K = c["max_support_keypoints"]
        coords = torch.rand(1, K, 2)
        mask = torch.zeros(1, K, dtype=torch.bool)
        edges = torch.tensor([[[0, 1], [1, 2]] + [[-1, -1]] * (
            c["max_skeleton_edges"] - 2)])
        assert _counted(lambda: ref.support_encoder(
            coords, mask, edges, None)) == pytest.approx(
            counts.support_flops(c), rel=1e-9)


def test_decode_token_flops_sum_to_a_full_pass():
    """Summed over L tokens, the decode's per-token work (attention over
    the written positions) falls short of a teacher-forced pass's by the
    L x L causal product's upper triangle, and by the class heads a decode
    reads from the last layer only."""
    c, _ = _ref("cape-geo.serve-b8")
    L, d, layers = c["seq_len"], c["hidden_dim"], c["dec_layers"]
    tokens = sum(counts.decode_token_flops(c, t) for t in range(L))
    full = counts.train_forward_flops(c, 1) - counts.image_flops(c) - \
        counts.support_flops(c) - counts.decoder_static_flops(c)
    upper = layers * 2.0 * 2 * d * (L * L - L * (L + 1) / 2)
    heads = (layers - 1) * 2.0 * L * d * 3
    assert tokens == pytest.approx(full - upper - heads, rel=1e-9)


def test_gather_bytes_spelled_out():
    c = dict(tiny.files("cape-geo.serve-b8")["config"]["cape"], bf16=True)
    C = 4 * c["hidden_dim"] // c["nheads"]
    # 4 (batch, head) rows of 10 gathered rows from a level of 64 cells
    assert counts.gather_bytes(c, 4, 64, 10) == 4 * (10 * C * 2 + 10 * 4
                                                     + 10 * C * 2)
    # more gathered rows than cells: each cell read once
    assert counts.gather_bytes(c, 1, 8, 100) == 8 * C * 2 + 100 * 4 + \
        100 * C * 2


def test_msda_bytes_and_flops_by_hand():
    """The whole op at the tiny size in bf16: 4 heads of Dh 16, levels of
    8x8, 4x4, 2x2 and 1x1 cells (85), 2 images, 3 queries, 2 points a
    level: 24 samples and 96 corners a (batch, head), 8 of those."""
    c = dict(tiny.files("cape-geo.train-update")["config"]["cape"],
             bf16=True)
    # value rows: each level's cells, at most 4 corners x 3 x 2 = 24
    rows = 24 + 16 + 4 + 1
    io = 24 * (2 * 4 + 2)        # fp32 (x, y) and a bf16 weight a sample
    out = 3 * 16 * 2
    fwd = counts.msda_bytes_flops(c, 2, 3, 2)
    assert fwd == (8 * (rows * 16 * 2 + io + out), 2 * 16 * 96 * 8)
    assert fwd == (14208, 24576)
    # the gradient of the output read, the locations' and weights' written,
    # the value's written whole (85 rows)
    bwd = counts.msda_bytes_flops(c, 2, 3, 2, backward=True)
    assert bwd == (8 * (rows * 16 * 2 + 2 * io + out + 85 * 16 * 2),
                   4 * 16 * 96 * 8)
    assert bwd == (37888, 49152)


def test_train_msda_s_sums_every_site():
    c = dict(tiny.files("cape-geo.train-update")["config"]["cape"],
             bf16=True)
    S = 85
    want = 0.0
    for layers, q, P in ((c["enc_layers"], S, c["enc_n_points"]),
                         (c["dec_layers"], c["seq_len"], c["dec_n_points"])):
        for bwd in (False, True):
            b, f = counts.msda_bytes_flops(c, 4, q, P, bwd)
            want += layers * max(b / counts.HBM_BYTES_PER_S,
                                 f / counts.PEAK_FP32_FLOPS)
    assert counts.train_msda_s(c, 4) == pytest.approx(want, rel=1e-12)


class _Run:
    def __init__(self, launches, updates=1):
        f = tiny.files("cape-geo.train-update")
        self.c, self.t = f["config"]["cape"], f["traffic"]
        self.traced_work = {"updates": updates}
        self.trace = {"events": [
            (f"void msda_{k}_kernel<true>(Args)", 0.0, 1e3)
            for k, n in launches.items() for _ in range(n)]}


def test_msda_roofline_reads_the_whole_ops_kernels():
    """One traced update of 2 micro-steps at 2 + 2 sites: 8 launches of
    each kernel, 1 ms each; any other count reads nothing."""
    run = _Run({"forward": 8, "backward": 8})
    c = run.c
    images = run.t["episodes"] * run.t["queries"]
    got = readers.msda_roofline(run)
    assert got == pytest.approx(
        100 * 2 * counts.train_msda_s(c, images) / 16e-3, rel=1e-12)
    assert 0 < got <= 100
    assert readers.msda_roofline(_Run({"forward": 8, "backward": 7})) is None
    assert readers.msda_roofline(_Run({"forward": 8, "backward": 8},
                                      updates=2)) is None
