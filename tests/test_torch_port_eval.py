"""The port's evaluation path against the JAX package's on the CPU: PCK,
the sequence and logging utilities, the leak audit, and the slice as a
whole — MP-100 episodes on disk to the PCK stats of `evaluate_cape`.

The slice runs the tiny config in fp32 with seeded weights
(`test_torch_port_util.jax_tiny`, carried over by `convert.from_jax_params`)
on the synthetic fixture's val split, the same fixed episodes in both
packages (their batches are byte-equal, `test_torch_port_data.py`).
Tolerances: decode logits and coords 1e-4 (fp32 through a deep stack,
summation order only); PCK counts equal and PCK values to 1e-12 (the host
bookkeeping is float64 in both); loss means 1e-4. A keypoint whose
normalised distance lies within 1e-4 of the threshold would make the
counts depend on that summation order: the test fails and names it.
"""

import contextlib
import io
import warnings

import numpy as np
import pytest
import torch

from cape_tpu.config import tiny_test_config as jax_tiny_config
from cape_tpu.data import builder as jax_builder
from cape_tpu.data import episodic as jax_episodic
from cape_tpu.eval import audit as jax_audit
from cape_tpu.eval import evaluate as jax_evaluate
from cape_tpu.eval import pck as jax_pck
from cape_tpu.train import make_eval_loss_fn as jax_eval_loss_fn
from cape_tpu.utils import debug as jax_debug
from cape_tpu.utils import logging as jax_logging
from cape_tpu.utils import sequence as jax_sequence

from cape_tpu_torch.config import CAPEConfig as PortConfig
from cape_tpu_torch.data import builder as port_builder
from cape_tpu_torch.data import episodic as port_episodic
from cape_tpu_torch.data.prefetch import prefetch, to_device
from cape_tpu_torch.data.synthetic import make_synthetic_mp100
from cape_tpu_torch.eval import audit as port_audit
from cape_tpu_torch.eval import evaluate as port_evaluate
from cape_tpu_torch.eval import pck as port_pck
from cape_tpu_torch.train import make_eval_loss_fn as port_eval_loss_fn
from cape_tpu_torch.utils import debug as port_debug
from cape_tpu_torch.utils import logging as port_logging
from cape_tpu_torch.utils import sequence as port_sequence

from test_torch_port_util import jax_tiny, port_model

THRESHOLD = 0.2
#: how close to the threshold a normalised distance may come
MARGIN = 1e-4


# -- PCK -------------------------------------------------------------------------
def _pck_inputs(seed, n=9):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 64, (n, 2))
    pred = gt + rng.normal(0, 8, (n, 2))
    vis = rng.integers(0, 3, n)
    return pred, gt, vis


@pytest.mark.parametrize("norm", ["diagonal", "max", "mean"])
@pytest.mark.parametrize("vis", ["none", "mask", "zero"])
def test_compute_pck_bbox_matches_jax(norm, vis):
    pred, gt, v = _pck_inputs(1)
    v = {"none": None, "mask": v, "zero": np.zeros_like(v)}[vis]
    for bw, bh in ((40.0, 70.0), (13.0, 9.5)):
        want = jax_pck.compute_pck_bbox(pred, gt, bw, bh, v, THRESHOLD, norm)
        got = port_pck.compute_pck_bbox(pred, gt, bw, bh, v, THRESHOLD, norm)
        assert got == want
    if vis == "zero":
        assert got == (0.0, 0, 0)
    with pytest.raises(ValueError, match="normalize_by"):
        port_pck.compute_pck_bbox(pred, gt, 1.0, 1.0, normalize_by="area")


@pytest.mark.parametrize("norm", ["diagonal", "max", "mean"])
def test_normalized_distances_are_what_pck_counts(norm):
    pred, gt, v = _pck_inputs(4, n=40)
    d = port_pck.normalized_distances(pred, gt, 40.0, 70.0, norm)
    assert d.dtype == np.float64 and d.shape == (40,)
    _, correct, visible = jax_pck.compute_pck_bbox(pred, gt, 40.0, 70.0, v,
                                                   THRESHOLD, norm)
    assert 0 < correct < visible
    assert int((d[v > 0] < THRESHOLD).sum()) == correct
    with pytest.raises(ValueError, match="normalize_by"):
        port_pck.normalized_distances(pred, gt, 1.0, 1.0, "area")


def test_pck_leak_warning_matches_jax():
    _, gt, vis = _pck_inputs(2)
    for lib in (jax_pck, port_pck):
        with pytest.warns(RuntimeWarning, match="identical to ground truth"):
            assert lib.compute_pck_bbox(gt + 1e-9, gt, 10, 10, vis)[0] == 1.0


def test_pck_evaluator_matches_jax():
    rng = np.random.default_rng(3)
    evs = [jax_pck.PCKEvaluator(0.2), port_pck.PCKEvaluator(0.2)]
    for b in range(4):
        preds, gts, vis = zip(*[_pck_inputs(10 * b + i, 5 + i)
                                for i in range(3)])
        bw, bh = rng.uniform(20, 90, 3), rng.uniform(20, 90, 3)
        cids = rng.integers(1, 4, 3)
        for ev in evs:
            ev.add_batch(preds, gts, bw, bh, cids, vis, image_ids=[b] * 3)
    evs[1].add_sample(*_pck_inputs(99)[:2], 30.0, 40.0)   # category 0
    evs[0].add_sample(*_pck_inputs(99)[:2], 30.0, 40.0)
    assert evs[1].get_results() == evs[0].get_results()
    assert evs[1].image_results == evs[0].image_results
    evs[1].reset()
    assert evs[1].get_results()["num_images"] == 0


# -- sequence, logging, debug ----------------------------------------------------
def test_sequence_utils_match_jax():
    rng = np.random.default_rng(4)
    coords = rng.uniform(0, 1, (3, 10, 2)).astype(np.float32)
    labels = rng.integers(-1, 3, (3, 10))
    mask = rng.integers(0, 2, (3, 10)).astype(bool)
    logits = rng.normal(size=(3, 10, 3)).astype(np.float32)
    for kw in (dict(), dict(mask=mask), dict(max_keypoints=2)):
        a = jax_sequence.extract_keypoints_from_sequence(coords, labels, **kw)
        b = port_sequence.extract_keypoints_from_sequence(coords, labels, **kw)
        assert [x.tolist() for x in a] == [x.tolist() for x in b]
    a = jax_sequence.extract_keypoints_from_predictions(coords, logits, 3)
    b = port_sequence.extract_keypoints_from_predictions(coords, logits, 3)
    assert [x.tolist() for x in a] == [x.tolist() for x in b]
    for lib in (jax_sequence, port_sequence):
        with pytest.warns(RuntimeWarning, match="IDENTICAL"):
            assert lib.compare_pred_gt_keypoints(coords, coords + 1e-8)
        assert not lib.compare_pred_gt_keypoints(coords, coords + 0.1)
        assert not lib.compare_pred_gt_keypoints(coords, coords[:1])


def test_extract_gt_keypoints_matches_jax():
    rng = np.random.default_rng(5)
    labels = np.full((3, 12), -1)
    counts = np.array([4, 7, 2])
    for i, n in enumerate(counts):
        labels[i, :n] = 0
        labels[i, n] = 2
    targets = {"target_seq": rng.uniform(0, 1, (3, 12, 2)).astype(np.float32),
               "token_labels": labels}
    for want_counts in (counts, counts - 1):
        a = jax_evaluate.extract_gt_keypoints(targets, want_counts)
        b = port_evaluate.extract_gt_keypoints(targets, want_counts)
        assert [x.tolist() for x in a] == [x.tolist() for x in b]


def test_smoothed_value_and_metric_logger_match_jax(capsys):
    vals = [3.0, 1.5, 9.25, 4.0, 0.5, 7.0]
    a, b = jax_logging.SmoothedValue(4), port_logging.SmoothedValue(4)
    for i, v in enumerate(vals):
        a.update(v, n=i + 1)
        b.update(v, n=i + 1)
        for attr in ("median", "avg", "global_avg", "max", "value"):
            assert getattr(a, attr) == getattr(b, attr), attr
        assert str(a) == str(b)
    assert str(port_logging.SmoothedValue()) == str(jax_logging.SmoothedValue())
    la, lb = jax_logging.MetricLogger(), port_logging.MetricLogger()
    for lg in (la, lb):
        for i, v in enumerate(vals):
            lg.update(loss=v, pck=v / 10, step=i)
    assert str(la) == str(lb)
    assert la.loss.global_avg == lb.loss.global_avg
    with pytest.raises(AttributeError):
        lb.nope
    outs = []
    for lg in (la, lb):
        assert list(lg.log_every(list(range(5)), 2, header="[h]")) == \
            list(range(5))
        outs.append([line.split(" eta")[0].split(" Total")[0]
                     for line in capsys.readouterr().out.splitlines()])
    assert outs[0] == outs[1] and len(outs[0]) == 4


def test_debug_toggles_match_jax(monkeypatch, capsys):
    for value, shown in (("0", False), ("1", True), ("yes", False)):
        monkeypatch.setenv("DEBUG_PCK", value)
        outs = []
        for lib in (jax_debug, port_debug):
            assert lib.debug_enabled("DEBUG_PCK") is shown
            lib.dbg("DEBUG_PCK", "msg")
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] == ("[DEBUG_PCK] msg\n" if shown else "")
    assert port_sequence.debug_enabled("DEBUG_PCK") is \
        jax_sequence.debug_enabled("DEBUG_PCK")


# -- the slice -------------------------------------------------------------------
#: evaluate_cape cases: (episodes, batch size, sampler kwargs, eval kwargs)
EVAL_CASES = {
    "batch1": (3, 1, {}, {}),
    "batch4_padded": (7, 4, {}, {}),
    "5shot": (5, 4, dict(num_support=5), {}),
    "resized": (7, 4, {}, dict(pck_norm="resized")),
    "gt_fallback": (7, 4, {}, dict(gt_structure_fallback=True)),
    "decode_cap": (7, 4, {}, dict(decode_max_len=5)),
    "loss": (7, 4, {}, dict(compute_loss=True)),
    "debug": (3, 4, {}, dict(print_freq=1)),
}
DEBUG_TOGGLES = ("DEBUG_KEYPOINT_BUG", "DEBUG_KEYPOINT_COUNT",
                 "DEBUG_EXTRACT", "DEBUG_EVAL")


@pytest.fixture(scope="module")
def weights():
    cfg, jm, params = jax_tiny(0)
    return cfg, jm, params, port_model(cfg, params)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return make_synthetic_mp100(
        str(tmp_path_factory.mktemp("mp100")), num_categories=6,
        images_per_category=7, keypoint_range=(4, 8))


def _batches(builder, episodic, cfg, case):
    n, b, skw, _ = EVAL_CASES[case]
    ds = builder.build_mp100_cape("val", cfg)
    sampler = episodic.EpisodicSampler(
        ds, builder.resolve_split_file(cfg), "val", num_queries=1, **skw)
    fixed = sampler.fixed_episodes(n, 17)
    eb, nb = episodic.eval_batch_plan(n, b)
    return list(episodic.episode_batches(
        ds, sampler, eb, nb, cfg.image_size, cfg.max_support_keypoints,
        cfg.max_skeleton_edges, np.random.default_rng(17), fixed=fixed,
        total_episodes=n))


def _run(evaluate, case, mp):
    """(stats, RuntimeWarning messages, printed lines) of `evaluate()`,
    with the DEBUG_* toggles on in the "debug" case."""
    if case == "debug":
        for name in DEBUG_TOGGLES:
            mp.setenv(name, "1")
    buf = io.StringIO()
    try:
        with warnings.catch_warnings(record=True) as caught, \
                contextlib.redirect_stdout(buf):
            warnings.simplefilter("always")
            stats = evaluate()
    finally:
        for name in DEBUG_TOGGLES:
            mp.delenv(name, raising=False)
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    return stats, msgs, buf.getvalue().splitlines()


def _configs(cfg, root):
    """The JAX and the port config of the tiny model on the fixture."""
    jcfg = cfg.replace(dataset_root=root["root"],
                       category_split_file=root["split_file"])
    return jcfg, PortConfig.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def jax_runs(weights, fixture_root):
    """Every case through the JAX package once: stats, warnings, printed
    lines, its batches and each decode's outputs."""
    cfg, jm, params, _ = weights
    jcfg, _ = _configs(cfg, fixture_root)
    loss_fn = jax_eval_loss_fn(jm, jcfg)
    out = {}
    decoded = []
    orig = jax_evaluate._decode_jit

    def recording(model, p, *args):
        o = orig(model, p, *args)
        decoded.append({k: np.asarray(v) for k, v in o.items()})
        return o

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_evaluate, "_decode_jit", recording)
        for case, (_, _, _, ekw) in EVAL_CASES.items():
            decoded.clear()
            batches = _batches(jax_builder, jax_episodic, jcfg, case)
            res = _run(lambda: jax_evaluate.evaluate_cape(
                jm, params, iter(batches), jcfg, pck_threshold=THRESHOLD,
                eval_loss_fn=loss_fn, **ekw), case, mp)
            out[case] = res + (batches, list(decoded))
    return out


def _near_threshold(case, batches, decoded, cfg, ekw):
    """(batch, row, keypoint, normalised distance) of every visible
    keypoint of a real episode within MARGIN of the threshold, as the JAX
    side scores it."""
    near = []
    for bi, (batch, out) in enumerate(zip(batches, decoded)):
        expected = batch["num_keypoints"]
        lengths = out["lengths"]
        active = (np.arange(out["pred_logits"].shape[1])[None]
                  < lengths[:, None])
        if ekw.get("gt_structure_fallback"):
            preds = [out["pred_coords"][i, :int(expected[i])]
                     for i in range(len(expected))]
        else:
            preds = jax_evaluate.extract_pred_keypoints(
                out["pred_logits"], out["pred_coords"], active, expected)
        gts = jax_evaluate.extract_gt_keypoints(batch["targets"], expected)
        for i in np.flatnonzero(batch["sample_valid"]):
            n = int(expected[i])
            if ekw.get("pck_norm") == "resized":
                size = np.sqrt(2.0) * cfg.image_size
            else:
                size = float(np.hypot(*batch["bbox_dims"][i].astype(np.float64)))
            d = np.sqrt((((preds[i] - gts[i]) * cfg.image_size) ** 2).sum(-1))
            for k in np.flatnonzero(batch["gt_visibility"][i, :n] > 0):
                if abs(d[k] / size - THRESHOLD) < MARGIN:
                    near.append((case, bi, int(i), int(k), d[k] / size))
    return near


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_evaluate_cape_matches_jax(weights, fixture_root, jax_runs, case,
                                   monkeypatch):
    cfg, _, _, pm = weights
    want, want_warn, want_lines, jbatches, jdecoded = jax_runs[case]
    _, _, _, ekw = EVAL_CASES[case]
    near = _near_threshold(case, jbatches, jdecoded, cfg, ekw)
    assert not near, f"keypoints within {MARGIN} of the threshold: {near}"

    _, pcfg = _configs(cfg, fixture_root)
    batches = _batches(port_builder, port_episodic, pcfg, case)
    assert len(batches) == len(jbatches)
    decoded = []
    orig = port_evaluate.decode

    def recording(*args):
        o = orig(*args)
        decoded.append(o)
        return o

    monkeypatch.setattr(port_evaluate, "decode", recording)
    # tensors on the CPU through the prefetch thread, as on the card
    got, got_warn, got_lines = _run(lambda: port_evaluate.evaluate_cape(
        pm, prefetch(iter(batches), transform=lambda b: to_device(b, "cpu")),
        pcfg, pck_threshold=THRESHOLD,
        eval_loss_fn=port_eval_loss_fn(pm, pcfg), **ekw), case, monkeypatch)

    assert len(decoded) == len(jdecoded)
    for o, w in zip(decoded, jdecoded):
        for k in ("lengths", "gen_valid", "unfinished"):
            np.testing.assert_array_equal(o[k].numpy(), w[k], err_msg=k)
        for k in ("pred_logits", "pred_coords"):
            np.testing.assert_allclose(o[k].numpy(), w[k], atol=1e-4,
                                       rtol=1e-4, err_msg=k)
    for k in ("num_images", "pck_num_visible", "pck_num_correct"):
        assert got[k] == want[k], k
    for k in ("pck", "pck_mean_categories"):
        assert got[k] == pytest.approx(want[k], abs=1e-12, rel=0), k
    assert set(got["pck_per_category"]) == set(want["pck_per_category"])
    for c, v in want["pck_per_category"].items():
        assert got["pck_per_category"][c] == pytest.approx(v, abs=1e-12,
                                                           rel=0), c
    assert set(got) == set(want)
    loss_keys = set(want) - {"pck", "pck_mean_categories", "pck_per_category",
                             "pck_num_correct", "pck_num_visible",
                             "num_images"}
    for k in loss_keys:
        assert got[k] == pytest.approx(want[k], abs=1e-4, rel=1e-4), k
    assert got_warn == want_warn
    n_real = EVAL_CASES[case][0]
    assert got["num_images"] == n_real
    if case == "loss":
        assert {"total", "loss_ce", "loss_coords"} <= loss_keys
        assert got["total"] > 0.0
    if case == "decode_cap":
        assert got_warn and "max_len=5" in got_warn[0]
        assert any(o["unfinished"].any() for o in decoded)
    if case == "batch4_padded":
        assert not jbatches[-1]["sample_valid"].all()
    # the class-head shift lets the decodes run past min_decode_len
    assert max(o["lengths"].max() for o in jdecoded) > cfg.min_decode_len + 1
    # printed lines (the DEBUG_* toggles and print_freq): equal where they
    # carry no coordinates
    def no_coords(lines):
        return [ln for ln in lines if "coords=" not in ln]

    assert no_coords(got_lines) == no_coords(want_lines)
    if case == "debug":
        for name in DEBUG_TOGGLES + ("[eval]",):
            assert any(name in ln for ln in got_lines), name


def test_evaluate_cape_refuses_what_it_lacks(weights):
    _, _, _, pm = weights
    # sharded evaluation is ported: without a process group the gathers
    # are the identity (the two-process runs are test_torch_port_ddp.py)
    stats = port_evaluate.evaluate_cape(pm, [], pm.cfg, multihost=True)
    assert stats["num_images"] == 0
    with pytest.raises(ValueError, match="pck_norm"):
        port_evaluate.evaluate_cape(pm, [], pm.cfg, pck_norm="bbox")
    stats = port_evaluate.evaluate_cape(pm, [], pm.cfg)
    assert stats["num_images"] == 0 and stats["loss"] == 0.0


# -- audit -----------------------------------------------------------------------
def _stub(kind, as_tensor):
    """A decode_fn for `audit_episodes`: numpy in the JAX package, numpy or
    tensors in the port."""

    def decode_fn(batch):
        b, L = batch["targets"]["target_seq"].shape[:2]
        rng = np.random.default_rng(b)
        logits = np.zeros((b, L, 3), np.float32)
        lengths = batch["num_keypoints"].astype(np.int32) + 1
        for i, n in enumerate(lengths):
            logits[i, :n - 1, 0] = 1.0
            logits[i, n - 1, 2] = 1.0
        if kind == "clean":
            coords = rng.uniform(0, 1, (b, L, 2)).astype(np.float32)
        elif kind == "gt_leak":
            coords = batch["targets"]["target_seq"].astype(np.float32)
        elif kind == "support_copy":
            coords = np.zeros((b, L, 2), np.float32)
            K = min(L, batch["support_coords"].shape[1])
            coords[:, :K] = batch["support_coords"][:, :K]
        else:                      # collapse: one coordinate everywhere
            coords = np.full((b, L, 2), 0.5, np.float32)
            lengths = np.full(b, L, np.int32)
        out = {"pred_logits": logits, "pred_coords": coords,
               "lengths": lengths, "unfinished": lengths >= L}
        if as_tensor:
            out = {k: torch.as_tensor(v) for k, v in out.items()}
        return out

    return decode_fn


@pytest.mark.parametrize("kind", ["clean", "gt_leak", "support_copy",
                                  "collapse"])
def test_audit_matches_jax(fixture_root, kind):
    """The same stub decode in both packages: equal audit dicts and report
    text (the port's stub returns tensors, which the audit brings to the
    host)."""
    cfg = jax_tiny_config(dataset_root=fixture_root["root"],
                          category_split_file=fixture_root["split_file"])
    batches = _batches(jax_builder, jax_episodic, cfg, "batch4_padded")
    want = jax_audit.audit_episodes(_stub(kind, False), iter(batches), cfg)
    got = port_audit.audit_episodes(_stub(kind, True), iter(batches),
                                    PortConfig.from_json(cfg.to_json()))
    assert got == want
    assert port_audit.format_audit_report(got) == \
        jax_audit.format_audit_report(want)
    flagged = {"clean": None, "gt_leak": "LEAK", "support_copy": "COPY",
               "collapse": "COLLAPSE"}[kind]
    if flagged:
        assert any(f.startswith(flagged) for f in got["flags"])
