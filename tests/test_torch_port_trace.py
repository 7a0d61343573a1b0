"""The port's spans and counters (`cape_tpu_torch.trace`) on the CPU.

Off (the default), a span is one shared no-op and records nothing; on,
spans nest on their thread, inherit the request of their root span and
land in a `torch.profiler` trace as `cape.<name>`, nested as recorded.
A tiny-config `predict` and `evaluate_cape` record the serving and
evaluation spans in order, and the eager decode counts its token bodies
and host reads. No JAX: the package alone.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cape_tpu_torch import trace
from cape_tpu_torch.config import tiny_test_config
from cape_tpu_torch.data.prefetch import prefetch, to_device
from cape_tpu_torch.eval import evaluate_cape
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.serve import CAPEPredictor


@pytest.fixture(autouse=True)
def tracing_restored():
    """Each test starts with tracing off and nothing recorded, and leaves
    it so."""
    trace.enable(False)
    trace.take()
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    trace.enable(False)
    trace.take()
    torch.set_num_threads(n)


def _names(taken):
    return [s["name"] for s in sorted(taken["spans"],
                                      key=lambda s: s["start_ns"])]


@pytest.mark.parametrize("make", [lambda: trace.span("a"),
                                  lambda: trace.span("a", root=True),
                                  lambda: trace.device_span("a", "cpu")],
                         ids=["span", "root", "device_span"])
def test_off_is_one_shared_noop(make):
    assert not trace.enabled()
    first, second = make(), make()
    assert first is second is trace.span("b")
    with first:
        with second:
            pass
    assert trace.take()["spans"] == []


def test_counters_count_on_and_off():
    before = trace.counters().get("test.things", 0)
    trace.count("test.things")
    trace.enable()
    trace.count("test.things", 3)
    assert trace.counters()["test.things"] == before + 4
    assert trace.take()["counters"]["test.things"] == before + 4
    assert trace.counters()["test.things"] == before + 4    # take keeps them


def test_the_docstring_lists_every_counter():
    """Every counter the port counts (`trace.count("<name>")` in its
    sources) is listed in `trace`'s docstring, the relative-attention
    route's `vitdet.rel_attn` among them."""
    import pathlib
    import re

    root = pathlib.Path(trace.__file__).parent
    names = set()
    for path in root.rglob("*.py"):
        names |= set(re.findall(r'trace\.count\("([\w.]+)"',
                                path.read_text()))
    assert "vitdet.rel_attn" in names and "swin.window_attn" in names
    missing = [n for n in sorted(names) if f"`{n}`" not in trace.__doc__]
    assert not missing, missing


def test_nesting_parents_and_requests():
    trace.enable()
    with trace.span("outside"):
        pass
    for _ in range(2):
        with trace.span("root", root=True):
            with trace.span("child"):
                with trace.device_span("grandchild", "cpu"):
                    time.sleep(0.001)
            with trace.span("sibling"):
                pass
    trace.enable(False)
    with trace.span("after"):
        pass
    taken = trace.take()
    by_id = {s["id"]: s for s in taken["spans"]}
    assert _names(taken) == ["outside", "root", "child", "grandchild",
                             "sibling", "root", "child", "grandchild",
                             "sibling"]
    spans = sorted(taken["spans"], key=lambda s: s["start_ns"])
    outside, roots = spans[0], [spans[1], spans[5]]
    assert outside["parent"] is None and outside["request"] is None
    assert roots[0]["request"] != roots[1]["request"]
    for root, group in zip(roots, (spans[1:5], spans[5:9])):
        assert root["parent"] is None and root["request"] == root["id"]
        for s in group:
            assert s["request"] == root["request"]
            assert s["thread"] == threading.get_ident()
            assert root["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= root["end_ns"]
        child, grand, sib = group[1:]
        assert child["parent"] == root["id"] == sib["parent"]
        assert grand["parent"] == child["id"]
        assert by_id[grand["parent"]]["name"] == "child"
        # on the CPU a device span is timed by the host clock
        assert grand["device_ms"] == pytest.approx(
            (grand["end_ns"] - grand["start_ns"]) * 1e-6)
        assert grand["device_start_ns"] == grand["start_ns"]
        assert grand["device_ms"] >= 1.0
        assert "device_ms" not in child


def test_open_spans_wait_for_the_next_take():
    trace.enable()
    with trace.span("open"):
        with trace.span("done"):
            pass
        assert _names(trace.take()) == ["done"]
    assert _names(trace.take()) == ["open"]


def test_a_span_ending_during_a_take_is_taken_once():
    trace.enable()
    n, stop = 20000, threading.Event()

    def worker():
        for _ in range(n):
            with trace.span("w"):
                pass
        stop.set()

    t = threading.Thread(target=worker)
    t.start()
    seen = []
    while not stop.is_set():
        seen += [s["id"] for s in trace.take()["spans"]]
    t.join()
    seen += [s["id"] for s in trace.take()["spans"]]
    assert len(seen) == len(set(seen)) == n


def test_prefetch_producer_spans_run_on_their_thread():
    trace.enable()
    items = [{"x": np.full((2, 3), i, np.float32)} for i in range(4)]
    with trace.span("consumer", root=True):
        got = list(prefetch(iter(items),
                            transform=lambda b: to_device(b, "cpu")))
    assert [float(g["x"][0, 0]) for g in got] == [0, 1, 2, 3]
    spans = trace.take()["spans"]
    names = [s["name"] for s in spans]
    assert names.count("prefetch.build") == 5      # 4 items and the end
    assert names.count("prefetch.copy") == 4
    assert names.count("prefetch.wait") == 5       # 4 items and the end
    (root,) = [s for s in spans if s["name"] == "consumer"]
    main = threading.get_ident()
    for s in spans:
        if s["name"] in ("prefetch.build", "prefetch.copy"):
            assert s["thread"] != main
            assert s["parent"] is None and s["request"] is None
        elif s["name"] == "prefetch.wait":
            assert s["thread"] == main
            assert s["parent"] == root["id"]
            assert s["request"] == root["request"]


def test_anchor_maps_spans_onto_unix_time():
    trace.enable()
    t0 = time.time_ns()
    with trace.span("a"):
        time.sleep(0.002)
    t1 = time.time_ns()
    taken = trace.take()
    (s,) = taken["spans"]
    slack = 1_000_000        # the two clocks are read at different moments
    assert t0 - slack <= s["start_ns"] + taken["anchor_ns"] <= t1 + slack
    assert t0 - slack <= s["end_ns"] + taken["anchor_ns"] <= t1 + slack
    assert taken["at_ns"] >= s["end_ns"]


def test_spans_land_in_the_profiler_trace_as_recorded():
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("root", root=True):
            with trace.span("child"):
                with trace.device_span("leaf", "cpu"):
                    torch.ones(16) + 1
            with trace.span("sibling"):
                pass
    recorded = trace.take()["spans"]
    by_id = {s["id"]: s for s in recorded}
    events = {e.name: e for e in prof.events() if e.name.startswith("cape.")}
    assert set(events) == {"cape." + s["name"] for s in recorded}
    for s in recorded:
        parent = events["cape." + s["name"]].cpu_parent
        if s["parent"] is None:
            assert parent is None or not parent.name.startswith("cape.")
        else:
            assert parent.name == "cape." + by_id[s["parent"]]["name"]


def test_spans_outside_a_profiler_record_no_profiler_event():
    trace.enable()
    with trace.span("quiet"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4) + 1
    assert not [e for e in prof.events() if e.name.startswith("cape.")]
    assert _names(trace.take()) == ["quiet"]


# -- the program's spans -----------------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_test_config()
    return cfg, CAPE(cfg, device="cpu")


def _decode_names(steps: int, reads: int):
    # the CPU's prologue runs eagerly, so `CAPE.encode_image` opens its
    # `backbone` device span inside it
    names = ["decode", "decode.inputs", "decode.prologue", "backbone"]
    for i in range(steps):
        names.append("decode.chunk")
        if i < reads:
            names.append("decode.host_read")
    return names + ["decode.outputs"]


def test_predict_records_its_spans_in_order(tiny):
    cfg, model = tiny
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), np.uint8)
              for h, w in ((40, 50), (70, 30), (64, 64))]
    support = rng.uniform(0.1, 0.9, (5, 2)).astype(np.float32)
    pred = CAPEPredictor(cfg, model, batch_size=2, device="cpu")
    trace.enable()
    c0 = trace.counters()
    out = pred.predict(images, support, skeleton=[[0, 1], [1, 2]],
                       bboxes=[(2, 3, 30, 30), None, (0, 0, 64, 64)])
    c1 = trace.counters()
    taken = trace.take()
    assert len(out) == 3
    spans = sorted(taken["spans"], key=lambda s: s["start_ns"])
    root = spans[0]
    assert root["name"] == "serve.predict" and root["request"] == root["id"]
    assert all(s["request"] == root["request"] for s in spans)
    chunks = [s for s in spans if s["name"] == "decode.chunk"]
    reads = [s for s in spans if s["name"] == "decode.host_read"]
    assert c1["decode.steps"] - c0.get("decode.steps", 0) == len(chunks)
    assert c1["decode.host_reads"] - c0.get("decode.host_reads", 0) \
        == len(reads)
    want = ["serve.predict"] + ["serve.prepare"] * 3
    tokens = iter(_batch_tokens(spans))
    for _ in range(2):                 # two batches of two
        steps, n_reads = next(tokens)
        want += (["serve.batch"] + _decode_names(steps, n_reads)
                 + ["serve.fetch", "serve.extract"])
    assert [s["name"] for s in spans] == want


def _decodes(spans):
    return [s for s in spans if s["name"] == "decode"]


def _batch_tokens(spans):
    """(token bodies, host reads) of each decode, from its children."""
    out = []
    for d in _decodes(spans):
        inner = [s for s in spans if s["parent"] == d["id"]]
        out.append((sum(s["name"] == "decode.chunk" for s in inner),
                    sum(s["name"] == "decode.host_read" for s in inner)))
    return out


def _eval_batch(cfg, seed, b=2, n=4):
    rng = np.random.default_rng(seed)
    S, K, L = cfg.image_size, cfg.max_support_keypoints, cfg.seq_len
    mask = np.ones((b, K), bool)
    mask[:, :n] = False
    seq = np.zeros((b, L, 2), np.float32)
    seq[:, :n] = rng.uniform(0.1, 0.9, (b, n, 2))
    labels = np.full((b, L), 3, np.int64)
    labels[:, :n] = 0
    labels[:, n] = 2
    sc = np.zeros((b, K, 2), np.float32)
    sc[:, :n] = rng.uniform(0.1, 0.9, (b, n, 2))
    return {"query_images": rng.integers(0, 256, (b, S, S, 3), np.uint8),
            "support_coords": sc, "support_mask": mask,
            "skeleton_edges": np.full((b, cfg.max_skeleton_edges, 2), -1,
                                      np.int32),
            "targets": {"target_seq": seq, "token_labels": labels},
            "category_ids": np.array([7] * b), "bbox_dims":
            np.full((b, 2), 64.0, np.float32),
            "gt_visibility": np.full((b, K), 2, np.int64),
            "num_keypoints": np.full((b,), n, np.int64),
            "sample_valid": np.ones((b,), bool)}


@pytest.mark.parametrize("with_loss", [False, True])
def test_evaluate_cape_records_its_spans_in_order(tiny, with_loss):
    cfg, model = tiny
    batches = [_eval_batch(cfg, s) for s in (1, 2)]
    trace.enable()
    c0 = trace.counters()
    # the loss runs inside the batch's span, with no span of its own; its
    # own inputs (tokenized targets) are not the point here
    kw = (dict(compute_loss=True,
               eval_loss_fn=lambda b: {"loss": torch.tensor(1.0)})
          if with_loss else {})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # samples that reach the cap
        stats = evaluate_cape(model, batches, cfg, decode_max_len=5, **kw)
    c1 = trace.counters()
    spans = sorted(trace.take()["spans"], key=lambda s: s["start_ns"])
    assert stats["num_images"] == 4
    roots = [s for s in spans if s["name"] == "eval.batch"]
    assert len(roots) == 2 and roots[0]["request"] != roots[1]["request"]
    want = []
    for steps, n_reads in _batch_tokens(spans):
        assert steps <= 5
        want += (["eval.batch"] + _decode_names(steps, n_reads)
                 + ["eval.fetch", "eval.score"])
    assert [s["name"] for s in spans] == want
    for root in roots:
        inner = [s for s in spans if s["request"] == root["request"]]
        assert inner[0] is root and all(
            root["start_ns"] <= s["start_ns"] <= s["end_ns"]
            <= root["end_ns"] for s in inner)
    steps = sum(s["name"] == "decode.chunk" for s in spans)
    reads = sum(s["name"] == "decode.host_read" for s in spans)
    assert c1["decode.steps"] - c0.get("decode.steps", 0) == steps
    assert c1["decode.host_reads"] - c0.get("decode.host_reads", 0) == reads
    # one token body a chunk: a read after every body but a decode's last
    assert steps - 2 <= reads <= steps


def test_decode_counts_with_tracing_off(tiny):
    cfg, model = tiny
    c0 = trace.counters()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        evaluate_cape(model, [_eval_batch(cfg, 3)], cfg, decode_max_len=4)
    c1 = trace.counters()
    steps = c1["decode.steps"] - c0.get("decode.steps", 0)
    reads = c1["decode.host_reads"] - c0.get("decode.host_reads", 0)
    assert 1 <= steps <= 4 and reads in (steps - 1, steps)
    assert trace.take()["spans"] == []
