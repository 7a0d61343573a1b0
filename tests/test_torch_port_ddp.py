"""Multi-process data parallelism of the port (`cape_tpu_torch.parallel`)
on the CPU: two real processes in a `gloo` group, against the JAX
package's single-process results.

- The train step: the tiny config in fp32, dropout 0,
  `accumulation_steps=2`; two ranks each take their half of a global
  batch of 4 over 2 micro-steps (one real update), and the halves hold
  different numbers of valid tokens (3 and 9 keypoints a row). Losses,
  `grad_norm` and every master after the update equal the JAX package's
  single-process step on the global batch within the tolerances of
  `test_torch_port_train.py`; the ranks' masters are bit-equal; plain
  gradient averaging (each rank normalised by its own tokens) misses the
  JAX step by more than those tolerances.
- Sharded evaluation: two ranks run `evaluate_cape(multihost=True)` over
  5 fixed episodes (rank 1 carries a padding row) and both report the
  JAX package's single-process PCK and counts.
- The sharding helpers against `cape_tpu.parallel` with its process index
  and count patched, and the group's collectives.
- The entry point: two processes of `cli.train --device cpu` for 2
  epochs, then a two-process resume from `epoch_0`.

The groups meet through a `file://` store in `tmp_path`. The workers
(`test_torch_port_ddp_worker.py`, and `python -m cape_tpu_torch.cli.train`)
import the port only; this process runs JAX while they run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from cape_tpu.data import builder as jax_builder
from cape_tpu.data import episodic as jax_episodic
from cape_tpu.eval import evaluate as jax_evaluate
from cape_tpu.parallel import distributed as jax_dist
from cape_tpu.train import state as jax_state
from cape_tpu.train import train_step as jax_step

from cape_tpu_torch import device as port_device
from cape_tpu_torch.config import CAPEConfig as PortConfig
from cape_tpu_torch.convert import from_jax_params
from cape_tpu_torch.data.synthetic import make_synthetic_mp100
from cape_tpu_torch.losses.criterion import loss_denominators
from cape_tpu_torch.models.layers import dropout
from cape_tpu_torch.parallel import distributed as port_dist
from cape_tpu_torch.train import state as port_state
from cape_tpu_torch.train import train_step as port_step
from cape_tpu_torch.utils import checkpoint as ck

from test_torch_port_ddp_worker import rows, save_batches
from test_torch_port_train import _check_update, _flat
from test_torch_port_util import few_torch_threads  # noqa: F401
from test_torch_port_util import jax_tiny, port_model, train_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_port_ddp_worker.py")
STEPS_PER_EPOCH = 4
#: the step's config: two micro-steps per update
STEP = dict(accumulation_steps=2)
#: the seeds of the two global batches. The tolerances of
#: `test_torch_port_train.py` hold only where fp32 summation order cannot
#: move the result: the tiny model's 1x1 extra level normalises 2 values a
#: GroupNorm group, which makes the gradient of some batches
#: ill-conditioned (on seed 22 the port's own step on the whole batch and
#: on its halves differ by 0.8% in grad_norm), and Adam's first update
#: divides each gradient element by its own size plus 1e-8, which
#: amplifies the noise of elements near zero (the port's own
#: single-process step misses JAX's update by up to 1.9 lr on 12 of 15
#: seed pairs tried from 40 to 98). The test asserts that its batches are
#: not such (`test_the_batches_are_well_conditioned`): the port's own
#: single-process step meets the tolerances on them, so that a reduction
#: error cannot hide in the conditioning.
BATCH_SEEDS = (48, 50)
#: the sharded eval: episodes, the global eval batch, the episode seed
EPISODES, EVAL_BATCH, EPISODE_SEED = 5, 4, 17
#: each worker's limit in seconds (a run takes ~20 s alone)
TIMEOUT = 300


def _launch(tmp_path, name, argvs, extra_env=None):
    """Start one process per argv as ranks 0.. of a group meeting at a
    file store; returns the Popen objects."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(CAPE_COORDINATOR=f"file://{tmp_path / f'store_{name}'}",
               CAPE_NUM_PROCESSES=str(len(argvs)), OMP_NUM_THREADS="2",
               PYTHONPATH=REPO, **(extra_env or {}))
    return [subprocess.Popen([sys.executable, *argv], cwd=REPO,
                             env=dict(env, CAPE_PROCESS_ID=str(r)),
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r, argv in enumerate(argvs)]


def _wait(procs):
    """Every process's output; all of them exit 0 or the test fails with
    their outputs (the others are killed: a rank alone waits forever)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    return outs


def _result(out):
    (line,) = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[len("RESULT "):])


# -- the two-rank worker: collectives, sharded eval, train step ---------------
def _global_batches(cfg):
    """Two global batches of 4 rows: rows 0-1 with 3 keypoints, rows 2-3
    with 9, so that rank 0's half holds fewer valid tokens than rank 1's."""
    out = []
    for seed in BATCH_SEEDS:
        a = train_batch(cfg, 2, seed=seed, n_kpts=3)
        b = train_batch(cfg, 2, seed=seed + 1, n_kpts=9)
        out.append(jax.tree_util.tree_map(
            lambda x, y: np.concatenate([x, y]), a, b))
    return out


def _jax_step(cfg, params, batches):
    """The JAX package's single-process step on the global batches:
    metrics of each micro-step and the params after them."""
    step = jax_step.make_train_step(jax_tiny(0, **STEP)[1], cfg,
                                    STEPS_PER_EPOCH, donate=False)
    st = jax_state.create_train_state(cfg, {"params": params},
                                      STEPS_PER_EPOCH)
    metrics = []
    for i, b in enumerate(batches):
        st, m = step(st, b, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _flat(st.params)


def _fixture_cfg(cfg, paths):
    return cfg.replace(dataset_root=paths["root"],
                       category_split_file=paths["split_file"])


def _jax_eval(cfg, params, paths):
    """The JAX package's single-process `evaluate_cape` on the episodes."""
    jcfg = _fixture_cfg(cfg, paths)
    ds = jax_builder.build_mp100_cape("val", jcfg)
    sampler = jax_episodic.EpisodicSampler(
        ds, jax_builder.resolve_split_file(jcfg), "val", num_queries=1,
        num_support=1)
    fixed = sampler.fixed_episodes(EPISODES, EPISODE_SEED)
    eb, nb = jax_episodic.eval_batch_plan(EPISODES, EVAL_BATCH)
    batches = jax_episodic.episode_batches(
        ds, sampler, eb, nb, jcfg.image_size, jcfg.max_support_keypoints,
        jcfg.max_skeleton_edges, np.random.default_rng(EPISODE_SEED),
        fixed=fixed, total_episodes=EPISODES)
    return jax_evaluate.evaluate_cape(jax_tiny(0, **STEP)[1], params,
                                      batches, jcfg)


def _port_grads(model, cfg, batch):
    """The port's single-process loss and fp32 gradients on `batch`."""
    params = list(model.parameters())
    losses = port_step.forward_losses(model, cfg, batch)
    grads = torch.autograd.grad(losses["total"], params)
    return losses["total"].item(), [g.float() for g in grads]


def _port_references(cfg, params, batches):
    """The port in this process, single-process: its step on the global
    batches (the gradient norms, their average for `_check_update`'s
    near-eps elements, taken at the initial weights as both micro-steps
    are, and the masters after the update), and what per-rank
    normalisation with averaged gradients gives (the mean of the halves'
    losses and the masters after the update)."""
    pcfg = PortConfig.from_json(cfg.to_json())
    ref = port_model(cfg, params)
    names = [n for n, _ in ref.named_parameters()]
    g = [_port_grads(ref, pcfg, b)[1] for b in batches]
    norms = [port_state.global_norm(x).item() for x in g]
    acc = {n: (a + (b - a) / 2).numpy() for n, a, b in zip(names, *g)}
    st = port_state.create_train_state(pcfg, ref, STEPS_PER_EPOCH)
    step = port_step.make_train_step(ref, pcfg, STEPS_PER_EPOCH)
    for b in batches:
        st, _ = step(st, b)
    single = {n: m.numpy() for n, m in zip(names, st.opt_state.masters)}
    pm = port_model(cfg, params)
    st = port_state.create_train_state(pcfg, pm, STEPS_PER_EPOCH)
    totals = []
    for b in batches:
        halves = [_port_grads(pm, pcfg, rows(b, lo, 2)) for lo in (0, 2)]
        totals.append((halves[0][0] + halves[1][0]) / 2)
        avg = [(x + y) / 2 for x, y in zip(halves[0][1], halves[1][1])]
        st.tx.update(avg, st.opt_state, list(pm.parameters()))
    masters = {n: m.numpy() for n, m in zip(names, st.opt_state.masters)}
    return dict(norms=norms, acc=acc, single=single, plain_totals=totals,
                plain_masters=masters)


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """Two worker ranks on the seeded tiny weights, and in this process
    meanwhile the JAX package's step and evaluation and the plain
    averaging."""
    tmp = tmp_path_factory.mktemp("ddp")
    cfg, _, params = jax_tiny(0, **STEP)
    pcfg = PortConfig.from_json(cfg.to_json())
    paths = make_synthetic_mp100(str(tmp / "tree"), num_categories=6,
                                 images_per_category=7, keypoint_range=(4, 8))
    batches = _global_batches(cfg)
    torch.save(from_jax_params(params, pcfg), tmp / "weights.pt")
    save_batches(str(tmp / "batches.npz"), batches)
    spec = {"config": _fixture_cfg(pcfg, paths).to_json(),
            "weights": str(tmp / "weights.pt"),
            "batches": str(tmp / "batches.npz"),
            "masters": str(tmp / "masters.pt"),
            "steps_per_epoch": STEPS_PER_EPOCH, "episodes": EPISODES,
            "episode_seed": EPISODE_SEED, "eval_batch_size": EVAL_BATCH}
    with open(tmp / "spec.json", "w") as f:
        json.dump(spec, f)
    procs = _launch(tmp, "worker", [[WORKER, str(tmp / "spec.json")]] * 2)
    try:
        jax_metrics, jax_after = _jax_step(cfg, params, batches)
        jax_stats = _jax_eval(cfg, params, paths)
        port = _port_references(cfg, params, batches)
    finally:
        outs = _wait(procs)
    yield dict(cfg=cfg, params=params, batches=batches,
               results=[_result(o) for o in outs], jax_metrics=jax_metrics,
               jax_after=jax_after, jax_stats=jax_stats, port=port,
               masters={k: v.numpy() for k, v in torch.load(
                   tmp / "masters.pt", weights_only=True).items()})


def test_collectives_under_the_group(ddp):
    r0, r1 = ddp["results"]
    assert [(r["multi"], r["rank"], r["main"], r["count"])
            for r in (r0, r1)] == [(True, 0, True, 2), (True, 1, False, 2)]
    for r in (r0, r1):
        c = r["collectives"]
        assert c["summed"] == {"a": 3.0, "b": 0.5}
        assert c["gathered"] == {"f": [[0.0] * 3] * 2 + [[1.0] * 3] * 2,
                                 "i": [0, 7, 1, 7],
                                 "b": [True, True, False, True]}
        assert c["dtypes"] == {"f": "float32", "i": "int32", "b": "bool"}
        assert c["objects"] == [{"rank": 0}, {"rank": 1}]
    # replicate() gave rank 1 rank 0's weights back
    assert r0["collectives"]["weights"] == r1["collectives"]["weights"]


def test_two_rank_step_equals_the_jax_global_step(ddp):
    """Losses and grad_norm of each micro-step, and every master after the
    real update, against the JAX package's single-process step on the
    global batch; the ranks' masters bit-equal."""
    cfg = ddp["cfg"]
    r0, r1 = (r["train"] for r in ddp["results"])
    # rank 0's half holds fewer valid tokens than rank 1's
    for d0, d1 in zip(r0["denominators"], r1["denominators"]):
        assert d0[0] < d1[0] and d0[1] < d1[1]
    assert r0["metrics"] == r1["metrics"]
    assert r0["masters"] == r1["masters"]
    assert (r0["step"], r0["gradient_step"]) == (2, 1)
    for i, (got, want) in enumerate(zip(r0["metrics"], ddp["jax_metrics"])):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"micro-step {i + 1} {k}")
    before = _flat(ddp["params"])
    _check_update(cfg, before, ddp["jax_after"], before, ddp["masters"],
                  ddp["port"]["acc"], count=0)


def test_the_batches_are_well_conditioned(ddp):
    """On the global batches the port's own single-process step gives
    JAX's gradient norms to 1e-5 and meets `_check_update` (see
    BATCH_SEEDS)."""
    port = ddp["port"]
    for got, want in zip(port["norms"], ddp["jax_metrics"]):
        np.testing.assert_allclose(got, want["grad_norm"], rtol=1e-5)
    before = _flat(ddp["params"])
    _check_update(ddp["cfg"], before, ddp["jax_after"], before,
                  port["single"], port["acc"], count=0)


def test_plain_gradient_averaging_misses_the_jax_step(ddp):
    """The check above can fail: with each rank normalised by its own
    tokens and the gradients averaged, the losses and the update miss the
    JAX step by more than its tolerances."""
    port = ddp["port"]
    for got, want in zip(port["plain_totals"], ddp["jax_metrics"]):
        assert abs(got - want["total"]) > 1e-4 * abs(want["total"])
    before = _flat(ddp["params"])
    with pytest.raises(AssertionError, match="Mismatched elements"):
        _check_update(ddp["cfg"], before, ddp["jax_after"], before,
                      port["plain_masters"], port["acc"], count=0)


def test_sharded_eval_equals_jax_single_process(ddp):
    """Both ranks score the full gathered set: the JAX package's counts
    and PCK. Rank 1's slice holds a padding row."""
    want = ddp["jax_stats"]
    assert want["num_images"] == EPISODES
    r0, r1 = (r["eval"] for r in ddp["results"])
    assert (r0["local_valid"], r1["local_valid"]) == (3, 2)
    assert (r0["batch"], r0["batches"]) == (2, 2)
    assert r0 == {**r1, "local_valid": 3}
    for k in ("pck_num_correct", "pck_num_visible", "num_images"):
        assert r0[k] == want[k], k
    for k in ("pck", "pck_mean_categories"):
        assert abs(r0[k] - want[k]) <= 1e-12, k
    assert r0["pck_per_category"] == {
        str(k): v for k, v in want["pck_per_category"].items()}


# -- the sharding helpers against cape_tpu.parallel --------------------------
@pytest.mark.parametrize("n,rank", [(n, r) for n in range(1, 5)
                                    for r in range(n)])
def test_sharding_helpers_match_jax(monkeypatch, n, rank):
    monkeypatch.setattr(jax, "process_count", lambda: n)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(port_dist, "process_count", lambda: n)
    monkeypatch.setattr(port_dist, "process_index", lambda: rank)
    for seed, epoch in ((0, 0), (7, 3)):
        assert (port_dist.host_rng(seed, epoch).bit_generator.state
                == jax_dist.host_rng(seed, epoch).bit_generator.state)
    episodes = [{"id": i} for i in range(7)]
    for total in (1, 5, 7):
        assert (port_dist.host_episode_slice(episodes, total)
                == jax_dist.host_episode_slice(episodes, total))
    for batch in (4, 12):
        if batch % n:
            for lib in (port_dist, jax_dist):
                with pytest.raises(ValueError, match="not divisible"):
                    lib.local_episode_count(batch)
        else:
            assert (port_dist.local_episode_count(batch)
                    == jax_dist.local_episode_count(batch))
    assert port_dist.is_main() == jax_dist.is_main() == (rank == 0)


def test_without_a_launch_nothing_is_initialized(monkeypatch):
    for k in ("CAPE_COORDINATOR", "CAPE_NUM_PROCESSES", "RANK",
              "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert port_dist.maybe_initialize() is False
    assert not torch.distributed.is_initialized()
    assert (port_dist.process_count(), port_dist.process_index()) == (1, 0)
    tree = {"a": torch.arange(3), "b": {"c": np.ones((2, 2), bool)}}
    got = port_dist.allgather_tree(tree)
    assert got["a"].tolist() == [0, 1, 2] and got["b"]["c"].all()
    assert port_dist.allreduce_sum_dict({"x": 2.5}) == {"x": 2.5}
    assert port_dist.allgather_object(3) == [3]


def test_one_rank_group_and_no_backend_switch(monkeypatch, tmp_path):
    """A one-rank group through the CAPE_* variables (gloo without CUDA:
    not multi-process, its collectives skipped), and a requested nccl
    that cannot start raises instead of falling back to gloo."""
    monkeypatch.setenv("CAPE_COORDINATOR", f"file://{tmp_path / 'store'}")
    monkeypatch.setenv("CAPE_NUM_PROCESSES", "1")
    monkeypatch.setenv("CAPE_PROCESS_ID", "0")
    try:
        assert port_dist.maybe_initialize() is False
        assert torch.distributed.get_backend() == "gloo"
        assert port_dist.maybe_initialize() is False       # made already
        assert port_dist.process_count() == 1 and port_dist.is_main()
    finally:
        torch.distributed.destroy_process_group()
    monkeypatch.setenv("CAPE_COORDINATOR", f"file://{tmp_path / 'store2'}")
    with pytest.raises(RuntimeError, match="nccl backend needs CUDA"):
        port_dist.maybe_initialize("nccl")
    assert not torch.distributed.is_initialized()


def test_cuda_is_the_ranks_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(port_device, "process_count", lambda: 1)
    assert port_device.resolve_device("cuda") == torch.device("cuda")
    monkeypatch.setattr(port_device, "process_count", lambda: 8)
    monkeypatch.setattr(port_dist, "process_index", lambda: 6)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert port_device.resolve_device(None) == torch.device("cuda", 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert port_device.resolve_device("cuda") == torch.device("cuda", 3)
    assert port_device.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_loss_denominators_are_the_criterion_means():
    """Dividing by `loss_denominators` is the criterion's own mean, and the
    halves' denominators add up to the whole batch's."""
    cfg, _, _ = jax_tiny(0)
    pcfg = PortConfig.from_json(cfg.to_json())
    batch = _global_batches(cfg)[0]
    targets = {k: torch.from_numpy(v) for k, v in batch["targets"].items()}
    rng = np.random.default_rng(3)
    out = {"pred_logits": torch.from_numpy(
               rng.normal(size=(4, cfg.seq_len, 3)).astype(np.float32)),
           "pred_coords": torch.from_numpy(
               rng.uniform(size=(4, cfg.seq_len, 2)).astype(np.float32))}
    from cape_tpu_torch.losses import cape_criterion

    for smoothing in (0.0, 0.1):
        c = pcfg.replace(label_smoothing=smoothing)
        den = loss_denominators(targets, c)
        halves = [loss_denominators(rows(targets, lo, 2), c)
                  for lo in (0, 2)]
        torch.testing.assert_close(halves[0] + halves[1], den, rtol=0, atol=0)
        own = cape_criterion(out, targets, c)
        given = cape_criterion(out, targets, c, denominators=den)
        for k in own:
            assert torch.equal(own[k], given[k]), k
        parts = [cape_criterion(rows(out, lo, 2), rows(targets, lo, 2), c,
                                denominators=den) for lo in (0, 2)]
        for k in own:
            torch.testing.assert_close(parts[0][k] + parts[1][k], own[k],
                                       rtol=1e-6, atol=1e-7)


# -- the entry point -----------------------------------------------------------
#: the tiny config's flags (`test_torch_port_resume.TINY_FLAGS`) with a
#: global batch of 2 (one episode a rank) and dropout on
CLI_FLAGS = ["--backbone", "resnet_tiny", "--image_size", "64",
             "--hidden_dim", "64", "--dim_feedforward", "128",
             "--enc_layers", "2", "--dec_layers", "2", "--nheads", "4",
             "--seq_len", "24", "--vocab_size", "100",
             "--support_encoder_layers", "1", "--num_gcn_layers", "1",
             "--batch_size", "2", "--accumulation_steps", "1",
             "--warmup_epochs", "0", "--no_bf16", "--dropout", "0.1",
             "--episodes_per_epoch", "4", "--val_episodes_per_epoch", "4",
             "--eval_batch_size", "2", "--num_data_threads", "1",
             "--print_freq", "0", "--device", "cpu"]


def _cli(paths, out, *extra):
    return ["-m", "cape_tpu_torch.cli.train", *CLI_FLAGS,
            "--dataset_root", paths["root"],
            "--category_split_file", paths["split_file"],
            "--output_dir", str(out), *extra]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two ranks of `cli.train` for 2 epochs, each rank with its own
    --output_dir (as on hosts without a shared disk: rank 1's must stay
    absent), then two ranks resumed from the straight run's `epoch_0`."""
    tmp = tmp_path_factory.mktemp("ddp_cli")
    paths = make_synthetic_mp100(str(tmp / "tree"), num_categories=6,
                                 images_per_category=6)
    straight = _wait(_launch(tmp, "straight", [
        _cli(paths, tmp / f"straight_{r}", "--epochs", "2")
        for r in range(2)]))
    resumed = _wait(_launch(tmp, "resumed", [
        _cli(paths, tmp / f"resumed_{r}", "--epochs", "2",
             "--resume", str(tmp / "straight_0" / "epoch_0"))
        for r in range(2)]))
    yield dict(tmp=tmp, straight=straight, resumed=resumed)


def _done_line(out):
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("Training done.")]
    return line


def test_cli_train_two_processes(cli_runs):
    """Both ranks finish with the same best PCK; rank 0 alone logs and
    writes checkpoints, and its epochs' validation covers every episode."""
    tmp, (o0, o1) = cli_runs["tmp"], cli_runs["straight"]
    assert _done_line(o0) == _done_line(o1)
    assert "Epoch 1: train loss" in o0 and "train loss" not in o1
    assert "2 process(es)" in o0
    assert not (tmp / "straight_1").exists()
    names = os.listdir(tmp / "straight_0")
    assert {"epoch_0", "epoch_1"} <= set(names)
    meta = ck.read_meta(str(tmp / "straight_0" / "epoch_1"))
    assert meta["extra"]["val_stats"]["num_images"] == 4
    best = max(ck.read_meta(str(tmp / "straight_0" / f"epoch_{e}"))[
        "extra"]["val_stats"]["pck"] for e in (0, 1))
    assert f"{best:.2%}" in _done_line(o1)


def test_cli_ranks_draw_different_dropout(cli_runs):
    """The checkpoint keeps both ranks' rng states; their dropout
    generators differ (so do their masks), rank 0's pair is also the
    top-level one a single-process restore reads."""
    meta = ck.read_meta(str(cli_runs["tmp"] / "straight_0" / "epoch_1"))
    s0, s1 = meta["rank_states"]
    assert (meta["rng_state"], meta["torch_rng_state"]) == (
        s0["rng_state"], s0["torch_rng_state"])
    assert s0["rng_state"] != s1["rng_state"]
    masks = []
    for s in (s0, s1):
        gen = ck.restore_torch_rng(torch.Generator(), s["torch_rng_state"])
        masks.append(dropout(torch.ones(4096), 0.1, gen) == 0)
    assert not torch.equal(*masks)
    assert 0 < masks[0].sum() < 4096


def test_cli_two_process_resume_is_exact(cli_runs):
    """A two-rank resume from `epoch_0` ends on the straight run's masters,
    moments and rng states, bit for bit (the same ops on the same host)."""
    tmp = cli_runs["tmp"]
    a = ck.load_state(str(tmp / "straight_0" / "epoch_1"))
    b = ck.load_state(str(tmp / "resumed_0" / "epoch_1"))
    for key in ("params", "mu", "nu"):
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)
    ma = ck.read_meta(str(tmp / "straight_0" / "epoch_1"))
    mb = ck.read_meta(str(tmp / "resumed_0" / "epoch_1"))
    assert ma["rank_states"] == mb["rank_states"]
    assert ma["extra"]["val_stats"] == mb["extra"]["val_stats"]
    assert "Resumed from" in cli_runs["resumed"][0]
    assert not (tmp / "resumed_1").exists()
