"""The port's host training loop (`train.loop.train_loop`) and its CLIs
against the JAX package's on the CPU, on the synthetic MP-100 fixture.

The JAX `train_loop` runs once per module (tiny config, fp32, dropout 0,
augmentation on, 2 epochs of 4 micro-steps with `accumulation_steps=2`,
one CPU device). The port's loop then trains the JAX loop's initial
weights, carried over by `convert.from_jax_params`, and must see the same
train batches byte for byte (recorded where both loops validate them),
per-step losses within rtol 1e-4 (`test_torch_port_train.py`'s trajectory
tolerance), the same validation PCK counts per epoch and the same
checkpoint names. A JAX orbax checkpoint, restored by JAX and carried over
by `convert.from_jax_train_state`, resumes in the port to the JAX loop's
next-epoch batches and losses. The JAX loop's resume is exact (its own
`tests/test_train_e2e.py::test_resume_is_exact`), so its uninterrupted
second epoch stands for the JAX resume.

A port run with its validation skipped trains the same steps bit for bit.
The loop's cases that need no JAX run are in `test_torch_port_resume.py`.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import flax.serialization
import jax

from cape_tpu.config import tiny_test_config as jax_tiny_config
from cape_tpu.data.builder import build_mp100_cape as jax_build
from cape_tpu.models import CAPE as JaxCAPE
from cape_tpu.train import loop as jax_loop
from cape_tpu.utils.checkpoint import CheckpointManager as JaxCkpt

from cape_tpu_torch.config import CAPEConfig
from cape_tpu_torch.convert import from_jax_params, from_jax_train_state
from cape_tpu_torch.data.builder import build_mp100_cape
from cape_tpu_torch.data.synthetic import make_synthetic_mp100
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.train import create_train_state
from cape_tpu_torch.train import loop as port_loop
from cape_tpu_torch.utils import checkpoint as ck

from test_torch_port_util import few_torch_threads  # noqa: F401
from test_torch_port_util import record_loop, same_bytes

LOSS_RTOL = 1e-4
EPOCHS, STEPS = 2, 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    paths = make_synthetic_mp100(str(root / "tree"), num_categories=6,
                                 images_per_category=6)
    jcfg = jax_tiny_config(
        dataset_root=paths["root"], category_split_file=paths["split_file"],
        output_dir=str(root / "jax"), epochs=EPOCHS,
        episodes_per_epoch=STEPS, val_episodes_per_epoch=4,
        eval_batch_size=2, accumulation_steps=2, num_data_threads=2,
        mesh_shape=(1,), early_stopping_patience=0)
    with pytest.MonkeyPatch.context() as mp:
        jrec = record_loop(mp, jax_loop, np.asarray)
        make_state = jax_loop.create_train_state

        def create(cfg, variables, spe):
            jrec["init"] = jax.device_get(variables["params"])
            return make_state(cfg, variables, spe)

        mp.setattr(jax_loop, "create_train_state", create)
        jres = jax_loop.train_loop(
            JaxCAPE(jcfg), jcfg, jax_build("train", jcfg),
            jax_build("val", jcfg), paths["split_file"], print_freq=0)

    pcfg = CAPEConfig.from_json(jcfg.to_json()).replace(
        output_dir=str(root / "port"))
    with pytest.MonkeyPatch.context() as mp:
        prec = record_loop(mp, port_loop, lambda v: v.detach().numpy())
        model = CAPE(pcfg, device="cpu")
        model.load_state_dict(from_jax_params(jrec["init"], pcfg))
        pres = port_loop.train_loop(
            model, pcfg, build_mp100_cape("train", pcfg),
            build_mp100_cape("val", pcfg), paths["split_file"], print_freq=0)
    yield dict(root=root, paths=paths, jcfg=jcfg, pcfg=pcfg, jres=jres,
               pres=pres, jrec=jrec, prec=prec)
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(autouse=True)
def _drop_outputs(tmp_path):
    """A tiny model's checkpoint is ~156 MB: each test removes what it
    wrote."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


# -- the port's loop against the JAX loop ----------------------------------------
def test_train_batches_byte_equal(runs):
    jb, pb = runs["jrec"]["batches"], runs["prec"]["batches"]
    assert len(jb) == len(pb) == EPOCHS * STEPS
    for i, (a, b) in enumerate(zip(jb, pb)):
        same_bytes(b, a, f"step {i}")
    # augmentation ran: the same query image differs between episodes
    assert len({b["query_images"].tobytes() for b in pb}) == len(pb)


def test_per_step_losses_match(runs):
    jm, pm = runs["jrec"]["metrics"], runs["prec"]["metrics"]
    assert len(jm) == len(pm) == EPOCHS * STEPS
    for i, (a, b) in enumerate(zip(jm, pm)):
        for k in ("total", "loss_ce", "loss_coords"):
            np.testing.assert_allclose(b[k], a[k], rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
    jh, ph = runs["jres"]["history"], runs["pres"]["history"]
    assert [h["epoch"] for h in ph] == [h["epoch"] for h in jh] == [0, 1]
    np.testing.assert_allclose([h["train_loss"] for h in ph],
                               [h["train_loss"] for h in jh], rtol=LOSS_RTOL)


def test_val_pck_counts_and_checkpoint_names(runs):
    jdir, pdir = runs["jcfg"].output_dir, runs["pcfg"].output_dir
    names = sorted(n for n in os.listdir(jdir) if not n.startswith("."))
    assert sorted(n for n in os.listdir(pdir)
                  if not n.startswith(".")) == names
    for h in runs["pres"]["history"]:
        meta = ck.read_meta(os.path.join(jdir, f"epoch_{h['epoch']}"))
        vs = meta["extra"]["val_stats"]
        assert (h["pck_num_correct"], h["pck_num_visible"]) == (
            vs["pck_num_correct"], vs["pck_num_visible"])
        assert h["pck_num_visible"] > 0
        port_meta = ck.read_meta(os.path.join(pdir, f"epoch_{h['epoch']}"))
        assert port_meta["rng_state"] == meta["rng_state"]
        assert (port_meta["best_pck"], port_meta["patience"]) == (
            meta["best_pck"], meta["patience"])
    assert runs["pres"]["best_pck"] == runs["jres"]["best_pck"]


def test_jax_orbax_checkpoint_resumes_in_the_port(runs, tmp_path):
    """epoch_0 of the JAX run: restored by JAX, carried over, written as a
    port checkpoint, resumed by the port's loop for epoch 1."""
    from cape_tpu.train.state import create_train_state as jax_state

    jcfg, pcfg = runs["jcfg"], runs["pcfg"]
    spe = STEPS // jcfg.batch_size
    target = jax_state(jcfg, {"params": runs["jrec"]["init"]}, spe)
    src = os.path.join(jcfg.output_dir, "epoch_0")
    jstate, meta = JaxCkpt(jcfg.output_dir).restore(src, target)
    sd = from_jax_train_state(
        flax.serialization.to_state_dict(jax.device_get(jstate)), pcfg)

    cfg = pcfg.replace(output_dir=str(tmp_path / "resumed"))
    model = CAPE(cfg, device="cpu")
    state = create_train_state(cfg, model, spe)
    state.load_state_dict(sd)
    mgr = ck.CheckpointManager(str(tmp_path / "carried"))
    mgr.save_epoch(state, meta["epoch"], cfg, meta["best_pck"],
                   meta["patience"], rng_state=meta["rng_state"])
    with pytest.MonkeyPatch.context() as mp:
        rec = record_loop(mp, port_loop, lambda v: v.detach().numpy())
        res = port_loop.train_loop(
            CAPE(cfg, device="cpu"), cfg, build_mp100_cape("train", cfg),
            build_mp100_cape("val", cfg), runs["paths"]["split_file"],
            resume=mgr.latest(), print_freq=0)
    assert [h["epoch"] for h in res["history"]] == [1]
    for i, (a, b) in enumerate(zip(runs["jrec"]["batches"][STEPS:],
                                   rec["batches"])):
        same_bytes(b, a, f"epoch 1 step {i}")
    want = [m["total"] for m in runs["jrec"]["metrics"][STEPS:]]
    np.testing.assert_allclose([m["total"] for m in rec["metrics"]], want,
                               rtol=LOSS_RTOL)


# -- the port's loop alone -------------------------------------------------------
def _port_run(runs, tmp, model=None, resume=None, **over):
    """The port's loop on the fixture at the module's config with
    `over`; returns (cfg, result, the recorded batches and metrics)."""
    cfg = runs["pcfg"].replace(output_dir=str(tmp), **over)
    with pytest.MonkeyPatch.context() as mp:
        rec = record_loop(mp, port_loop, lambda v: v.detach().numpy())
        res = port_loop.train_loop(
            model or CAPE(cfg, device="cpu"), cfg,
            build_mp100_cape("train", cfg), build_mp100_cape("val", cfg),
            runs["paths"]["split_file"], resume=resume, print_freq=0)
    return cfg, res, rec


def test_validation_does_not_leak_into_training(runs, tmp_path,
                                                monkeypatch):
    """A loop whose validation is skipped trains the same steps bit for
    bit: the decode's inference mode, its caches and the eval loss's
    no_grad leave nothing behind that the next epoch sees."""
    def no_validation(model, batches, cfg, **kw):
        return {"pck": 0.0, "pck_mean_categories": 0.0,
                "pck_num_correct": 0, "pck_num_visible": 0}

    monkeypatch.setattr(port_loop, "evaluate_cape", no_validation)
    model = CAPE(runs["pcfg"], device="cpu")
    model.load_state_dict(from_jax_params(runs["jrec"]["init"],
                                          runs["pcfg"]))
    _, _, rec = _port_run(runs, tmp_path, model=model)
    assert rec["metrics"] == runs["prec"]["metrics"]


