"""The port's checkpoints (`utils.checkpoint`, torch's own format) on the
CPU: a round trip of every `TrainState` field and both rng states, the
fp32 masters of a bf16 model, retention, orphaned temp directories,
`latest`/`best`, and `CAPEPredictor.from_checkpoint` against the predictor
built from the model in memory.

The carry-over of a JAX (orbax) checkpoint into a port checkpoint that
resumes like the JAX loop is held in `test_torch_port_loop.py`, beside the
JAX loop run it reads.
"""

import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from cape_tpu_torch.config import tiny_test_config
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch.serve import CAPEPredictor
from cape_tpu_torch.train import create_train_state, make_train_step
from cape_tpu_torch.utils import checkpoint as ck

from test_torch_port_util import few_torch_threads  # noqa: F401
from test_torch_port_util import episode_inputs, train_batch


@pytest.fixture(autouse=True)
def _drop_outputs(tmp_path):
    """A tiny model's checkpoint is ~156 MB: each test removes what it
    wrote."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _trained(cfg, steps=3, seed=0):
    """A tiny model and its state after `steps` micro-steps (dropout on, so
    the generator matters), with the rng streams the loop would save."""
    model = CAPE(cfg, device="cpu")
    state = create_train_state(cfg, model, steps_per_epoch=4)
    step = make_train_step(model, cfg, 4)
    gen = torch.Generator().manual_seed(seed)
    for i in range(steps):
        state, _ = step(state, train_batch(cfg, 2, seed=i), gen)
    rng = np.random.default_rng(seed)
    rng.integers(0, 10, 5)
    return model, state, rng, gen


def _fresh(cfg, seed=9):
    """A state around other weights than `_trained`'s."""
    model = CAPE(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(seed))
    return create_train_state(cfg, model, steps_per_epoch=4)


def test_round_trip_every_field_and_rng(tmp_path):
    cfg = tiny_test_config(accumulation_steps=2, dropout=0.1)
    model, state, rng, gen = _trained(cfg)
    st = state.opt_state
    assert st.mini_step == 1 and st.gradient_step == 1 and state.step == 3
    assert any(a.abs().sum() > 0 for a in st.acc_grads)
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save_epoch(state, 0, cfg, 0.25, 1, rng_state=ck.numpy_rng_state(rng),
                   torch_rng_state=ck.torch_rng_state(gen),
                   extra={"val_stats": {"pck": 0.25}})
    path = mgr.latest()
    assert path == os.path.join(str(tmp_path), "epoch_0")

    target = _fresh(cfg)
    restored, meta = mgr.restore(path, target)
    assert restored is target
    a, b = state.opt_state, target.opt_state
    assert a.names == b.names and a.labels == b.labels
    for key in ("masters", "mu", "nu", "acc_grads"):
        for x, y in zip(getattr(a, key), getattr(b, key)):
            assert torch.equal(x, y), key
    for key in ("adam_count", "sched_count", "mini_step", "gradient_step"):
        assert getattr(a, key) == getattr(b, key), key
    assert target.step == state.step
    for (n, p), (_, q) in zip(model.named_parameters(),
                              target.model.named_parameters()):
        assert torch.equal(p, q), n
    assert (meta["epoch"], meta["best_pck"], meta["patience"]) == (0, 0.25, 1)
    assert meta["config"] == json.loads(cfg.to_json())
    assert meta["extra"] == {"val_stats": {"pck": 0.25}}
    r2 = ck.restore_numpy_rng(meta["rng_state"])
    np.testing.assert_array_equal(r2.integers(0, 1 << 30, 8),
                                  rng.integers(0, 1 << 30, 8))
    g2 = ck.restore_torch_rng(torch.Generator(), meta["torch_rng_state"])
    assert torch.equal(torch.rand(8, generator=g2), torch.rand(8, generator=gen))
    # the state file holds tensors and ints only: it loads weights_only
    sd = torch.load(os.path.join(path, ck.STATE_FILE), weights_only=True)
    assert set(sd) == {"step", "params", "mu", "nu", "acc_grads", "adam_count",
                       "sched_count", "mini_step", "gradient_step"}


def test_bf16_model_saves_fp32_masters(tmp_path):
    """The saved `params` are the fp32 masters, not the bf16 copies: an
    update below bf16's resolution survives the round trip."""
    cfg = tiny_test_config(bf16=True)
    model, state, _, _ = _trained(cfg, steps=1)
    assert any(p.dtype == torch.bfloat16 for p in model.parameters())
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save_epoch(state, 0, cfg, 0.0, 0)
    sd = ck.load_state(mgr.latest())
    names = state.opt_state.names
    for n, m in zip(names, state.opt_state.masters):
        assert sd["params"][n].dtype == torch.float32
        assert torch.equal(sd["params"][n], m), n
    lost = sum(not torch.equal(m, p.float()) for m, p in
               zip(state.opt_state.masters, model.parameters()))
    assert lost > 0          # some masters hold what bf16 cannot
    target = _fresh(cfg)
    mgr.restore(mgr.latest(), target)
    for x, y in zip(state.opt_state.masters, target.opt_state.masters):
        assert torch.equal(x, y)


def test_retention_orphans_latest_best(tmp_path):
    """The directory policy does not look inside the state: a small one
    keeps the 11 saves cheap."""
    cfg = tiny_test_config()
    state = types.SimpleNamespace(
        state_dict=lambda: {"step": 0, "params": {"w": torch.ones(2)}})
    (tmp_path / ".tmp_epoch_9").mkdir()
    (tmp_path / ".tmp_epoch_9" / "meta.json").write_text("{}")
    mgr = ck.CheckpointManager(str(tmp_path))
    assert not (tmp_path / ".tmp_epoch_9").exists()
    pcks = [0.1, 0.5, 0.3, 0.6, 0.2]
    for epoch, pck in enumerate(pcks):
        mgr.save_best(state, epoch, pck, cfg, pck, 0)
        mgr.save_epoch(state, epoch, cfg, pck, 0)
    assert mgr.list_checkpoints() == sorted(
        ["epoch_2", "epoch_3", "epoch_4", "best_epoch_2_pck_0.3000",
         "best_epoch_3_pck_0.6000", "best_epoch_4_pck_0.2000"])
    assert mgr.latest() == str(tmp_path / "epoch_4")
    assert mgr.best() == str(tmp_path / "best_epoch_3_pck_0.6000")
    assert ck.read_meta(mgr.best())["pck"] == 0.6
    # a save over an existing name replaces it; no temp dir is left
    mgr.save_epoch(state, 4, cfg, 0.9, 3)
    assert ck.read_meta(mgr.latest())["best_pck"] == 0.9
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]
    # a directory without its state file is not a checkpoint
    (tmp_path / "epoch_7").mkdir()
    assert mgr.latest() == str(tmp_path / "epoch_4")
    assert ck.CheckpointManager(str(tmp_path / "empty")).best() is None


def test_restore_rejects_another_model(tmp_path):
    cfg = tiny_test_config()
    _, state, _, _ = _trained(cfg, steps=1)
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save_epoch(state, 0, cfg, 0.0, 0)
    other = tiny_test_config(position_embedding="learned")
    with pytest.raises(KeyError, match="row_embed"):
        mgr.restore(mgr.latest(), create_train_state(
            other, CAPE(other, device="cpu"), 4))


def test_from_checkpoint_equals_the_in_memory_predictor(tmp_path):
    cfg = tiny_test_config(min_decode_len=1)
    model, state, _, _ = _trained(cfg, steps=1)
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.save_epoch(state, 0, cfg, 0.0, 0)
    loaded = CAPEPredictor.from_checkpoint(mgr.latest(), batch_size=4,
                                           device="cpu")
    assert loaded.cfg == cfg.replace(dropout=0.0)
    mem = CAPEPredictor(cfg, model, batch_size=4, device="cpu")
    imgs, sc, _, se = episode_inputs(cfg, 5, n_kpts=6, seed=3)
    skel = se[0][se[0, :, 0] >= 0].tolist()
    want = mem.predict(list(imgs), sc[0, :6], skeleton=skel)
    got = loaded.predict(list(imgs), sc[0, :6], skeleton=skel)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["keypoints"], w["keypoints"])
        np.testing.assert_array_equal(g["generated"], w["generated"])
        assert g["length"] == w["length"]
