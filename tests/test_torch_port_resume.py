"""The port's host training loop (`train.loop.train_loop`) alone on the
CPU, on the synthetic MP-100 fixture at the tiny config (fp32,
augmentation on, 2 epochs of 2 micro-steps with `accumulation_steps=2`):
exact resume (dropout on), `steps_per_dispatch=2` against 1, the NaN
guard, early stopping, the profiler trace, `resnet_weights` loaded before
the state with the affines frozen, and the `cli.train` -> `cli.evaluate`
-> `cli.visualize` smoke with `--device cpu`. The loop against the JAX
package's is `test_torch_port_loop.py`.
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

from cape_tpu_torch.cli import evaluate as cli_evaluate
from cape_tpu_torch.cli import train as cli_train
from cape_tpu_torch.cli import visualize as cli_visualize
from cape_tpu_torch.config import tiny_test_config
from cape_tpu_torch.data.builder import build_mp100_cape
from cape_tpu_torch.data.synthetic import make_synthetic_mp100
from cape_tpu_torch.models.backbone import FrozenAffine
from cape_tpu_torch.models.cape import CAPE
from cape_tpu_torch import trace as program_trace
from cape_tpu_torch.train import loop as port_loop
from cape_tpu_torch.utils import checkpoint as ck

from test_torch_port_util import few_torch_threads  # noqa: F401
from test_torch_port_util import (record_loop, same_bytes,
                                  torchvision_state)

STEPS = 2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    paths = make_synthetic_mp100(str(root / "tree"), num_categories=6,
                                 images_per_category=6)
    pcfg = tiny_test_config(
        dataset_root=paths["root"], category_split_file=paths["split_file"],
        epochs=2, episodes_per_epoch=STEPS, val_episodes_per_epoch=4,
        eval_batch_size=2, accumulation_steps=2, num_data_threads=2,
        early_stopping_patience=0)
    yield dict(paths=paths, pcfg=pcfg)
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(autouse=True)
def _drop_outputs(tmp_path):
    """A tiny model's checkpoint is ~156 MB: each test removes what it
    wrote."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


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


def test_exact_resume(runs, tmp_path):
    """One epoch, then a resume for the second, equals two epochs straight:
    batches, losses, masters and both rng streams (dropout 0.1)."""
    _, full, frec = _port_run(runs, tmp_path / "a", dropout=0.1)
    cfg1, _, _ = _port_run(runs, tmp_path / "b", epochs=1, dropout=0.1)
    _, res, rec = _port_run(
        runs, tmp_path / "b", dropout=0.1,
        resume=ck.CheckpointManager(cfg1.output_dir).latest())
    assert [h["epoch"] for h in res["history"]] == [1]
    assert [m["total"] for m in rec["metrics"]] == [
        m["total"] for m in frec["metrics"][STEPS:]]
    for a, b in zip(frec["batches"][STEPS:], rec["batches"]):
        same_bytes(b, a)
    for x, y in zip(full["state"].opt_state.masters,
                    res["state"].opt_state.masters):
        assert torch.equal(x, y)
    ma = ck.read_meta(str(tmp_path / "a" / "epoch_1"))
    mb = ck.read_meta(str(tmp_path / "b" / "epoch_1"))
    assert ma["rng_state"] == mb["rng_state"]
    assert ma["torch_rng_state"] == mb["torch_rng_state"]
    assert res["history"][0]["pck"] == full["history"][1]["pck"]


def test_steps_per_dispatch_two_equals_one(runs, tmp_path):
    """Stacked groups of 2 micro-steps (`make_scan_train_step`) train
    exactly as single steps do: same batches, losses, masters."""
    _, one, r1 = _port_run(runs, tmp_path / "one", epochs=1, dropout=0.1)
    _, two, r2 = _port_run(runs, tmp_path / "two", epochs=1, dropout=0.1,
                           steps_per_dispatch=2)
    assert len(r2["batches"]) == len(r2["metrics"]) == STEPS
    assert r2["metrics"] == r1["metrics"]
    for a, b in zip(r1["batches"], r2["batches"]):
        same_bytes(b, a)
    assert one["history"][0]["train_loss"] == two["history"][0]["train_loss"]
    for x, y in zip(one["state"].opt_state.masters,
                    two["state"].opt_state.masters):
        assert torch.equal(x, y)


def test_nan_guard_raises(runs, tmp_path, monkeypatch):
    make = port_loop.make_train_step

    def make_nan(*a):
        inner = make(*a)

        def step(state, batch, gen):
            state, m = inner(state, batch, gen)
            if state.step == 2:
                m = dict(m, total=torch.tensor(math.nan))
            return state, m
        return step

    monkeypatch.setattr(port_loop, "make_train_step", make_nan)
    cfg = runs["pcfg"].replace(output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="NaN loss at epoch 0 step 1"):
        port_loop.train_loop(
            CAPE(cfg, device="cpu"), cfg, build_mp100_cape("train", cfg),
            build_mp100_cape("val", cfg), runs["paths"]["split_file"],
            print_freq=0)
    assert not os.listdir(tmp_path)      # nothing was checkpointed


def test_early_stopping(runs, tmp_path, capsys):
    """Frozen weights (lr 0) give the same PCK every epoch: with patience 1
    the run stops one epoch after its best (or at once when that is 0)."""
    _, res, _ = _port_run(runs, tmp_path, epochs=5, lr=0.0, lr_backbone=0.0,
                          early_stopping_patience=1)
    pck0 = res["history"][0]["pck"]
    assert len(res["history"]) == (2 if pck0 > 0 else 1)
    assert "Early stopping at epoch" in capsys.readouterr().out
    assert ck.read_meta(ck.CheckpointManager(str(tmp_path)).latest())[
        "patience"] == 1


def test_profile_dir_writes_a_trace(runs, tmp_path):
    """`profile_dir`: a torch.profiler trace from step 2 of the first
    epoch, stopped at step 4 or at the epoch's end (4 steps here), with
    the program's spans in it; they are off again after."""
    _port_run(runs, tmp_path / "out", epochs=1, episodes_per_epoch=4,
              profile_dir=str(tmp_path / "prof"))
    (trace,) = os.listdir(tmp_path / "prof")
    assert trace.endswith(".json") and os.path.getsize(
        tmp_path / "prof" / trace) > 0
    with open(tmp_path / "prof" / trace) as f:
        text = f.read()
    assert '"cape.train.micro_step"' in text
    assert '"cape.step.prepare"' in text
    assert not program_trace.enabled()
    assert program_trace.take()["spans"] == []


def test_resnet_weights_loaded_before_the_state(runs, tmp_path):
    """bf16: the folded affines are the fp32 masters from the start, are
    frozen and do not move; a conv weight does."""
    path = tmp_path / "resnet50.npz"
    over = dict(epochs=1, bf16=True, resnet_weights=str(path))
    cfg = runs["pcfg"].replace(output_dir=str(tmp_path / "out"), **over)
    model = CAPE(cfg, device="cpu")
    sd = torchvision_state(model.backbone, 21)
    np.savez(path, **sd)
    conv_before = model.backbone.layer1[0].conv2.weight.detach().clone()
    _, res, _ = _port_run(runs, tmp_path / "out", model=model, **over)
    st = res["state"].opt_state
    masters = dict(zip(st.names, st.masters))
    labels = dict(zip(st.names, st.labels))
    eps = 1e-5
    w, rv = sd["bn1.weight"], sd["bn1.running_var"]
    scale = (w / np.sqrt(rv + eps)).astype(np.float32)
    assert torch.equal(masters["backbone.bn1.scale"], torch.from_numpy(scale))
    for name, m in model.backbone.named_modules():
        if isinstance(m, FrozenAffine):
            for p in ("scale", "bias"):
                assert labels[f"backbone.{name}.{p}"] == "frozen"
    ds = sd["layer1.0.downsample.1.running_mean"]
    bias = sd["layer1.0.downsample.1.bias"] - ds * (
        sd["layer1.0.downsample.1.weight"]
        / np.sqrt(sd["layer1.0.downsample.1.running_var"] + eps))
    assert torch.equal(masters["backbone.layer1.0.downsample_bn.bias"],
                       torch.from_numpy(bias.astype(np.float32)))
    conv = model.backbone.layer1[0].conv2.weight
    assert not torch.equal(conv, conv_before)
    assert torch.equal(conv, masters["backbone.layer1.0.conv2.weight"].to(
        conv.dtype))


# -- the CLIs ------------------------------------------------------------------
TINY_FLAGS = ["--backbone", "resnet_tiny", "--image_size", "64",
              "--hidden_dim", "64", "--dim_feedforward", "128",
              "--enc_layers", "2", "--dec_layers", "2", "--nheads", "4",
              "--seq_len", "24", "--vocab_size", "100",
              "--support_encoder_layers", "1", "--num_gcn_layers", "1",
              "--batch_size", "1", "--accumulation_steps", "1",
              "--warmup_epochs", "0", "--no_bf16", "--dropout", "0"]


def test_cli_train_evaluate_visualize(runs, tmp_path):
    paths = runs["paths"]
    out = tmp_path / "out"
    res = cli_train.main(TINY_FLAGS + [
        "--dataset_root", paths["root"],
        "--category_split_file", paths["split_file"],
        "--output_dir", str(out), "--epochs", "2",
        "--episodes_per_epoch", "2", "--val_episodes_per_epoch", "4",
        "--eval_batch_size", "2", "--print_freq", "0", "--device", "cpu"])
    assert {"epoch_0", "epoch_1"} <= set(os.listdir(out))
    cfg = ck.config_of(str(out / "epoch_1"))
    assert (cfg.image_size, cfg.hidden_dim, cfg.bf16) == (64, 64, False)
    last = res["history"][-1]
    stats = cli_evaluate.main([
        "--checkpoint", str(out / "epoch_1"), "--split", "val",
        "--num_episodes", "4", "--seed", str(cfg.val_seed),
        "--eval_batch_size", "2", "--device", "cpu"])
    assert (stats["pck_num_correct"], stats["pck_num_visible"]) == (
        last["pck_num_correct"], last["pck_num_visible"])
    assert os.path.isfile(out / "epoch_1" / "metrics_val.json")
    for cap in ("off", "16"):       # PCK-identical above the split's max
        again = cli_evaluate.main([
            "--checkpoint", str(out / "epoch_1"), "--split", "val",
            "--num_episodes", "4", "--seed", str(cfg.val_seed),
            "--eval_batch_size", "2", "--device", "cpu",
            "--decode_max_len", cap, "--output_dir", str(tmp_path / cap)])
        assert again["pck_num_correct"] == stats["pck_num_correct"], cap
    viz = tmp_path / "viz"
    cli_visualize.main(["--checkpoint", str(out / "epoch_1"), "--split",
                        "val", "--num_episodes", "2", "--output_dir",
                        str(viz), "--device", "cpu"])
    pngs = sorted(os.listdir(viz))
    assert len(pngs) == 2 and all(p.endswith(".png") for p in pngs)
    import cv2

    img = cv2.imread(str(viz / pngs[0]))
    assert img.shape == (64, 3 * 64, 3)
