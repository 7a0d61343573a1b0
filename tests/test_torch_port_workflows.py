"""The port's workflows outside the training and evaluation CLIs against
their JAX-side counterparts, on the CPU at the tiny config (fp32,
`--device cpu`):

- `cli.aggregate_kfold`: the same `kfold_summary.json`, byte for byte, as
  `scripts/aggregate_kfold_results.py` (run in a subprocess) on seeded
  fold metrics, and the same messages and exit code when folds are
  missing;
- `cli.kfold`: `quick` over two folds in this process (the assertions of
  `tests/test_kfold.py`), fold 2's results equal to a fresh process that
  trains fold 2 alone (metrics file, checkpoint names and every master,
  bit for bit), its failures, and its argument sets against the ones
  parsed from `scripts/run_kfold_cross_validation.sh`;
- `cli.audit`: the audit dict and report of a checkpoint holding seeded
  JAX weights (`convert.from_jax_params`) against
  `cape_tpu.eval.audit.audit_episodes` over the JAX decode of the same
  fixed episodes: counts, lengths and flags equal, PCK values to 1e-6,
  the coordinate spread to 1e-4 (decode coordinates agree to 1e-4,
  `test_torch_port_eval.py`); exit 1 on a leak;
- `cli.kshot_demo`: the fixture's `indexed` marker branch with the demo's
  jitter and image size against the JAX package's (the `uniform` branch
  is in `test_torch_port_data.py`), the 5-shot test episodes of seed 123
  against the JAX sampler's, and a 1-epoch tiny demo whose `cli.train` /
  `cli.evaluate` arguments are the JAX script's lists (read from its
  source) and whose results JSON has the JAX script's keys;
- `cli.visualize_gt_annotations` / `cli.visualize_gt_preprocessing`: the
  same file names and the same pixels as the two JAX scripts;
- `cli.launch`: the presets of `START_CAPE_TRAINING.sh` and `TEST_CAPE.sh`
  (parsed from them), `smoke` training its epoch on the synthetic fixture
  with `--device cpu`, and the missing `DATASET_ROOT` refused.
"""

import ast
import importlib.util
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import tempfile

import cv2
import jax
import numpy as np
import pytest
import torch

from cape_tpu.config import CAPEConfig as JaxConfig
from cape_tpu.data import builder as jax_builder
from cape_tpu.data import episodic as jax_episodic
from cape_tpu.data.synthetic import make_synthetic_mp100 as jax_make
from cape_tpu.eval import audit as jax_audit
from cape_tpu.models.cape import autoregressive_decode as jax_decode

from cape_tpu_torch.cli import aggregate_kfold, kfold, kshot_demo, launch
from cape_tpu_torch.cli import audit as cli_audit
from cape_tpu_torch.cli import evaluate as cli_evaluate
from cape_tpu_torch.cli import train as cli_train
from cape_tpu_torch.cli import visualize_gt_annotations as port_gt_viz
from cape_tpu_torch.cli import visualize_gt_preprocessing as port_pre_viz
from cape_tpu_torch.config import CAPEConfig as PortConfig
from cape_tpu_torch.data import builder as port_builder
from cape_tpu_torch.data import episodic as port_episodic
from cape_tpu_torch.data.image import decode_rgb
from cape_tpu_torch.data.synthetic import make_synthetic_mp100
from cape_tpu_torch.eval import evaluate as port_evaluate
from cape_tpu_torch.train import create_train_state
from cape_tpu_torch.utils import checkpoint as ck

from test_torch_port_util import few_torch_threads  # noqa: F401
from test_torch_port_util import TORCH_THREADS, jax_tiny, port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")

#: `tests/test_kfold.py`'s tiny config, as `EXTRA_TRAIN_ARGS`
TINY = (
    "--image_size 64 --hidden_dim 64 --dim_feedforward 128 --enc_layers 2 "
    "--dec_layers 2 --nheads 4 --seq_len 24 --vocab_size 100 "
    "--backbone resnet_tiny --support_encoder_layers 1 --num_gcn_layers 1 "
    "--episodes_per_epoch 2 --val_episodes_per_epoch 2 "
    "--num_queries_per_episode 1 --early_stopping_patience 0 "
    "--dropout 0.0 --no_bf16 --print_freq 0"
)
#: the tiny model alone (the k-shot demo sets the episode counts itself)
TINY_MODEL = (
    "--hidden_dim 64 --dim_feedforward 128 --enc_layers 2 --dec_layers 2 "
    "--nheads 4 --seq_len 24 --vocab_size 100 --backbone resnet_tiny "
    "--support_encoder_layers 1 --num_gcn_layers 1 --dropout 0.0 --no_bf16 "
    "--print_freq 0").split()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The port-written synthetic tree (6 categories of 6 images)."""
    root = tmp_path_factory.mktemp("workflows")
    paths = make_synthetic_mp100(str(root / "mp100"), num_categories=6,
                                 images_per_category=6)
    yield paths
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(autouse=True)
def _drop_outputs(tmp_path):
    """A tiny model's checkpoint is ~150 MB: each test removes what it
    wrote."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _script(name):
    """A JAX-side script of `scripts/` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _joined(path):
    """A shell script's text with its line continuations joined."""
    with open(path) as f:
        return f.read().replace("\\\n", " ")


def _shell_array(path, name):
    """The words of every `NAME=(...)` assignment of a shell script."""
    return [shlex.split(m) for m in
            re.findall(rf"^\s*{name}=\(([^)]*)\)", _joined(path), re.M)]


def _train_commands(path):
    """The flags of every `python -m cape_tpu.cli.train` command of a
    shell script, without `--dataset_root`, `--output_dir` and array
    expansions."""
    out = []
    for line in re.findall(r"python -m cape_tpu\.cli\.train (.*)",
                           _joined(path)):
        words = shlex.split(line)
        flags = []
        while words:
            w = words.pop(0)
            if w in ("--dataset_root", "--output_dir"):
                words.pop(0)
            elif not w.startswith("$"):
                flags.append(w)
        out.append(flags)
    return out


# -- aggregate -------------------------------------------------------------------
def _fold_metrics(root, folds, seed):
    rng = np.random.default_rng(seed)
    for i, n in enumerate(folds):
        d = os.path.join(root, f"{'split' if i % 3 == 2 else 'fold'}_{n}")
        os.makedirs(d)
        m = {"pck": float(rng.uniform()),
             "pck_mean_categories": float(rng.uniform()),
             "pck_per_category": {"3": float(rng.uniform())}}
        if i != 1:
            m["num_images"] = int(rng.integers(1, 300))
        with open(os.path.join(d, "metrics_test.json"), "w") as f:
            json.dump(m, f)


def _aggregate_both(root, argv, capsys):
    """(returncode, stdout, stderr, summary text) of the JAX script and of
    the port's module on the same arguments."""
    summary = os.path.join(root, "kfold_summary.json")
    r = subprocess.run([sys.executable, os.path.join(
        SCRIPTS, "aggregate_kfold_results.py")] + argv,
        capture_output=True, text=True, timeout=120)
    want_text = None
    if os.path.exists(summary):
        with open(summary) as f:
            want_text = f.read()
        os.remove(summary)
    code = 0
    try:
        aggregate_kfold.main(argv)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    got_text = None
    if os.path.exists(summary):
        with open(summary) as f:
            got_text = f.read()
    return ((r.returncode, r.stdout, r.stderr, want_text),
            (code, out.out, out.err, got_text))


@pytest.mark.parametrize("n_folds", [2, 5])
def test_aggregate_matches_script(tmp_path, capsys, n_folds):
    """Folds under `fold_N/` and `split_N/`, one without `num_images`,
    and with 5 folds one asked for that is missing."""
    root = str(tmp_path)
    present = list(range(1, n_folds + 1))
    asked = present + ([6] if n_folds == 5 else [])
    _fold_metrics(root, present, seed=n_folds)
    want, got = _aggregate_both(
        root, ["--results_dir", root, "--splits", *map(str, asked),
               "--eval_split", "test"], capsys)
    assert got == want
    summary = json.loads(got[3])
    assert summary["folds"] == present
    micro = [summary["per_fold"][str(n)]["pck"] for n in present]
    assert summary["pck_overall_std"] == float(np.std(micro))  # ddof 0
    assert ("fold 6: metrics not found" in got[2]) == (n_folds == 5)


def test_aggregate_without_folds_exits_like_script(tmp_path, capsys):
    root = str(tmp_path)
    want, got = _aggregate_both(root, ["--results_dir", root], capsys)
    assert got == want
    assert got[0] == 1 and "No fold results found." in got[2]


# -- k-fold ----------------------------------------------------------------------
def _kfold_env(monkeypatch, tree, out_root, splits):
    monkeypatch.setenv("DATASET_ROOT", tree["root"])
    monkeypatch.setenv("OUTPUT_ROOT", out_root)
    monkeypatch.setenv("SPLITS", splits)
    monkeypatch.setenv("EVAL_EPISODES", "4")
    monkeypatch.setenv("EXTRA_TRAIN_ARGS", TINY)
    monkeypatch.setenv("EXTRA_EVAL_ARGS", "--eval_batch_size 2")


@pytest.fixture(scope="module")
def kfold_tree(tmp_path_factory):
    """A two-split synthetic tree."""
    root = tmp_path_factory.mktemp("kfold")
    paths = make_synthetic_mp100(str(root / "mp100"), num_categories=6,
                                 images_per_category=6, num_splits=2)
    yield paths
    shutil.rmtree(root, ignore_errors=True)


def _masters(path):
    return ck.load_state(path)["params"]


def test_kfold_two_folds_in_one_process(kfold_tree, tmp_path, monkeypatch):
    out_root = str(tmp_path / "kfold")
    _kfold_env(monkeypatch, kfold_tree, out_root, "1 2")
    res = kfold.main(["quick", "--device", "cpu"])

    # per-fold artifacts: checkpoints + metrics (tests/test_kfold.py)
    for fold in (1, 2):
        fold_dir = os.path.join(out_root, f"fold_{fold}")
        assert any(n.startswith(("epoch_", "best_"))
                   for n in os.listdir(fold_dir)), f"fold {fold}: no ckpt"
        with open(os.path.join(fold_dir, "metrics_test.json")) as f:
            m = json.load(f)
        assert 0.0 <= m["pck"] <= 1.0
        assert m["num_images"] == 4
        # each fold trained on its own partition, at the extra flags,
        # which win over the quick mode's
        cfg = ck.config_of(os.path.join(fold_dir, "epoch_0"))
        assert cfg.mp100_split == fold
        assert (cfg.episodes_per_epoch, cfg.image_size, cfg.epochs) == (
            2, 64, 1)
    with open(os.path.join(out_root, "kfold_summary.json")) as f:
        summary = json.load(f)
    assert summary == res["summary"]
    assert sorted(map(int, summary["folds"])) == [1, 2]
    for key in ("pck_overall_mean", "pck_overall_std",
                "pck_macro_mean", "pck_macro_std", "per_fold"):
        assert key in summary, summary.keys()
    assert 0.0 <= summary["pck_overall_mean"] <= 1.0
    assert summary["pck_overall_std"] >= 0.0
    assert sorted(map(int, summary["per_fold"])) == [1, 2]
    assert [f["fold"] for f in res["folds"]] == [1, 2]
    assert all(f["peak_bytes"] is None for f in res["folds"])  # no card

    # fold 2 after fold 1 in this process == fold 2 alone in a fresh one
    alone = str(tmp_path / "alone")
    env = dict(os.environ, OUTPUT_ROOT=alone, SPLITS="2",
               OMP_NUM_THREADS=str(TORCH_THREADS),
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-m", "cape_tpu_torch.cli.kfold",
                        "quick", "--device", "cpu"], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    a, b = os.path.join(out_root, "fold_2"), os.path.join(alone, "fold_2")
    with open(os.path.join(a, "metrics_test.json")) as f1, \
            open(os.path.join(b, "metrics_test.json")) as f2:
        assert f1.read() == f2.read()
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        if name.startswith(("epoch_", "best_")):
            ma, mb = _masters(os.path.join(a, name)), _masters(
                os.path.join(b, name))
            assert ma.keys() == mb.keys()
            for k in ma:
                assert torch.equal(ma[k], mb[k]), (name, k)


def test_kfold_failures(kfold_tree, tmp_path, monkeypatch, capsys):
    """No DATASET_ROOT, then a fold that writes no checkpoint: exit 1
    with the shell script's messages."""
    monkeypatch.delenv("DATASET_ROOT", raising=False)
    with pytest.raises(SystemExit) as e:
        kfold.main(["quick", "--device", "cpu"])
    assert e.value.code == 1
    assert "set DATASET_ROOT to the MP-100 root" in capsys.readouterr().err
    _kfold_env(monkeypatch, kfold_tree, str(tmp_path), "1")
    monkeypatch.setenv("EXTRA_TRAIN_ARGS", TINY + " --epochs 0")
    with pytest.raises(SystemExit) as e:
        kfold.main(["quick", "--device", "cpu"])
    assert e.value.code == 1
    assert "No checkpoint produced for fold 1" in capsys.readouterr().err


def test_kfold_arguments_match_shell_script():
    sh = os.path.join(SCRIPTS, "run_kfold_cross_validation.sh")
    quick, full = _shell_array(sh, "TRAIN_ARGS")
    assert kfold.QUICK_TRAIN_ARGS == quick
    assert kfold.FULL_TRAIN_ARGS == full
    defaults = re.findall(r'EVAL_EPISODES="\$\{EVAL_EPISODES:-(\d+)\}"',
                          _joined(sh))
    assert [kfold.QUICK_EVAL_EPISODES, kfold.FULL_EVAL_EPISODES] == defaults
    assert re.search(r'OUTPUT_ROOT:-output/kfold\}', _joined(sh))


def test_kfold_argv_composition(monkeypatch):
    """The train and eval argument lists of a fold: the script's, then
    `--device`, then the extra flags (last, so they win)."""
    calls = []
    monkeypatch.setattr(cli_train, "main", lambda argv: calls.append(
        ("train", argv)))
    monkeypatch.setattr(cli_evaluate, "main", lambda argv: calls.append(
        ("eval", argv)))
    monkeypatch.setattr(ck.CheckpointManager, "best",
                        lambda self: os.path.join(self.dir, "best_x"))
    monkeypatch.setattr(aggregate_kfold, "main", lambda argv: calls.append(
        ("aggregate", argv)))
    with tempfile.TemporaryDirectory() as out:
        monkeypatch.setenv("DATASET_ROOT", "/data/mp100")
        monkeypatch.setenv("OUTPUT_ROOT", out)
        monkeypatch.setenv("SPLITS", "3")
        monkeypatch.delenv("EVAL_EPISODES", raising=False)
        monkeypatch.setenv("EXTRA_TRAIN_ARGS", "--epochs 2")
        monkeypatch.setenv("EXTRA_EVAL_ARGS", "--seed 9")
        kfold.main(["full", "--device", "cpu"])
        fold = os.path.join(out, "fold_3")
        assert calls == [
            ("train", ["--dataset_root", "/data/mp100", "--mp100_split", "3",
                       "--output_dir", fold] + kfold.FULL_TRAIN_ARGS
             + ["--device", "cpu", "--epochs", "2"]),
            ("eval", ["--checkpoint", os.path.join(os.path.abspath(fold),
                                                   "best_x"),
                      "--dataset_root", "/data/mp100", "--split", "test",
                      "--num_episodes", "200", "--output_dir", fold,
                      "--device", "cpu", "--seed", "9"]),
            ("aggregate", ["--results_dir", out, "--splits", "3",
                           "--eval_split", "test"])]


# -- audit -----------------------------------------------------------------------
def _inputs(b):
    return (b["query_images"], b["support_coords"], b["support_mask"],
            b["skeleton_edges"])


def _assert_audit_equal(got, want, path="audit"):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_audit_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, float):
        tol = 1e-4 if path.endswith("coord_spread_mean") else 1e-6
        assert isinstance(got, float) and abs(got - want) <= tol, (
            path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


def _checkpoint(tree, tmp_path):
    """A port checkpoint of the seeded JAX weights; (path, JAX model,
    JAX params)."""
    jcfg, jm, params = jax_tiny(0)
    pm = port_model(jcfg, params)
    mgr = ck.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_epoch(create_train_state(pm.cfg, pm, 1), 0, pm.cfg, 0.0, 0)
    return mgr.latest(), jm, params


def test_audit_matches_jax(tree, tmp_path, capsys):
    path, jm, params = _checkpoint(tree, tmp_path)
    flags = ["--checkpoint", path, "--dataset_root", tree["root"],
             "--category_split_file", tree["split_file"], "--split", "val",
             "--num_episodes", "6", "--eval_batch_size", "4"]
    got = cli_audit.main(flags + ["--device", "cpu"])
    report = capsys.readouterr().out

    # the JAX script's steps, its restored state replaced by the same
    # weights: config from the checkpoint, fixed episodes, batches, decode
    with open(os.path.join(path, "meta.json")) as f:
        cfg = JaxConfig.from_json(json.dumps(json.load(f)["config"]))
    cfg = cfg.replace(dataset_root=tree["root"],
                      category_split_file=tree["split_file"])
    ds = jax_builder.build_mp100_cape("val", cfg)
    sampler = jax_episodic.EpisodicSampler(
        ds, jax_builder.resolve_split_file(cfg), "val", num_queries=1,
        num_support=cfg.num_support_per_episode)
    fixed = sampler.fixed_episodes(6, 123)
    eval_b, n_batches = jax_episodic.eval_batch_plan(6, 4)
    batches = list(jax_episodic.episode_batches(
        ds, sampler, eval_b, n_batches, cfg.image_size,
        cfg.max_support_keypoints, cfg.max_skeleton_edges,
        np.random.default_rng(123), fixed=fixed, total_episodes=6))
    variables = {"params": params}
    decode = jax.jit(lambda p, *a: jax_decode(jm, p, *a)).lower(
        variables, *_inputs(batches[0])).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    want = jax_audit.audit_episodes(
        lambda b: decode(variables, *_inputs(b)), iter(batches), cfg)
    assert want["num_samples"] == 6 and not want["leak_detected"]
    assert len(set(want["token_hist"])) > 1    # a decode that varies
    _assert_audit_equal(got, want)
    assert report.strip().endswith(
        jax_audit.format_audit_report(want).strip())


def test_audit_exits_on_leak(tree, tmp_path, monkeypatch, capsys):
    """A decode that returns the GT makes the CLI exit 1 with the LEAK
    flag, as the JAX script does."""
    path, _, _ = _checkpoint(tree, tmp_path)
    seen = {}

    def leaky(model, images, sc, sm, se):
        b = seen["batch"]
        B, L = b["targets"]["token_labels"].shape
        logits = np.zeros((B, L, 3), np.float32)
        coords = np.zeros((B, L, 2), np.float32)
        for i in range(B):
            n = int(b["num_keypoints"][i])
            logits[i, :n, 0] = 10.0
            logits[i, n, 2] = 10.0
            coords[i, :n] = b["targets"]["target_seq"][i, :n]
        return {"pred_logits": logits, "pred_coords": coords,
                "lengths": b["num_keypoints"] + 1,
                "unfinished": np.zeros(B, bool)}

    orig = port_episodic.episode_batches

    def recording(*a, **kw):
        for b in orig(*a, **kw):
            seen["batch"] = b
            yield b

    monkeypatch.setattr(port_evaluate, "decode", leaky)
    monkeypatch.setattr(port_episodic, "episode_batches", recording)
    with pytest.raises(SystemExit) as e:
        cli_audit.main(["--checkpoint", path, "--dataset_root",
                        tree["root"], "--category_split_file",
                        tree["split_file"], "--num_episodes", "4",
                        "--device", "cpu"])
    assert e.value.code == 1
    assert "!! LEAK: 4/4 predictions identical to GT" in \
        capsys.readouterr().out


# -- k-shot demonstration --------------------------------------------------------
#: the demo's fixture (`make_synthetic_mp100` arguments of the JAX script)
#: at fewer categories and images
KSHOT_FIXTURE = dict(num_categories=6, images_per_category=6,
                     keypoint_range=(5, 9), image_size=(256, 320), seed=7,
                     learnable=True, num_holdout=4, layout_jitter=0.08,
                     marker_style="indexed")


@pytest.fixture(scope="module")
def kshot_trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("kshot")
    out = (jax_make(str(root / "jax"), **KSHOT_FIXTURE),
           make_synthetic_mp100(str(root / "port"), **KSHOT_FIXTURE))
    yield out
    shutil.rmtree(root, ignore_errors=True)


def test_kshot_fixture_matches_jax(kshot_trees):
    jp, pp = kshot_trees
    for key in ("train_ann", "val_ann", "test_ann", "split_file"):
        with open(jp[key], "rb") as a, open(pp[key], "rb") as b:
            assert a.read() == b.read(), key
    names = sorted(os.listdir(jp["img_dir"]))
    assert names == sorted(os.listdir(pp["img_dir"])) and len(names) == 36
    for name in names:
        a = decode_rgb(os.path.join(jp["img_dir"], name))
        b = decode_rgb(os.path.join(pp["img_dir"], name))
        assert a.shape == (256, 320, 3) and np.array_equal(a, b), name


def test_kshot_5shot_episodes_match_jax(kshot_trees):
    """The demo's 5-shot test episodes (seed 123): the same category,
    support and query ids from both samplers."""
    pp = kshot_trees[1]
    kw = dict(dataset_root=pp["root"], category_split_file=pp["split_file"],
              image_size=256, num_support_per_episode=5)
    eps = []
    for cfg, builder, episodic in (
            (JaxConfig(**kw), jax_builder, jax_episodic),
            (PortConfig(**kw), port_builder, port_episodic)):
        ds = builder.build_mp100_cape("test", cfg)
        sampler = episodic.EpisodicSampler(
            ds, builder.resolve_split_file(cfg), "test", num_queries=1,
            num_support=5)
        eps.append(sampler.fixed_episodes(80, 123))
    assert eps[1] == eps[0]
    assert all(len(e["support_indices"]) == 5 for e in eps[1])
    assert len({e["category_id"] for e in eps[1]}) == 2


def _jax_argument_lists(**names):
    """The list literals passed to `train_main` and `eval_main` in
    `scripts/run_kshot_demo.py`, evaluated with `names` bound."""
    with open(os.path.join(SCRIPTS, "run_kshot_demo.py")) as f:
        tree = ast.parse(f.read())
    out = {"train_main": [], "eval_main": []}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in out):
            expr = ast.Expression(node.args[0])
            out[node.func.id].append(eval(compile(expr, "<demo>", "eval"),
                                          {"os": os, "str": str}, names))
    return out


def test_kshot_demo_tiny(tmp_path, monkeypatch, capsys):
    """One epoch at the tiny config: the JAX script's argument lists, and
    its results JSON's keys."""
    calls = []
    train_main, eval_main = cli_train.main, cli_evaluate.main

    def train(argv):
        calls.append(("train", argv))
        return train_main(argv + TINY_MODEL)

    def evaluate(argv):
        calls.append(("eval", argv))
        return eval_main(argv + ["--eval_batch_size", "2"])

    monkeypatch.setattr(cli_train, "main", train)
    monkeypatch.setattr(cli_evaluate, "main", evaluate)
    root = str(tmp_path / "kshot")
    argv = ["--root", root, "--epochs", "1", "--image_size", "64",
            "--episodes_per_epoch", "2", "--batch_size", "1",
            "--num_eval_episodes", "4", "--num_categories", "8",
            "--images_per_category", "6", "--num_holdout", "4"]
    res = kshot_demo.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()

    # the argument lists: the JAX script's, then --device
    args = kshot_demo.get_args_parser().parse_args(argv)
    ckpt = ck.CheckpointManager(os.path.join(root, "out"))
    ckpt = ckpt.best() or ckpt.latest()
    want = _jax_argument_lists(args=args, out_dir=os.path.join(root, "out"),
                               ckpt=ckpt, k=1,
                               edir=os.path.join(root, "eval_1shot"))
    assert [c[0] for c in calls] == ["train", "eval", "eval", "eval"]
    assert calls[0][1] == want["train_main"][0] + ["--device", "cpu"]
    for (_, got), name, k, noise in zip(
            calls[1:], ("eval_1shot", "eval_5shot", "eval_sensitivity"),
            (1, 5, 1), (0.0, 0.0, 0.3)):
        lists = _jax_argument_lists(args=args, out_dir=None, ckpt=ckpt,
                                    k=k, edir=os.path.join(root, name))
        jax_list = lists["eval_main"][0 if name != "eval_sensitivity" else 1]
        assert got == jax_list + ["--device", "cpu"], name
        assert got[got.index("--support_coord_noise") + 1] == str(noise)

    # the results JSON: the last line, with the JAX script's keys
    assert json.loads(lines[-1]) == res
    assert set(res) == {"1shot", "5shot", "sensitivity", "layout_jitter",
                        "support_coord_noise",
                        "macro_delta_5shot_minus_1shot"}
    for k in ("1shot", "5shot"):
        assert set(res[k]) == {"micro_pck", "macro_pck"}
        assert 0.0 <= res[k]["micro_pck"] <= 1.0
    assert set(res["sensitivity"]) == {"sigma", "micro_pck", "macro_pck",
                                       "drop_vs_1shot"}
    with open(os.path.join(SCRIPTS, "run_kshot_demo.py")) as f:
        src = f.read()
    for key in ("sensitivity", "layout_jitter", "support_coord_noise",
                "macro_delta_5shot_minus_1shot", "micro_pck", "macro_pck",
                "drop_vs_1shot", "sigma"):
        assert f'"{key}"' in src, key
    assert 'f"{k}shot"' in src
    train_line = next(json.loads(x.split(" ", 2)[2]) for x in lines
                      if x.startswith("kshot train "))
    assert train_line["epochs"] == 1 and train_line["peak_bytes"] is None
    assert sorted(os.listdir(root)) == [
        "annotations", "category_splits.json", "data", "eval_1shot",
        "eval_5shot", "eval_sensitivity", "out"]


# -- GT visualisations -----------------------------------------------------------
def _pngs(d):
    names = sorted(os.listdir(d))
    return names, [cv2.imread(os.path.join(d, n)) for n in names]


@pytest.mark.parametrize("name,port", [
    ("visualize_gt_annotations", port_gt_viz),
    ("visualize_gt_preprocessing", port_pre_viz)])
def test_gt_visualisations_match_jax(tree, tmp_path, monkeypatch, name,
                                     port):
    """Same file names, same pixels (the JAX scripts decode with PIL, the
    port with cv2: PNG is lossless, so the images are the same)."""
    flags = ["--dataset_root", tree["root"], "--num_images", "4",
             "--image_size", "96"]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    monkeypatch.setattr(sys, "argv", [name] + flags + ["--output_dir",
                                                       jax_dir])
    _script(name).main()
    written = port.main(flags + ["--output_dir", port_dir])
    want_names, want = _pngs(jax_dir)
    got_names, got = _pngs(port_dir)
    assert got_names == want_names and len(got_names) == 4
    assert sorted(os.path.basename(p) for p in written) == got_names
    for n, a, b in zip(got_names, got, want):
        assert a.shape == b.shape and np.array_equal(a, b), n


# -- launchers -------------------------------------------------------------------
def test_launch_presets_match_shell_scripts():
    quick, normal = _train_commands(os.path.join(REPO,
                                                 "START_CAPE_TRAINING.sh"))
    assert launch.QUICK_ARGS == quick
    assert launch.NORMAL_ARGS == normal
    test_cape = os.path.join(REPO, "TEST_CAPE.sh")
    (smoke,) = _train_commands(test_cape)
    assert launch.SMOKE_ARGS == smoke
    extra, empty = _shell_array(test_cape, "EXTRA")
    assert extra[:2] == ["--category_split_file", "$SPLIT_FILE"]
    assert launch.SMOKE_SYNTHETIC_ARGS == extra[2:] and empty == []


def test_launch_smoke_trains_on_the_fixture(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("DATASET_ROOT", raising=False)
    monkeypatch.setenv("OUTPUT_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    res = launch.main(["smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "DATASET_ROOT unset -> generating synthetic MP-100 fixture" in out
    assert out.strip().endswith("TEST_CAPE: OK")
    assert "epoch_0" in os.listdir(tmp_path / "out")
    cfg = ck.config_of(str(tmp_path / "out" / "epoch_0"))
    assert (cfg.image_size, cfg.hidden_dim, cfg.episodes_per_epoch,
            cfg.bf16) == (64, 64, 5, False)
    assert len(res["history"]) == 1


@pytest.mark.parametrize("mode", ["normal", "quick"])
def test_launch_modes(tmp_path, monkeypatch, capsys, mode):
    """`normal` / `quick` refuse a missing DATASET_ROOT, then run
    `cli.train` with the preset and print the backend."""
    monkeypatch.delenv("DATASET_ROOT", raising=False)
    with pytest.raises(SystemExit) as e:
        launch.main([mode, "--device", "cpu"])
    assert e.value.code == 1
    monkeypatch.setenv("DATASET_ROOT", "/data/mp100")
    monkeypatch.delenv("OUTPUT_DIR", raising=False)
    seen = []
    monkeypatch.setattr(cli_train, "main", seen.append)
    launch.main([mode, "--device", "cpu"])
    preset = launch.QUICK_ARGS if mode == "quick" else launch.NORMAL_ARGS
    assert seen == [["--dataset_root", "/data/mp100", "--output_dir",
                     "output/cape_episodic"] + preset + ["--device", "cpu"]]
    assert "torch backend: cpu" in capsys.readouterr().out
