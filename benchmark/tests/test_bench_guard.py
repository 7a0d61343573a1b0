"""What a run may load and where it may run: no module of the benchmark
imports JAX or the JAX package (top-level names compared whole: the
program's name begins with the JAX package's), the reference imports
nothing of the program, a tiny run of every cell leaves none of them in
`sys.modules`, and a run without a card exits non-zero with no result."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "cape_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return sorted(glob.glob(os.path.join(BENCH, sub, "**", "*.py"),
                            recursive=True))


def test_no_source_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_program():
    for p in _sources("reference"):
        assert not set(_imports(p)) & {"cape_tpu_torch", "cape_tpu"}, p


def test_a_run_loads_no_jax(tmp_path):
    code = f"""
import sys, time
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import torch; torch.set_num_threads(2)
import harness, run, tiny
for cell in ("cape-geo.serve-b8", "cape-geo.train-update",
             "cape-legacy.eval-kpt"):
    harness.execute(cell, 5, 0.1, False, "cpu", time.perf_counter(),
                    files=tiny.files(cell))
print(run.loaded_forbidden())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    # the reference alone does not load the program
    code = (f"import sys; sys.path[:0] = [{BENCH!r}]; "
            "import reference.model, reference.train, reference.data; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('cape_tpu_torch', 'cape_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


@pytest.mark.parametrize("alone", [False, True])
def test_no_card_no_result(tmp_path, alone):
    """Without a card (and, `alone`, in a directory of the benchmark's own
    files only) a run exits non-zero and prints no result."""
    cwd = ROOT
    if alone:
        cwd = str(tmp_path)
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), cwd)
        shutil.copytree(BENCH, os.path.join(cwd, "benchmark"),
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cape-geo.serve-b8", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env=env)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
