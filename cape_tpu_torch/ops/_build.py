"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source compiles with `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers,
so a build takes seconds). Libraries go to `_build/` beside this file
(listed in `.gitignore`), named by a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing is built at import: the first launch
builds, or `build_all()` builds every kernel in parallel up front. A
failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fused", "gather", "msda", "quadfused", "scatter")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str) -> subprocess.Popen:
    out = _target(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Sequence[str] = SOURCES) -> List[Path]:
    """Compile every kernel library that is not built yet, all nvcc
    processes started together; returns the library paths."""
    with _lock:
        procs = {n: _start(n) for n in names if not _target(n).exists()}
        errors = []
        for n, proc in procs.items():
            try:
                _finish(n, proc)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return [_target(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        (path,) = build_all([name])
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(path)))
    return lib


def build_log(name: str) -> str:
    """nvcc's output (`-Xptxas -v`: registers, spills) of the last build."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""
