"""The host colour-jitter op (`hostops.cpp`), the port of `cape_tpu.native`.

`fused_bcs` is the train augmentation's fused brightness/contrast/
saturation jitter in one C++ pass, called through ctypes (which releases
the GIL, so the loader threads overlap). `hostops.cpp` compiles with
`g++ -O3 -march=native -fPIC -shared`, the JAX package's flags, at first
use into `_build/` beside this file (listed in `.gitignore`), named by a
hash of the source, the flags and the host CPU's feature flags (a library
built for one CPU by `-march=native` is never loaded on another). Nothing
is built at import.

Unlike the JAX package, a failed build raises with g++'s output: it never
drops to the numpy version in silence. `CAPE_NATIVE=0` is the caller's
explicit choice of the numpy version, `fused_bcs_numpy`, which is also the
plain version the tests hold the C++ op against (its float32 pairwise mean
can differ from the C++ exact integer mean by one level).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "hostops.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared")
_ABI_VERSION = 1

_lock = threading.Lock()
_lib = None


def enabled() -> bool:
    """False when the caller chose the numpy version (`CAPE_NATIVE=0`)."""
    return os.environ.get("CAPE_NATIVE", "1") != "0"


def _host_cpu() -> bytes:
    """The CPU feature flags `-march=native` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "").encode()
    except OSError:
        return platform.machine().encode()


def _target() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
                          + _host_cpu()).hexdigest()
    return BUILD_DIR / f"hostops-{digest[:12]}.so"


def _build() -> Path:
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the host colour jitter "
                           f"(native/hostops.cpp) is built at first use ({e}); "
                           "set CAPE_NATIVE=0 for its numpy version") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build native/hostops.cpp (exit "
                           f"{res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.cape_hostops_version.argtypes = []
            lib.cape_hostops_version.restype = ctypes.c_int
            if lib.cape_hostops_version() != _ABI_VERSION:
                raise RuntimeError(f"native/hostops.cpp: ABI "
                                   f"{lib.cape_hostops_version()}, expected "
                                   f"{_ABI_VERSION}")
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.cape_fused_bcs.argtypes = [u8p, ctypes.c_int64, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_float, u8p]
            lib.cape_fused_bcs.restype = None
            _lib = lib
    return _lib


def _check(img: np.ndarray) -> None:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"fused_bcs takes (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")


def fused_bcs(img: np.ndarray, b: float, c: float, s: float) -> np.ndarray:
    """The C++ fused brightness/contrast/saturation jitter of an (H, W, 3)
    uint8 image; a new (H, W, 3) uint8 array."""
    _check(img)
    lib = load()
    img = np.ascontiguousarray(img)
    out = np.empty_like(img)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.cape_fused_bcs(img.ctypes.data_as(u8p),
                       ctypes.c_int64(img.shape[0] * img.shape[1]),
                       ctypes.c_float(b), ctypes.c_float(c), ctypes.c_float(s),
                       out.ctypes.data_as(u8p))
    return out


def fused_bcs_numpy(img: np.ndarray, b: float, c: float, s: float
                    ) -> np.ndarray:
    """The same transform in numpy (float32, clip, truncate): the JAX
    package's fallback, here the plain version and `CAPE_NATIVE=0`'s."""
    _check(img)
    xf = img.astype(np.float32)
    m = b * xf.mean()
    gray = xf.mean(axis=-1, keepdims=True)
    xf = (s * c * b) * xf + ((1.0 - s) * c * b) * gray + m * (1.0 - c)
    return np.clip(xf, 0, 255).astype(np.uint8)
