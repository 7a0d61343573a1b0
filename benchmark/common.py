"""What every kind of cell shares: the files found by name, the weights
made from the seed, the recorders installed around the program's calls,
and the numbers a run prints.

Files, by the names in `BENCHMARK.json`:
- a configuration: the `file` of its entry (`configs/<name>.json`): the
  program's configuration fields under `cape`, with `source`, `reduced`
  and `assumed`;
- a traffic mix: `traffic/<name>.json`, whose `kind` names the driver in
  `kinds/` and whose other keys are that driver's parameters;
- a cell's correctness limits: `limits/<cell>.json`;
- a per-layer metric: `metrics/<name>.py`, a reader `read(run)`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from reference import backbones

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_files(cell_name: str, root: str = ROOT) -> Dict:
    """The cell's entry and its configuration, traffic and limits, found by
    name."""
    s = spec(root)
    cells = {w["name"]: w for w in s["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"no workload {cell_name!r} in BENCHMARK.json")
    cell = cells[cell_name]
    conf = {c["name"]: c for c in s["configs"]}[cell["config"]]
    return {
        "cell": cell,
        "config": load_json(os.path.join(root, conf["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic",
                                          cell["traffic"] + ".json")),
        "limits": load_json(os.path.join(HERE, "limits",
                                         cell_name + ".json")),
        "end_to_end": [m for m in s["end_to_end"]
                       if cell_name in m.get("workloads", [cell_name])],
        "per_layer": [m for m in s["per_layer"]
                      if cell_name in m.get("workloads", [cell_name])],
    }


def load_module(path: str, name: str):
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> Callable:
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "bench_metric_" + name.replace(".", "_")).read


def kind_driver(kind: str):
    return load_module(os.path.join(HERE, "kinds", kind + ".py"),
                       "bench_kind_" + kind)


# -- weights ---------------------------------------------------------------
#: the prefix of the backbone's parameters in the model's `state_dict`
BACKBONE = "backbone."


def _offset_grid(h: int, l: int, p: int) -> torch.Tensor:
    """The sampling offsets' radial bias: head k points along angle
    2*pi*k/h, scaled to the unit square, point i at (i + 1) times that."""
    th = torch.arange(h, dtype=torch.float64) * (2 * math.pi / h)
    g = torch.stack([th.cos(), th.sin()], -1)
    g = g / g.abs().amax(-1, keepdim=True)
    g = g[:, None, None, :].repeat(1, l, p, 1)
    g = g * torch.arange(1, p + 1, dtype=torch.float64)[None, None, :, None]
    return g.reshape(-1).float()


def _weight(n: str, z: torch.Tensor, c: Dict, init: Dict) -> torch.Tensor:
    """The generic rules of `make_weights` for parameter `n`, from its
    slice `z` of the draw."""
    shp, dev = z.shape, z.device
    if n.endswith("sampling_offsets.bias"):
        h, L = c["nheads"], c["num_feature_levels"]
        return _offset_grid(h, L, z.numel() // (2 * h * L)).to(dev)
    if ".class_heads." in n and n.endswith(".bias"):
        return torch.tensor(init["class_bias"], dtype=torch.float32,
                            device=dev)
    if "embed" in n and len(shp) == 2:
        return z * (c["hidden_dim"] ** -0.5 if "token_embed" in n else 1.0)
    if len(shp) >= 2:
        fan_in = int(np.prod(shp[1:]))
        gain = 2.0 if len(shp) == 4 else 1.0
        w = z * math.sqrt(gain / fan_in)
        if ".coords_heads." in n and ".layers.2." in n:
            w = w * init["coords_head_last_scale"]
        return w
    if n.endswith(".bias"):
        return torch.zeros(shp, device=dev)
    return torch.ones(shp, device=dev)         # norm and affine scales


def make_weights(shapes: Dict[str, torch.Size], c: Dict, init: Dict,
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights by parameter name, made on `device` from `seed` in
    one draw of normals, in name order, and scaled leaf by leaf:

    - convolution and linear kernels: normal with variance gain / fan_in
      (gain 2 for convolutions, 1 for linears), the coordinate heads' last
      layer times `init["coords_head_last_scale"]`;
    - embeddings: normal, std d**-0.5 for tokens, 1 for the rest;
    - biases 0, except the sampling offsets' radial grid and the class
      heads' `init["class_bias"]`;
    - norm scales 1;

    except where the backbone's module (`reference/backbones/`) gives a
    backbone parameter's weight by its `init`."""
    names = list(shapes)
    total = sum(int(np.prod(shapes[n])) for n in names)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    own = getattr(backbones.module(c["backbone"]), "init", None)
    out, at = {}, 0
    for n in names:
        k = int(np.prod(shapes[n]))
        z = flat[at:at + k].reshape(shapes[n])
        at += k
        w = own(n[len(BACKBONE):], z, init) \
            if own is not None and n.startswith(BACKBONE) else None
        if w is None:
            w = _weight(n, z, c, init)
        out[n] = w.float().contiguous()
    return out


# -- recording -------------------------------------------------------------
class Reservoir:
    """A uniform sample of `k` items from a stream, drawn from a seeded
    generator, plus every item `keep(item)` asks to keep."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, np.random.default_rng(seed)
        self.items: List = []
        self.kept: List = []
        self.seen = 0

    def offer(self, item, keep: bool = False) -> None:
        if keep:
            self.kept.append(item)
            return
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item

    def sample(self) -> List:
        return self.kept + self.items


class Spans:
    """Named host-clock spans, in seconds."""

    def __init__(self):
        self.t = defaultdict(list)

    def add(self, name: str, seconds: float) -> None:
        self.t[name].append(seconds)


def synced(fn: Callable, run, name: str) -> Callable:
    """`fn` timed as a span of `run.spans` that ends when the device has
    finished."""

    def wrapper(*a, **k):
        t = time.perf_counter()
        with torch.profiler.record_function("bench." + name):
            out = fn(*a, **k)
            run.sync()
        run.spans.add(name, time.perf_counter() - t)
        return out

    return wrapper


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
