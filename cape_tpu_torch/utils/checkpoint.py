"""Checkpoints in torch's own format, with best-PCK tracking and retention:
the port of `cape_tpu.utils.checkpoint` (which writes orbax).

Parity with the JAX package's layout (`train_cape_episodic.py:853-959`):
- one directory a checkpoint, `epoch_N` for every epoch and
  `best_epoch_N_pck_X.XXXX` for every new best PCK, under the run's
  `output_dir`; the last 3 of each kind are kept;
- `meta.json`: epoch, best PCK, patience, the full config (self-describing
  checkpoints), the host numpy rng state (`rng_state`) and, in place of the
  JAX dropout key, the dropout `torch.Generator`'s state
  (`torch_rng_state`); across processes also every rank's two states, in
  rank order (`rank_states`: [{"rng_state", "torch_rng_state"}, ...]),
  the top-level pair being rank 0's, which a single-process restore
  reads;
- `state.pt`: `train.state.TrainState.state_dict()`, the step, the fp32
  masters (never the bf16 model copies), `mu`, `nu`, `acc_grads` and the
  four counts, read back with `torch.load(weights_only=True)`.

A save writes into `.tmp_<name>` and renames it into place, so a crash
mid-write never leaves a partial checkpoint under a final name or loses
the previous one; temp directories left by a crashed run are dropped when
a manager opens the directory. Writes are synchronous: `wait()` is kept so
the call sites read like the JAX loop's.

A JAX (orbax) checkpoint reaches the port through
`convert.from_jax_train_state` and `TrainState.load_state_dict`, in code
that may import both packages.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import CAPEConfig

_EPOCH_RE = re.compile(r"^epoch_(\d+)$")
_BEST_RE = re.compile(r"^best_epoch_(\d+)_pck_([0-9.]+)$")
STATE_FILE = "state.pt"
META_FILE = "meta.json"


class CheckpointManager:
    def __init__(self, output_dir: str, keep: int = 3):
        self.dir = os.path.abspath(output_dir)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)
        # drop orphaned temp dirs from a previous crashed run
        for name in os.listdir(self.dir):
            if name.startswith(".tmp_"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # ------------------------------------------------------------------
    def _save(self, name: str, state, meta: Dict[str, Any]) -> None:
        tmp = os.path.join(self.dir, f".tmp_{name}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f, indent=2)
        torch.save(state.state_dict(), os.path.join(tmp, STATE_FILE))
        final = os.path.join(self.dir, name)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._cleanup(_EPOCH_RE, key=lambda m: int(m.group(1)))
        self._cleanup(_BEST_RE, key=lambda m: int(m.group(1)))

    def wait(self) -> None:
        """Writes are synchronous: nothing is in flight."""

    @staticmethod
    def _meta(epoch: int, cfg: CAPEConfig, best_pck: float, patience: int,
              rng_state: Optional[dict], torch_rng_state: Optional[str],
              extra: Optional[Dict],
              rank_states: Optional[List[Dict]]) -> Dict[str, Any]:
        meta = {
            "epoch": epoch,
            "best_pck": best_pck,
            "patience": patience,
            "config": json.loads(cfg.to_json()),
            "rng_state": rng_state,
            "torch_rng_state": torch_rng_state,
            "extra": extra or {},
        }
        if rank_states is not None:
            meta["rank_states"] = rank_states
        return meta

    def save_epoch(self, state, epoch: int, cfg: CAPEConfig,
                   best_pck: float, patience: int,
                   rng_state: Optional[dict] = None,
                   torch_rng_state: Optional[str] = None,
                   extra: Optional[Dict] = None,
                   rank_states: Optional[List[Dict]] = None) -> None:
        self._save(f"epoch_{epoch}", state,
                   self._meta(epoch, cfg, best_pck, patience, rng_state,
                              torch_rng_state, extra, rank_states))

    def save_best(self, state, epoch: int, pck: float, cfg: CAPEConfig,
                  best_pck: float, patience: int,
                  rng_state: Optional[dict] = None,
                  torch_rng_state: Optional[str] = None,
                  rank_states: Optional[List[Dict]] = None) -> None:
        meta = self._meta(epoch, cfg, best_pck, patience, rng_state,
                          torch_rng_state, None, rank_states)
        meta["pck"] = pck
        self._save(f"best_epoch_{epoch}_pck_{pck:.4f}", state, meta)

    def _cleanup(self, pattern, key) -> None:
        entries = sorted((key(m), name) for name in os.listdir(self.dir)
                         if (m := pattern.match(name)))
        for _, name in entries[:-self.keep] if len(entries) > self.keep else []:
            shutil.rmtree(os.path.join(self.dir, name))

    # ------------------------------------------------------------------
    def _complete(self, name: str) -> bool:
        return os.path.isfile(os.path.join(self.dir, name, STATE_FILE))

    def list_checkpoints(self):
        return sorted(
            n for n in os.listdir(self.dir)
            if (_EPOCH_RE.match(n) or _BEST_RE.match(n)) and self._complete(n)
        )

    def latest(self) -> Optional[str]:
        best = None
        for name in os.listdir(self.dir):
            m = _EPOCH_RE.match(name)
            if m and self._complete(name) and (
                    best is None or int(m.group(1)) > best[0]):
                best = (int(m.group(1)), name)
        return os.path.join(self.dir, best[1]) if best else None

    def best(self) -> Optional[str]:
        top = None
        for name in os.listdir(self.dir):
            m = _BEST_RE.match(name)
            if m and self._complete(name) and (
                    top is None or float(m.group(2)) > top[0]):
                top = (float(m.group(2)), name)
        return os.path.join(self.dir, top[1]) if top else None

    def restore(self, path: str, target_state) -> Tuple[Any, Dict]:
        """The module's `restore`."""
        return restore(path, target_state)


def restore(path: str, target_state) -> Tuple[Any, Dict]:
    """Load a checkpoint into `target_state` (a `TrainState` of the same
    model, e.g. fresh from `create_train_state`) in place, without a
    manager (which would clean its directory). Returns (state, meta)."""
    target_state.load_state_dict(load_state(path, target_state.model.device))
    return target_state, read_meta(path)


def read_meta(path: str) -> Dict:
    with open(os.path.join(path, META_FILE)) as f:
        return json.load(f)


def config_of(path: str) -> CAPEConfig:
    """The config a checkpoint was trained with."""
    return CAPEConfig.from_json(json.dumps(read_meta(path)["config"]))


def load_state(path: str, device="cpu") -> Dict:
    """A checkpoint's `TrainState.state_dict()`, tensors on `device`."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=device,
                      weights_only=True)


def load_weights(model: torch.nn.Module, path: str) -> None:
    """A checkpoint's fp32 masters into `model` (cast to its dtype), for
    evaluation and serving: no optimizer state is built."""
    model.load_state_dict(load_state(path, model.device)["params"])


def torch_rng_state(gen: torch.Generator) -> str:
    """JSON-serializable state of a `torch.Generator` (on any device): its
    state bytes as hex."""
    return bytes(gen.get_state().numpy()).hex()


def restore_torch_rng(gen: torch.Generator, state: str) -> torch.Generator:
    gen.set_state(torch.frombuffer(bytearray.fromhex(state),
                                   dtype=torch.uint8))
    return gen


def numpy_rng_state(rng: np.random.Generator) -> dict:
    """JSON-serializable host PRNG state (parity with the reference saving
    torch/numpy/python RNG states, `train_cape_episodic.py:883-890`)."""
    state = rng.bit_generator.state
    return json.loads(json.dumps(state, default=int))


def restore_numpy_rng(state: dict) -> np.random.Generator:
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    return rng
