"""One rank of the two-process `gloo` groups of `test_torch_port_ddp.py`
on the CPU. It holds no tests and imports torch, numpy and the port only,
never JAX:

    CAPE_COORDINATOR=file:///tmp/store CAPE_NUM_PROCESSES=2 \\
    CAPE_PROCESS_ID=0 python tests/test_torch_port_ddp_worker.py spec.json

`spec.json` names the tiny config (JSON), the weights (a port state_dict
file), the global train batches (`save_batches`), the fixture's fixed
val episodes and where rank 0 saves its masters. In one process start the
worker checks the collectives under the group, runs `evaluate_cape(
multihost=True)` on its slice of the episodes with the initial weights,
then takes the train step on its half of each global batch, and prints
one line `RESULT {json}`.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cape_tpu_torch.config import CAPEConfig  # noqa: E402
from cape_tpu_torch.data.builder import (build_mp100_cape,  # noqa: E402
                                         resolve_split_file)
from cape_tpu_torch.data.episodic import (EpisodicSampler,  # noqa: E402
                                          episode_batches, eval_batch_plan)
from cape_tpu_torch.eval import evaluate_cape  # noqa: E402
from cape_tpu_torch.losses.criterion import loss_denominators  # noqa: E402
from cape_tpu_torch.models.cape import CAPE  # noqa: E402
from cape_tpu_torch.parallel import (allgather_object,  # noqa: E402
                                     allgather_tree, allreduce_sum_dict,
                                     host_episode_slice, is_main,
                                     local_episode_count, maybe_initialize,
                                     process_count, process_index,
                                     rank_seed, replicate)
from cape_tpu_torch.train import (create_train_state,  # noqa: E402
                                  make_train_step)


def save_batches(path: str, batches) -> None:
    """A list of (nested) numpy batch dicts as one .npz."""
    flat = {}
    for i, b in enumerate(batches):
        for k, v in b.items():
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
                flat[f"{i}/{k}" + (f"/{kk}" if kk else "")] = vv
    np.savez(path, **flat)


def load_batches(path: str):
    out = {}
    with np.load(path) as z:
        for key in z.files:
            i, *names = key.split("/")
            d = out.setdefault(int(i), {})
            for n in names[:-1]:
                d = d.setdefault(n, {})
            d[names[-1]] = z[key]
    return [out[i] for i in sorted(out)]


def rows(tree, lo: int, n: int):
    """Rows [lo, lo + n) of every leaf."""
    if isinstance(tree, dict):
        return {k: rows(v, lo, n) for k, v in tree.items()}
    return tree[lo:lo + n]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def collectives(model: CAPE) -> dict:
    """The helpers under the group: summed metrics, gathered leaves of
    every dtype the evaluator gathers, gathered objects, and `replicate`
    undoing a perturbation of rank 1's weights."""
    r = process_index()
    summed = allreduce_sum_dict({"a": r + 1.0, "b": 0.25})
    tree = allgather_tree({"f": np.full((2, 3), r, np.float32),
                           "i": torch.tensor([r, 7], dtype=torch.int32),
                           "b": np.array([r == 0, True])})
    objs = allgather_object({"rank": r})
    with torch.no_grad():
        if r == 1:
            for p in model.parameters():
                p.add_(1.0)
    replicate(model)
    return {"summed": summed,
            "gathered": {k: v.tolist() for k, v in tree.items()},
            "dtypes": {k: str(v.dtype) for k, v in tree.items()},
            "objects": objs,
            "weights": digest(model.state_dict().values())}


def sharded_eval(model: CAPE, cfg: CAPEConfig, spec: dict) -> dict:
    """`evaluate_cape(multihost=True)` on this rank's slice of the fixed
    episodes, in per-rank batches as `train.loop` plans them."""
    n, n_ranks = spec["episodes"], process_count()
    ds = build_mp100_cape("val", cfg)
    sampler = EpisodicSampler(ds, resolve_split_file(cfg), "val",
                              num_queries=1, num_support=1)
    fixed = sampler.fixed_episodes(n, spec["episode_seed"])
    local, valid = host_episode_slice(fixed, n)
    eb, nb = eval_batch_plan(-(-n // n_ranks),
                             max(1, spec["eval_batch_size"] // n_ranks))
    batches = episode_batches(
        ds, sampler, eb, nb, cfg.image_size, cfg.max_support_keypoints,
        cfg.max_skeleton_edges,
        np.random.default_rng([spec["episode_seed"], process_index()]),
        fixed=local, total_episodes=valid)
    stats = evaluate_cape(model, batches, cfg, multihost=True)
    return {"local_valid": valid, "batch": eb, "batches": nb,
            **{k: v for k, v in stats.items() if np.isscalar(v)},
            "pck_per_category": {str(k): v for k, v in
                                 stats["pck_per_category"].items()}}


def train(model: CAPE, cfg: CAPEConfig, spec: dict) -> dict:
    """The train step on this rank's half of each global batch."""
    batches = load_batches(spec["batches"])
    state = create_train_state(cfg, model, spec["steps_per_epoch"])
    step = make_train_step(model, cfg, spec["steps_per_epoch"])
    n = local_episode_count(len(batches[0]["query_images"]))
    lo = process_index() * n
    gen = torch.Generator().manual_seed(rank_seed(cfg.seed))
    metrics, dens = [], []
    for b in batches:
        mine = rows(b, lo, n)
        dens.append(loss_denominators(
            {k: torch.from_numpy(v) for k, v in mine["targets"].items()},
            cfg).tolist())
        state, m = step(state, mine, gen)
        metrics.append({k: v.item() for k, v in m.items()})
    masters = state.opt_state.masters
    if is_main():
        torch.save(dict(zip(state.opt_state.names, masters)),
                   spec["masters"])
    return {"metrics": metrics, "denominators": dens,
            "masters": digest(masters), "step": state.step,
            "gradient_step": state.opt_state.gradient_step}


def main() -> None:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    torch.set_num_threads(2)
    multi = maybe_initialize()
    cfg = CAPEConfig.from_json(spec["config"])
    model = CAPE(cfg, device="cpu")
    weights = torch.load(spec["weights"], weights_only=True)
    res = {"multi": multi, "rank": process_index(), "main": is_main(),
           "count": process_count()}
    res["collectives"] = collectives(model)
    model.load_state_dict(weights)
    res["eval"] = sharded_eval(model, cfg, spec)
    model.load_state_dict(weights)
    res["train"] = train(model, cfg, spec)
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
