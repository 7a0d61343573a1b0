"""Multi-process data parallelism: the port of `cape_tpu.parallel`.

PyTorch's idiom in place of JAX's global programs: one process per card,
a `torch.distributed` process group, ranks in place of JAX's process
indices, and explicit collectives.

- `maybe_initialize()` makes the group from the environment of a launch:
  the JAX package's protocol (`CAPE_COORDINATOR`, `CAPE_NUM_PROCESSES`,
  `CAPE_PROCESS_ID`; the coordinator is `host:port`, or a URL such as
  `file:///shared/path`), torchrun's (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
  `MASTER_ADDR`, `MASTER_PORT`), or a group the launcher already made.
  The backend is `nccl` where CUDA is available and `gloo` elsewhere,
  unless the caller names one; a failed init raises.
- per-rank input sharding: each rank builds only its share of the global
  episode batch (`local_episode_count`) from its own sampling stream
  (`host_rng`); validation splits the fixed episodes
  (`host_episode_slice`) and gathers the decode outputs
  (`allgather_tree`) so that every rank scores the full set.
- `is_main()` gates checkpoint writes and logging.
- `allreduce_sum_dict` sums scalar metrics across ranks.

Host data (numpy leaves of `allgather_tree`, the metrics of
`allreduce_sum_dict`, `allgather_object`) goes through the group's own
device: the rank's card under `nccl`, which gathers only device tensors,
and the host under `gloo`. There is no second group.

What takes the place of `cape_tpu.parallel.mesh` and the `global_*`
functions, which have no one-for-one counterpart under one process per
card:

- `make_mesh` and `cfg.mesh_shape`: the data-parallel group is every
  process of the group, one card each. `(-1,)` means all processes, and
  any other value is read the same way: the field stays in the config for
  its round trip with the JAX package, nothing refuses it.
- `shard_batch`, `shard_stacked_batch`, `global_shard_batch`,
  `global_shard_stacked_batch`, `global_shard_inputs`: a rank's local
  batch already is its shard; `data.prefetch.to_device` puts it on the
  rank's card.
- `global_replicate_batch`: a batch every rank holds in full is on every
  card once `to_device` has copied it.
- `replicate`: a broadcast of every parameter and buffer from rank 0
  (`replicate(module)`).
- the gradient psum XLA inserts in the JAX train step: one all-reduce of
  the gradients a micro-step (`allreduce_sum_flat`, called by
  `train.train_step`), after the loss denominators were summed across
  ranks (`losses.criterion.loss_denominators`).
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: model-input keys of an episode batch (device-placed); everything else is
#: host-side bookkeeping the evaluator reads as numpy
MODEL_INPUT_KEYS = ("query_images", "support_coords", "support_mask",
                    "skeleton_edges")


def _launch() -> Optional[Tuple[str, int, int]]:
    """(init_method, world size, rank) from the launch environment, or
    None for a single-process run."""
    coord = os.environ.get("CAPE_COORDINATOR")
    nproc = os.environ.get("CAPE_NUM_PROCESSES")
    if coord and nproc:
        url = coord if "://" in coord else f"tcp://{coord}"
        return url, int(nproc), int(os.environ.get("CAPE_PROCESS_ID", "0"))
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return ("env://", int(os.environ["WORLD_SIZE"]),
                int(os.environ["RANK"]))
    return None


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank(rank: Optional[int] = None) -> int:
    """The card of this process on its host: `LOCAL_RANK` where the
    launcher sets it, else the rank modulo the visible cards (processes
    numbered host by host), 0 without cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count()
    rank = process_index() if rank is None else rank
    return rank % n if n else 0


def maybe_initialize(backend: Optional[str] = None) -> bool:
    """Make the process group when launched multi-process (see the module
    docstring). Returns True if running multi-process after the call. Safe
    to call more than once and in single-process runs (no-op). Under
    `nccl` the rank's card becomes the current device first and the
    group's device."""
    if _grouped():                       # made already, here or by a launcher
        return dist.get_world_size() > 1
    launch = _launch()
    if launch is None:
        return False
    url, world, rank = launch
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    card = None
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA; name 'gloo' "
                               "to run on the CPU")
        card = torch.device("cuda", local_rank(rank))
        torch.cuda.set_device(card)
    # with a card named, nccl makes its communicator here (a failure
    # raises now, not at the first collective)
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank, device_id=card)
    return world > 1


def process_count() -> int:
    return dist.get_world_size() if _grouped() else 1


def process_index() -> int:
    return dist.get_rank() if _grouped() else 0


def is_main() -> bool:
    """True on the process that writes checkpoints and logs (reference
    `save_on_master`, `util/misc.py:338-340`)."""
    return process_index() == 0


def local_episode_count(global_batch: int,
                        n_processes: Optional[int] = None,
                        index: Optional[int] = None) -> int:
    """Per-rank share of a global episode batch. The global batch must
    divide evenly, so that every rank takes the same shapes; raises
    otherwise."""
    n = n_processes if n_processes is not None else process_count()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} processes")
    del index  # same count on every rank; offset handled by the sampler seed
    return global_batch // n


def host_rng(seed: int, epoch: int = 0) -> np.random.Generator:
    """Per-rank episodic sampling stream, disjoint by rank: the JAX
    package's stream of the same process index."""
    return np.random.default_rng([seed, process_index(), epoch])


def rank_seed(seed: int, epoch: int = 0) -> int:
    """The dropout generator's seed of this rank. The JAX step is one
    global program that draws another mask for every row; one seed on
    every rank would give row i of each rank the same mask."""
    return int(np.random.SeedSequence(
        [seed, process_index(), epoch]).generate_state(1)[0])


def host_episode_slice(episodes: list, total: int):
    """Split a fixed episode list for sharded evaluation.

    Rank r takes the contiguous block [r*per_rank, (r+1)*per_rank) of a
    list padded (by wrapping) to `process_count() * per_rank`; returns
    (local_list, local_valid_count). Every rank gets a slice of the same
    size, and ranks past the real episodes contribute wrapped padding that
    their valid count excludes."""
    n, r = process_count(), process_index()
    per = -(-total // n)
    local = [episodes[(r * per + i) % len(episodes)] for i in range(per)]
    return local, max(0, min(per, total - r * per))


def _device() -> torch.device:
    """Where the group's collectives take host data: the current card
    under nccl, the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def allgather_tree(tree):
    """Concatenate every leaf across ranks along axis 0, in rank order, as
    numpy. Leaves are tensors (on any device) or arrays of the same shape
    on every rank. Single-process: the leaves as numpy."""
    if isinstance(tree, Mapping):
        return {k: allgather_tree(v) for k, v in tree.items()}
    x = np.atleast_1d(_host(tree))
    if process_count() == 1:
        return x
    flag = x.dtype == np.bool_
    t = torch.from_numpy(np.ascontiguousarray(
        x.view(np.uint8) if flag else x)).to(_device())
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    out = torch.cat(parts).cpu().numpy()
    return out.view(np.bool_) if flag else out


def allgather_object(obj) -> List:
    """Every rank's picklable `obj`, in rank order ([obj] single-process)."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def allreduce_sum_dict(metrics: Dict[str, float]) -> Dict[str, float]:
    """Sum scalar metrics across ranks (reference `reduce_dict`,
    `util/misc.py:128-153`), in float64. No-op single-process."""
    if process_count() == 1:
        return dict(metrics)
    keys = sorted(metrics)
    t = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                     device=_device())
    dist.all_reduce(t)
    return {k: float(v) for k, v in zip(keys, t.cpu().tolist())}


def allreduce_sum_flat(tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """The sum across ranks of each tensor, in one all-reduce over a flat
    fp32 buffer on the tensors' device; returns fp32 tensors shaped like
    the inputs (views of the buffer). Single-process: the tensors in
    fp32."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    if process_count() > 1:
        dist.all_reduce(flat)
    return [v.view(t.shape) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast every parameter and buffer of `module` from rank 0, in
    place (the JAX package's `replicate` of the params onto the mesh).
    No-op single-process."""
    if process_count() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module
