"""Multi-process data parallelism (`torch.distributed`), the port of
`cape_tpu.parallel`: see `distributed` for what replaces the mesh and the
`global_*` functions."""

from .distributed import (MODEL_INPUT_KEYS, allgather_object, allgather_tree,
                          allreduce_sum_dict, allreduce_sum_flat,
                          host_episode_slice, host_rng, is_main,
                          local_episode_count, local_rank, maybe_initialize,
                          process_count, process_index, rank_seed, replicate)

__all__ = [
    "maybe_initialize", "is_main", "process_count", "process_index",
    "local_rank", "local_episode_count", "host_rng", "rank_seed",
    "host_episode_slice", "allgather_tree", "allgather_object",
    "allreduce_sum_dict", "allreduce_sum_flat", "replicate",
    "MODEL_INPUT_KEYS",
]
