"""Data parallelism over processes, one process a device (port of
parallel/mesh.py onto torch.distributed)."""
from .dist import (all_gather_host, all_reduce_sum, barrier, broadcast_module,
                   gather_object_lists, gather_rows, global_normalizer,
                   init_from_env, mean_gradients, mean_losses, process_count,
                   process_index, process_local_batch_size)

__all__ = ["all_gather_host", "all_reduce_sum", "barrier", "broadcast_module",
           "gather_object_lists", "gather_rows", "global_normalizer",
           "init_from_env", "mean_gradients", "mean_losses", "process_count",
           "process_index", "process_local_batch_size"]
