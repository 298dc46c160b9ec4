"""Parallelism over processes, one process a device (port of
parallel/mesh.py onto torch.distributed): the data axis (`dist`) and the
(data, model) grid with its tensor-parallel convolutions and height split
(`mesh`)."""
from . import mesh
from .dist import (all_gather_host, all_reduce_sum, barrier, broadcast_module,
                   data_parallel, gather_object_lists,
                   gather_rows, global_normalizer, init_from_env,
                   mean_gradients, mean_losses, process_count, process_index,
                   process_local_batch_size)
from .mesh import (Mesh, create_mesh, full_state_dict, gather_bands,
                   shard_batch, shard_params, spatial_detect, spatial_forward,
                   split_rows)

__all__ = ["all_gather_host", "all_reduce_sum", "barrier", "broadcast_module",
           "data_parallel", "gather_object_lists",
           "gather_rows", "global_normalizer", "init_from_env",
           "mean_gradients", "mean_losses", "process_count", "process_index",
           "process_local_batch_size", "mesh", "Mesh", "create_mesh",
           "full_state_dict", "gather_bands", "shard_batch", "shard_params",
           "spatial_detect", "spatial_forward", "split_rows"]
