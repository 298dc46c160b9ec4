"""Data parallelism over processes (port of parallel/mesh.py).

The JAX package puts the global batch on a mesh's `data` axis and lets
GSPMD compute the whole step over it: BatchNorm statistics, loss
normalisers, the gradient mean, the clipping norm and the ReID pairs are
all the global batch's. Here one process drives one device through
`torch.distributed` (NCCL on the card, gloo on the CPU), each on its own
slice of the global batch, and these helpers put the global quantities
back together:

  - `mean_gradients`: one flat all-reduce of the f32 gradients, averaged;
  - `global_normalizer`: a loss's count summed over the processes, so that
    the processes' mean loss (and mean gradient) is the global batch's;
  - `all_reduce_sum` / `gather_rows`: torch's differentiable collectives,
    for BatchNorm's statistics and the triplet loss's pairs;
  - `all_gather_host` / `gather_object_lists`: host-side unions of numpy
    trees and ragged per-image lists (validation's merge);
  - `broadcast_module`: rank 0's parameters and buffers to every rank.

With one process (no process group, or a group of one) every helper
returns its input as it is, so a single process computes exactly what it
computed before. The JAX package's `model` axis (`create_mesh(n_model>1)`,
`shard_params(model_parallel=True)`, `spatial_sharding`) has no
counterpart here yet.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["init_from_env", "process_index", "process_count",
           "process_local_batch_size", "barrier", "broadcast_module",
           "mean_gradients", "mean_losses", "global_normalizer",
           "all_reduce_sum", "gather_rows", "all_gather_host",
           "gather_object_lists"]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The number of processes in the default group (1 without one)."""
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if _initialized() else 0


def process_local_batch_size(global_batch_size: int) -> int:
    """This process's slice of the global batch."""
    return global_batch_size // process_count()


def init_from_env(device="cuda") -> torch.device:
    """Join the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return
    this process's device: `cuda:LOCAL_RANK` over NCCL, or the CPU over
    gloo when `device` is the CPU. NCCL is not replaced by gloo when it
    fails. A group that is already up (a caller's own store) is kept."""
    kind = torch.device(device).type
    if not _initialized():
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        url = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        if kind == "cuda":
            torch.cuda.set_device(local)
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                init_method=url, rank=rank, world_size=world)
    if kind != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", process_index()))
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def _collective_device() -> torch.device:
    """Where host data goes for a collective: NCCL moves only device
    tensors, gloo host ones."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank `src`'s parameters and buffers, in place, on every rank."""
    if process_count() == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)


@torch.no_grad()
def mean_gradients(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The gradients averaged over the processes: one all-reduce of one
    flat buffer, then views of it under the same names."""
    world = process_count()
    if world == 1:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads.values()])
    dist.all_reduce(flat)
    flat.div_(world)
    out, start = {}, 0
    for k, g in grads.items():
        out[k] = flat[start:start + g.numel()].view_as(g)
        start += g.numel()
    return out


@torch.no_grad()
def mean_losses(losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The scalar losses averaged over the processes, which with
    `global_normalizer` is the global batch's loss (one all-reduce)."""
    world = process_count()
    if world == 1:
        return losses
    flat = torch.stack([v.detach().float() for v in losses.values()])
    dist.all_reduce(flat)
    flat.div_(world)
    return dict(zip(losses, flat.unbind()))


def global_normalizer(count: torch.Tensor, floor: Optional[float] = None,
                      eps: float = 0.0) -> torch.Tensor:
    """What a per-process loss sum divides by: the count over the global
    batch (summed over the processes, no gradient), at least `floor`, plus
    `eps`, over the number of processes. The processes' mean of
    sum / normalizer is then the global sum over the global count, and
    so is their mean gradient. One process: max(floor, count) + eps."""
    world = process_count()
    total = count if world == 1 else _all_reduce_detached(count)
    if floor is not None:
        total = torch.clamp(total, min=floor)
    if eps:
        total = total + eps
    return total if world == 1 else total / world


@torch.no_grad()
def _all_reduce_detached(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the processes, differentiably: the cotangent is
    summed the same way (identity for one process)."""
    if process_count() == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's rows of `x`, concatenated in rank order: the global
    batch's rows. Differentiable (the backward sums every process's
    cotangent of this rank's rows); the shapes must agree across
    processes (the collate pads to a fixed `max_boxes`)."""
    if process_count() == 1:
        return x
    from torch.distributed.nn.functional import all_gather

    return torch.cat(all_gather(x))


def all_gather_host(tree):
    """Union the processes' fixed-shape numpy arrays (an array or a dict
    of arrays): each leaf comes back with a leading process axis, as JAX's
    `process_allgather` gives it. One process: the tree as it is."""
    if process_count() == 1:
        return tree
    if isinstance(tree, dict):
        return {k: all_gather_host(v) for k, v in tree.items()}
    arr = np.ascontiguousarray(tree)
    t = torch.from_numpy(arr).to(_collective_device())
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return np.stack([p.cpu().numpy() for p in parts])


def gather_object_lists(items, schema: Dict[str, Any], _allgather=None,
                        _process_count: Optional[int] = None):
    """Union the processes' lists of dicts of variable-length numpy arrays
    (per-image predictions or targets), which a collective cannot move as
    they are, through padded fixed-shape blocks:

      1. allgather each process's (number of items, most rows) pair,
      2. pad every array to the global largest block,
      3. allgather the blocks and each item's row count (-1 marks padding),
      4. unpack into one list ordered by (process, item).

    `schema` maps key -> (trailing shape, dtype) and must be the same on
    every process, so a process with no items still sends blocks of the
    right shape. Each key's leading dimension is the item's row count.
    `_allgather` / `_process_count` can be injected for tests.
    """
    pc = _process_count if _process_count is not None else process_count()
    if pc == 1:
        return list(items)
    allgather = _allgather or all_gather_host

    keys = sorted(schema)
    counts = np.asarray([len(np.asarray(it[keys[0]])) for it in items],
                        np.int64)
    n_local = len(items)
    k_local = int(counts.max()) if n_local else 0

    dims = np.asarray(allgather(np.asarray([n_local, k_local], np.int64)))
    n_max = int(dims[:, 0].max())
    k_max = max(int(dims[:, 1].max()), 1)

    packed = {"_counts": np.full((n_max,), -1, np.int64)}
    packed["_counts"][:n_local] = counts
    for key in keys:
        trail, dtype = schema[key]
        block = np.zeros((n_max, k_max, *trail), dtype)
        for i, it in enumerate(items):
            arr = np.asarray(it[key], dtype).reshape(-1, *trail)
            block[i, :len(arr)] = arr
        packed[key] = block

    gathered = {k: np.asarray(v) for k, v in allgather(packed).items()}
    out = []
    for p in range(pc):
        cnts = gathered["_counts"][p]
        for i in range(n_max):
            c = int(cnts[i])
            if c < 0:
                continue
            out.append({key: gathered[key][p, i, :c] for key in keys})
    return out
