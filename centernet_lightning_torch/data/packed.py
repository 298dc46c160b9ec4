"""Packed (pre-processed, memory-mapped) dataset cache (a copy of the JAX
package's data/packed.py, plus `write_pack` for arrays made in memory; a
pack written by either package loads in the other).

Packing runs the pipeline (dataset -> transforms -> padded collate) once
and writes the collated arrays to disk as .npy files; at train time the
loader memory-maps them and batch assembly is a fancy-index per array,
microseconds a batch on one host core. It also reads no image file, so it
is the way to train where the host cannot decode images (a machine
without OpenCV).

Augmentation is baked at pack time. Two knobs keep variety:
  * `copies=N` packs N epochs' worth of independently-augmented samples
    (epoch e draws different transform randomness), shuffled together at
    load time;
  * the loader's `flip_p` applies random horizontal flips online (a flip
    is a reversed-stride copy + 4 box adds), which the pack therefore
    should NOT include.

Layout of a pack directory:
  meta.json                 {"n", "keys", "dtypes", "shapes", "version"}
  <key>.npy                 one array per collated-batch key, leading dim n

Images are stored exactly as the pipeline emits them: keep `Normalize`
OUT of the transforms so they stay uint8 (4x smaller on disk and over
H2D; the train step normalizes on the device, train/state.py).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

__all__ = ["pack_dataset", "write_pack", "PackedLoader"]

_VERSION = 1


def pack_dataset(data_cfg: Dict[str, Any], out_dir: str, *, train: bool = True,
                 copies: int = 1, seed: int = 0,
                 progress: bool = False) -> Dict[str, Any]:
    """Run the config's pipeline once (per copy) and write the pack.

    `data_cfg` is the same dict `loader_from_config` takes (type,
    transforms, batch_size, max_boxes, ...). Samples are packed in dataset
    order (shuffle happens at LOAD time); `copies > 1` packs that many
    independently-augmented passes. Returns the meta dict.
    """
    from .builder import loader_from_config

    os.makedirs(out_dir, exist_ok=True)
    cfg = dict(data_cfg, shuffle=False, drop_last=False)
    cfg.pop("flip_p", None)  # loader-time knob, not a pipeline transform

    arrays: Dict[str, np.lib.format.open_memmap] = {}
    meta: Dict[str, Any] = {"version": _VERSION, "copies": int(copies)}
    cursor = 0
    n_total = None
    for copy in range(max(1, int(copies))):
        loader = loader_from_config(cfg, train=train, seed=seed + copy)
        if n_total is None:
            n_total = len(loader.dataset) * max(1, int(copies))
        for batch in loader:
            b = batch["image"].shape[0]
            for key, value in batch.items():
                value = np.asarray(value)
                if key not in arrays:
                    arrays[key] = np.lib.format.open_memmap(
                        os.path.join(out_dir, f"{key}.npy"), mode="w+",
                        dtype=value.dtype, shape=(n_total,) + value.shape[1:])
                arrays[key][cursor:cursor + b] = value
            cursor += b
            if progress and cursor % (50 * b) < b:
                print(f"packed {cursor}/{n_total}")
    for arr in arrays.values():
        arr.flush()
    return _write_meta(out_dir, meta, cursor, arrays)


def write_pack(out_dir: str, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Write collated arrays held in memory (key -> (n, ...) array, as
    `pack_dataset` would have collated them) as a pack of one copy.
    Returns the meta dict."""
    os.makedirs(out_dir, exist_ok=True)
    for key, value in arrays.items():
        np.save(os.path.join(out_dir, f"{key}.npy"), value)
    n = len(next(iter(arrays.values())))
    return _write_meta(out_dir, {"version": _VERSION, "copies": 1}, n, arrays)


def _write_meta(out_dir: str, meta: Dict[str, Any], n: int,
                arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    meta.update({
        "n": n,
        "keys": sorted(arrays),
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "shapes": {k: list(v.shape[1:]) for k, v in arrays.items()},
    })
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class PackedLoader:
    """Batches straight off a pack directory (memory-mapped, zero decode).

    Drop-in for data.loader.DataLoader on the consumer side: `__len__` is
    the batch count, iteration yields the padded-batch dict contract
    (image/boxes/labels/mask/...), shuffling reshuffles every epoch.

    `flip_p`: probability of a horizontal flip per sample, applied online
    (image reverse + x -> W - x - w on the xywh boxes). Requires the pack
    to hold UNNORMALIZED images only in the sense that flipping is
    dtype-agnostic — it works for uint8 and float packs alike.

    `shard_id`/`num_shards`: data parallelism over processes — every
    process reads the SAME pack and takes a disjoint interleaved slice (as
    DDP's DistributedSampler does; shard by rank and world size).
    Shuffling draws the same seed-derived permutation on every shard, so
    global batches stay epoch-consistent across processes.
    """

    def __init__(self, pack_dir: str, batch_size: int = 32,
                 shuffle: bool = False, drop_last: Optional[bool] = None,
                 flip_p: float = 0.0, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1):
        with open(os.path.join(pack_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("version") != _VERSION:
            raise ValueError(
                f"pack {pack_dir} has version {self.meta.get('version')}, "
                f"this loader reads version {_VERSION}")
        self.arrays = {
            key: np.load(os.path.join(pack_dir, f"{key}.npy"), mmap_mode="r")
            for key in self.meta["keys"]
        }
        self.n = int(self.meta["n"])
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.flip_p = float(flip_p)
        self.seed = seed
        self.shard_id = int(shard_id)
        self.num_shards = max(1, int(num_shards))
        if not 0 <= self.shard_id < self.num_shards:
            raise ValueError(
                f"shard_id {shard_id} out of range for {num_shards} shards")
        # equal-length shards (floor) so the processes stay in
        # lockstep — every process must dispatch the same number of steps
        self._n_shard = (self.n // self.num_shards if self.num_shards > 1
                         else self.n)
        self._epoch = 0
        # len(loader.dataset) is used for steps_per_epoch bookkeeping
        self.dataset = range(self._n_shard)

    def __len__(self) -> int:
        if self.drop_last:
            return self._n_shard // self.batch_size
        return (self._n_shard + self.batch_size - 1) // self.batch_size

    def _flip(self, batch: Dict[str, np.ndarray], rng: np.random.Generator):
        flip = rng.random(batch["image"].shape[0]) < self.flip_p
        if not flip.any():
            return batch
        width = batch["image"].shape[2]
        # __iter__ already materialized private per-batch copies (fancy
        # indexing of the memory-map), so mutate in place — a second
        # .copy() duplicated ~25 MB/batch at 512² b32 for nothing
        images, boxes = batch["image"], batch["boxes"]
        images[flip] = images[flip, :, ::-1]
        # xywh: x -> W - x - w, only on real rows (padding stays zero)
        boxes[flip, :, 0] = (width - boxes[flip, :, 0]
                             - boxes[flip, :, 2]) * batch["mask"][flip]
        return batch

    def __iter__(self):
        order = np.arange(self.n)
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        if self.shuffle:
            rng.shuffle(order)
        if self.num_shards > 1:
            # every shard permutes the GLOBAL order with the same seed,
            # then takes its interleaved slice — disjoint and consistent
            order = order[self.shard_id::self.num_shards][:self._n_shard]
        stop = ((self._n_shard - self.batch_size + 1) if self.drop_last
                else self._n_shard)
        for start in range(0, max(stop, 0), self.batch_size):
            idx = np.sort(order[start:start + self.batch_size])
            batch = {k: np.ascontiguousarray(a[idx])
                     for k, a in self.arrays.items()}
            if self.flip_p > 0:
                batch = self._flip(batch, rng)
            yield batch
