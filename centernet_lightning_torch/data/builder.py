"""Dataset/dataloader registry (a copy of the JAX package's data/builder.py;
the packed cache and the multi-process sharding by rank wait for the train
CLI and DDP, ROADMAP Queue 1 items 4 and 6).

Restores the reference's Gen-A builder API (reference
datasets/builder.py:17-59): name registry {coco, voc, crowdhuman,
mot-tracking, kitti-tracking}, task inferred from the name suffix, optional
DetectionForTracking wrap, collate chosen by task.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .coco import CocoDetection
from .collate import CollateDetection, CollateTracking
from .crowdhuman import CrowdHumanDataset
from .detection_for_tracking import DetectionForTracking
from .kitti import KITTITrackingDataset
from .loader import DataLoader
from .mot import MOTTrackingDataset
from .transforms import build_transforms
from .voc import VOCDataset

__all__ = ["DATASETS", "build_dataset", "build_dataloader", "parse_transforms",
           "loader_from_config"]

DATASETS = {
    "coco": CocoDetection,
    "voc": VOCDataset,
    "crowdhuman": CrowdHumanDataset,
    "mot-tracking": MOTTrackingDataset,
    "kitti-tracking": KITTITrackingDataset,
}

parse_transforms = build_transforms  # reference naming (builder.py:46)


def build_dataset(config: Dict[str, Any], seed: Optional[int] = None):
    """config: {type, transforms?, detection_for_tracking?, mosaic?,
    **dataset kwargs}.

    `mosaic: {height, width, p}` wraps the dataset in MosaicDataset; any
    Normalize entry (and everything after it) in `transforms` moves to the
    post-mosaic pipeline so the canvas composes on uint8 images.
    """
    from .mosaic import MosaicDataset

    config = dict(config)
    ds_type = config.pop("type")
    transforms_cfg = config.pop("transforms", None) or []
    if isinstance(transforms_cfg, dict):
        # Gen-A mapping form {Name: params}
        transforms_cfg = [{"name": n, "params": p}
                          for n, p in transforms_cfg.items()]
    transforms_cfg = list(transforms_cfg)
    wrap_tracking = config.pop("detection_for_tracking", False)
    mosaic_cfg = config.pop("mosaic", None)

    post_cfg = []
    if mosaic_cfg:
        for i, t in enumerate(transforms_cfg):
            if t.get("name") == "Normalize":
                post_cfg = transforms_cfg[i:]
                transforms_cfg = transforms_cfg[:i]
                break

    transforms = build_transforms(transforms_cfg, seed=seed) if transforms_cfg else None
    ds = DATASETS[ds_type](transforms=transforms, **config)
    if wrap_tracking:
        ds = DetectionForTracking(ds)
    if mosaic_cfg:
        mosaic_cfg = dict(mosaic_cfg) if isinstance(mosaic_cfg, dict) else {}
        ds = MosaicDataset(
            ds,
            out_h=mosaic_cfg.get("height", 512),
            out_w=mosaic_cfg.get("width", 512),
            p=mosaic_cfg.get("p", 1.0),
            seed=seed or 0,
            post_transforms=build_transforms(post_cfg, seed=seed) if post_cfg else None,
        )
    return ds


def build_dataloader(
    dataset,
    batch_size: int = 32,
    shuffle: bool = False,
    num_workers: int = 4,
    max_boxes: Optional[int] = None,
    drop_last: Optional[bool] = None,
    seed: int = 0,
    shard_id: int = 0,
    num_shards: int = 1,
    **_ignored,
) -> DataLoader:
    is_tracking = isinstance(dataset, (MOTTrackingDataset, KITTITrackingDataset,
                                       DetectionForTracking))
    if max_boxes is None:
        max_boxes = 256 if is_tracking else 128
    collate = (CollateTracking(max_boxes) if is_tracking
               else CollateDetection(max_boxes))
    return DataLoader(
        dataset, batch_size=batch_size, shuffle=shuffle,
        collate_fn=collate, num_workers=num_workers,
        drop_last=shuffle if drop_last is None else drop_last, seed=seed,
        shard_id=shard_id, num_shards=num_shards,
    )


def loader_from_config(config, train: bool, seed=None):
    """Dataset + DataLoader from ONE config dict — the single home for the
    loader-key plumbing used by both CenterNet.get_dataloader (reference
    centernet.py:220-227) and the train CLI. An explicit `shuffle` in the
    config overrides the train/eval default."""
    cfg = dict(config)
    cfg.setdefault("type", "coco")
    if cfg["type"] == "packed":
        raise NotImplementedError(
            "the packed dataset cache (data/packed.py) is ported with the "
            "train CLI (ROADMAP Queue 1 item 4)")
    loader_keys = {"batch_size", "num_workers", "shuffle", "max_boxes",
                   "drop_last", "pin_memory", "shard_id", "num_shards"}
    loader_cfg = {k: cfg.pop(k) for k in list(cfg) if k in loader_keys}
    loader_cfg.pop("pin_memory", None)  # the trainer pins its uploads itself
    shuffle = loader_cfg.pop("shuffle", train)
    ds = build_dataset(cfg, seed=(0 if train else 1) if seed is None else seed)
    return build_dataloader(ds, shuffle=shuffle,
                            seed=0 if seed is None else seed, **loader_cfg)
