"""Config system (a copy of centernet_lightning_tpu/train/config.py).

The port keeps its own copy so that it imports nothing of the JAX package;
tests hold the two against each other. PyYAML is imported only inside
`load_config`, so a config given as a dict needs no PyYAML.

 - Gen-B (reference train.py:5 LightningCLI): `model:` = CenterNet hparams,
   `trainer:` = loop settings — accepted as-is.
 - Gen-A (reference configs/base_resnet34.yaml): nested
   model.task/backbone/neck/output_heads/optimizer + data.train/validation
   trees with `__base__:` file inheritance (configs/helmet.yaml:1) —
   normalized into the Gen-B shape by `normalize_config`.

`load_config` resolves `__base__` chains with deep-merge (child wins).

Silent-drop protection: `normalize_config` tracks every leaf key it
consumes and WARNS about (or, with strict=True, raises on) any Gen-A key
it didn't map. The explicit no-op keys are listed in `_IGNORED_KEYS` with
their rationale.
"""
from __future__ import annotations

import copy
import math
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["load_config", "deep_merge", "normalize_config", "UnknownKeyError"]


class UnknownKeyError(ValueError):
    """A Gen-A config key the normalizer does not map (strict mode)."""


def deep_merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        config = yaml.safe_load(f) or {}
    base = config.pop("__base__", None)
    if base:
        base_path = base if os.path.isabs(base) else os.path.join(
            os.path.dirname(os.path.abspath(path)), base
        )
        config = deep_merge(load_config(base_path), config)
    return config


# ---------------------------------------------------------------------------
# Gen-A -> Gen-B normalization
# ---------------------------------------------------------------------------

_GEN_A_HEATMAP_LOSSES = {
    "cornernet_focal": "CornerNetFocalLoss",
    "quality_focal": "QualityFocalLoss",
}
_GEN_A_BOX_LOSSES = {
    "l1": "L1Loss", "smooth_l1": "SmoothL1Loss", "iou": "IoULoss",
    "giou": "GIoULoss", "diou": "DIoULoss", "ciou": "CIoULoss",
}
_GEN_A_REID_LOSSES = {"ce", "cross_entropy", "triplet"}

# keyword arguments of the JAX package's train/optim.py:make_optimizer and
# the names of its data/transforms.py:TRANSFORMS (plus Mosaic), copied so
# the port validates configs without importing either; a test keeps the
# copies equal to the originals
OPTIMIZER_KEYS = frozenset({
    "lr", "weight_decay", "norm_weight_decay", "warmup_epochs",
    "warmup_decay", "max_epochs", "steps_per_epoch", "gradient_clip_val",
    "momentum", "frozen_stages",
})
TRANSFORM_NAMES = frozenset({
    "Resize", "SmallestMaxSize", "LongestMaxSize", "RandomCrop",
    "CenterCrop", "RandomResizedCrop", "PadIfNeeded", "HorizontalFlip",
    "VerticalFlip", "ColorJitter", "Normalize", "Cutout", "MotionBlur",
    "Affine", "TrivialAugmentWide", "Mosaic",
})

# keys we deliberately accept and do nothing with, each with the reason
_IGNORED_KEYS = {
    ("model", "task"): "detection/tracking is inferred from the reid head",
    ("trainer", "gpus"): "device placement is the JAX mesh",
    ("trainer", "strategy"): "DDP strategy; GSPMD shards automatically",
    ("trainer", "sync_batchnorm"): "cross-replica BN stats are built in",
    ("trainer", "benchmark"): "cudnn autotune; XLA compiles ahead of time",
    ("trainer", "num_sanity_val_steps"): "no sanity-val phase here",
}
_IGNORED_DATALOADER_KEYS = {
    "pin_memory": "no pinned-host-memory notion on this runtime",
}
_KNOWN_TRAINER_KEYS = {
    "max_epochs", "val_check_interval", "check_val_every_n_epoch",
    "gradient_clip_val", "precision", "logger", "callbacks",
    "accumulate_grad_batches", "ema_decay", "log_every_n_steps",
}
_KNOWN_CALLBACKS = {
    # name -> consumed params (everything else warns)
    "ModelCheckpoint": {"monitor", "mode", "save_last"},
    "LearningRateMonitor": {"logging_interval"},  # lr is always logged
    "LogImageCallback": {"n_epochs", "random"},   # diagnostics each val
    "EarlyStopping": {"monitor", "mode", "patience"},
}
_DATALOADER_KEYS = {"batch_size", "num_workers", "shuffle", "drop_last",
                    "max_boxes", "pin_memory"}
# per-dataset constructor keys (kept in sync with the classes by
# tests/test_config_audit.py::test_dataset_key_table_matches_signatures)
_DATASET_KEYS = {
    # coco's Gen-A data_dir/split are mapped to img_dir/ann_json by the
    # normalizer before this table applies
    "coco": {"img_dir", "ann_json"},
    "voc": {"data_dir", "split", "name_to_label", "class_names"},
    "crowdhuman": {"data_dir", "split", "img_dir"},
    "mot-tracking": {"data_dir", "sequence_names"},
    "kitti-tracking": {"data_dir", "split", "sequence_names"},
    "packed": {"data_dir", "pack_dir", "flip_p", "shard_id", "num_shards"},
}


def _map_loss_name(name, table, kind):
    """Gen-A loss name -> Gen-B class name. Already-normalized Gen-B names
    pass through; anything unknown is a hard error — a typo silently
    falling back to the default loss trains the wrong objective."""
    if name in table:
        return table[name]
    if name in table.values():
        return name
    raise KeyError(
        f"unknown {kind} loss {name!r}; expected one of "
        f"{sorted(table) + sorted(table.values())}")


def _is_gen_a(model_cfg: Dict) -> bool:
    return "output_heads" in model_cfg or "task" in model_cfg


def _leaf_paths(tree, prefix=()) -> List[Tuple]:
    """Every leaf key path in a nested dict/list config tree."""
    if isinstance(tree, dict):
        if not tree:
            return [prefix]
        out = []
        for k, v in tree.items():
            out.extend(_leaf_paths(v, prefix + (k,)))
        return out
    if isinstance(tree, list):
        if not tree:
            return [prefix]
        out = []
        for i, v in enumerate(tree):
            out.extend(_leaf_paths(v, prefix + (i,)))
        return out
    return [prefix]


class _Reader:
    """Tracked reads over the raw Gen-A tree: anything not read (leaf-wise
    or via a consumed subtree prefix) is reported as unknown."""

    def __init__(self, root: Dict):
        self.root = root
        self._consumed: set = set()

    def _lookup(self, path):
        node = self.root
        for p in path:
            if isinstance(node, dict):
                if p not in node:
                    return None, False
                node = node[p]
            elif isinstance(node, list) and isinstance(p, int) and p < len(node):
                node = node[p]
            else:
                return None, False
        return node, True

    def get(self, *path, default=None):
        """Read one key (leaf or subtree) and mark it consumed — also when
        absent, so an empty parent dict ({} leaf) whose children we looked
        for counts as covered."""
        self._consumed.add(path)
        val, found = self._lookup(path)
        if not found:
            return default
        return copy.deepcopy(val)

    def peek(self, *path, default=None):
        val, found = self._lookup(path)
        return copy.deepcopy(val) if found else default

    def mark(self, *path):
        """Mark a key/subtree consumed without reading it."""
        self._consumed.add(path)

    def has(self, *path) -> bool:
        return self._lookup(path)[1]

    def unknown_paths(self) -> List[Tuple]:
        out = []
        for leaf in _leaf_paths(self.root):
            covered = any(leaf[:n] in self._consumed
                          for n in range(1, len(leaf) + 1))
            # an empty-container leaf counts as covered when we looked for
            # keys underneath it (e.g. `box_2d: {}` with per-key gets)
            covered = covered or any(c[:len(leaf)] == leaf
                                     for c in self._consumed)
            if not covered:
                out.append(leaf)
        return sorted(out, key=str)


def _fmt_path(path) -> str:
    return ".".join(str(p) for p in path)


def normalize_config(config: Dict[str, Any], strict: bool = False,
                     ) -> Dict[str, Any]:
    """Return a Gen-B-shaped config {model, data?, trainer?, tracker?}.

    strict=True raises UnknownKeyError on any Gen-A key the normalizer
    doesn't consume; the default warns (so every silent drop is at least
    visible on stdout). Gen-B configs pass through unchanged — their keys
    are validated against the task dataclass by the train CLI.
    """
    config = copy.deepcopy(config)
    model = config.get("model", {})
    if not _is_gen_a(model):
        return config

    r = _Reader(config)
    out: Dict[str, Any] = {}

    task = r.get("model", "task", default="detection")
    if task not in ("detection", "tracking"):
        raise ValueError(f"unknown model.task {task!r}")

    # ---- backbone -------------------------------------------------------
    new_model: Dict[str, Any] = {
        "backbone": r.get("model", "backbone", "name", default="resnet34"),
        "pretrained_backbone": r.get("model", "backbone", "pretrained",
                                     default=False),
    }
    frozen_stages = r.get("model", "backbone", "frozen_stages", default=0)
    if frozen_stages:
        # forward-side freeze (backbones honor it: BN on running stats +
        # stop_gradient) — the trainer mirrors it into the optimizer mask
        new_model["backbone_config"] = {"frozen_stages": int(frozen_stages)}
    input_channels = r.get("model", "backbone", "input_channels", default=3)
    if input_channels != 3:
        new_model["input_channels"] = int(input_channels)

    # ---- neck -----------------------------------------------------------
    neck = r.peek("model", "neck", default={}) or {}
    neck_name = {"simple": "SimpleNeck", "fpn": "FPN", "bifpn": "BiFPN",
                 "ida": "IDA"}.get(str(neck.get("name", "simple")).lower(),
                                   neck.get("name", "SimpleNeck"))
    r.mark("model", "neck", "name")
    # Gen-A writes neck options either inline or under `params`
    # (reference configs/test_config.yaml:9-18 nests them)
    if "params" in neck:
        neck_config = dict(neck["params"])
        r.mark("model", "neck", "params")
    else:
        neck_config = {k: v for k, v in neck.items() if k != "name"}
        for k in neck_config:
            r.mark("model", "neck", k)
    if "weighted_fusion" in neck_config:
        # Gen-A name (reference configs/base_resnet34_fpn.yaml:12)
        neck_config["weighted"] = bool(neck_config.pop("weighted_fusion"))

    new_model["neck"] = neck_name
    new_model["neck_config"] = neck_config or None

    # ---- heads ----------------------------------------------------------
    hm_bias = r.get("model", "output_heads", "heatmap", "init_bias")
    new_model.update({
        "num_classes": r.get("model", "output_heads", "heatmap",
                             "num_classes", default=80),
        "heatmap_loss": _map_loss_name(
            r.get("model", "output_heads", "heatmap", "loss_function",
                  default="cornernet_focal"),
            _GEN_A_HEATMAP_LOSSES, "heatmap"),
        "heatmap_loss_weight": r.get("model", "output_heads", "heatmap",
                                     "loss_weight", default=1.0),
        "heatmap_target": r.get("model", "output_heads", "heatmap",
                                "target_method", default="cornernet"),
        "box_loss": _map_loss_name(
            r.get("model", "output_heads", "box_2d", "loss_function",
                  default="l1"),
            _GEN_A_BOX_LOSSES, "box"),
        "box_loss_weight": r.get("model", "output_heads", "box_2d",
                                 "loss_weight", default=0.1),
        "box_init_bias": r.get("model", "output_heads", "box_2d",
                               "init_bias"),
    })
    if hm_bias is not None:
        # the heatmap head's Gen-A init_bias (reference meta.py:21-30 fills
        # the out-conv bias with it; every Gen-A config sets -2.19) maps to
        # our prior parameterization exactly: bias = log(p / (1-p))
        new_model["heatmap_prior"] = 1.0 / (1.0 + math.exp(-float(hm_bias)))

    ckpt = r.get("model", "load_from_checkpoint")
    if ckpt:
        # Gen-A finetune key (reference configs/mot_tracking.yaml:3)
        new_model["load_from_checkpoint"] = ckpt

    reid = r.peek("model", "output_heads", "reid")
    if reid is not None:
        reid = reid or {}
        reid_loss = str(r.get("model", "output_heads", "reid",
                              "loss_function", default="ce")).lower()
        if reid_loss not in _GEN_A_REID_LOSSES:
            raise KeyError(f"unknown reid loss {reid_loss!r}; expected one "
                           f"of {sorted(_GEN_A_REID_LOSSES)}")
        new_model["reid_config"] = {
            "emb_dim": r.get("model", "output_heads", "reid", "emb_dim",
                             default=64),
            "max_track_ids": r.get("model", "output_heads", "reid",
                                   "max_track_ids", default=1000),
            "width": r.get("model", "output_heads", "reid", "width",
                           default=256),
            "depth": r.get("model", "output_heads", "reid", "depth",
                           default=1),
            "init_bias": r.get("model", "output_heads", "reid", "init_bias"),
            "loss_function": "triplet" if reid_loss == "triplet" else "ce",
        }
        new_model["reid_loss_weight"] = r.get(
            "model", "output_heads", "reid", "loss_weight", default=1.0)

    # ---- optimizer + schedule -------------------------------------------
    opt = r.peek("model", "optimizer")
    if opt:
        params = r.get("model", "optimizer", "params", default={}) or {}
        known = OPTIMIZER_KEYS
        for k in set(params) - known:
            _unknown_key(("model", "optimizer", "params", k),
                         f"make_optimizer does not accept it "
                         f"(known: {sorted(known)})", strict)
            params.pop(k)
        new_model["optimizer_config"] = {
            "optimizer": r.get("model", "optimizer", "name", default="SGD"),
            **params,
        }
    sched = r.peek("model", "lr_scheduler")
    if sched:
        # Gen-A scheduler block ({name: OneCycleLR, params: {max_lr}} —
        # reference configs/base_resnet34.yaml:33-36); resolved by
        # train/optim.py resolve_schedules (which validates the params)
        r.mark("model", "lr_scheduler")
        new_model.setdefault("optimizer_config", {})["lr_scheduler"] = sched

    out["model"] = new_model

    # ---- data -----------------------------------------------------------
    if r.has("data"):
        new_model["train_data"] = _convert_split(r, "train", strict)
        new_model["val_data"] = _convert_split(r, "validation", strict)

    # ---- trainer --------------------------------------------------------
    trainer = r.peek("trainer")
    if trainer is not None:
        for k in trainer:
            if k in _KNOWN_TRAINER_KEYS or ("trainer", k) in _IGNORED_KEYS:
                r.mark("trainer", k)
            else:
                _unknown_key(("trainer", k), "not a supported trainer key",
                             strict)
                r.mark("trainer", k)
        for i, cb in enumerate(trainer.get("callbacks") or []):
            if not isinstance(cb, dict):
                # plain-string YAML list form (callbacks: [ModelCheckpoint])
                cb = {"name": cb}
            name = cb.get("name") or cb.get("class_path") or ""
            known = _KNOWN_CALLBACKS.get(str(name).split(".")[-1])
            if known is None:
                _unknown_key(("trainer", "callbacks", i, "name"),
                             f"unknown callback {name!r} (known: "
                             f"{sorted(_KNOWN_CALLBACKS)})", strict)
                continue
            for p in (cb.get("params") or cb.get("init_args") or {}):
                if p not in known:
                    _unknown_key(("trainer", "callbacks", i, "params", p),
                                 f"{name} does not consume it "
                                 f"(known: {sorted(known)})", strict)
        out["trainer"] = trainer
    if r.has("tracker"):
        out["tracker"] = r.get("tracker")

    # ---- audit ----------------------------------------------------------
    for path in r.unknown_paths():
        _unknown_key(path, "no mapping in normalize_config", strict)
    return out


def _convert_split(r: _Reader, split: str, strict: bool) -> Dict[str, Any]:
    ds = r.peek("data", split, "dataset", default={}) or {}
    dl = r.peek("data", split, "dataloader", default={}) or {}
    # audit the split's DIRECT children too: a key misplaced at
    # data.<split> level (e.g. batch_size outside the dataloader block)
    # must not escape the silent-drop audit just because the subtree as a
    # whole is consumed
    for k in (r.peek("data", split, default={}) or {}):
        if k not in ("dataset", "dataloader"):
            _unknown_key(("data", split, k),
                         "only 'dataset' and 'dataloader' blocks live here "
                         "(did you mean data.{}.dataloader.{}?)".format(
                             split, k), strict)
    r.mark("data", split)
    ds_type = ds.pop("type", "coco")
    entry: Dict[str, Any] = {"type": ds_type}

    transforms = ds.pop("transforms", None)
    if transforms is not None:
        # both Gen-A spellings pass through: [{name, params}] and the
        # mapping form {Name: params} (reference configs/test_config.yaml
        # uses the latter); names are validated here so a typo'd transform
        # can't silently vanish
        _validate_transform_names(
            transforms, ("data", split, "dataset", "transforms"), strict)
        entry["transforms"] = transforms
    if ds.pop("detection_for_tracking", False):
        entry["detection_for_tracking"] = True

    if ds_type == "coco" and "data_dir" in ds and "img_dir" not in ds:
        # the documented Gen-A COCO layout (reference docs/datasets.md:65-78):
        # data_dir/images/{split} + data_dir/annotations/instances_{split}.json
        data_dir = ds.pop("data_dir")
        coco_split = ds.pop("split", "val2017")
        entry["img_dir"] = os.path.join(data_dir, "images", coco_split)
        entry["ann_json"] = os.path.join(
            data_dir, "annotations", f"instances_{coco_split}.json")

    known = _DATASET_KEYS.get(ds_type, set())
    for k, v in ds.items():
        if k not in known:
            _unknown_key(("data", split, "dataset", k),
                         f"dataset type {ds_type!r} does not accept it "
                         f"(known: {sorted(known)})", strict)
            continue
        entry[k] = v

    for k, v in dl.items():
        if k not in _DATALOADER_KEYS:
            _unknown_key(("data", split, "dataloader", k),
                         f"not a dataloader key (known: "
                         f"{sorted(_DATALOADER_KEYS)})", strict)
            continue
        if k in _IGNORED_DATALOADER_KEYS:
            continue
        entry[k] = v
    return entry


def _validate_transform_names(transforms, path, strict: bool):
    known = TRANSFORM_NAMES
    if isinstance(transforms, dict):
        names = [(k, path + (k,)) for k in transforms]
    else:
        names = []
        for i, item in enumerate(transforms):
            if not isinstance(item, dict) or "name" not in item:
                # e.g. the reference's broken `- name:Resize:` entry
                # (configs/base_tracking_resnet34_fpn.yaml:93) parses to
                # {'name:Resize': {...}} — surface it instead of guessing
                key = next(iter(item), item) if isinstance(item, dict) else item
                _unknown_key(path + (i,),
                             f"transform entry {key!r} has no 'name' (use "
                             f"{{name: X, params: {{...}}}} or the mapping "
                             f"form {{X: {{...}}}})", strict)
                continue
            names.append((item["name"], path + (i, "name")))
    for name, p in names:
        if name not in known:
            _unknown_key(p, f"unknown transform {name!r} (known: "
                            f"{sorted(known)})", strict)


def _unknown_key(path, why: str, strict: bool):
    msg = (f"config key '{_fmt_path(path)}' is not consumed: {why}. "
           f"It would silently do nothing.")
    if strict:
        raise UnknownKeyError(msg)
    warnings.warn(msg, stacklevel=3)
