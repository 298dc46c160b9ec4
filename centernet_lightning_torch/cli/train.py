"""Train CLI (port of the root train.py):

    python -m centernet_lightning_torch.cli.train \
        --config configs/centernet.yaml --workdir runs/coco

Accepts the Gen-A and Gen-B config shapes (train/config.py normalizes
them). The `trainer:` section's Lightning keys map onto the Trainer where
it has them (max_epochs, check_val_every_n_epoch, val_check_interval,
log_every_n_steps, precision, gradient_clip_val, accumulate_grad_batches,
ema_decay, the ModelCheckpoint monitor, the logger). The run directory gets
the resolved `config.yaml`, `checkpoints/` (with `best/`) and `logs/`
(`metrics.jsonl`). One process on one device (`--device`, the card unless
`--device cpu`). A card's machine without OpenCV trains from packs
(`type: packed`, made by `cli/pack_dataset.py`).

`--multihost` trains data-parallel, one process a device, in the process
group that torchrun's environment describes (NCCL on `cuda:LOCAL_RANK`,
gloo with `--device cpu`); each process trains on its shard of the data,
and only rank 0 writes the run directory and prints:

    torchrun --nproc_per_node 8 -m centernet_lightning_torch.cli.train \
        --multihost --config configs/centernet.yaml --workdir runs/coco
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch.distributed

from ..data.builder import loader_from_config
from ..models.centernet import CenterNet
from ..models.fairmot import FairMOT
from ..parallel import dist
from ..train.config import load_config, normalize_config
from ..train.trainer import Trainer

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Train CenterNet/FairMOT (PyTorch port)")
    parser.add_argument("--config", required=True, help="YAML config path")
    parser.add_argument("--workdir", default="runs/default",
                        help="checkpoints + logs")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of the first epoch "
                             "under <workdir>/checkpoints/profile")
    parser.add_argument("--no-resume", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda; cpu "
                             "runs the plain PyTorch versions of the kernels)")
    parser.add_argument("--multihost", action="store_true",
                        help="data-parallel over the processes torchrun "
                             "starts (RANK, WORLD_SIZE, LOCAL_RANK, "
                             "MASTER_ADDR, MASTER_PORT): NCCL on "
                             "cuda:LOCAL_RANK, gloo with --device cpu")
    args = parser.parse_args(argv)

    own_group = args.multihost and not torch.distributed.is_initialized()
    device = (dist.init_from_env(args.device) if args.multihost
              else args.device)
    try:
        return _train(args, device)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _train(args, device) -> int:
    config = normalize_config(load_config(args.config))
    if dist.process_index() == 0:
        _save_resolved_config(config, args.workdir)
    model_cfg = dict(config["model"])
    trainer_cfg = dict(config.get("trainer", {}))

    train_data = model_cfg.pop("train_data", None) or {}
    val_data = model_cfg.pop("val_data", None) or {}
    is_tracking = model_cfg.get("reid_config") is not None
    task_cls = FairMOT if is_tracking else CenterNet
    task_kwargs = {k: v for k, v in model_cfg.items()
                   if k in task_cls.__dataclass_fields__}
    # consumed by the Trainer below, not the task dataclass
    trainer_model_keys = {"load_from_checkpoint", "finetune_from"}
    for k in model_cfg:
        if (k not in task_cls.__dataclass_fields__
                and k not in trainer_model_keys and dist.process_index() == 0):
            print(f"WARNING: model config key '{k}' is not a "
                  f"{task_cls.__name__} hparam and is ignored")
    task_kwargs["train_data"] = train_data
    task_kwargs["val_data"] = val_data
    task = task_cls(**task_kwargs)

    def make_loader(data_cfg, train):
        if not data_cfg or "type" not in data_cfg and "img_dir" not in data_cfg:
            return None
        return loader_from_config(data_cfg, train=train)

    train_loader = make_loader(train_data, train=True)
    val_loader = make_loader(val_data, train=False)

    image_size = tuple(model_cfg.get("image_size", (512, 512)))
    max_epochs = (args.max_epochs or trainer_cfg.get("max_epochs", 100))

    monitor = "val/HOTA" if is_tracking else "val/mAP"
    for cb in trainer_cfg.get("callbacks", []) or []:
        init = cb.get("init_args") or cb.get("params") or {}
        if "monitor" in init:
            monitor = init["monitor"]

    opt_cfg = dict(model_cfg.get("optimizer_config") or {})
    if trainer_cfg.get("gradient_clip_val"):
        opt_cfg.setdefault("gradient_clip_val", trainer_cfg["gradient_clip_val"])

    trainer = Trainer(
        task,
        train_loader=train_loader,
        val_loader=val_loader,
        max_epochs=max_epochs,
        optimizer_config=opt_cfg,
        ckpt_dir=os.path.join(args.workdir, "checkpoints"),
        log_dir=os.path.join(args.workdir, "logs"),
        monitor=monitor,
        val_interval=_val_interval(trainer_cfg),
        val_check_interval=trainer_cfg.get("val_check_interval"),
        log_every=int(trainer_cfg.get("log_every_n_steps", 50)),
        image_size=image_size,
        resume=not args.no_resume,
        profile=args.profile,
        tracker_config=config.get("tracker", {}),
        precision=trainer_cfg.get("precision"),
        accumulate_grad_batches=int(
            trainer_cfg.get("accumulate_grad_batches", 1)),
        ema_decay=float(trainer_cfg.get("ema_decay", 0.0)),
        finetune_from=(model_cfg.get("load_from_checkpoint")
                       or model_cfg.get("finetune_from")),
        logger_config=_parse_logger_config(trainer_cfg.get("logger")),
        device=device,
    )
    trainer.fit()
    return 0


def _save_resolved_config(config, workdir: str) -> None:
    """Write the fully resolved config (after `__base__` inheritance and
    the Gen-A/Gen-B normalization) to `workdir/config.yaml`, so a run is
    reproducible from its directory alone."""
    import yaml

    def plain(x):  # yaml-safe: tuples -> lists, numpy scalars -> python
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x.item() if hasattr(x, "item") else x

    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.yaml"), "w") as f:
        yaml.safe_dump(plain(config), f, sort_keys=False,
                       default_flow_style=False)


def _val_interval(trainer_cfg) -> int:
    """check_val_every_n_epoch -> the epochs that validate. The Lightning
    val_check_interval (a fraction of an epoch or a batch count) goes to
    the Trainer separately and sets the cadence within those epochs."""
    if "check_val_every_n_epoch" in trainer_cfg:
        return int(trainer_cfg["check_val_every_n_epoch"])
    return 1


def _parse_logger_config(logger_cfg):
    """The Lightning logger selection -> MetricLogger's backend config
    (backends unioned). Accepts a string, a {class_path|name,
    init_args|params} dict, or a list of those."""
    if not logger_cfg:
        return None
    entries = logger_cfg if isinstance(logger_cfg, list) else [logger_cfg]
    backends, project, run_name = [], None, None
    for entry in entries:
        if isinstance(entry, str):
            name, init = entry, {}
        else:
            name = str(entry.get("class_path")
                       or entry.get("name") or "tensorboard")
            init = entry.get("init_args") or entry.get("params") or {}
        backend = "wandb" if "wandb" in name.lower() else "tensorboard"
        if backend not in backends:
            backends.append(backend)
        project = project or init.get("project")
        run_name = run_name or init.get("name")
    return {"backends": backends, "project": project, "run_name": run_name}


if __name__ == "__main__":
    raise SystemExit(main())
