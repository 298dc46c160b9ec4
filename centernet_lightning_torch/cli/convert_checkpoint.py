"""Convert a reference (PyTorch Lightning) checkpoint into a port
checkpoint directory (port of tools/convert_checkpoint.py): the model's
weights through `CenterNet.load_torch_checkpoint`, saved in the
`train/checkpoint.py` format with `hparams.json`, so that
`build_centernet(output)`, `cli.detect`, `cli.serve` and `cli.export`
load it as it is.

    python -m centernet_lightning_torch.cli.convert_checkpoint \
        --config configs/centernet.yaml --torch-ckpt resnet34_bifpn.ckpt \
        --output ckpts/resnet34_bifpn

A model with deformable convolutions has its learned offsets audited
first (utils/dcn_audit.py; `--calibration-images` gives it real images,
random ones otherwise), which reports the smallest `dcn_fast` clamp that
keeps this checkpoint exact.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Convert a Lightning checkpoint to a port checkpoint dir")
    parser.add_argument("--config", required=True, help="model yaml")
    parser.add_argument("--torch-ckpt", required=True,
                        help="Lightning .ckpt / torch .pth state dict")
    parser.add_argument("--output", required=True, help="checkpoint dir")
    parser.add_argument("--calibration-images", default=None,
                        help="image dir for the DCN offset audit (models with "
                             "conv_type dcn*); random inputs when omitted")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from ..api import _extract_norm
    from ..models.centernet import CenterNet
    from ..ops.preprocess import preprocess
    from ..train.checkpoint import save_checkpoint
    from ..train.config import load_config, normalize_config
    from ..utils.dcn_audit import (audit_dcn_offsets, dcn_engine_displacement,
                                   format_dcn_audit, model_uses_dcn)

    config = normalize_config(load_config(args.config))
    model_cfg = dict(config.get("model", config))
    task = CenterNet(**{k: v for k, v in model_cfg.items()
                        if k in CenterNet.__dataclass_fields__})
    task.load_torch_checkpoint(args.torch_ckpt)      # strict: every tensor
    task.model.eval()
    if model_uses_dcn(task):
        h, w = task.image_size
        if args.calibration_images:
            from ..data.inference import InferenceDataset

            ds = InferenceDataset(args.calibration_images, resize=(h, w))
            imgs = np.stack([ds[i]["image"] for i in range(min(4, len(ds)))])
        else:
            print("DCN audit on RANDOM inputs (pass --calibration-images "
                  "for representative offset statistics)")
            imgs = np.random.default_rng(0).integers(0, 256, (2, h, w, 3),
                                                     dtype=np.uint8)
        mean, std = _extract_norm(model_cfg.get("val_data"))
        x = preprocess(torch.from_numpy(imgs), mean=mean, std=std)
        stats = audit_dcn_offsets(task, x)
        print(format_dcn_audit(stats, dcn_engine_displacement(task)))
    path = save_checkpoint(args.output,
                           {"model": task.model.state_dict(), "step": 0},
                           hparams=task.hparams, step=0)
    n_params = sum(p.numel() for p in task.model.parameters())
    print(f"converted {args.torch_ckpt} -> {path} ({n_params / 1e6:.1f}M params)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
