"""Pack a dataset into a memory-mapped cache (port of
tools/pack_dataset.py; the pack format is the JAX package's).

Runs a data config's pipeline (decode -> transforms -> padded collate)
once and writes the collated arrays to `--out` as .npy files
(data/packed.py). Training then uses `type: packed` in the data config:

    # 1. pack the train split (2 augmented copies, flips left online)
    python -m centernet_lightning_torch.cli.pack_dataset \
        --config configs/centernet.yaml --split train \
        --out /data/coco_packed --copies 2

    # 2. point the config's train_data at the pack
    train_data:
      type: packed
      data_dir: /data/coco_packed
      batch_size: 64
      flip_p: 0.5

Keep `Normalize` out of the packed transforms: images then stay uint8 (4x
smaller, normalized on the device by the train step) and `flip_p` flips
stay exact. Packing reads images, so it needs OpenCV; training from the
pack does not.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Pack a dataset cache")
    parser.add_argument("--config", default=None,
                        help="training YAML; packs its train_data/val_data")
    parser.add_argument("--split", default="train", choices=["train", "val"],
                        help="which data section of --config to pack")
    parser.add_argument("--data", default=None,
                        help="inline JSON data config (instead of --config)")
    parser.add_argument("--out", required=True, help="pack output directory")
    parser.add_argument("--copies", type=int, default=1,
                        help="independently-augmented passes to pack")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    if (args.config is None) == (args.data is None):
        raise SystemExit("pass exactly one of --config / --data")

    if args.data:
        data_cfg = json.loads(args.data)
    else:
        from ..train.config import load_config, normalize_config

        config = normalize_config(load_config(args.config))
        key = "train_data" if args.split == "train" else "val_data"
        data_cfg = config["model"].get(key)
        if not data_cfg:
            raise SystemExit(f"{args.config} has no model.{key} section")

    from ..data.packed import pack_dataset

    meta = pack_dataset(data_cfg, args.out, train=(args.split == "train"),
                        copies=args.copies, seed=args.seed, progress=True)
    size = sum(os.path.getsize(os.path.join(args.out, f"{k}.npy"))
               for k in meta["keys"])
    print(json.dumps({"n": meta["n"], "keys": meta["keys"],
                      "bytes": size, "out": args.out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
