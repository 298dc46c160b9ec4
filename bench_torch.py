#!/usr/bin/env python3
"""Serving benchmark of the PyTorch port on one CUDA card: images/s of
forward + decode at 512x512, b64 bf16, channels_last, the images already
on the card (what `bench.py` measures for the JAX package on a TPU).

    python3 bench_torch.py                       # ResNet-34 FPN-256
    python3 bench_torch.py --config vovnet39     # or dla34_ida, efficientnet_b0

Prints ONE JSON line {"metric", "value", "unit", "extras"}; `extras` has
the decode's ms a batch (the peak kernel, top-k and box gather on the
model's own heatmap), the dtype, channels_last, the peak kernel's
launches in the timed calls, and the card's name. Weights are random from
a seed, with BatchNorm statistics from one train-mode pass over the batch
(as training sets them; chip_smoke.py's `calibrate_bn`). Times are CUDA
events over `--iters` calls after a warm-up, the median of `--reps` rounds
(chip_smoke.py's `repeated_ms`). Runs on the card only: without one it
exits non-zero and prints no result.
"""
import argparse
import json
import sys

import torch

# bench_suite.py's serving configs (its own copy: bench_suite imports jax)
CONFIGS = {
    "flagship": ("resnet34-fpn256", {
        "backbone": "resnet34", "neck": "FPN",
        "neck_config": {"out_channels": 256},
        "head_config": {"width": 256, "depth": 3}}),
    "vovnet39": ("vovnet39-fpn256", {
        "backbone": "vovnet39", "neck": "FPN",
        "neck_config": {"out_channels": 256},
        "head_config": {"width": 256, "depth": 3}}),
    "dla34_ida": ("dla34-ida256", {
        "backbone": "dla34", "neck": "IDA",
        "neck_config": {"out_channels": 256},
        "head_config": {"width": 256, "depth": 2}}),
    "efficientnet_b0": ("efficientnet_b0-sepfpn96", {
        "backbone": "efficientnet_b0", "neck": "FPN",
        "neck_config": {"out_channels": 96, "conv_type": "separable"},
        "head_config": {"width": 96, "depth": 2}}),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=sorted(CONFIGS), default="flagship")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device", file=sys.stderr)
        return 2

    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.ops import peak_decode
    from chip_smoke import calibrate_bn, repeated_ms

    def median_ms(fn):
        return repeated_ms({"fn": fn}, args.reps, args.iters)["fn"]["median_ms"]

    label, model_cfg = CONFIGS[args.config]
    cfg = {"model": dict(model_cfg, num_classes=80, num_detections=100,
                         image_size=[args.size, args.size],
                         compute_dtype="bfloat16")}
    pred = build_centernet(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (args.batch, args.size, args.size, 3),
                           generator=gen, device="cuda", dtype=torch.uint8)
    calibrate_bn(pred, images)

    peak = peak_decode.peak_class_scores_cuda
    peak.launches = 0
    batch_ms = median_ms(lambda: pred.detect(images))
    calls = 1 + (1 + args.iters) * args.reps
    launches = peak.launches
    with torch.inference_mode():
        out = pred.model(pred.prepare_images(images))
        heat, box = out["heatmap"], out["box_2d"]
        decode_ms = median_ms(lambda: pred.task.decode_detections(
            heat, box, from_logits=True))
    print(json.dumps({
        "metric": f"images_per_sec_per_chip {label}@{args.size}x{args.size} "
                  f"fwd+decode",
        "value": round(args.batch / batch_ms * 1e3, 2),
        "unit": "images/sec",
        "extras": {
            "config": args.config,
            "batch_size": args.batch,
            "dtype": "bfloat16",
            "channels_last": all(
                m.weight.is_contiguous(memory_format=torch.channels_last)
                for m in pred.model.modules() if isinstance(m, torch.nn.Conv2d)),
            "decode_ms_batch": round(decode_ms, 4),
            "sec_per_batch": round(batch_ms / 1e3, 6),
            "peak_launches": launches,
            "peak_launches_per_call": launches / calls,
            "platform": "gpu",
            "device": torch.cuda.get_device_name(0),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
