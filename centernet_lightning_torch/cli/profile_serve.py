"""Serving-program profile (port of tools/profile_serve.py): the flagship
serving program's throughput by slope timing, and its time by op
category from a torch.profiler trace.

    python -m centernet_lightning_torch.cli.profile_serve [--quantize] \
        [--batch-size 64] [--trace DIR] [--top 12] [--device cuda]

The program is `predictor.detect` on uint8 images already on the device:
preprocess, ResNet-34 FPN-256 (heads 256 x 3, 80 classes) at 512², the
decode through the peak kernel; bf16, or int8 with `--quantize`
(calibrated on seeded batches). Weights are drawn from a seed.

Throughput: (t(n2) - t(n1)) / (n2 - n1) over n1 and n2 calls, each run
ending in a synchronise. Categories, as the JAX tool's: convolutions (the
cuDNN / CUTLASS kernels, and in int8 `torch._int_mm` with its im2col),
the peak kernel, quantize and dequant (int8's elementwise stages, told
apart by quantize.py's profiler ranges they run in), and everything
else. On the card the
categories are CUDA kernel time; with `--device cpu` they are the host's
op time (there is no device), and the JSON says which. The card's name
and power limit are printed with the result. `--trace` shows the
predictor's spans `api.prepare`, `api.forward` and `api.decode`
(utils/spans.py).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["FLAGSHIP", "slope_seconds", "card_label", "categorize",
           "profile_categories", "main"]

FLAGSHIP = {"num_classes": 80, "backbone": "resnet34", "neck": "FPN",
            "neck_config": {"out_channels": 256},
            "head_config": {"width": 256, "depth": 3}, "num_detections": 100}
_CONV = ("conv", "cudnn", "xmma", "implicit_gemm", "gemm", "cutlass",
         "winograd", "fprop", "_int_mm")
# quantize.py's int8 conv stages (its profiler ranges) by category
_STAGE_CATEGORY = {"int8_conv.quantize": "quantize_dequant",
                   "int8_conv.dequant": "quantize_dequant",
                   "int8_conv.im2col": "conv", "int8_conv.int_mm": "conv"}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def slope_seconds(fn: Callable[[], object], device: torch.device,
                  n1: int, n2: int) -> float:
    """Seconds a call: the time of n2 calls less that of n1, over n2 - n1
    (what a call costs once the pipeline is full)."""
    def run(n):
        sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync(device)
        return time.perf_counter() - t0
    run(1)
    return (run(n2) - run(n1)) / (n2 - n1)


def card_label(device: torch.device) -> Dict[str, object]:
    """The device's name and, on the card, `nvidia-smi`'s name and power
    limit (the card may run below 700 W)."""
    if device.type != "cuda":
        return {"device": "cpu"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as err:
        smi = [f"nvidia-smi failed: {err}"]
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"device": torch.cuda.get_device_name(index),
            "nvidia_smi": smi[index] if index < len(smi) else smi}


def categorize(key: str) -> str:
    k = key.lower()
    if "peak_rows_kernel" in k or "peak_class_scores" in k:
        return "peak_kernel"
    if any(p in k for p in _CONV):
        return "conv"
    return "other"


def _stage(event) -> Optional[str]:
    """The int8 conv stage (quantize.py's profiler range) an op ran in."""
    while event is not None:
        if event.name.startswith("int8_conv."):
            return event.name
        event = event.cpu_parent
    return None


def profile_categories(fn: Callable[[], object], device: torch.device,
                       top: int = 12) -> Dict[str, object]:
    """ms a call by category over three calls under torch.profiler: on
    the card the CUDA kernels' time, on the CPU each op's own time. A
    kernel (or op) that ran inside one of quantize.py's int8 stage ranges
    counts to that stage's category (its kernels are elementwise, told
    apart from the rest only by the range), found through the op that
    launched it; the rest by its name. Raises if the stages claim more
    of a kernel's (or op's) time than it took."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    fn()
    sync(device)
    iters = 3
    with profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        sync(device)
    scale = 1.0 / iters / 1e3                      # us over the run -> ms a call
    rows: Dict[str, float] = defaultdict(float)    # name -> ms
    staged: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            continue          # device events: through the ops that launched them
        items = ([(k.name, k.duration) for k in e.kernels] if cuda
                 else [(e.name, e.self_cpu_time_total)])
        stage = _stage(e)
        for name, us in items:
            if not cuda:
                rows[name] += us * scale
            if stage is not None:
                staged[name][stage] += us * scale
    if cuda:  # every kernel of the trace, whichever op (if any) launched it
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                rows[e.key] += e.self_device_time_total * scale
    cats: Dict[str, float] = defaultdict(float)
    stages: Dict[str, float] = defaultdict(float)
    for name, ms in rows.items():
        claimed = sum(staged[name].values())
        if claimed > ms * (1 + 1e-6):
            raise RuntimeError(f"the int8 stages claim {claimed} ms a call of "
                               f"{name!r}, which took {ms} ms")
        for stage, v in staged[name].items():
            cats[_STAGE_CATEGORY[stage]] += v
            stages[stage] += v
        cats[categorize(name)] += max(ms - claimed, 0.0)
    total = sum(rows.values())
    out = {k: cats.get(k, 0.0) for k in ("conv", "peak_kernel",
                                         "quantize_dequant", "other")}
    return {"time_of": ("device: CUDA kernels" if cuda
                        else "host: CPU ops (no device)"),
            "ms_per_call": total, "categories_ms": out,
            "categories_pct": {k: (100.0 * v / total if total else 0.0)
                               for k, v in out.items()},
            "int8_stage_ms": dict(stages),
            "top": [{"name": k[:120], "ms": v} for k, v in
                    sorted(rows.items(), key=lambda kv: -kv[1])[:top]]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quantize", action="store_true",
                        help="profile the int8 program")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="default 64 on the card, 2 on the CPU")
    parser.add_argument("--size", type=int, default=512, help="image side")
    parser.add_argument("--trace", default=None,
                        help="write a Chrome trace of three calls here")
    parser.add_argument("--top", type=int, default=12)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..api import build_centernet

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here; pass --device cpu")
    batch = args.batch_size or (64 if cuda else 2)
    cfg = dict(FLAGSHIP, compute_dtype="bfloat16" if cuda else None)
    pred = build_centernet({"model": cfg}, seed=0, device=device)
    gen = np.random.default_rng(0)
    draw = lambda: gen.integers(0, 256, (batch, args.size, args.size, 3),  # noqa: E731
                                dtype=np.uint8)
    if args.quantize:
        pred = pred.quantize([draw() for _ in range(2)])
    images = torch.from_numpy(draw()).to(device)

    def call():
        return pred.detect(images)

    n1, n2 = (2, 12) if cuda else (1, 2)
    sec = slope_seconds(call, device, n1, n2)
    result = {
        "metric": "serving_profile resnet34-fpn256 fwd+decode"
                  + (" int8" if args.quantize else
                     " bf16" if cuda else " f32"),
        "batch_size": batch, "image_size": args.size,
        **card_label(device),
        "images_per_sec": batch / sec, "ms_per_batch": sec * 1e3,
        **profile_categories(call, device, top=args.top),
    }
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.trace, exist_ok=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            for _ in range(3):
                call()
            sync(device)
        path = os.path.join(args.trace, "serve_trace.json")
        prof.export_chrome_trace(path)
        result["trace"] = path
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
