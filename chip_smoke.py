#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100 class, sm_90a).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from csrc/ with nvcc, then runs five
phases, each printing one JSON line; any failure exits non-zero:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, the kernels' build time;
  2. kernel vs plain: `peak_class_scores_cuda` against its plain PyTorch
     twin on the card, bf16 and f32, probabilities and logits, at the
     flagship (64, 128, 128, 80) map and an odd (3, 37, 53, 7) one, plus
     forced ties (constant map, equal classes, equal edge neighbours).
     Scores must be bitwise equal and labels exactly equal;
  3. main path: `build_centernet` (ResNet-34, FPN-256, heads 256 x 3,
     80 classes, bf16, random weights from a seed) and `gather_detection2d`
     on a seeded uint8 (64, 512, 512, 3) batch, with every kernel's launch
     count reset just before and read just after; the decode is checked
     against the plain decode on the same head outputs;
  4. times (CUDA events, after warm-up, on the main path's shapes):
     forward + decode images/s at b64 bf16, the kernel's ms per batch
     beside its plain twin's and the memory bound's; then a torch.profiler
     breakdown of one forward + decode by kernel, and the device's busy
     share;
  5. forward parity: the same f32 weights on the card (TF32 off) and on the
     CPU at batch 2, 512x512; the max abs difference of the heatmap and
     box logits must be within 1e-4 of the logits' largest magnitude.

The closing lines are the card's name and power limit as nvidia-smi
prints them, then {"kernels": [...]}, then {"ok": true, "device": {...}}. Without a card, or without the package
beside it, the script exits non-zero and prints no result.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
H100_F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
FLAGSHIP = (64, 128, 128, 80)
ODD = (3, 37, 53, 7)
BATCH, SIZE = 64, 512
FORWARD_RTOL = 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_breakdown(fn, iters: int, wall_ms: float, top: int = 15) -> dict:
    """Device time per call by kernel name, from torch.profiler, and the
    device's busy share against `wall_ms` (the CUDA-event time per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue               # host ops repeat their kernels' device time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / iters / 1e3, e.count / iters, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return {"device_ms_per_call": total if rows else "not measured",
            "busy_share": total / wall_ms if rows else "not measured",
            "kernels_per_call": sum(r[1] for r in rows),
            "top": [{"ms": ms, "calls": n, "name": name[:90]}
                    for ms, n, name in rows[:top]]}


def peak_inputs(shape, kind, from_logits, dtype, gen):
    n, h, w, c = shape
    dev = "cuda"
    draw = ((lambda s: torch.randn(s, generator=gen, device=dev) * 3)
            if from_logits else (lambda s: torch.rand(s, generator=gen, device=dev)))
    if kind == "random":
        x = draw(shape)
    elif kind == "constant":
        x = torch.full(shape, 0.25, device=dev)
    elif kind == "equal_classes":
        x = draw((n, h, w, 1)).expand(shape).contiguous()
    elif kind == "misaligned":         # contiguous, but not 16-byte aligned
        flat = torch.empty(n * h * w * c + 1, dtype=dtype, device=dev)
        x = flat[1:].view(shape)
        x.copy_(draw(shape))
        return x
    else:  # equal neighbours along every edge, and a bf16-coarse interior
        x = torch.round(draw(shape) * 4) / 4
        x[:, 0] = x[:, 0, :1]
        x[:, :, -1] = x[:, :1, -1]
        x[:, -1, :2] = x[:, -1, -1:]
    return x.to(dtype).contiguous()


def check_same_detections(a, b):
    """Top-k decode of one batch through the kernel (a) and the plain path
    (b); each holds the peak map `flat` (logits), and `indices`, `labels`
    and `boxes` of the top k.

    The top-k logits must be equal. Entries above the k-th logit of their
    row must match as sets of (index, label, box); at the k-th logit ties
    may keep other pixels, and each kept pixel must carry that logit."""
    va = torch.gather(a["flat"], 1, a["indices"].long())
    vb = torch.gather(b["flat"], 1, b["indices"].long())
    assert torch.equal(va, vb), "top-k logits differ"
    for n in range(va.shape[0]):
        inner = va[n] != va[n, -1]
        rows = []
        for out in (a, b):
            idx = out["indices"][n][inner]
            order = torch.argsort(idx)
            rows.append((idx[order], out["labels"][n][inner][order],
                         out["boxes"][n][inner][order]))
        for x, y in zip(*rows):
            assert torch.equal(x, y), f"row {n}: detections differ"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.ops import _build
    from centernet_lightning_torch.ops import decode as decode_ops
    from centernet_lightning_torch.ops import peak_decode

    kernels = [peak_decode.peak_class_scores_cuda]

    # ---- 1. device ------------------------------------------------------
    card = card_line()
    build_s = _build.build_all()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_sources": _build.sources(),
          "build_s": build_s})

    # ---- 2. kernel vs plain --------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(shape, "random") for shape in (FLAGSHIP, ODD, (3, 37, 53, 16))]
    cases += [(ODD, "misaligned"), ((2, 40, 24, 80), "misaligned")]
    cases += [(shape, kind) for shape in (ODD, (2, 128, 128, 80))
              for kind in ("constant", "equal_classes", "edge_ties")]
    max_err = 0.0
    for shape, kind in cases:
        for dtype in (torch.bfloat16, torch.float32):
            for from_logits in (False, True):
                x = peak_inputs(shape, kind, from_logits, dtype, gen)
                s, lab = peak_decode.peak_class_scores_cuda(x, from_logits)
                rs, rl = peak_decode.peak_class_scores_reference(x, from_logits)
                torch.cuda.synchronize()
                same = torch.equal(s, rs) and torch.equal(lab, rl)
                err = (s - rs).abs().max().item()
                max_err = max(max_err, err)
                emit({"phase": "kernel_vs_plain", "kernel": "peak_class_scores",
                      "shape": list(shape), "kind": kind,
                      "dtype": str(dtype).replace("torch.", ""),
                      "from_logits": from_logits, "bitwise_equal": same,
                      "max_abs_err": err,
                      "label_mismatches": int((lab != rl).sum().item())})
                if not same:
                    raise AssertionError(f"peak kernel differs from plain: "
                                         f"{shape} {kind} {dtype} {from_logits}")
    del x, s, lab, rs, rl

    # ---- 3. main path ---------------------------------------------------
    cfg = {"model": {
        "num_classes": 80, "backbone": "resnet34",
        "neck": "FPN", "neck_config": {"out_channels": 256},
        "head_config": {"width": 256, "depth": 3},
        "num_detections": 100, "image_size": [SIZE, SIZE],
        "compute_dtype": "bfloat16",
    }}
    pred = build_centernet(cfg, seed=0)           # default device: the card
    rng = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=rng,
                           dtype=torch.uint8).numpy()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    dets = pred.gather_detection2d(images)
    main_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    shapes_ok = (dets["bboxes"].shape == (BATCH, 100, 4)
                 and dets["scores"].shape == (BATCH, 100)
                 and dets["labels"].shape == (BATCH, 100))
    finite = all(bool(np.isfinite(dets[k]).all()) for k in ("bboxes", "scores"))
    labels_ok = bool(((dets["labels"] >= 0) & (dets["labels"] < 80)).all())

    with torch.inference_mode():
        x = pred.prepare_images(images)
        outs = pred.model(x)
        heat, box = outs["heatmap"], outs["box_2d"]
        kw = dict(num_detections=100, stride=pred.task.stride, from_logits=True)
        a = dict(zip(("flat", "labels_map"),
                     peak_decode.peak_class_scores_cuda(heat, True)))
        b = dict(zip(("flat", "labels_map"),
                     decode_ops.peak_class_scores(heat.float(), from_logits=True)))
        peak_same = (torch.equal(a["flat"], b["flat"])
                     and torch.equal(a["labels_map"], b["labels_map"]))
        for out in (a, b):
            _, out["indices"], out["labels"] = decode_ops._topk(
                out["flat"], out["labels_map"], 100, True)
            out["boxes"] = decode_ops.gather_and_decode_boxes(
                box, out["indices"], stride=pred.task.stride)
        check_same_detections(a, b)
    emit({"phase": "main_path", "config": cfg["model"], "batch": BATCH,
          "image_size": SIZE, "params_M": sum(
              p.numel() for p in pred.model.parameters()) / 1e6,
          "first_call_s": main_s, "launches": launches,
          "heatmap": list(heat.shape), "heatmap_dtype": str(heat.dtype),
          "heatmap_nhwc_contiguous": heat.is_contiguous(),
          "shapes_ok": shapes_ok, "finite": finite, "labels_ok": labels_ok,
          "peak_maps_equal_plain": peak_same, "decode_equal_plain": True})
    if not (shapes_ok and finite and labels_ok and peak_same):
        raise AssertionError("main path output check failed")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    # ---- 4. times -------------------------------------------------------
    dev_images = torch.from_numpy(images).cuda()
    e2e_ms = cuda_ms(lambda: pred.detect(dev_images), iters=10)
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: pred.model(pred.prepare_images(dev_images)),
                         iters=10)
        dec_ms = cuda_ms(lambda: peak_decode.decode_detections_fused(
            heat, box, **kw), iters=20)
        plain_dec_ms = cuda_ms(lambda: decode_ops.decode_detections(
            heat, box, **kw), iters=5)
        kernel_ms = cuda_ms(lambda: peak_decode.peak_class_scores_cuda(
            heat, True), iters=50)
        plain_ms = cuda_ms(lambda: peak_decode.peak_class_scores_reference(
            heat, True), iters=5)
    n, h, w, c = heat.shape
    moved = heat.numel() * heat.element_size() + n * h * w * (4 + 4)
    ops = heat.numel() * 10        # 8 neighbour maxes, 1 compare, 1 argmax step
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    emit({"phase": "times", "batch": BATCH, "dtype": "bfloat16",
          "images_per_s": BATCH / e2e_ms * 1e3, "forward_decode_ms": e2e_ms,
          "forward_ms": fwd_ms, "decode_fused_ms": dec_ms,
          "decode_plain_ms": plain_dec_ms, "peak_kernel_ms": kernel_ms,
          "peak_plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
          "bound_bytes": moved, "bound_ops": ops,
          "library_ms": None,
          "library_note": "no single PyTorch call computes the 3x3 peak mask "
                          "with the class max and argmax",
          "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9})
    emit({"phase": "profile", **device_breakdown(
        lambda: pred.detect(dev_images), iters=3, wall_ms=e2e_ms)})
    del outs, heat, box, a, b, x, dev_images, pred
    torch.cuda.empty_cache()

    # ---- 5. forward parity on the card ---------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32_cfg = {"model": {k: v for k, v in cfg["model"].items()
                         if k != "compute_dtype"}}
    cpu = build_centernet(f32_cfg, seed=1, device="cpu")
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for mod in cpu.model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(0.8, 1.2, generator=g)
                mod.bias.normal_(0.0, 0.05, generator=g)
                mod.running_mean.normal_(0.0, 0.05, generator=g)
                mod.running_var.uniform_(0.8, 1.2, generator=g)
    gpu = build_centernet(f32_cfg, seed=1)
    gpu.model.load_state_dict(cpu.model.state_dict())
    small = images[:2]
    with torch.inference_mode():
        ref = cpu.model(cpu.prepare_images(small))
        got = gpu.model(gpu.prepare_images(small))
    parity = {}
    for key in ("heatmap", "box_2d"):
        diff = (got[key].cpu() - ref[key]).abs().max().item()
        scale = max(1.0, ref[key].abs().max().item())
        parity[key] = {"max_abs_diff": diff, "max_abs_ref": scale,
                       "tolerance": FORWARD_RTOL * scale}
    emit({"phase": "forward_parity", "batch": 2, "image_size": SIZE,
          "dtype": "float32", "tf32": False, **parity})
    for key, p in parity.items():
        if not p["max_abs_diff"] <= p["tolerance"]:
            raise AssertionError(f"forward parity failed for {key}: {p}")

    # ---- closing lines --------------------------------------------------
    print(card_line(), flush=True)
    emit({"kernels": [{
        "name": "peak_class_scores", "route": "cuda",
        "source": peak_decode.KERNEL_SOURCE, "replaces": peak_decode.REPLACES,
        "launches": launches["peak_class_scores_cuda"],
        "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
