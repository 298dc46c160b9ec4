#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100 class, sm_90a).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from csrc/ with nvcc (one process per
source, in parallel), then runs these phases, each printing JSON lines
with its seconds (`phase_s`); any failure exits non-zero:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, the kernels' build time;
  2. kernel vs plain, every kernel against its plain PyTorch twin on the
     card:
     - `peak_class_scores_cuda`, bf16 and f32, probabilities and logits, at
       the flagship (64, 128, 128, 80) map and an odd (3, 37, 53, 7) one,
       plus forced ties; scores bitwise equal, labels exactly equal;
     - `dcn_sample_taps` and `dcn_fused_conv`, f32 and bf16, d = 1 and 2,
       DCNv1 and v2, at the DCN slice's three layers (32, S, S, 128) for
       S = 32, 64, 128 with O = 128, and an odd (3, 37, 53, 24) map with
       O = 40; offsets drawn well past +-d (the clamp), exactly at +-d
       (the floor remap), integers (fraction 0) and +-50 (samples off the
       image at its border), and maps whose pointer is not 16-byte
       aligned. The sampler must be bitwise equal; the fused kernel within
       1e-5 (f32) or 2^-6 (bf16) of the largest |output| (see FUSED_TOL),
       and its launch must refuse a C too wide for its shared memory;
  3. main paths, each with every kernel's launch count reset just before
     and read just after:
     - `build_centernet` (ResNet-34, FPN-256, heads 256 x 3, 80 classes,
       bf16, random weights from a seed) and `gather_detection2d` on a
       seeded uint8 (64, 512, 512, 3) batch; the decode is checked against
       the plain decode on the same head outputs;
     - the DCN slice: ResNet-18, FPN-128 with DCNv2 merge blocks, heads
       128 x 2, 80 classes, bf16, on a (32, 512, 512, 3) batch, once with
       `conv_type: dcn_fast_d1` (sampling kernel) and once with
       `dcn_fused_d1` (fused kernel), with offset convolutions drawn large
       enough that offsets pass +-1; each DCN kernel must launch once per
       DCN layer (3), and the logits must agree with the same model run
       through the kernels' twins (DCN_LOGIT_TOL), with no kernel launched
       in the twins' run;
  4. times (CUDA events, after warm-up, on the main paths' shapes):
     forward + decode images/s, the median of E2E_REPS rounds of
     E2E_ITERS calls (the DCN engines in turn within a round), the
     kernels' ms beside their twins', their bounds and a library call's;
     then torch.profiler breakdowns by kernel and the device's busy share,
     for both slices;
  5. forward parity: the same f32 weights on the card (TF32 off) and on the
     CPU at batch 2, 512x512, for ResNet-34 FPN-256 and for the DCN model
     on both DCN engines; the max abs difference of the heatmap and box
     logits must be within 1e-4 of the logits' largest magnitude.

The closing lines are the card's name and power limit as nvidia-smi
prints them, then {"kernels": [...]}, then {"ok": true, "device": {...}}.
Without a card, or without the package beside it, the script exits
non-zero and prints no result.
"""
import contextlib
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
H100_F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
FLAGSHIP = (64, 128, 128, 80)
ODD = (3, 37, 53, 7)
BATCH, SIZE = 64, 512
DCN_BATCH = 32
FORWARD_RTOL = 1e-4
# fused DCN kernel vs its twin, as a share of the largest |output|: the
# samples are bitwise the twin's, but the f32 sums over 9 taps x C run in
# another order (f32: about 1e-6 seen, 1e-5 allowed); in bf16 the output
# is rounded once, so the two may land one bf16 ulp apart: 2^-6 is about
# two ulps at the top magnitude
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
# DCN model logits through the kernels vs through the twins, bf16, as a
# share of the largest |logit|: the sampler is bitwise, the fused kernel's
# bf16 outputs may differ by an ulp, and such differences pass through
# the layers after it; 2^-5 is about eight bf16 ulps at the top magnitude
DCN_LOGIT_TOL = 2.0 ** -5
DCN_LAYERS = ((32, 32), (64, 64), (128, 128))   # s16, s8, s4 at 512^2
DCN_WIDTH = 128
DCN_ODD = (3, 37, 53, 24, 40)                    # (N, H, W, C, O)
# end-to-end times: REPS rounds of ITERS timed calls, the engines taken in
# turn within a round, so a slow stretch of the machine hits them alike
E2E_REPS, E2E_ITERS = 5, 10


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


def repeated_ms(fns: dict, reps: int = E2E_REPS, iters: int = E2E_ITERS) -> dict:
    """Per call ms of each of `fns`, timed in `reps` rounds that take the
    functions in turn: the median, least and most of the rounds."""
    for fn in fns.values():
        fn()
    rounds = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            rounds[name].append(cuda_ms(fn, iters, warmup=1))
    return {name: {"median_ms": float(np.median(ms)), "min_ms": min(ms),
                   "max_ms": max(ms), "reps": reps, "iters": iters}
            for name, ms in rounds.items()}


def bound(moved: float, ops_ms: float) -> dict:
    """The least time for `moved` bytes and `ops_ms` of arithmetic."""
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_bytes": moved,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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


# ---- DCN inputs and bounds ----------------------------------------------

def dcn_inputs(shape, dtype, d, version, kind, gen, misaligned=False):
    """x (N, H, W, C), the sampling planes and a (9, C, O) kernel on the
    card, from seeded draws. `kind` sets the offsets: "random" (normal,
    std 1.5 d: many past the clamp), "at_bound" (+-d exactly), "integer"
    (whole numbers, fraction 0) or "far" (+-50: clamped, and samples off
    the image along its border)."""
    from centernet_lightning_torch.ops import dcn

    n, h, w, c, o = shape
    dev = "cuda"
    if misaligned:                     # contiguous, but not 16-byte aligned
        x = torch.empty(n * h * w * c + 1, dtype=dtype, device=dev)[1:].view(n, h, w, c)
        x.copy_(torch.randn((n, h, w, c), generator=gen, device=dev))
    else:
        x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dtype)
    oshape = (n, h, w, 2 * len(dcn.TAPS))
    if kind == "random":
        off = torch.randn(oshape, generator=gen, device=dev) * (1.5 * d)
    elif kind == "at_bound":
        sign = torch.randint(0, 2, oshape, generator=gen, device=dev) * 2 - 1
        off = sign.float() * d
    elif kind == "integer":
        off = torch.randint(-d - 1, d + 2, oshape, generator=gen, device=dev).float()
    else:
        sign = torch.randint(0, 2, oshape, generator=gen, device=dev) * 2 - 1
        off = sign.float() * 50.0
    mask = (torch.sigmoid(torch.randn((n, h, w, len(dcn.TAPS)), generator=gen,
                                      device=dev)).to(dtype)
            if version == 2 else None)
    planes = dcn.dcn_planes(off.to(dtype), mask, d)
    kernel = (torch.randn((len(dcn.TAPS), c, o), generator=gen, device=dev)
              / (3 * c ** 0.5)).to(dtype)
    return x, planes, kernel


def sample_bound(n, h, w, c, elt):
    """Bytes: x and the five planes read once, the nine tap maps written
    once. Operations (f32, CUDA cores): per output value 4 corners x
    (multiply + add); per pixel and tap about 10 for the corner weights."""
    taps = 9
    moved = n * h * w * (c * elt + taps * 5 * 4 + taps * c * elt)
    ops = n * h * w * taps * (8 * c + 10)
    return bound(moved, ops / H100_F32_OPS_PER_S * 1e3)


def fused_bound(n, h, w, c, o, elt):
    """Bytes: x, the planes and the kernel read once, the output written
    once. Operations: the product, 2 x 9 C O per pixel, and the f32
    sampling as above. In bf16 the product runs on the tensor cores, a pipe
    apart from the CUDA cores that sample, so the larger of the two times
    bounds; in f32 both share the CUDA cores and their times add."""
    taps = 9
    moved = n * h * w * (c * elt + taps * 5 * 4 + o * elt) + taps * c * o * elt
    product = 2 * n * h * w * taps * c * o
    sampling_ms = n * h * w * taps * (8 * c + 10) / H100_F32_OPS_PER_S * 1e3
    if elt == 2:
        product_ms = product / H100_BF16_OPS_PER_S * 1e3
        ops_ms = max(product_ms, sampling_ms)
    else:
        product_ms = product / H100_F32_OPS_PER_S * 1e3
        ops_ms = product_ms + sampling_ms
    return {**bound(moved, ops_ms), "product_ms": product_ms,
            "sampling_ms": sampling_ms}


def dcn_blocks(model):
    from centernet_lightning_torch.models.layers import DeformableConvBlock

    return [m for m in model.modules() if isinstance(m, DeformableConvBlock)]


@torch.no_grad()
def draw_offset_weights(pred, images, gen, offset_std=1.5, mask_std=1.0):
    """Seeded weights for every DCN offset and mask convolution (zero in a
    seeded model, which would make every offset 0 and the sampling a plain
    3x3 gather), scaled twice on `images` so each layer's offsets have a
    std near `offset_std` (many pass +-1) and its mask logits near
    `mask_std` (the sigmoid stays smooth: logits of thousands would make it
    a step, and the model's output a near-discontinuous function of its
    input)."""
    blocks = dcn_blocks(pred.model)
    convs = [(b.conv_offset, offset_std) for b in blocks]
    convs += [(b.conv_mask, mask_std) for b in blocks if b.conv_mask is not None]
    for conv, _ in convs:
        conv.weight.normal_(0.0, 1.0, generator=gen)
        conv.bias.normal_(0.0, 0.3, generator=gen)
    x = pred.prepare_images(images)
    for _ in range(2):
        stds = {}
        hooks = [conv.register_forward_hook(
            lambda m, _i, out: stds.__setitem__(m, out.float().std().item()))
            for conv, _ in convs]
        pred.model(x)
        for h in hooks:
            h.remove()
        for conv, target in convs:
            conv.weight.mul_(target / stds[conv])
            conv.bias.mul_(target / stds[conv])


@contextlib.contextmanager
def dcn_twins(model, kernels):
    """Run the model's DCN blocks through the kernels' plain twins on the
    card (`DeformableConvBlock._deform(plain=True)`); fails if any of
    `kernels` launches meanwhile."""
    blocks = dcn_blocks(model)
    before = [k.launches for k in kernels]
    for b in blocks:
        b._deform = functools.partial(type(b)._deform, b, plain=True)
    try:
        yield
    finally:
        for b in blocks:
            del b._deform
    after = [k.launches for k in kernels]
    if after != before:
        raise AssertionError(f"a kernel launched in the twins' run: "
                             f"{before} -> {after}")


def dcn_config(conv_type, dtype="bfloat16"):
    model = {"num_classes": 80, "backbone": "resnet18",
             "neck": "FPN", "neck_config": {"out_channels": DCN_WIDTH,
                                            "conv_type": conv_type},
             "head_config": {"width": DCN_WIDTH, "depth": 2},
             "num_detections": 100, "image_size": [SIZE, SIZE]}
    if dtype:
        model["compute_dtype"] = dtype
    return {"model": model}


def perturb_bn(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.uniform_(0.8, 1.2, generator=g)
                mod.bias.normal_(0.0, 0.05, generator=g)
                mod.running_mean.normal_(0.0, 0.05, generator=g)
                mod.running_var.uniform_(0.8, 1.2, generator=g)


def forward_parity(cpu, gpu, images):
    with torch.inference_mode():
        ref = cpu.model(cpu.prepare_images(images))
        got = gpu.model(gpu.prepare_images(images))
    parity = {}
    for key in ("heatmap", "box_2d"):
        diff = (got[key].cpu() - ref[key]).abs().max().item()
        scale = max(1.0, ref[key].abs().max().item())
        parity[key] = {"max_abs_diff": diff, "max_abs_ref": scale,
                       "tolerance": FORWARD_RTOL * scale}
    return parity


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.ops import _build, dcn, dcn_fused, dcn_sample
    from centernet_lightning_torch.ops import decode as decode_ops
    from centernet_lightning_torch.ops import peak_decode
    from centernet_lightning_torch.utils.dcn_audit import audit_dcn_offsets

    kernels = [peak_decode.peak_class_scores_cuda, dcn_sample.dcn_sample_taps,
               dcn_fused.dcn_fused_conv]

    def reset_launches():
        for k in kernels:
            k.launches = 0

    def read_launches():
        return {k.__name__: k.launches for k in kernels}

    # ---- 1. device ------------------------------------------------------
    t_phase = time.perf_counter()
    card = card_line()
    build_s = _build.build_all()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernel_sources": _build.sources(),
          "build_s": build_s, "phase_s": time.perf_counter() - t_phase})

    # ---- 2. kernel vs plain --------------------------------------------
    t_phase = time.perf_counter()
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

    # the DCN kernels: (shape, dtype, d, version, kind, misaligned)
    layer_shapes = [(DCN_BATCH, h, w, DCN_WIDTH, DCN_WIDTH) for h, w in DCN_LAYERS]
    dcn_cases = [(shape, dtype, d, 2, "random", False) for shape in layer_shapes
                 for dtype in (torch.bfloat16, torch.float32) for d in (1, 2)]
    dcn_cases += [(DCN_ODD, dtype, d, version, kind, False)
                  for dtype in (torch.bfloat16, torch.float32) for d in (1, 2)
                  for version in (1, 2)
                  for kind in ("random", "at_bound", "integer", "far")]
    dcn_cases += [(layer_shapes[-1], torch.bfloat16, 1, 1, kind, False)
                  for kind in ("at_bound", "integer", "far")]
    dcn_cases += [(DCN_ODD, dtype, 1, 2, "random", True)
                  for dtype in (torch.bfloat16, torch.float32)]
    dcn_cases += [((2, 40, 24, DCN_WIDTH, DCN_WIDTH), torch.bfloat16, 2, 2,
                   "random", True)]
    dcn_err = {"dcn_sample": 0.0, "dcn_fused": 0.0}
    fused_rel = {"float32": 0.0, "bfloat16": 0.0}
    n_dcn_ok = 0
    for shape, dtype, d, version, kind, misaligned in dcn_cases:
        x, planes, kern = dcn_inputs(shape, dtype, d, version, kind, gen,
                                     misaligned)
        taps = dcn_sample.dcn_sample_taps(x, *planes, d)
        ref_taps = dcn.tap_sample_reference(x, *planes, d)
        y = dcn_fused.dcn_fused_conv(x.contiguous(), *planes, kern, d)
        ref_y = dcn.fused_reference(x, *planes, kern, d)
        torch.cuda.synchronize()
        same = torch.equal(taps, ref_taps)
        taps_err = (taps.float() - ref_taps.float()).abs().max().item()
        y_err = (y.float() - ref_y.float()).abs().max().item()
        y_scale = ref_y.float().abs().max().item()
        y_ok = y_err <= FUSED_TOL[dtype] * y_scale
        dcn_err["dcn_sample"] = max(dcn_err["dcn_sample"], taps_err)
        dcn_err["dcn_fused"] = max(dcn_err["dcn_fused"], y_err)
        dname = str(dtype).replace("torch.", "")
        fused_rel[dname] = max(fused_rel[dname], y_err / max(y_scale, 1e-30))
        emit({"phase": "kernel_vs_plain", "kernel": "dcn_sample+dcn_fused",
              "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
              "d": d, "version": version, "offsets": kind,
              "misaligned": misaligned, "sample_bitwise_equal": same,
              "sample_max_abs_err": taps_err, "fused_max_abs_err": y_err,
              "fused_max_abs_out": y_scale,
              "fused_tolerance": FUSED_TOL[dtype] * y_scale})
        if not (same and y_ok):
            raise AssertionError(f"DCN kernel differs from plain: {shape} "
                                 f"{dtype} d={d} v{version} {kind} "
                                 f"misaligned={misaligned}")
        n_dcn_ok += 1
    del x, planes, kern, taps, ref_taps, y, ref_y
    # C past what one block's shared memory holds: the launch must refuse
    for dtype, c in ((torch.bfloat16, 432), (torch.float32, 224)):
        x, planes, kern = dcn_inputs((1, 4, 4, c, 16), dtype, 1, 2, "random", gen)
        try:
            dcn_fused.dcn_fused_conv(x, *planes, kern, 1)
        except RuntimeError as err:
            emit({"phase": "kernel_vs_plain", "kernel": "dcn_fused",
                  "too_wide_C": c, "dtype": str(dtype).replace("torch.", ""),
                  "raised": str(err)[:120]})
        else:
            raise AssertionError(f"dcn_fused took C={c} {dtype}, past its "
                                 f"shared memory")
    del x, planes, kern
    torch.cuda.empty_cache()
    emit({"phase": "kernel_vs_plain_done", "peak_cases": 4 * len(cases),
          "dcn_cases": n_dcn_ok, "dcn_sample_max_abs_err": dcn_err["dcn_sample"],
          "dcn_fused_max_rel_err": fused_rel,
          "phase_s": time.perf_counter() - t_phase})

    # ---- 3a. main path: ResNet-34 FPN-256 ---------------------------------
    t_phase = time.perf_counter()
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
    reset_launches()
    t0 = time.perf_counter()
    dets = pred.gather_detection2d(images)
    main_s = time.perf_counter() - t0
    launches = read_launches()
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
          "peak_maps_equal_plain": peak_same, "decode_equal_plain": True,
          "phase_s": time.perf_counter() - t_phase})
    if not (shapes_ok and finite and labels_ok and peak_same):
        raise AssertionError("main path output check failed")
    if launches["peak_class_scores_cuda"] < 1:
        raise AssertionError(f"the peak kernel never launched: {launches}")
    path_launches = {"peak_class_scores_cuda": launches["peak_class_scores_cuda"]}

    # ---- 3b. main paths: ResNet-18 FPN-128 DCNv2 --------------------------
    t_phase = time.perf_counter()
    dcn_images = images[:DCN_BATCH]
    wgen = torch.Generator(device="cuda").manual_seed(3)
    dcn_preds = {}
    for conv_type, kernel_name in (("dcn_fast_d1", "dcn_sample_taps"),
                                   ("dcn_fused_d1", "dcn_fused_conv")):
        dpred = build_centernet(dcn_config(conv_type), seed=0)
        if not dcn_preds:
            draw_offset_weights(dpred, dcn_images[:4], wgen)
        else:                       # the same weights on the other engine
            dpred.model.load_state_dict(
                next(iter(dcn_preds.values())).model.state_dict())
        dcn_preds[conv_type] = dpred
        n_layers = len(dcn_blocks(dpred.model))
        reset_launches()
        t0 = time.perf_counter()
        dets = dpred.gather_detection2d(dcn_images)
        first_s = time.perf_counter() - t0
        launches = read_launches()
        audit = audit_dcn_offsets(dpred.task, dpred.prepare_images(dcn_images[:4]))
        shapes_ok = (dets["bboxes"].shape == (DCN_BATCH, 100, 4)
                     and dets["scores"].shape == (DCN_BATCH, 100)
                     and dets["labels"].shape == (DCN_BATCH, 100))
        finite = all(bool(np.isfinite(dets[k]).all()) for k in ("bboxes", "scores"))
        labels_ok = bool(((dets["labels"] >= 0) & (dets["labels"] < 80)).all())
        with torch.inference_mode():
            x = dpred.prepare_images(dcn_images)
            got = dpred.model(x)
            with dcn_twins(dpred.model, kernels):
                ref = dpred.model(x)
        logits = {}
        for key in ("heatmap", "box_2d"):
            diff = (got[key].float() - ref[key].float()).abs().max().item()
            scale = ref[key].float().abs().max().item()
            logits[key] = {"max_abs_diff": diff, "max_abs_ref": scale,
                           "tolerance": DCN_LOGIT_TOL * scale,
                           "bitwise_equal": torch.equal(got[key], ref[key]),
                           "finite": bool(torch.isfinite(got[key]).all())}
        emit({"phase": "dcn_main_path", "conv_type": conv_type,
              "config": dcn_config(conv_type)["model"], "batch": DCN_BATCH,
              "params_M": sum(p.numel() for p in dpred.model.parameters()) / 1e6,
              "dcn_layers": n_layers, "first_call_s": first_s,
              "launches": launches, "offsets": {
                  k: audit[k] for k in ("max_offset", "exceed_frac",
                                        "recommended_d", "n_values")},
              "shapes_ok": shapes_ok, "finite": finite, "labels_ok": labels_ok,
              "logits_vs_twins": logits,
              "phase_s": time.perf_counter() - t_phase})
        if not (shapes_ok and finite and labels_ok):
            raise AssertionError(f"{conv_type} main path output check failed")
        if n_layers != 3 or launches[kernel_name] != n_layers \
                or launches["peak_class_scores_cuda"] != 1:
            raise AssertionError(f"{conv_type}: expected {kernel_name} once per "
                                 f"DCN layer (3) and one peak launch: {launches}")
        if audit["exceed_frac"][1] < 0.05:
            raise AssertionError(f"offsets too small to test the sampling: {audit}")
        for key, p in logits.items():
            if not (p["finite"] and p["max_abs_diff"] <= p["tolerance"]):
                raise AssertionError(f"{conv_type} {key}: kernels vs twins {p}")
        path_launches[kernel_name] = launches[kernel_name]
        t_phase = time.perf_counter()

    # ---- 4a. times: ResNet-34 FPN-256 ---------------------------------------
    t_phase = time.perf_counter()
    dev_images = torch.from_numpy(images).cuda()
    e2e = repeated_ms({"detect": lambda: pred.detect(dev_images)})["detect"]
    e2e_ms = e2e["median_ms"]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: pred.model(pred.prepare_images(dev_images)),
                         iters=5)
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
    peak_b = bound(moved, ops / H100_F32_OPS_PER_S * 1e3)
    emit({"phase": "times", "batch": BATCH, "dtype": "bfloat16",
          "images_per_s": BATCH / e2e_ms * 1e3, "forward_decode_ms": e2e_ms,
          "forward_decode_rounds": e2e,
          "forward_ms": fwd_ms, "decode_fused_ms": dec_ms,
          "decode_plain_ms": plain_dec_ms, "peak_kernel_ms": kernel_ms,
          "peak_plain_ms": plain_ms, **peak_b, "bound_ops": ops,
          "library_ms": None,
          "library_note": "no single PyTorch call computes the 3x3 peak mask "
                          "with the class max and argmax",
          "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
          "phase_s": time.perf_counter() - t_phase})
    t_phase = time.perf_counter()
    emit({"phase": "profile", "model": "resnet34_fpn256", **device_breakdown(
        lambda: pred.detect(dev_images), iters=3, wall_ms=e2e_ms),
        "phase_s": time.perf_counter() - t_phase})
    del outs, heat, box, a, b, x, dev_images, pred
    torch.cuda.empty_cache()

    # ---- 4b. times: the DCN slice -----------------------------------------
    t_phase = time.perf_counter()
    dev_images = torch.from_numpy(dcn_images).cuda()
    state = dcn_preds["dcn_fast_d1"].model.state_dict()
    engines = {}
    for conv_type in ("dcn_fast_d1", "dcn_fast", "dcn_fused_d1", "dcn", "normal"):
        dpred = dcn_preds.get(conv_type)
        if dpred is None:
            dpred = build_centernet(dcn_config(conv_type), seed=0)
            if conv_type != "normal":
                dpred.model.load_state_dict(state)
        engines[conv_type] = functools.partial(dpred.detect, dev_images)
    e2e = repeated_ms(engines)
    for t in e2e.values():
        t["images_per_s"] = DCN_BATCH / t["median_ms"] * 1e3
    del engines, dpred
    emit({"phase": "dcn_times", "batch": DCN_BATCH, "dtype": "bfloat16",
          "image_size": SIZE, "engines": e2e,
          "phase_s": time.perf_counter() - t_phase})

    t_phase = time.perf_counter()
    kernel_times = []
    for (h, w) in DCN_LAYERS:
        shape = (DCN_BATCH, h, w, DCN_WIDTH, DCN_WIDTH)
        x, planes, kern = dcn_inputs(shape, torch.bfloat16, 1, 2, "random", gen)
        n, _, _, c, o = shape
        gemm_w = kern.reshape(9 * c, o)
        # library: one grid_sample over the nine taps (stacked along H) at
        # the same clamped coordinates; it has no modulation multiply
        a0, b0, fy, fx, _ = planes
        ys = torch.arange(h, device="cuda").view(1, h, 1, 1)
        xs = torch.arange(w, device="cuda").view(1, 1, w, 1)
        gy = (ys + a0 + fy) * (2.0 / (h - 1)) - 1
        gx = (xs + b0 + fx) * (2.0 / (w - 1)) - 1
        grid = torch.stack([gx, gy], dim=-1).permute(0, 3, 1, 2, 4).reshape(
            n, 9 * h, w, 2).to(x.dtype)
        x_nchw = x.permute(0, 3, 1, 2)
        with torch.inference_mode():
            t = {
                "sample_ms": cuda_ms(lambda: dcn_sample.dcn_sample_taps(
                    x, *planes, 1), iters=20),
                "sample_plain_ms": cuda_ms(lambda: dcn.tap_sample_reference(
                    x, *planes, 1), iters=3),
                "sample_library_ms": cuda_ms(lambda: torch.nn.functional.grid_sample(
                    x_nchw, grid, mode="bilinear", padding_mode="zeros",
                    align_corners=True), iters=20),
                "fused_ms": cuda_ms(lambda: dcn_fused.dcn_fused_conv(
                    x, *planes, kern, 1), iters=20),
                "fused_plain_ms": cuda_ms(lambda: dcn.fused_reference(
                    x, *planes, kern, 1), iters=3),
                "per_tap_path_ms": cuda_ms(lambda: torch.matmul(
                    dcn_sample.dcn_sample_taps(x, *planes, 1).reshape(-1, 9 * c),
                    gemm_w), iters=20),
            }
        sb = sample_bound(n, h, w, c, 2)
        fb = fused_bound(n, h, w, c, o, 2)
        kernel_times.append({"shape": list(shape), **t,
                             "sample_bound": sb, "fused_bound": fb})
        emit({"phase": "dcn_kernel_times", "shape": list(shape),
              "dtype": "bfloat16", "d": 1, **t, "sample_bound": sb,
              "fused_bound": fb,
              "sample_library_note": "F.grid_sample over the 9 taps at the "
                                     "same clamped coordinates, without the "
                                     "modulation multiply",
              "fused_library_ms": None,
              "fused_library_note": "no single PyTorch call computes it; "
                                    "per_tap_path_ms is the sampling kernel "
                                    "plus one matmul over K = 9 C",
              "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9})
    del x, planes, kern, grid, x_nchw, gemm_w
    fast = dcn_preds["dcn_fast_d1"]
    emit({"phase": "dcn_profile", "model": "resnet18_fpn128_dcn_fast_d1",
          **device_breakdown(lambda: fast.detect(dev_images), iters=3,
                             wall_ms=e2e["dcn_fast_d1"]["median_ms"]),
          "phase_s": time.perf_counter() - t_phase})
    del dev_images, fast, dcn_preds
    torch.cuda.empty_cache()

    # ---- 5. forward parity on the card ---------------------------------
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32_cfg = {"model": {k: v for k, v in cfg["model"].items()
                         if k != "compute_dtype"}}
    cpu = build_centernet(f32_cfg, seed=1, device="cpu")
    perturb_bn(cpu.model, 2)
    gpu = build_centernet(f32_cfg, seed=1)
    gpu.model.load_state_dict(cpu.model.state_dict())
    small = images[:2]
    parity = forward_parity(cpu, gpu, small)
    emit({"phase": "forward_parity", "model": "resnet34_fpn256", "batch": 2,
          "image_size": SIZE, "dtype": "float32", "tf32": False, **parity,
          "phase_s": time.perf_counter() - t_phase})
    for key, p in parity.items():
        if not p["max_abs_diff"] <= p["tolerance"]:
            raise AssertionError(f"forward parity failed for {key}: {p}")
    del cpu, gpu
    parity_state = None
    for conv_type in ("dcn_fast_d1", "dcn_fused_d1"):
        t_phase = time.perf_counter()
        f32 = dcn_config(conv_type, dtype=None)
        cpu = build_centernet(f32, seed=1, device="cpu")
        gpu = build_centernet(f32, seed=1)
        if parity_state is None:
            perturb_bn(cpu.model, 2)
            gpu.model.load_state_dict(cpu.model.state_dict())
            # offsets drawn after the BN change, on the model compared
            draw_offset_weights(gpu, small, torch.Generator(
                device="cuda").manual_seed(4))
            parity_state = gpu.model.state_dict()
        gpu.model.load_state_dict(parity_state)
        cpu.model.load_state_dict(parity_state)
        audit = audit_dcn_offsets(gpu.task, gpu.prepare_images(small))
        parity = forward_parity(cpu, gpu, small)
        emit({"phase": "forward_parity", "model": "resnet18_fpn128_dcnv2",
              "conv_type": conv_type, "batch": 2, "image_size": SIZE,
              "dtype": "float32", "tf32": False, **parity,
              "offsets": {k: audit[k] for k in ("max_offset", "exceed_frac")},
              "phase_s": time.perf_counter() - t_phase})
        for key, p in parity.items():
            if not p["max_abs_diff"] <= p["tolerance"]:
                raise AssertionError(f"{conv_type} forward parity failed for "
                                     f"{key}: {p}")
        del cpu, gpu

    # ---- closing lines --------------------------------------------------
    s4 = kernel_times[-1]
    print(card_line(), flush=True)
    emit({"kernels": [
        {"name": "peak_class_scores", "route": "cuda",
         "source": peak_decode.KERNEL_SOURCE, "replaces": peak_decode.REPLACES,
         "launches": path_launches["peak_class_scores_cuda"],
         "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": peak_b["bound_ms"], "bound_by": peak_b["bound_by"],
         "library_ms": None},
        {"name": "dcn_sample_taps", "route": "cuda",
         "source": dcn_sample.KERNEL_SOURCE, "replaces": dcn_sample.REPLACES,
         "launches": path_launches["dcn_sample_taps"],
         "max_abs_err": dcn_err["dcn_sample"], "ms": s4["sample_ms"],
         "plain_ms": s4["sample_plain_ms"],
         "bound_ms": s4["sample_bound"]["bound_ms"],
         "bound_by": s4["sample_bound"]["bound_by"],
         "library_ms": s4["sample_library_ms"]},
        {"name": "dcn_fused_conv", "route": "cuda",
         "source": dcn_fused.KERNEL_SOURCE, "replaces": dcn_fused.REPLACES,
         "launches": path_launches["dcn_fused_conv"],
         "max_abs_err": dcn_err["dcn_fused"], "ms": s4["fused_ms"],
         "plain_ms": s4["fused_plain_ms"],
         "bound_ms": s4["fused_bound"]["bound_ms"],
         "bound_by": s4["fused_bound"]["bound_by"],
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
