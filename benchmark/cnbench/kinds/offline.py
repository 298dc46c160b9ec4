"""Offline detection: batches of uint8 images from pinned host memory
through `CenterNetPredictor.gather_detection2d` (upload, preprocess,
forward, decode, the top-k to the host), one after another, for the whole
window. A batch counts when its detections are on the host.

Traffic parameters: batch, distinct_batches (a pool cycled in order),
calibration_images, check_batches (the calls compared with the
reference, drawn from the seed), reference_block, trace_skip and
trace_calls (the calls the traced run profiles)."""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import judge, trace, traffic, weights
from .train import by_span
from ..common import build_task, free, host_clock, memory_peak, sync
from reference import decode as decode_ref
from reference import model as model_ref
from reference.nn import Ctx


def run(cell):
    from centernet_lightning_torch.api import CenterNetPredictor
    from centernet_lightning_torch.ops import peak_decode

    p, cfg, dev = cell.traffic, cell.config, cell.device
    h, w = cell.image_size
    b, nb = p["batch"], p["distinct_batches"]
    k = cfg.get("num_detections", 100)
    mean, std = cfg["mean"], cfg["std"]
    spec = model_ref.param_spec(cell.model_cfg, (h, w))
    params = weights.make(spec, cell.model_cfg, cell.seed, dev)
    pool = traffic.images(cell.seed, nb * b, h, w, dev).view(nb, b, h, w, 3)
    weights.calibrate(params, cell.model_cfg,
                      pool[0, :p["calibration_images"]].to(dev), mean, std)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    task = build_task(cell.model_cfg, dev)
    weights.load_into(task.model, params)
    predictor = CenterNetPredictor(task, image_size=(h, w), mean=mean, std=std,
                                   compute_dtype=cfg["compute_dtype"], device=dev)
    if cell.predictor_hook is not None:
        predictor = cell.predictor_hook(predictor, pool[0, :p["calibration_images"]])
    predictor.gather_detection2d(pool[0], num_detections=k)     # warm-up

    heat_shapes = []
    hook = task.model.heads["heatmap"].register_forward_hook(
        lambda m, a, out: heat_shapes.append((tuple(out.shape), out.element_size()))
        if cell.trace and prof is not None else None)
    prof = None
    rec = {}
    outputs = []
    host = host_clock()
    t0 = cell.begin_window()
    calls = 0
    ends = []
    while True:
        if cell.trace and calls == p["trace_skip"]:
            sync(dev)
            launches0 = peak_decode.peak_class_scores_cuda.launches
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        outputs.append(predictor.gather_detection2d(pool[calls % nb], num_detections=k))
        calls += 1
        ends.append(time.perf_counter() - t0)
        if prof is not None and calls == p["trace_skip"] + p["trace_calls"]:
            sync(dev)
            prof.stop()
            rec = trace.reduce(prof)
            rec.update(steps=p["trace_calls"], images=p["trace_calls"] * b,
                       peak_launches=peak_decode.peak_class_scores_cuda.launches - launches0,
                       heatmaps=list(heat_shapes))
            prof = None
        if time.perf_counter() - t0 >= cell.seconds and (
                not cell.trace or calls > p["trace_skip"] + p["trace_calls"]):
            break
    elapsed = time.perf_counter() - t0
    host_s = host()
    hook.remove()
    peak = memory_peak(dev)
    del predictor, task
    free(dev)

    picks = traffic.rng(cell.seed, 3).choice(calls, size=min(p["check_batches"], calls),
                                             replace=False)
    served, refs = [], []
    for c in sorted(int(x) for x in picks):
        served.append({key: torch.from_numpy(np.asarray(outputs[c][src])).to(dev)
                       for key, src in (("boxes", "bboxes"), ("labels", "labels"),
                                        ("scores", "scores"))})
        refs.append(reference_dense(cell, params, pool[c % nb], p["reference_block"],
                                    k, normalize=False))
    served = {key: torch.cat([s[key] for s in served]) for key in served[0]}
    refs = {key: torch.cat([r[key] for r in refs]) for key in refs[0]}
    m = served["scores"].shape[0]
    numbers = judge.detection_gaps(
        served, refs, torch.full((m,), float(max(h, w)), device=dev),
        torch.full((m,), float(model_ref.STRIDE), device=dev))
    return {"attempted": calls * b, "failed": 0, "numbers": numbers,
            "e2e": {"images_per_s": calls * b / elapsed},
            "records": rec, "memory_peak": peak,
            "info": {"calls": calls, "window_s": elapsed, "host": host_s,
                     "images_per_s_by_5s": by_span(ends, b, 5.0), "checked_calls":
                     sorted(int(x) for x in picks), "numbers": numbers}}


@torch.no_grad()
def reference_dense(cell, params, images, block, k, normalize, sizes=None):
    """The reference's dense decode of uint8 NHWC `images` at the model's
    size, `block` images at a time, float32 without TF32."""
    cfg = cell.config
    model_cfg = cell.model_cfg
    outs = {"scores": [], "window_max": [], "boxes": [], "top_scores": []}
    with weights.no_tf32():
        for i in range(0, images.shape[0], block):
            x = model_ref.preprocess(images[i:i + block].to(cell.device),
                                     cfg["mean"], cfg["std"])
            maps = model_ref.forward(Ctx(params), model_cfg, x)
            d = decode_ref.dense(maps["heatmap"], maps["box_2d"], k,
                                 model_cfg.get("box_log", False),
                                 model_cfg.get("box_multiplier", 1.0),
                                 model_ref.STRIDE, normalize)
            for key in outs:
                outs[key].append(d[key])
    return {key: torch.cat(v) for key, v in outs.items()}
