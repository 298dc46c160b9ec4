#!/usr/bin/env python3
"""Serving benchmark of the PyTorch port on one CUDA card: images/s of
forward + decode at 512x512, b64 bf16, channels_last, the images already
on the card (what `bench.py` measures for the JAX package on a TPU).

    python3 bench_torch.py                       # ResNet-34 FPN-256
    python3 bench_torch.py --config vovnet39     # or dla34_ida, efficientnet_b0
    python3 bench_torch.py --train               # bench_train.py's cell
    python3 bench_torch.py --track               # bench_track.py's cell
    python3 bench_torch.py --eval                # bench_eval.py's cell

Prints ONE JSON line {"metric", "value", "unit", "extras"}; for serving `extras` has
the decode's ms a batch (the peak kernel, top-k and box gather on the
model's own heatmap), the dtype, channels_last, the peak kernel's
launches in the timed calls, and the card's name. Weights are random from
a seed, with BatchNorm statistics from one train-mode pass over the batch
(as training sets them; chip_smoke.py's `calibrate_bn`). Times are CUDA
events over `--iters` calls after a warm-up, the median of `--reps` rounds
(chip_smoke.py's `repeated_ms`). Runs on the card only: without one it
exits non-zero and prints no result.

The other cells, as the JAX package's benches define them:
  --train  the flagship's full train step (uint8 preprocess, forward,
           target rendering, losses, backward, AdamW, BatchNorm
           statistics) at b32 bf16 512^2 on seeded batches of 128 padded
           boxes about 30% valid: train images/s;
  --track  configs/mot_tracking.yaml at 608 x 1088, b8 bf16, TRACK_FRAMES
           frames of 24 moving rectangles from the host through
           `track_stream` at pipeline depths 1 and 2 (the heatmap bias
           shifted so that the median peak sits at the tracker's 0.3
           threshold): frames/s, the better depth as the value;
  --eval   the COCO validation epoch of the flagship at b64: the device
           leg (uint8 preprocess, f32 forward and decode, the eval step),
           the evaluator's host leg (`update` a batch) and its epoch-end
           `get_metrics`, on synthetic detections of COCO val's density
           (top-100, 7 boxes an image, EVAL_IMAGES images); the projected
           images/s of an epoch, n / (n max(device, host) + metrics), as
           bench_eval.py computes it.
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


TRAIN_BATCH = 32
TRACK_FRAMES = 320
EVAL_BATCH, EVAL_IMAGES, EVAL_GT = 64, 5000, 7


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=sorted(CONFIGS), default="flagship")
    cell = parser.add_mutually_exclusive_group()
    cell.add_argument("--train", action="store_true",
                      help="the flagship's train step, b32 bf16")
    cell.add_argument("--track", action="store_true",
                      help="mot_tracking.yaml through track_stream, b8 bf16")
    cell.add_argument("--eval", action="store_true",
                      help="the flagship's COCO validation epoch, b64")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device", file=sys.stderr)
        return 2
    if args.train:
        return bench_train(args)
    if args.track:
        return bench_track(args)
    if args.eval:
        return bench_eval(args)

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


def _flagship_task(**extra):
    from centernet_lightning_torch.models.centernet import CenterNet

    return CenterNet(num_classes=80, **CONFIGS["flagship"][1], **extra)


def bench_train(args) -> int:
    """bench_train.py's cell: the full train step of the flagship."""
    from centernet_lightning_torch.train import (TrainState, make_optimizer,
                                                 make_train_step)
    from chip_smoke import (TRAIN_OPT, TRAIN_RECIPE, detection_batches,
                            repeated_ms)

    task = _flagship_task(**TRAIN_RECIPE)
    task.init(torch.Generator().manual_seed(0))
    model = task.model.to("cuda", memory_format=torch.channels_last)
    state = TrainState(model=model, tx=make_optimizer(
        model, max_epochs=100, steps_per_epoch=1000, **TRAIN_OPT))
    step = make_train_step(task, compute_dtype="bfloat16")
    batches = detection_batches(4, TRAIN_BATCH, args.size, 80, "cuda", 0)
    turn = [0]

    def one_step():
        batch = batches[turn[0] % len(batches)]
        turn[0] += 1
        step(state, batch)

    torch.cuda.reset_peak_memory_stats()
    ms = repeated_ms({"step": one_step}, args.reps, args.iters)["step"]
    print(json.dumps({
        "metric": f"train_images_per_sec resnet34-fpn256@{args.size}x"
                  f"{args.size} full step",
        "value": round(TRAIN_BATCH / ms["median_ms"] * 1e3, 2),
        "unit": "images/sec",
        "extras": {"batch_size": TRAIN_BATCH, "dtype": "bfloat16",
                   "optimizer": TRAIN_OPT["optimizer"],
                   "sec_per_step": round(ms["median_ms"] / 1e3, 6),
                   "step_ms_min_max": [round(ms["min_ms"], 3),
                                       round(ms["max_ms"], 3)],
                   "peak_memory_gb": round(
                       torch.cuda.max_memory_allocated() / 1e9, 3),
                   "platform": "gpu",
                   "device": torch.cuda.get_device_name(0)},
    }))
    return 0


def bench_track(args) -> int:
    """bench_track.py's cell: FairMOT serving through track_stream."""
    import numpy as np

    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.ops import peak_decode
    from chip_smoke import (TRACK_BATCH, TRACK_OBJECTS, calibrate_bn,
                            run_stream, synth_frames, tracking_config)

    cfg, tracker_cfg = tracking_config()
    tracker_cfg["min_birth_age"] = 1
    h, w = cfg["model"]["image_size"]
    k, thr = tracker_cfg["num_detections"], tracker_cfg["detection_threshold"]
    frames = synth_frames(TRACK_FRAMES, h, w, TRACK_OBJECTS)
    pred = build_centernet(cfg, seed=0)
    calibrate_bn(pred, frames[:TRACK_BATCH])
    with torch.inference_mode():
        scores = pred._gather_tracking_device(
            frames[:TRACK_BATCH], num_detections=k)["scores"]
        median = float(scores[scores > 0].median())
    with torch.no_grad():
        pred.model.heads["heatmap"].out_conv.bias.add_(float(
            np.log(thr / (1 - thr)) - np.log(median / (1 - median))))
    fps, tracks = {}, {}
    peak = peak_decode.peak_class_scores_cuda
    for depth in (1, 2):
        run_stream(pred, frames[:2 * TRACK_BATCH], tracker_cfg, depth)
        peak.launches = 0
        wall, steps = run_stream(pred, frames, tracker_cfg, depth)
        fps[depth] = len(steps) / wall
        tracks[depth] = float(np.mean([len(s["track_ids"]) for s in steps]))
    print(json.dumps({
        "metric": f"tracking_frames_per_sec mot_tracking@{h}x{w} "
                  f"b{TRACK_BATCH} track_stream",
        "value": round(max(fps.values()), 2),
        "unit": "frames/sec",
        "extras": {"fps_depth1": round(fps[1], 2), "fps_depth2": round(fps[2], 2),
                   "frames": TRACK_FRAMES, "batch_size": TRACK_BATCH,
                   "objects": TRACK_OBJECTS, "tracks_per_frame": tracks,
                   "peak_launches_last_run": peak.launches,
                   "dtype": "bfloat16", "platform": "gpu",
                   "device": torch.cuda.get_device_name(0)},
    }))
    return 0


def bench_eval(args) -> int:
    """bench_eval.py's cell: the device, host and metrics legs of a COCO
    validation epoch, and its projected images/s."""
    import time

    import numpy as np

    from centernet_lightning_torch.eval.coco_eval import CocoEvaluator
    from centernet_lightning_torch.train import TrainState, make_eval_step
    from centernet_lightning_torch.utils.box_np import convert_box_format
    from chip_smoke import repeated_ms

    task = _flagship_task(num_detections=100)
    task.init(torch.Generator().manual_seed(0))
    model = task.model.to("cuda", memory_format=torch.channels_last)
    state = TrainState(model=model, tx=None)
    eval_step = make_eval_step(task)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = [torch.randint(0, 256, (EVAL_BATCH, args.size, args.size, 3),
                            generator=gen, device="cuda", dtype=torch.uint8)
              for _ in range(2)]
    turn = [0]

    def device_batch():
        turn[0] += 1
        eval_step(state, {"image": images[turn[0] % 2]})

    ms = repeated_ms({"eval": device_batch}, args.reps, args.iters)["eval"]
    device_ms = ms["median_ms"] / EVAL_BATCH

    # the host legs, on bench_eval.py's synthetic detections
    rng = np.random.default_rng(1)
    n, k = EVAL_IMAGES, task.num_detections
    det_boxes = rng.uniform(0, 480, (n, k, 4)).astype(np.float32)
    det_boxes[..., 2:] = det_boxes[..., :2] + rng.uniform(
        4, 120, (n, k, 2)).astype(np.float32)
    det_scores = np.sort(rng.uniform(0, 1, (n, k)).astype(np.float32),
                         axis=1)[:, ::-1]
    det_labels = rng.integers(0, 80, (n, k))
    gt_xy = rng.uniform(0, 480, (n, EVAL_GT, 4)).astype(np.float32)
    gt_wh = rng.uniform(4, 120, (n, EVAL_GT, 2)).astype(np.float32)
    gt = np.concatenate([gt_xy[..., :2], gt_wh], axis=-1)
    gt_labels = rng.integers(0, 80, (n, EVAL_GT))
    evaluator = CocoEvaluator(80)
    t0 = time.perf_counter()
    for s in range(0, n, EVAL_BATCH):
        e = min(s + EVAL_BATCH, n)
        boxes_xywh = convert_box_format(det_boxes[s:e], "xyxy", "xywh")
        evaluator.update(
            [{"boxes": boxes_xywh[i], "scores": det_scores[s + i],
              "labels": det_labels[s + i]} for i in range(e - s)],
            [{"boxes": gt[i], "labels": gt_labels[i]} for i in range(s, e)])
    host_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    metrics = evaluator.get_metrics()
    metrics_s = time.perf_counter() - t0
    per_img_ms = max(device_ms, host_ms)
    epoch_s = n * per_img_ms / 1e3 + metrics_s
    print(json.dumps({
        "metric": f"eval_epoch_projected_img_s {args.size}x{args.size} "
                  f"b{EVAL_BATCH} top{k} {n}img",
        "value": round(n / epoch_s, 1),
        "unit": "images/sec",
        "extras": {
            "device_ms_per_img": round(device_ms, 4),
            "host_accum_ms_per_img": round(host_ms, 4),
            "metrics_epoch_s": round(metrics_s, 2),
            "metrics_ms_per_img": round(metrics_s / n * 1e3, 4),
            "mAP_sanity": round(float(metrics["mAP"]), 4),
            "bound_by": ("device" if device_ms > host_ms else "host-accum")
            if metrics_s < epoch_s / 2 else "epoch-end-metrics",
            "batch_size": EVAL_BATCH, "dtype": "float32", "platform": "gpu",
            "device": torch.cuda.get_device_name(0)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
