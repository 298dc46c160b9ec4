#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (H100 class, sm_90a).

    python3 chip_smoke.py

Builds every CUDA kernel of the port from csrc/ with nvcc (one process per
source, in parallel), then runs these phases, each printing JSON lines
with its seconds (`phase_s`); any failure exits non-zero:

  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions, the kernels' build time, and the build of the tracker's
     native Hungarian solver (g++, native/src/native_ops.cc);
  2. kernel vs plain, every kernel against its plain PyTorch twin on the
     card:
     - `peak_class_scores_cuda`, bf16 and f32, probabilities and logits, at
       the flagship (64, 128, 128, 80) map and an odd (3, 37, 53, 7) one,
       plus forced ties, NaNs (inside, at a corner, along borders), LVIS's
       1203 classes (also misaligned: the kernel streams classes in
       chunks of one-value loads), 1208 and 516 classes (chunks of 16-byte
       vectors), H = 1, W = 1, a W that leaves a partial strip of
       columns, and the tracking maps of one class, (8, 152, 272, 1) and
       (8, 152, 152, 1) (random, NaN, edge ties, misaligned); scores
       bitwise equal, labels exactly equal; the kernel's
       build (registers, spills, shared memory, strip, band, ring depth)
       for the flagship map is printed;
     - `dcn_sample_taps` and `dcn_fused_conv`, f32 and bf16, d = 1 and 2,
       DCNv1 and v2, at the DCN slice's three layers (32, S, S, 128) for
       S = 32, 64, 128 with O = 128, and an odd (3, 37, 53, 24) map with
       O = 40; offsets drawn well past +-d (the clamp), exactly at +-d
       (the floor remap), integers (fraction 0) and +-50 (samples off the
       image at its border), and maps whose pointer is not 16-byte
       aligned. The sampler and the fused kernel's W re-layout (bf16) must
       be bitwise equal to their twins; the fused kernel within
       1e-5 (f32) or 2^-6 (bf16) of the largest |output| (see FUSED_TOL),
       also at C = 432 in bf16 (the bf16 kernel streams C in chunks), while
       its f32 launch must refuse a C too wide for its shared memory; the
       bf16 kernel's registers, spills and shared memory are printed;
     - `max_pool_3x3_s2_auto`, bf16 and f32, at the ResNet stem's
       (64, 256, 256, 64), an odd (3, 37, 53, 24) map (also misaligned) and
       a 1 x 1 map, with negatives and -inf among the values: bitwise equal
       to its twin and to `F.max_pool2d(3, 2, 1)`;
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
     kernels' ms beside their twins', their bounds and a library call's
     (the peak kernel also with its share of the bound and on 8 images:
     64 blocks, at most one an SM, on 21 MB that stay in L2, which times
     one block's walk; the fused kernel also with
     its TFLOP/s, its share of the bound and the weight re-layout alone);
     then torch.profiler breakdowns by kernel and the device's busy share,
     for both slices;
     then the pool kernel beside its 0.200 ms bound, its twin and
     `F.max_pool2d`, and the DCN backward: for both DCN kernels at the
     three layer shapes, bf16 and f32, the gradients through the
     kernels' `autograd.Function`s (kernel forward, twin recompute) must
     be bitwise equal to autograd through the twins, and the forward and
     the recompute are timed;
  5. training main paths, each with the launch counts reset just before
     `Trainer.fit` and read just after (5 epochs of 4 seeded batches, 512^2,
     bf16, the configs/centernet.yaml recipe, K = 128 boxes an image about
     30% valid): ResNet-34 FPN-256 at b32 (b16 if b32 does not fit), whose
     losses must stay finite, whose every parameter and BatchNorm
     statistic must move, and whose eval step must launch the peak kernel
     once; then the DCN model at b32 on `dcn_fast_d1` and `dcn_fused_d1`,
     3 DCN launches a step, and one step's gradients through the kernels
     against the same step through the twins (no launch): bitwise on
     `dcn_fast_d1`; on `dcn_fused_d1`, in bf16 and in f32, the whole
     gradient within FUSED_GRAD_TOL (relative L2). Each prints
     train images/s (median epoch after the first), peak memory and a
     profile;
     then the shipped configs' main paths, each with the launch counts
     reset just before and read just after: `build_centernet` on
     configs/centernet.yaml (CSPDarknet-53, FPN-256, heads 256 x 3, 80
     classes), helmet.yaml (MobileNetV2, separable SimpleNeck
     256/128/64, 2 classes) and base_resnet34.yaml (ResNet-34, nearest
     SimpleNeck), and a ResNet-34 BiFPN-256 built from a dict; bf16,
     seeded weights with BatchNorm statistics from one train-mode pass
     over 8 images (`calibrate_bn`), the (64, 512, 512, 3) batch through
     `gather_detection2d`: one peak launch each, and the detections equal
     to the plain decode of the same head outputs; their images/s (median
     of E2E_REPS rounds, the configs in turn) and their profiles; then
     centernet.yaml in fp16, whose heatmap the decode
     widens to f32 for the kernel: one peak launch, detections equal to
     the plain decode;
     then the remaining backbone families (`backbone_phases`): VoVNet-39
     FPN-256 (heads 256 x 3), DLA-34 IDA-256 (heads 256 x 2) and
     EfficientNet-B0 with a separable FPN-96 (heads 96 x 2), bench_suite's
     configs at 80 classes, bf16, BatchNorm calibrated, the (64, 512, 512,
     3) batch through `gather_detection2d` with the launch counts reset
     just before and read just after: one peak launch each, detections
     equal to the plain decode's, FLOPs an image (FlopCounterMode); their
     images/s (median of E2E_REPS rounds, in turn) and profiles; the f32
     forward on the card (TF32 off) at b2 against the same weights' f64
     forward on the CPU, held at FORWARD_RTOL of the largest magnitude or,
     where the CPU's own f32 forward is already that far from f64, at
     twice the CPU's distance (`forward_parity_exact`); then the flagship
     with `stem_space_to_depth` against the plain stem on the same weights
     (the port runs the plain stem for it: one peak launch each, logits and
     detections bitwise equal; the JAX package's regrouped 4x4 stem,
     `stem_space_to_depth`, in f32 within STEM_F32_TOL of `F.conv2d`, and
     both stems' ms); the flagship decode with the top-k in lax.top_k's
     order against the order-free `torch.topk` it replaced, timed in
     turns, and the order checked against a stable sort; one bf16 train
     step of a `remat` ResNet-34 FPN-256 at b32 against the plain step
     twice: gradients (relative L2 no larger than the second plain step's
     from the first), BatchNorm statistics updated once (REMAT_STATS_TOL),
     peak memory lower, step ms;
     then the tracking path: `build_centernet` on configs/mot_tracking.yaml
     (ResNet-34, FPN-256, heads 256 x 3, 1 class, ReID head 256 x 1 -> 64,
     2900 identities) at 608 x 1088, bf16, BatchNorm calibrated, the
     heatmap head's bias shifted so that the median top-300 peak score of
     the first batch sits at the tracker's 0.3 threshold (seeded weights
     score every pixel near the 0.1 prior); 640 seeded frames of 24
     moving rectangles through `track_stream` in batches of 8 at pipeline
     depths 1 and 2, the launch counts reset just before each and read
     just after (one peak launch a batch), the same track ids a frame at
     both depths, `native.available()`, and one batch's detections equal
     to the plain decode; frames/s at each depth, device ms a frame
     (forward + decode alone), association ms a frame (`Tracker.update`
     alone), H2D ms a batch and the peak kernel at the tracking map
     beside its bound; then FairMOT's train step (the YAML's Adam and
     OneCycle) through `Trainer.fit`, 5 steps at b8 on seeded batches with
     identities: step ms, the ReID loss, all losses finite;
     then validation inside the Trainer, each run once with every decode
     also decoded plainly (ops/decode.py, no kernel) on the same head
     outputs, once on those plain detections through a replaying eval
     step, and once timed, the launch counts reset just before the first
     and the timed run and read just after: `validation_main_path`, the
     flagship (ResNet-34, FPN-256, heads 256 x 3, 80 classes, 512^2)
     trained 3 bf16 steps at b32 by `Trainer.fit`, which validates at the
     epoch's end on 512 seeded uint8 images of numpy-drawn rectangles
     (boxes, labels, iscrowd, area; no OpenCV) through the port's
     threaded DataLoader (4 workers) and CollateDetection at b64: the JAX
     package's 12 val/* keys, all finite, one checkpoint in
     `ckpt_dir/best`, one peak launch a validation batch, the metrics equal
     to the plain decode's; validation images/s, device ms a batch
     (forward + decode), the evaluator's host ms a batch and the host's
     wait on the D2H event a batch; then `tracking_validation`:
     configs/mot_tracking.yaml (608 x 1088, the YAML's tracker), 2
     sequences of 160 frames (`synth_frames` with each frame's boxes and
     ids) through CollateTracking with `sequence_id` into
     `Trainer.validate()`, BatchNorm calibrated and the heatmap bias
     shifted so that the 32nd peak of a frame sits at the tracker's
     threshold: val/MOTA, val/IDF1, val/HOTA and the per-sequence keys
     finite, 2 tracker resets, one peak launch a batch, the metrics equal
     to the plain decode's; frames/s, device ms and association ms a
     frame;
     then the train CLI (`cli_main_path`): configs/centernet.yaml as
     shipped (CSPDarknet-53, FPN-256, heads 256 x 3, 80 classes, 512^2,
     bf16, its AdamW recipe) but for its data sections, which become
     packs (data/packed.py's format, written with numpy from the
     detection_batches recipe: 256 train images at b32 with flips, 128
     val images with `area` and `iscrowd` at b64), 2 epochs and a log a
     step; `cli.train.main` runs in this process with --profile: the
     resolved config.yaml, the checkpoints of epochs 1 and 2 and one in
     `best/`, metrics.jsonl with the train losses, lr, images/s and the
     JAX package's 12 val/* keys, all finite, a profiler trace holding
     CUDA kernel events, one peak launch a validation batch, and at
     most one diagnostic warning a run (printed); then
     `--max-epochs 3` resumes at epoch 2 and trains one epoch whose steps
     continue the first run's; then `build_centernet` on `best/`, served
     in bf16 on a b64 batch: one peak launch, the detections equal to the
     plain decode's; then, where OpenCV is (the tools read image files),
     `cli.validate` and `cli.detect` on that checkpoint over 64 of the
     val images written as PNG with a COCO annotation file, and
     `cli.track` on a seeded configs/mot_tracking.yaml checkpoint over 16
     seeded 608 x 1088 frames with their MOT ground truth: one peak
     launch a batch each, the metrics' keys, finite; the CLI's train
     images/s and step ms, the packed loader's host ms a batch alone,
     each validation's seconds;
     then int8 serving and deployment (`serving_phases`): `int8_main_path`,
     the flagship (ResNet-34 FPN-256, heads 256 x 3, 80 classes, 512^2,
     bf16) quantized through `predictor.quantize` on 2 seeded uint8
     batches of 64: for every distinct int8 conv of the path, and the
     stem's 7x7 / s2 (a float StemConv, as in the JAX package), the
     card's int32 accumulators (`torch._int_mm`) == the plain version's
     on the same int8 inputs (the heads' 3x3 at 16 images, in chunks);
     the card's int8 model against its plain twin in f32 (same scales,
     TF32 off) within 1e-5 of the heads' largest magnitude; int8 scores
     within 3e-2 of bf16; one peak launch a batch and every int8 conv
     on `_int_mm`; `int8_times`: int8 and bf16 images/s at b64 (the
     engines in turn) with the int8 conv's stages (quantize, im2col,
     int_mm, dequant; profiler ranges) and both profiles; `serve_path`:
     cli/serve.py's DetectionService and HTTP server on 127.0.0.1, port
     0, over the flagship at b8, 32 PNG requests from 8 client threads
     after a warm-up round, then 8 to an int8 service: every answer
     equal to the predictor's detections of the batch it was served in,
     fewer batches than requests, one peak launch a batch, p50 / p99
     latency; `export_path`: the serving program exported with
     torch.export at b1 and b8, bf16 and int8, loaded back and run: the
     peak op (and `_int_mm` in int8) in the graph, detections bitwise
     equal to the predictor's, one peak launch a call through the loaded
     program; `int8_tracking`: configs/mot_tracking.yaml at 608 x 1088,
     b8, 160 seeded frames at depth 1 in int8 and in bf16: frames/s,
     device and association ms a frame, one peak launch a batch, and the
     count of frames whose track ids differ (no check); `convert_path`:
     a seeded Lightning-style checkpoint of the flagship through
     cli.convert_checkpoint, then build_centernet on its directory: the
     forward (f32, TF32 off) bitwise equal to `load_torch_checkpoint`'s;
     then data parallelism and the ablation tool (`parallel_phases`):
     `ddp_path`, configs/centernet.yaml from packs (128 train images at
     b32, 128 val at b64), one epoch through `cli.train` with and without
     --multihost (torchrun's variables set here: a process group of one
     over NCCL), under deterministic cuDNN: weights, BatchNorm statistics
     and val/* bitwise equal, one peak launch a validation batch, both
     runs' step ms and the gradient all-reduce's ms in a group of one;
     `ddp_two_ranks_one_card`, two gloo ranks on this card (device
     tensors; `python3 chip_smoke.py --ddp-rank R DIR`) each taking 16
     of a seeded b32 flagship batch for one SGD step, in f32 (TF32 off)
     and bf16, against one process on all 32: f32 updates within
     SGD_UPDATE_TOL, statistics within DDP_STATS_TOL in both, the bf16
     update's distance printed beside bf16's own; `ablation_smoke`,
     `cli.run_ablations --arm dcn_fast --epochs 1` on the 24-image smoke
     set in this process: the result file's keys, --report's row, the
     DCN sampler's and the peak kernel's launches;
     then DCN export, the model axis and the profile tools
     (`mesh_phases`): `dcn_export_path`, the DCN model on `dcn_fast` and
     `dcn_fused_d1` exported at b1 and b8 (bf16), loaded and run: each
     DCN layer an operator node, detections bitwise equal to the
     predictor's, a loaded call launching the DCN kernel once a layer
     and the peak kernel once; `model_axis_path`, the flagship at b8 on
     (1, 2) and (1, 4) grids of gloo ranks on this card (`python3
     chip_smoke.py --mesh-rank R WORLD DIR`; their times are host
     copies, no interconnect figure): tensor-parallel and height-split
     heads within 1e-4 of max |head| of one process's (f32, TF32 off;
     bf16 printed), no map gathered whole at 512² / 4, the gathered
     heads' top-k through the peak kernel the plain decode's, one peak
     launch a batch, a (2, 2) grid's f32 SGD step within SGD_UPDATE_TOL
     of one process's, and the grid's collectives in a group of one
     over NCCL; `profile_tools`, cli.profile_serve (bf16, --quantize)
     and cli.profile_train at small batches, their breakdowns printed;
  6. forward parity: the same f32 weights on the card (TF32 off) and on the
     CPU at batch 2, 512x512, for ResNet-34 FPN-256, for the DCN model
     on both DCN engines, and for centernet.yaml, helmet.yaml and the
     BiFPN model (statistics calibrated on the card); the max abs
     difference of the heatmap and box logits must be within 1e-4 of the
     logits' largest magnitude;
  7. train-step parity: one f32 SGD step (TF32 off) of the flagship, both
     DCN models and centernet.yaml's model at b2, 256^2 on the card and on
     the CPU from the same weights:
     losses within 1e-4, every updated tensor within 1e-4 of its largest
     magnitude, the two updates within 2^-5 of each other in L2; two AdamW
     steps, held by their losses (1e-3).

The closing lines are the card's name and power limit as nvidia-smi
prints them, then {"kernels": [...]}, then {"ok": true, "device": {...}}.
Without a card, or without the package beside it, the script exits
non-zero and prints no result.
"""
import collections
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import bench_torch

H100_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
H100_F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
FLAGSHIP = (64, 128, 128, 80)
ODD = (3, 37, 53, 7)
LVIS = (2, 32, 48, 1203)                         # LVIS's class count
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
# the max pool: the ResNet stem's map at the flagship batch, an odd map and
# a 1 x 1 one
POOL_STEM = (64, 256, 256, 64)
POOL_ODD = (3, 37, 53, 24)
POOL_ONE = (2, 1, 1, 64)
# training: the flagship recipe (configs/centernet.yaml: GIoU w5, exp box
# decode x4, AdamW 2.5e-4, wd 1e-3, norm wd 0, LinearLR warmup then cosine)
# on seeded batches of K = 128 padded boxes, about 30% valid; 5 epochs of
# 4 batches, the first epoch a warm-up
TRAIN_RECIPE = dict(box_loss="GIoULoss", box_log=True, box_multiplier=4.0,
                    box_loss_weight=5.0, image_size=(512, 512))
TRAIN_OPT = dict(optimizer="AdamW", lr=2.5e-4, weight_decay=1e-3,
                 norm_weight_decay=0.0, warmup_epochs=5, warmup_decay=0.01)
TRAIN_BATCH, TRAIN_BATCHES, TRAIN_EPOCHS = 32, 4, 5
MAX_BOXES, VALID_BOXES = 128, 0.3
# DCN model gradients through the fused kernel vs through its twin: the L2
# norm of the difference over all parameters as a share of the gradient's
# norm. The kernel's outputs differ from the twin's by about 1e-6 (f32) or
# an ulp (bf16); downstream, the ReLUs whose inputs lie that close to 0
# flip (a few hundred of some 1e8 elements in f32), and each flip moves
# the gradient at one element, so the whole gradient moves by about
# sqrt(flips / elements): on an H100, 1.6e-3 in f32 and 0.068 in bf16. The
# twins' own gradients under an input change of one rounding (2^-23 in f32,
# 2^-8 in bf16) are printed beside them as the model's sensitivity
FUSED_GRAD_TOL = {torch.float32: 1e-2, torch.bfloat16: 2.0 ** -3}
INPUT_ROUNDING = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -8}
# one f32 step on the card (TF32 off) vs the CPU, at b2 256^2: losses and
# each updated tensor, as a share of its largest magnitude (convolution and
# gradient sums in another order; 1e-4 as for the forward)
TRAIN_PARITY_SIZE = 256
# a small SGD step, so each updated tensor's difference stays a matter of
# the step's direction, which the updates' L2 difference holds apart: ReLUs
# flipped by rounding move the gradient by sqrt(flips / elements), about
# 1e-3 in f32 (as for the fused kernel's gradients)
SGD_PARITY_LR = 1e-4
SGD_UPDATE_TOL = 2.0 ** -5
ADAMW_LOSS_RTOL = 1e-3   # the second AdamW step's loss: Adam moves every
#                          weight by about lr whatever its gradient's size
# the shipped detection configs served at BATCH x SIZE^2 in bf16: the YAMLs
# as a user passes them to build_centernet, and the reference's ResNet-34
# BiFPN, built from a dict; random weights from a seed
SHIPPED = ("centernet.yaml", "helmet.yaml", "base_resnet34.yaml")
# the tracking path: configs/mot_tracking.yaml (ResNet-34, FPN-256, heads
# 256 x 3, 1 class, ReID 256 x 1 -> 64 over 2900 identities) at 608 x 1088,
# bf16, TRACK_FRAMES seeded frames of TRACK_OBJECTS moving rectangles in
# batches of TRACK_BATCH; FairMOT trained TRACK_TRAIN_STEPS steps at b8
TRACK_YAML = "mot_tracking.yaml"
TRACK_FRAMES, TRACK_OBJECTS, TRACK_BATCH, TRACK_TRAIN_STEPS = 640, 24, 8, 5
# the peak kernel at the tracking maps: one class, 608 x 1088 and CrowdHuman's
# 608 x 608 frames at stride 4
TRACK_MAPS = ((8, 152, 272, 1), (8, 152, 152, 1))
BIFPN = {"num_classes": 80, "backbone": "resnet34", "neck": "BiFPN",
         "neck_config": {"out_channels": 256},
         "head_config": {"width": 256, "depth": 3}}


def emit(obj):
    print(json.dumps(obj), flush=True)


def shipped_config(name, dtype="bfloat16"):
    """The model config of a shipped YAML (from beside this script), or of
    the BiFPN model, served at SIZE^2 in `dtype` (None: f32)."""
    from centernet_lightning_torch.train.config import load_config

    if name == "resnet34_bifpn256":
        model = dict(BIFPN)
    else:
        here = os.path.dirname(os.path.abspath(__file__))
        model = dict(load_config(os.path.join(here, "configs", name))["model"])
    model.update(image_size=[SIZE, SIZE], num_detections=100)
    model.pop("compute_dtype", None)
    if dtype:
        model["compute_dtype"] = dtype
    return {"model": model}


@torch.no_grad()
def calibrate_bn(pred, images):
    """Set every BatchNorm's running statistics to those of one train-mode
    pass over `images`, as training on data sets them. With unit
    statistics the seeded CSPDarknet's activations grow past 1e4 (no
    residual branch starts at zero, unlike the ResNets'), and the exp box
    decode of configs/centernet.yaml overflows."""
    calibrate_model_bn(pred.model, pred.prepare_images(images))


@torch.no_grad()
def calibrate_model_bn(model, x):
    """calibrate_bn on a model and its prepared input `x`."""
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in norms:
        m.momentum = 1.0
    model.train()
    try:
        model(x)
    finally:
        model.eval()
        for m in norms:
            m.momentum = 0.1


def decode_vs_plain(pred, images, k=100):
    """The head outputs of `images`, decoded through the peak kernel and
    through the plain decode (ops/decode.py) on the same maps, widened to
    f32 as the fused decode widens an fp16 map: the peak maps must be
    bitwise equal and the top-k the same (check_same_detections).
    Returns {peak_maps_equal_plain, max_abs_logit, finite, heatmap_dtype}."""
    with torch.inference_mode():
        outs = pred.model(pred.prepare_images(images))
        heat, box = outs["heatmap"], outs["box_2d"]
        heat_dtype = str(heat.dtype).replace("torch.", "")
        if heat.dtype not in (torch.float32, torch.bfloat16):
            heat = heat.float()
        same = maps_vs_plain(heat, box, pred.task.stride, k)
        return {"peak_maps_equal_plain": same,
                "max_abs_logit": heat.float().abs().max().item(),
                "finite": bool(torch.isfinite(heat).all()
                               and torch.isfinite(box).all()),
                "heatmap_dtype": heat_dtype}


def topk_of(flat, labels_map, box, stride, k=100):
    """check_same_detections' form of the top k of a peak map (logits)."""
    from centernet_lightning_torch.ops import decode as decode_ops

    out = {"flat": flat, "labels_map": labels_map}
    out["scores"], out["indices"], out["labels"] = decode_ops._topk(
        flat, labels_map, k, True)
    out["boxes"] = decode_ops.gather_and_decode_boxes(box, out["indices"],
                                                      stride=stride)
    return out


def peak_topk(heat, box, stride, k=100):
    """The top k of `heat` (logits) through the peak kernel."""
    from centernet_lightning_torch.ops import peak_decode

    return topk_of(*peak_decode.peak_class_scores_cuda(heat.contiguous(), True),
                   box, stride, k)


def maps_vs_plain(heat, box, stride, k=100):
    """Top-k of `heat` (logits, f32 or bf16) through the peak kernel and
    through the plain decode on the same maps: check_same_detections
    holds them. Returns whether the peak maps are bitwise equal."""
    from centernet_lightning_torch.ops import decode as decode_ops

    a = peak_topk(heat, box, stride, k)
    b = topk_of(*decode_ops.peak_class_scores(heat.float(), from_logits=True),
                box, stride, k)
    check_same_detections(a, b)
    return (torch.equal(a["flat"], b["flat"])
            and torch.equal(a["labels_map"], b["labels_map"]))


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
        if e.key.startswith("int8_conv."):
            continue               # quantize.py's ranges span kernels listed apart
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
    elif kind == "nan":                # NaNs inside, at a corner, on borders
        x = draw(shape)
        x[:, h // 2, w // 2, ::2] = float("nan")
        x[:, 0, 0, :] = float("nan")
        x[:, -1, 1:-1, c // 2] = float("nan")
        x[:, 1:-1, 0, -1] = float("nan")
        x[:, 1:-1, 1:-1][torch.rand((n, max(h - 2, 0), max(w - 2, 0), c),
                                    generator=gen, device=dev) < 0.01] = float("nan")
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
def draw_offset_weights(model, x, gen, offset_std=1.5, mask_std=1.0):
    """Seeded weights for every DCN offset and mask convolution (zero in a
    seeded model, which would make every offset 0 and the sampling a plain
    3x3 gather), scaled twice on the preprocessed images `x` so each
    layer's offsets have a std near `offset_std` (many pass +-1) and its
    mask logits near `mask_std` (the sigmoid stays smooth: logits of
    thousands would make it a step, and the model's output a
    near-discontinuous function of its input)."""
    blocks = dcn_blocks(model)
    convs = [(b.conv_offset, offset_std) for b in blocks]
    convs += [(b.conv_mask, mask_std) for b in blocks if b.conv_mask is not None]
    for conv, _ in convs:
        conv.weight.normal_(0.0, 1.0, generator=gen)
        conv.bias.normal_(0.0, 0.3, generator=gen)
    training = model.training
    model.eval()
    for _ in range(2):
        stds = {}
        hooks = [conv.register_forward_hook(
            lambda m, _i, out: stds.__setitem__(m, out.float().std().item()))
            for conv, _ in convs]
        model(x)
        for h in hooks:
            h.remove()
        for conv, target in convs:
            conv.weight.mul_(target / stds[conv])
            conv.bias.mul_(target / stds[conv])
    model.train(training)


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


# ---- the max pool -----------------------------------------------------

def pool_input(shape, dtype, gen, dev="cuda", misaligned=False):
    """A seeded (N, H, W, C) map with negatives and every 7th value -inf."""
    x = torch.randn(shape, generator=gen, device=dev)
    x.view(-1)[::7] = float("-inf")
    if misaligned:                     # contiguous, but not 16-byte aligned
        flat = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
        out = flat[1:].view(shape)
        out.copy_(x)
        return out
    return x.to(dtype)


def pool_library(x):
    """F.max_pool2d on the NHWC map's channels_last NCHW view."""
    return torch.nn.functional.max_pool2d(
        x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def pool_bound(n, h, w, c, elt):
    """Bytes: the input read once, the output written once. Operations: 8
    maxes per output value (f32 rate; a max is one compare)."""
    ho, wo = (h + 1) // 2, (w + 1) // 2
    moved = n * h * w * c * elt + n * ho * wo * c * elt
    return bound(moved, n * ho * wo * c * 8 / H100_F32_OPS_PER_S * 1e3)


# ---- the DCN backward --------------------------------------------------

def dcn_grads(fn, x, planes, kern, grad):
    """Gradients of fn's output . grad w.r.t. x, fy, fx, wm (and the
    kernel when `kern` is given), from fresh leaves."""
    a0, b0, *floats = planes
    leaves = [x.detach().clone().requires_grad_()]
    leaves += [p.detach().clone().requires_grad_() for p in floats]
    extra = [kern.detach().clone().requires_grad_()] if kern is not None else []
    out = fn(leaves[0], a0, b0, *leaves[1:], *extra, 1)
    return out, torch.autograd.grad(out, leaves + extra, grad)


# ---- training ------------------------------------------------------------

def detection_batches(n_batches, batch, size, num_classes, dev, seed,
                      max_ids=None):
    """CollateDetection batches made on `dev` from a seed: uint8 images of
    `size` (an int for a square, or (H, W)), MAX_BOXES padded xywh boxes an
    image inside it, about VALID_BOXES of them valid; with `max_ids`, also
    identities below it (FairMOT's `ids`)."""
    h, w = (size, size) if isinstance(size, int) else size
    extent = torch.tensor([w, h], dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(n_batches):
        wh = torch.rand((batch, MAX_BOXES, 2), generator=gen, device=dev) \
            * (extent / 2 - 8) + 8
        xy = torch.rand((batch, MAX_BOXES, 2), generator=gen, device=dev) \
            * (extent - wh)
        out.append({
            "image": torch.randint(0, 256, (batch, h, w, 3), generator=gen,
                                   device=dev, dtype=torch.uint8),
            "boxes": torch.cat([xy, wh], -1),
            "labels": torch.randint(0, num_classes, (batch, MAX_BOXES),
                                    generator=gen, device=dev, dtype=torch.int32),
            "mask": (torch.rand((batch, MAX_BOXES), generator=gen, device=dev)
                     < VALID_BOXES).float()})
        if max_ids is not None:
            out[-1]["ids"] = torch.randint(0, max_ids, (batch, MAX_BOXES),
                                           generator=gen, device=dev,
                                           dtype=torch.int32)
    return out


class EpochClock:
    """A loader over fixed batches that, as each epoch starts, waits for the
    card and records the time and the trainer's last losses; `tick()` once
    more after fit closes the last epoch."""

    def __init__(self, batches):
        self.batches, self.times, self.losses = batches, [], []
        self.trainer = None

    def __len__(self):
        return len(self.batches)

    def tick(self):
        if self.batches[0]["image"].is_cuda:
            torch.cuda.synchronize()
        self.times.append(time.perf_counter())
        last = self.trainer.last_losses if self.trainer is not None else None
        if last is not None:
            self.losses.append({k: float(v) for k, v in last.items()})

    def __iter__(self):
        self.tick()
        return iter(self.batches)

    def step_ms(self):
        """Median ms a step over the epochs after the first (warm-up)."""
        epochs = np.diff(self.times)[1:]
        return float(np.median(epochs)) / len(self.batches) * 1e3


class KeepGrads:
    """An optimizer for `make_train_step` that keeps the gradients and
    changes nothing: one step's gradients, through the real train step."""
    grads = None

    def update(self, params, grads):
        self.grads = grads


def step_grads(task, model, batch, compute_dtype):
    """(losses, gradients) of one train step of `model` on `batch`; the
    model's weights and BatchNorm statistics are left as they were."""
    from centernet_lightning_torch.train import TrainState, make_train_step

    saved = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState(model=model, tx=KeepGrads())
    state, losses = make_train_step(task, compute_dtype=compute_dtype)(state, batch)
    model.load_state_dict(saved)
    return {k: v.detach() for k, v in losses.items()}, state.tx.grads


def fit_path(task, batches, epochs, opt_cfg, dev, prepare=None):
    """A bf16 Trainer for `epochs` epochs over `batches` on `dev`;
    `prepare` (model -> None) runs on the freshly drawn weights. Returns
    the trainer, its clock and the state dict before the run."""
    from centernet_lightning_torch.train import Trainer

    clock = EpochClock(batches)
    trainer = Trainer(task, train_loader=clock, max_epochs=epochs,
                      optimizer_config=opt_cfg, image_size=(SIZE, SIZE),
                      precision="bf16", log_every=10 ** 9, device=dev,
                      logger_config={"backends": []}, diagnostics=False)
    clock.trainer = trainer
    if prepare is not None:
        prepare(trainer.state.model)
    before = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    return trainer, clock, before


def changed(model, before):
    """How many parameters, and how many BatchNorm running statistics, moved."""
    now = model.state_dict()
    names = {k for k, _ in model.named_parameters()}
    moved = {k for k, v in now.items() if v.is_floating_point()
             and not torch.equal(v, before[k])}
    stats = [k for k in now if k.endswith(("running_mean", "running_var"))]
    return {"params_changed": len(moved & names), "params": len(names),
            "bn_stats_changed": len(moved & set(stats)), "bn_stats": len(stats)}


def sgd_step_parity(cfg, batch, seed, prepare=None, dev="cuda"):
    """One f32 SGD step and two AdamW steps of the same model on the card
    (TF32 off) and on the CPU, from the same weights on the same batch:
    the losses, each updated tensor's max abs difference beside its
    largest magnitude and its largest change in the step, and the L2 norm
    of the difference of the two updates as a share of the CPU's."""
    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.train import (TrainState, make_optimizer,
                                                 make_train_step)

    preds = {"cpu": build_centernet(cfg, seed=seed, device="cpu"),
             "card": build_centernet(cfg, seed=seed, device=dev)}
    perturb_bn(preds["cpu"].model, seed + 1)
    preds["card"].model.load_state_dict(preds["cpu"].model.state_dict())
    if prepare is not None:
        prepare(preds["card"])
    start = {k: v.cpu() for k, v in preds["card"].model.state_dict().items()}
    result = {}
    for rule, steps, lr in (("SGD", 1, SGD_PARITY_LR), ("AdamW", 2, 1e-4)):
        opt = dict(optimizer=rule, lr=lr, weight_decay=1e-4, warmup_epochs=0,
                   max_epochs=1, steps_per_epoch=steps)
        after, losses = {}, {}
        for where, pred in preds.items():
            pred.model.load_state_dict(start)
            state = TrainState(model=pred.model,
                               tx=make_optimizer(pred.model, **opt))
            step = make_train_step(pred.task)
            b = {k: v.to(pred.device) for k, v in batch.items()}
            losses[where] = []
            for _ in range(steps):
                state, out = step(state, b)
                losses[where].append({k: float(v) for k, v in out.items()})
            after[where] = {k: v.cpu() for k, v in pred.model.state_dict().items()}
        worst = {"rel_to_max": 0.0, "rel_to_update": 0.0, "tensor": None}
        diff_sq = update_sq = 0.0
        for key, ref in after["cpu"].items():
            if not ref.is_floating_point():
                continue
            diff_sq += ((after["card"][key] - ref) ** 2).sum().item()
            update_sq += ((ref - start[key]) ** 2).sum().item()
            diff = (after["card"][key] - ref).abs().max().item()
            rel = diff / max(ref.abs().max().item(), 1e-30)
            upd = (ref - start[key]).abs().max().item()
            if rel > worst["rel_to_max"]:
                worst = {"rel_to_max": rel, "rel_to_update": diff / max(upd, 1e-30),
                         "tensor": key}
        loss_rel = max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-30)
                       for g, r in zip(losses["card"], losses["cpu"]) for k in r)
        result[rule] = {"steps": steps, "lr": lr, "losses": losses,
                        "loss_max_rel_diff": loss_rel, "worst_tensor": worst,
                        "update_rel_l2_diff": (diff_sq / max(update_sq, 1e-30)) ** 0.5}
    return result


# ---- tracking (configs/mot_tracking.yaml) ----------------------------------

def synth_frames(n_frames, h, w, n_objects=24, seed=0, with_boxes=False):
    """Moving bright rectangles on noise (bench_track.py's recipe): real
    association work for the tracker and distinct peaks for the decode.
    with_boxes: also each frame's rectangles as (n_objects, 4) f32 xywh
    boxes and their ids 0..n_objects-1, one array of each a frame."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(10, 50, (n_frames, h, w, 3), dtype=np.uint8)
    x = rng.uniform(0, w - 64, n_objects)
    y = rng.uniform(0, h - 64, n_objects)
    vx = rng.uniform(-4, 4, n_objects)
    vy = rng.uniform(-4, 4, n_objects)
    bw = rng.integers(24, 64, n_objects)
    bh = rng.integers(24, 64, n_objects)
    color = rng.integers(120, 255, (n_objects, 3))
    boxes = np.zeros((n_frames, n_objects, 4), np.float32)
    for f in range(n_frames):
        for i in range(n_objects):
            xi = int(x[i] + f * vx[i]) % (w - int(bw[i]))
            yi = int(y[i] + f * vy[i]) % (h - int(bh[i]))
            frames[f, yi:yi + bh[i], xi:xi + bw[i]] = color[i]
            boxes[f, i] = (xi, yi, bw[i], bh[i])
    if with_boxes:
        return frames, list(boxes), [np.arange(n_objects)] * n_frames
    return frames


def tracking_config(dtype="bfloat16"):
    """configs/mot_tracking.yaml as a user passes it (from beside this
    script), in `dtype`; its `tracker:` section."""
    from centernet_lightning_torch.train.config import load_config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configs", TRACK_YAML))
    model = dict(cfg["model"], compute_dtype=dtype)
    return {"model": model}, dict(cfg["tracker"])


def track_batches(frames):
    for s in range(0, len(frames), TRACK_BATCH):
        yield frames[s:s + TRACK_BATCH], TRACK_BATCH


def run_stream(pred, frames, tracker_cfg, depth):
    """All of `frames` through track_stream: (wall s, per-frame steps)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = list(pred.track_stream(track_batches(frames),
                                   tracker_config=tracker_cfg,
                                   pipeline_depth=depth))
    return time.perf_counter() - t0, steps


def tracking_phases(card, reset_launches, read_launches):
    """The tracking path on configs/mot_tracking.yaml at 608 x 1088, b8,
    bf16: serving through track_stream at pipeline depths 1 and 2 (phase
    `tracking_main_path`, then `tracking_times`), then FairMOT's train step
    (`tracking_train`). Returns the peak kernel's launches on the serving
    path and its times at the tracking map."""
    from centernet_lightning_torch import build_centernet, native
    from centernet_lightning_torch.models.fairmot import FairMOT
    from centernet_lightning_torch.models.tracker import Tracker
    from centernet_lightning_torch.ops import decode as decode_ops
    from centernet_lightning_torch.ops import peak_decode
    from centernet_lightning_torch.train import Trainer

    t_phase = time.perf_counter()
    cfg, tracker_cfg = tracking_config()
    tracker_cfg["min_birth_age"] = 1          # as bench_track.py serves it
    h, w = cfg["model"]["image_size"]
    k = tracker_cfg["num_detections"]
    thr = tracker_cfg["detection_threshold"]
    t0 = time.perf_counter()
    frames = synth_frames(TRACK_FRAMES, h, w, TRACK_OBJECTS)
    synth_s = time.perf_counter() - t0
    pred = build_centernet(cfg, seed=0)
    calibrate_bn(pred, frames[:TRACK_BATCH])
    native_ok = native.available()

    # seeded weights put every score near the heatmap prior (0.1), under
    # the threshold: shift the heatmap head's bias so that the median of
    # the first batch's top-k scores (peaks only: a suppressed pixel scores
    # 0) lands at the threshold
    def median_score():
        with torch.inference_mode():
            scores = pred._gather_tracking_device(
                frames[:TRACK_BATCH], num_detections=k)["scores"]
            return float(scores[scores > 0].median())

    median = median_score()
    shift = float(np.log(thr / (1 - thr)) - np.log(median / (1 - median)))
    with torch.no_grad():
        pred.model.heads["heatmap"].out_conv.bias.add_(shift)
    median_after = median_score()
    plain = decode_vs_plain(pred, frames[:TRACK_BATCH], k=k)

    # warm-up at both depths, then every frame at depth 1 and at depth 2,
    # each with the launch counts reset just before and read just after
    for depth in (1, 2):
        run_stream(pred, frames[:2 * TRACK_BATCH], tracker_cfg, depth)
    runs = {}
    for depth in (1, 2):
        reset_launches()
        wall, steps = run_stream(pred, frames, tracker_cfg, depth)
        runs[depth] = {"wall_s": wall, "steps": steps, "launches": read_launches()}
    ids_same = [s["track_ids"] for s in runs[1]["steps"]] == \
        [s["track_ids"] for s in runs[2]["steps"]]
    last = runs[1]["steps"][-1]
    n_batches = TRACK_FRAMES // TRACK_BATCH
    dets_per_frame = float(np.mean([s["num_detections"] for s in runs[1]["steps"]]))
    emit({"phase": "tracking_main_path", "config": TRACK_YAML, "card": card,
          "batch": TRACK_BATCH, "image_size": [h, w], "dtype": "bfloat16",
          "frames": TRACK_FRAMES, "objects": TRACK_OBJECTS,
          "num_detections": k, "detection_threshold": thr,
          "tracker": tracker_cfg, "params_M": sum(
              p.numel() for p in pred.model.parameters()) / 1e6,
          "heatmap_bias_shift": shift, "median_topk_score_before": median,
          "median_topk_score_after": median_after,
          "detections_into_tracker_per_frame": dets_per_frame,
          "native_available": native_ok,
          "launches": {d: r["launches"] for d, r in runs.items()},
          "track_ids_same_at_depths_1_2": ids_same,
          "tracks_alive_at_end": len(last["track_ids"]),
          "track_ids_issued": max((max(s["track_ids"], default=-1)
                                   for s in runs[1]["steps"]), default=-1) + 1,
          **plain, "decode_equal_plain": True, "frames_synth_s": synth_s,
          "phase_s": time.perf_counter() - t_phase})
    if not (native_ok and ids_same and plain["finite"]
            and plain["peak_maps_equal_plain"]):
        raise AssertionError("tracking main path check failed")
    for depth, r in runs.items():
        if len(r["steps"]) != TRACK_FRAMES:
            raise AssertionError(f"depth {depth}: {len(r['steps'])} frames")
        if r["launches"]["peak_class_scores_cuda"] != n_batches:
            raise AssertionError(f"depth {depth}: expected one peak launch a "
                                 f"batch ({n_batches}): {r['launches']}")
    if dets_per_frame < 1:
        raise AssertionError("no detection entered the tracker")

    # times: the device alone (forward + decode on frames already on the
    # card), the host's association alone (Tracker.update on the decoded
    # arrays of every batch), the H2D copy of a batch, the peak kernel at
    # the tracking map
    t_phase = time.perf_counter()
    dev_frames = pred.upload(frames[:TRACK_BATCH])
    with torch.inference_mode():
        device_ms = cuda_ms(lambda: pred._gather_tracking_device(
            dev_frames, num_detections=k), iters=20) / TRACK_BATCH
        outs = pred.model(pred.prepare_images(dev_frames))
    heat = outs["heatmap"]
    decoded = [pred.gather_tracking2d(b, num_detections=k)
               for b, _ in track_batches(frames)]
    tracker = Tracker(model=pred.gather_tracking2d, **tracker_cfg)
    t0 = time.perf_counter()
    for d in decoded:
        for i in range(TRACK_BATCH):
            tracker.update(d["bboxes"][i], d["labels"][i], d["scores"][i],
                           d["embeddings"][i])
            tracker.frame += 1
    assoc_ms = (time.perf_counter() - t0) / TRACK_FRAMES * 1e3
    host = torch.from_numpy(frames[:TRACK_BATCH])
    h2d = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.upload(host)
        torch.cuda.synchronize()
        h2d.append((time.perf_counter() - t0) * 1e3)
    pinned = host.pin_memory()
    dma_ms = cuda_ms(lambda: pinned.to("cuda", non_blocking=True), iters=10)
    # the host's share of a batch's dispatch (pin, upload, launches, D2H
    # copies queued): host clock, the card left to run
    dispatch = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred._dispatch(frames[:TRACK_BATCH], num_detections=k)
        dispatch.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: peak_decode.peak_class_scores_cuda(heat, True),
                            iters=100)
        plain_ms = cuda_ms(lambda: peak_decode.peak_class_scores_reference(
            heat, True), iters=10)
    n, mh, mw, c = heat.shape
    peak_b = bound(heat.numel() * heat.element_size() + n * mh * mw * 8,
                   heat.numel() * 10 / H100_F32_OPS_PER_S * 1e3)
    fps = {d: TRACK_FRAMES / r["wall_s"] for d, r in runs.items()}
    emit({"phase": "tracking_times", "card": card, "batch": TRACK_BATCH,
          "image_size": [h, w], "dtype": "bfloat16",
          "frames_per_s": fps, "wall_s": {d: r["wall_s"] for d, r in runs.items()},
          "device_ms_per_frame": device_ms,
          "association_ms_per_frame": assoc_ms,
          "association_tracks_at_end": len(tracker.tracks),
          "h2d_ms_per_batch": float(np.median(h2d)), "h2d_dma_ms_per_batch": dma_ms,
          "h2d_bytes_per_batch": host.numel(),
          "dispatch_host_ms_per_batch": float(np.median(dispatch)),
          "binding": max((("device", device_ms * TRACK_BATCH),
                          ("association", assoc_ms * TRACK_BATCH),
                          ("h2d", float(np.median(h2d)))), key=lambda x: x[1])[0],
          "peak_map": list(heat.shape), "peak_kernel_ms": kernel_ms,
          "peak_plain_ms": plain_ms, "peak_bound_share": peak_b["bound_ms"] / kernel_ms,
          "peak_plan": dataclasses.asdict(peak_decode.plan_for(heat)), **peak_b,
          "phase_s": time.perf_counter() - t_phase})
    del pred, outs, heat, dev_frames, frames, decoded
    torch.cuda.empty_cache()

    # FairMOT's train step: the YAML's model and optimizer (Adam, OneCycle)
    t_phase = time.perf_counter()
    fields = {k2: v for k2, v in cfg["model"].items()
              if k2 in FairMOT.__dataclass_fields__}
    task = FairMOT(**fields)
    # one seeded batch an epoch: the clock times each step
    batches = detection_batches(1, TRACK_BATCH, (h, w), 1, "cuda", 12,
                                max_ids=task.reid_config["max_track_ids"])
    clock = EpochClock(batches)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(task, train_loader=clock, max_epochs=TRACK_TRAIN_STEPS,
                      image_size=(h, w), precision="bf16", log_every=10 ** 9,
                      logger_config={"backends": []}, diagnostics=False)
    clock.trainer = trainer
    reset_launches()
    trainer.fit()
    clock.tick()
    launches = read_launches()
    steps_ms = list(np.diff(clock.times) * 1e3)
    finite = all(np.isfinite(v) for l in clock.losses for v in l.values())
    emit({"phase": "tracking_train", "config": TRACK_YAML, "card": card,
          "batch": TRACK_BATCH, "image_size": [h, w], "dtype": "bfloat16",
          "optimizer": task.optimizer_config, "steps": TRACK_TRAIN_STEPS,
          "step_ms": steps_ms, "step_ms_after_first": float(np.median(steps_ms[1:])),
          "losses": clock.losses, "reid_loss": [l["reid"] for l in clock.losses],
          "finite": finite, "launches": launches,
          "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
          "phase_s": time.perf_counter() - t_phase})
    if not (finite and len(clock.losses) == TRACK_TRAIN_STEPS):
        raise AssertionError(f"FairMOT training: {clock.losses}")
    del trainer, task, batches, clock
    torch.cuda.empty_cache()
    return {"launches": runs[1]["launches"]["peak_class_scores_cuda"],
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound": peak_b}


# ---- validation (Trainer.fit and Trainer.validate) -------------------------

# detection: VAL_IMAGES seeded images at SIZE^2 through the port's threaded
# DataLoader (VAL_WORKERS workers) and CollateDetection in batches of
# VAL_BATCH, after VAL_TRAIN_STEPS bf16 train steps at TRAIN_BATCH;
# tracking: VAL_SEQUENCES sequences of VAL_FRAMES frames of
# configs/mot_tracking.yaml in batches of TRACK_BATCH, the heatmap bias
# shifted so that the VAL_TRACK_PEAK-th peak of a frame sits at the
# tracker's threshold
VAL_IMAGES, VAL_BATCH, VAL_WORKERS, VAL_TRAIN_STEPS = 512, 64, 4, 3
VAL_SEQUENCES, VAL_FRAMES, VAL_TRACK_PEAK = 2, 160, 32
# the JAX package's val/* keys of a detection task (eval/coco_eval.py)
COCO_KEYS = ("mAP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
             "AR1", "AR10", "mAR", "AR_small", "AR_medium", "AR_large")


class RectangleImages:
    """An in-memory detection dataset: `n` seeded uint8 images of size^2,
    noise under 1-15 rectangles drawn with numpy (no OpenCV), with their
    xywh boxes, labels, `iscrowd` (about 5%) and `area` (0.6-1 of the
    box's)."""

    def __init__(self, n, size, num_classes, seed):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 40, (n, size, size, 3), dtype=np.uint8)
        self.targets = []
        for img in self.images:
            k = int(rng.integers(1, 16))
            wh = rng.uniform(8, size / 2, (k, 2))
            xy = rng.uniform(0, size - wh)
            for (x, y), (w, h), c in zip(xy.astype(int), wh.astype(int),
                                         rng.integers(100, 256, (k, 3))):
                img[y:y + h, x:x + w] = c
            self.targets.append({
                "bboxes": np.concatenate([xy, wh], 1).astype(np.float32),
                "labels": rng.integers(0, num_classes, k),
                "iscrowd": (rng.uniform(size=k) < 0.05).astype(np.int64),
                "area": (wh.prod(1) * rng.uniform(0.6, 1.0, k)).astype(np.float32)})

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], **self.targets[i], "image_id": i}


@contextlib.contextmanager
def patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def plain_decodes(stash):
    """While active, every decode of the task (ops/decode.py:
    decode_detections_auto, through the peak kernel on the card) also runs
    the plain decode (ops/decode.py:decode_detections, no kernel) on the
    same head outputs and appends its result to `stash`."""
    from centernet_lightning_torch.ops import decode as decode_ops

    real = decode_ops.decode_detections_auto

    def both(*args, **kwargs):
        out = real(*args, **kwargs)
        stash.append(decode_ops.decode_detections(*args, **kwargs))
        return out

    return patched(decode_ops, "decode_detections_auto", both)


def replayed(stash):
    """An eval step that returns `stash`'s detections in order."""
    it = iter(list(stash))
    return lambda state, batch: next(it)


def validation_phases(card, reset_launches, read_launches):
    """Validation inside the Trainer: the flagship's COCO validation in
    `Trainer.fit` (`validation_main_path`) and the MOT validation of
    configs/mot_tracking.yaml (`tracking_validation`). Each runs its
    validation once with every decode also decoded plainly, then the same
    loop on those plain detections (the metrics must be equal), then once
    more, timed. Returns the peak kernel's launches on both paths."""
    import shutil
    import tempfile

    import centernet_lightning_torch.train.trainer as trainer_mod
    from centernet_lightning_torch.data import (CollateDetection,
                                                CollateTracking, DataLoader)
    from centernet_lightning_torch.eval.coco_eval import CocoEvaluator
    from centernet_lightning_torch.models.centernet import CenterNet
    from centernet_lightning_torch.models.fairmot import FairMOT
    from centernet_lightning_torch.models.tracker import Tracker
    from centernet_lightning_torch.ops.preprocess import preprocess
    from centernet_lightning_torch.train import Trainer

    # ---- detection: ResNet-34 FPN-256, 80 classes, 512^2 ----------------
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dataset = RectangleImages(VAL_IMAGES, SIZE, 80, seed=31)
    data_s = time.perf_counter() - t0
    loader = DataLoader(dataset, batch_size=VAL_BATCH, num_workers=VAL_WORKERS,
                        collate_fn=CollateDetection())
    n_val = len(loader)
    task = CenterNet(num_classes=80, backbone="resnet34", neck="FPN",
                     neck_config={"out_channels": 256},
                     head_config={"width": 256, "depth": 3}, **TRAIN_RECIPE)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_val_")
    trainer = Trainer(
        task, train_loader=detection_batches(VAL_TRAIN_STEPS, TRAIN_BATCH, SIZE,
                                             80, "cuda", 33),
        val_loader=loader, max_epochs=1, optimizer_config=TRAIN_OPT,
        image_size=(SIZE, SIZE), precision="bf16", ckpt_dir=ckpt_dir,
        log_every=10 ** 9, logger_config={"backends": []}, diagnostics=False)
    fit_metrics, stash = [], []
    real_validate = trainer.validate
    trainer.validate = lambda: fit_metrics.append(real_validate()) or fit_metrics[-1]
    reset_launches()
    with plain_decodes(stash):
        trainer.fit()
    launches = read_launches()
    del trainer.validate
    real_step = trainer.eval_step
    trainer.eval_step = replayed(stash)
    plain_metrics = trainer.validate()
    trainer.eval_step = real_step
    # timed: the evaluator's update and metrics on the host's clock
    clock = {"update_s": 0.0, "metrics_s": 0.0}

    class TimedEvaluator(CocoEvaluator):
        def update(self, preds, targets):
            t = time.perf_counter()
            super().update(preds, targets)
            clock["update_s"] += time.perf_counter() - t

        def get_metrics(self):
            t = time.perf_counter()
            out = super().get_metrics()
            clock["metrics_s"] += time.perf_counter() - t
            return out

    reset_launches()
    t0 = time.perf_counter()
    with patched(trainer_mod, "CocoEvaluator", TimedEvaluator):
        timed_metrics = trainer.validate()
    val_s = time.perf_counter() - t0
    timed_launches = read_launches()
    stats = dict(trainer.val_stats)
    dev_images = torch.from_numpy(dataset.images[:VAL_BATCH]).cuda()
    device_ms = cuda_ms(lambda: trainer.eval_step(trainer.state,
                                                  {"image": dev_images}), iters=5)
    best = sorted(d for d in os.listdir(os.path.join(ckpt_dir, "best"))
                  if d.startswith("step_"))
    metrics = fit_metrics[0] if fit_metrics else {}
    keys_ok = set(metrics) == {f"val/{k}" for k in COCO_KEYS}
    finite = bool(metrics) and all(np.isfinite(v) for v in metrics.values())
    evaluator_ms = (clock["update_s"] + clock["metrics_s"]) / n_val * 1e3
    emit({"phase": "validation_main_path", "card": card,
          "model": "resnet34_fpn256", "image_size": SIZE, "train_batch": TRAIN_BATCH,
          "train_steps": VAL_TRAIN_STEPS, "train_dtype": "bfloat16",
          "eval_dtype": "float32", "val_images": VAL_IMAGES, "val_batch": VAL_BATCH,
          "val_batches": n_val, "loader_workers": VAL_WORKERS,
          "data_synth_s": data_s, "metrics": metrics, "keys_equal_jax_set": keys_ok,
          "finite": finite, "best_checkpoints": best,
          "launches": launches, "timed_run_launches": timed_launches,
          "metrics_equal_plain_decode": plain_metrics == metrics,
          "plain_decodes": len(stash),
          "timed_run_metrics_equal": timed_metrics == metrics,
          "val_images_per_s": stats["images"] / val_s, "val_wall_s": val_s,
          "loop_images_per_s": stats["images"] / stats["seconds"],
          "loop_wall_s": stats["seconds"],
          "device_ms_per_batch": device_ms,
          "evaluator_host_ms_per_batch": evaluator_ms,
          "evaluator_update_ms_per_batch": clock["update_s"] / n_val * 1e3,
          "evaluator_get_metrics_s": clock["metrics_s"],
          "d2h_wait_ms_per_batch": stats["wait_s"] / n_val * 1e3,
          "binding": "host" if evaluator_ms > device_ms else "device",
          "phase_s": time.perf_counter() - t_phase})
    if not (keys_ok and finite and len(fit_metrics) == 1 and len(best) == 1
            and plain_metrics == metrics and len(stash) == n_val):
        raise AssertionError("validation main path check failed")
    for name, got in (("fit", launches), ("timed", timed_launches)):
        if got["peak_class_scores_cuda"] != n_val:
            raise AssertionError(f"validation ({name}): expected one peak launch a "
                                 f"batch ({n_val}): {got}")
    det_launches = launches["peak_class_scores_cuda"]
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del trainer, task, loader, dataset, stash, dev_images
    torch.cuda.empty_cache()

    # ---- tracking: configs/mot_tracking.yaml, 608 x 1088 -----------------
    t_phase = time.perf_counter()
    cfg, tracker_cfg = tracking_config()
    h, w = cfg["model"]["image_size"]
    fields = {k: v for k, v in cfg["model"].items()
              if k in FairMOT.__dataclass_fields__}
    task = FairMOT(**fields)
    collate = CollateTracking(max_boxes=64)
    t0 = time.perf_counter()
    batches = []
    for s in range(VAL_SEQUENCES):
        frames, boxes, ids = synth_frames(VAL_FRAMES, h, w, TRACK_OBJECTS,
                                          seed=40 + s, with_boxes=True)
        items = [{"image": f, "bboxes": b, "labels": np.zeros(len(b), np.int64),
                  "ids": i + 100 * s, "sequence_id": s}
                 for f, b, i in zip(frames, boxes, ids)]
        batches += [collate(items[j:j + TRACK_BATCH])
                    for j in range(0, VAL_FRAMES, TRACK_BATCH)]
        del frames, items
    data_s = time.perf_counter() - t0
    n_val = len(batches)
    trainer = Trainer(task, val_loader=batches, image_size=(h, w),
                      precision="bf16", tracker_config=tracker_cfg,
                      log_every=10 ** 9, logger_config={"backends": []},
                      diagnostics=False)
    model = trainer.state.model
    first = torch.from_numpy(batches[0]["image"]).cuda()
    calibrate_model_bn(model, preprocess(first))
    thr = tracker_cfg["detection_threshold"]

    def kth_score():
        scores = trainer.eval_step(trainer.state, {"image": first})["scores"]
        return float(scores[:, VAL_TRACK_PEAK - 1].median())

    kth = kth_score()
    shift = float(np.log(thr / (1 - thr)) - np.log(kth / (1 - kth)))
    with torch.no_grad():
        model.heads["heatmap"].out_conv.bias.add_(shift)
    kth_after = kth_score()
    clock = {"resets": 0, "updates": 0, "update_s": 0.0, "metrics_s": 0.0}

    class CountingTracker(Tracker):
        def reset(self):
            clock["resets"] += 1
            super().reset()

        def update(self, *args, **kwargs):
            t = time.perf_counter()
            out = super().update(*args, **kwargs)
            clock["update_s"] += time.perf_counter() - t
            clock["updates"] += 1
            return out

    real_eval = trainer_mod.evaluate_mot_tracking_sequences

    def timed_eval(per_seq):
        t = time.perf_counter()
        out = real_eval(per_seq)
        clock["metrics_s"] += time.perf_counter() - t
        clock["pred_ids"] = {k: len({int(i) for f in v["pred_track_ids"] for i in f})
                             for k, v in per_seq.items()}
        clock["pred_boxes_per_frame"] = float(np.mean(
            [len(f) for v in per_seq.values() for f in v["pred_track_ids"]]))
        return out

    def run():
        for key in ("resets", "updates", "update_s", "metrics_s"):
            clock[key] = 0
        t0 = time.perf_counter()
        with patched(trainer_mod, "Tracker", CountingTracker), \
                patched(trainer_mod, "evaluate_mot_tracking_sequences", timed_eval):
            out = trainer.validate()
        clock["wall_s"] = time.perf_counter() - t0
        return out, dict(clock)

    stash = []
    reset_launches()
    with plain_decodes(stash):
        metrics, first_clock = run()
    launches = read_launches()
    real_step = trainer.eval_step
    trainer.eval_step = replayed(stash)
    plain_metrics, plain_clock = run()
    trainer.eval_step = real_step
    reset_launches()
    timed_metrics, timed_clock = run()
    timed_launches = read_launches()
    stats = dict(trainer.val_stats)
    device_ms = cuda_ms(lambda: trainer.eval_step(trainer.state, {"image": first}),
                        iters=10) / TRACK_BATCH
    names = {f"val/{p}{m}" for p in [""] + [f"seq{s}/" for s in range(VAL_SEQUENCES)]
             for m in ("MOTA", "IDF1", "HOTA")}
    finite = all(np.isfinite(v) for v in metrics.values())
    frames = stats["images"]
    emit({"phase": "tracking_validation", "card": card, "config": TRACK_YAML,
          "batch": TRACK_BATCH, "image_size": [h, w], "train_dtype": "bfloat16",
          "eval_dtype": "float32", "sequences": VAL_SEQUENCES,
          "frames_per_sequence": VAL_FRAMES, "val_batches": n_val,
          "tracker": tracker_cfg, "heatmap_bias_shift": shift,
          "kth_peak_score_before": kth, "kth_peak_score_after": kth_after,
          "data_synth_s": data_s, "metrics": metrics,
          "keys_ok": set(metrics) == names, "finite": finite,
          "tracker_resets": first_clock["resets"],
          "pred_track_ids": first_clock.get("pred_ids"),
          "reported_boxes_per_frame": first_clock.get("pred_boxes_per_frame"),
          "launches": launches, "timed_run_launches": timed_launches,
          "metrics_equal_plain_decode": plain_metrics == metrics,
          "plain_decodes": len(stash),
          "timed_run_metrics_equal": timed_metrics == metrics,
          "frames_per_s": frames / timed_clock["wall_s"],
          "val_wall_s": timed_clock["wall_s"],
          "loop_frames_per_s": frames / stats["seconds"],
          "loop_wall_s": stats["seconds"],
          "device_ms_per_frame": device_ms,
          "association_ms_per_frame": timed_clock["update_s"] / max(1, timed_clock["updates"]) * 1e3,
          "mot_metrics_s": timed_clock["metrics_s"],
          "d2h_wait_ms_per_batch": stats["wait_s"] / n_val * 1e3,
          "phase_s": time.perf_counter() - t_phase})
    if not (set(metrics) == names and finite and plain_metrics == metrics
            and len(stash) == n_val and frames == VAL_SEQUENCES * VAL_FRAMES):
        raise AssertionError("tracking validation check failed")
    if first_clock["resets"] != VAL_SEQUENCES or plain_clock["resets"] != VAL_SEQUENCES:
        raise AssertionError(f"expected {VAL_SEQUENCES} tracker resets: "
                             f"{first_clock['resets']}, {plain_clock['resets']}")
    for name, got in (("first", launches), ("timed", timed_launches)):
        if got["peak_class_scores_cuda"] != n_val:
            raise AssertionError(f"tracking validation ({name}): expected one "
                                 f"peak launch a batch ({n_val}): {got}")
    del trainer, task, batches, stash, first, model
    torch.cuda.empty_cache()
    return det_launches + launches["peak_class_scores_cuda"]


# ---- the train CLI (cli/train.py) on packs --------------------------------

# configs/centernet.yaml as shipped but for its data sections (packs of
# seeded images: CLI_TRAIN_IMAGES at CLI_TRAIN_BATCH with flips,
# CLI_VAL_IMAGES at CLI_VAL_BATCH), CLI_EPOCHS epochs, then one more on
# resume
CLI_YAML = "centernet.yaml"
CLI_TRAIN_IMAGES, CLI_TRAIN_BATCH = 256, 32
CLI_VAL_IMAGES, CLI_VAL_BATCH = 128, 64
CLI_EPOCHS = 2
# the image-reading tools (where OpenCV is): TOOL_IMAGES of the val pack
# through cli.validate and cli.detect, TOOL_FRAMES tracking frames through
# cli.track, in batches of TOOL_BATCH
TOOL_IMAGES, TOOL_FRAMES, TOOL_BATCH = 64, 16, 8


def detection_pack(out_dir, n, seed, eval_keys=False):
    """A pack of `n` seeded CollateDetection samples (detection_batches'
    recipe: uint8 SIZE^2 images, MAX_BOXES padded boxes about VALID_BOXES
    valid, the padding zeroed), with `image_id`; with `eval_keys`, also
    COCO's `area` (0.6-1 of the box) and `iscrowd` (about 5%). Written by
    data/packed.py:write_pack."""
    from centernet_lightning_torch.data.packed import write_pack

    batches = detection_batches(n // TRAIN_BATCH, TRAIN_BATCH, SIZE, 80, "cpu",
                                seed)
    arrays = {k: torch.cat([b[k] for b in batches]).numpy() for k in batches[0]}
    mask = arrays["mask"]
    arrays["boxes"] *= mask[..., None]
    arrays["labels"] *= mask.astype(np.int32)
    arrays["image_id"] = np.arange(n, dtype=np.int64)
    if eval_keys:
        rng = np.random.default_rng(seed)
        wh = arrays["boxes"][..., 2:]
        arrays["area"] = (wh.prod(-1) * rng.uniform(0.6, 1.0, mask.shape)
                          * mask).astype(np.float32)
        arrays["iscrowd"] = ((rng.uniform(size=mask.shape) < 0.05)
                             * mask).astype(np.int32)
    write_pack(out_dir, arrays)
    return arrays


def captured_json(fn, argv):
    """Run a CLI's `main(argv)` in this process: its last stdout line as
    JSON."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    if rc != 0:
        raise AssertionError(f"{fn.__module__} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def cli_tools(work, best_dir, val, reset_launches, read_launches, device):
    """The image-reading tools on the card (they need OpenCV): images of
    the val pack written as PNG with a COCO annotation file, through
    `cli.validate` and `cli.detect` on the train CLI's best checkpoint;
    TOOL_FRAMES seeded 608 x 1088 frames with their MOT ground truth
    through `cli.track` on a seeded configs/mot_tracking.yaml checkpoint.
    One peak launch a batch each. Returns (results, checks, launches)."""
    import cv2

    from centernet_lightning_torch.cli import detect as cli_detect
    from centernet_lightning_torch.cli import track as cli_track
    from centernet_lightning_torch.cli import validate as cli_validate
    from centernet_lightning_torch.models.fairmot import FairMOT
    from centernet_lightning_torch.train.checkpoint import save_checkpoint

    img_dir = os.path.join(work, "coco", "images")
    os.makedirs(img_dir)
    images, annotations = [], []
    for i in range(TOOL_IMAGES):
        name = f"{i:06d}.png"
        cv2.imwrite(os.path.join(img_dir, name),
                    cv2.cvtColor(val["image"][i], cv2.COLOR_RGB2BGR))
        images.append({"id": i + 1, "file_name": name, "width": SIZE,
                       "height": SIZE})
        for k in np.flatnonzero(val["mask"][i]):
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1,
                "category_id": int(val["labels"][i, k]) + 1,
                "bbox": [float(v) for v in val["boxes"][i, k]],
                "area": float(val["area"][i, k]),
                "iscrowd": int(val["iscrowd"][i, k])})
    ann = os.path.join(work, "coco", "annotations.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": [{"id": c + 1, "name": str(c)}
                                  for c in range(80)]}, f)
    batches = -(-TOOL_IMAGES // TOOL_BATCH)
    results, launches, times = {}, {}, {}
    dev = ["--device", device, "--batch-size", str(TOOL_BATCH)]

    def run(name, fn, argv):
        reset_launches()
        t = time.perf_counter()
        results[name] = captured_json(fn, argv + dev)
        times[name] = time.perf_counter() - t
        launches[name] = read_launches()["peak_class_scores_cuda"]

    run("validate", cli_validate.main,
        ["--checkpoint", best_dir, "--img-dir", img_dir, "--ann-json", ann,
         "--image-size", str(SIZE),
         "--save-results", os.path.join(work, "coco", "results.json")])
    run("detect", cli_detect.main,
        ["--checkpoint", best_dir, "--images", img_dir, "--score-threshold",
         "0.0", "--out", os.path.join(work, "detect"), "--save-images"])

    # tracking: a seeded FairMOT checkpoint of configs/mot_tracking.yaml
    cfg, _ = tracking_config(dtype=None)
    h, w = cfg["model"]["image_size"]
    task = FairMOT(**{k: v for k, v in cfg["model"].items()
                      if k in FairMOT.__dataclass_fields__})
    task.init(torch.Generator().manual_seed(5))
    track_ckpt = os.path.join(work, "track_ckpt")
    save_checkpoint(track_ckpt, {"model": task.model.state_dict(), "step": 0},
                    hparams=task.hparams, step=0)
    del task
    frames, boxes, ids = synth_frames(TOOL_FRAMES, h, w, TRACK_OBJECTS,
                                      seed=61, with_boxes=True)
    seq = os.path.join(work, "mot", "SYNTH-01")
    os.makedirs(os.path.join(seq, "img1"))
    os.makedirs(os.path.join(seq, "gt"))
    lines = []
    for f, (frame, fb, fi) in enumerate(zip(frames, boxes, ids), start=1):
        cv2.imwrite(os.path.join(seq, "img1", f"{f:06d}.png"),
                    cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        lines += [f"{f},{i + 1},{x:.1f},{y:.1f},{bw:.1f},{bh:.1f},1,1,1"
                  for (x, y, bw, bh), i in zip(fb, fi)]
    with open(os.path.join(seq, "gt", "gt.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(seq, "seqinfo.ini"), "w") as f:
        f.write(f"[Sequence]\nname=SYNTH-01\nimDir=img1\nframeRate=30\n"
                f"seqLength={TOOL_FRAMES}\nimWidth={w}\nimHeight={h}\n"
                f"imExt=.png\n")
    run("track", cli_track.main,
        ["--checkpoint", track_ckpt, "--frames", os.path.join(seq, "img1"),
         "--out", os.path.join(work, "track"),
         "--eval-gt", os.path.join(work, "mot"), "--seq", "SYNTH-01",
         "--tracker", "detection_threshold=0.0", "min_birth_age=1",
         "num_detections=32"])
    def finite(d):
        return all(np.isfinite(v) for v in d.values() if isinstance(v, float))

    checks = {
        "validate_keys": set(results["validate"]) == set(COCO_KEYS),
        "validate_finite": finite(results["validate"]),
        "detect_images": results["detect"]["images"] == TOOL_IMAGES,
        "detect_saved": len(os.listdir(os.path.join(work, "detect", "images")))
        == TOOL_IMAGES,
        "track_frames": results["track"]["frames"] == TOOL_FRAMES,
        "track_metrics": {"HOTA", "MOTA", "IDF1"} <= set(results["track"])
        and finite(results["track"]),
        "peak_launches": launches == {
            "validate": batches, "detect": batches,
            "track": -(-TOOL_FRAMES // TOOL_BATCH)},
    }
    return {"results": results, "seconds": times}, checks, launches


def cli_phases(card, reset_launches, read_launches, device="cuda"):
    """`cli_main_path`: configs/centernet.yaml trained from packs by the
    train CLI in this process (`cli.train.main`, with --profile), resumed
    for one more epoch, then served from its best checkpoint, then the
    image-reading tools where OpenCV is (`cli_tools`). Returns the peak
    kernel's launches."""
    import shutil
    import tempfile
    import warnings

    import yaml

    from centernet_lightning_torch import CenterNetPredictor, build_centernet
    from centernet_lightning_torch.cli import train as cli_train
    from centernet_lightning_torch.data.packed import PackedLoader
    from centernet_lightning_torch.train import Trainer
    from centernet_lightning_torch.train.checkpoint import load_checkpoint
    from centernet_lightning_torch.train.config import load_config

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    t0 = time.perf_counter()
    train_dir, val_dir = os.path.join(work, "train"), os.path.join(work, "val")
    detection_pack(train_dir, CLI_TRAIN_IMAGES, seed=51)
    val = detection_pack(val_dir, CLI_VAL_IMAGES, seed=52, eval_keys=True)
    pack_s = time.perf_counter() - t0
    pack_mb = sum(os.path.getsize(os.path.join(d, f)) for d in (train_dir, val_dir)
                  for f in os.listdir(d)) / 1e6

    # the shipped YAML; only the data sections become packs (each keeps its
    # transforms' Normalize, which the predictor reads), 2 epochs, a log a step
    here = os.path.dirname(os.path.abspath(__file__))
    config = load_config(os.path.join(here, "configs", CLI_YAML))
    model = config["model"]

    def packed(section, pack_dir, batch, **extra):
        norm = [t for t in model[section].get("transforms", [])
                if t.get("name") == "Normalize"]
        return {"type": "packed", "data_dir": pack_dir, "batch_size": batch,
                "transforms": norm, **extra}

    model["train_data"] = packed("train_data", train_dir, CLI_TRAIN_BATCH,
                                 flip_p=0.5)
    model["val_data"] = packed("val_data", val_dir, CLI_VAL_BATCH)
    config["trainer"].update(max_epochs=CLI_EPOCHS, log_every_n_steps=1)
    yaml_path = os.path.join(work, CLI_YAML)
    with open(yaml_path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)
    run_dir = os.path.join(work, "run")
    argv = ["--config", yaml_path, "--workdir", run_dir, "--device", device]

    # each validation timed on the host's clock (it ends on the host)
    val_s = []
    real_validate = Trainer.validate

    def timed_validate(self):
        t = time.perf_counter()
        out = real_validate(self)
        val_s.append(time.perf_counter() - t)
        return out

    def run(extra):
        with warnings.catch_warnings(record=True) as caught, \
                patched(Trainer, "validate", timed_validate):
            warnings.simplefilter("always")
            reset_launches()
            t = time.perf_counter()
            rc = cli_train.main(argv + extra)
            wall = time.perf_counter() - t
            launches = read_launches()
        return rc, wall, launches, [f"{w.category.__name__}: {w.message}"
                                    for w in caught]

    ckpt_dir = os.path.join(run_dir, "checkpoints")

    def saved_epochs():
        return sorted(load_checkpoint(os.path.join(ckpt_dir, d))[0]["epoch"]
                      for d in os.listdir(ckpt_dir) if d.startswith("step_"))

    rc1, wall1, launches1, warned1 = run(["--profile"])
    n_val = -(-CLI_VAL_IMAGES // CLI_VAL_BATCH)
    steps = CLI_TRAIN_IMAGES // CLI_TRAIN_BATCH
    epochs_saved = saved_epochs()
    best = [d for d in os.listdir(os.path.join(ckpt_dir, "best"))
            if d.startswith("step_")]
    log_path = os.path.join(run_dir, "logs", "metrics.jsonl")
    with open(log_path) as f:
        rows1 = [json.loads(line) for line in f]
    train_rows = [r for r in rows1 if "train/total_loss" in r]
    val_rows = [r for r in rows1 if "val/mAP" in r]
    train_keys = {"train/heatmap_loss", "train/box_2d_loss", "train/total_loss",
                  "train/lr", "train/images_per_sec"}
    finite = all(np.isfinite(v) for r in rows1 for k, v in r.items()
                 if k != "time")
    # the CLI's step: the host clock between consecutive logged steps of
    # the last epoch (each log reads the losses, so each step ends synced)
    last = [r["time"] for r in train_rows[-steps:]]
    step_ms = float(np.median(np.diff(last))) * 1e3
    traces = os.listdir(os.path.join(ckpt_dir, "profile"))
    trace_path = os.path.join(ckpt_dir, "profile", traces[0]) if traces else None
    kernel_events, kernel_us = 0, 0.0
    if trace_path:
        with open(trace_path) as f:
            events = [e for e in json.load(f).get("traceEvents", [])
                      if e.get("cat") == "kernel"]
        kernel_events = len(events)
        kernel_us = sum(float(e.get("dur", 0)) for e in events)
        del events
    diag = [w for w in warned1 if "diagnostic logging" in w]
    checks1 = {
        "rc": rc1 == 0,
        "config_yaml": os.path.isfile(os.path.join(run_dir, "config.yaml")),
        "epoch_checkpoints": epochs_saved == list(range(1, CLI_EPOCHS + 1)),
        "best": len(best) == 1,
        "train_keys": all(train_keys <= set(r) for r in train_rows)
        and len(train_rows) == CLI_EPOCHS * steps,
        "val_keys": [set(k for k in r if k.startswith("val/")) for r in val_rows]
        == [{f"val/{k}" for k in COCO_KEYS}] * CLI_EPOCHS,
        "finite": finite,
        "profile_trace_kernels": kernel_events > 0,
        "peak_launches": launches1["peak_class_scores_cuda"] == CLI_EPOCHS * n_val,
        # a failed diagnostic warns once a run and training goes on
        "diagnostics_warned_at_most_once": len(diag) <= 1,
    }

    # resume: one more epoch, the steps continuing the first run's
    rc2, wall2, launches2, warned2 = run(["--max-epochs", str(CLI_EPOCHS + 1)])
    with open(log_path) as f:
        rows2 = [json.loads(line) for line in f][len(rows1):]
    resumed_steps = [r["step"] for r in rows2 if "train/total_loss" in r]
    epochs_after = saved_epochs()
    checks2 = {
        "rc": rc2 == 0,
        "one_epoch_continuing": resumed_steps == list(
            range(CLI_EPOCHS * steps + 1, (CLI_EPOCHS + 1) * steps + 1)),
        "epoch_checkpoint": epochs_after[-1] == CLI_EPOCHS + 1,
        "validated_once": sum("val/mAP" in r for r in rows2) == 1,
        "peak_launches": launches2["peak_class_scores_cuda"] == n_val,
        "diagnostics_warned_at_most_once": sum(
            "diagnostic logging" in w for w in warned2) <= 1,
    }

    # the packed loader alone, one epoch after a warm one (page cache)
    loader = PackedLoader(train_dir, batch_size=CLI_TRAIN_BATCH, shuffle=True,
                          flip_p=0.5)
    for _ in loader:
        pass
    t = time.perf_counter()
    n_batches = sum(1 for _ in loader)
    loader_ms = (time.perf_counter() - t) / n_batches * 1e3

    # serving from the best checkpoint, bf16, one batch of the val pack
    best_pred = build_centernet(os.path.join(ckpt_dir, "best"), device=device)
    pred = CenterNetPredictor(best_pred.task, image_size=best_pred.image_size,
                              mean=best_pred.mean, std=best_pred.std,
                              compute_dtype="bfloat16", device=device)
    images = val["image"][:CLI_VAL_BATCH]
    reset_launches()
    dets = pred.gather_detection2d(images)
    launches3 = read_launches()
    plain = decode_vs_plain(pred, images)
    checks3 = {
        "shapes": dets["bboxes"].shape
        == (CLI_VAL_BATCH, pred.task.num_detections, 4),
        "finite": all(bool(np.isfinite(dets[k]).all())
                      for k in ("bboxes", "scores")),
        "peak_maps_equal_plain": plain["peak_maps_equal_plain"],
        "peak_launches": launches3["peak_class_scores_cuda"] == 1,
    }
    try:
        import cv2  # noqa: F401  (the tools read image files)
    except ImportError:
        tools, checks4, launches4 = {"skipped": "no OpenCV"}, {}, {}
    else:
        tools, checks4, launches4 = cli_tools(
            work, os.path.join(ckpt_dir, "best"), val, reset_launches,
            read_launches, device)
    emit({"phase": "cli_main_path", "card": card, "config": CLI_YAML,
          "dtype": "bfloat16", "image_size": SIZE,
          "train_images": CLI_TRAIN_IMAGES, "train_batch": CLI_TRAIN_BATCH,
          "val_images": CLI_VAL_IMAGES, "val_batch": CLI_VAL_BATCH,
          "epochs": CLI_EPOCHS, "steps_per_epoch": steps,
          "pack_s": pack_s, "pack_MB": pack_mb,
          "train_images_per_s": CLI_TRAIN_BATCH / step_ms * 1e3,
          "train_step_ms": step_ms,
          "logged_images_per_sec": [r["train/images_per_sec"]
                                    for r in train_rows[steps - 1::steps]],
          "loader_ms_per_batch": loader_ms,
          "loader_share_of_step": loader_ms / step_ms,
          "val_s": val_s, "first_run_s": wall1, "resume_run_s": wall2,
          "val_metrics": {k: v for k, v in val_rows[-1].items()
                          if k.startswith("val/")} if val_rows else None,
          "last_losses": {k: v for k, v in train_rows[-1].items()
                          if k.endswith("_loss")} if train_rows else None,
          "profile_trace": trace_path and os.path.basename(trace_path),
          "profile_trace_MB": trace_path and os.path.getsize(trace_path) / 1e6,
          "profile_kernel_events": kernel_events,
          # the first epoch's kernels (under the profiler), a step
          "profile_device_ms_per_step": kernel_us / 1e3 / steps,
          "warnings": {"train": dict(collections.Counter(warned1)),
                       "resume": dict(collections.Counter(warned2))},
          "launches": {"train": launches1, "resume": launches2,
                       "serve": launches3, "tools": launches4},
          "checks": {"train": checks1, "resume": checks2, "serve": checks3,
                     "tools": checks4},
          "tools": tools,
          "serve_plain": plain, "phase_s": time.perf_counter() - t_phase})
    failed = [f"{part}.{k}" for part, c in (("train", checks1), ("resume", checks2),
                                            ("serve", checks3), ("tools", checks4))
              for k, ok in c.items() if not ok]
    if failed:
        raise AssertionError(f"cli main path checks failed: {failed}")
    shutil.rmtree(work, ignore_errors=True)
    del best_pred, pred
    if device == "cuda":
        torch.cuda.empty_cache()
    return (launches1["peak_class_scores_cuda"] + launches2["peak_class_scores_cuda"]
            + launches3["peak_class_scores_cuda"] + sum(launches4.values()))


# ---- int8 serving and deployment (cli/serve.py, cli/export.py,
# cli/convert_checkpoint.py) ------------------------------------------------
FLAGSHIP_CFG = {"num_classes": 80, "backbone": "resnet34", "neck": "FPN",
                "neck_config": {"out_channels": 256},
                "head_config": {"width": 256, "depth": 3},
                "num_detections": 100, "image_size": [SIZE, SIZE]}
INT8_CALIB_BATCHES = 2          # seeded uint8 batches of BATCH images
INT8_SCORE_TOL = 3e-2           # the JAX predictor test's score tolerance
INT8_JAX_HEAD_TOL = 0.05        # the JAX package's int8-vs-float bound, x max |head|
INT8_PLAIN_TOL = 1e-5           # card vs plain int8 model, f32, x max |head|
INT8_CHECK_IMAGES, INT8_CHUNK_IMAGES = 2, 16
INT8_HEAD_IMAGES = 4            # images of the head comparisons (b), (c)
INT8_TRACK_FRAMES = 160
SERVE_BATCH, SERVE_REQUESTS, SERVE_CLIENTS, SERVE_INT8_REQUESTS = 8, 256, 8, 256
EXPORT_BATCHES = (1, 8)


def conv_signature(m, x):
    """(kernel, stride, C in, C out, H, W) of an Int8Conv2d call."""
    return (m.kernel_size[0], m.stride[0], m.in_channels, m.out_channels,
            x.shape[2], x.shape[3])


def captured_int8_inputs(qmodel, x):
    """One forward of `qmodel` on `x`: the input of the first call of each
    distinct Int8Conv2d signature, {signature: (module, input)}."""
    from centernet_lightning_torch.quantize import Int8Conv2d

    seen = {}

    def hook(m, args):
        seen.setdefault(conv_signature(m, args[0]), (m, args[0]))

    handles = [m.register_forward_pre_hook(hook) for m in qmodel.modules()
               if isinstance(m, Int8Conv2d)]
    try:
        with torch.inference_mode():
            qmodel(x)
    finally:
        for h in handles:
            h.remove()
    return seen


def int32_vs_plain(x_q, w_q, stride, pads, groups=1):
    """The card's int32 accumulators against the plain version's on the
    same int8 inputs: (equal, max |diff|, entries)."""
    from centernet_lightning_torch import quantize as tq

    with torch.inference_mode():
        got = tq.int8_conv_mm(x_q, w_q, stride, pads, (1, 1), groups)
        want = tq.int8_conv_plain(x_q, w_q, stride, pads, (1, 1), groups)
    torch.cuda.synchronize()
    n, _, ho, wo = got.shape
    k = w_q.shape[1] * w_q.shape[2] * w_q.shape[3]
    per_chunk = max(1, tq.IM2COL_BYTES // (ho * wo * (-(-k // 8) * 8)))
    return {"int32_equal": torch.equal(got, want),
            "max_abs_diff": int((got - want).abs().max().item()),
            "entries": got.numel(), "chunks": -(-n // per_chunk)}


def stage_breakdown(fn, iters, wall_ms):
    """Device ms a call of the int8 conv's stages (the profiler ranges of
    quantize.py: quantize, im2col, int_mm, dequant), beside the whole
    breakdown by kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    stages = {}
    for e in prof.key_averages():
        if e.key.startswith("int8_conv."):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = getattr(e, "cuda_time_total", 0)
            stages[e.key.split(".", 1)[1]] = {"ms": us / iters / 1e3,
                                              "calls": e.count / iters}
    return stages


def live_flagship(images):
    """The seeded flagship in f32 with live outputs: BatchNorm statistics
    from one train-mode pass over `images` (calibrate_bn), and the heatmap
    bias shifted so that the median of the top-100 scores is 0.3. As drawn
    (unit statistics) the heatmap logits spread so far that every top-100
    score is within 1e-4 of 1, and no comparison of scores can fail.
    Returns the predictor and the top-100 scores before and after."""
    from centernet_lightning_torch import build_centernet

    f32 = build_centernet({"model": dict(FLAGSHIP_CFG)}, seed=0)
    raw = f32.gather_detection2d(images)["scores"]
    calibrate_bn(f32, images)
    median = float(np.median(f32.gather_detection2d(images)["scores"]))
    with torch.no_grad():
        f32.model.heads["heatmap"].out_conv.bias.add_(
            float(np.log(0.3 / 0.7) - np.log(median / (1 - median))))
    return f32, raw, f32.gather_detection2d(images)["scores"]


def head_gaps(a, b):
    """max |a - b| / max |b| of the heatmap and box heads, in f32."""
    return {k: (a[k].float() - b[k].float()).abs().max().item()
            / max(b[k].float().abs().max().item(), 1e-30)
            for k in ("heatmap", "box_2d")}


def int8_main_path(card, reset_launches, read_launches):
    """`int8_main_path`: the flagship in bf16 (live outputs, `live_flagship`)
    quantized on seeded batches, its conv shapes, its card-vs-plain model
    check, its heads and detections against bf16, one peak launch a batch,
    and both images/s. Returns the bf16 and int8 predictors and the peak
    launches."""
    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch import quantize as tq
    from centernet_lightning_torch.api import QuantizedCenterNetPredictor

    t_phase = time.perf_counter()
    cfg = {"model": dict(FLAGSHIP_CFG, compute_dtype="bfloat16")}
    gen = torch.Generator().manual_seed(21)
    draw = lambda: torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen,  # noqa: E731
                                 dtype=torch.uint8).numpy()
    calib = [draw() for _ in range(INT8_CALIB_BATCHES)]
    images = draw()
    f32, raw_scores, live_scores = live_flagship(images)
    pred = build_centernet(cfg, seed=0)
    pred.model.load_state_dict(f32.model.state_dict())      # cast to bf16
    t0 = time.perf_counter()
    qpred = pred.quantize(calib)
    calib_s = time.perf_counter() - t0
    n_int8 = sum(isinstance(m, tq.Int8Conv2d) for m in qpred.model.modules())

    # (d) the int8 main path, one batch: one peak launch
    reset_launches()
    tq.Int8Conv2d.card_calls = 0
    t0 = time.perf_counter()
    dets = qpred.gather_detection2d(images)
    first_s = time.perf_counter() - t0
    launches = read_launches()
    mm_calls = tq.Int8Conv2d.card_calls
    ref = pred.gather_detection2d(images)
    score_diff = float(np.abs(dets["scores"] - ref["scores"]).max())
    finite = all(bool(np.isfinite(dets[k]).all()) for k in ("bboxes", "scores"))

    # (a) every distinct int8 conv signature of the path, and the stem's
    # 7x7 / s2 (a float StemConv in both packages, not a target), int32
    # accumulators on the card == the plain version's on the same inputs
    dev = torch.from_numpy(images).cuda()
    x_small = pred.prepare_images(dev[:INT8_CHUNK_IMAGES])
    seen = captured_int8_inputs(qpred.model, x_small)
    shapes = []
    for sig, (m, x) in sorted(seen.items()):
        n = INT8_CHUNK_IMAGES if (sig[0], sig[2], sig[4]) == (3, 256, SIZE // 4) \
            and sig[3] == 256 else INT8_CHECK_IMAGES
        x_q = tq.quantize_activation(x[:n], m.x_scale)
        shapes.append({"kernel": sig[0], "stride": sig[1], "c_in": sig[2],
                       "c_out": sig[3], "hw": list(sig[4:]), "images": n,
                       **int32_vs_plain(x_q, m.weight_oihw(), m.stride,
                                        m.pads(x.shape[2], x.shape[3]))})
    stem = pred.model.backbone.conv1
    with torch.inference_mode():
        xs = pred.prepare_images(dev[:INT8_CHECK_IMAGES]).permute(0, 3, 1, 2)
        s_x = torch.tensor([xs.float().abs().max().item() / 127.0], device="cuda")
        w_q = tq.quantize_conv_params(torch.nn.ModuleDict({"s": stem}),
                                      {"s": 1.0})["s"]["w"].cuda()
        x_q = tq.quantize_activation(xs, s_x)
    shapes.append({"kernel": 7, "stride": 2, "c_in": 3, "c_out": stem.out_channels,
                   "hw": [SIZE, SIZE], "images": INT8_CHECK_IMAGES,
                   "stem_not_a_target": True,
                   **int32_vs_plain(x_q, w_q, (2, 2), (3, 3, 3, 3))})
    del seen, x_small

    # (b) the card's int8 model against the plain version of the same
    # quantized model (the same scales, f32 weights, TF32 off), heads
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        qf32 = tq.quantize_model(f32.model, act_scales=qpred.act_scales)
        with torch.inference_mode():
            x4 = f32.prepare_images(dev[:INT8_HEAD_IMAGES])
            card_out = qf32(x4)
            for m in qf32.modules():
                if isinstance(m, tq.Int8Conv2d):
                    m.plain = True
            plain_out = qf32(x4)
            float_out = f32.model(x4)
        torch.cuda.synchronize()
        vs_plain = {}
        for key in ("heatmap", "box_2d"):
            d = (card_out[key] - plain_out[key]).abs().max().item()
            mag = plain_out[key].abs().max().item()
            vs_plain[key] = {"max_abs_err": d, "max_abs": mag,
                             "rel_to_max": d / max(mag, 1e-30),
                             "bitwise_equal": torch.equal(card_out[key],
                                                          plain_out[key])}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    # (c) int8 against bf16 on live heads. int8 serving (bf16) - bf16 serving
    # = (int8 bf16 - int8 f32) + (int8 f32 - float f32) + (float f32 - bf16):
    # the int8 scheme's own drift (plain int8 vs float, both f32: the JAX
    # package's arithmetic, held to it on the CPU) plus bf16's drift, once
    # in each model, all measured here on the same images. A wrong weight
    # scale, bias or weight layout moves a head by about its own size
    with torch.inference_mode():
        xb = pred.prepare_images(dev[:INT8_HEAD_IMAGES])
        bf16_out = pred.model(xb)
        serve_gap = head_gaps(qpred.model(xb), bf16_out)
    algo_gap = head_gaps(plain_out, float_out)
    bf16_gap = head_gaps(bf16_out, float_out)
    vs_bf16 = {k: {"int8_vs_bf16": serve_gap[k], "int8_scheme_f32": algo_gap[k],
                   "bf16_vs_f32": bf16_gap[k],
                   "bound": algo_gap[k] + 2 * bf16_gap[k],
                   "within_jax_bound": serve_gap[k] < INT8_JAX_HEAD_TOL}
               for k in serve_gap}
    del f32, qf32, card_out, plain_out, float_out, bf16_out, x4, xb
    torch.cuda.empty_cache()

    checks = {"quantized_predictor": isinstance(qpred, QuantizedCenterNetPredictor),
              "shapes_ok": dets["bboxes"].shape == (BATCH, 100, 4),
              "finite": finite,
              "int32_equal_every_shape": all(s["int32_equal"] for s in shapes),
              "card_vs_plain_model": all(v["rel_to_max"] <= INT8_PLAIN_TOL
                                         for v in vs_plain.values()),
              "live_scores": float(np.min(live_scores)) < 0.9,
              "heads_vs_bf16": all(v["int8_vs_bf16"] <= v["bound"]
                                   for v in vs_bf16.values()),
              "one_peak_launch": launches["peak_class_scores_cuda"] == 1,
              "every_int8_conv_on_int_mm": mm_calls == n_int8}
    emit({"phase": "int8_main_path", "card": card, "config": cfg["model"],
          "batch": BATCH, "calibration_batches": INT8_CALIB_BATCHES,
          "calibration_s": calib_s, "int8_convs": n_int8,
          "float_convs": sum(type(m).__name__ in ("Conv2d", "StemConv",
                                                  "SameConv2d")
                             for m in qpred.model.modules()),
          "first_call_s": first_s, "launches": launches,
          "int8_card_calls": mm_calls, "conv_shapes": shapes,
          "card_vs_plain_f32": vs_plain, "plain_tolerance": INT8_PLAIN_TOL,
          "top100_scores_as_drawn": {"min": float(np.min(raw_scores)),
                                     "median": float(np.median(raw_scores))},
          "top100_scores_live": {"min": float(np.min(live_scores)),
                                 "median": float(np.median(live_scores)),
                                 "max": float(np.max(live_scores))},
          "heads_vs_bf16": vs_bf16, "jax_head_bound": INT8_JAX_HEAD_TOL,
          "max_score_diff_vs_bf16": score_diff, "jax_score_tolerance": INT8_SCORE_TOL,
          "scores_within_jax_tolerance": score_diff <= INT8_SCORE_TOL,
          "checks": checks, "phase_s": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise AssertionError(f"int8 main path checks failed: "
                             f"{[k for k, v in checks.items() if not v]}")

    # (e) images/s, int8 and bf16 in turn, and the int8 stages on the card
    t_phase = time.perf_counter()
    e2e = repeated_ms({"bfloat16": lambda: pred.detect(dev),
                       "int8": lambda: qpred.detect(dev)}, reps=3, iters=5)
    for t in e2e.values():
        t["images_per_s"] = BATCH / t["median_ms"] * 1e3
    int8_ms = e2e["int8"]["median_ms"]
    emit({"phase": "int8_times", "card": card, "batch": BATCH,
          "image_size": SIZE, "e2e": e2e,
          "int8_over_bf16": e2e["int8"]["images_per_s"]
          / e2e["bfloat16"]["images_per_s"],
          "int8_stages": stage_breakdown(lambda: qpred.detect(dev), 2, int8_ms),
          "int8_profile": device_breakdown(lambda: qpred.detect(dev), iters=2,
                                           wall_ms=int8_ms, top=20),
          "bf16_profile": device_breakdown(lambda: pred.detect(dev), iters=2,
                                           wall_ms=e2e["bfloat16"]["median_ms"],
                                           top=8),
          "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
          "phase_s": time.perf_counter() - t_phase})
    del dev
    torch.cuda.empty_cache()
    return pred, qpred, launches["peak_class_scores_cuda"]


def int8_tracking(card, reset_launches, read_launches):
    """`int8_tracking`: configs/mot_tracking.yaml at 608 x 1088, b8,
    quantized on two seeded batches of frames, over INT8_TRACK_FRAMES
    frames at depth 1, beside the same stream in bf16. Returns the peak
    launches of the int8 stream."""
    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.models.tracker import Tracker

    t_phase = time.perf_counter()
    cfg, tracker_cfg = tracking_config()
    tracker_cfg["min_birth_age"] = 1
    h, w = cfg["model"]["image_size"]
    k = tracker_cfg["num_detections"]
    thr = tracker_cfg["detection_threshold"]
    frames = synth_frames(INT8_TRACK_FRAMES, h, w, TRACK_OBJECTS, seed=3)
    pred = build_centernet(cfg, seed=0)
    calibrate_bn(pred, frames[:TRACK_BATCH])
    with torch.inference_mode():     # peaks' median at the threshold
        scores = pred._gather_tracking_device(frames[:TRACK_BATCH],
                                              num_detections=k)["scores"]
        median = float(scores[scores > 0].median())
    with torch.no_grad():
        pred.model.heads["heatmap"].out_conv.bias.add_(
            float(np.log(thr / (1 - thr)) - np.log(median / (1 - median))))
    qpred = pred.quantize([frames[:TRACK_BATCH], frames[TRACK_BATCH:2 * TRACK_BATCH]])
    n_batches = INT8_TRACK_FRAMES // TRACK_BATCH
    run_stream(qpred, frames[:2 * TRACK_BATCH], tracker_cfg, 1)   # warm-up
    run_stream(pred, frames[:2 * TRACK_BATCH], tracker_cfg, 1)
    reset_launches()
    wall_q, steps_q = run_stream(qpred, frames, tracker_cfg, 1)
    launches = read_launches()
    wall_f, steps_f = run_stream(pred, frames, tracker_cfg, 1)
    differ = sum(a["track_ids"] != b["track_ids"] for a, b in zip(steps_q, steps_f))
    dev_frames = pred.upload(frames[:TRACK_BATCH])
    with torch.inference_mode():
        device_ms = {name: cuda_ms(lambda p=p: p._gather_tracking_device(
            dev_frames, num_detections=k), iters=10) / TRACK_BATCH
            for name, p in (("int8", qpred), ("bfloat16", pred))}
    decoded = [qpred.gather_tracking2d(b, num_detections=k)
               for b, _ in track_batches(frames)]
    tracker = Tracker(model=qpred.gather_tracking2d, **tracker_cfg)
    t0 = time.perf_counter()
    for d in decoded:
        for i in range(TRACK_BATCH):
            tracker.update(d["bboxes"][i], d["labels"][i], d["scores"][i],
                           d["embeddings"][i])
            tracker.frame += 1
    assoc_ms = (time.perf_counter() - t0) / INT8_TRACK_FRAMES * 1e3
    dets_q = float(np.mean([s["num_detections"] for s in steps_q]))
    checks = {"frames": len(steps_q) == INT8_TRACK_FRAMES,
              "one_peak_launch_a_batch":
                  launches["peak_class_scores_cuda"] == n_batches,
              "detections_enter_tracker": dets_q >= 1}
    emit({"phase": "int8_tracking", "card": card, "config": TRACK_YAML,
          "batch": TRACK_BATCH, "image_size": [h, w], "frames": INT8_TRACK_FRAMES,
          "depth": 1, "int8_convs": len(qpred.act_scales),
          "frames_per_s": {"int8": INT8_TRACK_FRAMES / wall_q,
                           "bfloat16": INT8_TRACK_FRAMES / wall_f},
          "device_ms_per_frame": device_ms,
          "association_ms_per_frame_int8": assoc_ms,
          "detections_into_tracker_per_frame": {
              "int8": dets_q,
              "bfloat16": float(np.mean([s["num_detections"] for s in steps_f]))},
          "frames_whose_ids_differ_from_bf16": differ,
          "launches": launches, "checks": checks,
          "phase_s": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise AssertionError(f"int8 tracking checks failed: {checks}")
    del pred, qpred, dev_frames, decoded, frames
    torch.cuda.empty_cache()
    return launches["peak_class_scores_cuda"]


def serve_path(card, pred, qpred, reset_launches, read_launches):
    """`serve_path`: cli/serve.py's DetectionService and HTTP server on
    127.0.0.1 (port 0) over the flagship at b8: SERVE_REQUESTS PNG requests
    from SERVE_CLIENTS client threads, then SERVE_INT8_REQUESTS to an int8
    service. Every answer must equal the predictor's detections of the
    batch it was served in; the batches must be fewer than the requests.
    Returns the peak launches."""
    import gc
    import hashlib
    import threading
    import urllib.request

    import cv2

    from centernet_lightning_torch.cli.serve import DetectionService, make_server

    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    originals = [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
                 for _ in range(SERVE_REQUESTS)]
    bodies = [cv2.imencode(".png", img[..., ::-1])[1].tobytes() for img in originals]
    digest = lambda img: hashlib.sha1(np.ascontiguousarray(img).tobytes()).digest()  # noqa: E731
    request_of = {digest(img): i for i, img in enumerate(originals)}
    report, total = {}, 0
    collections, gc_began = [], [0.0]   # (generation, start s, ms) a gc pass

    def gc_timer(phase, info):
        if phase == "start":
            gc_began[0] = time.perf_counter()
        else:
            collections.append((info["generation"], gc_began[0],
                                (time.perf_counter() - gc_began[0]) * 1e3))

    for name, p, n_req in (("bfloat16", pred, SERVE_REQUESTS),
                           ("int8", qpred, SERVE_INT8_REQUESTS)):
        service = DetectionService(p, batch_size=SERVE_BATCH, max_wait_ms=5,
                                   num_detections=100, score_threshold=0.0)
        batches, runs = [], []          # runs: (start s, run ms)
        real_run = service._run

        def recording_run(batch, real_run=real_run, batches=batches, runs=runs):
            t = time.perf_counter()
            out = real_run(batch)
            runs.append((t, (time.perf_counter() - t) * 1e3))
            batches.append((batch.copy(), out))
            return out

        service._run = recording_run
        service.start()
        batches.clear()
        server = make_server(service, "127.0.0.1", 0, model_info={"model": name})
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_port}/v1/detect"
        answers, latency, sent = [None] * n_req, [None] * n_req, [None] * n_req

        def client(c):
            for i in range(c, n_req, SERVE_CLIENTS):
                req = urllib.request.Request(url, data=bodies[i],
                                             headers={"Content-Type": "image/png"})
                sent[i] = time.perf_counter()
                answers[i] = json.loads(urllib.request.urlopen(req, timeout=120).read())
                latency[i] = (time.perf_counter() - sent[i]) * 1e3

        # one round of requests first: the handler threads' and the card's
        # first calls stay out of the timed latencies
        warm = [threading.Thread(target=urllib.request.urlopen, args=(
            urllib.request.Request(url, data=bodies[c],
                                   headers={"Content-Type": "image/png"}),),
            kwargs={"timeout": 120}) for c in range(SERVE_CLIENTS)]
        for t in warm:
            t.start()
        for t in warm:
            t.join(timeout=300)
        batches.clear()
        runs.clear()
        collections.clear()
        gc.callbacks.append(gc_timer)
        reset_launches()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        launches = read_launches()
        gc.callbacks.remove(gc_timer)
        server.shutdown()
        server.server_close()
        service.stop()
        # each answer against the predictor's detections of its batch
        # (the same padded batch run again), found by its image
        equal, served_in = 0, 0
        for batch, _ in batches:
            want = p.gather_detection2d(batch, num_detections=100,
                                        normalize_boxes=True)
            for slot in range(SERVE_BATCH):
                i = request_of.get(digest(batch[slot]))
                if i is not None and i < n_req and answers[i] is not None:
                    served_in += 1
                    boxes = want["bboxes"][slot] * SIZE
                    got = answers[i]["detections"]
                    equal += int(
                        [d["label"] for d in got] == want["labels"][slot].tolist()
                        and [d["score"] for d in got]
                        == [round(float(s), 4) for s in want["scores"][slot]]
                        and [d["box"] for d in got]
                        == [[round(float(v), 2) for v in b] for b in boxes])
        lat = np.array([x for x in latency if x is not None])
        # where the tail sits: the slowest requests (sent at, ms after the
        # stream's start) beside the batches the card ran
        slowest = sorted((x, (sent[i] - t0) * 1e3) for i, x in enumerate(latency)
                         if x is not None)[-5:]
        run_ms = np.array([r[1] for r in runs])
        checks = {"all_answered": all(a is not None for a in answers),
                  "answers_equal_predictor": equal == n_req == served_in,
                  "fewer_batches_than_requests": 0 < len(batches) < n_req,
                  "one_peak_launch_a_batch":
                      launches["peak_class_scores_cuda"] == len(batches)}
        report[name] = {"requests": n_req, "clients": SERVE_CLIENTS,
                        "batches_run": len(batches), "wall_s": wall,
                        "requests_per_s": n_req / wall,
                        "latency_ms": {"p50": float(np.percentile(lat, 50)),
                                       "p99": float(np.percentile(lat, 99)),
                                       "max": float(lat.max())},
                        "slowest_requests_ms_sent_at": [
                            [round(x, 1), round(at, 1)] for x, at in slowest[::-1]],
                        "batch_run_ms": {"p50": float(np.median(run_ms)),
                                         "max": float(run_ms.max()),
                                         "max_started_at": round(
                                             (runs[int(run_ms.argmax())][0] - t0) * 1e3, 1)},
                        "requests_a_batch": n_req / max(len(batches), 1),
                        "gc_passes": [sum(g == gen for g, _, _ in collections)
                                      for gen in range(3)],
                        "gc_max_ms_started_at": [
                            round(max((c[2] for c in collections), default=0.0), 1),
                            round((max(collections, key=lambda c: c[2])[1] - t0) * 1e3, 1)
                            if collections else None],
                        "launches": launches, "checks": checks}
        total += launches["peak_class_scores_cuda"]
        if not all(checks.values()):
            emit({"phase": "serve_path", "card": card, **report})
            raise AssertionError(f"serve path ({name}) checks failed: {checks}")
    emit({"phase": "serve_path", "card": card, "batch": SERVE_BATCH,
          "max_wait_ms": 5, "image_size": SIZE, **report,
          "phase_s": time.perf_counter() - t_phase})
    return total


def export_path(card, pred, qpred, reset_launches, read_launches):
    """`export_path`: the flagship's serving program exported with
    torch.export (cli/export.py) at b1 and b8, bf16 and int8, saved,
    loaded back and run on the card: detections bitwise equal to the
    predictor's, one peak launch a call through the loaded program.
    Returns the peak launches."""
    import shutil
    import tempfile

    from centernet_lightning_torch.cli.export import export_program

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_export_")
    gen = torch.Generator().manual_seed(41)
    rows, total = [], 0
    for name, p in (("bfloat16", pred), ("int8", qpred)):
        for b in EXPORT_BATCHES:
            path = os.path.join(work, f"{name}_b{b}.pt2")
            t0 = time.perf_counter()
            exported = export_program(p, path, batch_size=b, height=SIZE, width=SIZE)
            export_s = time.perf_counter() - t0
            ops = {str(n.target) for n in exported.graph.nodes
                   if n.op == "call_function"}
            del exported
            t0 = time.perf_counter()
            program = torch.export.load(path).module()
            load_s = time.perf_counter() - t0
            x = torch.randint(0, 256, (b, SIZE, SIZE, 3), generator=gen,
                              dtype=torch.uint8).cuda()
            with torch.inference_mode():
                program(x)                                  # warm-up
                reset_launches()
                got = program(x)
                torch.cuda.synchronize()
                launches = read_launches()
                want = p.detect(x)
            same = {k: torch.equal(got[k], want[k]) for k in want}
            rows.append({"dtype": name, "batch": b, "bytes": os.path.getsize(path),
                         "export_s": export_s, "load_s": load_s,
                         "peak_op_in_graph":
                             "centernet_lightning.peak_class_scores.default" in ops,
                         "int_mm_in_graph": "aten._int_mm.default" in ops,
                         "launches": launches, "bitwise_equal": same})
            total += launches["peak_class_scores_cuda"]
            del program, got, want, x
    shutil.rmtree(work, ignore_errors=True)
    checks = {"peak_op_in_every_graph": all(r["peak_op_in_graph"] for r in rows),
              "int_mm_in_int8_graphs": all(r["int_mm_in_graph"] == (r["dtype"] == "int8")
                                           for r in rows),
              "one_peak_launch_a_call": all(
                  r["launches"]["peak_class_scores_cuda"] == 1 for r in rows),
              "equal_predictor": all(all(r["bitwise_equal"].values()) for r in rows)}
    emit({"phase": "export_path", "card": card, "image_size": SIZE,
          "programs": rows, "checks": checks,
          "phase_s": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise AssertionError(f"export path checks failed: {checks}")
    torch.cuda.empty_cache()
    return total


def convert_path(card):
    """`convert_path`: a synthetic Lightning checkpoint of the flagship
    (seeded state dict under `model.`, torch.save) through
    cli.convert_checkpoint, then build_centernet on its directory: the
    forward on the card (f32, TF32 off) equal to `load_torch_checkpoint`'s."""
    import shutil
    import tempfile

    import yaml

    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.cli import convert_checkpoint
    from centernet_lightning_torch.models.centernet import CenterNet

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_convert_")
    task = CenterNet(**FLAGSHIP_CFG)
    task.init(torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    state = {}
    for key, v in task.model.state_dict().items():
        if v.is_floating_point():
            v = v + 0.01 * torch.randn(v.shape, generator=gen)
            if key.endswith("running_var"):
                v = v.abs() + 0.5
        state["model." + key] = v
    ckpt = os.path.join(work, "reference.ckpt")
    torch.save({"state_dict": state, "epoch": 1, "global_step": 10}, ckpt)
    config = os.path.join(work, "flagship.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"model": FLAGSHIP_CFG}, f)
    out_dir = os.path.join(work, "converted")
    t0 = time.perf_counter()
    rc = convert_checkpoint.main(["--config", config, "--torch-ckpt", ckpt,
                                  "--output", out_dir])
    convert_s = time.perf_counter() - t0
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        served = build_centernet(out_dir)
        ref = CenterNet(**FLAGSHIP_CFG)
        ref.load_torch_checkpoint(ckpt)
        ref.model.to("cuda", memory_format=torch.channels_last).eval()
        images = torch.randint(0, 256, (4, SIZE, SIZE, 3), generator=gen,
                               dtype=torch.uint8).numpy()
        with torch.inference_mode():
            x = served.prepare_images(images)
            a, b = served.model(x), ref.model(x)
        same = {k: torch.equal(a[k], b[k]) for k in ("heatmap", "box_2d")}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    shutil.rmtree(work, ignore_errors=True)
    checks = {"exit_0": rc == 0, "forward_equal": all(same.values())}
    emit({"phase": "convert_path", "card": card, "convert_s": convert_s,
          "tensors": len(state), "bitwise_equal": same, "checks": checks,
          "phase_s": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise AssertionError(f"convert path checks failed: {checks}")
    del served, ref, a, b
    torch.cuda.empty_cache()


def serving_phases(card, reset_launches, read_launches):
    """The int8 and deployment phases: `int8_main_path` (and
    `int8_times`), `int8_tracking`, `serve_path`, `export_path`,
    `convert_path`. Returns the peak kernel's launches on their paths."""
    pred, qpred, launches = int8_main_path(card, reset_launches, read_launches)
    launches += serve_path(card, pred, qpred, reset_launches, read_launches)
    launches += export_path(card, pred, qpred, reset_launches, read_launches)
    del pred, qpred
    torch.cuda.empty_cache()
    launches += int8_tracking(card, reset_launches, read_launches)
    convert_path(card)
    return launches


# ---- the remaining backbone families, the ResNet options, the top-k order --
# bench_suite.py's full-width serving configs of VoVNet-39 FPN-256, DLA-34
# IDA-256 and EfficientNet-B0 with a separable FPN-96 (bench_torch.py's
# copy: bench_suite imports jax), served at BATCH x SIZE^2 in bf16 with 80
# classes
BACKBONE_CFGS = {name: bench_torch.CONFIGS[name][1]
                 for name in ("vovnet39", "dla34_ida", "efficientnet_b0")}
# the JAX package's space-to-depth stem regrouped on the card, timed beside
# the plain stem the port runs for it: within STEM_F32_TOL of F.conv2d in
# f32 with TF32 off, as a share of the largest |output|
STEM_F32_TOL = 1e-5
# the remat train step: ResNet-34 FPN-256 at b32 bf16, the flagship recipe;
# its gradients against the plain step's as a relative L2 norm, no farther
# than a second plain step's (the run's own noise floor: 0 where the step
# is deterministic, so a recompute on other weights fails); its BatchNorm
# statistics against the plain step's, as a share of the step's change of
# them (a second update in the recompute moves them by about 0.9 of it)
REMAT_BATCH = 32
REMAT_STATS_TOL = 1e-2


def forward_parity_exact(cpu, gpu, images):
    """The card's f32 forward against the exact answer: the same weights in
    f64 on the CPU. `card_vs_exact` is the card's max abs distance from the
    f64 logits, `own_f32_error` the CPU f32 forward's, `card_vs_cpu` the
    two f32 forwards'. The card is held at FORWARD_RTOL of the largest
    magnitude or, where the CPU's own f32 forward is already farther
    (VoVNet-39's box head, 3.1-3.3e-4 from f64 against a 2.99e-4
    tolerance), at twice the CPU's distance."""
    with torch.inference_mode():
        x = cpu.prepare_images(images)
        ref = cpu.model(x)
        got = gpu.model(gpu.prepare_images(images))
        exact = cpu.model.double()(x.double())
        cpu.model.float()
    parity = {}
    for key in ("heatmap", "box_2d"):
        scale = max(1.0, exact[key].abs().max().item())
        own = (ref[key].double() - exact[key]).abs().max().item()
        parity[key] = {
            "card_vs_exact": (got[key].cpu().double() - exact[key]).abs().max().item(),
            "own_f32_error": own,
            "card_vs_cpu": (got[key].cpu() - ref[key]).abs().max().item(),
            "max_abs_ref": scale, "tolerance": max(FORWARD_RTOL * scale, 2 * own)}
    return parity


def stem_space_to_depth(x, weight):
    """The JAX package's space-to-depth stem on the card: the (O, C, 7, 7)
    stem weight zero-padded 7 -> 8 at the leading edge and regrouped into a
    4x4 stride-1 convolution over a 2x2 space-to-depth of x (N, C, H, W),
    pads (2, 1); the same function as the 7x7 / s2 / pad-3 convolution.
    Timed beside it; the port runs the plain convolution."""
    n, c, h, w = x.shape
    x2 = x.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
    x2 = x2.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
    x2 = torch.nn.functional.pad(x2.permute(0, 3, 1, 2), (2, 1, 2, 1))
    # k[p', q'] = weight[p' - 1, q' - 1]: (O, C, P, a, Q, b) -> (O, a, b, C, P, Q)
    k = torch.nn.functional.pad(weight, (1, 0, 1, 0)).reshape(-1, c, 4, 2, 4, 2)
    k = k.permute(0, 3, 5, 1, 2, 4).reshape(-1, 4 * c, 4, 4)
    return torch.nn.functional.conv2d(x2, k)


def backbone_config(name, dtype="bfloat16"):
    model = dict(BACKBONE_CFGS[name], num_classes=80, num_detections=100,
                 image_size=[SIZE, SIZE])
    if dtype:
        model["compute_dtype"] = dtype
    return {"model": model}


def flops_per_image(pred, images):
    """Forward FLOPs of one image, from torch's FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        pred.model(pred.prepare_images(images[:1]))
    return counter.get_total_flops()


def topk_before_repair(scores, labels, num_detections, from_logits):
    """ops/decode.py:_topk as it was before ties took lax.top_k's order:
    one torch.topk on the scores (no order among ties). Timed beside the
    repaired one on the same maps."""
    k = min(num_detections, scores.shape[-1])
    top, idx = torch.topk(scores, k, dim=-1)
    top = top.float()
    if from_logits:
        top = torch.sigmoid(top)
    return top, idx.to(torch.int32), torch.gather(labels, 1, idx)


def lax_order_holds(scores, idx):
    """Whether `idx` (N, k) lists the top k of `scores` (N, M) as lax.top_k
    does for finite scores: descending, equal scores lower index first, the
    k-th place taken by the lowest such index (a stable descending sort)."""
    ref = torch.sort(scores.float().cpu(), dim=-1, descending=True,
                     stable=True).indices[:, :idx.shape[1]]
    return torch.equal(ref, idx.long().cpu())


def remat_step(task, batch):
    """One bf16 train step of `task.model` with gradients kept (KeepGrads):
    (gradients, the state dict after it, peak allocated GB, ms)."""
    from centernet_lightning_torch.train import TrainState, make_train_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = TrainState(model=task.model, tx=KeepGrads())
    t0 = time.perf_counter()
    state, _ = make_train_step(task, compute_dtype="bfloat16")(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    return ({k: g.float() for k, g in state.tx.grads.items() if g is not None},
            {k: v.clone() for k, v in task.model.state_dict().items()}, peak, ms)


def rel_l2(a, b):
    """||a - b|| / ||b|| over every tensor of two dicts."""
    diff = sum(((a[k] - b[k]) ** 2).sum().item() for k in b)
    norm = sum((b[k] ** 2).sum().item() for k in b)
    return (diff / max(norm, 1e-30)) ** 0.5


def backbone_phases(card, reset_launches, read_launches, images):
    """VoVNet-39 FPN-256, DLA-34 IDA-256 and EfficientNet-B0 sep-FPN-96
    served at b64 bf16 (`backbones_main_path`, `backbones_times`,
    `backbones_profile`, `backbones_forward_parity`), the flagship's stem
    in space-to-depth form (`stem_space_to_depth`), its decode with the
    top-k in lax.top_k's order against the order-free one it replaced
    (`topk_repair`), and a remat train step (`remat_train_step`). Returns
    the peak kernel's launches on these paths."""
    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.models.centernet import CenterNet
    from centernet_lightning_torch.ops import decode as decode_ops
    from centernet_lightning_torch.ops import peak_decode

    peak_launches = 0
    preds = {}
    for name in BACKBONE_CFGS:
        t_phase = time.perf_counter()
        pred = build_centernet(backbone_config(name), seed=0)
        calibrate_bn(pred, images[:8])
        reset_launches()
        t0 = time.perf_counter()
        dets = pred.gather_detection2d(images)
        first_s = time.perf_counter() - t0
        launches = read_launches()
        peak_launches += launches["peak_class_scores_cuda"]
        shapes_ok = (dets["bboxes"].shape == (BATCH, 100, 4)
                     and dets["scores"].shape == (BATCH, 100))
        finite = all(bool(np.isfinite(dets[k]).all()) for k in ("bboxes", "scores"))
        labels_ok = bool(((dets["labels"] >= 0) & (dets["labels"] < 80)).all())
        plain = decode_vs_plain(pred, images)
        model = pred.model
        emit({"phase": "backbones_main_path", "config": name,
              "model": backbone_config(name)["model"],
              "backbone": type(model.backbone).__name__,
              "neck": type(model.neck).__name__, "batch": BATCH,
              "image_size": SIZE, "dtype": "bfloat16",
              "params_M": sum(p.numel() for p in model.parameters()) / 1e6,
              "gflop_per_image": flops_per_image(pred, images) / 1e9,
              "first_call_s": first_s, "launches": launches,
              "shapes_ok": shapes_ok, "dets_finite": finite,
              "labels_ok": labels_ok, **plain, "decode_equal_plain": True,
              "phase_s": time.perf_counter() - t_phase})
        if not (shapes_ok and finite and plain["finite"] and labels_ok
                and plain["peak_maps_equal_plain"]):
            raise AssertionError(f"{name} main path output check failed")
        if launches["peak_class_scores_cuda"] != 1:
            raise AssertionError(f"{name}: expected one peak launch: {launches}")
        preds[name] = pred

    t_phase = time.perf_counter()
    dev_images = torch.from_numpy(images).cuda()
    times = repeated_ms({name: functools.partial(p.detect, dev_images)
                         for name, p in preds.items()})
    for t in times.values():
        t["images_per_s"] = BATCH / t["median_ms"] * 1e3
    emit({"phase": "backbones_times", "batch": BATCH, "dtype": "bfloat16",
          "image_size": SIZE, "card": card, "configs": times,
          "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
          "phase_s": time.perf_counter() - t_phase})
    for name, pred in preds.items():
        t_phase = time.perf_counter()
        emit({"phase": "backbones_profile", "config": name, "card": card,
              **device_breakdown(functools.partial(pred.detect, dev_images),
                                 iters=3, wall_ms=times[name]["median_ms"]),
              "phase_s": time.perf_counter() - t_phase})
    del preds, pred, model, dev_images
    torch.cuda.empty_cache()

    # f32 forward, card (TF32 off) against the CPU, statistics calibrated
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name in BACKBONE_CFGS:
            t_phase = time.perf_counter()
            f32 = backbone_config(name, dtype=None)
            cpu = build_centernet(f32, seed=1, device="cpu")
            gpu = build_centernet(f32, seed=1)
            calibrate_bn(gpu, images[2:6])
            cpu.model.load_state_dict(gpu.model.state_dict())
            parity = forward_parity_exact(cpu, gpu, images[:2])
            emit({"phase": "backbones_forward_parity", "model": name, "batch": 2,
                  "image_size": SIZE, "dtype": "float32", "tf32": False, **parity,
                  "phase_s": time.perf_counter() - t_phase})
            for key, p in parity.items():
                if not p["card_vs_exact"] <= p["tolerance"]:
                    raise AssertionError(f"{name} forward parity failed for {key}: {p}")
            del cpu, gpu

        # `stem_space_to_depth` on the flagship, same weights: the port runs
        # the plain stem for it; the regrouped stem timed beside the plain
        t_phase = time.perf_counter()
        stem_preds = {}
        for s2d in (False, True):
            cfg = {"model": dict(FLAGSHIP_CFG, compute_dtype="bfloat16",
                                 backbone_config={"stem_space_to_depth": s2d})}
            stem_preds[s2d] = build_centernet(cfg, seed=0)
        calibrate_bn(stem_preds[False], images[:8])
        stem_preds[True].model.load_state_dict(stem_preds[False].model.state_dict())
        dets, launches, logits = {}, {}, {}
        for s2d, pred in stem_preds.items():
            reset_launches()
            dets[s2d] = pred.gather_detection2d(images)
            launches[s2d] = read_launches()["peak_class_scores_cuda"]
            with torch.inference_mode():
                logits[s2d] = pred.model(pred.prepare_images(images))["heatmap"]
        peak_launches += sum(launches.values())
        same = (torch.equal(logits[True], logits[False])
                and all(np.array_equal(dets[True][k], dets[False][k])
                        for k in dets[False]))
        w = stem_preds[False].model.backbone.conv1.weight.detach()
        x32 = stem_preds[False].prepare_images(images[:8]).float().permute(0, 3, 1, 2)
        with torch.inference_mode():
            ref = torch.nn.functional.conv2d(x32, w.float(), stride=2, padding=3)
            got = stem_space_to_depth(x32, w.float())
        regrouped_gap = ((got - ref).abs().max() / ref.abs().max()).item()
        dev_images = torch.from_numpy(images).cuda()
        with torch.inference_mode():
            xb = stem_preds[False].prepare_images(dev_images).permute(0, 3, 1, 2)
            stem_ms = repeated_ms({
                "plain": functools.partial(stem_preds[True].model.backbone.conv1, xb),
                "space_to_depth": functools.partial(stem_space_to_depth, xb, w)},
                iters=20)
        emit({"phase": "stem_space_to_depth", "model": "resnet34_fpn256",
              "batch": BATCH, "image_size": SIZE, "dtype": "bfloat16",
              "card": card, "launches": launches,
              "logits_and_detections_equal_plain": same,
              "regrouped_f32_vs_conv2d_rel_to_max": regrouped_gap,
              "regrouped_f32_tolerance": STEM_F32_TOL, "stem_ms": stem_ms,
              "phase_s": time.perf_counter() - t_phase})
        if not (same and regrouped_gap <= STEM_F32_TOL
                and all(n == 1 for n in launches.values())):
            raise AssertionError("space-to-depth stem check failed")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # the flagship decode: top-k in lax.top_k's order, and as it was before
    t_phase = time.perf_counter()
    pred = stem_preds[False]
    del stem_preds, logits
    with torch.inference_mode():
        outs = pred.model(pred.prepare_images(dev_images))
        heat, box = outs["heatmap"], outs["box_2d"]
        kw = dict(num_detections=100, stride=pred.task.stride, from_logits=True)

        def decode_with(topk):
            with patched(decode_ops, "_topk", topk):
                return peak_decode.decode_detections_fused(heat, box, **kw)

        repaired = functools.partial(decode_with, decode_ops._topk)
        before = functools.partial(decode_with, topk_before_repair)
        ms = repeated_ms({"before_repair": before, "repaired": repaired,
                          "repaired_again": repaired, "before_repair_again": before},
                         iters=20)
        flat, labels_map = peak_decode.peak_class_scores_cuda(heat, True)
        _, idx, _ = decode_ops._topk(flat, labels_map, 100, True)
        _, old_idx, _ = topk_before_repair(flat, labels_map, 100, True)
        order_ok = lax_order_holds(flat, idx)
        ties = int((flat.gather(1, idx.long())[:, 1:]
                    == flat.gather(1, idx.long())[:, :-1]).sum().item())
    emit({"phase": "topk_repair", "batch": BATCH, "card": card,
          "decode_fused_ms": ms, "lax_order_holds": order_ok,
          "tied_neighbours_in_top100": ties,
          "rows_ordered_differently_before": int(
              (idx != old_idx).any(dim=1).sum().item()),
          "phase_s": time.perf_counter() - t_phase})
    if not order_ok:
        raise AssertionError("the repaired top-k is not in lax.top_k's order")
    del pred, outs, heat, box, dev_images
    torch.cuda.empty_cache()

    # a remat train step: ResNet-34 FPN-256 at b32 bf16, the flagship recipe
    t_phase = time.perf_counter()
    batch = detection_batches(1, REMAT_BATCH, SIZE, 80, "cuda", 12)[0]
    results = {}
    for run, remat in (("plain", False), ("remat", True), ("plain_again", False)):
        cfg = dict(FLAGSHIP_CFG, **TRAIN_RECIPE)
        cfg.pop("num_detections")
        cfg.pop("image_size")
        task = CenterNet(**cfg, backbone_config={"remat": remat})
        task.init(torch.Generator().manual_seed(0))
        task.model.to("cuda", memory_format=torch.channels_last)
        start = {k: v.clone() for k, v in task.model.state_dict().items()}
        remat_step(task, batch)                      # warm-up
        task.model.load_state_dict(start)
        results[run] = remat_step(task, batch)
        del task
        torch.cuda.empty_cache()
    grads = {run: r[0] for run, r in results.items()}
    stats = {run: {k: v for k, v in r[1].items() if k.endswith(("running_mean",
                                                                "running_var"))}
             for run, r in results.items()}
    stats_moved = max((stats["plain"][k] - start[k]).abs().max().item()
                      for k in stats["plain"])
    stats_gap = max((stats["remat"][k] - stats["plain"][k]).abs().max().item()
                    for k in stats["plain"]) / max(stats_moved, 1e-30)
    res = {"grads_rel_l2_vs_plain": rel_l2(grads["remat"], grads["plain"]),
           "grads_bitwise_equal_plain": all(torch.equal(grads["remat"][k],
                                                        grads["plain"][k])
                                            for k in grads["plain"]),
           "plain_vs_plain_again_rel_l2": rel_l2(grads["plain_again"], grads["plain"]),
           "bn_stats_gap_share_of_update": stats_gap,
           "peak_GB": {run: r[2] for run, r in results.items()},
           "step_ms": {run: r[3] for run, r in results.items()}}
    emit({"phase": "remat_train_step", "model": "resnet34_fpn256",
          "batch": REMAT_BATCH, "image_size": SIZE, "dtype": "bfloat16",
          "card": card, **res, "tolerance": {
              "grads_rel_l2": "plain_vs_plain_again_rel_l2",
              "bn_stats_share": REMAT_STATS_TOL},
          "phase_s": time.perf_counter() - t_phase})
    if not (res["grads_rel_l2_vs_plain"] <= res["plain_vs_plain_again_rel_l2"]
            and stats_gap <= REMAT_STATS_TOL
            and res["peak_GB"]["remat"] < res["peak_GB"]["plain"]):
        raise AssertionError(f"remat train step check failed: {res}")
    del results, grads, stats, batch
    torch.cuda.empty_cache()
    return peak_launches


# ---- data parallelism (parallel/dist.py) and the ablation tool ------------

# `ddp_path`: configs/centernet.yaml from packs (the cli_phases recipe:
# DDP_TRAIN_IMAGES at CLI_TRAIN_BATCH with flips, CLI_VAL_IMAGES at
# CLI_VAL_BATCH), one epoch through `cli.train` with and without
# --multihost (a process group of one over NCCL)
DDP_TRAIN_IMAGES = 128
# `ddp_two_ranks_one_card`: the flagship (ResNet-34 FPN-256, heads 256 x 3,
# 80 classes, TRAIN_RECIPE) at b32 SIZE^2, one SGD step of SGD_PARITY_LR
# in f32 (TF32 off) and in bf16, as two gloo ranks of 16 images on the
# one card against one process of 32. The f32 updates within
# SGD_UPDATE_TOL (relative L2, the f32 bound of sgd_step_parity); the
# BatchNorm running statistics' change within DDP_STATS_TOL of its own
# size (relative L2) in both dtypes: the global statistics are sums of
# f32 moments, the single process's cuDNN's, a rounding apart
DDP_RANKS, DDP_BATCH = 2, 32
DDP_STATS_TOL = 1e-2
FLAGSHIP_TRAIN = dict(num_classes=80, backbone="resnet34", neck="FPN",
                      neck_config={"out_channels": 256},
                      head_config={"width": 256, "depth": 3}, **TRAIN_RECIPE)
# `ablation_smoke`: cli.run_ablations' dcn_fast arm, one epoch on the
# 24-image smoke set (CENTERNET_TPU_SMOKE_DATASET)
ABLATION_ARM = "dcn_fast"
ABLATION_KEYS = {"arm", "seed", "epochs", "final", "best_mAP", "dcn_audit"}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(port):
    """torchrun's variables for a group of one on this card."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ddp_path(card, reset_launches, read_launches):
    """`cli.train --multihost` in a process group of one over NCCL, held
    bitwise against the same run without it (final parameters and
    BatchNorm statistics, val/* metrics), with one peak launch a
    validation batch; then the gradient all-reduce of this model timed in
    a group of one. Returns the peak kernel's launches."""
    import shutil
    import tempfile

    import torch.distributed as tdist
    import yaml

    from centernet_lightning_torch.cli import train as cli_train
    from centernet_lightning_torch.parallel import dist
    from centernet_lightning_torch.train import trainer as trainer_mod
    from centernet_lightning_torch.train.checkpoint import (latest_checkpoint,
                                                            load_checkpoint)
    from centernet_lightning_torch.train.config import load_config

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    train_dir, val_dir = os.path.join(work, "train"), os.path.join(work, "val")
    detection_pack(train_dir, DDP_TRAIN_IMAGES, seed=61)
    detection_pack(val_dir, CLI_VAL_IMAGES, seed=62, eval_keys=True)
    here = os.path.dirname(os.path.abspath(__file__))
    config = load_config(os.path.join(here, "configs", CLI_YAML))
    model = config["model"]

    def packed(section, pack_dir, batch, **extra):
        norm = [t for t in model[section].get("transforms", [])
                if t.get("name") == "Normalize"]
        return {"type": "packed", "data_dir": pack_dir, "batch_size": batch,
                "transforms": norm, **extra}

    model["train_data"] = packed("train_data", train_dir, CLI_TRAIN_BATCH,
                                 flip_p=0.5)
    model["val_data"] = packed("val_data", val_dir, CLI_VAL_BATCH)
    config["trainer"].update(max_epochs=1, log_every_n_steps=1)
    yaml_path = os.path.join(work, CLI_YAML)
    with open(yaml_path, "w") as f:
        yaml.safe_dump(config, f, sort_keys=False)

    step_s = []
    real_step = trainer_mod.make_train_step

    def timed_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def run(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            return out
        return run

    def train(name, extra):
        run_dir = os.path.join(work, name)
        del step_s[:]
        reset_launches()
        t = time.perf_counter()
        with patched(trainer_mod, "make_train_step", timed_step):
            rc = cli_train.main(["--config", yaml_path, "--workdir", run_dir,
                                 "--no-resume"] + extra)
        wall = time.perf_counter() - t
        launches = read_launches()
        state = load_checkpoint(latest_checkpoint(
            os.path.join(run_dir, "checkpoints")))[0]["model"]
        with open(os.path.join(run_dir, "logs", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        val = [{k: v for k, v in r.items() if k.startswith("val/")}
               for r in rows if "val/mAP" in r]
        return {"rc": rc, "wall_s": wall, "launches": launches, "state": state,
                "val": val, "step_ms": float(np.median(step_s[1:])) * 1e3,
                "steps": len(step_s),
                "group_left_up": tdist.is_initialized()}

    # the same run twice, bitwise: deterministic cuDNN and index backward
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain = train("plain", [])
        with torchrun_env(_free_port()):
            multi = train("multihost", ["--multihost"])
    finally:
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)

    # the gradient all-reduce of this model, in a group of one over NCCL
    n_params = sum(v.numel() for k, v in plain["state"].items()
                   if v.is_floating_point() and "running" not in k)
    grads = {"flat": torch.ones(n_params, device="cuda")}
    with torchrun_env(_free_port()):
        dist.init_from_env("cuda")
        try:
            world = dist.process_count()
            tdist.all_reduce(grads["flat"])
            allreduce_ms = cuda_ms(lambda: tdist.all_reduce(grads["flat"]), 20)
            backend = tdist.get_backend()
        finally:
            tdist.destroy_process_group()
    n_val = -(-CLI_VAL_IMAGES // CLI_VAL_BATCH)
    mismatched = [k for k, v in plain["state"].items()
                  if not torch.equal(v, multi["state"][k])]
    checks = {
        "rc": plain["rc"] == 0 and multi["rc"] == 0,
        "params_and_bn_bitwise": not mismatched,
        "val_equal": plain["val"] == multi["val"] and len(plain["val"]) == 1,
        "peak_launches": multi["launches"]["peak_class_scores_cuda"] == n_val,
        "group_torn_down": not multi["group_left_up"],
        "nccl_world_of_one": backend == "nccl" and world == 1,
    }
    emit({"phase": "ddp_path", "config": CLI_YAML, "batch": CLI_TRAIN_BATCH,
          "train_images": DDP_TRAIN_IMAGES, "steps": multi["steps"],
          "plain_step_ms": plain["step_ms"], "multihost_step_ms": multi["step_ms"],
          "allreduce_ms_per_step": allreduce_ms,
          "allreduce_mb": n_params * 4 / 1e6, "backend": backend,
          "plain_wall_s": plain["wall_s"], "multihost_wall_s": multi["wall_s"],
          "launches": multi["launches"], "val": multi["val"],
          "mismatched": mismatched[:5], "checks": checks, "nvidia_smi": card,
          "phase_s": time.perf_counter() - t_phase})
    shutil.rmtree(work, ignore_errors=True)
    if not all(checks.values()):
        raise AssertionError(f"ddp_path failed: {checks}")
    torch.cuda.empty_cache()
    return multi["launches"]["peak_class_scores_cuda"]


DDP_DTYPES = (("bfloat16", "bfloat16"), ("float32", None))


def ddp_one_step(task, model, start, batch, compute_dtype, mesh=None):
    """One SGD step of SGD_PARITY_LR from `start` on `batch` (on the card,
    TF32 off in f32): (the weights and statistics after it on the host,
    the losses). With `mesh` (parallel/mesh.py) the step runs on that grid
    with its wide convolutions split over `model`; `batch` is the global
    batch and the weights come back whole."""
    from centernet_lightning_torch.parallel import mesh as pm
    from centernet_lightning_torch.train import (TrainState, make_optimizer,
                                                 make_train_step)

    model.load_state_dict(start)
    if mesh is not None:
        pm.shard_params(model, mesh, model_parallel=True)
        batch = pm.shard_batch(batch, mesh)
    torch.backends.cudnn.allow_tf32 = compute_dtype is not None
    torch.backends.cuda.matmul.allow_tf32 = compute_dtype is not None
    state = TrainState(model=model, tx=make_optimizer(
        model, optimizer="SGD", lr=SGD_PARITY_LR, weight_decay=1e-4,
        warmup_epochs=0, max_epochs=1, steps_per_epoch=1))
    step = make_train_step(task, compute_dtype=compute_dtype, mesh=mesh)
    state, losses = step(state, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    weights = model.state_dict() if mesh is None else pm.full_state_dict(model)
    return ({k: v.cpu() for k, v in weights.items()},
            {k: float(v) for k, v in losses.items()})


def ddp_rank_worker(rank: int, work: str) -> None:
    """One of the `ddp_two_ranks_one_card` ranks: joins a gloo group (a
    FileStore in `work`) on the one card, takes its DDP_BATCH / DDP_RANKS
    rows of the seeded batch and one SGD step from the saved weights in
    each of DDP_DTYPES, and saves its weights and losses."""
    import torch.distributed as tdist

    from centernet_lightning_torch.models.centernet import CenterNet

    tdist.init_process_group(
        "gloo", store=tdist.FileStore(os.path.join(work, "store"), DDP_RANKS),
        rank=rank, world_size=DDP_RANKS)
    try:
        task = CenterNet(**FLAGSHIP_TRAIN)
        model = task.model.to("cuda", memory_format=torch.channels_last)
        start = torch.load(os.path.join(work, "start.pt"))
        batch = torch.load(os.path.join(work, "batch.pt"))
        n = DDP_BATCH // DDP_RANKS
        mine = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
        out = {name: ddp_one_step(task, model, start, mine, dtype)
               for name, dtype in DDP_DTYPES}
        torch.save(out, os.path.join(work, f"rank_{rank}.pt"))
    finally:
        tdist.destroy_process_group()


def ddp_two_ranks_one_card(card):
    """Two gloo ranks on the one card (device tensors through gloo), each
    one SGD step on half of a seeded b32 flagship batch, against one
    process's step on the whole batch from the same weights, in f32 (TF32
    off) and in bf16. In f32 the updates are held to SGD_UPDATE_TOL and
    the statistics to DDP_STATS_TOL. In bf16 the statistics are held to
    DDP_STATS_TOL; the update is printed, not held: the step's bf16
    rounding alone moves this model's update by about half its size (one
    process whose BatchNorm takes the same f32 moments as the two ranks,
    without a collective, lands as far from cuDNN's step, and the two
    ranks as far from it), so no bf16 bound near 2^-5 can tell a right
    step from a wrong one; f32 can."""
    import shutil
    import tempfile
    import types

    from centernet_lightning_torch.models import layers
    from centernet_lightning_torch.models.centernet import CenterNet

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    task = CenterNet(**FLAGSHIP_TRAIN)
    task.init(torch.Generator().manual_seed(5))
    perturb_bn(task.model, 6)
    model = task.model.to("cuda", memory_format=torch.channels_last)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.save(start, os.path.join(work, "start.pt"))
    batch = detection_batches(1, DDP_BATCH, SIZE, 80, "cpu", 71)[0]
    torch.save(batch, os.path.join(work, "batch.pt"))

    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ddp-rank", str(r), work],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(DDP_RANKS)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    ranks_s = time.perf_counter() - t
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"ddp_two_ranks_one_card: rank {r} exited "
                                 f"{p.returncode}:\n{out[-3000:]}")
    ranks = [torch.load(os.path.join(work, f"rank_{r}.pt"))
             for r in range(DDP_RANKS)]

    one = {name: ddp_one_step(task, model, start, batch, dtype)
           for name, dtype in DDP_DTYPES}
    # one process, BatchNorm through the global moments formula
    moments = types.SimpleNamespace(process_count=lambda: DDP_RANKS,
                                    all_reduce_sum=lambda x: x)
    with patched(layers, "dist", moments):
        one_moments = ddp_one_step(task, model, start, batch, "bfloat16")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    start = {k: v.cpu() for k, v in start.items()}
    names = sorted(k for k, _ in model.named_parameters())
    stats = [k for k in start if k.endswith(("running_mean", "running_var"))]

    def rel_change(got, ref, keys):
        diff = sum(((got[k] - ref[k]) ** 2).sum().item() for k in keys)
        size = sum(((ref[k] - start[k]) ** 2).sum().item() for k in keys)
        return (diff / max(size, 1e-30)) ** 0.5

    two = {name: ranks[0][name] for name, _ in DDP_DTYPES}
    gaps = {
        "f32_update": rel_change(two["float32"][0], one["float32"][0], names),
        "f32_stats": rel_change(two["float32"][0], one["float32"][0], stats),
        "bf16_update_vs_moments": rel_change(two["bfloat16"][0],
                                             one_moments[0], names),
        "bf16_stats_vs_moments": rel_change(two["bfloat16"][0],
                                            one_moments[0], stats),
        "bf16_update_vs_cudnn": rel_change(two["bfloat16"][0],
                                           one["bfloat16"][0], names),
        "bf16_stats_vs_cudnn": rel_change(two["bfloat16"][0],
                                          one["bfloat16"][0], stats),
        "bf16_moments_update_vs_cudnn": rel_change(one_moments[0],
                                                   one["bfloat16"][0], names),
    }
    loss_rel = {name: {k: abs(two[name][1][k] - v) / max(abs(v), 1e-30)
                       for k, v in one[name][1].items()}
                for name, _ in DDP_DTYPES}
    checks = {
        "ranks_equal": all(torch.equal(v, ranks[1][name][0][k])
                           for name, _ in DDP_DTYPES
                           for k, v in ranks[0][name][0].items()),
        "f32_update": gaps["f32_update"] <= SGD_UPDATE_TOL,
        "f32_stats": gaps["f32_stats"] <= DDP_STATS_TOL,
        "bf16_stats": gaps["bf16_stats_vs_cudnn"] <= DDP_STATS_TOL,
        "losses_finite": all(np.isfinite(v) for name, _ in DDP_DTYPES
                             for v in two[name][1].values()),
    }
    emit({"phase": "ddp_two_ranks_one_card", "model": "resnet34_fpn256",
          "ranks": DDP_RANKS, "backend": "gloo", "batch": DDP_BATCH,
          "image_size": SIZE, "lr": SGD_PARITY_LR, "rel_l2": gaps,
          "tolerance": {"update_rel_l2": SGD_UPDATE_TOL,
                        "stats_rel_l2": DDP_STATS_TOL},
          "losses_one_process": {n: one[n][1] for n, _ in DDP_DTYPES},
          "losses_two_ranks": {n: two[n][1] for n, _ in DDP_DTYPES},
          "loss_rel_diff": loss_rel, "ranks_wall_s": ranks_s,
          "checks": checks, "nvidia_smi": card,
          "phase_s": time.perf_counter() - t_phase})
    shutil.rmtree(work, ignore_errors=True)
    del model
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise AssertionError(f"ddp_two_ranks_one_card failed: {checks}")


def ablation_smoke(card, reset_launches, read_launches):
    """cli.run_ablations' ABLATION_ARM for one epoch on the smoke set, in
    this process: the DCN sampling kernel and the peak kernel launch, the
    result file holds the tool's keys and --report renders it. Needs
    OpenCV (the arms read JPEG files); skipped, and said so, without it.
    Returns the launches."""
    import io
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    try:
        import cv2  # noqa: F401
    except ImportError:
        emit({"phase": "ablation_smoke", "skipped": "no OpenCV on this machine",
              "phase_s": time.perf_counter() - t_phase})
        return {}
    from centernet_lightning_torch.cli import run_ablations

    out = tempfile.mkdtemp(prefix="chip_smoke_ablation_")
    old = os.environ.get("CENTERNET_TPU_SMOKE_DATASET")
    os.environ["CENTERNET_TPU_SMOKE_DATASET"] = "1"
    try:
        reset_launches()
        t = time.perf_counter()
        rc = run_ablations.main(["--out", out, "--arm", ABLATION_ARM,
                                 "--epochs", "1"])
        wall = time.perf_counter() - t
        launches = read_launches()
    finally:
        if old is None:
            os.environ.pop("CENTERNET_TPU_SMOKE_DATASET", None)
        else:
            os.environ["CENTERNET_TPU_SMOKE_DATASET"] = old
    with open(os.path.join(out, f"{ABLATION_ARM}_s0.json")) as f:
        result = json.load(f)
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        run_ablations.report(out)
    # the fit's one validation and the final one, each one batch of the
    # 5 validation images; the sampler in every forward of the 3 DCN
    # layers (the train step, both validations and the offset audit)
    checks = {
        "rc": rc == 0,
        "result_keys": set(result) == ABLATION_KEYS,
        "val_keys": set(result["final"]) == {f"val/{k}" for k in COCO_KEYS},
        "audit_keys": set(result["dcn_audit"]) == {
            "max_abs_offset", "engine_bound", "exact_by_construction"},
        "peak_launches": launches["peak_class_scores_cuda"] == 2,
        "sampler_launches": launches["dcn_sample_taps"] > 0,
        "report_row": f"| {ABLATION_ARM} |" in report.getvalue(),
    }
    emit({"phase": "ablation_smoke", "arm": ABLATION_ARM, "epochs": 1,
          "wall_s": wall, "launches": launches, "result": result,
          "checks": checks, "nvidia_smi": card,
          "phase_s": time.perf_counter() - t_phase})
    shutil.rmtree(out, ignore_errors=True)
    if not all(checks.values()):
        raise AssertionError(f"ablation_smoke failed: {checks}")
    return launches


def parallel_phases(card, reset_launches, read_launches):
    """`ddp_path`, `ddp_two_ranks_one_card` and `ablation_smoke`. Returns
    the launches of the kernels on their paths."""
    launches = collections.Counter()
    launches["peak_class_scores_cuda"] += ddp_path(card, reset_launches,
                                                   read_launches)
    ddp_two_ranks_one_card(card)
    launches.update(ablation_smoke(card, reset_launches, read_launches))
    return launches


# ---- the model axis (parallel/mesh.py), DCN export, the profile tools ------

MESH_BATCH = 8
MESH_WORLDS = (2, 4)      # model ranks on the (1, n) grids; 4 also runs (2, 2)
MESH_GRID = (2, 2)
DCN_EXPORT_TYPES = ("dcn_fast", "dcn_fused_d1")


def dcn_export_path(card, reset_launches, read_launches):
    """`dcn_export_path`: the DCN main path (ResNet-18 FPN-128, its three
    DCN merges on `dcn_fast` (the sampler, d = 2) or `dcn_fused_d1`, bf16,
    512²) exported with cli/export.py at b1 and b8, saved, loaded and run
    on the card: each DCN layer a `centernet_lightning::dcn_sample_taps`
    or `::dcn_fused_conv` node and the peak op once in the graph,
    detections bitwise equal to `predictor.detect`, and a loaded call
    launching the DCN kernel once a DCN layer and the peak kernel once.
    Returns the launches of the loaded calls."""
    import shutil
    import tempfile

    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.cli.export import export_program

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_dcn_export_")
    gen = torch.Generator().manual_seed(43)
    op_of = {"dcn_fast": ("dcn_sample_taps",
                          "centernet_lightning.dcn_sample_taps.default"),
             "dcn_fused_d1": ("dcn_fused_conv",
                              "centernet_lightning.dcn_fused_conv.default")}
    peak_op = "centernet_lightning.peak_class_scores.default"
    rows, total = [], collections.Counter()
    for conv_type in DCN_EXPORT_TYPES:
        pred = build_centernet(dcn_config(conv_type), seed=0)
        calib = torch.randint(0, 256, (2, SIZE, SIZE, 3), generator=gen,
                              dtype=torch.uint8).cuda()
        draw_offset_weights(pred.model, pred.prepare_images(calib),
                            torch.Generator(device="cuda").manual_seed(44))
        layers = len(dcn_blocks(pred.model))
        counter, op = op_of[conv_type]
        for b in EXPORT_BATCHES:
            path = os.path.join(work, f"{conv_type}_b{b}.pt2")
            t0 = time.perf_counter()
            exported = export_program(pred, path, batch_size=b, height=SIZE,
                                      width=SIZE)
            export_s = time.perf_counter() - t0
            targets = [str(n.target) for n in exported.graph.nodes
                       if n.op == "call_function"]
            del exported
            t0 = time.perf_counter()
            program = torch.export.load(path).module()
            load_s = time.perf_counter() - t0
            x = torch.randint(0, 256, (b, SIZE, SIZE, 3), generator=gen,
                              dtype=torch.uint8).cuda()
            with torch.inference_mode():
                program(x)                                  # warm-up
                reset_launches()
                got = program(x)
                torch.cuda.synchronize()
                launches = read_launches()
                want = pred.detect(x)
            rows.append({
                "conv_type": conv_type, "batch": b, "dcn_layers": layers,
                "bytes": os.path.getsize(path), "export_s": export_s,
                "load_s": load_s, "dcn_op": op,
                "dcn_op_nodes": targets.count(op),
                "peak_op_nodes": targets.count(peak_op),
                "launches": launches,
                "bitwise_equal": {k: torch.equal(got[k], want[k]) for k in want}})
            total.update(launches)
            del program, got, want, x
        del pred
    shutil.rmtree(work, ignore_errors=True)
    counter_of = {op: c for c, op in op_of.values()}
    checks = {
        "dcn_op_a_layer": all(r["dcn_op_nodes"] == r["dcn_layers"] == len(DCN_LAYERS)
                              for r in rows),
        "peak_op_once": all(r["peak_op_nodes"] == 1 for r in rows),
        "dcn_launches_a_layer": all(
            r["launches"][counter_of[r["dcn_op"]]] == r["dcn_layers"] for r in rows),
        "one_peak_launch_a_call": all(
            r["launches"]["peak_class_scores_cuda"] == 1 for r in rows),
        "both_ops": {r["dcn_op"] for r in rows} == set(counter_of),
        "equal_predictor": all(all(r["bitwise_equal"].values()) for r in rows)}
    emit({"phase": "dcn_export_path", "card": card, "image_size": SIZE,
          "programs": rows, "checks": checks,
          "phase_s": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise AssertionError(f"dcn_export_path checks failed: {checks}")
    torch.cuda.empty_cache()
    return total


def head_gaps_to(heads, ref):
    """max |heads - ref| of each head map (ref on the host), beside
    FORWARD_RTOL x max(1, max |ref|)."""
    out = {}
    for key in ("heatmap", "box_2d"):
        r = ref[key].cuda().float()
        diff = (heads[key].float() - r).abs().max().item()
        scale = max(1.0, r.abs().max().item())
        out[key] = {"max_abs_diff": diff, "max_abs_ref": scale,
                    "tolerance": FORWARD_RTOL * scale}
    return out


def mesh_rank_worker(rank: int, world: int, work: str) -> None:
    """One rank of `model_axis_path` (`python3 chip_smoke.py --mesh-rank R
    WORLD DIR`): a gloo group of WORLD ranks on the one card (device
    tensors), a (1, WORLD) grid: the flagship's tensor-parallel forward
    and its height split (heads gathered, decoded through the peak kernel)
    in f32 (TF32 off) and bf16, each against one process's heads, the
    detections against the top k of one process's heads through the peak
    kernel (check_same_detections, f32; bf16's are printed); with 4
    ranks also one f32 SGD step on a (2, 2) grid with the wide
    convolutions split. Saves its readings."""
    import torch.distributed as tdist

    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.models.centernet import CenterNet
    from centernet_lightning_torch.ops import peak_decode
    from centernet_lightning_torch.parallel import mesh as pm

    torch.cuda.set_device(0)
    tdist.init_process_group(
        "gloo", store=tdist.FileStore(os.path.join(work, f"store_{world}"), world),
        rank=rank, world_size=world)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        start = torch.load(os.path.join(work, "start.pt"))
        refs = torch.load(os.path.join(work, "ref.pt"))
        images = torch.load(os.path.join(work, "images.pt")).cuda()
        mesh = pm.create_mesh(1, world)
        f32_cfg = {"model": dict(FLAGSHIP_CFG)}
        out = {"tp": {}, "band": {}}

        def model_in(dtype):
            pred = build_centernet(f32_cfg, seed=0)
            pred.model.load_state_dict(start)
            pred.model.to(dtype).eval()
            return pred, pred.prepare_images(images).to(dtype)

        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            pred, x = model_in(dtype)
            split = pm.shard_params(pred.model, mesh, model_parallel=True)
            with torch.inference_mode():
                pred.model(x)                               # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                heads = pred.model(x)
                torch.cuda.synchronize()
            out["tp"][name] = {"split_weights": len(split),
                               "forward_s_gloo_host": time.perf_counter() - t0,
                               **head_gaps_to(heads, refs[name])}
            del pred, heads
            pred, x = model_in(dtype)
            band = pm.split_rows(x, mesh)
            with torch.inference_mode():
                before = pm.spatial_forward.gathers
                heads = pm.gather_bands(pm.spatial_forward(pred.model, band, mesh),
                                        mesh)
                gathers = pm.spatial_forward.gathers - before
                peak_decode.peak_class_scores_cuda.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dets = pm.spatial_detect(pred.task, pred.model, band, mesh)
                torch.cuda.synchronize()
                detect_s = time.perf_counter() - t0
                launches = peak_decode.peak_class_scores_cuda.launches
                stride = pred.task.stride
                got = peak_topk(heads["heatmap"], heads["box_2d"], stride)
                one = peak_topk(refs[name]["heatmap"].cuda(),
                                refs[name]["box_2d"].cuda(), stride)
                if dtype == torch.float32:
                    check_same_detections(got, one)
                same = maps_vs_plain(heads["heatmap"], heads["box_2d"], stride)
            out["band"][name] = {
                "gathers": gathers, "peak_launches": launches,
                "detect_s_gloo_host": detect_s,
                "detections_are_topk_of_gathered": all(
                    torch.equal(dets[k], got[k])
                    for k in ("scores", "labels", "boxes")),
                "topk_logits_equal_one_process": torch.equal(
                    torch.gather(got["flat"], 1, got["indices"].long()),
                    torch.gather(one["flat"], 1, one["indices"].long())),
                "peak_maps_equal_plain": same,
                "top_scores": dets["scores"][:, :5].float().cpu().tolist(),
                **head_gaps_to(heads, refs[name])}
            if dtype == torch.float32:     # check_same_detections held above
                out["band"][name]["same_detections_as_one_process"] = True
            del pred, heads, dets, got, one
            torch.cuda.empty_cache()
        if world == MESH_GRID[0] * MESH_GRID[1]:
            grid = pm.create_mesh(*MESH_GRID)
            task = CenterNet(**FLAGSHIP_TRAIN)
            model = task.model.to("cuda", memory_format=torch.channels_last)
            t0 = time.perf_counter()
            weights, losses = ddp_one_step(
                task, model, torch.load(os.path.join(work, "start_step.pt")),
                torch.load(os.path.join(work, "batch.pt")), None, mesh=grid)
            out["grid_step"] = {"losses": losses,
                                "step_s_gloo_host": time.perf_counter() - t0}
            if rank == 0:
                torch.save(weights, os.path.join(work, "grid_weights.pt"))
        torch.save(out, os.path.join(work, f"rank_{world}_{rank}.pt"))
    finally:
        tdist.destroy_process_group()


def model_axis_path(card):
    """`model_axis_path`: the flagship (ResNet-34 FPN-256, 80 classes, full
    width, 512², b8) on (1, 2) and (1, 4) grids of gloo ranks on this card
    (the ranks' collectives run through the host, so their times are no
    interconnect figures), and a (2, 2) grid step. Held, f32 with TF32
    off: the tensor-parallel and the height-split heads within
    FORWARD_RTOL of max |head| of one process's, no map gathered whole at
    512² / 4, the detections of the gathered heads those of one
    process's heads and the gathered heads' top-k through the peak
    kernel the plain decode's (check_same_detections), one peak launch a
    batch on every
    rank, and the (2, 2) step's update within SGD_UPDATE_TOL (relative
    L2) of one process's step on the global batch, its statistics within
    DDP_STATS_TOL. bf16's distances are printed, not held. Then the
    grid's collectives in a group of one over NCCL. Returns the peak
    launches of the height split's decodes."""
    import shutil
    import tempfile

    import torch.distributed as tdist

    from centernet_lightning_torch import build_centernet
    from centernet_lightning_torch.models.centernet import CenterNet
    from centernet_lightning_torch.parallel import dist
    from centernet_lightning_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = build_centernet({"model": dict(FLAGSHIP_CFG)}, seed=0, device="cpu")
    perturb_bn(cpu.model, 31)
    start = {k: v.detach().clone() for k, v in cpu.model.state_dict().items()}
    del cpu
    pred = build_centernet({"model": dict(FLAGSHIP_CFG)}, seed=0)
    pred.model.load_state_dict(start)
    images = torch.randint(0, 256, (MESH_BATCH, SIZE, SIZE, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(32))
    refs = {}
    with torch.inference_mode():
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            pred.model.to(dtype)
            heads = pred.model(pred.prepare_images(images.cuda()).to(dtype))
            refs[name] = {k: v.cpu() for k, v in heads.items()}
    del pred, heads
    torch.save(start, os.path.join(work, "start.pt"))
    torch.save(refs, os.path.join(work, "ref.pt"))
    torch.save(images, os.path.join(work, "images.pt"))
    task = CenterNet(**FLAGSHIP_TRAIN)
    task.init(torch.Generator().manual_seed(33))
    perturb_bn(task.model, 34)
    model = task.model.to("cuda", memory_format=torch.channels_last)
    start_step = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batch = detection_batches(1, MESH_BATCH, SIZE, 80, "cpu", 35)[0]
    torch.save(start_step, os.path.join(work, "start_step.pt"))
    torch.save(batch, os.path.join(work, "batch.pt"))
    one = ddp_one_step(task, model, start_step, batch, None)
    del model
    torch.cuda.empty_cache()

    ranks, wall = {}, {}
    for world in MESH_WORLDS:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", str(r),
             str(world), work], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        outs = [p.communicate(timeout=600)[0] for p in procs]
        wall[world] = time.perf_counter() - t0
        for r, (p, o) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"model_axis_path: rank {r} of {world} "
                                     f"exited {p.returncode}:\n{o[-3000:]}")
        ranks[world] = [torch.load(os.path.join(work, f"rank_{world}_{r}.pt"))
                        for r in range(world)]
    grid = torch.load(os.path.join(work, "grid_weights.pt"))
    shutil.rmtree(work, ignore_errors=True)

    start_step = {k: v.cpu() for k, v in start_step.items()}
    names = sorted(k for k, _ in task.model.named_parameters())
    stats = [k for k in start_step if k.endswith(("running_mean", "running_var"))]

    def rel_change(got, ref, keys):
        diff = sum(((got[k] - ref[k]) ** 2).sum().item() for k in keys)
        size = sum(((ref[k] - start_step[k]) ** 2).sum().item() for k in keys)
        return (diff / max(size, 1e-30)) ** 0.5

    grid_gaps = {"f32_update": rel_change(grid, one[0], names),
                 "f32_stats": rel_change(grid, one[0], stats)}

    def within(g):
        return all(v["max_abs_diff"] <= v["tolerance"]
                   for k, v in g.items() if k in ("heatmap", "box_2d"))

    rows = [dict(world=w, rank=r, **out["tp"]["float32"]) for w in MESH_WORLDS
            for r, out in enumerate(ranks[w])]
    band = [out["band"] for w in MESH_WORLDS for out in ranks[w]]
    checks = {
        "tp_f32_within": all(within(out["tp"]["float32"])
                             for w in MESH_WORLDS for out in ranks[w]),
        "weights_split": all(out["tp"]["float32"]["split_weights"] > 0
                             for w in MESH_WORLDS for out in ranks[w]),
        "band_f32_within": all(within(b["float32"]) for b in band),
        "no_gathers_at_512_over_4": all(out["band"]["float32"]["gathers"] == 0
                                        for out in ranks[4]),
        "one_peak_launch_a_batch": all(b[d]["peak_launches"] == 1
                                       for b in band for d in b),
        "detections_of_gathered_maps": all(
            b[d]["detections_are_topk_of_gathered"] for b in band for d in b),
        "same_detections_as_one_process": all(
            b["float32"]["same_detections_as_one_process"] for b in band),
        "peak_maps_equal_plain": all(b[d]["peak_maps_equal_plain"]
                                     for b in band for d in b),
        "grid_update": grid_gaps["f32_update"] <= SGD_UPDATE_TOL,
        "grid_stats": grid_gaps["f32_stats"] <= DDP_STATS_TOL,
        "grid_losses_finite": all(np.isfinite(v) for out in ranks[4]
                                  for v in out["grid_step"]["losses"].values()),
    }

    # the grid's collectives in a group of one over NCCL
    with torchrun_env(_free_port()):
        dist.init_from_env("cuda")
        try:
            g = tdist.group.WORLD
            one_mesh = pm.Mesh(1, 1, 0, 0, g, g)
            y = torch.randn(2, 8, 6, 5, device="cuda")
            nccl = {
                "backend": tdist.get_backend(),
                "channel_gather": torch.equal(
                    pm._GatherChannels.apply(y, g, 0, 1), y),
                "halo": torch.equal(pm._Bands(one_mesh)._halo(y, 2, 1, 2, 0.0),
                                    torch.nn.functional.pad(y, (0, 0, 1, 2))),
                "data_mean": torch.equal(
                    dist.mean_gradients({"g": y}, group=g)["g"], y)}
        finally:
            tdist.destroy_process_group()
    checks["nccl_group_of_one"] = all(v for k, v in nccl.items() if k != "backend")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    emit({"phase": "model_axis_path", "model": "resnet34_fpn256",
          "batch": MESH_BATCH, "image_size": SIZE, "backend": "gloo on one card "
          "(host copies; no interconnect figure)", "tensor_parallel": rows,
          "height_split": [dict(world=w, rank=r, **out["band"])
                           for w in MESH_WORLDS for r, out in enumerate(ranks[w])],
          "grid": {"shape": list(MESH_GRID), "rel_l2": grid_gaps,
                   "losses_one_process": one[1],
                   "losses_grid": [out["grid_step"] for out in ranks[4]],
                   "tolerance": {"update_rel_l2": SGD_UPDATE_TOL,
                                 "stats_rel_l2": DDP_STATS_TOL}},
          "nccl_group_of_one": nccl, "ranks_wall_s": wall, "checks": checks,
          "nvidia_smi": card, "phase_s": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise AssertionError(f"model_axis_path failed: {checks}")
    return sum(b[d]["peak_launches"] for b in band for d in b)


def profile_tools(card):
    """`profile_tools`: cli.profile_serve (bf16, then --quantize) at b8
    and cli.profile_train at b4, 512², in this process: their JSON, every
    category and segment present, conv and peak-kernel time on the
    device, every category's time at least 0, their sum the device time
    a call and that no more than the call's time, bwd = grad - fwd_loss, and
    a positive torch-op FLOP count. Returns the peak launches of the serving
    calls."""
    from centernet_lightning_torch.cli import profile_serve, profile_train
    from centernet_lightning_torch.ops import peak_decode

    t_phase = time.perf_counter()
    serve = {}
    before = peak_decode.peak_class_scores_cuda.launches
    for name, argv in (("bfloat16", ["--batch-size", "8"]),
                       ("int8", ["--batch-size", "8", "--quantize"])):
        serve[name] = captured_json(profile_serve.main, argv + ["--top", "6"])
    launches = peak_decode.peak_class_scores_cuda.launches - before
    train = captured_json(profile_train.main, ["--batch-size", "4"])
    cats = {"conv", "peak_kernel", "quantize_dequant", "other"}
    ms = train["ms"]
    checks = {
        "serve_categories": all(set(v["categories_ms"]) == cats
                                for v in serve.values()),
        "serve_on_device": all(v["time_of"].startswith("device")
                               and v["categories_ms"]["conv"] > 0
                               and v["categories_ms"]["peak_kernel"] > 0
                               for v in serve.values()),
        "int8_stages": serve["int8"]["categories_ms"]["quantize_dequant"] > 0,
        "serve_breakdown_adds_up": all(
            min(v["categories_ms"].values()) >= 0
            and abs(sum(v["categories_ms"].values()) - v["ms_per_call"])
            <= 1e-6 * v["ms_per_call"]
            and v["ms_per_call"] <= v["ms_per_batch"] for v in serve.values()),
        "train_segments": set(ms) == {"full", "fwd", "fwd_loss", "grad",
                                      "render", "optim"},
        "train_bwd": train["ms_derived"]["bwd (grad - fwd_loss)"]
                     == ms["grad"] - ms["fwd_loss"],
        "train_op_flops": train["torch_op_flops_per_step"] > 0,
    }
    emit({"phase": "profile_tools", "profile_serve": serve,
          "profile_train": train, "checks": checks, "nvidia_smi": card,
          "phase_s": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise AssertionError(f"profile_tools failed: {checks}")
    return launches


def mesh_phases(card, reset_launches, read_launches):
    """`dcn_export_path`, `model_axis_path` and `profile_tools`. Returns
    the launches of the kernels on their paths."""
    launches = collections.Counter(dcn_export_path(card, reset_launches,
                                                   read_launches))
    launches["peak_class_scores_cuda"] += model_axis_path(card)
    launches["peak_class_scores_cuda"] += profile_tools(card)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2

    from centernet_lightning_torch import build_centernet, native
    from centernet_lightning_torch.models.centernet import CenterNet
    from centernet_lightning_torch.ops import (_build, dcn, dcn_fused,
                                               dcn_sample, pool)
    from centernet_lightning_torch.ops.preprocess import preprocess
    from centernet_lightning_torch.ops import decode as decode_ops
    from centernet_lightning_torch.ops import peak_decode
    from centernet_lightning_torch.utils.dcn_audit import audit_dcn_offsets

    kernels = [peak_decode.peak_class_scores_cuda, dcn_sample.dcn_sample_taps,
               dcn_fused.dcn_fused_conv, pool.max_pool_3x3_s2_auto]

    def reset_launches():
        for k in kernels:
            k.launches = 0

    def read_launches():
        return {k.__name__: k.launches for k in kernels}

    # ---- 1. device ------------------------------------------------------
    t_phase = time.perf_counter()
    card = card_line()
    build_s = _build.build_all()
    t0 = time.perf_counter()
    native_ok = native.available()       # builds native/src/native_ops.cc
    emit({"phase": "device", "nvidia_smi": card,
          "native_ops": native_ok, "native_build_s": time.perf_counter() - t0,
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
              for kind in ("constant", "equal_classes", "edge_ties", "nan")]
    cases += [(LVIS, "random"), (LVIS, "nan"), (LVIS, "misaligned")]
    # class chunks of 16-byte vectors (C = 1203 takes one-value loads in
    # both dtypes): 1208 classes (bf16 two chunks, f32 three), 516 (f32 two
    # chunks of 4-value vectors, bf16 two of one-value loads)
    cases += [(shape, kind) for shape in ((2, 32, 48, 1208), (2, 32, 48, 516))
              for kind in ("random", "nan")]
    cases += [(shape, kind) for shape in ((2, 1, 70, 80), (2, 70, 1, 80),
                                          (2, 9, 100, 80), (2, 1, 1, 5))
              for kind in ("random", "nan")]
    # one class (the tracking maps): one-value loads, one lane a pixel
    cases += [(shape, kind) for shape in TRACK_MAPS
              for kind in ("random", "nan", "edge_ties", "misaligned")]
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
    # the kernel's build (cudaFuncGetAttributes) and plan at the serving map
    emit({"phase": "kernel_vs_plain", "kernel": "peak_class_scores",
          "build": peak_decode.kernel_info(
              peak_decode.launch_plan(*FLAGSHIP[1:], 2, True), bf16=True)})

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
        if dtype == torch.bfloat16:   # the W re-layout kernel vs its twin
            same = same and torch.equal(dcn_fused.pack_wgmma_kernel(kern).cpu(),
                                        dcn_fused.pack_wgmma_kernel(kern.cpu()))
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
              "misaligned": misaligned,
              "sample_and_w_layout_bitwise_equal": same,
              "sample_max_abs_err": taps_err, "fused_max_abs_err": y_err,
              "fused_max_abs_out": y_scale,
              "fused_tolerance": FUSED_TOL[dtype] * y_scale})
        if not (same and y_ok):
            raise AssertionError(f"DCN kernel differs from plain: {shape} "
                                 f"{dtype} d={d} v{version} {kind} "
                                 f"misaligned={misaligned}")
        n_dcn_ok += 1
    del x, planes, kern, taps, ref_taps, y, ref_y
    # bf16 streams C in chunks of 64, so a C past the old shared-memory
    # limit (416) is a correctness case; f32 keeps its limit (208): a wider
    # C must be refused at the launch
    x, planes, kern = dcn_inputs((1, 4, 4, 432, 16), torch.bfloat16, 1, 2,
                                 "random", gen)
    y = dcn_fused.dcn_fused_conv(x, *planes, kern, 1)
    ref_y = dcn.fused_reference(x, *planes, kern, 1)
    torch.cuda.synchronize()
    if not torch.equal(dcn_fused.pack_wgmma_kernel(kern).cpu(),
                       dcn_fused.pack_wgmma_kernel(kern.cpu())):
        raise AssertionError("the W re-layout kernel differs from its twin at C=432")
    y_err = (y.float() - ref_y.float()).abs().max().item()
    y_scale = ref_y.float().abs().max().item()
    dcn_err["dcn_fused"] = max(dcn_err["dcn_fused"], y_err)
    fused_rel["bfloat16"] = max(fused_rel["bfloat16"], y_err / max(y_scale, 1e-30))
    emit({"phase": "kernel_vs_plain", "kernel": "dcn_fused", "shape": [1, 4, 4, 432, 16],
          "dtype": "bfloat16", "wide_C": 432, "fused_max_abs_err": y_err,
          "fused_max_abs_out": y_scale,
          "fused_tolerance": FUSED_TOL[torch.bfloat16] * y_scale})
    if not y_err <= FUSED_TOL[torch.bfloat16] * y_scale:
        raise AssertionError("dcn_fused differs from plain at C=432 bf16")
    n_dcn_ok += 1
    x, planes, kern = dcn_inputs((1, 4, 4, 224, 16), torch.float32, 1, 2, "random", gen)
    try:
        dcn_fused.dcn_fused_conv(x, *planes, kern, 1)
    except RuntimeError as err:
        emit({"phase": "kernel_vs_plain", "kernel": "dcn_fused", "too_wide_C": 224,
              "dtype": "float32", "raised": str(err)[:120]})
    else:
        raise AssertionError("dcn_fused took C=224 float32, past its shared memory")
    del x, planes, kern, y, ref_y
    # the bf16 kernel's build (cudaFuncGetAttributes) and pipeline stages
    emit({"phase": "kernel_vs_plain", "kernel": "dcn_fused",
          "build": dcn_fused.kernel_info()})
    torch.cuda.empty_cache()
    # the max pool: bitwise equal to its twin and to F.max_pool2d
    pool_cases = [(shape, dtype, False) for shape in (POOL_STEM, POOL_ODD, POOL_ONE)
                  for dtype in (torch.bfloat16, torch.float32)]
    pool_cases += [(POOL_ODD, dtype, True) for dtype in (torch.bfloat16, torch.float32)]
    pool_err = 0.0
    for shape, dtype, misaligned in pool_cases:
        x = pool_input(shape, dtype, gen, misaligned=misaligned)
        y = pool.max_pool_3x3_s2_auto(x)
        ref = pool.max_pool_3x3_s2_reference(x)
        lib = pool_library(x)
        torch.cuda.synchronize()
        same = torch.equal(y, ref) and torch.equal(y, lib)
        err = (y.float() - ref.float()).nan_to_num(0.0).abs().max().item()
        pool_err = max(pool_err, err)
        emit({"phase": "kernel_vs_plain", "kernel": "max_pool_3x3_s2",
              "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
              "misaligned": misaligned, "bitwise_equal_twin": torch.equal(y, ref),
              "bitwise_equal_max_pool2d": torch.equal(y, lib),
              "neg_inf_outputs": int(torch.isneginf(y).sum().item()),
              "max_abs_err": err})
        if not same:
            raise AssertionError(f"max pool kernel differs: {shape} {dtype} "
                                 f"misaligned={misaligned}")
    del x, y, ref, lib
    torch.cuda.empty_cache()
    emit({"phase": "kernel_vs_plain_done", "peak_cases": 4 * len(cases),
          "pool_cases": len(pool_cases),
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
    path_launches = dict(launches)

    # ---- 3b. main paths: ResNet-18 FPN-128 DCNv2 --------------------------
    t_phase = time.perf_counter()
    dcn_images = images[:DCN_BATCH]
    wgen = torch.Generator(device="cuda").manual_seed(3)
    dcn_preds = {}
    for conv_type, kernel_name in (("dcn_fast_d1", "dcn_sample_taps"),
                                   ("dcn_fused_d1", "dcn_fused_conv")):
        dpred = build_centernet(dcn_config(conv_type), seed=0)
        if not dcn_preds:
            draw_offset_weights(dpred.model, dpred.prepare_images(dcn_images[:4]),
                                wgen)
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
        path_launches["max_pool_3x3_s2_auto"] += launches["max_pool_3x3_s2_auto"]
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
        # 8 images (64 blocks: one block's walk on an SM of its own, on
        # 21 MB that stay in the 50 MB L2)
        heat8 = heat[:8].contiguous()
        kernel_b8_ms = cuda_ms(lambda: peak_decode.peak_class_scores_cuda(
            heat8, True), iters=200)
    n, h, w, c = heat.shape
    moved = heat.numel() * heat.element_size() + n * h * w * (4 + 4)
    ops = heat.numel() * 10        # 8 neighbour maxes, 1 compare, 1 argmax step
    peak_b = bound(moved, ops / H100_F32_OPS_PER_S * 1e3)
    emit({"phase": "times", "batch": BATCH, "dtype": "bfloat16",
          "images_per_s": BATCH / e2e_ms * 1e3, "forward_decode_ms": e2e_ms,
          "forward_decode_rounds": e2e,
          "forward_ms": fwd_ms, "decode_fused_ms": dec_ms,
          "decode_plain_ms": plain_dec_ms, "peak_kernel_ms": kernel_ms,
          "bound_share": peak_b["bound_ms"] / kernel_ms,
          "peak_plan": dataclasses.asdict(peak_decode.plan_for(heat)),
          "peak_kernel_b8_ms": kernel_b8_ms,
          "peak_kernel_b8_bound_share": peak_b["bound_ms"] / 8 / kernel_b8_ms,
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
                # the W re-layout kernel that every bf16 call launches, alone
                "fused_pack_ms": cuda_ms(lambda: dcn_fused.pack_wgmma_kernel(kern),
                                         iters=20),
                "fused_plain_ms": cuda_ms(lambda: dcn.fused_reference(
                    x, *planes, kern, 1), iters=3),
                "per_tap_path_ms": cuda_ms(lambda: torch.matmul(
                    dcn_sample.dcn_sample_taps(x, *planes, 1).reshape(-1, 9 * c),
                    gemm_w), iters=20),
            }
        sb = sample_bound(n, h, w, c, 2)
        fb = fused_bound(n, h, w, c, o, 2)
        product = 2 * n * h * w * 9 * c * o
        t["fused_tflops"] = product / (t["fused_ms"] * 1e-3) / 1e12
        t["fused_bound_share"] = fb["bound_ms"] / t["fused_ms"]
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

    # ---- 4c. times: the max pool at the stem's shape ----------------------
    t_phase = time.perf_counter()
    x = pool_input(POOL_STEM, torch.bfloat16, gen)
    with torch.inference_mode():
        pool_t = {
            "kernel_ms": cuda_ms(lambda: pool.max_pool_3x3_s2_auto(x), iters=50),
            "plain_ms": cuda_ms(lambda: pool.max_pool_3x3_s2_reference(x), iters=10),
            "library_ms": cuda_ms(lambda: pool_library(x), iters=50),
        }
    pool_b = pool_bound(*POOL_STEM, 2)
    emit({"phase": "pool_times", "shape": list(POOL_STEM), "dtype": "bfloat16",
          **pool_t, **pool_b,
          "library_note": "F.max_pool2d(3, 2, 1) on the channels_last view",
          "phase_s": time.perf_counter() - t_phase})
    del x

    # ---- 4d. the DCN backward: gradients through the Functions -----------
    # (kernel forward, twin recompute) against autograd through the twins,
    # with the same upstream gradient: bitwise, since the recompute is the
    # twin; then the forward kernel's and the recompute's times
    t_phase = time.perf_counter()
    recompute_ms = {}
    n_back = 0
    for kname, fn, twin in (("dcn_sample", dcn_sample.dcn_sample_taps,
                             dcn.tap_sample_reference),
                            ("dcn_fused", dcn_fused.dcn_fused_conv,
                             dcn.fused_reference)):
        for (h, w) in DCN_LAYERS:
            for dtype in (torch.bfloat16, torch.float32):
                shape = (DCN_BATCH, h, w, DCN_WIDTH, DCN_WIDTH)
                x, planes, kern = dcn_inputs(shape, dtype, 1, 2, "random", gen)
                k = kern if kname == "dcn_fused" else None
                out_shape = ((DCN_BATCH, h, w, DCN_WIDTH) if k is not None
                             else (DCN_BATCH, h, w, len(dcn.TAPS), DCN_WIDTH))
                grad = torch.randn(out_shape, generator=gen, device="cuda").to(dtype)
                out, got = dcn_grads(fn, x, planes, k, grad)
                _, ref = dcn_grads(twin, x, planes, k, grad)
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
                leaves = [x.detach().clone().requires_grad_()] + [
                    p.detach().clone().requires_grad_() for p in planes[2:]]
                extra = [kern.detach().clone().requires_grad_()] if k is not None else []
                out = fn(leaves[0], *planes[:2], *leaves[1:], *extra, 1)
                t = {"forward_ms": cuda_ms(lambda: fn(
                         x, *planes, *([kern] if k is not None else []), 1), iters=10),
                     "recompute_ms": cuda_ms(lambda: torch.autograd.grad(
                         out, leaves + extra, grad, retain_graph=True), iters=3)}
                dname = str(dtype).replace("torch.", "")
                recompute_ms[(kname, h, dname)] = t["recompute_ms"]
                emit({"phase": "dcn_backward", "kernel": kname, "shape": list(shape),
                      "dtype": dname, "d": 1, "grads_bitwise_equal_twin": same,
                      "grad_max_abs": [g.float().abs().max().item() for g in got], **t})
                if not same:
                    raise AssertionError(f"{kname} backward differs from the twin's "
                                         f"autograd: {shape} {dtype}")
                n_back += 1
                del x, planes, kern, grad, out, got, ref, leaves, extra
                torch.cuda.empty_cache()
    emit({"phase": "dcn_backward_done", "cases": n_back,
          "recompute_ms_per_step_bf16": {
              kname: sum(recompute_ms[(kname, h, "bfloat16")] for h, _ in DCN_LAYERS)
              for kname in ("dcn_sample", "dcn_fused")},
          "phase_s": time.perf_counter() - t_phase})

    # ---- 5a. training main path: ResNet-34 FPN-256 ------------------------
    t_phase = time.perf_counter()
    for batch_size in (TRAIN_BATCH, TRAIN_BATCH // 2):
        try:
            torch.cuda.reset_peak_memory_stats()
            batches = detection_batches(TRAIN_BATCHES, batch_size, SIZE, 80, "cuda", 5)
            task = CenterNet(num_classes=80, backbone="resnet34", neck="FPN",
                             neck_config={"out_channels": 256},
                             head_config={"width": 256, "depth": 3}, **TRAIN_RECIPE)
            trainer, clock, before = fit_path(task, batches, TRAIN_EPOCHS, TRAIN_OPT,
                                              "cuda")
            reset_launches()
            state = trainer.fit()
            clock.tick()
            launches = read_launches()
            break
        except torch.cuda.OutOfMemoryError as err:
            emit({"phase": "train_main_path", "batch": batch_size,
                  "out_of_memory": str(err)[:200]})
            trainer = clock = state = batches = None
            torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    moved = changed(state.model, before)
    finite = all(np.isfinite(v) for losses in clock.losses for v in losses.values())
    step_ms = clock.step_ms()
    reset_launches()
    eval_dets = trainer.eval_step(state, {"image": batches[0]["image"]})
    eval_launches = read_launches()
    eval_ok = (tuple(eval_dets["scores"].shape) == (batch_size, 100)
               and bool(torch.isfinite(eval_dets["scores"]).all()))
    emit({"phase": "train_main_path", "model": "resnet34_fpn256", "batch": batch_size,
          "image_size": SIZE, "precision": "bf16", "optimizer": TRAIN_OPT,
          "steps": state.step, "losses_at_epoch_ends": clock.losses,
          "finite": finite, **moved, "launches": launches,
          "eval_step_launches": eval_launches, "eval_ok": eval_ok,
          "step_ms_median": step_ms, "train_images_per_s": batch_size / step_ms * 1e3,
          "epoch_s": np.diff(clock.times).tolist(), "max_memory_GB": peak_gb,
          "phase_s": time.perf_counter() - t_phase})
    if not (finite and eval_ok and moved["params_changed"] == moved["params"]
            and moved["bn_stats_changed"] == moved["bn_stats"]):
        raise AssertionError("training main path check failed")
    if eval_launches["peak_class_scores_cuda"] != 1:
        raise AssertionError(f"the peak kernel did not launch once in the eval "
                             f"step: {eval_launches}")
    t_phase = time.perf_counter()
    emit({"phase": "train_profile", "model": "resnet34_fpn256", "batch": batch_size,
          **device_breakdown(lambda: trainer.train_step(state, batches[0]),
                             iters=2, wall_ms=step_ms),
          "phase_s": time.perf_counter() - t_phase})
    del trainer, clock, state, batches, task, eval_dets
    torch.cuda.empty_cache()

    # ---- 5b. training main path: the DCN model on both engines -----------
    t_phase = time.perf_counter()
    dcn_batches = detection_batches(TRAIN_BATCHES, DCN_BATCH, SIZE, 80, "cuda", 6)
    dcn_start = None
    for conv_type, kernel in (("dcn_fast_d1", dcn_sample.dcn_sample_taps),
                              ("dcn_fused_d1", dcn_fused.dcn_fused_conv)):
        torch.cuda.reset_peak_memory_stats()
        task = CenterNet(num_classes=80, backbone="resnet18", neck="FPN",
                         neck_config={"out_channels": DCN_WIDTH, "conv_type": conv_type},
                         head_config={"width": DCN_WIDTH, "depth": 2}, **TRAIN_RECIPE)

        def prepare(model):
            if dcn_start is None:    # the same weights on both engines
                draw_offset_weights(model, preprocess(dcn_batches[0]["image"][:4]),
                                    torch.Generator(device="cuda").manual_seed(7))
            else:
                model.load_state_dict(dcn_start)

        trainer, clock, before = fit_path(task, dcn_batches, TRAIN_EPOCHS, TRAIN_OPT,
                                          "cuda", prepare=prepare)
        dcn_start = dcn_start or before
        reset_launches()
        state = trainer.fit()
        clock.tick()
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        moved = changed(state.model, before)
        finite = all(np.isfinite(v) for losses in clock.losses for v in losses.values())
        step_ms = clock.step_ms()
        # one step's gradients through the kernels and through the twins,
        # from the same weights on the same batch: bf16, and for the fused
        # kernel f32 too (TF32 off); then the twins' on an input changed
        # by one rounding. Deterministic algorithms: cuDNN's default f32
        # backward and the index backward's atomics would otherwise part
        # two runs of the same step
        model = state.model
        vs_twins = {}
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        for dtype in ((torch.bfloat16, torch.float32) if conv_type == "dcn_fused_d1"
                      else (torch.bfloat16,)):
            compute = "bfloat16" if dtype == torch.bfloat16 else None
            torch.backends.cudnn.allow_tf32 = dtype == torch.bfloat16
            torch.backends.cuda.matmul.allow_tf32 = False
            batch = dict(dcn_batches[0], image=preprocess(dcn_batches[0]["image"]))
            noise = torch.randn(batch["image"].shape, device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(11))
            moved_batch = dict(batch, image=batch["image"]
                               * (1 + INPUT_ROUNDING[dtype] * noise))
            reset_launches()
            k_losses, k_grads = step_grads(task, model, batch, compute)
            step_launches = read_launches()
            with dcn_twins(model, kernels):
                t_losses, t_grads = step_grads(task, model, batch, compute)
                _, m_grads = step_grads(task, model, moved_batch, compute)

            def rel_l2(a, b):
                diff_sq = sum(((a[n].float() - g.float()) ** 2).sum().item()
                              for n, g in b.items())
                norm_sq = sum((g.float() ** 2).sum().item() for g in b.values())
                return (diff_sq / max(norm_sq, 1e-30)) ** 0.5

            vs_twins[str(dtype).replace("torch.", "")] = {
                "bitwise_equal": all(torch.equal(k_grads[n], g)
                                     for n, g in t_grads.items()),
                "losses_equal": all(torch.equal(k_losses[n], v)
                                    for n, v in t_losses.items()),
                "rel_l2_diff": rel_l2(k_grads, t_grads),
                "twins_input_rounding_rel_l2_diff": rel_l2(m_grads, t_grads),
                "worst_tensor_max_rel_diff": max(
                    ((k_grads[n].float() - g.float()).abs().max().item()
                     / max(g.float().abs().max().item(), 1e-30), n)
                    for n, g in t_grads.items()),
                "tolerance": (0.0 if conv_type == "dcn_fast_d1"
                              else FUSED_GRAD_TOL[dtype]),
                "step_launches": step_launches}
            del k_grads, t_grads, m_grads, batch, moved_batch, noise
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)
        n_steps = state.step
        emit({"phase": "dcn_train_path", "conv_type": conv_type, "batch": DCN_BATCH,
              "image_size": SIZE, "precision": "bf16", "steps": n_steps,
              "losses_at_epoch_ends": clock.losses, "finite": finite, **moved,
              "launches": launches, "grads_vs_twins": vs_twins,
              "step_ms_median": step_ms, "train_images_per_s": DCN_BATCH / step_ms * 1e3,
              "recompute_share_estimate": sum(
                  recompute_ms[("dcn_sample" if conv_type == "dcn_fast_d1"
                                else "dcn_fused", h, "bfloat16")]
                  for h, _ in DCN_LAYERS) / step_ms,
              "max_memory_GB": peak_gb, "phase_s": time.perf_counter() - t_phase})
        if not (finite and moved["params_changed"] == moved["params"]
                and moved["bn_stats_changed"] == moved["bn_stats"]):
            raise AssertionError(f"{conv_type} training check failed")
        if launches[kernel.__name__] != 3 * n_steps or any(
                v["step_launches"][kernel.__name__] != 3 for v in vs_twins.values()):
            raise AssertionError(f"{conv_type}: expected 3 {kernel.__name__} launches "
                                 f"a step: {launches} over {n_steps} steps, "
                                 f"{vs_twins}")
        for v in vs_twins.values():
            if conv_type == "dcn_fast_d1" and not (v["bitwise_equal"]
                                                   and v["losses_equal"]):
                raise AssertionError(f"dcn_fast_d1 gradients through the kernel "
                                     f"differ from the twins': {v}")
            if v["rel_l2_diff"] > v["tolerance"]:
                raise AssertionError(f"{conv_type} gradients vs twins: {v}")
        t_phase = time.perf_counter()
        emit({"phase": "dcn_train_profile", "conv_type": conv_type,
              **device_breakdown(lambda: trainer.train_step(state, dcn_batches[0]),
                                 iters=2, wall_ms=step_ms),
              "phase_s": time.perf_counter() - t_phase})
        del trainer, clock, state, model, task
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
    del dcn_batches, dcn_start
    torch.cuda.empty_cache()

    # ---- 5c. main paths: the shipped configs -----------------------------
    # each built from its YAML (or dict) with build_centernet on the card,
    # bf16, seeded weights, one uint8 BATCH x SIZE^2 batch through
    # gather_detection2d with the launch counts reset just before: one peak
    # launch, and the decode against the plain decode of the same outputs
    shipped = {}
    for name in SHIPPED + ("resnet34_bifpn256",):
        t_phase = time.perf_counter()
        spred = build_centernet(shipped_config(name), seed=0)
        calibrate_bn(spred, images[:8])
        reset_launches()
        t0 = time.perf_counter()
        dets = spred.gather_detection2d(images)
        first_s = time.perf_counter() - t0
        launches = read_launches()
        shapes_ok = (dets["bboxes"].shape == (BATCH, 100, 4)
                     and dets["scores"].shape == (BATCH, 100))
        finite = all(bool(np.isfinite(dets[k]).all()) for k in ("bboxes", "scores"))
        n_cls = spred.task.num_classes
        labels_ok = bool(((dets["labels"] >= 0) & (dets["labels"] < n_cls)).all())
        plain = decode_vs_plain(spred, images)
        model = spred.model
        emit({"phase": "config_main_path", "config": name,
              "backbone": type(model.backbone).__name__,
              "neck": type(model.neck).__name__, "classes": n_cls,
              "batch": BATCH, "image_size": SIZE, "dtype": "bfloat16",
              "params_M": sum(p.numel() for p in model.parameters()) / 1e6,
              "first_call_s": first_s, "launches": launches,
              "shapes_ok": shapes_ok, "dets_finite": finite,
              "labels_ok": labels_ok, **plain, "decode_equal_plain": True,
              "phase_s": time.perf_counter() - t_phase})
        if not (shapes_ok and finite and plain["finite"] and labels_ok
                and plain["peak_maps_equal_plain"]):
            raise AssertionError(f"{name} main path output check failed")
        if launches["peak_class_scores_cuda"] != 1:
            raise AssertionError(f"{name}: expected one peak launch: {launches}")
        shipped[name] = spred

    t_phase = time.perf_counter()
    dev_images = torch.from_numpy(images).cuda()
    shipped_times = repeated_ms({name: functools.partial(p.detect, dev_images)
                                 for name, p in shipped.items()})
    for t in shipped_times.values():
        t["images_per_s"] = BATCH / t["median_ms"] * 1e3
    emit({"phase": "config_times", "batch": BATCH, "dtype": "bfloat16",
          "image_size": SIZE, "card": card, "configs": shipped_times,
          "max_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
          "phase_s": time.perf_counter() - t_phase})
    for name, spred in shipped.items():
        t_phase = time.perf_counter()
        emit({"phase": "config_profile", "config": name, "card": card,
              **device_breakdown(functools.partial(spred.detect, dev_images),
                                 iters=3, wall_ms=shipped_times[name]["median_ms"]),
              "phase_s": time.perf_counter() - t_phase})
    del shipped, spred, model
    torch.cuda.empty_cache()

    # fp16 serving: the decode widens the fp16 heatmap for the peak kernel
    t_phase = time.perf_counter()
    hpred = build_centernet(shipped_config("centernet.yaml", "float16"), seed=0)
    calibrate_bn(hpred, images[:8])
    reset_launches()
    dets = hpred.gather_detection2d(images)
    launches = read_launches()
    plain = decode_vs_plain(hpred, images)
    finite = all(bool(np.isfinite(dets[k]).all()) for k in ("bboxes", "scores"))
    emit({"phase": "fp16_main_path", "config": "centernet.yaml", "batch": BATCH,
          "image_size": SIZE, "dtype": "float16", "launches": launches,
          "dets_finite": finite, **plain, "decode_equal_plain": True,
          "phase_s": time.perf_counter() - t_phase})
    if not (finite and plain["finite"] and plain["peak_maps_equal_plain"]
            and plain["heatmap_dtype"] == "float16"):
        raise AssertionError("fp16 main path output check failed")
    if launches["peak_class_scores_cuda"] != 1:
        raise AssertionError(f"fp16: expected one peak launch: {launches}")
    del hpred, dev_images
    torch.cuda.empty_cache()

    # ---- 5c'. the remaining backbones, the ResNet options, the top-k order --
    path_launches["peak_class_scores_cuda"] += backbone_phases(
        card, reset_launches, read_launches, images)

    # ---- 5d. the tracking path: serving and FairMOT training ---------------
    track = tracking_phases(card, reset_launches, read_launches)
    path_launches["peak_class_scores_cuda"] += track["launches"]

    # ---- 5e. validation: COCO in Trainer.fit, MOT in Trainer.validate -------
    path_launches["peak_class_scores_cuda"] += validation_phases(
        card, reset_launches, read_launches)

    # ---- 5f. the train CLI on packs, resumed, served from best/ ------------
    path_launches["peak_class_scores_cuda"] += cli_phases(
        card, reset_launches, read_launches)

    # ---- 5g. int8 serving, the HTTP service, export, checkpoint convert ----
    path_launches["peak_class_scores_cuda"] += serving_phases(
        card, reset_launches, read_launches)

    # ---- 5h. data parallelism and the ablation tool ------------------------
    for name, n in parallel_phases(card, reset_launches, read_launches).items():
        path_launches[name] += n

    # ---- 5i. DCN export, the model axis, the profile tools -----------------
    for name, n in mesh_phases(card, reset_launches, read_launches).items():
        path_launches[name] += n

    # ---- 6. forward parity on the card ---------------------------------
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
            draw_offset_weights(gpu.model, gpu.prepare_images(small),
                                torch.Generator(device="cuda").manual_seed(4))
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

    for name in ("centernet.yaml", "helmet.yaml", "resnet34_bifpn256"):
        t_phase = time.perf_counter()
        f32 = shipped_config(name, dtype=None)
        cpu = build_centernet(f32, seed=1, device="cpu")
        gpu = build_centernet(f32, seed=1)
        calibrate_bn(gpu, images[2:6])
        cpu.model.load_state_dict(gpu.model.state_dict())
        parity = forward_parity(cpu, gpu, small)
        emit({"phase": "forward_parity", "model": name, "batch": 2,
              "image_size": SIZE, "dtype": "float32", "tf32": False, **parity,
              "phase_s": time.perf_counter() - t_phase})
        for key, p in parity.items():
            if not p["max_abs_diff"] <= p["tolerance"]:
                raise AssertionError(f"{name} forward parity failed for {key}: {p}")
        del cpu, gpu

    # ---- 7. train-step parity on the card (TF32 still off) -----------------
    small_batch = detection_batches(1, 2, TRAIN_PARITY_SIZE, 80, "cpu", 9)[0]
    for name, pcfg, prepare in (
            ("resnet34_fpn256", f32_cfg, None),
            ("centernet.yaml", shipped_config("centernet.yaml", dtype=None),
             lambda p: calibrate_bn(p, small_batch["image"].cuda())),
            ("resnet18_fpn128_dcn_fast_d1", dcn_config("dcn_fast_d1", dtype=None),
             lambda p: draw_offset_weights(
                 p.model, preprocess(small_batch["image"].cuda()),
                 torch.Generator(device="cuda").manual_seed(10))),
            ("resnet18_fpn128_dcn_fused_d1", dcn_config("dcn_fused_d1", dtype=None),
             lambda p: draw_offset_weights(
                 p.model, preprocess(small_batch["image"].cuda()),
                 torch.Generator(device="cuda").manual_seed(10)))):
        t_phase = time.perf_counter()
        pcfg = {"model": dict(pcfg["model"], **{k: v for k, v in TRAIN_RECIPE.items()
                                                 if k != "image_size"})}
        res = sgd_step_parity(pcfg, small_batch, seed=1, prepare=prepare)
        emit({"phase": "train_parity", "model": name, "batch": 2,
              "image_size": TRAIN_PARITY_SIZE, "dtype": "float32", "tf32": False,
              **res, "tolerance": {"SGD_loss_rel": FORWARD_RTOL,
                                   "SGD_tensor_rel_to_max": FORWARD_RTOL,
                                   "SGD_update_rel_l2": SGD_UPDATE_TOL,
                                   "AdamW_loss_rel": ADAMW_LOSS_RTOL},
              "phase_s": time.perf_counter() - t_phase})
        if not (res["SGD"]["loss_max_rel_diff"] <= FORWARD_RTOL
                and res["SGD"]["worst_tensor"]["rel_to_max"] <= FORWARD_RTOL
                and res["SGD"]["update_rel_l2_diff"] <= SGD_UPDATE_TOL
                and res["AdamW"]["loss_max_rel_diff"] <= ADAMW_LOSS_RTOL):
            raise AssertionError(f"{name}: train step card vs CPU out of "
                                 f"tolerance: {res['SGD']['worst_tensor']}")

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
        {"name": "max_pool_3x3_s2", "route": "cuda",
         "source": pool.KERNEL_SOURCE, "replaces": pool.REPLACES,
         "launches": path_launches["max_pool_3x3_s2_auto"],
         "max_abs_err": pool_err, "ms": pool_t["kernel_ms"],
         "plain_ms": pool_t["plain_ms"], "bound_ms": pool_b["bound_ms"],
         "bound_by": pool_b["bound_by"], "library_ms": pool_t["library_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        ddp_rank_worker(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
