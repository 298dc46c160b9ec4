"""Training: `train/state.py:make_train_step`'s step with the
configuration's optimizer (`train/optim.py:make_optimizer`) on one
TrainState, fed a host batch each step (uint8 images and padded boxes from
pinned memory, uploaded without blocking); each step ends in a
synchronize. Set-up takes the first `check_steps` steps through the same
call on the first batches of the pool (all different rows) and keeps what
the comparison needs: each loss, the first gradient (from AdamW's first
moment after one step) and the change of every tensor after the last of
them; the window then goes on with the same state.

Traffic parameters: batch, pool, max_boxes, boxes_per_image, the box
sizes (area_shares and max_aspect, or min_side and max_side:
traffic.box_sizes), check_steps, warm_seconds (steps of the same call
between the comparison's steps and the window; 0 if left out), trace_skip
and trace_steps."""
from __future__ import annotations

import time
from typing import Dict

import torch

from .. import judge, trace, traffic, weights
from ..common import build_task, free, gc_clock, host_clock, memory_peak, sync
from reference import model as model_ref
from reference.adamw import AdamW
from reference.train import train_steps

STATS = ("running_mean", "running_var")


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names])
    return dict(zip(names, vals.cpu().tolist()))


def run(cell):
    from centernet_lightning_torch.models.layers import DeformableConvBlock
    from centernet_lightning_torch.ops import dcn_sample
    from centernet_lightning_torch.train import (TrainState, make_optimizer,
                                                 make_train_step)

    p, cfg, dev = cell.traffic, cell.config, cell.device
    b = p["batch"]
    spec, params, images, boxes = inputs(cell)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    task = build_task(cell.model_cfg, dev)
    weights.load_into(task.model, params)
    model = task.model.to(dev, memory_format=torch.channels_last)
    tx = make_optimizer(model, max_epochs=cfg["max_epochs"],
                        steps_per_epoch=cfg["steps_per_epoch"],
                        **cell.model_cfg["optimizer_config"])
    state = TrainState(model=model, tx=tx)
    step_fn = make_train_step(task, compute_dtype=cfg["compute_dtype"])

    def one_step(j):
        batch = {"image": images[j].to(dev, non_blocking=True),
                 **{k: v.to(dev, non_blocking=True) for k, v in boxes[j].items()}}
        _, losses = step_fn(state, batch)
        sync(dev)
        return losses

    prog = {"losses": []}
    for j in range(p["check_steps"]):
        prog["losses"].append(float(one_step(j)["total"]))
        if j == 0:
            # AdamW's first moment after one step is 0.1 g; a tensor the
            # step did not reach reads a zero gradient
            prog["grad_norms"] = _norms({
                k: tx.slots[k]["mu"] / 0.1 if "mu" in tx.slots.get(k, {}) else torch.zeros(())
                for k, _ in model.named_parameters()})
    now = dict(model.named_parameters())
    bufs = dict(model.named_buffers())
    prog["delta_norms"] = _norms({k: now[k].detach() - params[k] for k in now})
    prog["stat_norms"] = _norms({k: bufs[k] - params[k] for k in bufs
                                 if k.endswith(STATS)})
    # more steps of the same call before the window, where the traffic asks
    # for them: the first seconds of steps run slower than the rest
    warm = time.perf_counter()
    j = p["check_steps"]
    while time.perf_counter() - warm < p.get("warm_seconds", 0):
        one_step(j % p["pool"])
        j += 1

    timer = None
    if cell.trace:
        timer = trace.RegionTimer([m for m in model.modules()
                                   if isinstance(m, DeformableConvBlock)])
    rec = {}
    prof = None
    collected = gc_clock()
    host = host_clock()
    t0 = cell.begin_window()
    steps = 0
    ends = []
    while True:
        if cell.trace and steps == p["trace_skip"]:
            launches0 = dcn_sample.dcn_sample_taps.launches
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            timer.active = True
            step_start = torch.cuda.Event(enable_timing=True)
            step_start.record()
        one_step((p["check_steps"] + steps) % p["pool"])
        steps += 1
        ends.append(time.perf_counter() - t0)
        if prof is not None and steps == p["trace_skip"] + p["trace_steps"]:
            step_end = torch.cuda.Event(enable_timing=True)
            step_end.record()
            sync(dev)
            prof.stop()
            timer.active = False
            rec = trace.reduce(prof)
            rec.update(steps=p["trace_steps"], images=p["trace_steps"] * b,
                       dcn_block_s=timer.seconds(),
                       steps_device_s=step_start.elapsed_time(step_end) / 1e3,
                       dcn_inputs=list(timer.shapes),
                       dcn_sample_launches=dcn_sample.dcn_sample_taps.launches - launches0)
            prof = None
        if time.perf_counter() - t0 >= cell.seconds and (
                not cell.trace or steps > p["trace_skip"] + p["trace_steps"]):
            break
    elapsed = time.perf_counter() - t0
    gc_s = collected()
    host_s = host()
    if timer is not None:
        timer.remove()
    peak = memory_peak(dev)
    del state, tx, model, task, step_fn
    free(dev)

    ref = reference_readings(cell, spec, params, images, boxes)
    numbers = judge.training_gaps(prog, ref)
    cell.log.update(prog=prog, ref=ref)
    return {"attempted": steps, "failed": 0, "numbers": numbers,
            "e2e": {"train_images_per_s": steps * b / elapsed},
            "records": rec, "memory_peak": peak,
            "info": {"steps": steps, "window_s": elapsed, "gc_s": gc_s, "host": host_s,
                     "images_per_s_by_5s": by_span(ends, b, 5.0),
                     "losses": prog["losses"], "ref_losses": ref["losses"],
                     "worst": judge.worst(prog, ref), "numbers": numbers}}


def inputs(cell):
    """(spec, weights, image pool, box batches) from the seed; images and
    boxes in pinned host memory on a CUDA cell."""
    p, dev = cell.traffic, cell.device
    h, w = cell.image_size
    spec = model_ref.param_spec(cell.model_cfg, (h, w))
    params = weights.make(spec, cell.model_cfg, cell.seed, dev)
    images = traffic.images(cell.seed, p["pool"] * p["batch"], h, w, dev).view(
        p["pool"], p["batch"], h, w, 3)
    boxes = traffic.box_batches(cell.seed, p, cell.model_cfg["num_classes"], h, w)
    if dev.type == "cuda":
        boxes = [{k: v.pin_memory() for k, v in bb.items()} for bb in boxes]
    return spec, params, images, boxes


def reference_readings(cell, spec, params, images, boxes, lowp=None) -> Dict:
    """The reference's first `check_steps` steps from `params` on the first
    batches: {losses, grad_norms, delta_norms, stat_norms}."""
    cfg, dev = cell.config, cell.device
    norm_names = [k for k, (_, kind) in spec.items() if kind in ("bn_weight", "bn_bias")]
    ref_params = {k: v.clone() for k, v in params.items()}
    opt = AdamW(cell.model_cfg["optimizer_config"], cfg["steps_per_epoch"], norm_names)
    batches = [{"image": images[j].to(dev), **{k: v.to(dev) for k, v in boxes[j].items()}}
               for j in range(cell.traffic["check_steps"])]
    with weights.no_tf32():
        ref = train_steps(cell.model_cfg, ref_params, batches, opt,
                          cfg["train_mean"], cfg["train_std"], model_ref.STRIDE, lowp=lowp)
    moved = [k for k, (_, kind) in spec.items() if kind not in ("bn_mean", "bn_var", "bn_count")]
    stats = [k for k, (_, kind) in spec.items() if kind in ("bn_mean", "bn_var")]
    ref["delta_norms"] = _norms({k: ref_params[k] - params[k] for k in moved})
    ref["stat_norms"] = _norms({k: ref_params[k] - params[k] for k in stats})
    return ref


def by_span(ends, per_step, span):
    """Images a second in each `span` seconds of the window, from the
    steps' end times."""
    out, start, count = [], 0.0, 0
    for t in ends:
        while t >= start + span:
            out.append(count * per_step / span)
            start, count = start + span, 0
        count += 1
    return out
