"""Train-step time breakdown (port of tools/profile_train.py): each segment
of the flagship's step timed on its own by slope timing.

    python -m centernet_lightning_torch.cli.profile_train [--batch-size 16] \
        [--dtype bf16|f32] [--size 512] [--trace DIR] [--device cuda]

Segments (ms a step):

    full      the train step (train/state.py: forward, targets and losses,
              backward, optimizer)
    fwd       the forward alone (train mode, statistics moved)
    fwd_loss  forward + target render + losses
    grad      the losses' gradient (forward + backward), no optimizer
    render    the target heatmap render and the centre-sample indices
    optim     the optimizer update alone (given gradients)

Derived: bwd = grad - fwd_loss, loss+render = fwd_loss - fwd and
optimizer-in-context = full - grad. `torch_op_flops_per_step` is
`torch.utils.flop_counter.FlopCounterMode`'s count over one full step: the
FLOPs of the torch ops it knows (convolutions and matrix products, forward
and backward), none of the hand-written kernels' (ctypes launches), and it
moves whenever a kernel takes the place of torch ops. It is the port's op
count, not the model's FLOPs, so no utilization is reckoned from it (the
benchmark's `mfu.*` count the plain reference's FLOPs). `--trace` shows
the train step's spans (utils/spans.py). ResNet-34 FPN-256 (heads 256 x 3,
80 classes), AdamW, 128 padded boxes an image, about 30% valid; weights
and data from a seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from .profile_serve import FLAGSHIP, card_label, slope_seconds, sync

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch-size", type=int, default=None,
                        help="default 16 on the card, 2 on the CPU")
    parser.add_argument("--dtype", default=None, choices=["bf16", "f32"],
                        help="default bf16 on the card, f32 on the CPU")
    parser.add_argument("--size", type=int, default=None,
                        help="image side (default 512 on the card, 64 on the CPU)")
    parser.add_argument("--trace", default=None,
                        help="write a Chrome trace of three full steps here")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from torch.utils.flop_counter import FlopCounterMode

    from ..models.centernet import CenterNet
    from ..ops import targets as target_ops
    from ..ops.preprocess import preprocess
    from ..train import optim, state as train_state

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here; pass --device cpu")
    batch_size = args.batch_size or (16 if cuda else 2)
    dtype = args.dtype or ("bf16" if cuda else "f32")
    compute = torch.bfloat16 if dtype == "bf16" else torch.float32
    size = args.size or (512 if cuda else 64)

    task = CenterNet(**FLAGSHIP, box_loss="GIoULoss", box_loss_weight=5.0,
                     box_multiplier=16.0, image_size=(size, size))
    task.init(torch.Generator().manual_seed(0))
    model = task.model.to(device, memory_format=torch.channels_last)
    tx = optim.make_optimizer(model, optimizer="AdamW", lr=2.5e-4,
                              max_epochs=100, steps_per_epoch=1000)
    state = train_state.TrainState(model=model, tx=tx)
    step = train_state.make_train_step(
        task, compute_dtype="bfloat16" if dtype == "bf16" else None)

    k = 128
    rng = np.random.default_rng(0)
    batch = train_state.to_device({
        "image": rng.integers(0, 256, (batch_size, size, size, 3), dtype=np.uint8),
        "boxes": np.abs(rng.normal(size=(batch_size, k, 4)) * 50 + 10
                        ).astype(np.float32) * (size / 512),
        "labels": rng.integers(0, 80, (batch_size, k)).astype(np.int32),
        "mask": (rng.uniform(size=(batch_size, k)) < 0.3).astype(np.float32),
    }, device)
    params = state.params()

    def forward():
        cast = {f"model.{n}": p.to(compute) for n, p in params.items()}
        image = preprocess(batch["image"], dtype=compute)
        return torch.func.functional_call(
            train_state._Method(model, "forward"), cast, (image,))

    def seg_fwd():
        with torch.no_grad():
            return forward()

    def seg_fwd_loss():
        with torch.no_grad():
            return task.compute_loss(forward(), batch)["total"]

    def seg_grad():
        loss = task.compute_loss(forward(), batch)["total"]
        return torch.autograd.grad(loss, list(params.values()),
                                   allow_unused=True)

    out_hw = size // task.stride

    def seg_render():
        hm = target_ops.render_heatmap(
            batch["boxes"], batch["labels"].long(), batch["mask"],
            task.num_classes, out_hw, out_hw, task.stride, task._radius_fn)
        return hm, target_ops.center_sample_indices(
            batch["boxes"], batch["mask"], out_hw, out_hw, task.stride,
            sample_size=task.center_sampling_size)

    grads = {n: torch.full_like(p, 1e-8) for n, p in params.items()}

    def seg_optim():
        state.tx.update(params, grads)

    model.train()
    n1, n2 = (2, 7) if cuda else (1, 2)
    segments = {"full": slope_seconds(lambda: step(state, batch), device, n1, n2)}
    for name, fn in (("fwd", seg_fwd), ("fwd_loss", seg_fwd_loss),
                     ("grad", seg_grad), ("render", seg_render),
                     ("optim", seg_optim)):
        segments[name] = slope_seconds(fn, device, n1, n2)
        print(f"  {name:9s} {segments[name] * 1e3:9.3f} ms/step", file=sys.stderr)

    counter = FlopCounterMode(display=False)
    with counter:
        step(state, batch)
    sync(device)
    flops = float(counter.get_total_flops())
    ms = {k: v * 1e3 for k, v in segments.items()}
    result = {
        "metric": "train_step_breakdown resnet34-fpn256",
        "batch_size": batch_size, "image_size": size, "dtype": dtype,
        **card_label(device),
        "ms": ms,
        "ms_derived": {
            "bwd (grad - fwd_loss)": ms["grad"] - ms["fwd_loss"],
            "loss+render (fwd_loss - fwd)": ms["fwd_loss"] - ms["fwd"],
            "optimizer-in-context (full - grad)": ms["full"] - ms["grad"],
        },
        "images_per_sec": batch_size / segments["full"],
        "torch_op_flops_per_step": flops,
    }
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.trace, exist_ok=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            for _ in range(3):
                step(state, batch)
            sync(device)
        path = os.path.join(args.trace, "train_trace.json")
        prof.export_chrome_trace(path)
        result["trace"] = path
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
