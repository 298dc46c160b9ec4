"""Plain float32 building blocks of the benchmark's reference models.

The reference is written from the published architectures, in plain
PyTorch, and owns its parameter layout: every block asks the context `Ctx`
for its tensors by name and shape. Run on `meta` tensors with `Ctx.spec`
set, a forward lists the model's tensors (name -> (shape, kind)) without
computing anything; the benchmark draws the weights from that list and
hands the same tensors to the reference and to the program.

Modes of `Ctx`:
  eval       BatchNorm normalises with the running statistics;
  train      BatchNorm normalises with the batch mean and biased variance
             and records both in `Ctx.stats`, from which `bn_update`
             moves the running statistics (momentum 0.1 on the new batch);
  calibrate  as train, used once to set the running statistics.

`Ctx.lowp` rounds every convolution's operands, and the gradients that
flow back into them: "int8" to 8-bit integers (symmetric, one scale a
tensor), the lower-precision control of the training cells; "fp8" to
float8 (e4m3 forward, e5m2 backward, one scale a tensor); "bf16" to
bfloat16, a witness of what bfloat16 arithmetic alone does to the
comparison.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
TAPS = tuple((ty, tx) for ty in (-1, 0, 1) for tx in (-1, 0, 1))


class Ctx:
    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 mode: str = "eval", lowp: Optional[str] = None, spec: Optional[dict] = None,
                 checkpoint: bool = False):
        if mode not in ("eval", "train", "calibrate"):
            raise ValueError(f"unknown mode {mode!r}")
        self.p = params or {}
        self.mode = mode
        if lowp not in (None, "int8", "fp8", "bf16"):
            raise ValueError(f"unknown lower precision {lowp!r}")
        self.lowp = lowp
        self.spec = spec
        self.checkpoint = checkpoint
        self.stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def param(self, name: str, shape, kind: str) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self.spec is not None:
            self.spec[name] = (shape, kind)
            return torch.zeros(shape, device="meta")
        t = self.p[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        return t


def _round8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    if t.device.type == "meta":
        return t
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def _round_int8(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "meta":
        return t
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / 127.0
    return (torch.round(t.float() / scale).clamp(-127, 127) * scale).to(t.dtype)


class _Int8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round_int8(t)

    @staticmethod
    def backward(ctx, g):
        return _round_int8(g)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def q(ctx: Ctx, t: torch.Tensor) -> torch.Tensor:
    if ctx.lowp == "int8":
        return _Int8.apply(t)
    if ctx.lowp == "fp8":
        return _Fp8.apply(t)
    if ctx.lowp == "bf16":
        return _Bf16.apply(t)
    return t


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax / lax padding "SAME" along one axis."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(ctx: Ctx, name: str, x: torch.Tensor, cout: int, k: int,
         stride: int = 1, pad="same", bias: bool = False,
         kind: str = "conv") -> torch.Tensor:
    """NCHW convolution; pad "same" (flax SAME) or an int (symmetric)."""
    w = ctx.param(f"{name}.weight", (cout, x.shape[1], k, k), kind)
    b = ctx.param(f"{name}.bias", (cout,), kind + "_bias") if bias else None
    if pad == "same":
        top, bottom = same_pads(x.shape[2], k, stride)
        left, right = same_pads(x.shape[3], k, stride)
        if top == bottom and left == right:
            pad = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            pad = 0
    return F.conv2d(q(ctx, x), q(ctx, w), b, stride=stride, padding=pad)


def bn(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    c = x.shape[1]
    w = ctx.param(f"{name}.weight", (c,), "bn_weight")
    b = ctx.param(f"{name}.bias", (c,), "bn_bias")
    rm = ctx.param(f"{name}.running_mean", (c,), "bn_mean")
    rv = ctx.param(f"{name}.running_var", (c,), "bn_var")
    ctx.param(f"{name}.num_batches_tracked", (), "bn_count")
    if ctx.mode == "eval" or ctx.spec is not None:
        mean, var = rm, rv
    else:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        ctx.stats[name] = (mean.detach(), var.detach())
    shape = (1, c, 1, 1)
    return ((x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
            * w.view(shape) + b.view(shape))


@torch.no_grad()
def bn_update(params: Dict[str, torch.Tensor],
              stats: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
              momentum: float = BN_MOMENTUM) -> None:
    """Move the running statistics toward a train step's batch statistics
    (flax: biased variance), in place; momentum 1 sets them."""
    for name, (mean, var) in stats.items():
        rm, rv = params[f"{name}.running_mean"], params[f"{name}.running_var"]
        rm.mul_(1 - momentum).add_(mean, alpha=momentum)
        rv.mul_(1 - momentum).add_(var, alpha=momentum)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def conv_bn_act(ctx: Ctx, name: str, x, cout, k, stride=1, act=F.relu,
                pad="same") -> torch.Tensor:
    y = bn(ctx, f"{name}.bn", conv(ctx, f"{name}.conv", x, cout, k, stride, pad))
    return act(y) if act is not None else y


def dcn_block(ctx: Ctx, name: str, x: torch.Tensor, cout: int,
              max_displacement: Optional[int]) -> torch.Tensor:
    """Modulated deformable 3x3 convolution (DCNv2), then BatchNorm and
    ReLU.

    Tap t at (ty, tx) of pixel (y, x) is the bilinear sample of x at
    (y + ty + dy_t, x + tx + dx_t), zero outside the map, times
    sigmoid(mask_t); the output is sum_t W[:, :, ty + 1, tx + 1] applied to
    tap t. With `max_displacement` None the offsets are unbounded: the
    exact engine, DCNv2 as torchvision's DeformConv2d computes it. With d
    each offset is first clamped to [-d, d]: the bounded engines. Offsets
    come as (dy, dx) pairs a tap, taps in row-major order, from a 3x3 SAME
    convolution with bias; the mask from another."""
    n, c, h, w = x.shape
    off = conv(ctx, f"{name}.conv_offset", x, 2 * len(TAPS), 3, bias=True,
               kind="dcn_offset")
    mask = torch.sigmoid(conv(ctx, f"{name}.conv_mask", x, len(TAPS), 3,
                              bias=True, kind="dcn_mask"))
    weight = ctx.param(f"{name}.deform.weight", (cout, c, 3, 3), "conv")
    ys = torch.arange(h, dtype=x.dtype, device=x.device).view(1, h, 1)
    xs = torch.arange(w, dtype=x.dtype, device=x.device).view(1, 1, w)
    d = None if max_displacement is None else float(max_displacement)
    y = 0
    for t, (ty, tx) in enumerate(TAPS):
        dy, dx = off[:, 2 * t], off[:, 2 * t + 1]
        if d is not None:
            dy, dx = dy.clamp(-d, d), dx.clamp(-d, d)
        py = ys + ty + dy
        px = xs + tx + dx
        grid = torch.stack([px * (2.0 / max(w - 1, 1)) - 1.0,
                            py * (2.0 / max(h - 1, 1)) - 1.0], dim=-1)
        sample = F.grid_sample(x, grid, mode="bilinear",
                               padding_mode="zeros", align_corners=True)
        sample = sample * mask[:, t:t + 1]
        y = y + F.conv2d(q(ctx, sample),
                         q(ctx, weight[:, :, ty + 1, tx + 1, None, None]))
    return F.relu(bn(ctx, f"{name}.bn", y))


def conv_block(ctx: Ctx, name: str, x: torch.Tensor, cout: int,
               conv_type: str) -> torch.Tensor:
    """A 3x3 block by the program's `conv_type` name (its
    models/layers.py:CONV_BLOCKS): `normal` conv + BatchNorm + ReLU; `dcn`
    and `deformable` the exact DCNv2 block; `dcn_fast` the bounded one at
    d = 2, `dcn_fast_d<d>` and `dcn_fused_d<d>` at d."""
    if conv_type == "normal":
        return conv_bn_act(ctx, name, x, cout, 3)
    if conv_type in ("dcn", "deformable"):
        return dcn_block(ctx, name, x, cout, None)
    if conv_type == "dcn_fast":
        return dcn_block(ctx, name, x, cout, 2)
    for prefix in ("dcn_fast_d", "dcn_fused_d"):
        d = conv_type[len(prefix):]
        if conv_type.startswith(prefix) and d.isdigit():
            return dcn_block(ctx, name, x, cout, int(d))
    raise ValueError(f"the reference has no conv_type {conv_type!r}")


def checkpoint_stage(ctx: Ctx, fn, x: torch.Tensor) -> torch.Tensor:
    """fn(ctx, x), recomputed in the backward where `ctx.checkpoint` asks
    for it: one stage of a backbone, a neck or a head."""
    if ctx.checkpoint and torch.is_grad_enabled() and ctx.spec is None:
        return torch.utils.checkpoint.checkpoint(lambda t: fn(ctx, t), x,
                                                 use_reentrant=False)
    return fn(ctx, x)


def fan_in_std(shape, gain: float) -> float:
    fan_in = int(math.prod(shape[1:])) if len(shape) > 1 else 1
    return gain / math.sqrt(fan_in)
