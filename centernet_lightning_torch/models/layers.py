"""Shared building blocks (port of models/layers.py: ConvNormAct,
SeparableConvNormAct, DeformableConvBlock, Upsample, Downsample, Fuse,
SPP).

Modules take and return NCHW tensors; the model keeps them in
`torch.channels_last` memory format, so a convolution reads and writes the
same bytes as the JAX package's NHWC layout.

BatchNorm keeps flax's settings: eps 1e-5, and flax `momentum=0.9` (weight
of the running value) is torch `momentum=0.1` (weight of the new batch).
In train mode it also keeps flax's running-variance update, which takes
the biased batch variance (torch's own `BatchNorm2d` takes the unbiased
one, n/(n-1) larger). Over several processes the train-mode statistics are
the global batch's (`_FlaxStatistics._global_batch_norm`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dcn as dcn_ops
from ..parallel import dist
from ..ops import dcn_fused, dcn_sample

__all__ = ["BatchNorm1d", "BatchNorm2d", "ConvNormAct", "SeparableConvNormAct",
           "DeformableConvBlock", "DeformWeight", "Upsample", "DepthwiseUpsample",
           "Downsample",
           "Fuse", "SPP", "SameConv2d", "CONV_BLOCKS", "get_conv_block",
           "batch_norm", "same_pads", "bilinear_kernel", "recomputing"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class _Recompute(threading.local):
    depth = 0


_RECOMPUTE = _Recompute()


@contextlib.contextmanager
def recomputing():
    """Marks, on this thread, the recompute of a checkpointed block
    (ResNet `remat`): its BatchNorms normalise as in the forward but leave
    the running statistics as the forward moved them, once, as flax's
    `nn.remat` does."""
    _RECOMPUTE.depth += 1
    try:
        yield
    finally:
        _RECOMPUTE.depth -= 1


class _FlaxStatistics:
    """flax's train-mode statistics for a torch BatchNorm class.

    Train mode normalises with the batch mean and biased variance, as
    torch does, and moves the running statistics toward the same two
    (flax), in f32 whatever the input's dtype. Eval mode normalises with
    the running statistics, cast to the input's dtype where they differ
    (a bf16 forward over f32 buffers).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            stats = (self.running_mean, self.running_var)
            if stats[0].dtype != x.dtype:
                stats = tuple(s.to(x.dtype) for s in stats)
            return F.batch_norm(x, *stats, self.weight, self.bias, False,
                                0.0, self.eps)
        if dist.process_count() > 1:
            y, mean, var = self._global_batch_norm(x)
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
            var = None
        if _RECOMPUTE.depth:
            return y
        with torch.no_grad():
            if var is None:
                var = invstd.float().pow(-2) - self.eps
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.float(), alpha=m)
            self.running_var.mul_(1 - m).add_(var.float(), alpha=m)
            self.num_batches_tracked.add_(1)
        return y

    def _global_batch_norm(self, x: torch.Tensor):
        """Train mode over the processes' global batch (SyncBN, as BatchNorm
        under the JAX package's data-parallel jit): the per-channel count,
        sum and sum of squares in f32 are summed over the processes through
        a differentiable all-reduce, then mean = sum / n and the biased
        var = max(0, sum_sq / n - mean^2), as flax computes them. Returns
        (y in x's dtype, mean, var)."""
        c = x.shape[1]
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, c] + [1] * (x.dim() - 2)
        xf = x.float()
        sums = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                          xf.new_full((1,), x.numel() // c)])
        sums = dist.all_reduce_sum(sums)
        n = sums[2 * c]
        mean = sums[:c] / n
        var = torch.clamp(sums[c:2 * c] / n - mean * mean, min=0.0)
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean.view(shape)) * scale.view(shape) \
            + self.bias.float().view(shape)
        return y.to(x.dtype), mean.detach(), var.detach()


class BatchNorm2d(_FlaxStatistics, nn.BatchNorm2d):
    """`nn.BatchNorm2d` over (N, C, H, W) with flax's statistics."""


class BatchNorm1d(_FlaxStatistics, nn.BatchNorm1d):
    """`nn.BatchNorm1d` over (M, C) rows with flax's statistics: flax
    `BatchNorm` on a (M, C) input, as the ReID classifier has it."""


def batch_norm(channels: int, eps: float = BN_EPS) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=eps, momentum=BN_MOMENTUM)


def same_pads(size: int, kernel_size: int, stride: int) -> Tuple[int, int]:
    """flax / lax `padding="SAME"` along one axis: the total pad is
    max((ceil(size / stride) - 1) * stride + k - size, 0), the low side
    taking the smaller half."""
    total = max((-(-size // stride) - 1) * stride + kernel_size - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """`nn.Conv2d` padded as flax's `padding="SAME"`.

    At stride 1 and an odd kernel SAME is the symmetric `k // 2`, which
    the convolution applies itself. Otherwise the pad depends on the
    input's size (stride 2 on an even input pads (0, 1) at k = 3), so the
    input is padded first (`same_pads`, one copy) and convolved unpadded.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True):
        self.symmetric = stride == 1 and kernel_size % 2 == 1
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2 if self.symmetric else 0,
                         groups=groups, bias=bias)

    def pad_input(self, x: torch.Tensor) -> torch.Tensor:
        """x padded as SAME needs it (x itself at stride 1, odd k)."""
        if self.symmetric:
            return x
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = same_pads(x.shape[2], k, s)
        left, right = same_pads(x.shape[3], k, s)
        return F.pad(x, (left, right, top, bottom))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.pad_input(x))


class ConvNormAct(nn.Module):
    """Conv (padding "SAME") -> BatchNorm -> activation.

    Parameters: `conv` (bias only without norm) and `bn`, the flax
    `Conv_0` and `BatchNorm_0` of the same block.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, groups: int = 1,
                 act: Optional[Callable] = F.relu, use_norm: bool = True):
        super().__init__()
        self.conv = SameConv2d(in_channels, out_channels, kernel_size,
                               stride=stride, groups=groups, bias=not use_norm)
        self.bn = batch_norm(out_channels) if use_norm else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class SeparableConvNormAct(nn.Module):
    """Depthwise k x k ConvNormAct (groups = in_channels, strided SAME),
    then a pointwise ConvNormAct, each with BN and the activation.
    `blocks.{0,1}` are flax `ConvNormAct_{0,1}`."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 act: Optional[Callable] = F.relu):
        super().__init__()
        self.blocks = nn.ModuleList([
            ConvNormAct(in_channels, in_channels, kernel_size, stride=stride,
                        groups=in_channels, act=act),
            ConvNormAct(in_channels, out_channels, 1, act=act)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks[1](self.blocks[0](x))


def bilinear_filter(k: int) -> torch.Tensor:
    """The (k, k) bilinear-interpolation filter of a transpose conv of
    kernel k: 1 - |i - centre| / ceil(k / 2) along each axis."""
    factor = (k + 1) // 2
    center = factor - 1 if k % 2 == 1 else factor - 0.5
    og = torch.arange(k, dtype=torch.float64)
    row = 1 - (og - center).abs() / factor
    return (row[:, None] * row[None, :]).float()


def bilinear_kernel(k: int, channels: int) -> torch.Tensor:
    """The bilinear-interpolation transpose-conv kernel, (k, k, C, C) in
    flax's layout, as the JAX package's `_bilinear_kernel`."""
    filt = bilinear_filter(k)
    kernel = torch.zeros(k, k, channels, channels)
    idx = torch.arange(channels)
    kernel[:, :, idx, idx] = filt[:, :, None]
    return kernel


class Upsample(nn.Module):
    """x2 upsample: nearest or bilinear (half-pixel centres, as
    `jax.image.resize`), or `conv_transpose`: a stride-2 transpose conv
    (`kernel_size`, no bias; bilinear-initialised unless
    `init_bilinear=False`, see models/meta.py:init_weights), BatchNorm and
    ReLU, whose `conv`/`bn` are flax `ConvTranspose_0`/`BatchNorm_0`.

    Flax's transpose conv does not flip its kernel and torch's does, so
    `conv.weight` is flip(kernel, (0, 1)) as (in, out, k, k)
    (utils/convert.py). `lax.conv_transpose`'s SAME pads the dilated input
    with k + s - 2 in all, ceil of half low (k - 1 when s > k - 1), which
    at odd k is asymmetric; the transpose conv runs unpadded and its
    output is cut to 2 H x 2 W from k - 1 - low.
    """

    def __init__(self, method: str = "nearest", channels: Optional[int] = None,
                 kernel_size: int = 4, init_bilinear: bool = True):
        super().__init__()
        if method not in ("nearest", "bilinear", "conv_transpose"):
            raise ValueError(f"unknown upsample method {method!r}")
        self.method = method
        self.init_bilinear = init_bilinear
        if method == "conv_transpose":
            if channels is None:
                raise ValueError("Upsample('conv_transpose') needs channels")
            k, s = kernel_size, 2
            low = k - 1 if s > k - 1 else -(-(k + s - 2) // 2)
            self.crop = k - 1 - low
            self.conv = nn.ConvTranspose2d(channels, channels, k, stride=s,
                                           bias=False)
            self.bn = batch_norm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "nearest":
            return F.interpolate(x, scale_factor=2, mode="nearest")
        if self.method == "bilinear":
            return F.interpolate(x, scale_factor=2, mode="bilinear",
                                 align_corners=False)
        h, w = 2 * x.shape[2], 2 * x.shape[3]
        y = self.conv(x)
        # negative pads cut: rows [crop, crop + 2H) of the full output,
        # zeros past its end (only when k < s)
        c = self.crop
        y = F.pad(y, (-c, w + c - y.shape[3], -c, h + c - y.shape[2]))
        return F.relu(self.bn(y))


class DepthwiseUpsample(nn.ConvTranspose2d):
    """x`factor` upsample by a depthwise transposed convolution: kernel
    2 f, stride f, padding f / 2, one group a channel, no bias, and no
    BatchNorm or activation after it (`IDAUp.up_i` of CenterNet's DLA-34
    neck, xingyizhou/CenterNet `pose_dla_dcn.py`). An even f maps H x W to
    f H x f W. `weight` is (C, 1, 2f, 2f); it starts as the bilinear
    filter in every channel (models/meta.py:init_weights), as upstream's
    `fill_up_weights`."""

    def __init__(self, channels: int, factor: int):
        if factor < 2 or factor % 2:
            raise ValueError(f"DepthwiseUpsample needs an even factor, got {factor}")
        super().__init__(channels, channels, 2 * factor, stride=factor,
                         padding=factor // 2, groups=channels, bias=False)
        self.factor = factor


class Downsample(nn.Module):
    """x2 downsample: `max` / `avg` over 2 x 2 windows at stride 2 with
    `reduce_window`'s SAME (odd sizes pad the high side: -inf for max, 0
    for avg, which still divides by 4), or `conv`: a 3x3/s2 ConvNormAct,
    `conv` (flax `ConvNormAct_0`)."""

    def __init__(self, method: str = "max", channels: Optional[int] = None,
                 in_channels: Optional[int] = None):
        super().__init__()
        if method not in ("max", "avg", "conv"):
            raise ValueError(f"unknown downsample method {method!r}")
        self.method = method
        if method == "conv":
            if in_channels is None:
                raise ValueError("Downsample('conv') needs in_channels")
            self.conv = ConvNormAct(in_channels, channels or in_channels, 3,
                                    stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "conv":
            return self.conv(x)
        if self.method == "max":
            return F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = F.pad(x, (0, x.shape[3] % 2, 0, x.shape[2] % 2))
        return F.avg_pool2d(x, 2, 2)


class Fuse(nn.Module):
    """BiFPN / IDA fusion node (port of the JAX `Fuse`).

    Each input whose width is not `out_channels` gets a 1x1 projection
    (ConvNormAct, no activation); every input is resized to the first
    one's H x W (a larger map by one 2 x 2 max, a smaller one by a nearest
    2x broadcast, or `jax.image.resize` at other ratios and for bilinear);
    they are summed, with softmax-free weights relu(w) / (sum relu(w) +
    eps) when `weighted` (`fuse_weights`, ones at init), and the sum goes
    through a 3x3 `conv_type` block. `blocks` holds the projections, then
    the output block: flax `ConvNormAct_{i}` are `blocks.{i}` and a DCN or
    separable output block is `blocks.{P}` after the P projections.
    """

    def __init__(self, in_channels: Sequence[int], out_channels: int,
                 weighted: bool = False, upsample: str = "nearest",
                 conv_type: str = "normal", eps: float = 1e-4):
        super().__init__()
        self.upsample = upsample
        self.eps = eps
        blocks: List[nn.Module] = []
        self._projection: List[Optional[int]] = []
        for c in in_channels:
            if c != out_channels:
                self._projection.append(len(blocks))
                blocks.append(ConvNormAct(c, out_channels, 1, act=None))
            else:
                self._projection.append(None)
        blocks.append(get_conv_block(conv_type)(out_channels, out_channels, 3))
        self.blocks = nn.ModuleList(blocks)
        self.fuse_weights = (nn.Parameter(torch.ones(len(in_channels)))
                             if weighted else None)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        target = tuple(inputs[0].shape[2:])
        fused = []
        for f, proj in zip(inputs, self._projection):
            if proj is not None:
                f = self.blocks[proj](f)
            if tuple(f.shape[2:]) != target:
                if f.shape[2] < target[0]:
                    if (self.upsample == "nearest" and target[0] == 2 * f.shape[2]
                            and target[1] == 2 * f.shape[3]):
                        f = F.interpolate(f, scale_factor=2, mode="nearest")
                    elif self.upsample == "nearest":
                        # jax.image.resize's half-pixel centres: torch's
                        # "nearest-exact" ("nearest" agrees only at 2x)
                        f = F.interpolate(f, size=target, mode="nearest-exact")
                    else:
                        f = F.interpolate(f, size=target, mode="bilinear",
                                          align_corners=False)
                else:
                    f = F.max_pool2d(f, 2, 2, ceil_mode=True)
            fused.append(f)
        if self.fuse_weights is not None:
            w = F.relu(self.fuse_weights)
            w = w / (w.sum() + self.eps)
            out = sum(wi * f for wi, f in zip(w, fused))
        else:
            out = sum(fused)
        return self.blocks[-1](out)


class SPP(nn.Module):
    """Spatial pyramid pooling, the model's `extra_block` on the coarsest
    map: a 1x1 ConvNormAct to C/2, max pools of `pool_sizes` at stride 1
    (-inf padding), the concatenation and a 1x1 ConvNormAct
    (`blocks.{0,1}`, flax `ConvNormAct_{0,1}`)."""

    def __init__(self, in_channels: int, out_channels: int,
                 pool_sizes: Sequence[int] = (5, 9, 13)):
        super().__init__()
        self.out_channels = out_channels
        self.pool_sizes = tuple(pool_sizes)
        hidden = in_channels // 2
        self.blocks = nn.ModuleList([
            ConvNormAct(in_channels, hidden, 1),
            ConvNormAct(hidden * (1 + len(self.pool_sizes)), out_channels, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.blocks[0](x)
        pools = [x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.pool_sizes]
        return self.blocks[1](torch.cat(pools, dim=1))


class DeformWeight(nn.Module):
    """The deformable kernel in torchvision DeformConv2d's layout,
    `weight` (O, C, k, k), and the `bias` of a block without norm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None


class DeformableConvBlock(nn.Module):
    """Deformable convolution v1/v2 -> BatchNorm (or bias) -> activation
    (port of the JAX DeformableConvBlock).

    Parameters, registered in the flax block's order: `conv_offset` (flax
    `Conv_0`, 2k^2 channels of (dy, dx) per tap), `conv_mask` (flax
    `Conv_1`, v2 only, sigmoid-modulation logits), `deform` (flax `kernel`,
    tap-major (k^2 C, O) there) and `bn`. The offset and mask convolutions
    start at zero (models/meta.py:init_weights).

    Engines:
      - max_displacement=None: the exact gather engine, plain PyTorch
        (ops/dcn.py:exact_taps), any k; taps start at -(k - 1) // 2, so an
        even k reaches one further on the high side, as its SAME offset
        and mask convolutions pad;
      - max_displacement=d, sampler="auto": offsets clamped to [-d, d], the
        nine taps from the sampling kernel (ops/dcn_sample.py), then one
        matrix product with f32 accumulation;
      - max_displacement=d, sampler="fused": the same sampling and product
        in one kernel (ops/dcn_fused.py).
    On CUDA tensors the bounded engines launch their kernels; on CPU
    tensors they run the kernels' plain twins.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, version: int = 2,
                 act: Optional[Callable] = F.relu, use_norm: bool = True,
                 max_displacement: Optional[int] = None,
                 sampler: str = "auto"):
        super().__init__()
        k = kernel_size
        if max_displacement is not None and k != 3:
            raise ValueError(
                f"dcn_fast shift engines support kernel_size=3 only "
                f"(got {k}); use conv_type 'dcn' for other sizes")
        if version not in (1, 2):
            raise ValueError(f"DCN version must be 1 or 2, got {version}")
        if sampler not in ("auto", "fused"):
            raise ValueError(f"unknown DCN sampler {sampler!r}")
        self.kernel_size = k
        self.max_displacement = max_displacement
        self.sampler = sampler
        # SAME: an even k pads (k - 1) // 2 low and k // 2 high
        self.conv_offset = SameConv2d(in_channels, 2 * k * k, k)
        self.conv_mask = (SameConv2d(in_channels, k * k, k)
                          if version == 2 else None)
        self.deform = DeformWeight(in_channels, out_channels, k,
                                   bias=not use_norm)
        self.bn = batch_norm(out_channels) if use_norm else None
        self.act = act

    def _deform(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """The deformable convolution alone: NCHW in, NHWC (N, H, W, O)
        out, in x's dtype. `plain` runs a bounded engine through its
        kernel's plain twin on any device, to hold the kernel against it."""
        k = self.kernel_size
        offsets = _nhwc(self.conv_offset(x))
        mask = (_nhwc(torch.sigmoid(self.conv_mask(x)))
                if self.conv_mask is not None else None)
        xh = _nhwc(x)
        n, h, w, c = xh.shape
        kernel = self.deform.weight.permute(2, 3, 1, 0)     # (k, k, C, O)
        d = self.max_displacement
        if d is None:
            taps = dcn_ops.exact_taps(xh, offsets, mask, k)
        else:
            planes = dcn_ops.dcn_planes(offsets, mask, d)
            if self.sampler == "fused":
                fused = (dcn_ops.fused_reference if plain
                         else dcn_fused.dcn_fused_conv)
                return fused(
                    xh, *planes, kernel.reshape(k * k, c, -1).contiguous(), d)
            sample = (dcn_ops.tap_sample_reference if plain
                      else dcn_sample.dcn_sample_taps)
            taps = sample(xh, *planes, d)
        # sum_t tap_t @ W[t] as one product over K = k^2 C: the matmul
        # accumulates in f32 and rounds once, as the JAX engines' f32 sum
        # of per-tap products cast at the end
        y = torch.matmul(taps.reshape(n * h * w, k * k * c),
                         kernel.reshape(k * k * c, -1))
        return y.reshape(n, h, w, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._deform(x).permute(0, 3, 1, 2)  # NCHW view, channels_last
        if self.bn is not None:
            y = self.bn(y)
        else:
            y = y + self.deform.bias.view(1, -1, 1, 1)
        if self.act is not None:
            y = self.act(y)
        return y


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC; free for a channels_last tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


CONV_BLOCKS = {
    "normal": ConvNormAct,
    "separable": SeparableConvNormAct,
    "dcn": DeformableConvBlock,
    "deformable": DeformableConvBlock,
    # bounded engines: offsets clamped to [-d, d]; "dcn_fast" is d = 2
    "dcn_fast": functools.partial(DeformableConvBlock, max_displacement=2),
    **{f"dcn_fast_d{d}": functools.partial(DeformableConvBlock,
                                           max_displacement=d)
       for d in (1, 2, 3, 4)},
    **{f"dcn_fused_d{d}": functools.partial(
        DeformableConvBlock, max_displacement=d, sampler="fused")
       for d in (1, 2)},
}

def get_conv_block(name: str):
    if name in CONV_BLOCKS:
        return CONV_BLOCKS[name]
    raise KeyError(f"unknown conv block {name!r}; available: "
                   f"{sorted(CONV_BLOCKS)}")
