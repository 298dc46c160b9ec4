"""Shared building blocks (port of models/layers.py: ConvNormAct,
DeformableConvBlock, Upsample).

Modules take and return NCHW tensors; the model keeps them in
`torch.channels_last` memory format, so a convolution reads and writes the
same bytes as the JAX package's NHWC layout.

BatchNorm keeps flax's settings: eps 1e-5, and flax `momentum=0.9` (weight
of the running value) is torch `momentum=0.1` (weight of the new batch).
In train mode it also keeps flax's running-variance update, which takes
the biased batch variance (torch's own `BatchNorm2d` takes the unbiased
one, n/(n-1) larger).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dcn as dcn_ops
from ..ops import dcn_fused, dcn_sample

__all__ = ["BatchNorm2d", "ConvNormAct", "DeformableConvBlock", "DeformWeight",
           "Upsample", "CONV_BLOCKS", "get_conv_block", "batch_norm"]

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` with flax's train-mode statistics.

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
        y, mean, invstd = torch.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.float().pow(-2) - self.eps
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.float(), alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class ConvNormAct(nn.Module):
    """Conv -> BatchNorm -> activation, padding "SAME" (odd kernels).

    Parameters: `conv` (bias only without norm) and `bn`, the flax
    `Conv_0` and `BatchNorm_0` of the same block.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, groups: int = 1,
                 act: Optional[Callable] = F.relu, use_norm: bool = True):
        super().__init__()
        if kernel_size % 2 == 0:
            raise NotImplementedError(
                "ConvNormAct: even kernels need flax's asymmetric SAME "
                "padding; no block on the serving path uses one")
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=kernel_size // 2,
                              groups=groups, bias=not use_norm)
        self.bn = batch_norm(out_channels) if use_norm else None
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class Upsample(nn.Module):
    """x2 upsample: nearest or bilinear (half-pixel centres, as
    `jax.image.resize`). The conv_transpose form carries weights and waits
    for the slice that ports the remaining necks and blocks."""

    def __init__(self, method: str = "nearest"):
        super().__init__()
        if method == "conv_transpose":
            raise NotImplementedError(
                "Upsample(method='conv_transpose') is ported with the "
                "remaining necks and blocks (ROADMAP Queue 1 item 8)")
        if method not in ("nearest", "bilinear"):
            raise ValueError(f"unknown upsample method {method!r}")
        self.method = method

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.method == "nearest":
            return F.interpolate(x, scale_factor=2, mode="nearest")
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)


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
        (ops/dcn.py:exact_taps), any odd k;
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
        if k % 2 == 0:
            raise NotImplementedError(
                "DeformableConvBlock: even kernels need flax's asymmetric "
                "SAME padding; no block on the serving path uses one")
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
        self.conv_offset = nn.Conv2d(in_channels, 2 * k * k, k, padding=k // 2)
        self.conv_mask = (nn.Conv2d(in_channels, k * k, k, padding=k // 2)
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

_LATER_BLOCKS = {
    "separable": "the remaining necks and blocks (ROADMAP Queue 1 item 8)",
}


def get_conv_block(name: str):
    if name in CONV_BLOCKS:
        return CONV_BLOCKS[name]
    if name in _LATER_BLOCKS:
        raise NotImplementedError(
            f"conv block {name!r} is ported with {_LATER_BLOCKS[name]}")
    raise KeyError(f"unknown conv block {name!r}; available: "
                   f"{sorted(CONV_BLOCKS)}")
