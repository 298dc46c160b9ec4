"""Deformable convolution (DCN) in plain PyTorch: the sampling planes, the
twins of the two CUDA kernels, and the exact gather engine (port of the DCN
parts of models/layers.py and ops/pallas_dcn.py).

Layouts, as the CUDA kernels take them:
  x        (N, H, W, C) NHWC activation, the model's dtype;
  offsets  (N, H, W, 2T) as (dy, dx) pairs per tap, taps in row-major
           order (ty, tx) = (-1, -1), (-1, 0), ..., (1, 1); T = 9;
  planes   a0, b0 int32 and fy, fx, wm float32, each (N, H, W, T): the
           floor of the sample relative to the pixel, its fraction, and the
           modulation (ones for DCNv1);
  taps     (N, H, W, T, C): tap t of pixel p is the bilinear sample of x at
           p + tap_t + clamp(offset, -d, d), times the modulation. The
           tap-major (T*C, O) kernel then makes sum_t tap_t @ W[t] one
           matrix product over K = T*C.

The bounded engines (d = max displacement) clamp the offsets to [-d, d]
and clip the floors into [tap - d, tap + d - 1]: at u == tap + d the
sample (floor tap + d, fraction 0) becomes the identical (tap + d - 1, 1),
so every nonzero bilinear weight falls on one of (2d+1)^2 shifts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from ..utils.spans import span

__all__ = ["TAPS", "dcn_planes", "tap_sample_reference",
           "tap_sample_backward_reference", "fused_reference", "exact_taps",
           "check_sampling_inputs", "twin_vjp"]

# (ty, tx) of the 3x3 taps in row-major order, as the JAX block orders them
TAPS = tuple((ty, tx) for ty in (-1, 0, 1) for tx in (-1, 0, 1))

Planes = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor]


def _tap_vectors(device) -> Tuple[torch.Tensor, torch.Tensor]:
    ty = torch.tensor([t[0] for t in TAPS], dtype=torch.float32, device=device)
    tx = torch.tensor([t[1] for t in TAPS], dtype=torch.float32, device=device)
    return ty, tx


def dcn_planes(offsets: torch.Tensor, mask: Optional[torch.Tensor],
               d: int) -> Planes:
    """Sampling planes of the bounded engines (JAX models/layers.py
    DeformableConvBlock, max_displacement=d).

    offsets (N, H, W, 2T) and mask (N, H, W, T) after the sigmoid, or None
    for DCNv1, both in the model's dtype. Returns a0, b0 (int32) and fy,
    fx, wm (float32), each (N, H, W, T) contiguous.
    """
    n, h, w, two_t = offsets.shape
    if two_t != 2 * len(TAPS):
        raise ValueError(f"offsets must have {2 * len(TAPS)} channels, "
                         f"got {two_t}")
    off = offsets.reshape(n, h, w, len(TAPS), 2)
    ty, tx = _tap_vectors(offsets.device)
    # the clamp runs in the model's dtype, as in the JAX block; integer
    # bounds are exact in bf16, so it commutes with the widening
    u = ty + off[..., 0].clamp(-d, d).float()
    v = tx + off[..., 1].clamp(-d, d).float()
    a0f = torch.minimum(torch.maximum(torch.floor(u), ty - d), ty + d - 1)
    b0f = torch.minimum(torch.maximum(torch.floor(v), tx - d), tx + d - 1)
    fy = u - a0f
    fx = v - b0f
    wm = mask.float() if mask is not None else torch.ones_like(fy)
    return (a0f.to(torch.int32).contiguous(), b0f.to(torch.int32).contiguous(),
            fy.contiguous(), fx.contiguous(), wm.contiguous())


def check_sampling_inputs(x: torch.Tensor, planes: Planes,
                          d: Optional[int]) -> None:
    """Shape, dtype and device checks shared by the kernel wrappers (d None:
    the sampler's backward, which takes no displacement bound)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if d is not None and (not isinstance(d, int) or d < 1):
        raise ValueError(f"max displacement must be a positive int, got {d!r}")
    want = (*x.shape[:3], len(TAPS))
    for name, p, dtype in zip(("a0", "b0", "fy", "fx", "wm"), planes,
                              (torch.int32, torch.int32, torch.float32,
                               torch.float32, torch.float32)):
        if tuple(p.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(p.shape)}")
        if p.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {p.dtype}")
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")


def twin_vjp(twin, inputs, wants, grad: torch.Tensor, *static):
    """The backward of the fused DCN kernel, and of the sampler on a CPU
    tensor: recompute the twin with grad enabled and return
    d(twin)/d(input) . grad for each input whose `wants` is true (None for
    the others), as the JAX package's custom VJPs do with `jax.vjp` of the
    XLA twin (ops/pallas_dcn.py:398-406, 417-426). The whole of it is the
    span `dcn.recompute`."""
    with span("dcn.recompute"), torch.enable_grad():
        leaves = [t.detach().requires_grad_() if w else t
                  for t, w in zip(inputs, wants)]
        wrt = [t for t, w in zip(leaves, wants) if w]
        got = iter(torch.autograd.grad(twin(*leaves, *static), wrt, grad)
                   if wrt else ())
        return tuple(next(got) if w else None for w in wants)


def _pad_hw(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, 0, pad, pad, pad, pad))    # NHWC: W, then H


def _axis_weight(f0: torch.Tensor, frac: torch.Tensor, s: int) -> torch.Tensor:
    """Bilinear weight of shift s along one axis: 1 - frac on the floor,
    frac on floor + 1, 0 elsewhere (f32)."""
    return torch.where(f0 == s, 1.0 - frac,
                       torch.where(f0 + 1 == s, frac, torch.zeros_like(frac)))


def tap_sample_reference(x: torch.Tensor, a0, b0, fy, fx, wm,
                         d: int) -> torch.Tensor:
    """Twin of csrc/dcn_sample.cu: the JAX `xla_tap_sample` for every tap
    (ops/pallas_dcn.py:50-69, 193-198), in NHWC.

    Per tap it sums the (2d+1)^2 masked shifts of the zero-padded map in
    x's dtype: the weight (wy * wm) * wx is formed in f32 and rounded to
    the dtype, then the product and the running sum round to the dtype.
    Returns (N, H, W, T, C) in x.dtype.
    """
    n, h, w, c = x.shape
    pad = d + 2
    xp = _pad_hw(x, pad)
    taps = []
    for t, (ity, itx) in enumerate(TAPS):
        acc = torch.zeros_like(x)
        for sa in range(ity - d, ity + d + 1):
            wy = _axis_weight(a0[..., t], fy[..., t], sa) * wm[..., t]
            for sb in range(itx - d, itx + d + 1):
                wx = _axis_weight(b0[..., t], fx[..., t], sb)
                sl = xp[:, pad + sa:pad + sa + h, pad + sb:pad + sb + w]
                acc = acc + (wy * wx).to(x.dtype)[..., None] * sl
        taps.append(acc)
    return torch.stack(taps, dim=3)


def tap_sample_backward_reference(x: torch.Tensor, a0, b0, fy, fx, wm,
                                  grad_taps: torch.Tensor):
    """Twin of csrc/dcn_sample.cu's backward (`dcn_sample_grad`): the
    gradients of `tap_sample_reference` in the four-corner form, with no
    recompute and no displacement bound (the planes carry the clipped
    floors). For each pixel p, tap t and corner (r, s) inside the image,
    with g = grad_taps[p, t], x_rs the corner's channels, wy = (1 - fy, fy)
    and wx = (1 - fx, fx):

      dx[corner] += ((wy_r * wm) * wx_s) * g      (by index_add_)
      dfy = wm * sum_c g * (wx_0 (x10 - x00) + wx_1 (x11 - x01))
      dfx = wm * sum_c g * (wy_0 (x01 - x00) + wy_1 (x11 - x10))
      dwm = sum_c g * sum_rs wy_r wx_s x_rs

    Corners outside the image contribute nothing, as the twin's zero pad.
    Sums run in f32; dx is rounded to x's dtype once. grad_taps (N, H, W,
    T, C). Returns (dx in x.dtype, dfy, dfx, dwm in f32).
    """
    n, h, w, c = x.shape
    t = len(TAPS)
    g = grad_taps.float()
    flat = x.float().reshape(n * h * w, c)
    dx = torch.zeros((n * h * w, c), dtype=torch.float32, device=x.device)
    dev = x.device
    ys = torch.arange(h, device=dev).view(1, h, 1, 1)
    xs = torch.arange(w, device=dev).view(1, 1, w, 1)
    base = (torch.arange(n, device=dev) * (h * w)).view(n, 1, 1, 1)
    wy = (1.0 - fy, fy)
    wx = (1.0 - fx, fx)
    dot = {}
    for r in (0, 1):
        yy = ys + a0.long() + r
        for s in (0, 1):
            xx = xs + b0.long() + s
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (base + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(-1)
            corner = flat[idx].reshape(n, h, w, t, c)
            dot[r, s] = torch.where(inside, (g * corner).sum(-1), 0.0)
            wgt = torch.where(inside, (wy[r] * wm) * wx[s], 0.0)
            dx.index_add_(0, idx, (wgt[..., None] * g).reshape(-1, c))
    dfy = wm * (wx[0] * (dot[1, 0] - dot[0, 0]) + wx[1] * (dot[1, 1] - dot[0, 1]))
    dfx = wm * (wy[0] * (dot[0, 1] - dot[0, 0]) + wy[1] * (dot[1, 1] - dot[1, 0]))
    dwm = (wy[0] * (wx[0] * dot[0, 0] + wx[1] * dot[0, 1])
           + wy[1] * (wx[0] * dot[1, 0] + wx[1] * dot[1, 1]))
    return dx.reshape(n, h, w, c).to(x.dtype), dfy, dfx, dwm


def fused_reference(x: torch.Tensor, a0, b0, fy, fx, wm,
                    kernel: torch.Tensor, d: int) -> torch.Tensor:
    """Twin of csrc/dcn_fused.cu: the JAX `_xla_fused_ref`
    (ops/pallas_dcn.py:310-328) with the fused kernel's numerics
    (`_fused_kernel`, :233-256): each tap is sampled in f32 with the
    per-term weight (wy * wm) * wx, rounded to the kernel's dtype, and
    multiplied by kernel[t] with an f32 accumulator across all taps; the
    sum is cast once to x's dtype.

    kernel (T, C, O). Returns (N, H, W, O) in x.dtype.
    """
    n, h, w, c = x.shape
    pad = d + 2
    xp = _pad_hw(x.float(), pad)
    acc = x.new_zeros((n, h, w, kernel.shape[-1]), dtype=torch.float32)
    for t, (ity, itx) in enumerate(TAPS):
        samp = torch.zeros((n, h, w, c), dtype=torch.float32, device=x.device)
        for sa in range(ity - d, ity + d + 1):
            wy = _axis_weight(a0[..., t], fy[..., t], sa) * wm[..., t]
            for sb in range(itx - d, itx + d + 1):
                w9 = wy * _axis_weight(b0[..., t], fx[..., t], sb)
                sl = xp[:, pad + sa:pad + sa + h, pad + sb:pad + sb + w]
                samp = samp + w9[..., None] * sl
        # products of two values of the kernel's dtype are exact in f32,
        # so an f32 matmul of the rounded operands is an f32-accumulated
        # product of the rounded values
        acc = acc + torch.matmul(samp.to(kernel.dtype).float(),
                                 kernel[t].float())
    return acc.to(x.dtype)


def exact_taps(x: torch.Tensor, offsets: torch.Tensor,
               mask: Optional[torch.Tensor], k: int = 3) -> torch.Tensor:
    """The exact engine (JAX models/layers.py:154-180, 302-313): per tap,
    the bilinear sample at p + tap + offset with unbounded offsets and
    zeros outside the image (torchvision DeformConv2d), from its four
    corners in f32, times the mask, rounded to x's dtype.

    x (N, H, W, C); offsets (N, H, W, 2k^2); mask (N, H, W, k^2) or None.
    Returns (N, H, W, k^2, C) in x.dtype. A torch function mode sees the
    call whole (parallel/mesh.py's height split gives it the whole map).
    Each computation is the span `dcn.exact` and counts one in
    `exact_taps.calls`.
    """
    args = (x, offsets) if mask is None else (x, offsets, mask)
    if has_torch_function(args):
        return handle_torch_function(exact_taps, args, x, offsets, mask, k)
    exact_taps.calls += 1
    with span("dcn.exact"):
        return _exact_taps(x, offsets, mask, k)


exact_taps.calls = 0


def _exact_taps(x: torch.Tensor, offsets: torch.Tensor,
                mask: Optional[torch.Tensor], k: int) -> torch.Tensor:
    n, h, w, c = x.shape
    flat = x.reshape(n * h * w, c)
    off = offsets.reshape(n, h, w, k * k, 2).float()
    dev = x.device
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    base = (torch.arange(n, device=dev) * (h * w)).view(n, 1, 1)
    half = (k - 1) // 2
    taps = []
    for t in range(k * k):
        sy = ys + float(t // k - half) + off[..., t, 0]
        sx = xs + float(t % k - half) + off[..., t, 1]
        y0 = torch.floor(sy)
        x0 = torch.floor(sx)
        wy = sy - y0
        wx = sx - x0
        iy = y0.long()
        ix = x0.long()
        val = torch.zeros((n, h, w, c), dtype=torch.float32, device=dev)
        for r, wgt_y in ((0, 1 - wy), (1, wy)):
            yy = iy + r
            for s, wgt_x in ((0, 1 - wx), (1, wx)):
                xx = ix + s
                inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                idx = base + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
                corner = flat[idx.reshape(-1)].reshape(n, h, w, c)
                wgt = torch.where(inside, wgt_y * wgt_x, torch.zeros_like(wy))
                val = val + corner.float() * wgt[..., None]
        if mask is not None:
            val = val * mask[..., t:t + 1].float()
        taps.append(val.to(x.dtype))
    return torch.stack(taps, dim=3)
