"""Fused DCN (tap sampling + per-tap matrix product): the CUDA kernel and
its dispatch (port of ops/pallas_dcn.py:dcn_fused_conv).

`dcn_fused_conv` launches `csrc/dcn_fused.cu` on a CUDA tensor and runs
the plain twin `ops/dcn.py:fused_reference` on a CPU tensor; there is no
other fallback. The kernel takes the sampling planes, not the TPU kernel's
per-term weights (see the note in the source).

It is differentiable in x, fy, fx, wm and the kernel (not in the integer
floors): the backward recomputes through the twin on either device, as
the JAX package's custom VJP recomputes through `_xla_fused_ref`. There is
no backward kernel, as there is none in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import dcn as dcn_ops

__all__ = ["dcn_fused_conv", "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "centernet_lightning_torch/csrc/dcn_fused.cu"
REPLACES = "centernet_lightning_tpu/ops/pallas_dcn.py:332"
# the widest C whose tiles fit one block (csrc/dcn_fused.cu: smem_bytes
# <= kMaxSmem); the launch returns cudaErrorInvalidValue past it
_MAX_CHANNELS = {torch.bfloat16: 416, torch.float32: 208}


@functools.cache
def _launch_fn():
    from ._build import load

    lib = load("dcn_fused")
    lib.dcn_fused_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                     + [ctypes.c_void_p])
    lib.dcn_fused_launch.restype = ctypes.c_int
    return lib.dcn_fused_launch


def dcn_fused_conv(x: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor,
                   fy: torch.Tensor, fx: torch.Tensor, wm: torch.Tensor,
                   kernel: torch.Tensor, d: int) -> torch.Tensor:
    """Bounded-offset deformable convolution in one kernel.

    x (N, H, W, C) float32 or bfloat16; the planes as `ops/dcn.py:
    dcn_planes` returns them for max displacement d; kernel (9, C, O) in
    x's dtype, tap-major. On a CUDA tensor this launches the kernel
    (counted in `dcn_fused_conv.launches`) or raises; on a CPU tensor it
    returns `fused_reference`. Returns (N, H, W, O) in x's dtype.
    """
    planes = (a0, b0, fy, fx, wm)
    dcn_ops.check_sampling_inputs(x, planes, d)
    n, h, w, c = x.shape
    if kernel.dim() != 3 or kernel.shape[:2] != (len(dcn_ops.TAPS), c):
        raise ValueError(f"kernel must be ({len(dcn_ops.TAPS)}, {c}, O), "
                         f"got {tuple(kernel.shape)}")
    if kernel.dtype != x.dtype or kernel.device != x.device:
        raise TypeError(f"kernel is {kernel.dtype} on {kernel.device}, "
                        f"x is {x.dtype} on {x.device}")
    return _FusedConv.apply(x, a0, b0, fy, fx, wm, kernel, d)


class _FusedConv(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the twin (CPU). Backward: the twin's
    gradient, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, a0, b0, fy, fx, wm, kernel, d):
        ctx.d = d
        ctx.save_for_backward(x, a0, b0, fy, fx, wm, kernel)
        return _forward(x, (a0, b0, fy, fx, wm), kernel, d)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        wants = [ctx.needs_input_grad[i] and i in (0, 3, 4, 5, 6)
                 for i in range(len(inputs))]
        return (*dcn_ops.twin_vjp(dcn_ops.fused_reference, inputs, wants,
                                  grad, ctx.d), None)


def _forward(x: torch.Tensor, planes, kernel: torch.Tensor,
             d: int) -> torch.Tensor:
    n, h, w, c = x.shape
    if x.device.type == "cpu":
        return dcn_ops.fused_reference(x, *planes, kernel, d)
    if x.device.type != "cuda":
        raise ValueError(f"no fused DCN kernel for device {x.device}")
    if not (x.is_contiguous() and kernel.is_contiguous()
            and all(p.is_contiguous() for p in planes)):
        raise ValueError("x, the planes and the kernel must be contiguous")
    o = kernel.shape[2]
    if n * h * w == 0 or c == 0 or o == 0:
        raise ValueError(f"empty map {tuple(x.shape)} or kernel "
                         f"{tuple(kernel.shape)}")
    out = torch.empty((n, h, w, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launch_fn()(
            x.data_ptr(), *(p.data_ptr() for p in planes), kernel.data_ptr(),
            out.data_ptr(), n, h, w, c, o, int(x.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(
            f"dcn_fused kernel launch failed: CUDA error {err} (1, invalid "
            f"value, when C={c} is over the {_MAX_CHANNELS[x.dtype]} "
            f"{x.dtype} channels that fit one block's shared memory, or "
            f"N*H*W >= 2^31)")
    dcn_fused_conv.launches += 1
    return out


dcn_fused_conv.launches = 0
