"""DCN tap sampling: the CUDA kernel and its dispatch (port of
ops/pallas_dcn.py:dcn_sample_all_taps).

`dcn_sample_taps` launches `csrc/dcn_sample.cu` on a CUDA tensor and runs
the plain twin `ops/dcn.py:tap_sample_reference` on a CPU tensor; there is
no other fallback. The per-tap matrix product that follows stays outside
the kernel, as it stays outside Pallas in the JAX package.

It is differentiable in x, fy, fx and wm (not in the integer floors): the
backward recomputes through the twin on either device, as the JAX
package's custom VJP recomputes through `_xla_all`. There is no backward
kernel, as there is none in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import dcn as dcn_ops

__all__ = ["dcn_sample_taps", "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "centernet_lightning_torch/csrc/dcn_sample.cu"
REPLACES = "centernet_lightning_tpu/ops/pallas_dcn.py:181"


@functools.cache
def _launch_fn():
    from ._build import load

    fn = load("dcn_sample").dcn_sample_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dcn_sample_taps(x: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor,
                    fy: torch.Tensor, fx: torch.Tensor, wm: torch.Tensor,
                    d: int) -> torch.Tensor:
    """All nine taps' bounded-offset bilinear samples.

    x (N, H, W, C) float32 or bfloat16; the planes as `ops/dcn.py:
    dcn_planes` returns them for max displacement d. On a CUDA tensor this
    launches the kernel (counted in `dcn_sample_taps.launches`) or raises;
    on a CPU tensor it returns `tap_sample_reference`. Returns
    (N, H, W, 9, C) in x's dtype.
    """
    dcn_ops.check_sampling_inputs(x, (a0, b0, fy, fx, wm), d)
    return _SampleTaps.apply(x, a0, b0, fy, fx, wm, d)


class _SampleTaps(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the twin (CPU). Backward: the twin's
    gradient, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, a0, b0, fy, fx, wm, d):
        ctx.d = d
        ctx.save_for_backward(x, a0, b0, fy, fx, wm)
        return _forward(x, (a0, b0, fy, fx, wm), d)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        wants = [ctx.needs_input_grad[i] and i in (0, 3, 4, 5)
                 for i in range(len(inputs))]
        return (*dcn_ops.twin_vjp(dcn_ops.tap_sample_reference, inputs, wants,
                                  grad, ctx.d), None)


def _forward(x: torch.Tensor, planes, d: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return dcn_ops.tap_sample_reference(x, *planes, d)
    if x.device.type != "cuda":
        raise ValueError(f"no DCN sampling kernel for device {x.device}")
    if not (x.is_contiguous() and all(p.is_contiguous() for p in planes)):
        raise ValueError("x and the planes must be contiguous")
    n, h, w, c = x.shape
    if n * h * w == 0 or c == 0:
        raise ValueError(f"empty map {tuple(x.shape)}")
    taps = torch.empty((n, h, w, len(dcn_ops.TAPS), c), dtype=x.dtype,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launch_fn()(
            x.data_ptr(), *(p.data_ptr() for p in planes), taps.data_ptr(),
            n, h, w, c, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"dcn_sample kernel launch failed: CUDA error {err}")
    dcn_sample_taps.launches += 1
    return taps


dcn_sample_taps.launches = 0
