"""DCN tap sampling: the CUDA kernel and its dispatch (port of
ops/pallas_dcn.py:dcn_sample_all_taps).

`dcn_sample_taps` launches `csrc/dcn_sample.cu` on a CUDA tensor and runs
the plain twin `ops/dcn.py:tap_sample_reference` on a CPU tensor; there is
no other fallback. While a program is traced (`torch.export`) it goes
through the operator `torch.ops.centernet_lightning.dcn_sample_taps`
instead, which dispatches to the same two (ops/_library.py). The per-tap
matrix product that follows stays outside the kernel, as it stays outside
Pallas in the JAX package.

It is differentiable in x, fy, fx and wm (not in the integer floors). On a
CUDA tensor the backward is one launch of the backward kernel in the same
source (`dcn_sample_taps_backward`, counted in
`dcn_sample_taps.grad_launches`; its plain twin is
`ops/dcn.py:tap_sample_backward_reference`), inside the span
`dcn.recompute`. The JAX package has no backward kernel: its custom VJP
recomputes through `_xla_all` under `jax.vjp`, and on a CPU tensor the port
does the same through the twin (`ops/dcn.py:twin_vjp`). The kernel sums in
f32 with atomics, in an order that changes from run to run, and rounds dx
to x's dtype once. The exported operator is forward-only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
from torch.overrides import handle_torch_function, has_torch_function

from ..utils.spans import span
from . import dcn as dcn_ops
from ._library import LIB, traced

__all__ = ["dcn_sample_taps", "dcn_sample_taps_backward", "dcn_sample_taps_op",
           "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "centernet_lightning_torch/csrc/dcn_sample.cu"
REPLACES = "centernet_lightning_tpu/ops/pallas_dcn.py:181"


@functools.cache
def _launch_fn():
    from ._build import load

    fn = load("dcn_sample").dcn_sample_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _grad_launch_fn():
    from ._build import load

    fn = load("dcn_sample").dcn_sample_grad_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dcn_sample_taps(x: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor,
                    fy: torch.Tensor, fx: torch.Tensor, wm: torch.Tensor,
                    d: int) -> torch.Tensor:
    """All nine taps' bounded-offset bilinear samples.

    x (N, H, W, C) float32 or bfloat16; the planes as `ops/dcn.py:
    dcn_planes` returns them for max displacement d. On a CUDA tensor this
    launches the kernel (counted in `dcn_sample_taps.launches`) or raises;
    on a CPU tensor it returns `tap_sample_reference`; a traced x goes
    through the operator. A torch function mode sees the call whole
    (parallel/mesh.py's height split gives it halo rows). Returns
    (N, H, W, 9, C) in x's dtype.
    """
    args = (x, a0, b0, fy, fx, wm)
    if has_torch_function(args):
        return handle_torch_function(dcn_sample_taps, args, *args, d)
    dcn_ops.check_sampling_inputs(x, args[1:], d)
    if traced(x):
        return dcn_sample_taps_op(*args, d)
    return _SampleTaps.apply(*args, d)


class _SampleTaps(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the twin (CPU). Backward: the
    backward kernel (CUDA) or the twin's gradient, recomputed from the
    saved inputs (CPU)."""

    @staticmethod
    def forward(ctx, x, a0, b0, fy, fx, wm, d):
        ctx.d = d
        ctx.save_for_backward(x, a0, b0, fy, fx, wm)
        return _forward(x, (a0, b0, fy, fx, wm), d)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        if grad.device.type == "cuda":
            with span("dcn.recompute"):
                dx, dfy, dfx, dwm = dcn_sample_taps_backward(
                    *inputs, grad.contiguous(),
                    [ctx.needs_input_grad[i] for i in (0, 3, 4, 5)])
            return dx, None, None, dfy, dfx, dwm, None
        wants = [ctx.needs_input_grad[i] and i in (0, 3, 4, 5)
                 for i in range(len(inputs))]
        return (*dcn_ops.twin_vjp(dcn_ops.tap_sample_reference, inputs, wants,
                                  grad, ctx.d), None)


def _forward(x: torch.Tensor, planes, d: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return dcn_ops.tap_sample_reference(x, *planes, d)
    if x.device.type != "cuda":
        raise ValueError(f"no DCN sampling kernel for device {x.device}")
    return _launch(x, *planes, d)


def _launch(x, a0, b0, fy, fx, wm, d):
    """Launch csrc/dcn_sample.cu on x's current stream."""
    planes = (a0, b0, fy, fx, wm)
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
dcn_sample_taps.grad_launches = 0


def dcn_sample_taps_backward(x: torch.Tensor, a0: torch.Tensor,
                             b0: torch.Tensor, fy: torch.Tensor,
                             fx: torch.Tensor, wm: torch.Tensor,
                             grad_taps: torch.Tensor,
                             wants: Sequence[bool] = (True,) * 4):
    """Gradients of `dcn_sample_taps` from one launch of csrc/dcn_sample.cu's
    backward kernel on x's current stream (counted in
    `dcn_sample_taps.grad_launches`); CUDA tensors only.

    x (N, H, W, C) float32 or bfloat16 and the planes as for the forward,
    grad_taps (N, H, W, 9, C) in x's dtype, all contiguous; `wants` says
    which of (dx, dfy, dfx, dwm) to compute. Returns them, None where not
    wanted: dx in x's dtype (summed in f32, rounded once), the others f32
    (N, H, W, 9). Raises on any other device, shape, dtype or layout.
    """
    planes = (a0, b0, fy, fx, wm)
    dcn_ops.check_sampling_inputs(x, planes, None)
    want = (*x.shape[:3], len(dcn_ops.TAPS), x.shape[3])
    if tuple(grad_taps.shape) != want:
        raise ValueError(f"grad_taps must be {want}, got {tuple(grad_taps.shape)}")
    if grad_taps.dtype != x.dtype:
        raise TypeError(f"grad_taps must be {x.dtype}, got {grad_taps.dtype}")
    if grad_taps.device != x.device:
        raise ValueError(f"grad_taps is on {grad_taps.device}, x on {x.device}")
    if len(wants) != 4:
        raise ValueError(f"wants names (dx, dfy, dfx, dwm), got {wants!r}")
    if x.device.type != "cuda":
        raise ValueError(f"no DCN sampling backward kernel for device {x.device}: "
                         "the CPU backward is ops/dcn.py:twin_vjp")
    if not (x.is_contiguous() and grad_taps.is_contiguous()
            and all(p.is_contiguous() for p in planes)):
        raise ValueError("x, grad_taps and the planes must be contiguous")
    n, h, w, c = x.shape
    if n * h * w == 0 or c == 0:
        raise ValueError(f"empty map {tuple(x.shape)}")
    if not any(wants):
        return (None,) * 4
    outs = [torch.empty(shape, dtype=torch.float32, device=x.device) if wanted
            else None
            for shape, wanted in zip((x.shape, *(fy.shape,) * 3), wants)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _grad_launch_fn()(
            x.data_ptr(), *(p.data_ptr() for p in planes), grad_taps.data_ptr(),
            *(o.data_ptr() if o is not None else None for o in outs),
            n, h, w, c, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"dcn_sample_grad kernel launch failed: CUDA error {err}")
    dcn_sample_taps.grad_launches += 1
    dx = outs[0]
    if dx is not None and dx.dtype != x.dtype:
        dx = dx.to(x.dtype)
    return (dx, *outs[1:])


def _meta(x, a0, b0, fy, fx, wm, d):
    n, h, w, c = x.shape
    return x.new_empty((n, h, w, len(dcn_ops.TAPS), c))


LIB.define("dcn_sample_taps(Tensor x, Tensor a0, Tensor b0, Tensor fy, "
           "Tensor fx, Tensor wm, int d) -> Tensor")
LIB.impl("dcn_sample_taps", dcn_ops.tap_sample_reference, "CPU")
LIB.impl("dcn_sample_taps", _launch, "CUDA")
LIB.impl("dcn_sample_taps", _meta, "Meta")
dcn_sample_taps_op = torch.ops.centernet_lightning.dcn_sample_taps
