"""Fused DCN (tap sampling + per-tap matrix product): the CUDA kernel and
its dispatch (port of ops/pallas_dcn.py:dcn_fused_conv).

`dcn_fused_conv` launches `csrc/dcn_fused.cu` on a CUDA tensor and runs
the plain twin `ops/dcn.py:fused_reference` on a CPU tensor; there is no
other fallback. While a program is traced (`torch.export`) it goes through
the operator `torch.ops.centernet_lightning.dcn_fused_conv` instead, whose
CUDA implementation makes the weight re-layout itself, so a loaded program
needs no packing of its own (ops/_library.py). The kernel takes the sampling planes, not the TPU kernel's
per-term weights (see the note in the source). In bf16 the kernel reads
the weights as `pack_wgmma_kernel` lays them out, a re-layout made on
every call; in f32 it reads them as given.

It is differentiable in x, fy, fx, wm and the kernel (not in the integer
floors): the backward recomputes through the twin on either device, as
the JAX package's custom VJP recomputes through `_xla_fused_ref`. There is
no backward kernel, as there is none in the JAX package.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from . import dcn as dcn_ops
from ._library import LIB, traced

__all__ = ["dcn_fused_conv", "dcn_fused_conv_op", "pack_wgmma_kernel", "check_launch", "kernel_info",
           "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "centernet_lightning_torch/csrc/dcn_fused.cu"
REPLACES = "centernet_lightning_tpu/ops/pallas_dcn.py:332"
# the widest f32 C whose tiles fit one block (csrc/dcn_fused.cu:
# fma_smem_bytes <= kMaxSmem); the launch returns cudaErrorInvalidValue
# past it. bf16 takes any C (it streams C in chunks of 64)
_MAX_F32_CHANNELS = 208
# the bf16 kernel's tiles (csrc/dcn_fused.cu: kBK channels a chunk, kBN
# outputs a block)
_CHUNK, _OTILE = 64, 128


def pack_wgmma_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The (9, C, O) kernel as the bf16 kernel's W tiles: blocks of
    (chunk kc, tap t, O tile) in that order, each 128 outputs x 64
    channels, K-major (a row is one output's 64 channels, 128 bytes), the
    16-byte group g of row n stored at g ^ (n % 8) (the 128-byte swizzle
    of the wgmma descriptor), zeros past C and O. Returns a contiguous
    (ceil(C/64), 9, ceil(O/128), 128, 64) tensor of kernel's dtype.

    On a CUDA bf16 tensor this launches the re-layout kernel of
    csrc/dcn_fused.cu (part of each bf16 fused call); otherwise it is the
    plain twin: one gather from the flat kernel with a zero appended."""
    taps, c, o = kernel.shape
    if kernel.device.type == "cuda" and kernel.dtype == torch.bfloat16:
        packed = torch.empty((-(-c // _CHUNK), taps, -(-o // _OTILE), _OTILE,
                              _CHUNK), dtype=kernel.dtype, device=kernel.device)
        err = _lib().dcn_fused_pack_launch(
            kernel.contiguous().data_ptr(), packed.data_ptr(), c, o,
            torch.cuda.current_stream(kernel.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"dcn_fused pack launch failed: CUDA error {err}")
        return packed
    flat = F.pad(kernel.reshape(-1), (0, 1))
    # the gather's result takes the index's strides: lay it out in order
    return flat[_pack_index(taps, c, o, kernel.device)].contiguous()


@functools.lru_cache(maxsize=32)
def _pack_index(taps: int, c: int, o: int, device) -> torch.Tensor:
    """For each element of pack_wgmma_kernel's result, its index in the
    flat (taps, C, O) kernel, or taps * C * O (the appended zero)."""
    kc, ot = -(-c // _CHUNK), -(-o // _OTILE)
    idx = torch.arange(taps * c * o, device=device).view(taps, c, o)
    idx = F.pad(idx, (0, ot * _OTILE - o, 0, kc * _CHUNK - c),
                value=taps * c * o)
    idx = idx.view(taps, kc, _CHUNK, ot, _OTILE).permute(1, 0, 3, 4, 2)
    idx = idx.reshape(kc, taps, ot, _OTILE, 8, 8)   # (..., n, group, value)
    n = torch.arange(_OTILE, device=device)[:, None]
    groups = torch.arange(8, device=device)[None, :] ^ (n % 8)
    return idx[..., n, groups, :].reshape(kc, taps, ot, _OTILE, _CHUNK).contiguous()


@functools.cache
def _lib():
    from ._build import load

    lib = load("dcn_fused")
    lib.dcn_fused_bf16_launch.argtypes = ([ctypes.c_void_p] * 8
                                          + [ctypes.c_int] * 5
                                          + [ctypes.c_void_p])
    lib.dcn_fused_bf16_launch.restype = ctypes.c_int
    lib.dcn_fused_f32_launch.argtypes = ([ctypes.c_void_p] * 8
                                         + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.dcn_fused_f32_launch.restype = ctypes.c_int
    lib.dcn_fused_bf16_info.argtypes = [ctypes.c_void_p]
    lib.dcn_fused_bf16_info.restype = ctypes.c_int
    lib.dcn_fused_pack_launch.argtypes = ([ctypes.c_void_p] * 2
                                          + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.dcn_fused_pack_launch.restype = ctypes.c_int
    return lib


def kernel_info() -> dict:
    """The bf16 kernel's registers a thread, local (spilled) bytes a
    thread, static and dynamic shared bytes a block and pipeline stages
    (the card's cudaFuncGetAttributes and the launch's constants)."""
    out = (ctypes.c_int * 5)()
    err = _lib().dcn_fused_bf16_info(out)
    if err != 0:
        raise RuntimeError(f"dcn_fused_bf16_info failed: CUDA error {err}")
    keys = ("registers", "local_bytes", "static_smem_bytes",
            "dynamic_smem_bytes", "stages")
    return dict(zip(keys, out))


def dcn_fused_conv(x: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor,
                   fy: torch.Tensor, fx: torch.Tensor, wm: torch.Tensor,
                   kernel: torch.Tensor, d: int) -> torch.Tensor:
    """Bounded-offset deformable convolution in one kernel.

    x (N, H, W, C) float32 or bfloat16; the planes as `ops/dcn.py:
    dcn_planes` returns them for max displacement d; kernel (9, C, O) in
    x's dtype, tap-major. On a CUDA tensor this launches the kernel
    (counted in `dcn_fused_conv.launches`) or raises; on a CPU tensor it
    returns `fused_reference`; a traced x goes through the operator. A
    torch function mode sees the call whole (parallel/mesh.py's height
    split gives it halo rows). Returns (N, H, W, O) in x's dtype.
    """
    args = (x, a0, b0, fy, fx, wm, kernel)
    if has_torch_function(args):
        return handle_torch_function(dcn_fused_conv, args, *args, d)
    planes = (a0, b0, fy, fx, wm)
    dcn_ops.check_sampling_inputs(x, planes, d)
    n, h, w, c = x.shape
    if kernel.dim() != 3 or kernel.shape[:2] != (len(dcn_ops.TAPS), c):
        raise ValueError(f"kernel must be ({len(dcn_ops.TAPS)}, {c}, O), "
                         f"got {tuple(kernel.shape)}")
    if kernel.dtype != x.dtype or kernel.device != x.device:
        raise TypeError(f"kernel is {kernel.dtype} on {kernel.device}, "
                        f"x is {x.dtype} on {x.device}")
    if traced(x):
        return dcn_fused_conv_op(*args, d)
    return _FusedConv.apply(*args, d)


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


def check_launch(x: torch.Tensor, planes, kernel: torch.Tensor) -> None:
    """What the kernel takes beyond `dcn_fused_conv`'s checks, held before
    a launch: contiguous x, planes and kernel, and no empty dimension."""
    if not (x.is_contiguous() and kernel.is_contiguous()
            and all(p.is_contiguous() for p in planes)):
        raise ValueError("x, the planes and the kernel must be contiguous")
    if x.numel() == 0 or kernel.numel() == 0:
        raise ValueError(f"empty map {tuple(x.shape)} or kernel "
                         f"{tuple(kernel.shape)}")


def _forward(x: torch.Tensor, planes, kernel: torch.Tensor,
             d: int) -> torch.Tensor:
    """The kernel's launch (CUDA) or the twin (CPU)."""
    if x.device.type == "cpu":
        return dcn_ops.fused_reference(x, *planes, kernel, d)
    if x.device.type != "cuda":
        raise ValueError(f"no fused DCN kernel for device {x.device}")
    return _launch(x, *planes, kernel, d)


def _launch(x, a0, b0, fy, fx, wm, kernel, d):
    """Launch csrc/dcn_fused.cu on x's current stream (in bf16, after the
    weight re-layout kernel)."""
    planes = (a0, b0, fy, fx, wm)
    n, h, w, c = x.shape
    check_launch(x, planes, kernel)
    o = kernel.shape[2]
    out = torch.empty((n, h, w, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (x.data_ptr(), *(p.data_ptr() for p in planes))
        if x.dtype == torch.bfloat16:
            packed = pack_wgmma_kernel(kernel)
            err = _lib().dcn_fused_bf16_launch(
                *ptrs, packed.data_ptr(), out.data_ptr(), n, h, w, c, o,
                stream)
            why = "N*H*W >= 2^31"
        else:
            err = _lib().dcn_fused_f32_launch(
                *ptrs, kernel.data_ptr(), out.data_ptr(), n, h, w, c, o,
                stream)
            why = (f"C={c} is over the {_MAX_F32_CHANNELS} float32 channels "
                   f"that fit one block's shared memory, or N*H*W >= 2^31")
    if err != 0:
        raise RuntimeError(f"dcn_fused kernel launch failed: CUDA error {err} "
                           f"(1, invalid value, when {why})")
    dcn_fused_conv.launches += 1
    return out


dcn_fused_conv.launches = 0


def _meta(x, a0, b0, fy, fx, wm, kernel, d):
    n, h, w, _ = x.shape
    return x.new_empty((n, h, w, kernel.shape[2]))


LIB.define("dcn_fused_conv(Tensor x, Tensor a0, Tensor b0, Tensor fy, "
           "Tensor fx, Tensor wm, Tensor kernel, int d) -> Tensor")
LIB.impl("dcn_fused_conv", dcn_ops.fused_reference, "CPU")
LIB.impl("dcn_fused_conv", _launch, "CUDA")
LIB.impl("dcn_fused_conv", _meta, "Meta")
dcn_fused_conv_op = torch.ops.centernet_lightning.dcn_fused_conv
