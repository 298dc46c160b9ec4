"""Fused peak decode: the CUDA kernel, its plain twin, and the decode that
uses them (port of ops/pallas_decode.py).

`peak_class_scores_cuda` launches `csrc/peak_decode.cu` on a CUDA tensor
and runs `peak_class_scores_reference` on a CPU tensor; there is no other
fallback. Both compute, for an NHWC heatmap, the 3x3 pseudo-NMS mask with
neutral edges (0 for probabilities, -1e30 for logits), then the per-pixel
class max and first-index argmax, in f32. The kernel reads the head's
NHWC output as it lies (classes innermost), so no re-layout copy precedes
it. Top-k and the box gather stay plain PyTorch (`ops/decode.py`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import decode as decode_ops

__all__ = ["peak_class_scores_cuda", "peak_class_scores_reference",
           "decode_detections_fused", "KERNEL_SOURCE", "REPLACES"]

KERNEL_SOURCE = "centernet_lightning_torch/csrc/peak_decode.cu"
REPLACES = "centernet_lightning_tpu/ops/pallas_decode.py:138"

_NEG_BIG = -1e30


def _neutral(from_logits: bool) -> float:
    return _NEG_BIG if from_logits else 0.0


def peak_class_scores_reference(heatmap: torch.Tensor,
                                from_logits: bool = False):
    """Plain PyTorch twin of the kernel. heatmap (N, H, W, C) f32 or bf16 ->
    (scores f32, labels int32), each (N, H*W)."""
    n, h, w, c = heatmap.shape
    neutral = _neutral(from_logits)
    x = heatmap.float().permute(0, 3, 1, 2)                 # (N, C, H, W)
    window = F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=neutral), 3, stride=1)
    masked = torch.where(window == x, x, x.new_tensor(neutral))
    scores = masked.amax(dim=1)                             # (N, H, W)
    cls = torch.arange(c, device=x.device, dtype=torch.int32).view(1, c, 1, 1)
    hit = masked == scores[:, None]
    labels = torch.where(hit, cls, torch.full_like(cls, c)).amin(dim=1)
    return scores.reshape(n, h * w), labels.reshape(n, h * w)


@functools.cache
def _launch_fn():
    from ._build import load

    fn = load("peak_decode").peak_class_scores_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def peak_class_scores_cuda(heatmap: torch.Tensor, from_logits: bool = False):
    """Fused 3x3 pseudo-NMS + class max/argmax.

    heatmap: (N, H, W, C) contiguous, float32 or bfloat16. On a CUDA tensor
    this launches the kernel (counted in `peak_class_scores_cuda.launches`)
    or raises; on a CPU tensor it returns `peak_class_scores_reference`.
    Returns (scores f32, labels int32), each (N, H*W).
    """
    if heatmap.dim() != 4:
        raise ValueError(f"heatmap must be (N, H, W, C), got {tuple(heatmap.shape)}")
    if heatmap.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"heatmap must be float32 or bfloat16, got {heatmap.dtype}")
    if heatmap.device.type == "cpu":
        return peak_class_scores_reference(heatmap, from_logits=from_logits)
    if heatmap.device.type != "cuda":
        raise ValueError(f"no peak kernel for device {heatmap.device}")
    if not heatmap.is_contiguous():
        raise ValueError("heatmap must be contiguous NHWC")
    n, h, w, c = heatmap.shape
    if n * h * w == 0 or c == 0:
        raise ValueError(f"empty heatmap {tuple(heatmap.shape)}")
    if n * h * w >= 2 ** 31:
        raise ValueError(f"heatmap {tuple(heatmap.shape)}: the kernel indexes "
                         f"pixels with 32-bit ints")
    scores = torch.empty((n, h * w), dtype=torch.float32, device=heatmap.device)
    labels = torch.empty((n, h * w), dtype=torch.int32, device=heatmap.device)
    with torch.cuda.device(heatmap.device):
        stream = torch.cuda.current_stream(heatmap.device).cuda_stream
        err = _launch_fn()(
            heatmap.data_ptr(), scores.data_ptr(), labels.data_ptr(),
            n, h, w, c, int(heatmap.dtype == torch.bfloat16),
            _neutral(from_logits), stream)
    if err != 0:
        raise RuntimeError(f"peak_class_scores kernel launch failed: CUDA error {err}")
    peak_class_scores_cuda.launches += 1
    return scores, labels


peak_class_scores_cuda.launches = 0


def decode_detections_fused(
    heatmap: torch.Tensor,
    box_offsets: torch.Tensor,
    reid: Optional[torch.Tensor] = None,
    num_detections: int = 100,
    nms_kernel: int = 3,
    normalize_boxes: bool = False,
    box_log: bool = False,
    box_multiplier: float = 1.0,
    stride: int = 4,
    from_logits: bool = False,
) -> Dict[str, torch.Tensor]:
    """ops.decode.decode_detections with stages 1-2 in the fused kernel.

    The heatmap may be the model's own bf16 output; scores, boxes and
    embeddings come back f32. Windows other than 3x3 take the plain path.
    """
    if nms_kernel != 3:
        return decode_ops.decode_detections(
            heatmap, box_offsets, reid=reid, num_detections=num_detections,
            nms_kernel=nms_kernel, normalize_boxes=normalize_boxes,
            box_log=box_log, box_multiplier=box_multiplier, stride=stride,
            from_logits=from_logits)
    scores, labels = peak_class_scores_cuda(heatmap.contiguous(),
                                            from_logits=from_logits)
    topk_scores, indices, topk_labels = decode_ops._topk(
        scores, labels, num_detections, from_logits)
    return decode_ops.assemble_detections(
        topk_scores, indices, topk_labels, box_offsets, reid=reid,
        normalize_boxes=normalize_boxes, box_log=box_log,
        box_multiplier=box_multiplier, stride=stride)
