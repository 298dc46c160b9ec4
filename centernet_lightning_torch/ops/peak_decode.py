"""Fused peak decode: the CUDA kernel, its plain twin, and the decode that
uses them (port of ops/pallas_decode.py).

`peak_class_scores_cuda` launches `csrc/peak_decode.cu` on a CUDA tensor
and runs `peak_class_scores_reference` on a CPU tensor; there is no other
fallback. While a program is traced (`torch.export`, cli/export.py) it goes
through the operator `torch.ops.centernet_lightning.peak_class_scores`
(`peak_class_scores_op`) instead, so the exported program keeps the kernel.
Both compute, for an NHWC heatmap, the 3x3 pseudo-NMS mask with
neutral edges (0 for probabilities, -1e30 for logits), then the per-pixel
class max and first-index argmax, in f32; a NaN in a class's window gives
that class the neutral, as in the JAX package. The kernel reads the head's
NHWC output as it lies (classes innermost), so no re-layout copy precedes
it. `launch_plan` cuts the map into the kernel's blocks (strips of columns,
bands of rows, a ring of staged rows, class chunks); the CPU tests hold it.
Top-k and the box gather stay plain PyTorch (`ops/decode.py`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import decode as decode_ops
from ._library import LIB, traced

__all__ = ["peak_class_scores_cuda", "peak_class_scores_op",
           "peak_class_scores_reference",
           "decode_detections_fused", "launch_plan", "plan_for", "PeakPlan",
           "kernel_info", "KERNEL_SOURCE", "REPLACES"]

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


SMEM_LIMIT = 232448       # H100: 227 KB of dynamic shared memory a block
MAX_THREADS = 256         # the kernel's __launch_bounds__
ITEMS = {1: 16, 4: 4, 8: 4}  # class vectors a lane holds, by vector width
ALIGN = 128               # ring buffers start on 128 bytes
SLACK = 32                # a span copied from and to 16-byte boundaries
BAND, STAGES, STRIP = 32, 4, 64   # rows a block walks, staged rows, columns


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class PeakPlan:
    """How csrc/peak_decode.cu cuts an (N, H, W, C) map. The fields are
    the kernel's `struct Plan`, in order.

    A block takes `strip` output columns of one image and `band` output
    rows, with `strip * lanes` threads: `lanes` threads a pixel, each
    holding `items` vectors of `vec` classes. `passes` class chunks of
    `chunk` classes each stream the band once; `stages` input rows of
    `stage_bytes` are staged at a time (a pixel's chunk at `pitch` bytes
    when passes > 1)."""
    vec: int
    lanes: int
    items: int
    chunk: int
    passes: int
    strip: int
    band: int
    stages: int
    pitch: int
    stage_bytes: int

    @property
    def threads(self) -> int:
        return self.strip * self.lanes

    @property
    def smem_bytes(self) -> int:
        return self.stages * self.stage_bytes + 2 * self.stages * 8 + ALIGN

    def blocks(self, n: int, h: int, w: int) -> int:
        return n * -(-w // self.strip) * -(-h // self.band)

    @functools.cached_property
    def ints(self):
        """The ten ints of the kernel's `struct Plan`."""
        return (ctypes.c_int * 10)(*dataclasses.astuple(self))


@functools.lru_cache(maxsize=None)
def launch_plan(h: int, w: int, c: int, elt: int, aligned: bool) -> PeakPlan:
    """The kernel's blocks for a map of H x W pixels of C classes of `elt`
    bytes; `aligned`: the map's pointer is 16-byte aligned. The strip of
    STRIP columns narrows for narrow maps and for wide pixels."""
    vec = 16 // elt if aligned and (c * elt) % 16 == 0 else 1
    most = ITEMS[vec]
    nv = c // vec
    if nv <= 32 * most:       # one pass: the fewest idle slots, then lanes
        lanes = min((1, 2, 4, 8, 16, 32),
                    key=lambda l: (-(-nv // l) > most, l * -(-nv // l), l))
        items, chunk = -(-nv // lanes), c
    else:                     # class chunks of 32 lanes x `most` vectors
        lanes, items, chunk = 32, most, 32 * most * vec
    passes = -(-c // chunk)
    pitch = 0 if passes == 1 else _round_up(chunk * elt + SLACK, 16)
    # a warp holds whole pixels; a strip need not pass the map's width
    strip = max(32 // lanes, min(STRIP, MAX_THREADS // lanes,
                                 1 << max(w - 1, 0).bit_length()))

    def stage_bytes(s):     # one span of s + 2 pixels, or s + 2 pitches
        row = (s + 2) * c * elt + SLACK if passes == 1 else (s + 2) * pitch
        return _round_up(row, ALIGN)

    while True:
        plan = PeakPlan(vec, lanes, items, chunk, passes, strip, BAND, STAGES,
                        pitch, stage_bytes(strip))
        if plan.smem_bytes <= SMEM_LIMIT:
            return plan
        if strip == 32 // lanes:
            raise ValueError(f"no peak plan fits C = {c} in shared memory")
        strip //= 2


@functools.cache
def _lib():
    from ._build import load

    lib = load("peak_decode")
    lib.peak_class_scores_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    lib.peak_class_scores_launch.restype = ctypes.c_int
    lib.peak_class_scores_info.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.peak_class_scores_info.restype = ctypes.c_int
    return lib


def kernel_info(plan: PeakPlan, bf16: bool) -> dict:
    """The build of the kernel `plan` launches: registers, spilled bytes and
    static shared bytes a thread or block, and the plan's own sizes."""
    out = (ctypes.c_int * 4)()
    err = _lib().peak_class_scores_info(int(bf16), plan.ints, out)
    if err != 0:
        raise RuntimeError(f"peak_class_scores_info failed: CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1],
            "static_shared_bytes": out[2], "max_threads": out[3],
            "dynamic_shared_bytes": plan.smem_bytes, "threads": plan.threads,
            "strip": plan.strip, "band": plan.band, "stages": plan.stages,
            "lanes": plan.lanes, "items": plan.items, "vec": plan.vec,
            "passes": plan.passes}


def plan_for(heatmap: torch.Tensor) -> PeakPlan:
    """`launch_plan` for an (N, H, W, C) map as it lies in memory."""
    _, h, w, c = heatmap.shape
    return launch_plan(h, w, c, heatmap.element_size(),
                       heatmap.data_ptr() % 16 == 0)


def peak_class_scores_cuda(heatmap: torch.Tensor, from_logits: bool = False):
    """Fused 3x3 pseudo-NMS + class max/argmax.

    heatmap: (N, H, W, C) contiguous, float32 or bfloat16. On a CUDA
    tensor this launches the kernel (counted in
    `peak_class_scores_cuda.launches`) or raises; on a CPU tensor it returns
    `peak_class_scores_reference`. A traced tensor (a fake or functional
    tensor of `torch.export`, or under `torch.compile`) goes through the
    operator `centernet_lightning::peak_class_scores`, which dispatches to
    the same two. Returns (scores f32, labels int32), each (N, H*W).
    """
    if heatmap.dim() != 4:
        raise ValueError(f"heatmap must be (N, H, W, C), got {tuple(heatmap.shape)}")
    if heatmap.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"heatmap must be float32 or bfloat16, got {heatmap.dtype}")
    if heatmap.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no peak kernel for device {heatmap.device}")
    if traced(heatmap):
        # the operator, on the map detached (the kernel has no backward)
        return peak_class_scores_op(heatmap.detach(), from_logits)
    if heatmap.device.type == "cpu":
        return peak_class_scores_reference(heatmap, from_logits=from_logits)
    return _peak_launch(heatmap, from_logits)


# The peak stage as an operator that `torch.export` keeps in a graph
# (ops/_library.py).
LIB.define("peak_class_scores(Tensor heatmap, bool from_logits) -> (Tensor, Tensor)")


def _peak_meta(heatmap, from_logits):
    n, h, w, _ = heatmap.shape
    return (heatmap.new_empty((n, h * w), dtype=torch.float32),
            heatmap.new_empty((n, h * w), dtype=torch.int32))


def _peak_launch(heatmap, from_logits):
    """Launch csrc/peak_decode.cu on `heatmap`'s current stream."""
    if not heatmap.is_contiguous():
        raise ValueError("heatmap must be contiguous NHWC")
    n, h, w, c = heatmap.shape
    if n * h * w == 0 or c == 0:
        raise ValueError(f"empty heatmap {tuple(heatmap.shape)}")
    if n * h * w >= 2 ** 31:
        raise ValueError(f"heatmap {tuple(heatmap.shape)}: the kernel indexes "
                         f"pixels with 32-bit ints")
    plan = plan_for(heatmap)
    scores = torch.empty((n, h * w), dtype=torch.float32, device=heatmap.device)
    labels = torch.empty((n, h * w), dtype=torch.int32, device=heatmap.device)
    with torch.cuda.device(heatmap.device):
        stream = torch.cuda.current_stream(heatmap.device).cuda_stream
        err = _lib().peak_class_scores_launch(
            heatmap.data_ptr(), scores.data_ptr(), labels.data_ptr(),
            n, h, w, c, int(heatmap.dtype == torch.bfloat16),
            _neutral(from_logits), plan.ints, stream)
    if err != 0:
        raise RuntimeError(f"peak_class_scores kernel launch failed: CUDA error {err}")
    peak_class_scores_cuda.launches += 1
    return scores, labels


peak_class_scores_cuda.launches = 0
LIB.impl("peak_class_scores", peak_class_scores_reference, "CPU")
LIB.impl("peak_class_scores", _peak_launch, "CUDA")
LIB.impl("peak_class_scores", _peak_meta, "Meta")
peak_class_scores_op = torch.ops.centernet_lightning.peak_class_scores


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

    The heatmap may be the model's own bf16 output (an fp16 one is widened
    to f32 for the kernel); scores, boxes and embeddings come back f32. Windows other than 3x3 take the plain path.
    """
    if nms_kernel != 3:
        return decode_ops.decode_detections(
            heatmap, box_offsets, reid=reid, num_detections=num_detections,
            nms_kernel=nms_kernel, normalize_boxes=normalize_boxes,
            box_log=box_log, box_multiplier=box_multiplier, stride=stride,
            from_logits=from_logits)
    if heatmap.dtype not in (torch.float32, torch.bfloat16):
        # the kernel reads f32 and bf16; other maps (fp16 serving) are
        # widened to f32 first, as the JAX package's Pallas wrapper does
        heatmap = heatmap.float()
    scores, labels = peak_class_scores_cuda(heatmap.contiguous(),
                                            from_logits=from_logits)
    topk_scores, indices, topk_labels = decode_ops._topk(
        scores, labels, num_detections, from_logits)
    return decode_ops.assemble_detections(
        topk_scores, indices, topk_labels, box_offsets, reid=reid,
        normalize_boxes=normalize_boxes, box_log=box_log,
        box_multiplier=box_multiplier, stride=stride)
