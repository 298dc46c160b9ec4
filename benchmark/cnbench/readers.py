"""The arithmetic of the per-layer metrics, over the records of a traced
slice (cnbench/trace.py). Each returns None where it finds nothing to
read; shares are in percent."""
from __future__ import annotations

import statistics
from typing import Dict, Optional

from roofline import kernels as bounds
from roofline import peaks

# BatchNorm and activation kernels (forward and backward) by name
NORM_ACT = ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "mish", "relu",
            "threshold", "silu", "sigmoid", "hardswish", "softplus", "tanh")


def idle_share(rec: Dict) -> Optional[float]:
    if not rec.get("window_s") or not rec.get("kernels"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def mfu(rec: Dict, passes: int) -> Optional[float]:
    """Model FLOPs of the slice's images (`passes` forwards an image: 1
    serving, 3 training) over the slice, against the bf16 peak."""
    if not rec.get("window_s") or not rec.get("images") or not rec.get("flops_per_image"):
        return None
    return 100.0 * passes * rec["flops_per_image"] * rec["images"] / rec["window_s"] \
        / peaks.BF16_FLOPS


def kernel_share(rec: Dict, patterns) -> Optional[float]:
    total = sum(d for _, _, d in rec.get("kernels", []))
    if not total:
        return None
    part = sum(d for n, _, d in rec["kernels"] if any(p in n.lower() for p in patterns))
    return 100.0 * part / total


def kernels_per_step(rec: Dict) -> Optional[float]:
    if not rec.get("kernels") or not rec.get("steps"):
        return None
    return len(rec["kernels"]) / rec["steps"]


def roofline(rec: Dict, kernel: str, bound_s) -> Optional[float]:
    """Sum of the launches' least times over their measured times."""
    durations = [d for n, _, d in rec.get("kernels", []) if kernel in n]
    if not durations or bound_s is None:
        return None
    return 100.0 * bound_s(len(durations)) / sum(durations)


def peak_bound(rec: Dict):
    """Least time of n peak-kernel launches, from the heatmaps the head
    made in the slice ((N, C, H, W), bytes an element)."""
    maps = rec.get("heatmaps")
    if not maps:
        return None
    each = statistics.fmean(bounds.peak_decode_s(s[0], s[2], s[3], s[1], elt)
                            for s, elt in maps)
    return lambda n: n * each


def dcn_sample_bound(rec: Dict):
    """Least time of the sampling launches, from the DCN blocks' inputs in
    the slice ((N, C, H, W), dtype); one launch a block forward."""
    inputs = rec.get("dcn_inputs")
    if not inputs:
        return None
    each = [bounds.dcn_sample_s(s[0], s[2], s[3], s[1], 2 if "bfloat16" in str(dt)
                                or "float16" in str(dt) else 4) for s, dt in inputs]
    mean = statistics.fmean(each)
    return lambda n: n * mean


def share(part: Optional[float], whole: Optional[float]) -> Optional[float]:
    if not part or not whole:
        return None
    return 100.0 * part / whole
