"""The program's own spans (centernet_lightning_torch/utils/spans.py) in
the records of a traced slice (cnbench/trace.py), and the per-layer
arithmetic over them. Each reader returns None where the slice recorded
no span of the names it asks for (a program without spans); shares are in
percent.

A span is an op of the profiler's, so `reduce` files it among `host_ops`
under its name, on the trace's one time line, and puts no copy of it
among the device's events. (The profiler maps the kernels' device times
onto that line; on an H100 they drifted from their launches by up to
2.4 ms within a 0.9 s slice, so an interval of a span meets the device's
busy time with that much slack.) A kernel's launch is the CUDA API call that
launched it (`LAUNCH_CALLS`), also among `host_ops`. The records
keep no thread and no correlation id, so a launch counts to a span when it
starts inside the span's interval, whichever thread made it; that holds
for the spans read here: while the optimizer runs no other thread
launches, and while autograd's worker runs a backward (`dcn.recompute`)
the main thread waits for it. Kernels pair with their launches in order,
counted from the end of the slice: the cells run one stream, whose
kernels start in the order they were launched, and a slice ends in a
synchronize, so its last launches all have their kernels; the profiler
can miss the kernels of its first launches (on an H100 with torch 2.11,
the first launch of the flagship's training slice, whose kernel is not
in the trace).
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import merge

# names of the CUDA API calls that launch one kernel each
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")


def intervals(rec: Dict, names: Sequence[str]) -> List[Tuple[float, float]]:
    """The union of the spans of these names, as merged intervals."""
    return merge([(s, e) for n, s, e in rec.get("host_ops", []) if n in names])


def launches(rec: Dict) -> List[float]:
    """Start times of the slice's kernel launches, in order."""
    return sorted(s for n, s, _ in rec.get("host_ops", []) if n.startswith(LAUNCH_CALLS))


def inside(t: float, spans: List[Tuple[float, float]]) -> bool:
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two lists of merged intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_idle_share(rec: Dict, names: Sequence[str]) -> Optional[float]:
    """Time inside these spans in which the device ran nothing, over the
    traced slice."""
    spans = intervals(rec, names)
    if not spans or not rec.get("window_s"):
        return None
    length = sum(e - s for s, e in spans)
    return 100.0 * (length - overlap(spans, rec.get("busy_spans", []))) / rec["window_s"]


def span_kernels_per_step(rec: Dict, names: Sequence[str]) -> Optional[float]:
    """Kernels launched inside these spans, a step of the slice."""
    spans = intervals(rec, names)
    if not spans or not rec.get("steps"):
        return None
    return sum(inside(t, spans) for t in launches(rec)) / rec["steps"]


def span_kernel_share(rec: Dict, names: Sequence[str]) -> Optional[float]:
    """Device time of the kernels launched inside these spans, over all
    kernel time. None where the slice has fewer launches than kernels."""
    spans = intervals(rec, names)
    kernels = sorted(rec.get("kernels", []), key=lambda k: k[1])
    starts = launches(rec)
    total = sum(d for _, _, d in kernels)
    if not spans or not total or len(starts) < len(kernels):
        return None
    part = sum(k[2] for k, t in zip(reversed(kernels), reversed(starts)) if inside(t, spans))
    return 100.0 * part / total
