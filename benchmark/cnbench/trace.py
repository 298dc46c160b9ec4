"""The traced slice of a window: torch.profiler over a few steps, reduced
to plain records that the per-layer metric readers read.

Records (a dict):
  window_s, busy_s    the slice's length (first to last profiler event)
                      and the union of the device's activity in it;
  kernels             [(name, start_s, dur_s)] of device kernels (memory
                      copies and sets are in busy_s, not here);
  host_ops            [(name, start_s, end_s)] of the host's top-level ops;
  steps, images       steps (batches) and images the slice ran;
  anything the window adds (counters, hook timings, latencies).
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

import torch


def _device_of(event) -> str:
    return str(event.device_type()).split(".")[-1].upper()


def reduce(prof) -> Dict:
    """Records from a stopped torch.profiler.profile."""
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    for e in events:
        start = e.start_ns() * 1e-9
        dur = e.duration_ns() * 1e-9
        if _device_of(e) == "CUDA":
            device.append((e.name(), start, dur))
        else:
            host.append((e.name(), start, start + dur))
    if not device:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": [], "host_ops": []}
    t0 = min([s for _, s, _ in device] + [s for _, s, _ in host])
    t1 = max([s + d for _, s, d in device] + [e for _, _, e in host])
    spans = sorted((s - t0, s - t0 + d) for _, s, d in device)
    kernels = [(n, s - t0, d) for n, s, d in device
               if not n.startswith(("Memcpy", "Memset"))]
    return {"window_s": t1 - t0, "busy_s": union_length(spans),
            "kernels": kernels, "busy_spans": merge(spans),
            "host_ops": [(n, s - t0, e - t0) for n, s, e in host]}


def merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def union_length(spans) -> float:
    return sum(e - s for s, e in merge(spans))


def breakdown(rec: Dict, top: int = 10) -> Dict:
    """The device ops that took most time, and the idle gaps summed by the
    innermost host op running at each gap's middle."""
    by_name = collections.Counter()
    for name, _, dur in rec["kernels"]:
        by_name[name] += dur
    busy = rec.get("busy_spans", [])
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    if busy:
        gaps = [(0.0, busy[0][0])] + gaps + [(busy[-1][1], rec["window_s"])]
    ops = sorted(rec.get("host_ops", []), key=lambda o: o[1])
    starts = [o[1] for o in ops]
    by_host = collections.Counter()
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:500]:
        if e <= s:
            continue
        mid = (s + e) / 2
        name = "no host op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if ops[j][2] >= mid:          # the latest-starting op covering it
                name = ops[j][0]
                break
        by_host[name] += e - s
    return {"device_ops": [[n[:120], v] for n, v in by_name.most_common(top)],
            "idle_gaps": [[n[:120], v] for n, v in by_host.most_common(top)]}


class RegionTimer:
    """CUDA events at the edges of each forward and backward of the given
    modules (forward pre/post hooks, full backward pre/post hooks), and
    the input shape and dtype of each forward: `seconds()` is the device
    time inside them. Armed only while `active`."""

    def __init__(self, modules):
        self.active = False
        self.pairs: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []
        self.shapes: List[Tuple[tuple, torch.dtype]] = []
        self._open: Dict[Tuple[int, str], torch.cuda.Event] = {}
        self._handles = []
        for m in modules:
            self._handles += [
                m.register_forward_pre_hook(self._pre("f")),
                m.register_forward_hook(self._post("f")),
                m.register_full_backward_pre_hook(self._pre("b")),
                m.register_full_backward_hook(self._post("b"))]

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _pre(self, phase):
        def hook(module, args):
            if self.active:
                if phase == "f":
                    x = args[0]
                    self.shapes.append((tuple(x.shape), x.dtype))
                self._open[(id(module), phase)] = self._event()
        return hook

    def _post(self, phase):
        def hook(module, *args):
            start = self._open.pop((id(module), phase), None)
            if self.active and start is not None:
                self.pairs.append((start, self._event()))
        return hook

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) / 1e3

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
