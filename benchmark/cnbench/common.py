"""What every kind of window shares: the clock, the program's model built
from a configuration, device facts."""
from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch


@dataclass
class Cell:
    """One run of one workload: what BENCHMARK.json and the files it names
    say, and the command's arguments."""
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float                      # perf_counter at process start
    window_start: Optional[float] = None
    # benchmark/control.py and the tests only: a function (predictor,
    # calibration images) -> predictor put in the program's predictor's place
    predictor_hook: Optional[Any] = None
    log: Dict[str, Any] = field(default_factory=dict)

    @property
    def model_cfg(self) -> Dict[str, Any]:
        return self.config

    @property
    def image_size(self):
        return tuple(self.config["image_size"])

    def begin_window(self) -> float:
        sync(self.device)
        self.window_start = time.perf_counter()
        return self.window_start

    @property
    def setup_s(self) -> float:
        return self.window_start - self.started


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_task(model_cfg: Dict[str, Any], device):
    """The program's CenterNet task, its model's tensors allocated on
    `device` and not yet filled (weights.load_into fills them)."""
    from centernet_lightning_torch.models.centernet import CenterNet

    fields = CenterNet.__dataclass_fields__
    with torch.device("meta"):
        task = CenterNet(**{k: v for k, v in model_cfg.items() if k in fields})
    task.model.to_empty(device=device)
    return task


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def device_info(device, peak: int) -> Dict[str, Any]:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def gc_clock():
    """Start timing the interpreter's garbage collections; the returned
    function stops and gives the seconds they took."""
    import gc

    total = [0.0]
    clock = {}

    def on_gc(phase, info):
        if phase == "start":
            clock["t"] = time.perf_counter()
        elif "t" in clock:
            total[0] += time.perf_counter() - clock.pop("t")

    gc.callbacks.append(on_gc)

    def stop() -> float:
        gc.callbacks.remove(on_gc)
        return total[0]
    return stop


def host_clock():
    """Start reading what the host gave this process; the returned function
    stops and gives, over the span, the wall seconds, the main thread's and
    the process's CPU seconds and the involuntary context switches."""
    import resource

    t0, th0, pr0 = time.perf_counter(), time.thread_time(), time.process_time()
    sw0 = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw

    def stop() -> Dict[str, float]:
        return {"wall_s": time.perf_counter() - t0,
                "main_thread_cpu_s": time.thread_time() - th0,
                "process_cpu_s": time.process_time() - pr0,
                "involuntary_switches":
                    resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw - sw0}
    return stop
