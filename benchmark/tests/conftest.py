"""The benchmark's own tests (python -m pytest benchmark/tests). Tests
marked `card` need a CUDA device; they decide inside the test whether to
skip."""
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def tiny_cell():
    """A workload's cell at a size the CPU can run: 64 x 64 images, two to
    a batch, short pools, the workload's own configuration (narrower
    heads), traffic kind and limits."""
    import torch

    from cnbench import manifest
    from cnbench.common import Cell

    def make(workload, seed=7, seconds=0.5, dtype=None, **traffic):
        bench = manifest.manifest()
        wl = manifest.workload(workload, bench)
        cfg = dict(manifest.config(wl["config"]), image_size=[64, 64])
        if dtype:
            cfg["compute_dtype"] = dtype
        t = dict(manifest.traffic(wl["traffic"]), batch=2)
        if t["kind"] == "offline":
            t.update(distinct_batches=2, calibration_images=2, check_batches=2,
                     reference_block=2)
        elif t["kind"] == "train":
            t.update(pool=4, max_boxes=8)
        t.update(traffic)
        return Cell(name=workload, config=cfg, traffic=t, limits=manifest.limits(workload),
                    seed=seed, seconds=seconds, trace=False, device=torch.device("cpu"),
                    started=time.perf_counter())
    return make
