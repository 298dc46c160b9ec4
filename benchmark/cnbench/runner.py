"""One run of one cell: the kind's window, the verdict, the metrics, the
result line."""
from __future__ import annotations

import importlib
import math
from typing import Dict, Tuple

from . import judge, manifest, trace
from .common import Cell, device_info


def run(cell: Cell, bench: Dict) -> Tuple[Dict, Dict]:
    kind = importlib.import_module(f"cnbench.kinds.{cell.traffic['kind']}")
    out = kind.run(cell)
    correct, checks = judge.verdict(out["numbers"], cell.limits)
    device = device_info(cell.device, out["memory_peak"])
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if cell.trace:
        rec = dict(out["records"])
        rec.update(records_of(cell))
        for m in manifest.metrics_for(cell.name, "per_layer", bench):
            value = manifest.metric_reader(m["name"])(rec)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        device["busy_s"] = rec.get("busy_s", 0.0)
        device["window_s"] = rec.get("window_s", 0.0)
        if rec.get("kernels"):
            result["breakdown"] = trace.breakdown(rec)
    else:
        values = dict(out["e2e"], setup_s=cell.setup_s)
        for m in manifest.metrics_for(cell.name, "end_to_end", bench):
            # a metric split by cell (train_images_per_s.r18dcn) reads its
            # quantity, the part of the name before the first dot
            value = values.get(m["name"], values.get(m["name"].split(".")[0]))
            metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    result["info"] = out["info"]
    result["checks"] = checks
    return result, checks


def records_of(cell: Cell) -> Dict:
    """What the readers need besides the trace: the model's FLOPs an image
    (counted on the reference) and the cell's batch."""
    from roofline.flops import forward_flops_per_image

    return {"flops_per_image": forward_flops_per_image(cell.model_cfg, cell.image_size),
            "batch": cell.traffic.get("batch")}
