"""Checkpoints in the port's own format (port of train/checkpoint.py).

`ckpt_dir/step_N/state.pt` holds a `torch.save` of the state tree (the
model's state dict, the optimizer state, the step, epoch and best metric,
and the EMA weights when kept) and `ckpt_dir/hparams.json` the task's
hyper-parameters, so a run resumes, or a predictor is rebuilt, from the
directory alone. A save writes `step_N.tmp` and renames it, so an
interrupted save never leaves a `step_N` to resume from. Files load with
`weights_only=True`: tensors, numbers, strings and containers only.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "restore_partial"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_STATE_FILE = "state.pt"


def _steps(ckpt_dir: str):
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := _STEP_RE.match(d)))


def save_checkpoint(ckpt_dir: str, state_tree: Dict[str, Any],
                    hparams: Optional[Dict[str, Any]] = None,
                    step: Optional[int] = None, keep_last: int = 3) -> str:
    """Write `state_tree` to ckpt_dir/step_N (N = `step`, else the tree's
    "step"), `hparams` beside it, and keep the newest `keep_last` steps."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    step = int(step if step is not None else state_tree.get("step", 0))
    path = os.path.join(ckpt_dir, f"step_{step}")
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state_tree, os.path.join(tmp, _STATE_FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    if hparams is not None:
        with open(os.path.join(ckpt_dir, "hparams.json"), "w") as f:
            json.dump(hparams, f, indent=2, default=str)
    for s in _steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, f"step_{steps[-1]}") if steps else None


def load_checkpoint(path: str, map_location="cpu"
                    ) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """(state_tree, hparams or None) from a step directory, or from a run
    directory (its newest step)."""
    path = os.path.abspath(path)
    if _STEP_RE.match(os.path.basename(path)):
        run_dir = os.path.dirname(path)
    else:
        run_dir = path
        path = latest_checkpoint(path)
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {run_dir}")
    state = torch.load(os.path.join(path, _STATE_FILE),
                       map_location=map_location, weights_only=True)
    hparams = None
    hp_path = os.path.join(run_dir, "hparams.json")
    if os.path.exists(hp_path):
        with open(hp_path) as f:
            hparams = json.load(f)
    return state, hparams


def restore_partial(path: str, model_state: Dict[str, torch.Tensor],
                    verbose: bool = True) -> Dict[str, torch.Tensor]:
    """Fine-tuning restore: `model_state` with every tensor that the
    checkpoint holds under the same name and shape replaced by the
    checkpoint's (the rest, e.g. a head over other classes, stays fresh)."""
    state, _ = load_checkpoint(path)
    source = state["model"]
    out, loaded, skipped = dict(model_state), [], []
    for key, value in model_state.items():
        src = source.get(key)
        if src is not None and tuple(src.shape) == tuple(value.shape):
            out[key] = src
            loaded.append(key)
        else:
            skipped.append(key if src is None else
                           f"{key} (shape {tuple(src.shape)} vs {tuple(value.shape)})")
    if verbose:
        print(f"finetune restore from {path}: {len(loaded)} tensors loaded, "
              f"{len(skipped)} kept fresh")
        for s in skipped[:20]:
            print(f"  skipped {s}")
    return out
