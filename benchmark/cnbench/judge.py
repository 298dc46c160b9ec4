"""The comparisons with the reference that decide `correct`.

Detections (serving), for every image checked, against the reference's
float32 maps of the same image:
  score_gap  each served detection is matched to the pixel whose reference
             score of the served class and reference box lie nearest to it
             (|score| + |box|_inf / image side); the largest |served score
             - reference score| there;
  box_gap    the largest |served box - reference box|_inf at that pixel,
             over (the reference box's longer side + one stride);
  rank_gap   the largest gap between the k-th best served score and the
             k-th best peak score of the reference (the top-k lists,
             sorted), which a missing or extra detection opens;
  *_q90      the same gaps' 90th percentile over all detections checked;
  off_peak_share  the share of served detections whose matched pixel's
             reference score of the served class lies more than NEAR_TIE
             below the largest in its 3x3 window: detections off the
             reference's peaks by more than a near-tie. A decode that
             selects other pixels than the peaks (no suppression, a top-k
             over the wrong map) reads it high; the score and box gaps
             alone cannot see that, since every pixel has its own score
             and box.
Training, against the reference's float32 steps from the same weights on
the same batches:
  loss_gap   the largest |loss - reference loss| / reference loss of the
             first steps;
  grad_gap   over the tensors, the largest | |g| - |g_ref| | of the first
             gradient as the optimizer got it, over the larger of |g_ref|
             and the median tensor's |g_ref|;
  delta_gap  the same of the parameters' change over the first steps, over
             the tensors whose reference gradient is at least 1e-3 of the
             median tensor's (the others move by rounding alone);
  stats_gap  the same of the BatchNorm running statistics' change;
  *_median   the median tensor's gap, where the worst tensor's reads the
             rounding of a few tensors (PERF.md, section 2).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

MOVED = 1e-3
# how far below its 3x3 window's largest score a detection may lie and count
# as a near-tie that bfloat16 rounding turned: half again the 90th
# percentile of bfloat16's score gaps (0.013-0.021 over 96 seeds)
NEAR_TIE = 0.032


def detection_gaps(served: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   side: torch.Tensor, stride: torch.Tensor) -> Dict[str, float]:
    """served: boxes (M, K, 4), labels (M, K), scores (M, K); ref: the
    reference decode's dense maps (reference/decode.py:dense) of the same
    M images, boxes in the served units; side, stride (M,) in those units.
    Each gap's largest value over all detections, its 90th percentile
    (`_q90`), and the share of detections off the peaks."""
    detail = {"score": [], "box": [], "rank": []}
    deficit = []
    for i in range(served["scores"].shape[0]):
        s = served["scores"][i].float()
        b = served["boxes"][i].float()
        lab = served["labels"][i].long()
        rs = ref["scores"][i].index_select(1, lab)                   # (HW, K)
        rb = ref["boxes"][i]                                         # (HW, 4)
        dist = (rb[:, None, :] - b[None]).abs().amax(-1)             # (HW, K)
        cost = (rs - s[None]).abs() + dist / side[i]
        p = cost.argmin(0)
        k = torch.arange(s.shape[0], device=s.device)
        rbp = rb[p]
        longer = torch.maximum(rbp[:, 2] - rbp[:, 0], rbp[:, 3] - rbp[:, 1])
        detail["score"].append((rs[p, k] - s).abs())
        detail["box"].append(dist[p, k] / (longer + stride[i]))
        deficit.append(ref["window_max"][i][p, lab] - rs[p, k])
        top = ref["top_scores"][i]
        mine = torch.sort(s, descending=True).values[:top.shape[0]]
        detail["rank"].append((mine - top[:mine.shape[0]]).abs())
    gaps = {k: torch.cat(v) for k, v in detail.items()}
    out = {f"{k}_gap": float(v.max()) for k, v in gaps.items()}
    out.update({f"{k}_gap_q90": float(torch.quantile(v, 0.9)) for k, v in gaps.items()})
    out["off_peak_share"] = float((torch.cat(deficit) > NEAR_TIE).float().mean())
    return out


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    keys = list(keys)
    if not keys:
        return {}
    med = sorted(ref[k] for k in keys)[len(keys) // 2]
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def worst(prog: Dict, ref: Dict, top: int = 4) -> Dict[str, list]:
    """The tensors behind each training number: [name, gap, program norm,
    reference norm], largest gap first."""
    g = ref["grad_norms"]
    med = sorted(g.values())[len(g) // 2]
    moved = [k for k in g if g[k] >= MOVED * med]
    out = {}
    for label, key, keys in (("grad", "grad_norms", g), ("delta", "delta_norms", moved),
                             ("stats", "stat_norms", ref["stat_norms"])):
        gaps = _gaps(prog[key], ref[key], keys)
        out[label] = [[k, gaps[k], prog[key][k], ref[key][k]]
                      for k in sorted(gaps, key=gaps.get, reverse=True)[:top]]
    out["median_grad"] = med
    return out


def training_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog / ref: {losses, grad_norms, delta_norms, stat_norms}."""
    losses = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    med = sorted(g.values())[len(g) // 2]
    moved = [k for k in g if g[k] >= MOVED * med]
    out = {"loss_gap": losses}
    for label, key, keys in (("grad_gap", "grad_norms", g), ("delta_gap", "delta_norms", moved),
                             ("stats_gap", "stat_norms", ref["stat_norms"])):
        gaps = sorted(_gaps(prog[key], ref[key], keys).values())
        out[label] = gaps[-1] if gaps else 0.0
        out[label + "_median"] = gaps[len(gaps) // 2] if gaps else 0.0
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every number finite and at or under its limit;
    checks maps each to {value, limit}."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
    return ok, checks
