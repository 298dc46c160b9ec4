"""DCN offset-magnitude audit for the bounded engines (port of
utils/dcn_audit.py).

The exact engine (`conv_type: dcn`) samples with unbounded offsets, as
torchvision DeformConv2d does; the bounded engines (`dcn_fast[_dK]`,
`dcn_fused_dK`) clamp offsets to [-D, D]. A checkpoint whose learned
offsets exceed D would lose accuracy on a bounded engine, so this audit
records the offset convolutions' outputs on calibration images (forward
hooks) and reports the smallest D that serves the checkpoint exactly.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["audit_dcn_offsets", "dcn_engine_displacement",
           "format_dcn_audit", "model_uses_dcn"]

# conv_type name -> offset clamp (None = unbounded exact engine); mirrors
# models/layers.py CONV_BLOCKS
_ENGINE_D = {
    "dcn": None, "deformable": None,
    "dcn_fast": 2, "dcn_fast_d1": 1, "dcn_fast_d2": 2,
    "dcn_fast_d3": 3, "dcn_fast_d4": 4,
    "dcn_fused_d1": 1, "dcn_fused_d2": 2,
}


def _conv_types(task) -> set:
    types = set()
    for cfg in (task.neck_config, task.head_config, task.backbone_config):
        for key in ("conv_type", "block"):  # heads call it `block`
            ct = (cfg or {}).get(key)
            if ct:
                types.add(str(ct))
    return types


def model_uses_dcn(task) -> bool:
    return any(t in _ENGINE_D for t in _conv_types(task))


def dcn_engine_displacement(task) -> Optional[int]:
    """The configured engine's offset clamp, None if unbounded/exact."""
    ds = [_ENGINE_D[t] for t in _conv_types(task) if t in _ENGINE_D]
    real = [d for d in ds if d is not None]
    return min(real) if real else None


@torch.no_grad()
def audit_dcn_offsets(task, images, coverage: float = 0.999,
                      max_d: int = 4) -> Dict[str, Any]:
    """Run `task.model` (in eval mode, on its device and dtype) on the
    calibration `images` (N, H, W, 3, preprocessed float; numpy or a
    tensor) and histogram the |offset| values every DCN offset convolution
    emits.

    Returns {n_values, n_layers, max_offset, exceed_frac: {D: fraction
    > D}, recommended_d: smallest D covering `coverage` of offsets (None if
    even max_d clamps materially -> use the exact engine), coverage}.
    """
    from ..models.layers import DeformableConvBlock

    model = task.model
    param = next(model.parameters())
    mags = []
    hooks = [m.conv_offset.register_forward_hook(
                 lambda _m, _i, out: mags.append(
                     out.detach().abs().float().reshape(-1).cpu().numpy()))
             for m in model.modules() if isinstance(m, DeformableConvBlock)]
    was_training = model.training
    model.eval()
    try:
        model(torch.as_tensor(images).to(param.device, param.dtype))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    if not mags:
        return {"n_values": 0, "n_layers": 0, "max_offset": 0.0,
                "exceed_frac": {}, "recommended_d": None}
    flat = np.concatenate(mags)
    exceed = {d: float(np.mean(flat > d)) for d in range(1, max_d + 1)}
    recommended = None
    for d in range(1, max_d + 1):
        if exceed[d] <= 1.0 - coverage:
            recommended = d
            break
    return {
        "n_values": int(flat.size),
        "n_layers": len(mags),
        "max_offset": float(flat.max()),
        "exceed_frac": exceed,
        "recommended_d": recommended,
        "coverage": coverage,
    }


def format_dcn_audit(stats: Dict[str, Any],
                     engine_d: Optional[int]) -> str:
    """Human-readable report + clamping warning for the configured engine."""
    if not stats.get("n_values"):
        return "DCN offset audit: no deformable layers found"
    lines = [
        f"DCN offset audit over {stats['n_layers']} layer(s), "
        f"{stats['n_values']:,} offsets:",
        f"  max |offset| = {stats['max_offset']:.3f}",
    ]
    for d, frac in stats["exceed_frac"].items():
        lines.append(f"  |offset| > {d}: {frac * 100:.4f}%")
    rec = stats["recommended_d"]
    cov = stats.get("coverage", 0.999) * 100
    if rec is None:
        lines.append(
            f"  no D<=4 covers {cov:.1f}% of offsets: use the exact engine "
            f"(conv_type: dcn)")
    else:
        lines.append(
            f"  smallest exact-equivalent clamp at {cov:.1f}% coverage: "
            f"D={rec} (conv_type: "
            f"{'dcn_fast' if rec == 2 else f'dcn_fast_d{rec}'})")
    if engine_d is not None and rec is not None and engine_d < rec:
        lines.append(
            f"  WARNING: configured engine clamps at ±{engine_d} but "
            f"{stats['exceed_frac'][engine_d] * 100:.3f}% of learned "
            f"offsets exceed it — expect accuracy loss; use D={rec} or "
            f"conv_type: dcn")
    elif engine_d is None:
        lines.append("  configured engine: exact (unbounded) — no clamping")
    return "\n".join(lines)
