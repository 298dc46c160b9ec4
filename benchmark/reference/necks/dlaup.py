"""CenterNet's DLA-34 neck (Zhou et al., "Objects as Points",
arXiv:1904.07850; xingyizhou/CenterNet `pose_dla_dcn.py`, `DLASeg` with
down_ratio 4): upstream's `DLAUp` on the backbone's four maps, then its
final `IDAUp` over the three finest maps `DLAUp` returns. Returns the
stride-4 map, as wide as the finest input.

An aggregation pass `ida(layers, start, end)` runs, for i from start + 1
to end - 1 in order, with j = i - start:
  layers[i] = node_j(up_j(proj_j(layers[i])) + layers[i - 1]),
proj_j and node_j 3x3 blocks of `conv_type` to the pass's width (`dcn`:
upstream's `DeformConv`, modulated DCNv2, BatchNorm, ReLU; nn.conv_block),
up_j a depthwise transposed conv (kernel 2f, stride f, padding f / 2, one
group a channel, no bias) by the factor f that brings layers[i] to
layers[i - 1]'s resolution. `DLAUp` runs `ida_0` .. `ida_2` over the
levels from 2, 1 and 0 (upstream's startp + 2, + 1, + 0), each pass as
wide as its start level and every factor 2, and keeps the coarsest level
of each pass: [stride 4, 8, 16, 32]. `ida_up` runs over the first three
at 64, with factors 1, 2 and 4 (up_1 x2, up_2 x4). The 16 blocks: ida_0 2,
ida_1 4, ida_2 6, ida_up 4; five of them at stride 4.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..nn import Ctx, checkpoint_stage, conv_block, q

MODELLED = ("conv_type",)


def up(ctx: Ctx, name: str, x: torch.Tensor, f: int) -> torch.Tensor:
    c = x.shape[1]
    # kind "conv": drawn from the seed like every convolution
    w = ctx.param(f"{name}.weight", (c, 1, 2 * f, 2 * f), "conv")
    return F.conv_transpose2d(q(ctx, x), q(ctx, w), stride=f, padding=f // 2, groups=c)


def ida(ctx: Ctx, name: str, layers: List[torch.Tensor], start: int, end: int,
        width: int, factors, conv_type: str, record: Optional[list]) -> None:
    def block(ctx, block_name, x):
        if record is not None:
            record.append(tuple(int(s) for s in x.shape[1:]))
        return conv_block(ctx, block_name, x, width, conv_type)

    for i in range(start + 1, end):
        j = i - start

        def proj_up(ctx, x, j=j):
            return up(ctx, f"{name}.up_{j}", block(ctx, f"{name}.proj_{j}", x), factors[j])

        x = checkpoint_stage(ctx, proj_up, layers[i]) + layers[i - 1]
        layers[i] = checkpoint_stage(
            ctx, lambda ctx, t, j=j: block(ctx, f"{name}.node_{j}", t), x)


def forward(ctx: Ctx, feats, cfg: Dict, prefix: str = "neck",
            record: Optional[list] = None) -> torch.Tensor:
    """`record`, a list, gets (C, H, W) of each 3x3 block's input, in call
    order."""
    unknown = sorted(set(cfg) - set(MODELLED))
    if unknown:
        raise ValueError(f"the reference DLAUp does not model {unknown}")
    conv_type = cfg.get("conv_type", "dcn")
    layers = list(feats)
    n = len(layers)
    out = [layers[-1]]
    for i in range(n - 1):
        start = n - 2 - i
        ida(ctx, f"{prefix}.ida_{i}", layers, start, n, feats[start].shape[1],
            [1] + [2] * (n - 1 - start), conv_type, record)
        out.insert(0, layers[-1])
    y = out[:n - 1]
    ida(ctx, f"{prefix}.ida_up", y, 0, n - 1, feats[0].shape[1],
        [2 ** j for j in range(n - 1)], conv_type, record)
    return y[-1]


def block_inputs(feats, cfg: Optional[Dict] = None) -> List[Tuple[int, int, int]]:
    """(C, H, W) of each 3x3 block's input for one image, in call order,
    given the backbone's maps (their shapes are what is read)."""
    record: list = []
    forward(Ctx(spec={}), [torch.zeros((1, *f.shape[1:]), device="meta") for f in feats],
            dict(cfg or {}), record=record)
    return record
