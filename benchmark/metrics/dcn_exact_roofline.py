"""The exact DCN sampling's least time over the measured time of the kernels launched inside the spans `dcn.exact`, for
CenterNet's DLA-34 DLAUp neck alone: the least time is that of its 16 blocks (roofline/dcn_exact.py, the reference's
`dla34` backbone and `dlaup` neck at the served maps' size). The record names no configuration, so the reader reads only
a slice whose `dcn.exact` spans all lie inside `neck.dlaup` spans, 16 to each, and returns nothing elsewhere; a cell of
another exact-DCN model needs a reader of its own blocks."""
from cnbench.spans import span_kernel_share
from reference.model import STRIDE
from roofline import dcn_exact

BLOCKS_PER_NECK = 16


def read(rec):
    ops = rec.get("host_ops", [])
    necks = [(s, e) for n, s, e in ops if n == "neck.dlaup"]
    exact = [(s, e) for n, s, e in ops if n == "dcn.exact"]
    maps = rec.get("heatmaps")
    if not exact or len(exact) != BLOCKS_PER_NECK * len(necks) or not maps or not rec.get("batch"):
        return None
    if not all(any(a <= s and e <= b for a, b in necks) for s, e in exact):
        return None
    share = span_kernel_share(rec, ("dcn.exact",))
    if not share:
        return None
    (_, _, h, w), elt = maps[0]
    blocks = dcn_exact.block_inputs((h * STRIDE, w * STRIDE), "dla34", "dlaup")
    measured = share / 100.0 * sum(d for _, _, d in rec["kernels"])
    least = dcn_exact.least_s(blocks, rec["batch"], elt) * len(exact) / len(blocks)
    return 100.0 * least / measured
