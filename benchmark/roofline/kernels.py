"""The least time of each measured kernel a launch: the larger of its
bytes over the memory's peak and its operations over the arithmetic peak.
Bytes count each input read once and each output written once."""
from __future__ import annotations

from . import peaks

TAPS = 9


def bound_s(moved_bytes: float, ops: float, ops_per_s: float) -> float:
    return max(moved_bytes / peaks.HBM_BYTES_PER_S, ops / ops_per_s)


def peak_decode_s(n: int, h: int, w: int, c: int, elt: int) -> float:
    """csrc/peak_decode.cu: the (N, H, W, C) heatmap read once, an f32 score
    and an int32 label a pixel written once; about 10 operations a map
    value (the 3x3 maximum, the compare and the class reduction)."""
    return bound_s(n * h * w * c * elt + n * h * w * 8, n * h * w * c * 10,
                   peaks.F32_OPS)


def dcn_sample_s(n: int, h: int, w: int, c: int, elt: int) -> float:
    """csrc/dcn_sample.cu: x and the five (N, H, W, 9) planes (two int32
    floors, three f32 fractions and modulations) read once, the nine tap
    maps written once; f32 arithmetic on the CUDA cores, per output value 4
    corners x (multiply + add), per pixel and tap about 10 for the corner
    weights."""
    moved = n * h * w * (c * elt + TAPS * 5 * 4 + TAPS * c * elt)
    ops = n * h * w * TAPS * (8 * c + 10)
    return bound_s(moved, ops, peaks.F32_OPS)
