"""The peak kernel's launch plan (`ops/peak_decode.py:launch_plan`), on the
CPU.

csrc/peak_decode.cu takes its blocks from the plan: a strip of `strip`
output columns and a band of `band` rows a block, `lanes` threads a pixel
each holding `items` vectors of `vec` classes, `passes` class chunks of
`chunk` classes, and a ring of `stages` staged input rows of `stage_bytes`
(a pixel's chunk at `pitch` bytes when passes > 1). These tests walk the
plan by the kernel's own index rules and hold that every pixel and class
is computed exactly once, every output written exactly once, every staged
copy and every read inside its stage, and the block within the card's
shared memory and the kernel's thread and register-slot limits.
"""
import numpy as np
import pytest
import torch

from centernet_lightning_torch.ops import peak_decode as TP

FLAGSHIP = (128, 128)             # the serving map's H, W (C = 80)
SMALL = (37, 53)


def _walk(plan, h, w, c, elt, misalign=0):
    """Counts of the (y, x, class) the kernel computes and of the (y, x) it
    writes, per the kernel's indexing, checking every copy and read
    against the stage on the way."""
    assert plan.threads % 32 == 0 and plan.threads <= TP.MAX_THREADS
    assert 32 % plan.lanes == 0 and plan.items <= TP.ITEMS[plan.vec]
    assert plan.smem_bytes <= TP.SMEM_LIMIT and plan.stages >= 4
    assert plan.stage_bytes % TP.ALIGN == 0
    computed = np.zeros((h, w, c), np.int32)
    written = np.zeros((plan.passes, h, w), np.int32)
    per_warp = 32 // plan.lanes
    for x0 in range(0, w, plan.strip):
        xa = max(x0 - 1, 0)
        ncols = min(x0 + plan.strip, w - 1) - xa + 1
        for y0 in range(0, h, plan.band):
            y1 = min(y0 + plan.band, h)
            for p in range(plan.passes):
                c0 = p * plan.chunk
                cn = min(plan.chunk, c - c0)
                for r in range(y0 - 1, y1 + 1):          # the staged rows
                    pix0 = min(max(r, 0), h - 1) * w + xa
                    if plan.passes == 1:
                        a = misalign + pix0 * c * elt
                        span = -(-(a + ncols * c * elt) // 16) * 16 - a // 16 * 16
                        assert span <= plan.stage_bytes
                    else:
                        for j in range(ncols):
                            a = misalign + ((pix0 + j) * c + c0) * elt
                            span = -(-(a + cn * elt) // 16) * 16 - a // 16 * 16
                            assert span <= plan.pitch
                        assert ncols * plan.pitch <= plan.stage_bytes
                for tid in range(plan.threads):
                    g, li = divmod(tid, plan.lanes)
                    x = x0 + g
                    xc = min(x, w - 1)
                    for i in range(plan.items):
                        k0 = (li + i * plan.lanes) * plan.vec
                        if k0 >= cn:
                            continue
                        assert k0 + plan.vec <= cn
                        for j in (max(xc - 1, 0) - xa, xc - xa, min(xc + 1, w - 1) - xa):
                            assert 0 <= j < ncols
                            end = (j * (c if plan.passes == 1 else 0) + k0
                                   + plan.vec) * elt + 15
                            assert j * plan.pitch + end <= plan.stage_bytes
                        if x < w:
                            computed[y0:y1, x, c0 + k0:c0 + k0 + plan.vec] += 1
                    warp, lane = divmod(tid, 32)
                    xo = x0 + warp * per_warp + lane
                    if lane < per_warp and xo < min(x0 + plan.strip, w):
                        written[p, y0:y1, xo] += 1
    return computed, written


CASES = [(SMALL, c, elt, misalign) for c in (1, 7, 80, 1203, 4099)
         for elt in (2, 4) for misalign in (0, elt)]
CASES += [(FLAGSHIP, 80, elt, 0) for elt in (2, 4)]
CASES += [((1, 1), 80, 2, 0), ((1, 70), 80, 2, 0), ((70, 1), 1203, 4, 0),
          ((9, 100), 80, 2, 0), ((6, 9), 1208, 2, 0)]
# class chunks of 16-byte vectors, as the card's peak cases run them
CASES += [((32, 48), c, elt, 0) for c in (1208, 516) for elt in (2, 4)]


@pytest.mark.parametrize(
    "hw,c,elt,misalign", CASES,
    ids=[f"{h}x{w}_c{c}_{'bf16' if e == 2 else 'f32'}{'_mis' if m else ''}"
         for (h, w), c, e, m in CASES])
def test_plan_covers_every_pixel_and_class_once(hw, c, elt, misalign):
    h, w = hw
    plan = TP.launch_plan(h, w, c, elt, aligned=misalign == 0)
    computed, written = _walk(plan, h, w, c, elt, misalign)
    assert (computed == 1).all()
    assert (written == 1).all()


def test_flagship_plan():
    """The serving map, (64, 128, 128, 80) bf16: one pass of 16-byte
    vectors, 4 lanes of 3 vectors a pixel, 64 columns and 32 rows a block
    of 256 threads, well inside shared memory."""
    plan = TP.launch_plan(128, 128, 80, 2, aligned=True)
    assert (plan.vec, plan.lanes, plan.items, plan.passes) == (8, 4, 3, 1)
    assert (plan.strip, plan.band, plan.stages, plan.threads) == (64, 32, 4, 256)
    assert plan.stage_bytes == -(-(66 * 160 + 32) // 128) * 128  # span + slack
    assert plan.blocks(64, 128, 128) == 64 * 2 * 4
    assert plan.smem_bytes < TP.SMEM_LIMIT // 4


def test_wide_classes_take_chunks():
    """A row of 10 pixels of 4099 f32 classes (164 KB) would crowd shared
    memory: the plan streams the classes in chunks of 512 instead."""
    plan = TP.launch_plan(32, 48, 4099, 4, aligned=True)
    assert plan.vec == 1 and plan.chunk == 512 and plan.passes == 9
    assert plan.smem_bytes <= TP.SMEM_LIMIT


@pytest.mark.parametrize("c,elt,vec,passes", [(1203, 2, 1, 3), (1203, 4, 1, 3),
                                              (1208, 2, 8, 2), (1208, 4, 4, 3),
                                              (516, 4, 4, 2), (516, 2, 1, 2)])
def test_chunk_loads(c, elt, vec, passes):
    """Which class chunks take 16-byte vectors: a pixel of 1203 classes is
    no multiple of 16 bytes in either dtype, so one-value loads; 1208
    (either dtype) and 516 f32 stride 16-byte vectors by the chunk's
    pitch."""
    plan = TP.launch_plan(32, 48, c, elt, aligned=True)
    assert (plan.vec, plan.passes) == (vec, passes)
    assert plan.pitch % 16 == 0 and plan.pitch >= plan.chunk * elt + TP.SLACK


def test_plan_for_reads_the_alignment_of_the_map():
    """A map whose pointer is not 16-byte aligned takes one-value loads;
    the same map aligned takes 16-byte vectors."""
    flat = torch.zeros(2 * 9 * 11 * 16 + 1, dtype=torch.bfloat16)
    aligned = flat[:-1].view(2, 9, 11, 16)
    shifted = flat[1:].view(2, 9, 11, 16)
    assert TP.plan_for(aligned).vec == 8
    assert TP.plan_for(shifted).vec == 1


def test_plan_is_computed_once_a_shape():
    """The wrapper looks the plan and its ctypes ints up, not recomputing
    them a call; the ints are the plan's fields in order."""
    x = torch.zeros(2, 9, 11, 80, dtype=torch.bfloat16)
    plan = TP.plan_for(x)
    assert TP.plan_for(x.clone()) is plan
    assert plan.ints is plan.ints
    assert list(plan.ints) == [getattr(plan, f.name)
                               for f in TP.dataclasses.fields(plan)]
