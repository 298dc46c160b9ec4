"""The DLA-34 DLAUp DCNv2 configuration (dla34-dlaup-dcnv2-coco) and the
cell that serves it (dla34dcn-serve-b64): the reference's tensors against
the program's, the weights drawn for every DCN block and upsample, the
exact DCN sampling's least bytes counted by hand, the two readers of the
spans `dcn.exact` on a synthetic record, and the cell's comparison on the
CPU at a small size."""
import hashlib
import json

import pytest
import torch

import control
from cnbench import manifest, weights
from cnbench.runner import run
from reference import model as model_ref
from roofline import dcn_exact, peaks
from roofline.flops import forward_flops_per_image

CONFIG = "dla34-dlaup-dcnv2-coco"
CELL = "dla34dcn-serve-b64"


def cfg(size=512):
    return dict(manifest.config(CONFIG), image_size=[size, size])


def test_param_spec_and_flops_pinned():
    """The ordered tensor list (weights.make draws in this order) and the
    forward FLOPs an image at 512 x 512 (mfu.serve's denominator)."""
    spec = model_ref.param_spec(cfg(), (512, 512))
    rows = [[k, list(shape), kind] for k, (shape, kind) in spec.items()]
    digest = hashlib.sha256(json.dumps(rows).encode()).hexdigest()
    assert (digest, len(rows), forward_flops_per_image(cfg(), (512, 512))) == (
        "3d5bf3ecaea8350a5863e8134c209e52993b338035b99a945a500fba5d5566ff", 418,
        61367648256)


def test_reference_keys_are_the_programs_state_dict():
    from centernet_lightning_torch.models.centernet import CenterNet

    c = cfg()
    spec = model_ref.param_spec(c, (512, 512))
    with torch.device("meta"):
        task = CenterNet(**{k: v for k, v in c.items() if k in CenterNet.__dataclass_fields__})
    state = task.model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: shape for k, (shape, _) in spec.items()}


def test_every_dcn_weight_and_upsample_is_drawn_from_the_seed():
    c = cfg(64)
    spec = model_ref.param_spec(c, (64, 64))
    drawn = [k for k in spec if k.endswith(("conv_offset.weight", "conv_mask.weight",
                                            "deform.weight"))]
    ups = [k for k in spec if ".up_" in k]
    assert len(drawn) == 3 * 16 and len(ups) == 8
    assert all(spec[k][1] == "conv" for k in ups)
    a, b = weights.make(spec, c, 1, "cpu"), weights.make(spec, c, 2, "cpu")
    for k in drawn + ups:
        assert a[k].std() > 0 and not torch.equal(a[k], b[k]), k


def test_block_inputs_of_the_sixteen_blocks():
    blocks = dcn_exact.block_inputs((512, 512))
    assert len(blocks) == 16
    assert blocks.count((64, 128, 128)) == 5 and blocks.count((128, 64, 64)) == 6
    assert blocks[0] == (512, 16, 16)


def test_sampling_bytes_by_hand():
    # one image's stride-4 block of 64 channels at 512, bf16: x 64, the 27
    # offset and mask channels, the 9 x 64 taps, 2 bytes each, per pixel
    assert dcn_exact.sampling_bytes(64, 128, 128, 2) == 128 * 128 * 1334 == 21856256
    assert dcn_exact.sampling_ops(64, 128, 128) == 128 * 128 * 9 * (9 * 64 + 10)
    blocks = [(64, 128, 128), (128, 64, 64)]
    moved = 4 * (21856256 + 64 * 64 * (128 * 2 + 27 * 2 + 9 * 128 * 2))
    assert dcn_exact.least_s(blocks, 4, 2) == pytest.approx(moved / peaks.HBM_BYTES_PER_S)


def record():
    """One `neck.dlaup` span holding 16 `dcn.exact` spans, of a 2-image
    slice at 64 x 64 (heatmaps 16 x 16, float32): four launches, one each
    inside the first two exact spans, and their four kernels in launch
    order."""
    host = [("neck.dlaup", 0.09, 0.45), ("dcn.exact", 0.1, 0.2), ("dcn.exact", 0.3, 0.4)]
    host += [("dcn.exact", 0.41 + 0.002 * i, 0.411 + 0.002 * i) for i in range(14)]
    host += [("cudaLaunchKernel", t, t + 0.001) for t in (0.05, 0.15, 0.35, 0.5)]
    kernels = [("conv", 0.06, 0.01), ("gather", 0.16, 0.02), ("mul", 0.36, 0.03),
               ("peak", 0.51, 0.04)]
    return {"host_ops": host, "kernels": kernels, "window_s": 1.0, "steps": 1,
            "images": 2, "batch": 2, "heatmaps": [((2, 80, 16, 16), 4)]}


def test_readers_of_the_exact_spans_by_hand():
    read = manifest.metric_reader
    assert read("dcn_exact_share.serve")(record()) == pytest.approx(100 * 0.05 / 0.1)
    blocks = dcn_exact.block_inputs((64, 64))
    least = dcn_exact.least_s(list(blocks), 2, 4)
    assert read("dcn_exact_roofline")(record()) == pytest.approx(100 * least / 0.05)


@pytest.mark.parametrize("change", ["no_neck", "span_outside_the_neck", "fifteen_a_neck"])
def test_roofline_reads_only_the_dla34_neck(change):
    """The record names no configuration: `dcn_exact_roofline` charges
    DLA-34's 16 blocks only where every exact span lies in a `neck.dlaup`
    span, 16 to each, and reads nothing elsewhere."""
    rec = record()
    ops = rec["host_ops"]
    if change == "no_neck":
        ops[:] = [h for h in ops if h[0] != "neck.dlaup"]
    elif change == "span_outside_the_neck":
        ops[ops.index(("dcn.exact", 0.3, 0.4))] = ("dcn.exact", 0.46, 0.47)
    else:
        ops.remove(("dcn.exact", 0.41, 0.411))
    assert manifest.metric_reader("dcn_exact_share.serve")(rec) is not None
    assert manifest.metric_reader("dcn_exact_roofline")(rec) is None


def test_readers_find_nothing_without_the_spans():
    rec = record()
    rec["host_ops"] = [h for h in rec["host_ops"] if h[0] != "dcn.exact"]
    for name in ("dcn_exact_share.serve", "dcn_exact_roofline"):
        assert manifest.metric_reader(name)(rec) is None


def _verdict(cell):
    result, checks = run(cell, manifest.manifest())
    return result["correct"], {k: c["value"] for k, c in checks.items()}


@pytest.mark.parametrize("hook", [None, control.int8, control.no_peak_test],
                         ids=["sound", "int8_control", "no_peak_test"])
def test_cell_comparison_on_the_cpu(tiny_cell, hook):
    """The cell's own configuration and limits at 64 x 64: the program
    passes; its int8 path and the decode without its peak test (the
    runs `box_gap_q90`'s and `rank_gap_q90`'s limits were set from) do not.
    Batches of 8, so that BatchNorm is calibrated on the cell's 8 images:
    from 2, the deepest levels' statistics come from a few values each,
    and this chaotic model (PERF.md, section 4) carries float32 rounding
    past the limits."""
    cell = tiny_cell(CELL, batch=8, calibration_images=8, reference_block=8)
    cell.predictor_hook = hook
    ok, numbers = _verdict(cell)
    assert ok == (hook is None), numbers
