"""PyTorch port: CenterNet's DLA-34 with DCNv2 (`neck: DLAUp`, the
configuration benchmark/configs/dla34-dlaup-dcnv2-coco.json) against the
benchmark's float32 reference (benchmark/reference/backbones/dla34.py,
benchmark/reference/necks/dlaup.py), which imports nothing of the port.

Weights come from the benchmark's own draw (cnbench/weights.py: make,
calibrate, load_into) at full channels, batch 2, 64 x 64 images, float32.
On random weights and noise images this model is chaotic: a 1e-3 change of
its input moves the neck's output by most of its size (PERF.md, section
4), so float32 rounding alone moves the float32 reference's logits by up
to about 0.5% of their largest value, and one train step's gradients by
about a tenth. Each comparison is therefore made against the reference in
float64, and holds the port to at most twice the float32 reference's own
distance from it: the port is computed as exactly as the reference. That
distance is a draw of the rounding, and one draw can land near zero, so it
is the largest over three float32 references whose inputs differ by one
unit in the last place (SCALES). A wrong wiring, sum, factor or sampling
moves the maps by their whole size.
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from centernet_lightning_torch import build_centernet
from centernet_lightning_torch.models import layers, meta
from centernet_lightning_torch.models.centernet import CenterNet
from centernet_lightning_torch.models.necks import DLAUp
from centernet_lightning_torch.ops import dcn as dcn_ops

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from cnbench import manifest, traffic, weights  # noqa: E402
from cnbench.common import build_task  # noqa: E402
from reference import loss as loss_ref  # noqa: E402
from reference import model as model_ref  # noqa: E402
from reference.nn import Ctx, bn_update, dcn_block  # noqa: E402

CONFIG = "dla34-dlaup-dcnv2-coco"
SIZE = 64
SEED = 2020
# float32 references a comparison's rounding scale is read from: the input
# as it is and moved up and down by one unit in the last place
SCALES = (1.0, 1.0 + 2.0 ** -23, 1.0 - 2.0 ** -23)


def config(**changes):
    cfg = dict(manifest.config(CONFIG), image_size=[SIZE, SIZE])
    cfg.update(changes)
    return cfg


@pytest.fixture(scope="module")
def drawn():
    """{conv_type: (cfg, params, images)}: weights drawn from the seed and
    BatchNorm statistics from 8 of the cell's noise images; images[:2]
    are the ones compared."""
    out = {}
    images = traffic.images(SEED, 10, SIZE, SIZE, torch.device("cpu"))
    for conv_type in ("dcn", "dcn_fast"):
        cfg = config(neck_config={"conv_type": conv_type})
        params = weights.make(model_ref.param_spec(cfg, (SIZE, SIZE)), cfg, SEED, "cpu")
        weights.calibrate(params, cfg, images[2:], cfg["mean"], cfg["std"])
        out[conv_type] = (cfg, params, images[:2])
    return out


def program(cfg, params):
    task = build_task(cfg, "cpu")
    weights.load_into(task.model, params)
    task.model.to(memory_format=torch.channels_last)
    return task


def as64(params):
    return {k: v.double() if v.is_floating_point() else v for k, v in params.items()}


def gap(a, b):
    return (a.double() - b.double()).abs().max().item()


@pytest.mark.parametrize("conv_type", ["dcn", "dcn_fast"])
def test_eval_maps_match_the_reference(drawn, conv_type):
    cfg, params, images = drawn[conv_type]
    x = model_ref.preprocess(images, cfg["mean"], cfg["std"])
    refs32 = [model_ref.forward(Ctx(params), cfg, x * s) for s in SCALES]
    ref64 = model_ref.forward(Ctx(as64(params)), cfg, x.double())
    task = program(cfg, params)
    with torch.no_grad():
        got = task.model.eval()(x.permute(0, 2, 3, 1))
    for key in ("heatmap", "box_2d"):
        assert got[key].shape == ref64[key].shape == (2, SIZE // 4, SIZE // 4,
                                                      80 if key == "heatmap" else 4)
        rounding = max(gap(r[key], ref64[key]) for r in refs32)
        assert 0 < rounding < 0.02 * ref64[key].abs().max()
        assert gap(got[key], ref64[key]) <= 2 * rounding, key


# the train step's offset convolutions at this share of their drawn weights
OFFSET_SCALE = 0.1
# gradient tensors compared as one vector a group, each group held alone
GROUPS = {"mask": ".conv_mask.", "offset": ".conv_offset.", "deform": ".deform.",
          "upsample": ".up_"}


def train_step_readings(cfg, params, images):
    """One train-mode step of the port and of the reference from the same
    weights: {quantity: (the port's distance from the float64 reference,
    the float32 references' largest)}. Quantities: the three losses, the
    gradients of each of GROUPS and of every other tensor (each group as
    one vector), the median tensor's relative gradient gap, and the moved
    BatchNorm statistics."""
    cfg = dict(cfg, box_loss="GIoULoss", box_loss_weight=5.0)
    x = model_ref.preprocess(images, cfg["mean"], cfg["std"])
    batch = {"boxes": torch.tensor([[[4.0, 6.0, 30.0, 22.0], [40.0, 33.0, 12.0, 20.0],
                                     [0.0, 0.0, 0.0, 0.0]],
                                    [[10.0, 12.0, 44.0, 40.0], [0.0, 0.0, 0.0, 0.0],
                                     [0.0, 0.0, 0.0, 0.0]]]),
             "labels": torch.tensor([[3, 17, 0], [79, 0, 0]]),
             "mask": torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0]])}
    trainable = [k for k in params if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]

    def reference(p, xin):
        p = {k: v.clone() for k, v in p.items()}
        leaves = {k: p[k].requires_grad_() for k in trainable}
        ctx = Ctx(dict(p, **leaves), mode="train")
        losses = loss_ref.detection_loss(model_ref.forward(ctx, cfg, xin), batch, cfg,
                                         model_ref.STRIDE)
        grads = torch.autograd.grad(losses["total"], [leaves[k] for k in trainable],
                                    allow_unused=True)
        with torch.no_grad():
            bn_update(p, ctx.stats)
        return losses, dict(zip(trainable, grads)), p

    refs32 = [reference(params, x * s) for s in SCALES]
    loss64, grad64, stat64 = reference(as64(params), x.double())
    task = program(cfg, params)
    task.model.train()
    got = task.compute_loss(task.model(x.permute(0, 2, 3, 1)), batch)
    got["total"].backward()
    named = dict(task.model.named_parameters())
    state = task.model.state_dict()

    # DLA-34's depth-2 trees project their pooled input and drop it
    # (reference/backbones/dla34.py): those tensors get no gradient in either
    unused = {k for k in trainable if grad64[k] is None}
    assert unused == {k for k in trainable if named[k].grad is None}
    assert all(unused == {k for k in trainable if grad32[k] is None}
               for _, grad32, _ in refs32)
    assert unused and all(".project_" in k for k in unused)
    trainable = [k for k in trainable if k not in unused]
    port_grad = {k: named[k].grad for k in trainable}

    def ratio(distance, port, refs):
        return distance(port), max(distance(r) for r in refs)

    def flat(d, keys):
        return torch.cat([d[k].double().reshape(-1) for k in keys])

    readings = {key: ratio(lambda loss: gap(loss[key], loss64[key]), got,
                           [loss32 for loss32, _, _ in refs32])
                for key in ("heatmap", "box_2d", "total")}
    groups = {name: [k for k in trainable if part in k] for name, part in GROUPS.items()}
    groups["other"] = [k for k in trainable
                       if not any(k in keys for keys in groups.values())]
    for name, keys in groups.items():
        ref = flat(grad64, keys)
        readings[f"grad.{name}"] = ratio(lambda g: (flat(g, keys) - ref).norm().item(),
                                         port_grad, [g for _, g, _ in refs32])

    def median_gap(g):
        return float(np.median([((g[k].double() - grad64[k]).norm()
                                 / grad64[k].norm().clamp_min(1e-30)).item()
                                for k in trainable]))
    readings["grad.median"] = ratio(median_gap, port_grad, [g for _, g, _ in refs32])
    stats = [k for k in params if k.endswith(("running_mean", "running_var"))]
    ref = flat(stat64, stats)
    readings["stats"] = ratio(lambda st: (flat(st, stats) - ref).norm().item(), state,
                              [st for _, _, st in refs32])
    assert not torch.equal(flat(state, stats), flat(params, stats).double())
    return readings


def test_train_step_matches_the_reference(drawn):
    """One train-mode step (`train_step_readings`): the losses held to
    twice the float32 references' largest distance from the float64 one,
    the gradients and BatchNorm statistics to four times it.

    The losses are read at the drawn weights. The gradients and statistics
    are read with the offset convolutions at a tenth of their drawn weights
    (offsets of about +-0.14 pixel, still between the pixels): at the drawn
    +-1.4 pixels the step is chaotic on noise maps, float32 rounding alone
    moving each group of gradients by 4-9%, so that a 10% error in one
    group would pass; at a tenth it moves them by 0.1-2%. Over 1 to 8
    threads the port's loss readings at the drawn weights are 0.01-1.03
    times the references' largest, its gradient and statistics readings at
    a tenth 0.23-2.00 times, and a 10% error in the mask convolutions'
    gradient reads 7.3-8.4 times in `grad.mask`."""
    cfg, params, images = drawn["dcn"]
    readings = train_step_readings(cfg, params, images)
    for key in ("heatmap", "box_2d", "total"):
        port, rounding = readings[key]
        assert port <= 2 * rounding + 1e-6, (key, port, rounding)
    params = {k: v * OFFSET_SCALE if k.endswith(".conv_offset.weight") else v
              for k, v in params.items()}
    readings = train_step_readings(cfg, params, images)
    for key, (port, rounding) in readings.items():
        if key.startswith(("grad.", "stats")):
            assert port <= 4 * rounding, (key, port, rounding)


def test_neck_structure():
    neck = DLAUp([64, 128, 256, 512], conv_type="dcn")
    assert neck.stride == 8 and neck.out_channels == 64
    blocks = [m for m in neck.modules() if isinstance(m, layers.DeformableConvBlock)]
    ups = [m for m in neck.modules() if isinstance(m, layers.DepthwiseUpsample)]
    assert len(blocks) == 16 and all(b.max_displacement is None for b in blocks)
    assert sorted(u.factor for u in ups) == [2] * 7 + [4]
    assert [n for n, _ in neck.named_children()] == ["ida_0", "ida_1", "ida_2", "ida_up"]
    assert [n for n, _ in neck.ida_up.named_children()] == [
        "proj_1", "up_1", "node_1", "proj_2", "up_2", "node_2"]
    assert neck.ida_up.proj_2.conv_offset.in_channels == 256
    assert neck.ida_up.up_2.weight.shape == (64, 1, 8, 8)
    assert neck.ida_0.proj_1.deform.weight.shape == (256, 512, 3, 3)


@pytest.mark.parametrize("neck_config, error", [
    ({"conv_type": "dcn", "out_channels": 64}, TypeError),
    ({"conv_type": "dcn", "upsample_channels": [64]}, TypeError),
    ({"conv_type": "no_such_block"}, KeyError),
], ids=["out_channels", "upsample_channels", "conv_type"])
def test_unmodelled_neck_config_raises(neck_config, error):
    with pytest.raises(error):
        CenterNet(num_classes=3, backbone="dla34", neck="DLAUp", neck_config=neck_config)


@pytest.mark.parametrize("factor", [2, 4])
def test_depthwise_upsample_against_conv_transpose(factor):
    gen = torch.Generator().manual_seed(factor)
    up = layers.DepthwiseUpsample(6, factor)
    with torch.no_grad():
        up.weight.copy_(torch.randn(up.weight.shape, generator=gen))
    x = torch.randn(2, 6, 5, 7, generator=gen)
    want = F.conv_transpose2d(x, up.weight, stride=factor, padding=factor // 2, groups=6)
    got = up(x.contiguous(memory_format=torch.channels_last))
    assert got.shape == (2, 6, 5 * factor, 7 * factor)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert up.bias is None


@pytest.mark.parametrize("factor", [2, 4])
def test_depthwise_upsample_starts_bilinear(factor):
    """init_weights fills every channel with upstream's `fill_up_weights`:
    (1 - |i / f - c|)(1 - |j / f - c|), c = (2f - 1 - f % 2) / 2f."""
    task = CenterNet(num_classes=3, backbone="dla34", neck="DLAUp")
    task.init(torch.Generator().manual_seed(0))
    ups = [m for m in task.model.modules()
           if isinstance(m, layers.DepthwiseUpsample) and m.factor == factor]
    k, c = 2 * factor, (2 * factor - 1 - factor % 2) / (2.0 * factor)
    row = torch.tensor([1 - abs(i / factor - c) for i in range(k)])
    want = row[:, None] * row[None, :]
    assert ups and all(torch.equal(u.weight, want.expand(u.weight.shape)) for u in ups)
    # interior of a constant map stays constant
    y = ups[0](torch.ones(1, ups[0].in_channels, 6, 6))
    torch.testing.assert_close(y[..., factor:-factor, factor:-factor],
                               torch.ones_like(y[..., factor:-factor, factor:-factor]))


def test_exact_engine_is_unclamped():
    """Offsets of +-6 pixels: the program's exact block follows the
    reference's unclamped DCNv2, and a +-4 clamp would give another map."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 8, 20, 20, generator=gen)
    block = layers.get_conv_block("dcn")(8, 5, 3).eval()
    with torch.no_grad():
        block.conv_offset.weight.zero_()
        block.conv_offset.bias.copy_(torch.tensor([6.0, -6.0] * 4 + [-6.0, 6.0] * 5)[:18])
        block.conv_mask.weight.copy_(0.1 * torch.randn(block.conv_mask.weight.shape,
                                                       generator=gen))
        block.deform.weight.copy_(torch.randn(block.deform.weight.shape, generator=gen))
        block.bn.running_var.fill_(2.0)
        got = block(x)
    params = {f"blk.{k}": v for k, v in block.state_dict().items()}
    exact = dcn_block(Ctx(params), "blk", x, 5, None)
    clamped = dcn_block(Ctx(params), "blk", x, 5, 4)
    torch.testing.assert_close(got, exact, rtol=1e-5, atol=1e-5)
    assert gap(exact, clamped) > 0.1 * exact.abs().max()


def test_counter_and_spans():
    task = CenterNet(num_classes=3, backbone="dla34", neck="DLAUp",
                     head_config={"width": 16, "depth": 1})
    task.init(torch.Generator().manual_seed(1))
    model = task.model.eval()
    x = torch.randn(1, SIZE, SIZE, 3)
    before = dcn_ops.exact_taps.calls
    with torch.no_grad():
        model(x)
    assert dcn_ops.exact_taps.calls - before == 16
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(x)
    names = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() in ("dcn.exact", "neck.dlaup")]
    neck = [n for n in names if n[0] == "neck.dlaup"]
    exact = [n for n in names if n[0] == "dcn.exact"]
    assert len(neck) == 1 and len(exact) == 16
    assert all(neck[0][1] <= s and e <= neck[0][2] for _, s, e in exact)


def test_served_through_the_predictor():
    """build_centernet and CenterNetPredictor serve the configuration as
    any other: the top-100 of each image, 16 exact samplings a batch."""
    model = {k: v for k, v in config().items() if k in CenterNet.__dataclass_fields__}
    pred = build_centernet({"model": model}, seed=0, device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    before = dcn_ops.exact_taps.calls
    out = pred.gather_detection2d(images)
    assert dcn_ops.exact_taps.calls - before == 16
    assert out["bboxes"].shape == (2, 100, 4) and out["scores"].shape == (2, 100)
    assert np.isfinite(out["scores"]).all() and (out["labels"] < 80).all()
    assert isinstance(pred.model.neck, DLAUp)
    ref = copy.deepcopy(pred.model)
    meta.init_weights(ref, torch.Generator().manual_seed(0))
    for m in ref.modules():
        if isinstance(m, layers.DeformableConvBlock):
            assert not m.conv_offset.weight.any() and not m.conv_mask.weight.any()
