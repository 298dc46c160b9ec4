"""PyTorch port vs the JAX package: int8 post-training quantization
(centernet_lightning_torch/quantize.py against
centernet_lightning_tpu/quantize.py), on the CPU.

- The plain int8 conv's int32 accumulators `==` JAX's
  `lax.conv_general_dilated(..., preferred_element_type=int32)` on the same
  int8 inputs (1x1, 3x3 s1, 3x3 s2 SAME at an even size, 7x7 s2, grouped),
  and the card's route (`int8_conv_mm`: im2col and `torch._int_mm`, which
  this CPU build also runs) `==` the plain version on the same cases,
  chunked and unchunked.
- One quantized conv: the int8 weights and their scales `==` JAX's, the
  dequantized output within 1 f32 ulp of JAX's `_int8_conv`.
- Calibration on converted weights: the same set of convolutions as JAX's
  (mapped through utils/convert.py) on every model family the port builds,
  the scales within 1e-5.
- With JAX's scales, the port's quantized heads within 1e-2 of the largest
  magnitude of JAX's `quantized_apply`; port int8 against port float under
  0.05 (JAX's own bound).
- The JAX package's tests of tests/test_quantize.py, ported: depthwise
  convs excluded by default but quantizable, the narrow head convs
  quantized, the DCN offset convs excluded, the predictor API, and the
  calibration loader (run on the port as it is).
- int8 tracking: `gather_tracking2d` on a FairMOT model, its ReID head in
  int8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import test_quantize as jax_quantize_tests
from centernet_lightning_tpu import quantize as jq
from centernet_lightning_tpu.api import CenterNetPredictor as JPredictor
from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet

from centernet_lightning_torch import quantize as tq
from centernet_lightning_torch.api import (QuantizedCenterNetPredictor,
                                           build_centernet)
from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet
from centernet_lightning_torch.models.layers import SameConv2d
from centernet_lightning_torch.utils.convert import (module_name,
                                                     variables_to_state_dict)

from _torch_port_helpers import (NARROW_DARKNET, random_flax_variables,
                                 run_on_port)

# (x NCHW, w OIHW, stride, explicit pads (top, bottom, left, right) or
# "SAME", groups)
CONVS = {
    "1x1": ((2, 16, 9, 9), (24, 16, 1, 1), 1, (0, 0, 0, 0), 1),
    "3x3_s1": ((2, 16, 10, 10), (24, 16, 3, 3), 1, "SAME", 1),
    "3x3_s2_same_even": ((2, 16, 10, 10), (24, 16, 3, 3), 2, "SAME", 1),
    "7x7_s2": ((2, 3, 16, 16), (16, 3, 7, 7), 2, (3, 3, 3, 3), 1),
    "grouped": ((2, 16, 8, 8), (16, 1, 3, 3), 1, "SAME", 16),
}


def int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def resolve_pads(case):
    x_shape, w_shape, s, pads, _ = case
    if pads != "SAME":
        return pads
    conv = tq.Int8Conv2d.__new__(tq.Int8Conv2d)
    conv.same, conv.kernel_size, conv.stride = True, w_shape[2:], (s, s)
    return conv.pads(*x_shape[2:])


def lax_int32(x, w, stride, pads, groups):
    """JAX's int8 conv (quantize.py:_int8_conv's call) on NCHW / OIHW int8
    inputs, returned NCHW."""
    top, bottom, left, right = pads
    y = jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(w.transpose(2, 3, 1, 0)),
        window_strides=(stride, stride), padding=((top, bottom), (left, right)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups,
        preferred_element_type=jnp.int32)
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name", sorted(CONVS))
def test_plain_int8_conv_equals_lax(name):
    rng = np.random.default_rng(1)
    x_shape, w_shape, s, _, groups = CONVS[name]
    x, w = int8(rng, x_shape), int8(rng, w_shape)
    pads = resolve_pads(CONVS[name])
    if name == "3x3_s2_same_even":
        assert pads == (0, 1, 0, 1)          # flax's SAME at stride 2
    got = tq.int8_conv_plain(torch.from_numpy(x), torch.from_numpy(w), (s, s),
                             pads, (1, 1), groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), lax_int32(x, w, s, pads, groups))


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("name", sorted(CONVS) + ["narrow_out", "one_pixel"])
def test_card_route_equals_plain(name, chunked, monkeypatch):
    """The card's route (im2col, K and N padded to 8, the rows padded past
    16, chunks of the batch, one product a group) gives the plain
    version's int32 values, through this CPU build's `_int_mm`."""
    rng = np.random.default_rng(2)
    case = {"narrow_out": ((3, 16, 8, 8), (4, 16, 1, 1), 1, (0, 0, 0, 0), 1),
            "one_pixel": ((1, 16, 2, 2), (8, 16, 3, 3), 2, "SAME", 1)
            }.get(name) or CONVS[name]
    x_shape, w_shape, s, _, groups = case
    pads = resolve_pads(case)
    x = torch.from_numpy(int8(rng, x_shape)).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy(int8(rng, w_shape))
    if chunked:
        monkeypatch.setattr(tq, "IM2COL_BYTES", 64)
    ref = tq.int8_conv_plain(x, w, (s, s), pads, (1, 1), groups)
    got = tq.int8_conv_mm(x, w, (s, s), pads, (1, 1), groups)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.parametrize("name", ["3x3_s1", "3x3_s2_same_even", "7x7_s2",
                                  "1x1_bias"])
def test_dequantized_conv_within_one_ulp_of_jax(name):
    """One conv from the same float weights: int8 weights and scales equal
    to JAX's quantize_conv_params, output within 1 ulp of `_int8_conv`."""
    rng = np.random.default_rng(3)
    k, s, same, c_in = {"3x3_s1": (3, 1, True, 16),
                        "3x3_s2_same_even": (3, 2, True, 16),
                        "7x7_s2": (7, 2, False, 3),
                        "1x1_bias": (1, 1, False, 16)}[name]
    bias = name == "1x1_bias"
    flax_conv = nn.Conv(24, (k, k), strides=(s, s), use_bias=bias,
                        padding="SAME" if same else [(k // 2, k // 2)] * 2)
    x = rng.normal(size=(2, 12, 12, c_in)).astype(np.float32)
    variables = {"params": {"Conv_0": {
        "kernel": rng.normal(size=(k, k, c_in, 24)).astype(np.float32) * 0.2}}}
    if bias:
        variables["params"]["Conv_0"]["bias"] = rng.normal(size=24).astype(np.float32)
    act_scale = float(np.abs(x).max()) / 127.0
    jqt = jq.quantize_conv_params(variables, {"Conv_0": act_scale})["Conv_0"]
    ref = np.asarray(jq._int8_conv(flax_conv, jnp.asarray(x), jqt, act_scale))

    conv = (SameConv2d(c_in, 24, k, stride=s, bias=bias) if same else
            torch.nn.Conv2d(c_in, 24, k, stride=s, padding=k // 2, bias=bias))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            variables["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1)))
        if bias:
            conv.bias.copy_(torch.from_numpy(variables["params"]["Conv_0"]["bias"]))
    q = tq.quantize_conv_params(torch.nn.ModuleDict({"c": conv}),
                                {"c": act_scale})["c"]
    np.testing.assert_array_equal(q["w"].numpy(),
                                  np.asarray(jqt["w"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(q["s"].numpy(), np.asarray(jqt["s"]))
    with torch.no_grad():
        got = tq.Int8Conv2d(conv, act_scale, q)(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_array_max_ulp(got, ref, maxulp=1)


# ---- calibration against JAX on converted weights, every family ----------

FAMILIES = {
    "resnet18_fpn": dict(backbone="resnet18", backbone_config={"width": 16},
                         neck="FPN", neck_config={"out_channels": 16}),
    "resnet18_fpn_dcn": dict(backbone="resnet18", backbone_config={"width": 16},
                             neck="FPN", neck_config={"out_channels": 16,
                                                      "conv_type": "dcn"}),
    "cspdarknet_fpn_spp": dict(
        backbone="cspdarknet53", backbone_config=NARROW_DARKNET,
        neck="FPN", neck_config={"out_channels": 16},
        extra_block={"name": "SPP", "pool_sizes": [3, 5]}),
    "mobilenet_v2_simple_separable": dict(
        backbone="mobilenet_v2", backbone_config={"width_mult": 0.25},
        neck="SimpleNeck", neck_config={"upsample_channels": [16, 12, 8],
                                        "conv_type": "separable"}),
    "mobilenet_v3_bifpn": dict(
        backbone="mobilenet_v3_small",
        neck="BiFPN", neck_config={"out_channels": 16}),
    "resnet34_simple_conv_transpose": dict(
        backbone="resnet34", backbone_config={"width": 8},
        neck="SimpleNeck", neck_config={"upsample_channels": [16, 12, 8],
                                        "upsample_type": "conv_transpose"}),
    "vovnet39_fpn": dict(
        backbone="vovnet39", backbone_config={
            "stage_channels": (8, 8, 12, 12), "concat_channels": (16, 16, 24, 24)},
        neck="FPN", neck_config={"out_channels": 16}),
    "dla34_ida": dict(
        backbone="dla34", backbone_config={"channels": (8, 12, 16, 16, 24, 32)},
        neck="IDA", neck_config={"out_channels": 16}),
    "efficientnet_b0_separable_fpn": dict(
        backbone="efficientnet_b0", backbone_config={"width_mult": 0.25},
        neck="FPN", neck_config={"out_channels": 16, "conv_type": "separable"}),
    "fairmot_reid": dict(backbone="resnet18", backbone_config={"width": 16},
                         neck="FPN", neck_config={"out_channels": 16},
                         reid_config={"emb_dim": 16, "max_track_ids": 8,
                                      "width": 16, "depth": 1}),
}
SIZE = 32


def converted_pair(cfg, seed):
    """(jax task, variables, port task) with the same weights."""
    rng = np.random.default_rng(seed)
    jtask = JCenterNet(**cfg)
    variables = random_flax_variables(jtask, rng, image_size=(SIZE, SIZE))
    ttask = TCenterNet(**cfg)
    ttask.model.load_state_dict(variables_to_state_dict(variables), strict=True)
    ttask.model.eval()
    return jtask, variables, ttask


def port_scales_of(jax_scales, variables):
    return {module_name(k, variables["params"]): v for k, v in jax_scales.items()}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_calibration_scales_match_jax(family):
    cfg = dict(num_classes=3, head_config={"width": 16, "depth": 1},
               **FAMILIES[family])
    jtask, variables, ttask = converted_pair(cfg, 4)
    rng = np.random.default_rng(5)
    batches = [rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
               for _ in range(2)]
    j_scales = jq.collect_conv_scales(jtask.model, variables,
                                      [jnp.asarray(b) for b in batches])
    t_scales = tq.collect_conv_scales(ttask.model,
                                      [torch.from_numpy(b) for b in batches])
    mapped = port_scales_of(j_scales, variables)
    assert set(t_scales) == set(mapped) == set(tq.conv_targets(ttask.model))
    assert len(t_scales) > 10
    for name, v in mapped.items():
        assert abs(t_scales[name] - v) <= 1e-5 * v, name
    convs = dict(ttask.model.named_modules())
    assert not any(type(convs[n]).__name__ == "ConvTranspose2d" for n in t_scales)
    if "dcn" in family:
        assert not any("conv_offset" in n or "conv_mask" in n for n in t_scales)
    if "mobilenet" in family or "efficientnet" in family:
        assert all(convs[n].groups == 1 for n in t_scales)
        assert any(m.groups > 1 for m in convs.values()
                   if isinstance(m, torch.nn.Conv2d))
    # the squeeze-excite 1x1 convs are flax nn.Convs, quantized in JAX too;
    # DLA's dropped projection is called, so calibrated
    wanted = {"vovnet": ".ese.conv", "efficientnet": ".se.reduce",
              "dla": "level4.project_conv"}
    for key, part in wanted.items():
        if key in family:
            assert any(n.endswith(part) for n in t_scales), part


@pytest.mark.parametrize("family", ["resnet18_fpn"])
def test_quantized_heads_match_jax_with_its_scales(family):
    """The JAX package's own end-to-end check (its initial weights, normal
    inputs): on the same weights and with JAX's scales, the port's int8
    heads agree with JAX's; both stay within 0.05 of float. (On
    `random_flax_variables` JAX's own int8 error is 0.06-0.08.)"""
    cfg = dict(num_classes=4, head_config={"width": 16, "depth": 1},
               **FAMILIES[family])
    jtask = JCenterNet(**cfg)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: jtask.init(key, image_size=(SIZE, SIZE), batch_size=1))(
            jax.random.PRNGKey(0)))
    ttask = TCenterNet(**cfg)
    ttask.model.load_state_dict(variables_to_state_dict(variables), strict=True)
    ttask.model.eval()
    x = np.random.default_rng(7).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    j_ex, t_ex = jq.default_exclude, tq.default_exclude
    j_scales = jq.collect_conv_scales(jtask.model, variables, [jnp.asarray(x)],
                                      exclude=j_ex)
    qtree = jax.jit(lambda v: jq.quantize_conv_params(v, j_scales))(variables)
    ref = jax.jit(lambda v, q, x: jq.quantized_apply(
        jtask.model, v, q, j_scales, x, exclude=j_ex, train=False))(
            variables, qtree, jnp.asarray(x))
    qmodel = tq.quantize_model(ttask.model, exclude=t_ex,
                               act_scales=port_scales_of(j_scales, variables))
    assert sum(isinstance(m, tq.Int8Conv2d) for m in qmodel.modules()) == len(j_scales)
    assert not any(isinstance(m, tq.Int8Conv2d) for m in ttask.model.modules())
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = qmodel(xt)
        flt = ttask.model(xt)
    for head in ("heatmap", "box_2d"):
        r = np.asarray(ref[head])
        scale = np.abs(r).max()
        assert np.abs(got[head].numpy() - r).max() <= 1e-2 * scale, head
        f = flt[head].numpy()
        assert np.abs(got[head].numpy() - f).max() / np.abs(f).max() < 0.05, head


# ---- the JAX package's tests of tests/test_quantize.py, on the port -------

def test_load_calibration_images_skips_non_images(request, monkeypatch):
    run_on_port(jax_quantize_tests, "test_load_calibration_images_skips_non_images",
                request, monkeypatch, ["centernet_lightning_tpu.quantize"])


def test_depthwise_excluded_by_default_but_quantizable():
    """As the JAX test's module (a strided conv, a depthwise one, a 1x1),
    on the same weights: the default leaves the depthwise conv in float,
    a permissive exclude takes it too, both within 0.05 of float; the
    targets are JAX's."""
    rng = np.random.default_rng(0)

    class M(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            x = nn.Conv(128, (3, 3), strides=(2, 2), padding="SAME",
                        use_bias=False)(x)
            x = nn.Conv(128, (3, 3), padding="SAME", feature_group_count=128)(x)
            return nn.Conv(128, (1, 1))(x)

    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    variables = M().init(jax.random.PRNGKey(0), jnp.asarray(x))
    model = torch.nn.Sequential(SameConv2d(3, 128, 3, stride=2, bias=False),
                                SameConv2d(128, 128, 3, groups=128),
                                torch.nn.Conv2d(128, 128, 1))
    p = variables["params"]
    with torch.no_grad():
        for i in range(3):
            model[i].weight.copy_(torch.from_numpy(
                np.array(p[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)))
            if model[i].bias is not None:
                model[i].bias.copy_(torch.from_numpy(np.array(p[f"Conv_{i}"]["bias"])))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    j_default = jq.collect_conv_scales(M(), variables, [jnp.asarray(x)],
                                       apply_kwargs={"train": False})
    assert sorted(j_default) == ["Conv_0", "Conv_2"]
    with torch.no_grad():
        ref = model(xt)
        denom = float(ref.abs().max())
        for exclude, names in ((tq.default_exclude, ["0", "2"]),
                               (lambda *a: False, ["0", "1", "2"])):
            scales = tq.collect_conv_scales(model, [xt], exclude=exclude)
            assert sorted(scales) == names
            got = tq.quantized_apply(model, tq.quantize_conv_params(model, scales),
                                     scales, xt)
            assert got.shape == ref.shape
            assert float((got - ref).abs().max()) / denom < 0.05


def test_narrow_output_convs_quantize_by_default():
    task = TCenterNet(num_classes=4, backbone="resnet18", neck="FPN",
                      neck_config={"out_channels": 128},
                      head_config={"width": 128, "depth": 1})
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 32, 32, 3)).astype(np.float32))
    scales = tq.collect_conv_scales(task.model, [x])
    assert "heads.heatmap.out_conv" in scales and "heads.box_2d.out_conv" in scales
    assert any(k.startswith("heads.heatmap") for k in scales)


def test_dcn_offset_convs_excluded():
    task = TCenterNet(num_classes=2, backbone="resnet18", neck="FPN",
                      neck_config={"out_channels": 16, "conv_type": "dcn_fast"},
                      head_config={"width": 16, "depth": 1})
    task.model.eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 32, 32, 3)).astype(np.float32))
    scales = tq.collect_conv_scales(task.model, [x])
    assert scales, "non-DCN convs must still calibrate"
    blocks = [n for n, m in task.model.named_modules()
              if type(m).__name__ == "DeformableConvBlock"]
    assert blocks
    assert not any(k.startswith(b + ".") for k in scales for b in blocks)
    with torch.no_grad():
        out = tq.quantize_model(task.model, [x])(x)
    assert out["heatmap"].shape[0] == 1


TINY = {"num_classes": 3, "backbone": "resnet18", "backbone_config": {"width": 16},
        "neck": "FPN", "neck_config": {"out_channels": 16},
        "head_config": {"width": 16, "depth": 1}, "num_detections": 7,
        "image_size": [32, 32]}


def test_predictor_quantize_api():
    """predictor.quantize(): the same serving API on uint8, decode shapes
    intact, scores within the JAX test's 3e-2 of float, the two-step
    `__call__` contract in int8, and `__call__(train=True)` the float
    model's."""
    rng = np.random.default_rng(0)
    pred = build_centernet({"model": TINY}, device="cpu")
    imgs = rng.integers(0, 255, size=(2, 32, 32, 3), dtype=np.uint8)
    qpred = pred.quantize(imgs)
    assert isinstance(qpred, QuantizedCenterNetPredictor)
    assert qpred.act_scales and qpred.model is not pred.model
    assert not any(isinstance(m, tq.Int8Conv2d) for m in pred.model.modules())

    out = qpred.gather_detection2d(imgs)
    assert out["bboxes"].shape == (2, 7, 4)
    assert out["scores"].shape == (2, 7)
    ref = pred.gather_detection2d(imgs)
    np.testing.assert_allclose(out["scores"], ref["scores"], atol=3e-2)

    encoded = qpred(pred.prepare_images(imgs))
    two_step = qpred.gather_detection2d(dict(encoded))
    assert two_step["bboxes"].shape == (2, 7, 4)
    np.testing.assert_array_equal(two_step["scores"], out["scores"])

    x = pred.prepare_images(imgs)
    got, stats = qpred(x, train=True)
    want, _ = pred(x, train=True)
    assert "batch_stats" in stats
    for k in ("heatmap", "box_2d"):
        assert torch.equal(got[k], want[k])


def test_predictor_quantize_calibration_matches_jax():
    """The predictor's calibration preprocesses uint8 batches as serving
    does: on the same weights its scales are JAX's predictor's."""
    rng = np.random.default_rng(8)
    cfg = {k: v for k, v in TINY.items() if k != "image_size"}
    jtask = JCenterNet(**cfg)
    variables = random_flax_variables(jtask, rng)
    imgs = [rng.integers(0, 255, (2, 32, 32, 3), dtype=np.uint8) for _ in range(2)]
    jpred = JPredictor(jtask, variables, image_size=(32, 32))
    jq_pred = jpred.quantize(imgs)
    j_scales = jq.collect_conv_scales(
        jtask.model, variables, [jpred._prep_calibration(b) for b in imgs])
    assert set(j_scales) == set(jq_pred.variables["_quant"])
    pred = build_centernet({"model": TINY}, device="cpu")
    pred.model.load_state_dict(variables_to_state_dict(variables), strict=True)
    qpred = pred.quantize(imgs)
    mapped = port_scales_of(j_scales, variables)
    assert set(qpred.act_scales) == set(mapped)
    for name, v in mapped.items():
        assert abs(qpred.act_scales[name] - v) <= 1e-5 * v, name
    j_dets = jq_pred.gather_detection2d(imgs[0])
    t_dets = qpred.gather_detection2d(imgs[0])
    np.testing.assert_allclose(t_dets["scores"], j_dets["scores"], atol=1e-2)


def test_int8_gather_tracking2d_fairmot():
    """int8 tracking: a FairMOT model's ReID head convolutions are int8;
    its heads stay within 0.05 of the float predictor's, and
    `gather_tracking2d` decodes the int8 heads (embeddings included)."""
    from centernet_lightning_torch.ops.decode import decode_detections

    rng = np.random.default_rng(9)
    cfg = dict(TINY, num_classes=1, num_detections=6,
               reid_config={"emb_dim": 16, "max_track_ids": 8, "width": 16,
                            "depth": 1})
    pred = build_centernet({"model": cfg}, device="cpu")
    frames = rng.integers(0, 255, (2, 32, 32, 3), dtype=np.uint8)
    qpred = pred.quantize(frames)
    reid = [n for n, m in qpred.model.named_modules()
            if n.startswith("heads.reid") and isinstance(m, tq.Int8Conv2d)]
    assert "heads.reid.out_conv" in reid and len(reid) == 2
    got = qpred.gather_tracking2d(frames)
    assert got["embeddings"].shape == (2, 6, 16)
    assert got["bboxes"].shape == (2, 6, 4)
    with torch.no_grad():
        x = pred.prepare_images(frames)
        q_out, f_out = qpred.model(x), pred.model(x)
        want = decode_detections(q_out["heatmap"], q_out["box_2d"],
                                 reid=q_out["reid"], num_detections=6,
                                 normalize_boxes=True, stride=qpred.task.stride,
                                 from_logits=True)
    for k in ("heatmap", "box_2d", "reid"):
        err = (q_out[k] - f_out[k]).abs().max() / f_out[k].abs().max()
        assert float(err) < 0.05, k
    np.testing.assert_array_equal(got["scores"], want["scores"].numpy())
    np.testing.assert_array_equal(got["embeddings"], want["embeddings"].numpy())
