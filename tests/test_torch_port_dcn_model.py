"""PyTorch port vs the JAX package: the DCN slice at the model level, on
the CPU with identical inputs and weights: the FPN and GenericHead with DCN
blocks, the weight converter, the whole ResNet-18 FPN DCNv2 serving slice
and the offset audit (the kernels' twins and the block are in
test_torch_port_dcn.py).

Tolerances rtol 1e-4 / atol 1e-4 (f32 convolutions and products summed in
another order than XLA's); detection scores near the 0.01 prior use
atol 1e-6. Maps stay at most 8 x 8 with C <= 8, so interpret-mode Pallas
stays fast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu import build_centernet as j_build
from centernet_lightning_tpu.models import heads as j_heads
from centernet_lightning_tpu.models import necks as j_necks
from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
from centernet_lightning_tpu.utils import dcn_audit as j_audit
from centernet_lightning_tpu.utils.torch_convert import (
    convert_centernet_checkpoint,
)

from centernet_lightning_torch import build_centernet as t_build
from centernet_lightning_torch.models import heads as t_heads
from centernet_lightning_torch.models import layers as t_layers
from centernet_lightning_torch.models import necks as t_necks
from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet
from centernet_lightning_torch.utils import dcn_audit as t_audit
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import (
    assert_detections_match, init_flax_dcn, nchw, nhwc, perturb_batch_norm,
    perturb_dcn, scoped_state_dict, to_numpy_tree,
)

TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# FPN and GenericHead with DCN blocks
# ---------------------------------------------------------------------------

def _pyramid(rng, widths=(8, 16, 32, 64), size=8):
    return [rng.normal(size=(2, size >> i or 1, size >> i or 1, c)).astype(np.float32)
            for i, c in enumerate(widths)]


@pytest.mark.parametrize("config", [
    {"conv_type": "dcn_fast_d1"},
    {"conv_type": "dcn_fused_d1", "upsample_channels": [16, 8, 8]},
    {"conv_type": "dcn", "fuse_fn": "concat"},
], ids=["fast_d1", "fused_d1_upsample_channels", "exact_concat"])
def test_fpn_with_dcn_matches_jax(config):
    rng = np.random.default_rng(60)
    feats = _pyramid(rng)
    in_ch = [f.shape[-1] for f in feats]
    j = j_necks.build_neck("FPN", in_ch, out_channels=8, **config)
    t = t_necks.build_neck("FPN", in_ch, out_channels=8, **config)
    v = init_flax_dcn(j, [jnp.asarray(f) for f in feats], rng)
    t.load_state_dict(scoped_state_dict(v, "neck", "neck."), strict=True)
    t.eval()
    n_dcn = sum(isinstance(b, t_layers.DeformableConvBlock) for b in t.blocks)
    assert n_dcn == sum(k.startswith("DeformableConvBlock")
                        for k in v["params"])
    ref = np.asarray(j.apply(v, [jnp.asarray(f) for f in feats], train=False))
    with torch.no_grad():
        got = nhwc(t([nchw(f) for f in feats]))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("block", ["dcn_fast_d1", "dcn_fused_d2"])
def test_generic_head_with_dcn_matches_jax(block):
    rng = np.random.default_rng(61)
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    j = j_heads.GenericHead(out_channels=5, width=8, depth=2, block=block,
                            init_bias=-2.19)
    t = t_heads.GenericHead(6, 5, width=8, depth=2, block=block,
                            init_bias=-2.19)
    v = init_flax_dcn(j, jnp.asarray(x), rng)
    t.load_state_dict(scoped_state_dict(v, "heads_heatmap", "heads.heatmap."),
                      strict=True)
    t.eval()
    ref = np.asarray(j.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(t(nchw(x)))
    np.testing.assert_allclose(got, ref, **TOL)


# ---------------------------------------------------------------------------
# weights, the whole slice, the audit
# ---------------------------------------------------------------------------

TINY_DCN = {
    "num_classes": 3,
    "backbone": "resnet18",
    "backbone_config": {"width": 8},
    "neck": "FPN",
    "neck_config": {"out_channels": 8, "conv_type": "dcn_fast_d1"},
    "head_config": {"width": 8, "depth": 2},
    "num_detections": 20,
    "image_size": [32, 32],
}


@pytest.mark.parametrize("head_block", ["normal", "dcn_fused_d1"])
def test_converter_strict_load_and_round_trip(head_block):
    kw = dict(TINY_DCN, head_config={"width": 8, "depth": 2,
                                     "block": head_block})
    kw.pop("num_detections")
    variables = perturb_dcn(
        to_numpy_tree(JCenterNet(**kw).init(jax.random.PRNGKey(0))),
        np.random.default_rng(70))
    sd = variables_to_state_dict(variables)
    ttask = TCenterNet(**kw)
    result = ttask.model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # flax counts DCN blocks on their own: the FPN's first one follows the
    # four 1x1 ConvNormAct blocks
    assert sd["neck.blocks.4.deform.weight"].shape == (8, 8, 3, 3)
    assert sd["neck.blocks.0.conv.weight"].shape[-2:] == (1, 1)
    # a converter that put DeformableConvBlock_0 at blocks.0 is refused
    naive = {k.replace("neck.blocks.4.", "neck.blocks.0."): v
             for k, v in sd.items() if not k.startswith("neck.blocks.0.")}
    with pytest.raises(RuntimeError):
        TCenterNet(**kw).model.load_state_dict(naive, strict=True)
    # back through the JAX package's torch->flax converter
    back = convert_centernet_checkpoint(ttask.model.state_dict(), variables,
                                        backbone_arch="resnet18")
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(to_numpy_tree(back)))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def _dcn_pair(conv_type):
    cfg = dict(TINY_DCN, neck_config={"out_channels": 8,
                                      "conv_type": conv_type})
    jp = j_build({"model": cfg})
    rng = np.random.default_rng(71)
    variables = perturb_dcn(
        perturb_batch_norm(to_numpy_tree(jp.variables), rng), rng)
    # moderate heatmap logits, so sigmoid scores stay apart
    out_conv = variables["params"]["heads_heatmap"]["out_conv"]
    out_conv["kernel"] = out_conv["kernel"] * 0.05
    jp.variables = variables
    tp = t_build({"model": cfg}, device="cpu")
    tp.model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return jp, tp


@pytest.mark.parametrize("conv_type", ["dcn_fast_d1", "dcn_fused_d1", "dcn"])
def test_whole_dcn_slice_matches_jax(conv_type):
    jp, tp = _dcn_pair(conv_type)
    images = np.random.default_rng(72).integers(0, 256, (2, 32, 32, 3),
                                                dtype=np.uint8)
    ref_enc = jp(jnp.asarray(images.astype(np.float32) / 255.0))
    got_enc = tp(images.astype(np.float32) / 255.0)
    for key in ("heatmap", "box_2d"):
        np.testing.assert_allclose(got_enc[key].numpy(),
                                   np.asarray(ref_enc[key]), **TOL)
    ref = jp.gather_detection2d(jnp.asarray(images))
    got = tp.gather_detection2d(images)
    assert got["bboxes"].shape == (2, 20, 4)
    # scores sit near the 0.01 prior: atol 1e-6 keeps the comparison
    # relative (1e-4) and their gaps apart from the tolerance
    assert_detections_match(ref, got, min_distinct=10, rtol=1e-4, atol=1e-6)


def test_dcn_audit_matches_jax():
    jp, tp = _dcn_pair("dcn_fast_d1")
    images = np.random.default_rng(73).normal(
        size=(2, 32, 32, 3)).astype(np.float32)
    ref = j_audit.audit_dcn_offsets(jp.task, jp.variables, images)
    got = t_audit.audit_dcn_offsets(tp.task, images)
    assert got["n_layers"] == ref["n_layers"] == 3
    assert got["n_values"] == ref["n_values"]
    assert got["recommended_d"] == ref["recommended_d"]
    np.testing.assert_allclose(got["max_offset"], ref["max_offset"], rtol=1e-4)
    assert ref["exceed_frac"][1] > 0          # offsets past +-1 exist
    for d, frac in ref["exceed_frac"].items():
        assert abs(got["exceed_frac"][d] - frac) <= 2 / ref["n_values"]
    for engine_d in (None, 1, 4):
        assert (t_audit.format_dcn_audit(ref, engine_d)
                == j_audit.format_dcn_audit(ref, engine_d))
    assert t_audit.model_uses_dcn(tp.task) and j_audit.model_uses_dcn(jp.task)
    assert (t_audit.dcn_engine_displacement(tp.task)
            == j_audit.dcn_engine_displacement(jp.task) == 1)
    plain = TCenterNet(**dict(TINY_DCN, neck_config={"out_channels": 8}))
    assert not t_audit.model_uses_dcn(plain)
    assert t_audit.audit_dcn_offsets(plain, images)["n_values"] == 0
