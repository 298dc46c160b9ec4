"""The float32 reference (benchmark/reference/) on the CPU: the shipped
configurations' tensor lists and FLOPs pinned, the exact and the bounded
DCNv2 blocks against the program's, necks found by name, and every key the
reference does not model refused."""
import hashlib
import json
import re
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from cnbench import manifest
from reference import model as model_ref
from reference.nn import Ctx, conv_bn_act, conv_block, dcn_block
from roofline.flops import forward_flops_per_image

# (digest of the ordered [name, shape, kind] list, tensors, forward FLOPs an
# image) at 512 x 512: weights.make draws in this order, and the FLOPs are
# the MFU metrics' denominators
PINNED = {
    "csp53-fpn256-coco": (
        "306c23f1373686d189ef328bb52e3b5d2b25fbabe683e249b82c9d6619bbc31f", 514, 196310204416),
    "r18-fpn128-dcnv2-voc": (
        "1a1e6bdc0da30f5c811fdc0d94e198cca86995ad383b095bb4b56ceae2352964", 202, 46560706560),
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_param_spec_and_flops_pinned(name):
    cfg = manifest.config(name)
    spec = model_ref.param_spec(cfg, (512, 512))
    rows = [[k, list(shape), kind] for k, (shape, kind) in spec.items()]
    digest = hashlib.sha256(json.dumps(rows).encode()).hexdigest()
    assert (digest, len(rows), forward_flops_per_image(cfg, (512, 512))) == PINNED[name]


def _block_params(spec, gen, offset_scale):
    """Random tensors for a block's spec; the offset convolution's scaled
    by `offset_scale`, BatchNorm's statistics away from 0 and 1."""
    params = {}
    for k, (shape, kind) in spec.items():
        if kind == "bn_count":
            params[k] = torch.zeros(shape, dtype=torch.long)
        elif kind == "bn_var":
            params[k] = torch.rand(shape, generator=gen) + 0.5
        else:
            scale = offset_scale if kind.startswith("dcn_offset") else 0.3
            params[k] = torch.randn(shape, generator=gen) * scale
    return params


def _spec(fn, x):
    spec = {}
    fn(Ctx(spec=spec), torch.zeros(x.shape, device="meta"))
    return spec


def _offsets(params, x, name="blk"):
    return F.conv2d(x, params[f"{name}.conv_offset.weight"],
                    params[f"{name}.conv_offset.bias"], padding=1)


def _port(module, params, prefix):
    state = {k[len(prefix):]: v for k, v in params.items()}
    module.load_state_dict(state, strict=True)
    return module.eval()


def test_exact_dcn_block_matches_the_programs_exact_engine():
    from centernet_lightning_torch.models.layers import get_conv_block

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 9, 11, generator=gen)

    def block(ctx, t):
        return dcn_block(ctx, "blk", t, 6, None)

    params = _block_params(_spec(block, x), gen, offset_scale=0.5)
    off = _offsets(params, x)
    assert off.abs().max() > 6 and (off.abs() > 2).float().mean() > 0.4
    ref = block(Ctx(params), x)
    with torch.no_grad():
        prog = _port(get_conv_block("dcn")(8, 6, 3), params, "blk.")(x)
    assert ref.shape == prog.shape
    assert (ref - prog).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("d", [1, 2, 4])
def test_clamped_block_bit_equal_to_exact_within_its_bound(d):
    gen = torch.Generator().manual_seed(10 + d)
    x = torch.randn(2, 8, 9, 11, generator=gen)
    spec = _spec(lambda ctx, t: dcn_block(ctx, "blk", t, 6, d), x)
    params = _block_params(spec, gen, offset_scale=0.025 * d)
    assert _offsets(params, x).abs().max() <= d
    exact = dcn_block(Ctx(params), "blk", x, 6, None)
    assert torch.equal(dcn_block(Ctx(params), "blk", x, 6, d), exact)


@pytest.mark.parametrize("block", ["normal", "dcn", "dcn_fast", "dcn_fast_d1",
                                   "dcn_fused_d1"])
def test_head_follows_the_programs_head_block(block):
    from centernet_lightning_torch.models.heads import GenericHead

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 10, 12, generator=gen)
    cfg = {"width": 6, "depth": 2, "block": block}

    def run(ctx, t):
        return model_ref.head(ctx, "heads.box_2d", t, 4, cfg)

    params = _block_params(_spec(run, x), gen, offset_scale=1.0)
    if block != "normal":
        assert (_offsets(params, x, "heads.box_2d.blocks.0").abs() > 2).any()
    ref = run(Ctx(params), x)
    with torch.no_grad():
        prog = _port(GenericHead(8, 4, **cfg), params, "heads.box_2d.")(x)
    prog = prog.permute(0, 2, 3, 1)
    assert ref.shape == prog.shape
    assert (ref - prog).abs().max() <= 1e-5 * ref.abs().max()


def _toy_neck(calls):
    """A neck module as a file under reference/necks/ would hold it: a 1x1
    lateral on the stride-4 map, the stride-8 map upsampled into it, and a
    3x3 block of the configuration's conv_type."""
    def forward(ctx, feats, cfg, prefix="neck"):
        calls.append(prefix)
        width = cfg["out_channels"]
        x = conv_bn_act(ctx, f"{prefix}.lateral", feats[0], width, 1, act=None)
        up = conv_bn_act(ctx, f"{prefix}.top", feats[1], width, 1, act=None)
        x = x + F.interpolate(up, scale_factor=2, mode="nearest")
        return conv_block(ctx, f"{prefix}.merge", x, width, cfg["conv_type"])

    return types.SimpleNamespace(forward=forward)


def _r18(**changes):
    cfg = dict(manifest.config("r18-fpn128-dcnv2-voc"), head_config={"width": 8, "depth": 1})
    cfg.update(changes)
    return cfg


def test_a_neck_module_is_found_by_name(monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "reference.necks.toyneck", _toy_neck(calls))
    cfg = _r18(neck="ToyNeck", neck_config={"out_channels": 16, "conv_type": "dcn"})
    spec = model_ref.param_spec(cfg, (64, 64))
    assert spec["neck.lateral.conv.weight"] == ((16, 64, 1, 1), "conv")
    assert spec["neck.merge.conv_offset.weight"] == ((18, 16, 3, 3), "dcn_offset")
    assert not [k for k in spec if k.startswith("neck.blocks.")]
    toy = forward_flops_per_image(cfg, (64, 64))
    assert 0 < toy != forward_flops_per_image(_r18(), (64, 64))

    from cnbench import weights

    params = weights.make(spec, cfg, 11, "cpu")
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(2))
    out = model_ref.forward(Ctx(params), cfg, x)
    assert out["heatmap"].shape == (2, 16, 16, 20) and out["box_2d"].shape == (2, 16, 16, 4)
    assert calls and set(calls) == {"neck"}


def test_a_missing_neck_names_its_file():
    cfg = _r18(neck="NoSuchNeck")
    with pytest.raises(ValueError, match=re.escape("benchmark/reference/necks/nosuchneck.py")):
        model_ref.param_spec(cfg, (64, 64))


FPN = {"out_channels": 128, "fuse_fn": "sum", "conv_type": "dcn_fast"}


@pytest.mark.parametrize("changes, named", [
    ({"neck_config": dict(FPN, upsample_channels=[64, 32])}, "upsample_channels"),
    ({"neck_config": dict(FPN, eps=1e-4)}, "eps"),
    ({"neck_config": dict(FPN, fuse_fn="concat")}, "concat"),
    ({"neck_config": dict(FPN, weighted=True)}, "weighted"),
    ({"neck_config": dict(FPN, upsample_type="bilinear")}, "bilinear"),
    ({"neck_config": dict(FPN, conv_type="separable")}, "separable"),
    ({"head_config": {"width": 8, "depth": 1, "init_bias": 0.0}}, "init_bias"),
    ({"head_config": {"width": 8, "depth": 1, "block": "separable"}}, "separable"),
    ({"extra_block": {"name": "SPP"}}, "extra_block"),
    ({"backbone_config": {"stem_space_to_depth": True}}, "backbone_config"),
    ({"reid_config": {"emb_dim": 64}}, "reid_config"),
], ids=["upsample_channels", "neck_eps", "concat", "weighted", "bilinear",
        "neck_separable", "head_init_bias", "head_separable", "extra_block",
        "backbone_config", "reid_config"])
def test_every_unmodelled_key_is_refused(changes, named):
    with pytest.raises(ValueError, match=named):
        model_ref.param_spec(_r18(**changes), (64, 64))
