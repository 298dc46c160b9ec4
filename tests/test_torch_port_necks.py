"""PyTorch port vs the JAX package: the blocks and necks of the remaining
layers.py / necks.py (SeparableConvNormAct, the conv_transpose Upsample,
Downsample, Fuse, SPP, SimpleNeck, the weighted FPN, BiFPN and IDA), on
the CPU with identical seeded inputs and converted weights, BatchNorm
statistics perturbed and fusion weights drawn (some negative, so the
ReLU on them matters).

Tolerances rtol 1e-4 / atol 1e-4 (f32 convolutions summed in another
order than XLA's), as the other module tests. The DCN SimpleNeck runs the
sampling kernel's plain twin on the CPU, with offsets drawn well past +-1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models import layers as j_layers
from centernet_lightning_tpu.models import necks as j_necks

from centernet_lightning_torch.models import layers as t_layers
from centernet_lightning_torch.models import necks as t_necks

from _torch_port_helpers import (
    nchw, nhwc, perturb_batch_norm, perturb_dcn, scoped_state_dict,
    to_numpy_tree,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb_fuse(variables, rng):
    def draw(path, x):
        if getattr(path[-1], "key", "") == "fuse_weights":
            return rng.uniform(-0.5, 2.0, np.shape(x)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(draw, variables)


def _init(module, args, rng, **kwargs):
    v = to_numpy_tree(module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return perturb_dcn(_perturb_fuse(perturb_batch_norm(v, rng), rng), rng)


def _run(t, args):
    t.eval()
    with torch.no_grad():
        return t(*args)


def test_separable_conv_norm_act_parity():
    rng = np.random.default_rng(20)
    x = rng.normal(size=(2, 9, 10, 6)).astype(np.float32)
    for stride in (1, 2):
        j = j_layers.SeparableConvNormAct(8, strides=stride)
        v = _init(j, (jnp.asarray(x),), rng)
        t = t_layers.SeparableConvNormAct(6, 8, stride=stride)
        t.load_state_dict(scoped_state_dict(v, "SeparableConvNormAct_0",
                                            "blocks.0."), strict=True)
        assert t.blocks[0].conv.weight.shape == (6, 1, 3, 3)   # depthwise
        ref = np.asarray(j.apply(v, jnp.asarray(x)))
        got = nhwc(_run(t, (nchw(x),)))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("kernel", [3, 4])
def test_upsample_conv_transpose_parity(kernel):
    """Random (he_normal, non-symmetric) kernels: the bilinear one is
    symmetric and would hide a missing flip. At k = 3 lax's SAME padding
    is asymmetric (low 2, high 1)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    j = j_layers.Upsample(6, method="conv_transpose", kernel_size=kernel,
                          init_bilinear=False)
    v = _init(j, (jnp.asarray(x),), rng)
    kern = v["params"]["ConvTranspose_0"]["kernel"]
    assert not np.allclose(kern, kern[::-1, ::-1])
    t = t_layers.Upsample("conv_transpose", 6, kernel_size=kernel)
    t.load_state_dict(scoped_state_dict(v, "Upsample_0", "upsamples.0."),
                      strict=True)
    ref = np.asarray(j.apply(v, jnp.asarray(x)))
    got = nhwc(_run(t, (nchw(x),)))
    assert got.shape == ref.shape == (2, 10, 14, 6)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("method", ["max", "avg", "conv"])
@pytest.mark.parametrize("size", [(8, 10), (7, 9)], ids=["even", "odd"])
def test_downsample_parity(method, size):
    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, *size, 4)).astype(np.float32)
    j = j_layers.Downsample(6 if method == "conv" else None, method=method)
    v = _init(j, (jnp.asarray(x),), rng)
    t = t_layers.Downsample(method, channels=6 if method == "conv" else None,
                            in_channels=4)
    if method == "conv":
        inner = {col: tree["ConvNormAct_0"] for col, tree in v.items()}
        t.conv.load_state_dict(scoped_state_dict(inner, "ConvNormAct_0",
                                                 "blocks.0."), strict=True)
    ref = np.asarray(j.apply(v, jnp.asarray(x)))
    got = nhwc(_run(t, (nchw(x),)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


FUSE_SIZES = {"2x": [(10, 12), (5, 6), (19, 23)],
              "non_2x": [(7, 9), (3, 4), (14, 17)]}


@pytest.mark.parametrize("upsample", ["nearest", "bilinear"])
@pytest.mark.parametrize("ratio", sorted(FUSE_SIZES))
@pytest.mark.parametrize("weighted", [False, True], ids=["sum", "weighted"])
def test_fuse_parity(weighted, ratio, upsample):
    """Three inputs: the target, a smaller map (nearest 2x broadcast, or
    jax.image.resize at other ratios) and a larger one (one 2 x 2 max);
    widths 6 (no projection), 4 and 8."""
    rng = np.random.default_rng(23)
    widths = (6, 4, 8)
    xs = [rng.normal(size=(2, h, w, c)).astype(np.float32)
          for (h, w), c in zip(FUSE_SIZES[ratio], widths)]
    j = j_layers.Fuse(6, weighted=weighted, upsample=upsample)
    v = _init(j, ([jnp.asarray(x) for x in xs],), rng)
    t = t_layers.Fuse(widths, 6, weighted=weighted, upsample=upsample)
    t.load_state_dict(scoped_state_dict(v, "Fuse_0", "fuses.0."), strict=True)
    assert len(t.blocks) == 3                # two projections + the output
    ref = np.asarray(j.apply(v, [jnp.asarray(x) for x in xs]))
    got = nhwc(_run(t, ([nchw(x) for x in xs],)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_spp_parity():
    rng = np.random.default_rng(24)
    x = rng.normal(size=(2, 7, 6, 8)).astype(np.float32)
    j = j_layers.SPP(12, pool_sizes=(3, 5, 9))
    v = _init(j, (jnp.asarray(x),), rng)
    t = t_layers.SPP(8, 12, pool_sizes=(3, 5, 9))
    t.load_state_dict(scoped_state_dict(v, "extra_block", "extra_block."),
                      strict=True)
    ref = np.asarray(j.apply(v, jnp.asarray(x)))
    got = nhwc(_run(t, (nchw(x),)))
    np.testing.assert_allclose(got, ref, **TOL)


def _pyramid(rng, widths=(8, 12, 16, 20), sizes=(32, 16, 8, 4)):
    return [rng.normal(size=(2, s, s, c)).astype(np.float32)
            for s, c in zip(sizes, widths)]


def _neck_parity(name, config, feats, rng, pyramid=False):
    in_ch = [f.shape[-1] for f in feats]
    j = j_necks.build_neck(name, in_ch, **config)
    t = t_necks.build_neck(name, in_ch, **config)
    jf = [jnp.asarray(f) for f in feats]
    v = _init(j, (jf,), rng)
    t.load_state_dict(scoped_state_dict(v, "neck", "neck."), strict=True)
    kw = {"return_pyramid": True} if pyramid else {}
    refs = j.apply(v, jf, **kw)
    t.eval()
    with torch.no_grad():
        gots = t([nchw(f) for f in feats], **kw)
    if not pyramid:
        refs, gots = [refs], [gots]
    assert len(gots) == len(refs)
    for ref, got in zip(refs, gots):
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)
    assert t.stride == j.stride
    assert gots[0].shape[1] == t.out_channels
    return t


SIMPLE = {
    "nearest": {},
    "conv_transpose_skip": {"upsample_type": "conv_transpose", "skip_kernel": 3,
                            "deconv_init_bilinear": False},
    "conv_transpose_k3": {"upsample_type": "conv_transpose", "deconv_kernel": 3,
                          "deconv_init_bilinear": False},
    "separable": {"conv_type": "separable", "skip_kernel": 1},
    "dcn_fast_d1_skip": {"conv_type": "dcn_fast_d1", "skip_kernel": 1},
}


@pytest.mark.parametrize("name", sorted(SIMPLE))
def test_simple_neck_parity(name):
    rng = np.random.default_rng(25)
    feats = _pyramid(rng)
    t = _neck_parity("SimpleNeck", dict(upsample_channels=(16, 12, 8),
                                        **SIMPLE[name]), feats, rng)
    if SIMPLE[name].get("skip_kernel") and "conv_type" in SIMPLE[name]:
        # DCN / separable steps interleaved with plain skips: plain first
        plain = [type(b) is t_layers.ConvNormAct for b in t.blocks]
        assert plain == [True] * 3 + [False] * 3


# widths and sizes of a 76 x 76 image's pyramid: 19 -> 10 is no 2x ratio
ODD_PYRAMID = dict(widths=(8, 12, 16, 20), sizes=(19, 10, 5, 3))


@pytest.mark.parametrize("name,config", [
    ("FPN", {"weighted": True, "out_channels": 12}),
    ("FPN", {"weighted": True, "upsample_channels": [16, 12, 8],
             "upsample_type": "bilinear"}),
    ("FPN", {"upsample_type": "conv_transpose", "out_channels": 12}),
    ("BiFPN", {"out_channels": 12}),
    ("BiFPN", {"out_channels": 12, "num_repeats": 1, "weighted": False,
               "conv_type": "separable"}),
], ids=["fpn_weighted", "fpn_weighted_progressive", "fpn_conv_transpose",
        "bifpn", "bifpn_separable"])
def test_pyramid_neck_parity(name, config):
    """FPN / BiFPN with return_pyramid (finest first) on maps whose sizes
    are not 2x apart; the conv_transpose FPN on the 2x pyramid (its
    transpose conv doubles exactly)."""
    rng = np.random.default_rng(26)
    sizes = (ODD_PYRAMID if config.get("upsample_type") != "conv_transpose"
             else dict(widths=ODD_PYRAMID["widths"]))
    feats = _pyramid(rng, **sizes)
    t = _neck_parity(name, config, feats, rng, pyramid=True)
    if name == "FPN":
        _neck_parity(name, config, feats, rng)       # the finest level alone
        assert len(t.fuses) == (3 if config.get("weighted") else 0)


@pytest.mark.parametrize("config", [{}, {"weighted": True,
                                         "upsample_type": "bilinear"}],
                         ids=["sum", "weighted_bilinear"])
def test_ida_parity(config):
    rng = np.random.default_rng(27)
    _neck_parity("IDA", dict(out_channels=12, **config),
                 _pyramid(rng, **ODD_PYRAMID), rng)


def test_build_neck_widths():
    """build_neck's defaulting, as the JAX package's: SimpleNeck keeps its
    own width, BiFPN / IDA take upsample_channels[-1] as one width."""
    in_ch = (8, 12, 16, 20)
    assert t_necks.build_neck("simple", in_ch).out_channels == 64
    for name in ("BiFPN", "IDA"):
        t = t_necks.build_neck(name, in_ch, upsample_channels=[32, 24])
        j = j_necks.build_neck(name, in_ch, upsample_channels=[32, 24])
        assert t.out_channels == j.out_channels == 24
    t = t_necks.build_neck("FPN", in_ch, upsample_channels=[32, 24])
    assert t.out_channels == 24 and t.stride == 8
