"""PyTorch port vs the JAX package: preprocess and every model module of
the serving slice, on the CPU with identical inputs and weights.

Tolerances: preprocess atol 1e-5 (f32 elementwise, resize weights summed
in another order); modules rtol 1e-4, atol 1e-4 (f32 convolutions summed
in another order than XLA's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from centernet_lightning_tpu.models import heads as j_heads
from centernet_lightning_tpu.models import layers as j_layers
from centernet_lightning_tpu.models import necks as j_necks
from centernet_lightning_tpu.models.backbones import resnet as j_resnet
from centernet_lightning_tpu.ops.preprocess import preprocess as j_preprocess

from centernet_lightning_torch.models import heads as t_heads
from centernet_lightning_torch.models import layers as t_layers
from centernet_lightning_torch.models import necks as t_necks
from centernet_lightning_torch.models.backbones import resnet as t_resnet
from centernet_lightning_torch.ops.preprocess import preprocess as t_preprocess

from _torch_port_helpers import (
    nchw, nhwc, perturb_batch_norm, scoped_state_dict, to_numpy_tree,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def _init_flax(module, x, rng, **kwargs):
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(x), **kwargs)
    return perturb_batch_norm(to_numpy_tree(variables), rng)


@pytest.mark.parametrize("size", [None, (48, 40), (24, 20)],
                         ids=["no_resize", "upscale", "downscale"])
def test_preprocess_parity(size):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(2, 32, 30, 3), dtype=np.uint8)
    ref = np.asarray(j_preprocess(jnp.asarray(images), size=size))
    got = t_preprocess(torch.from_numpy(images), size=size).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


# flax SAME at stride 2 pads (0, 1) on an even size and (1, 1) on an odd
# one at k = 3; an even kernel pads asymmetrically at stride 1 too
CNA_CASES = [(3, "relu", 1, (9, 11)), (1, None, 1, (9, 11)),
             (3, "relu", 2, (8, 8)), (3, "relu", 2, (9, 11)),
             (3, None, 2, (10, 7)), (5, "relu", 2, (12, 9)),
             (1, None, 2, (8, 9)), (4, "relu", 1, (7, 8))]


@pytest.mark.parametrize(
    "kernel,act,stride,size", CNA_CASES,
    ids=[f"{k}-{a}" + (f"-s{s}-{h}x{w}" if s > 1 or k % 2 == 0 else "")
         for k, a, s, (h, w) in CNA_CASES])
def test_conv_norm_act_parity(kernel, act, stride, size):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *size, 6)).astype(np.float32)
    flax_act = jax.nn.relu if act else None
    j = j_layers.ConvNormAct(8, kernel, strides=stride, act=flax_act)
    v = _init_flax(j, x, rng)
    t = t_layers.ConvNormAct(6, 8, kernel, stride=stride,
                             act=F.relu if act else None).eval()
    t.load_state_dict(scoped_state_dict(v, "ConvNormAct_0", "blocks.0."),
                      strict=True)
    ref = np.asarray(j.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(t(nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
def test_upsample_parity(method):
    x = np.random.default_rng(2).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(j_layers.Upsample(3, method=method).apply(
        {}, jnp.asarray(x)))
    got = nhwc(t_layers.Upsample(method)(nchw(x)))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_residual_block_with_downsample_parity(block):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 12, 10, 8)).astype(np.float32)
    if block == "basic":
        j = j_resnet.BasicBlock(16, strides=2)
        t = t_resnet.BasicBlock(8, 16, stride=2)
    else:
        j = j_resnet.Bottleneck(4, strides=2)
        t = t_resnet.Bottleneck(8, 4, stride=2)
    v = _init_flax(j, x, rng)
    t.load_state_dict(scoped_state_dict(v, "layer1_block0", "layer1.0."),
                      strict=True)
    t.eval()
    assert t.downsample is not None
    ref = np.asarray(j.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(t(nchw(x)))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_pyramid_parity(arch):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    j = getattr(j_resnet, arch)(width=8)
    t = getattr(t_resnet, arch)(width=8)
    v = _init_flax(j, x, rng)
    t.load_state_dict(scoped_state_dict(v, "backbone", "backbone."),
                      strict=True)
    t.eval()
    refs = j.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        gots = t(nchw(x))
    assert t.out_channels == j.out_channels
    assert len(gots) == len(refs) == 4
    for ref, got in zip(refs, gots):
        np.testing.assert_allclose(nhwc(got), np.asarray(ref), **TOL)


def _pyramid(rng, widths=(8, 16, 32, 64), size=32):
    return [rng.normal(size=(2, size >> i, size >> i, c)).astype(np.float32)
            for i, c in enumerate(widths)]


@pytest.mark.parametrize("config", [
    {"fuse_fn": "sum"},
    {"fuse_fn": "concat"},
    {"upsample_channels": [32, 16, 8]},
    {"upsample_type": "bilinear"},
], ids=["sum", "concat", "upsample_channels", "bilinear"])
def test_fpn_parity(config):
    rng = np.random.default_rng(5)
    feats = _pyramid(rng)
    in_ch = [f.shape[-1] for f in feats]
    j = j_necks.build_neck("FPN", in_ch, out_channels=16, **config)
    t = t_necks.build_neck("FPN", in_ch, out_channels=16, **config)
    v = to_numpy_tree(j.init(jax.random.PRNGKey(0),
                             [jnp.asarray(f) for f in feats]))
    v = perturb_batch_norm(v, rng)
    t.load_state_dict(scoped_state_dict(v, "neck", "neck."), strict=True)
    t.eval()
    ref = np.asarray(j.apply(v, [jnp.asarray(f) for f in feats], train=False))
    with torch.no_grad():
        got = nhwc(t([nchw(f) for f in feats]))
    assert t.stride == j.stride
    assert got.shape[-1] == t.out_channels
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("init_bias", [None, -2.19])
def test_generic_head_parity(init_bias):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 8, 12)).astype(np.float32)
    j = j_heads.GenericHead(out_channels=5, width=16, depth=2,
                            init_bias=init_bias)
    t = t_heads.GenericHead(12, 5, width=16, depth=2, init_bias=init_bias)
    v = _init_flax(j, x, rng)
    t.load_state_dict(scoped_state_dict(v, "heads_heatmap", "heads.heatmap."),
                      strict=True)
    t.eval()
    ref = np.asarray(j.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(t(nchw(x)))
    np.testing.assert_allclose(got, ref, **TOL)
