"""PyTorch port vs the JAX package: the deformable-convolution (DCN)
kernels' twins and `DeformableConvBlock`, on the CPU with identical inputs
and weights (the model-level DCN tests are in test_torch_port_dcn_model.py).

Covers the twins of the two CUDA kernels against the JAX engines they port
(`xla_tap_sample`/`_xla_all`, and the Pallas `dcn_sample_all_taps` and
`dcn_fused_conv` in interpret mode), and `DeformableConvBlock` for every
DCN conv type against the JAX block, plus the port's own clamp and
within-bound contracts.

Tolerances: the sampler twin rtol 1e-5 / atol 1e-6 and the fused twin
rtol 1e-5 / atol 1e-5 (f32; the same terms, summed in another order in the
fused product); blocks rtol 1e-4 / atol 1e-4 (f32 convolutions and
products summed in another order than XLA's). Maps stay at most 8 x 10
with C <= 8, so interpret-mode Pallas stays fast.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models import layers as j_layers
from centernet_lightning_tpu.ops import pallas_dcn

from centernet_lightning_torch.models import layers as t_layers
from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet
from centernet_lightning_torch.ops import dcn as dcn_ops
from centernet_lightning_torch.ops import dcn_fused, dcn_sample

from _torch_port_helpers import (
    init_flax_dcn, nchw, nhwc, scoped_state_dict,
)

TOL = dict(rtol=1e-4, atol=1e-4)
TAPS = dcn_ops.TAPS
DCN_TYPES = ["dcn", "deformable", "dcn_fast", "dcn_fast_d1", "dcn_fast_d2",
             "dcn_fast_d3", "dcn_fast_d4", "dcn_fused_d1", "dcn_fused_d2"]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _offsets(rng, shape, d):
    """Offsets that reach well past +-d, with a share exactly at +-d (the
    floor-remap boundary) and a share of integers (fraction 0)."""
    off = rng.normal(scale=1.5 * d, size=shape)
    flat = off.reshape(-1)
    idx = rng.permutation(flat.size)
    q = flat.size // 8
    flat[idx[:q]] = d
    flat[idx[q:2 * q]] = -d
    flat[idx[2 * q:3 * q]] = rng.integers(-d - 1, d + 2, size=q)
    return off.astype(np.float32)


def _sampling_inputs(rng, d, version, shape=(2, 8, 10, 8)):
    n, h, w, c = shape
    x = rng.normal(size=shape).astype(np.float32)
    off = _offsets(rng, (n, h, w, 2 * len(TAPS)), d)
    logits = rng.normal(size=(n, h, w, len(TAPS)))
    mask = ((1 / (1 + np.exp(-logits))).astype(np.float32)
            if version == 2 else None)
    planes = dcn_ops.dcn_planes(
        torch.from_numpy(off),
        torch.from_numpy(mask) if mask is not None else None, d)
    return x, planes


def _jax_planes(planes):
    """Port planes (N, H, W, T) -> the JAX engines' (N, T, H, W)."""
    return [jnp.asarray(p.numpy().transpose(0, 3, 1, 2)) for p in planes]


def _w9(planes, d):
    """The fused TPU kernel's per-term weights (N, T, S, S, H, W), built as
    the JAX block builds them (models/layers.py:258-279)."""
    a0, b0, fy, fx, wm = (p.numpy().transpose(0, 3, 1, 2).astype(np.float32)
                          for p in planes)
    s = np.arange(2 * d + 1, dtype=np.float32)
    ty = np.array([t[0] for t in TAPS], np.float32)
    tx = np.array([t[1] for t in TAPS], np.float32)
    sa = (ty[:, None] + s[None] - d)[None, :, :, None, None]
    sb = (tx[:, None] + s[None] - d)[None, :, :, None, None]
    wy = np.where(a0[:, :, None] == sa, 1 - fy[:, :, None],
                  np.where(a0[:, :, None] + 1 == sa, fy[:, :, None], 0.0))
    wy = wy * wm[:, :, None]
    wx = np.where(b0[:, :, None] == sb, 1 - fx[:, :, None],
                  np.where(b0[:, :, None] + 1 == sb, fx[:, :, None], 0.0))
    return (wy[:, :, :, None] * wx[:, :, None, :]).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernels' twins against the JAX engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("version", [1, 2], ids=["v1", "v2"])
@pytest.mark.parametrize("d", [1, 2], ids=["d1", "d2"])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_sampler_twin_matches_jax(engine, d, version):
    rng = np.random.default_rng(10 + d + 2 * version)
    x, planes = _sampling_inputs(rng, d, version)
    n, h, w, c = x.shape
    pad = d + 2
    xp = jnp.asarray(np.pad(x.transpose(0, 3, 1, 2),
                            ((0, 0), (0, 0), (pad, pad), (pad, pad))))
    fn = (pallas_dcn._xla_all if engine == "xla"
          else pallas_dcn.dcn_sample_all_taps)
    ref = np.stack([np.asarray(t) for t in
                    fn(xp, *_jax_planes(planes), d, TAPS, h, w)])
    got = dcn_sample.dcn_sample_taps(torch.from_numpy(x), *planes, d)
    assert got.shape == (n, h, w, len(TAPS), c)
    np.testing.assert_allclose(got.numpy().transpose(3, 0, 4, 1, 2), ref,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("version", [1, 2], ids=["v1", "v2"])
@pytest.mark.parametrize("d", [1, 2], ids=["d1", "d2"])
@pytest.mark.parametrize("engine", ["xla_ref", "pallas"])
def test_fused_twin_matches_jax(engine, d, version):
    rng = np.random.default_rng(20 + d + 2 * version)
    x, planes = _sampling_inputs(rng, d, version)
    n, h, w, c = x.shape
    o = 5
    kernel = rng.normal(size=(len(TAPS), c, o)).astype(np.float32)
    pad = d + 2
    xp = jnp.asarray(np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0))))
    fn = (pallas_dcn._xla_fused_ref if engine == "xla_ref"
          else pallas_dcn.dcn_fused_conv)
    ref = np.asarray(fn(xp, jnp.asarray(_w9(planes, d)), jnp.asarray(kernel),
                        d, TAPS, h, w))
    got = dcn_fused.dcn_fused_conv(torch.from_numpy(x), *planes,
                                   torch.from_numpy(kernel), d)
    assert got.shape == (n, h, w, o)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_twins_agree_with_the_four_corner_form(dtype):
    """The twins sum (2d+1)^2 masked shifts; the kernels sum four corners.
    The exact engine is a four-corner sum: with offsets already clamped,
    all three agree (bf16 to its rounding)."""
    rng = np.random.default_rng(30)
    d = 2
    x, planes = _sampling_inputs(rng, d, 2)
    xt = torch.from_numpy(x).to(dtype)
    a0, b0, fy, fx, wm = planes
    ty = torch.tensor([t[0] for t in TAPS], dtype=torch.float32)
    tx = torch.tensor([t[1] for t in TAPS], dtype=torch.float32)
    off = torch.stack([a0 + fy - ty, b0 + fx - tx], dim=-1).flatten(3)
    exact = dcn_ops.exact_taps(xt, off, wm).float()
    taps = dcn_sample.dcn_sample_taps(xt, *planes, d).float()
    tol = 1e-6 if dtype == torch.float32 else 2 ** -6
    np.testing.assert_allclose(taps.numpy(), exact.numpy(), rtol=tol, atol=tol)
    kernel = torch.from_numpy(
        rng.normal(size=(len(TAPS), x.shape[-1], 4)).astype(np.float32)).to(dtype)
    fused = dcn_fused.dcn_fused_conv(xt, *planes, kernel, d).float()
    per_tap = torch.einsum("nhwtc,tco->nhwo", exact, kernel.float())
    np.testing.assert_allclose(fused.numpy(), per_tap.numpy(),
                               rtol=8 * tol, atol=8 * tol)


def test_wrappers_check_their_inputs():
    rng = np.random.default_rng(31)
    x, planes = _sampling_inputs(rng, 1, 2, shape=(1, 4, 5, 3))
    xt = torch.from_numpy(x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dcn_sample.dcn_sample_taps(xt.half(), *planes, 1)
    with pytest.raises(ValueError, match="must be"):
        dcn_sample.dcn_sample_taps(xt, planes[0][:, :2], *planes[1:], 1)
    with pytest.raises(TypeError, match="int32"):
        dcn_sample.dcn_sample_taps(xt, planes[0].long(), *planes[1:], 1)
    with pytest.raises(ValueError, match="positive int"):
        dcn_sample.dcn_sample_taps(xt, *planes, 0)
    with pytest.raises(ValueError, match="no DCN sampling kernel"):
        dcn_sample.dcn_sample_taps(xt.to("meta"), *(p.to("meta") for p in planes), 1)
    with pytest.raises(ValueError, match="kernel must be"):
        dcn_fused.dcn_fused_conv(xt, *planes, torch.zeros(9, 4, 2), 1)
    with pytest.raises(TypeError, match="kernel is"):
        dcn_fused.dcn_fused_conv(xt, *planes, torch.zeros(9, 3, 2).double(), 1)
    before = (dcn_sample.dcn_sample_taps.launches, dcn_fused.dcn_fused_conv.launches)
    dcn_sample.dcn_sample_taps(xt, *planes, 1)
    dcn_fused.dcn_fused_conv(xt, *planes, torch.zeros(9, 3, 2), 1)
    # the CPU twins are not kernel launches
    assert (dcn_sample.dcn_sample_taps.launches,
            dcn_fused.dcn_fused_conv.launches) == before


# ---------------------------------------------------------------------------
# DeformableConvBlock
# ---------------------------------------------------------------------------

def _block_pair(name_or_kwargs, in_c, out_c, x, rng):
    if isinstance(name_or_kwargs, str):
        j = j_layers.CONV_BLOCKS[name_or_kwargs](out_c, 3)
        t = t_layers.CONV_BLOCKS[name_or_kwargs](in_c, out_c, 3)
    else:
        kw = dict(name_or_kwargs)
        j = j_layers.DeformableConvBlock(out_c, **kw)
        t = t_layers.DeformableConvBlock(in_c, out_c, **kw)
    v = init_flax_dcn(j, jnp.asarray(x), rng)
    t.load_state_dict(scoped_state_dict(v, "DeformableConvBlock_0", "blocks.0."),
                      strict=True)
    return j, v, t.eval()


@pytest.mark.parametrize("name", DCN_TYPES)
def test_deformable_block_matches_jax(name):
    rng = np.random.default_rng(40)
    x = rng.normal(size=(2, 8, 10, 6)).astype(np.float32)
    j, v, t = _block_pair(name, 6, 7, x, rng)
    off = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), v["params"]["Conv_0"]["kernel"], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + v["params"]["Conv_0"]["bias"]
    assert np.abs(off).max() > 2.5          # offsets reach past the clamps
    ref = np.asarray(j.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(t(nchw(x)))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("engine", [
    {}, {"max_displacement": 1}, {"max_displacement": 2, "sampler": "fused"},
], ids=["exact", "fast_d1", "fused_d2"])
def test_deformable_block_v1_with_bias_matches_jax(engine):
    rng = np.random.default_rng(41)
    x = rng.normal(size=(1, 7, 9, 5)).astype(np.float32)
    kw = dict(version=1, use_norm=False, act=None, **engine)
    j, v, t = _block_pair(kw, 5, 4, x, rng)
    assert t.conv_mask is None and t.deform.bias is not None
    v["params"]["bias"] = rng.normal(size=4).astype(np.float32)
    t.deform.bias.data = torch.from_numpy(v["params"]["bias"])
    ref = np.asarray(j.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(t(nchw(x)))
    np.testing.assert_allclose(got, ref, **TOL)


def _port_block(in_c, out_c, rng, scale, **kw):
    blk = t_layers.DeformableConvBlock(in_c, out_c, use_norm=False, act=None,
                                       **kw).eval()
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.from_numpy(
                rng.normal(scale=scale, size=tuple(p.shape)).astype(np.float32)))
    return blk


@pytest.mark.parametrize("engine,bound,scale", [
    ({"max_displacement": 3}, 3.0, 0.05),
    ({"max_displacement": 1}, 1.0, 0.02),
    ({"max_displacement": 1, "sampler": "fused"}, 1.0, 0.02),
], ids=["fast_d3", "fast_d1", "fused_d1"])
@pytest.mark.parametrize("version", [1, 2], ids=["v1", "v2"])
def test_bounded_engines_equal_exact_within_bound(engine, bound, scale, version):
    """Where every offset lies within +-d the bounded engines compute the
    exact engine's function."""
    rng = np.random.default_rng(50 + version)
    x = torch.from_numpy(rng.normal(size=(2, 7, 9, 5)).astype(np.float32))
    x = x.permute(0, 3, 1, 2)
    fast = _port_block(5, 4, rng, scale, version=version, **engine)
    exact = t_layers.DeformableConvBlock(5, 4, use_norm=False, act=None,
                                         version=version).eval()
    exact.load_state_dict(fast.state_dict())
    with torch.no_grad():
        assert fast.conv_offset(x).abs().max() < bound   # the precondition
        np.testing.assert_allclose(fast(x).numpy(), exact(x).numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sampler", ["auto", "fused"])
def test_bounded_engines_clamp_large_offsets(sampler):
    """Offsets past +-d act as +-d exactly: every offset pushed to +50
    equals the exact engine with every offset at +d."""
    rng = np.random.default_rng(52)
    x = torch.from_numpy(rng.normal(size=(1, 3, 6, 6)).astype(np.float32))
    d = 2
    fast = _port_block(3, 3, rng, 0.5, version=1, max_displacement=d,
                       sampler=sampler)
    exact = t_layers.DeformableConvBlock(3, 3, use_norm=False, act=None,
                                         version=1).eval()
    with torch.no_grad():
        fast.conv_offset.weight.zero_()
        fast.conv_offset.bias.fill_(50.0)
        exact.load_state_dict(fast.state_dict())
        exact.conv_offset.bias.fill_(float(d))
        np.testing.assert_allclose(fast(x).numpy(), exact(x).numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_exact_engine_samples_zero_far_outside():
    rng = np.random.default_rng(53)
    x = torch.from_numpy(rng.normal(size=(1, 4, 5, 5)).astype(np.float32))
    blk = _port_block(4, 3, rng, 1.0, version=1)
    with torch.no_grad():
        blk.deform.bias.zero_()
        blk.conv_offset.weight.zero_()
        blk.conv_offset.bias.fill_(100.0)
        assert torch.equal(blk(x), torch.zeros(1, 3, 5, 5))


def test_kernel_size_5_raises_on_shift_engines_and_matches_jax_on_exact():
    for sampler in ("auto", "fused"):
        with pytest.raises(ValueError, match="kernel_size=3 only"):
            t_layers.DeformableConvBlock(3, 4, kernel_size=5,
                                         max_displacement=2, sampler=sampler)
    rng = np.random.default_rng(54)
    x = rng.normal(size=(1, 8, 8, 3)).astype(np.float32)
    j = j_layers.DeformableConvBlock(4, kernel_size=5)
    v = init_flax_dcn(j, jnp.asarray(x), rng)
    t = t_layers.DeformableConvBlock(3, 4, kernel_size=5)
    t.load_state_dict(scoped_state_dict(v, "DeformableConvBlock_0", "blocks.0."),
                      strict=True)
    t.eval()
    ref = np.asarray(j.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(t(nchw(x)))
    assert got.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("k,version", [(2, 2), (4, 2), (4, 1)])
def test_even_kernel_block_matches_jax(k, version):
    """An even k on the exact engine: SAME offset and mask convolutions pad
    (k - 1) // 2 low and k // 2 high (at stride 1 whatever the size), taps
    start at -(k - 1) // 2; offsets past +-1."""
    for sampler in ("auto", "fused"):
        with pytest.raises(ValueError, match="kernel_size=3 only"):
            t_layers.DeformableConvBlock(3, 4, kernel_size=k,
                                         max_displacement=1, sampler=sampler)
    rng = np.random.default_rng(60 + k + version)
    x = rng.normal(size=(2, 7, 8, 3)).astype(np.float32)
    j = j_layers.DeformableConvBlock(5, kernel_size=k, version=version)
    v = init_flax_dcn(j, jnp.asarray(x), rng)
    t = t_layers.DeformableConvBlock(3, 5, kernel_size=k, version=version)
    t.load_state_dict(scoped_state_dict(v, "DeformableConvBlock_0",
                                        "blocks.0."), strict=True)
    t.eval()
    ref = np.asarray(j.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(t(nchw(x)))
    assert got.shape == (2, 7, 8, 5)
    np.testing.assert_allclose(got, ref, **TOL)


def test_registry_and_init():
    for name in DCN_TYPES:
        blk = t_layers.get_conv_block(name)(4, 6, 3)
        want = j_layers.CONV_BLOCKS[name](6, 3)
        assert blk.max_displacement == want.max_displacement, name
        assert blk.sampler == ("fused" if want.sampler == "fused" else "auto")
    sep = t_layers.get_conv_block("separable")(4, 6, 3)
    assert isinstance(sep, t_layers.SeparableConvNormAct)
    assert sep.blocks[0].conv.groups == 4
    with pytest.raises(KeyError):
        t_layers.get_conv_block("dcn_fast_d9")
    cfg = {"num_classes": 3, "backbone": "resnet18",
           "backbone_config": {"width": 8},
           "neck_config": {"out_channels": 8, "conv_type": "dcn_fast_d1"},
           "head_config": {"width": 8, "depth": 1, "block": "dcn"}}
    task = TCenterNet(**cfg)
    task.init(torch.Generator().manual_seed(0))
    blocks = [m for m in task.model.modules()
              if isinstance(m, t_layers.DeformableConvBlock)]
    assert len(blocks) == 5                  # 3 FPN merges, 1 per head
    for blk in blocks:
        # zero offsets and masks at init, as the flax block
        for conv in (blk.conv_offset, blk.conv_mask):
            assert not conv.weight.any() and not conv.bias.any()
        c = blk.deform.weight.shape[1]
        std = blk.deform.weight.std().item()
        assert abs(std / np.sqrt(2.0 / (9 * c)) - 1) < 0.25
