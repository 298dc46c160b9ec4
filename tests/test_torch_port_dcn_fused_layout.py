"""The fused DCN wrapper's work before a launch, on the CPU: the bf16
kernel's weight layout (`ops/dcn_fused.py:pack_wgmma_kernel`) and the
checks that raise before a launch.

The bf16 kernel (csrc/dcn_fused.cu) copies its W tiles with
cp.async.bulk and reads them through 128-byte-swizzled wgmma descriptors,
so the wrapper lays the (9, C, O) kernel out as (chunk, tap, O tile) blocks
of 128 outputs x 64 channels, K-major, with the 16-byte group g of row n at
g ^ (n % 8), zeros past C and O. These tests read the packed tiles back by
the descriptor's address rule, as the kernel does, and hold the result
against the original kernel: exactly, through `fused_reference`, and
against the JAX package's fused reference (f32, rtol 1e-5 / atol 1e-5 as
in test_torch_port_dcn.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.ops import pallas_dcn

from centernet_lightning_torch.ops import dcn as dcn_ops
from centernet_lightning_torch.ops import dcn_fused

TAPS = dcn_ops.TAPS
CHUNK, OTILE = 64, 128
SHAPES = [(128, 128), (24, 40), (72, 136), (432, 16), (8, 8)]


def _read_tiles(packed: torch.Tensor, c: int, o: int) -> torch.Tensor:
    """The (9, C, O) kernel as the bf16 kernel reads `packed`: element
    (k, n) of the tile (chunk kc, tap t, O tile ot) at row n, 16-byte group
    (k // 8) ^ (n % 8), position k % 8 (the descriptor's 128-byte swizzle),
    k the channel within the chunk and n the output within the O tile."""
    kc, taps, ot = packed.shape[:3]
    flat = packed.reshape(kc, taps, ot, OTILE * CHUNK)
    k = torch.arange(CHUNK)[:, None]
    n = torch.arange(OTILE)[None, :]
    offset = n * CHUNK + ((k // 8) ^ (n % 8)) * 8 + k % 8      # (k, n)
    tiles = flat[..., offset]                                    # (kc, t, ot, k, n)
    full = tiles.permute(1, 0, 3, 2, 4).reshape(taps, kc * CHUNK, ot * OTILE)
    return full, full[:, :c, :o]


def _planes(rng, shape, d, version):
    n, h, w, _ = shape
    off = rng.normal(scale=1.5 * d, size=(n, h, w, 2 * len(TAPS)))
    mask = (1 / (1 + np.exp(-rng.normal(size=(n, h, w, len(TAPS))))))
    return dcn_ops.dcn_planes(
        torch.from_numpy(off.astype(np.float32)),
        torch.from_numpy(mask.astype(np.float32)) if version == 2 else None, d)


@pytest.mark.parametrize("c,o", SHAPES, ids=[f"c{c}_o{o}" for c, o in SHAPES])
def test_packed_kernel_layout(c, o):
    rng = np.random.default_rng(c * 1000 + o)
    kernel = torch.from_numpy(rng.normal(size=(9, c, o)).astype(np.float32)
                              ).to(torch.bfloat16)
    packed = dcn_fused.pack_wgmma_kernel(kernel)
    kc, ot = -(-c // CHUNK), -(-o // OTILE)
    assert packed.shape == (kc, 9, ot, OTILE, CHUNK)
    assert packed.dtype == torch.bfloat16
    # the kernel copies whole tiles from the pointer: the layout must be the
    # storage order, not a view of it (a gather keeps its index's strides)
    assert packed.is_contiguous()
    full, got = _read_tiles(packed, c, o)
    assert torch.equal(got, kernel)
    # the padding past C and O multiplies zero samples: it must be zeros
    pad = full.clone()
    pad[:, :c, :o] = 0
    assert not pad.any()


@pytest.mark.parametrize("c,o", SHAPES[:3], ids=[f"c{c}_o{o}" for c, o in SHAPES[:3]])
def test_tiled_product_over_packed_tiles_matches_per_tap_sum(c, o):
    """The bf16 kernel's order of work: for each chunk, tap and O tile, a
    (pixels x 64) sample tile times the (64 x 128) W tile, summed; against
    sum_t sample_t @ W[t]."""
    rng = np.random.default_rng(7 + c + o)
    kernel = torch.from_numpy(rng.normal(size=(9, c, o))).to(torch.bfloat16)
    samples = torch.from_numpy(rng.normal(size=(9, 50, c))).to(torch.bfloat16)
    packed = dcn_fused.pack_wgmma_kernel(kernel)
    kc, _, ot = packed.shape[:3]
    full, _ = _read_tiles(packed, c, o)
    a = torch.zeros(9, 50, kc * CHUNK, dtype=torch.float64)
    a[..., :c] = samples.double()
    acc = torch.zeros(50, ot * OTILE, dtype=torch.float64)
    for chunk in range(kc):
        for t in range(9):
            for tile in range(ot):
                cols = slice(tile * OTILE, (tile + 1) * OTILE)
                rows = slice(chunk * CHUNK, (chunk + 1) * CHUNK)
                acc[:, cols] += a[t, :, rows] @ full[t, rows, cols].double()
    want = torch.einsum("tpc,tco->po", samples.double(), kernel.double())
    np.testing.assert_allclose(acc[:, :o].numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("d", [1, 2], ids=["d1", "d2"])
def test_packed_kernel_through_twin_matches_jax(d):
    """fused_reference with the kernel read back from its packed tiles, on
    the same inputs as the JAX package's fused reference with the kernel as
    given."""
    rng = np.random.default_rng(40 + d)
    n, h, w, c, o = 2, 6, 7, 72, 9
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    kernel = rng.normal(size=(9, c, o)).astype(np.float32)
    planes = _planes(rng, (n, h, w, c), d, 2)
    _, unpacked = _read_tiles(
        dcn_fused.pack_wgmma_kernel(torch.from_numpy(kernel)), c, o)
    got = dcn_ops.fused_reference(torch.from_numpy(x), *planes, unpacked, d)
    same = dcn_ops.fused_reference(torch.from_numpy(x), *planes,
                                   torch.from_numpy(kernel), d)
    assert torch.equal(got, same)
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
    w9 = (wy[:, :, :, None] * wx[:, :, None, :]).astype(np.float32)
    pad = d + 2
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    ref = np.asarray(pallas_dcn._xla_fused_ref(
        jnp.asarray(xp), jnp.asarray(w9), jnp.asarray(kernel), d, TAPS, h, w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def _launch_inputs(rng, c=16, o=8):
    x = torch.from_numpy(rng.normal(size=(1, 5, 6, c)).astype(np.float32))
    planes = _planes(rng, (1, 5, 6, c), 1, 2)
    kernel = torch.from_numpy(rng.normal(size=(9, c, o)).astype(np.float32))
    return x, planes, kernel


@pytest.mark.parametrize("what", ["x", "kernel", "plane"])
def test_check_launch_refuses_non_contiguous(what):
    x, planes, kernel = _launch_inputs(np.random.default_rng(3))
    if what == "x":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif what == "kernel":
        kernel = kernel.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        planes = (planes[0], planes[1], planes[2].transpose(1, 2).contiguous()
                  .transpose(1, 2), planes[3], planes[4])
    with pytest.raises(ValueError, match="contiguous"):
        dcn_fused.check_launch(x, planes, kernel)


def test_check_launch_refuses_empty_and_takes_the_rest():
    x, planes, kernel = _launch_inputs(np.random.default_rng(4))
    dcn_fused.check_launch(x, planes, kernel)
    with pytest.raises(ValueError, match="empty"):
        dcn_fused.check_launch(x[:0], tuple(p[:0] for p in planes), kernel)
    with pytest.raises(ValueError, match="empty"):
        dcn_fused.check_launch(x, planes, kernel[:, :, :0])


def test_wrapper_raises_before_a_launch_and_counts_none():
    x, planes, kernel = _launch_inputs(np.random.default_rng(5))
    before = dcn_fused.dcn_fused_conv.launches
    with pytest.raises(ValueError, match="kernel must be"):
        dcn_fused.dcn_fused_conv(x, *planes, kernel[:, :4], 1)
    with pytest.raises(TypeError, match="kernel is"):
        dcn_fused.dcn_fused_conv(x, *planes, kernel.to(torch.bfloat16), 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dcn_fused.dcn_fused_conv(x.half(), *planes, kernel.half(), 1)
    with pytest.raises(TypeError, match="int32"):
        dcn_fused.dcn_fused_conv(x, planes[0].long(), *planes[1:], kernel, 1)
    with pytest.raises(ValueError, match="positive int"):
        dcn_fused.dcn_fused_conv(x, *planes, kernel, 0)
    with pytest.raises(ValueError, match="no fused DCN kernel"):
        dcn_fused.dcn_fused_conv(x.to("meta"), *(p.to("meta") for p in planes),
                                 kernel.to("meta"), 1)
    # the CPU branch is the twin, bitwise, and no kernel launch
    for dtype in (torch.float32, torch.bfloat16):
        got = dcn_fused.dcn_fused_conv(x.to(dtype), *planes, kernel.to(dtype), 1)
        want = dcn_ops.fused_reference(x.to(dtype), *planes, kernel.to(dtype), 1)
        assert torch.equal(got, want)
    assert dcn_fused.dcn_fused_conv.launches == before
