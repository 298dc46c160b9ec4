"""PyTorch port vs the JAX package: the backward of the two DCN kernels and
a DCN block in train mode, on the CPU with identical inputs and weights.

- The sampler's and the fused kernel's `autograd.Function`s (their CPU
  forward is the twin; the backward recomputes through the twin on either
  device) against `jax.vjp` of `_xla_all` and of `_xla_fused_ref` (the
  fused one through the per-term weights w9, built from fy, fx and wm as
  the JAX block builds them): rtol 1e-5 in f32, with an atol of 1e-6 of
  the gradient's largest magnitude for entries that sums cancel to near 0.
- The Functions' gradients against plain autograd through the twins:
  bitwise on the CPU (on the card the fused kernel's backward is held so
  by chip_smoke.py; the sampler's is a kernel, held within a tolerance).
- The clamp's gradient at an offset exactly on +-d, where the two
  frameworks differ (the block-level tests draw offsets off the ties,
  test_torch_port_dcn_block_train.py).
- The plain twin of the sampler's backward kernel,
  `tap_sample_backward_reference` (four corners, f32 sums, dx by
  index_add_), against autograd through `tap_sample_reference` and
  `jax.vjp` of `_xla_all` at the tolerances above, with offsets past +-d
  and samples off the image; in bf16 against the float64 gradient of the
  same bf16 inputs, where it must be at least as close as the twin's bf16
  autograd. On a CPU tensor the Function still backpropagates through the
  twin, and the CUDA-only backward wrapper refuses CPU tensors and inputs
  it does not take.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.ops import pallas_dcn

from centernet_lightning_torch.ops import dcn as dcn_ops
from centernet_lightning_torch.ops import dcn_fused, dcn_sample

TAPS = dcn_ops.TAPS


def _inputs(seed, d, version, shape=(2, 6, 7, 5), o=4):
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    x = rng.normal(size=shape).astype(np.float32)
    off = rng.normal(scale=1.5 * d, size=(n, h, w, 2 * len(TAPS))).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.normal(size=(n, h, w, len(TAPS)))))).astype(np.float32)
    planes = dcn_ops.dcn_planes(torch.from_numpy(off),
                                torch.from_numpy(mask) if version == 2 else None, d)
    kernel = rng.normal(size=(len(TAPS), c, o)).astype(np.float32)
    grad_taps = rng.normal(size=(n, h, w, len(TAPS), c)).astype(np.float32)
    grad_out = rng.normal(size=(n, h, w, o)).astype(np.float32)
    return x, planes, kernel, grad_taps, grad_out


def _jnp_planes(planes):
    """Port planes (N, H, W, T) -> the JAX engines' (N, T, H, W)."""
    return [jnp.asarray(p.numpy().transpose(0, 3, 1, 2)) for p in planes]


def _jax_w9(a0, b0, fy, fx, wm, d):
    """Per-term weights (N, T, S, S, H, W) as the JAX block builds them
    (models/layers.py:258-279), differentiable in fy, fx and wm."""
    s = jnp.arange(2 * d + 1, dtype=jnp.float32)
    ty = jnp.asarray([t[0] for t in TAPS], jnp.float32)
    tx = jnp.asarray([t[1] for t in TAPS], jnp.float32)
    sa = (ty[:, None] + s[None] - d)[None, :, :, None, None]
    sb = (tx[:, None] + s[None] - d)[None, :, :, None, None]
    a0e = a0.astype(jnp.float32)[:, :, None]
    b0e = b0.astype(jnp.float32)[:, :, None]
    wy = jnp.where(a0e == sa, 1.0 - fy[:, :, None],
                   jnp.where(a0e + 1.0 == sa, fy[:, :, None], 0.0))
    wy = wy * wm[:, :, None]
    wx = jnp.where(b0e == sb, 1.0 - fx[:, :, None],
                   jnp.where(b0e + 1.0 == sb, fx[:, :, None], 0.0))
    return wy[:, :, :, None] * wx[:, :, None, :]


def _assert_grad_close(got, ref, name=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * max(1.0, float(np.abs(ref).max())),
                               err_msg=name)


def _port_grads(fn, x, planes, extra, grad, wrt):
    """Gradients of fn's output . grad w.r.t. `wrt` (names among x, fy,
    fx, wm, kernel), through the Function."""
    leaves = {"x": torch.from_numpy(x), "fy": planes[2].clone(),
              "fx": planes[3].clone(), "wm": planes[4].clone()}
    if extra is not None:
        leaves["kernel"] = torch.from_numpy(extra)
    for name in wrt:
        leaves[name].requires_grad_()
    args = [leaves["x"], planes[0], planes[1], leaves["fy"], leaves["fx"],
            leaves["wm"]]
    if extra is not None:
        args.append(leaves["kernel"])
    out = fn(*args)
    got = torch.autograd.grad(out, [leaves[k] for k in wrt], torch.from_numpy(grad))
    return dict(zip(wrt, got))


@pytest.mark.parametrize("version", [1, 2], ids=["v1", "v2"])
@pytest.mark.parametrize("d", [1, 2], ids=["d1", "d2"])
def test_sampler_backward_matches_jax_vjp(d, version):
    x, planes, _, grad_taps, _ = _inputs(60 + d + 2 * version, d, version)
    n, h, w, c = x.shape
    pad = d + 2
    a0, b0, fy, fx, wm = _jnp_planes(planes)
    xp = jnp.asarray(np.pad(x.transpose(0, 3, 1, 2),
                            ((0, 0), (0, 0), (pad, pad), (pad, pad))))
    _, vjp = jax.vjp(lambda xp_, fy_, fx_, wm_: pallas_dcn._xla_all(
        xp_, a0, b0, fy_, fx_, wm_, d, TAPS, h, w), xp, fy, fx, wm)
    gxp, gfy, gfx, gwm = vjp(tuple(jnp.asarray(grad_taps[:, :, :, t].transpose(0, 3, 1, 2))
                                   for t in range(len(TAPS))))
    got = _port_grads(lambda *a: dcn_sample.dcn_sample_taps(*a, d), x, planes,
                      None, grad_taps, ("x", "fy", "fx", "wm"))
    ref_x = np.asarray(gxp)[:, :, pad:pad + h, pad:pad + w].transpose(0, 2, 3, 1)
    _assert_grad_close(got["x"].numpy(), ref_x, "x")
    for name, ref in (("fy", gfy), ("fx", gfx), ("wm", gwm)):
        _assert_grad_close(got[name].numpy(),
                           np.asarray(ref).transpose(0, 2, 3, 1), name)


@pytest.mark.parametrize("version", [1, 2], ids=["v1", "v2"])
@pytest.mark.parametrize("d", [1, 2], ids=["d1", "d2"])
def test_fused_backward_matches_jax_vjp(d, version):
    x, planes, kernel, _, grad_out = _inputs(70 + d + 2 * version, d, version)
    n, h, w, c = x.shape
    pad = d + 2
    a0, b0, fy, fx, wm = _jnp_planes(planes)
    xp = jnp.asarray(np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0))))

    def ref_fn(xp_, fy_, fx_, wm_, k_):
        return pallas_dcn._xla_fused_ref(xp_, _jax_w9(a0, b0, fy_, fx_, wm_, d),
                                         k_, d, TAPS, h, w)

    _, vjp = jax.vjp(ref_fn, xp, fy, fx, wm, jnp.asarray(kernel))
    gxp, gfy, gfx, gwm, gk = vjp(jnp.asarray(grad_out))
    got = _port_grads(lambda *a: dcn_fused.dcn_fused_conv(*a, d), x, planes,
                      kernel, grad_out, ("x", "fy", "fx", "wm", "kernel"))
    _assert_grad_close(got["x"].numpy(),
                       np.asarray(gxp)[:, pad:pad + h, pad:pad + w], "x")
    _assert_grad_close(got["kernel"].numpy(), gk, "kernel")
    for name, ref in (("fy", gfy), ("fx", gfx), ("wm", gwm)):
        _assert_grad_close(got[name].numpy(),
                           np.asarray(ref).transpose(0, 2, 3, 1), name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel_name", ["sample", "fused"])
def test_function_gradients_equal_twin_autograd(kernel_name, dtype):
    """The recompute is the twin, so the Function's gradients are bitwise
    the twin's own autograd gradients for the same upstream gradient."""
    d = 1
    x, planes, kernel, grad_taps, grad_out = _inputs(80, d, 2)
    x_t = torch.from_numpy(x).to(dtype)
    k_t = torch.from_numpy(kernel).to(dtype)
    if kernel_name == "sample":
        fn, twin, grad, extra = (dcn_sample.dcn_sample_taps,
                                 dcn_ops.tap_sample_reference, grad_taps, ())
    else:
        fn, twin, grad, extra = (dcn_fused.dcn_fused_conv,
                                 dcn_ops.fused_reference, grad_out, (k_t,))
    grad = torch.from_numpy(grad).to(dtype)
    results = []
    for f in (fn, twin):
        xs = x_t.clone().requires_grad_()
        fys, fxs, wms = (p.clone().requires_grad_() for p in planes[2:])
        ks = [e.clone().requires_grad_() for e in extra]
        out = f(xs, planes[0], planes[1], fys, fxs, wms, *ks, d)
        results.append(torch.autograd.grad(out, [xs, fys, fxs, wms, *ks], grad))
    for got, ref in zip(*results):
        assert torch.equal(got, ref)


def test_no_gradient_to_the_floors_and_only_what_is_asked():
    x, planes, kernel, _, grad_out = _inputs(81, 1, 2)
    xs = torch.from_numpy(x).requires_grad_()
    out = dcn_fused.dcn_fused_conv(xs, *planes, torch.from_numpy(kernel), 1)
    (gx,) = torch.autograd.grad(out, [xs], torch.from_numpy(grad_out))
    assert gx.shape == xs.shape
    assert not planes[0].dtype.is_floating_point and out.grad_fn is not None
    with torch.no_grad():
        assert dcn_sample.dcn_sample_taps(torch.from_numpy(x), *planes, 1).grad_fn is None


def test_clamp_tie_gradient_convention():
    """At an offset exactly on the clamp (+-d) `jnp.clip` splits the
    gradient between its two sides (half passes) while `torch.clamp` passes
    all of it: the port's planes take the whole gradient there and agree
    with JAX everywhere else."""
    d = 1
    off = np.array([-1.5, -1.0, -0.3, 0.0, 0.7, 1.0, 2.0] * 18,
                   np.float32)[:18].reshape(1, 1, 1, 18)
    t_off = torch.from_numpy(off).requires_grad_()
    _, _, fy, fx, _ = dcn_ops.dcn_planes(t_off, None, d)
    (got,) = torch.autograd.grad(fy.sum() + fx.sum(), [t_off])
    ref = np.asarray(jax.grad(lambda o: jnp.sum(jnp.clip(o, -d, d)))(jnp.asarray(off)))
    tie = np.abs(off) == d
    assert tie.any() and (np.abs(off) < d).any() and (np.abs(off) > d).any()
    np.testing.assert_array_equal(got.numpy()[tie], 1.0)
    np.testing.assert_array_equal(ref[tie], 0.5)
    np.testing.assert_array_equal(got.numpy()[~tie], ref[~tie])


def _sampler_inputs(seed, d, version, offsets):
    """x, planes and a tap gradient on a 6 x 7 map (every pixel near a
    border) with offsets drawn past +-d ("random") or at +-50 ("far": every
    sample clamped, corners off the image along the border)."""
    x, planes, _, grad_taps, _ = _inputs(seed, d, version)
    if offsets == "far":
        rng = np.random.default_rng(seed + 1000)
        n, h, w, _ = x.shape
        off = 50.0 * rng.choice([-1.0, 1.0], size=(n, h, w, 2 * len(TAPS)))
        planes = dcn_ops.dcn_planes(torch.from_numpy(off.astype(np.float32)),
                                    planes[4] if version == 2 else None, d)
    return x, planes, grad_taps


@pytest.mark.parametrize("offsets", ["random", "far"])
@pytest.mark.parametrize("version", [1, 2], ids=["v1", "v2"])
@pytest.mark.parametrize("d", [1, 2], ids=["d1", "d2"])
def test_plain_sampler_backward_matches_autograd_and_jax_vjp(d, version, offsets):
    x, planes, grad_taps = _sampler_inputs(90 + d + 2 * version, d, version, offsets)
    n, h, w, c = x.shape
    got = dcn_ops.tap_sample_backward_reference(torch.from_numpy(x), *planes,
                                                torch.from_numpy(grad_taps))
    assert [g.dtype for g in got] == [torch.float32] * 4
    # autograd through the twin
    twin = _port_grads(lambda *a: dcn_ops.tap_sample_reference(*a, d), x, planes,
                       None, grad_taps, ("x", "fy", "fx", "wm"))
    for name, g in zip(("x", "fy", "fx", "wm"), got):
        _assert_grad_close(g.numpy(), twin[name].numpy(), name)
    # jax.vjp of the JAX package's XLA twin
    pad = d + 2
    a0, b0, fy, fx, wm = _jnp_planes(planes)
    xp = jnp.asarray(np.pad(x.transpose(0, 3, 1, 2),
                            ((0, 0), (0, 0), (pad, pad), (pad, pad))))
    _, vjp = jax.vjp(lambda xp_, fy_, fx_, wm_: pallas_dcn._xla_all(
        xp_, a0, b0, fy_, fx_, wm_, d, TAPS, h, w), xp, fy, fx, wm)
    gxp, gfy, gfx, gwm = vjp(tuple(jnp.asarray(grad_taps[:, :, :, t].transpose(0, 3, 1, 2))
                                   for t in range(len(TAPS))))
    _assert_grad_close(got[0].numpy(), np.asarray(gxp)[:, :, pad:pad + h, pad:pad + w]
                       .transpose(0, 2, 3, 1), "x")
    for name, g, ref in zip(("fy", "fx", "wm"), got[1:], (gfy, gfx, gwm)):
        _assert_grad_close(g.numpy(), np.asarray(ref).transpose(0, 2, 3, 1), name)


@pytest.mark.parametrize("d", [1, 2], ids=["d1", "d2"])
def test_plain_sampler_backward_bf16_within_one_rounding(d):
    """bf16 inputs: the plain backward sums their exact values in f32 and
    rounds dx to bf16 once, so dx lies within 2^-8 of each element's
    float64 value (half a bf16 ulp is at most 2^-8 of it, with room for the
    f32 sums: rtol 1e-5 of the largest), and the f32 plane gradients within
    1e-5; the twin's bf16 autograd rounds every product and running sum,
    and is never closer."""
    x, planes, grad_taps = _sampler_inputs(95 + d, d, 2, "random")
    xb = torch.from_numpy(x).bfloat16()
    gb = torch.from_numpy(grad_taps).bfloat16()
    got = dcn_ops.tap_sample_backward_reference(xb, *planes, gb)
    assert got[0].dtype == torch.bfloat16
    assert [g.dtype for g in got[1:]] == [torch.float32] * 3

    def autograd(dtype):
        leaves = [xb.to(dtype).requires_grad_()]
        leaves += [p.to(torch.float64 if dtype == torch.float64 else p.dtype)
                   .requires_grad_() for p in planes[2:]]
        out = dcn_ops.tap_sample_reference(leaves[0], planes[0], planes[1],
                                           *leaves[1:], d)
        return torch.autograd.grad(out, leaves, gb.to(dtype))

    truth = autograd(torch.float64)
    twin = autograd(torch.bfloat16)
    for name, g, t, tw in zip(("x", "fy", "fx", "wm"), got, truth, twin):
        err = (g.double() - t).abs()
        scale = float(t.abs().max())
        if name == "x":
            assert bool((err <= 2.0 ** -8 * t.abs() + 1e-5 * scale).all()), name
        else:
            assert float(err.max()) <= 1e-5 * scale, name
        assert float(err.max()) <= float((tw.double() - t).abs().max()), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [1, 2], ids=["d1", "d2"])
def test_cpu_sampler_backward_is_the_twin_and_launches_nothing(d, dtype):
    """On a CPU tensor the backward recomputes through the twin: bitwise
    its autograd gradients, and no backward (or forward) kernel launch."""
    x, planes, grad_taps = _sampler_inputs(100 + d, d, 2, "random")
    x_t = torch.from_numpy(x).to(dtype)
    grad = torch.from_numpy(grad_taps).to(dtype)
    launches = (dcn_sample.dcn_sample_taps.launches,
                dcn_sample.dcn_sample_taps.grad_launches)
    results = []
    for f in (dcn_sample.dcn_sample_taps, dcn_ops.tap_sample_reference):
        xs = x_t.clone().requires_grad_()
        fys, fxs, wms = (p.clone().requires_grad_() for p in planes[2:])
        out = f(xs, planes[0], planes[1], fys, fxs, wms, d)
        results.append(torch.autograd.grad(out, [xs, fys, fxs, wms], grad))
    for got, ref in zip(*results):
        assert torch.equal(got, ref)
    assert (dcn_sample.dcn_sample_taps.launches,
            dcn_sample.dcn_sample_taps.grad_launches) == launches


def _refused(case):
    x, planes, grad_taps = _sampler_inputs(110, 1, 2, "random")
    x = torch.from_numpy(x)
    grad = torch.from_numpy(grad_taps)
    planes = list(planes)
    wants = (True,) * 4
    if case == "grad_shape":
        grad = grad[..., :-1]
    elif case == "grad_dtype":
        grad = grad.bfloat16()
    elif case == "x_dtype":
        x, grad = x.half(), grad.half()
    elif case == "plane_dtype":
        planes[2] = planes[2].double()
    elif case == "plane_shape":
        planes[4] = planes[4][:, 1:]
    elif case == "wants":
        wants = (True, True)
    return x, planes, grad, wants


@pytest.mark.parametrize("case, error, match", [
    ("cpu", ValueError, "no DCN sampling backward kernel for device cpu"),
    ("grad_shape", ValueError, "grad_taps must be"),
    ("grad_dtype", TypeError, "grad_taps must be torch.float32"),
    ("x_dtype", TypeError, "x must be float32 or bfloat16"),
    ("plane_dtype", TypeError, "fy must be torch.float32"),
    ("plane_shape", ValueError, "wm must be"),
    ("wants", ValueError, "wants names"),
])
def test_sampler_backward_kernel_wrapper_refuses(case, error, match):
    """The wrapper takes CUDA tensors of the kernel's shapes and dtypes
    only, and raises before any launch on anything else."""
    x, planes, grad, wants = _refused(case)
    before = dcn_sample.dcn_sample_taps.grad_launches
    with pytest.raises(error, match=match):
        dcn_sample.dcn_sample_taps_backward(x, *planes, grad, wants)
    assert dcn_sample.dcn_sample_taps.grad_launches == before
