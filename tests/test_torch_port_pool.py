"""PyTorch port vs the JAX package: the 3x3 / stride-2 max pool's plain twin
(the CPU side of `max_pool_3x3_s2_auto`) against the Pallas kernel in
interpret mode and `lax.reduce_window`, and against `F.max_pool2d`.

Tolerance: none. A max returns one of its inputs, so every comparison is
exact, in f32 and bf16, with -inf among the values. The CUDA kernel itself
is held against the twin on the card by chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from centernet_lightning_tpu.ops import pallas_pool

from centernet_lightning_torch.ops import pool


def _reduce_window(x):
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), ((0, 0), (1, 1), (1, 1), (0, 0)))


def _input(shape, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x.reshape(-1)[::7] = -np.inf
    return x


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 8, 8, 3), (1, 32, 24, 5)])
def test_twin_matches_pallas_kernel(shape):
    x = _input(shape)
    ref = np.asarray(pallas_pool.max_pool_3x3_s2_pallas(jnp.asarray(x),
                                                         interpret=True))
    got = pool.max_pool_3x3_s2_auto(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(3, 37, 53, 24), (1, 1, 1, 4), (2, 2, 3, 1),
                                   (1, 7, 2, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_twin_matches_reduce_window_and_max_pool2d(shape, dtype):
    """Odd and tiny maps too: the port has no even-size limit."""
    x = torch.from_numpy(_input(shape, seed=1)).to(dtype)
    got = pool.max_pool_3x3_s2_auto(x)
    assert got.dtype == dtype and got.is_contiguous()
    assert tuple(got.shape) == (shape[0], (shape[1] + 1) // 2,
                                (shape[2] + 1) // 2, shape[3])
    ref = _reduce_window(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    lib = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    assert torch.equal(got, lib)


def test_train_path_is_differentiable():
    """train=True is the plain differentiable path, as in the JAX
    function; its gradient matches reduce_window's where the window max is
    unique."""
    x = _input((1, 10, 10, 4), seed=2)
    x[np.isinf(x)] = 0.0
    t = torch.from_numpy(x).requires_grad_()
    out = pool.max_pool_3x3_s2_auto(t, train=True)
    out.sum().backward()
    ref = jax.grad(lambda v: jnp.sum(pallas_pool.max_pool_3x3_s2_auto(v, train=True)))(
        jnp.asarray(x))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(ref))
    assert torch.equal(out.detach(), pool.max_pool_3x3_s2_reference(t.detach()))


def test_dispatch_and_launch_count():
    x = torch.from_numpy(_input((1, 4, 4, 2)))
    before = pool.max_pool_3x3_s2_auto.launches
    pool.max_pool_3x3_s2_auto(x)
    assert pool.max_pool_3x3_s2_auto.launches == before   # CPU: the twin
    with pytest.raises(ValueError):
        pool.max_pool_3x3_s2_auto(x[0])
    with pytest.raises(ValueError):
        pool.max_pool_3x3_s2_auto(x.to("meta"))
