"""PyTorch port vs the JAX package: `DeformableConvBlock` in train mode
(batch statistics), on the CPU with identical inputs and weights, against
the JAX block with `train=True`: the input and parameter gradients and the
updated BatchNorm statistics (flax's biased running variance), rtol 1e-4 /
atol 1e-5 (convolutions summed in another order). The bounded engines'
backward runs through the kernels' `autograd.Function`s
(test_torch_port_dcn_train.py). Offsets are continuous draws, so none sits
exactly on the clamp at +-d, where the frameworks' gradients differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models import layers as j_layers

from centernet_lightning_torch.models import layers as t_layers

from _torch_port_helpers import init_flax_dcn, nchw, scoped_state_dict

BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["dcn_fast_d1", "dcn_fused_d1", "dcn"])
def test_deformable_block_train_gradients_match_jax(name):
    rng = np.random.default_rng(90)
    x = rng.normal(size=(2, 6, 7, 5)).astype(np.float32)
    j = j_layers.CONV_BLOCKS[name](6, 3)
    v = init_flax_dcn(j, jnp.asarray(x), rng)
    t = t_layers.CONV_BLOCKS[name](5, 6, 3)
    t.load_state_dict(scoped_state_dict(v, "DeformableConvBlock_0", "blocks.0."),
                      strict=True)
    upstream = rng.normal(size=(2, 6, 7, 6)).astype(np.float32)

    def jloss(params, xx):
        out, mutated = j.apply({"params": params, "batch_stats": v["batch_stats"]},
                               xx, train=True, mutable=["batch_stats"])
        return jnp.sum(out * upstream), mutated["batch_stats"]

    (_, new_bs), (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        v["params"], jnp.asarray(x))
    t.train()
    xs = nchw(x).requires_grad_()
    out = t(xs).permute(0, 2, 3, 1)
    loss = (out * torch.from_numpy(upstream)).sum()
    names, params = zip(*t.named_parameters())
    grads = torch.autograd.grad(loss, [xs, *params])
    np.testing.assert_allclose(grads[0].permute(0, 2, 3, 1).numpy(), np.asarray(gx),
                               **BLOCK_TOL)
    ref = scoped_state_dict({"params": jax.tree_util.tree_map(np.asarray, gp),
                             "batch_stats": jax.tree_util.tree_map(np.asarray, new_bs)},
                            "DeformableConvBlock_0", "blocks.0.")
    for name_, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), ref[name_].numpy(), err_msg=name_,
                                   **BLOCK_TOL)
    for key in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(t.state_dict()[key].numpy(), ref[key].numpy(),
                                   err_msg=key, **BLOCK_TOL)
