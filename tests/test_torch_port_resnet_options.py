"""PyTorch port vs the JAX package: the ResNet options `stem_space_to_depth`
and `remat`, on the CPU with the same seeded numpy inputs and converted
weights.

- `stem_space_to_depth`: the port runs its plain 7x7 / s2 stem for it,
  which equals JAX's space-to-depth stem (a 4x4 stride-1 convolution over
  a 2x2 space-to-depth input, the same products summed in another order)
  and JAX's plain stem within rtol 1e-4 / atol 1e-4, at even and odd
  sizes.
- `remat`: one train-mode step of a width-16 ResNet-18 (forward with batch
  statistics, backward of a fixed loss) with each block checkpointed: the
  gradients and running statistics equal the step without remat (bitwise:
  the recompute runs the same arithmetic, and does not move the statistics
  a second time) and JAX's `nn.remat` step within rtol 1e-4 / atol 1e-4 of
  each tensor's largest magnitude; with `frozen_stages` equal to the plain
  step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.backbones import resnet as j_resnet

from centernet_lightning_torch.models.backbones import resnet as t_resnet
from centernet_lightning_torch.models.backbones import build_backbone

from _torch_port_helpers import (backbone_parity, nchw,
                                 random_module_variables, scoped_state_dict,
                                 to_numpy_tree)

TOL = dict(rtol=1e-4, atol=1e-4)


def _stems(x):
    """JAX's plain and space-to-depth stems and the port's stem (one plain
    convolution for either setting of the option), one kernel."""
    rng = np.random.default_rng(1)
    kernel = rng.normal(0, 0.1, (7, 7, x.shape[-1], 8)).astype(np.float32)
    ref = {s2d: np.asarray(j_resnet.StemConv(8, space_to_depth=s2d).apply(
        {"params": {"kernel": kernel}}, jnp.asarray(x))) for s2d in (False, True)}
    conv = t_resnet.StemConv(x.shape[-1], 8)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = conv(nchw(x).contiguous(memory_format=torch.channels_last))
    return ref, got.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(2, 16, 20, 3), (1, 14, 8, 5)])
def test_space_to_depth_stem_matches_plain_and_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ref, got = _stems(x)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 8)
    for s2d in (False, True):
        assert ref[s2d].shape == got.shape
        np.testing.assert_allclose(got, ref[s2d], **TOL)


@pytest.mark.parametrize("shape", [(2, 15, 20, 3), (1, 16, 9, 3)])
def test_space_to_depth_stem_odd_size_falls_back_bitwise(shape):
    """At an odd size JAX's space-to-depth stem is its plain conv,
    bitwise, and the port's stem is within TOL of it."""
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref, got = _stems(x)
    np.testing.assert_array_equal(ref[True], ref[False])
    np.testing.assert_allclose(got, ref[True], **TOL)


def test_space_to_depth_resnet_matches_jax():
    """A ResNet built with `stem_space_to_depth` against JAX's, and
    bitwise equal to the port's ResNet without the option."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 66, 70, 3)).astype(np.float32)
    j = j_resnet.resnet18(width=16, stem_space_to_depth=True)
    t = build_backbone("resnet18", width=16, stem_space_to_depth=True)
    backbone_parity(j, t, x, rng, jit=True)
    plain = build_backbone("resnet18", width=16)
    plain.load_state_dict(t.state_dict())
    xt = nchw(x).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        for a, b in zip(t.eval()(xt), plain.eval()(xt)):
            assert torch.equal(a, b)


def _loss_weights(features, rng):
    return [rng.normal(size=np.shape(f)).astype(np.float32) for f in features]


def _jax_step(j, variables, x, weights):
    def loss(params):
        feats, upd = j.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(x), train=True, mutable=["batch_stats"])
        value = sum(jnp.sum(f * w) for f, w in zip(feats, weights))
        return value, upd
    (_, upd), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    stats = scoped_state_dict({"params": variables["params"],
                               "batch_stats": to_numpy_tree(upd["batch_stats"])},
                              "backbone", "backbone.")
    return scoped_state_dict({"params": to_numpy_tree(grads)},
                             "backbone", "backbone."), stats


def _port_step(sd, x, weights, remat, frozen):
    t = build_backbone("resnet18", width=16, remat=remat, frozen_stages=frozen)
    t = t.to(memory_format=torch.channels_last)
    t.load_state_dict(sd, strict=True)
    t.train()
    feats = t(nchw(x).contiguous(memory_format=torch.channels_last))
    loss = sum((f.permute(0, 2, 3, 1) * torch.from_numpy(w)).sum()
               for f, w in zip(feats, weights))
    loss.backward()
    grads = {k: p.grad for k, p in t.named_parameters()}
    return grads, t.state_dict()


def test_remat_train_step_matches_plain_and_jax():
    rng = np.random.default_rng(4)
    # 48^2: layer4's batch statistics pool 8 values a channel (2 at 32^2,
    # too few to hold its running mean to 1e-4)
    x = rng.normal(size=(2, 48, 48, 3)).astype(np.float32)
    j = j_resnet.resnet18(width=16, remat=True)
    variables = random_module_variables(j, x, rng)
    feats = jax.eval_shape(j.apply, variables, jnp.asarray(x))
    weights = _loss_weights(feats, rng)
    ref_grads, ref_stats = _jax_step(j, variables, x, weights)
    sd = scoped_state_dict(variables, "backbone", "backbone.")
    plain_grads, plain_stats = _port_step(sd, x, weights, False, 0)
    grads, stats = _port_step(sd, x, weights, True, 0)
    moved = 0
    for key, value in stats.items():
        assert torch.equal(value, plain_stats[key]), key
        if "running" in key:
            ref = ref_stats[key].numpy()
            np.testing.assert_allclose(value.numpy(), ref, rtol=1e-4,
                                       atol=1e-4 * np.abs(ref).max(), err_msg=key)
            moved += not torch.equal(value, sd[key])
    assert moved == 40
    for key, g in grads.items():
        assert torch.equal(g, plain_grads[key]), key
        ref = ref_grads[key].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=key)
    # with frozen_stages (the frozen stages' non-remat step is held against
    # JAX's by test_torch_port_train_frozen*.py): remat equals plain
    # bitwise, the frozen stem and layer1 keep their statistics, and get
    # no gradient (detached, where JAX's are zeros)
    plain_grads, plain_stats = _port_step(sd, x, weights, False, 1)
    grads, stats = _port_step(sd, x, weights, True, 1)
    for key, value in stats.items():
        assert torch.equal(value, plain_stats[key]), key
    frozen = [k for k in stats if k.startswith(("bn1.", "layer1."))
              and "running" in k]
    assert len(frozen) == 10 and all(torch.equal(stats[k], sd[k]) for k in frozen)
    for key, g in grads.items():
        if key.startswith(("conv1.", "bn1.", "layer1.")):
            assert g is None and plain_grads[key] is None, key
        else:
            assert torch.equal(g, plain_grads[key]), key


def test_remat_is_training_only():
    """In eval, and without grad, the blocks run as plain calls: no
    checkpoint, the same outputs bitwise."""
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    a = build_backbone("resnet18", width=16, remat=True).eval()
    b = build_backbone("resnet18", width=16)
    b.load_state_dict(a.state_dict())
    b.eval()
    with torch.no_grad():
        for fa, fb in zip(a(x), b(x)):
            assert torch.equal(fa, fb)


def test_remat_in_the_bf16_train_step():
    """Through `make_train_step` in bf16, which calls the model with bf16
    copies of its weights through `functional_call`, gone from the module
    when the backward recomputes: the remat step's losses, gradients and
    statistics equal the plain step's bitwise."""
    from centernet_lightning_torch.models.centernet import CenterNet
    from centernet_lightning_torch.train.state import (TrainState,
                                                        make_train_step)

    from _torch_port_helpers import detection_batch

    class Keep:
        grads = None

        def update(self, params, grads):
            self.grads = grads

    batch = {k: torch.from_numpy(v) for k, v in
             detection_batch(np.random.default_rng(7), size=32).items()}
    out = {}
    for remat in (False, True):
        task = CenterNet(num_classes=3, backbone="resnet18",
                         backbone_config={"width": 16, "remat": remat},
                         neck_config={"out_channels": 16},
                         head_config={"width": 16, "depth": 1})
        task.init(torch.Generator().manual_seed(0))
        state = TrainState(model=task.model, tx=Keep())
        _, losses = make_train_step(task, compute_dtype="bfloat16")(state, batch)
        out[remat] = losses, state.tx.grads, task.model.state_dict()
    for a, b in zip(out[False], out[True]):
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k] is None and b[k] is None) or torch.equal(a[k], b[k]), k
