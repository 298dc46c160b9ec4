"""PyTorch port vs the JAX package: the optimizer (train/optim.py) against
the optax chain that the JAX `make_optimizer` builds, on the CPU.

Each of SGD, Adam, AdamW and RMSprop, in each of five set-ups (one group
with full decay; norm groups; frozen stages; global-norm clipping;
OneCycleLR with momentum cycling), takes five updates from the same
weights and the same seeded gradients (numpy, handed to both); every
parameter must agree with optax's after every update at rtol 1e-6
(atol 1e-7 for parameters that start at zero). The parameter groups
themselves (which tensors get `norm_weight_decay`, which are frozen) must
equal the JAX masks, mapped through utils/convert.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
from centernet_lightning_tpu.train import optim as j_optim

from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet
from centernet_lightning_torch.train import optim as t_optim
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import to_numpy_tree

TINY = {"num_classes": 3, "backbone": "resnet18", "backbone_config": {"width": 8},
        "neck": "FPN", "neck_config": {"out_channels": 8},
        "head_config": {"width": 8, "depth": 1}}
# steps stay small beside the weights (a step of lr x O(1) on weights of
# O(0.05)), so a rounding of the step, in float32 on both sides, stays
# inside rtol 1e-6 of the weight
SCHEDULE = dict(lr=1e-3, warmup_epochs=1, warmup_decay=0.1, max_epochs=4,
                steps_per_epoch=3)
SETUPS = {
    "plain": dict(weight_decay=1e-2, norm_weight_decay=None),
    "norm_groups": dict(weight_decay=1e-2, norm_weight_decay=1e-3),
    "frozen": dict(weight_decay=1e-2, norm_weight_decay=0.0, frozen_stages=2),
    # the tested tensors' gradient norm is about 57: clipped to 0.35 of it
    "clip": dict(weight_decay=1e-2, gradient_clip_val=20.0),
    "onecycle": dict(weight_decay=1e-2, lr_scheduler={
        "name": "OneCycleLR", "params": {"max_lr": 1e-3, "total_steps": 8}}),
}


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the port's model), the same weights: seeded draws in
    the shapes of the JAX model's parameter tree (traced, not run)."""
    shapes = jax.eval_shape(lambda key: JCenterNet(**TINY).init(
        key, image_size=(32, 32)), jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(scale=0.05, size=s.shape).astype(np.float32), shapes)
    task = TCenterNet(**TINY)
    state = variables_to_state_dict({"params": params})
    task.model.load_state_dict(state, strict=False)
    return params, task.model


def _to_torch(tree):
    return variables_to_state_dict({"params": tree})


def _every_third(params):
    """Every third leaf of the tree, nested as before: the update tests
    keep a third of the tensors (every group among them) so that the
    optax chain compiles fast."""
    out = {}
    for i, (path, leaf) in enumerate(jax.tree_util.tree_leaves_with_path(params)):
        if i % 3:
            continue
        node = out
        for key in path[:-1]:
            node = node.setdefault(key.key, {})
        node[path[-1].key] = leaf
    return out


def test_param_groups_match_jax_masks(pair):
    params, model = pair
    for frozen_stages in (0, 1, 3):
        codes = {"main": 0.0, "norm": 1.0, "frozen": 2.0}

        def label(path, leaf):
            if j_optim._is_frozen_param(path, frozen_stages):
                return np.full(np.shape(leaf), codes["frozen"], np.float32)
            return np.full(np.shape(leaf),
                           codes["norm" if j_optim._is_norm_param(path) else "main"],
                           np.float32)

        ref = _to_torch(jax.tree_util.tree_map_with_path(label, params))
        got = t_optim.param_labels(model, frozen_stages)
        assert set(got) == set(ref)
        for name, lab in got.items():
            assert codes[lab] == float(ref[name].reshape(-1)[0]), (name, frozen_stages)
        assert sum(v == "norm" for v in got.values()) > 10
        assert (sum(v == "frozen" for v in got.values()) > 0) == (frozen_stages > 0)


@pytest.mark.parametrize("setup", list(SETUPS))
@pytest.mark.parametrize("name", ["SGD", "Adam", "AdamW", "RMSprop"])
def test_updates_match_optax(pair, name, setup):
    params, model = pair
    params = _every_third(params)
    kw = dict(SCHEDULE, optimizer=name, **SETUPS[setup])
    tx = j_optim.make_optimizer(params, **kw)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    port_params = {k: v.clone() for k, v in _to_torch(params).items()}
    port = t_optim.make_optimizer(model, **kw)
    rng = np.random.default_rng([list(SETUPS).index(setup), len(name)])
    j_params = params
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=np.shape(p)).astype(np.float32), params)
        if setup == "clip":
            norm = np.sqrt(sum(float((g ** 2).sum())
                               for g in jax.tree_util.tree_leaves(grads)))
            assert 40 < norm < 80
        updates, opt_state = update(grads, opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        # frozen parameters take zero updates whatever their gradient
        port.update(port_params, _to_torch(grads))
        ref = _to_torch(to_numpy_tree(j_params))
        for key, p in port_params.items():
            np.testing.assert_allclose(p.numpy(), ref[key].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{key} step {step}")
    assert port.count == 5
    assert {port.labels[k] for k in port_params} >= (
        {"main", "norm", "frozen"} if setup == "frozen" else {"main"})


def test_frozen_parameters_do_not_move(pair):
    params, model = pair
    port_params = {k: v.clone() for k, v in _to_torch(params).items()}
    before = {k: v.clone() for k, v in port_params.items()}
    port = t_optim.make_optimizer(model, optimizer="AdamW", frozen_stages=4,
                                  weight_decay=0.5, **SCHEDULE)
    port.update(port_params, {k: torch.ones_like(v) for k, v in port_params.items()})
    for key, lab in port.labels.items():
        assert torch.equal(port_params[key], before[key]) == (lab == "frozen"), key
    assert all(lab == "frozen" for k, lab in port.labels.items()
               if k.startswith("backbone."))


def test_multisteps_matches_optax(pair):
    """Gradient accumulation: optax.MultiSteps(k=3) over seven micro-steps."""
    params, model = pair
    params = _every_third(params)
    kw = dict(SCHEDULE, optimizer="AdamW", weight_decay=1e-2)
    tx = optax.MultiSteps(j_optim.make_optimizer(params, **kw), every_k_schedule=3)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    port_params = {k: v.clone() for k, v in _to_torch(params).items()}
    port = t_optim.MultiSteps(t_optim.make_optimizer(model, **kw), 3)
    rng = np.random.default_rng(5)
    j_params = params
    for step in range(7):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=np.shape(p)).astype(np.float32), params)
        updates, opt_state = update(grads, opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        port.update(port_params, _to_torch(grads))
        ref = _to_torch(to_numpy_tree(j_params))
        for key, p in port_params.items():
            np.testing.assert_allclose(p.numpy(), ref[key].numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{key} step {step}")
    assert port.inner.count == 2 and port.mini_step == 1


@pytest.mark.parametrize("cfg", [
    {},
    {"lr": 0.2, "warmup_epochs": 1, "warmup_decay": 0.5},
    {"lr_scheduler": {"name": "OneCycleLR", "params": {
        "total_steps": 40, "anneal_strategy": "linear", "three_phase": True}}},
], ids=["defaults", "warmup", "onecycle_three_phase"])
def test_schedules_match_jax(cfg):
    ref = j_optim.schedule_from_config(cfg, max_epochs=4, steps_per_epoch=10)
    got = t_optim.schedule_from_config(cfg, max_epochs=4, steps_per_epoch=10)
    for step in range(0, 45, 3):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6)
    if "lr_scheduler" in cfg:
        j_fns = j_optim.resolve_schedules(0.05, 4, 10, lr_scheduler=cfg["lr_scheduler"])
        t_fns = t_optim.resolve_schedules(0.05, 4, 10, lr_scheduler=cfg["lr_scheduler"])
        for step in range(0, 45, 3):
            np.testing.assert_allclose(t_fns[1](step), float(j_fns[1](jnp.int32(step))),
                                       rtol=1e-6)
