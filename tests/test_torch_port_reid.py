"""PyTorch port vs the JAX package: FairMOT's ReID parts on the CPU with
identical seeded numpy inputs and converted weights.

Tolerances: the classifier's logits and BatchNorm statistics rtol 1e-5 /
atol 1e-5 (f32 products summed in another order); the ReID losses rtol
1e-6 and their gradients rtol 1e-5 / atol 1e-7; centre indices exactly;
three SGD steps of a narrow FairMOT: losses within 1e-4 relative, every
tensor within rtol 1e-4 and 1e-4 of its largest magnitude (as
`train_step_parity` holds the detection model).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.fairmot import FairMOT as JFairMOT
from centernet_lightning_tpu.models.heads import ReIDClassifier as JClassifier
from centernet_lightning_tpu.ops import losses as j_losses
from centernet_lightning_tpu.train.optim import make_optimizer as j_make
from centernet_lightning_tpu.train.state import TrainState as JState
from centernet_lightning_tpu.train.state import make_train_step as j_step
from centernet_lightning_tpu.utils.torch_convert import (
    convert_centernet_checkpoint,
)

from centernet_lightning_torch.models.fairmot import FairMOT as TFairMOT
from centernet_lightning_torch.models.heads import ReIDClassifier as TClassifier
from centernet_lightning_torch.ops import losses as t_losses
from centernet_lightning_torch.train import optim as t_optim
from centernet_lightning_torch.train import state as t_state
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import (
    TRAIN_CFG, TRAIN_OPT, detection_batch, perturb_batch_norm,
    random_flax_variables, scoped_state_dict, to_numpy_tree,
)

REID = {"emb_dim": 16, "max_track_ids": 40, "width": 16, "depth": 1}
TOL = dict(rtol=1e-5, atol=1e-5)


def _classifier_pair(rng, m=24, e=16, ids=40):
    jc = JClassifier(ids)
    x = rng.normal(size=(m, e)).astype(np.float32)
    v = to_numpy_tree(jc.init(jax.random.PRNGKey(1), jnp.asarray(x), True))
    v = perturb_batch_norm(v, rng)
    tc = TClassifier(e, ids)
    tc.load_state_dict(scoped_state_dict(v, "classifier", "classifier."),
                       strict=True)
    return jc, v, tc, x


def test_classifier_forward_and_batch_norm_update():
    rng = np.random.default_rng(40)
    jc, v, tc, x = _classifier_pair(rng)
    ref, mutated = jc.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    tc.train()
    got = tc(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tc.bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), **TOL)
    np.testing.assert_allclose(tc.bn.running_var.numpy(),
                               np.asarray(stats["var"]), **TOL)
    # eval mode: the running statistics
    tc.eval()
    v2 = dict(v, batch_stats=to_numpy_tree(mutated["batch_stats"]))
    with torch.no_grad():
        got = tc(torch.from_numpy(x[:5]))
    ref = jc.apply(v2, jnp.asarray(x[:5]), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _loss_grads(j_fn, t_fn, x, *args):
    ref_v, ref_g = jax.value_and_grad(j_fn)(jnp.asarray(x), *map(jnp.asarray, args))
    t = torch.from_numpy(x).requires_grad_()
    got = t_fn(t, *(torch.from_numpy(a) for a in args))
    got.backward()
    return got.item(), t.grad.numpy(), float(ref_v), np.asarray(ref_g)


@pytest.mark.parametrize("masked", [False, True])
def test_reid_cross_entropy_loss(masked):
    rng = np.random.default_rng(41)
    logits = rng.normal(scale=3, size=(20, 30)).astype(np.float32)
    ids = rng.integers(0, 30, 20).astype(np.int32)
    mask = (rng.uniform(size=20) < 0.6).astype(np.float32)
    args = (ids, mask) if masked else (ids,)
    got, g, ref, rg = _loss_grads(j_losses.reid_cross_entropy_loss,
                                  t_losses.reid_cross_entropy_loss, logits, *args)
    assert got == pytest.approx(ref, rel=1e-6)
    np.testing.assert_allclose(g, rg, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("m,n_ids,masked", [(12, 3, False), (40, 3, True),
                                            (33, 8, True)])
def test_reid_triplet_loss(m, n_ids, masked):
    """Every valid triplet, averaged over the violating ones; at M = 40 the
    (anchor, positive) pairs span several chunks."""
    rng = np.random.default_rng(42 + m)
    emb = rng.normal(size=(m, 8)).astype(np.float32)
    ids = rng.integers(0, n_ids, m).astype(np.int32)
    mask = (rng.uniform(size=m) < 0.75).astype(np.float32)
    args = (ids, mask) if masked else (ids,)
    got, g, ref, rg = _loss_grads(j_losses.reid_triplet_loss,
                                  t_losses.reid_triplet_loss, emb, *args)
    assert ref > 0
    assert got == pytest.approx(ref, rel=1e-6)
    np.testing.assert_allclose(g, rg, rtol=1e-5, atol=1e-7)


def test_reid_triplet_loss_without_violations():
    """Identities on orthogonal axes: sim(a, p) = 1, sim(a, n) = 0, so no
    triplet violates the margin: the loss is 0 and so is its gradient."""
    emb = np.zeros((6, 4), np.float32)
    ids = np.array([0, 0, 1, 1, 2, 2], np.int32)
    emb[np.arange(6), ids] = [1.0, 2.0, 1.0, 3.0, 0.5, 1.0]
    got, g, ref, rg = _loss_grads(j_losses.reid_triplet_loss,
                                  t_losses.reid_triplet_loss, emb, ids)
    assert got == ref == 0.0
    np.testing.assert_array_equal(g, 0.0)
    np.testing.assert_array_equal(rg, 0.0)


def _fairmot_cfg(loss_function="ce"):
    return dict(TRAIN_CFG, reid_config=dict(REID, loss_function=loss_function),
                reid_loss_weight=0.5)


def test_reid_center_indices():
    cfg = _fairmot_cfg()
    jtask, ttask = JFairMOT(**cfg), TFairMOT(**cfg)
    rng = np.random.default_rng(43)
    boxes = rng.uniform(-20, 80, (3, 9, 4)).astype(np.float32)
    boxes[0, :3, :2] = [[-5.0, -3.0], [-0.3, 2.0], [63.9, 15.99]]
    boxes[0, :3, 2:] = 0.0          # centres at the corner, below 0, at 15.97
    ref = jtask.reid_center_indices({"boxes": jnp.asarray(boxes)}, 16, 16)
    got = ttask.reid_center_indices({"boxes": torch.from_numpy(boxes)}, 16, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32 and 0 <= got.min() and got.max() < 256


def _ids_batch(rng, n_ids=5):
    batch = detection_batch(rng)
    batch["ids"] = rng.integers(0, n_ids, batch["labels"].shape).astype(np.int32)
    return batch


@pytest.mark.parametrize("loss_function", ["ce", "triplet"])
def test_fairmot_train_steps_match_jax(loss_function):
    """Three SGD steps of a narrow FairMOT (ResNet-18, FPN-32, heads 32 x 1,
    ReID 16 x 1 -> 16 over 40 identities) from the same weights on the
    same batches with ids: the losses, the ReID loss included, and every
    parameter and BatchNorm statistic (the classifier's too) after the
    steps."""
    cfg = _fairmot_cfg(loss_function)
    opt = dict(TRAIN_OPT["SGD"], weight_decay=1e-3, norm_weight_decay=0.0,
               warmup_epochs=1, warmup_decay=0.1, max_epochs=3,
               steps_per_epoch=2)
    rng = np.random.default_rng(44)
    jtask = JFairMOT(**cfg)
    variables = random_flax_variables(jtask, rng)
    assert "classifier" in variables["params"]
    tx = j_make(variables["params"], **opt)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]), tx=tx)
    jstep = j_step(jtask, donate=False)

    ttask = TFairMOT(**cfg)
    model = ttask.model.to(memory_format=torch.channels_last)
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    tstate = t_state.TrainState(model=model,
                                tx=t_optim.make_optimizer(model, **opt))
    tstep = t_state.make_train_step(ttask)

    for step in range(3):
        batch = _ids_batch(rng)
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tl = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(jl["reid"]) > 0
        for key in ("heatmap", "box_2d", "reid", "total"):
            np.testing.assert_allclose(float(tl[key]), float(jl[key]), rtol=1e-4,
                                       err_msg=f"{key} loss, step {step}")

    ref = variables_to_state_dict({"params": to_numpy_tree(jstate.params),
                                   "batch_stats": to_numpy_tree(jstate.batch_stats)})
    start = variables_to_state_dict(variables)
    got = model.state_dict()
    moved = 0
    for key, value in ref.items():
        if key.endswith("num_batches_tracked"):
            continue
        ref_a = value.numpy()
        np.testing.assert_allclose(got[key].numpy(), ref_a, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref_a).max()),
                                   err_msg=key)
        moved += not torch.equal(got[key], start[key])
    assert moved > len(ref) // 2
    # the classifier's statistics move under either loss (it runs in the
    # forward); under "triplet" its weights move by the weight decay alone
    assert not torch.equal(got["classifier.fc2.weight"],
                           start["classifier.fc2.weight"])
    assert not torch.equal(got["classifier.bn.running_mean"],
                           start["classifier.bn.running_mean"])
    assert not torch.equal(got["heads.reid.out_conv.weight"],
                           start["heads.reid.out_conv.weight"])


def test_fairmot_bf16_step_through_functional_call():
    """The bf16 step runs train_forward through functional_call with cast
    parameters: the gradients come back f32 to every trained tensor, the
    classifier and the ReID head included, and the losses stay near the
    f32 step's from the same weights."""
    cfg = _fairmot_cfg()
    rng = np.random.default_rng(45)
    variables = random_flax_variables(JFairMOT(**cfg), rng)
    batch = {k: torch.from_numpy(v) for k, v in _ids_batch(rng).items()}
    losses = {}
    for dtype in (None, "bfloat16"):
        task = TFairMOT(**cfg)
        model = task.model.to(memory_format=torch.channels_last)
        model.load_state_dict(variables_to_state_dict(variables), strict=True)
        state = t_state.TrainState(model=model, tx=t_optim.make_optimizer(
            model, **TRAIN_OPT["SGD"], max_epochs=1, steps_per_epoch=1))
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        _, losses[dtype] = t_state.make_train_step(task, compute_dtype=dtype)(
            state, batch)
        for key in ("classifier.fc1.weight", "classifier.fc2.bias",
                    "heads.reid.out_conv.weight"):
            p = dict(model.named_parameters())[key]
            assert p.dtype == torch.float32
            assert not torch.equal(p, before[key]), key
    for key in ("reid", "total"):
        assert torch.isfinite(losses["bfloat16"][key])
        np.testing.assert_allclose(float(losses["bfloat16"][key]),
                                   float(losses[None][key]), rtol=0.05)


def test_converter_round_trip_reid_and_classifier():
    """JAX -> the port (strict load) -> the JAX package's structural
    torch->flax converter -> JAX: every leaf of `heads_reid` and
    `classifier` (Dense kernels transposed) comes back bitwise."""
    cfg = dict(num_classes=1, backbone="resnet18",
               backbone_config={"width": 8}, neck_config={"out_channels": 16},
               head_config={"width": 8, "depth": 1}, reid_config=REID)
    rng = np.random.default_rng(46)
    variables = perturb_batch_norm(to_numpy_tree(JFairMOT(**cfg).init(
        jax.random.PRNGKey(0), image_size=(64, 64))), rng)
    assert {"heads_reid", "classifier"} <= set(variables["params"])
    ttask = TFairMOT(**cfg)
    sd = variables_to_state_dict(variables)
    assert sd["classifier.fc2.weight"].shape == (40, 16)
    result = ttask.model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    back = convert_centernet_checkpoint(ttask.model.state_dict(), variables,
                                        backbone_arch="resnet18")
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(to_numpy_tree(back)))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_model_without_reid_refuses_classifier():
    task = TFairMOT(**TRAIN_CFG)
    assert task.reid_config == {"emb_dim": 64, "max_track_ids": 1000}
    from centernet_lightning_torch.models.centernet import CenterNet

    plain = CenterNet(**TRAIN_CFG)
    with pytest.raises(ValueError, match="classifier"):
        plain.model.classify_embeddings(torch.zeros(2, 64))
