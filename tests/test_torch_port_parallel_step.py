"""PyTorch port: the data-parallel train step (parallel/dist.py) against the
JAX package's step on the global batch, on the CPU.

Two gloo ranks (tests/_torch_port_parallel_worker.py, a FileStore in
tmp_path) each take one f32 step on 2 of 4 images; the JAX package takes
its single-device step on all 4 from the same weights (utils/convert.py).
The halves differ in box counts (rank 1's images have none) and in image
statistics (dark against bright), so a loss normalised by a rank's own
counts or a BatchNorm over a rank's own images gives another step.

Held at the tolerances of the single-process step tests
(test_torch_port_train.py, test_torch_port_reid.py): losses rtol 1e-5
(FairMOT 1e-4), every parameter and BatchNorm statistic rtol 1e-4 within
1e-4 of its largest magnitude; for SGD also the update itself (after -
before) at the same tolerances (or, where larger, the f32 spacing of the
tensor's largest weight, which bounds how well an update can be read back
from f32 weights), and the two ranks' weights bitwise equal.
Each case also runs with per-rank normalisers and with per-rank BatchNorm,
and each of those must miss the same tolerances.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
from centernet_lightning_tpu.models.fairmot import FairMOT as JFairMOT
from centernet_lightning_tpu.train.optim import make_optimizer as j_make
from centernet_lightning_tpu.train.state import TrainState as JState
from centernet_lightning_tpu.train.state import make_train_step as j_step

from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import (TRAIN_CFG, TRAIN_OPT, detection_batch,
                                 random_flax_variables, to_numpy_tree)
from test_torch_port_parallel import run_ranks

VARIANTS = ("global", "local_norm", "local_bn")
REID = {"emb_dim": 16, "max_track_ids": 40, "width": 16, "depth": 1}
CASES = {
    # one SGD step at the repo's default rate, the clip active: the
    # update is large enough to be compared itself
    "sgd": dict(cfg=TRAIN_CFG, fairmot=False, loss_rtol=1e-5,
                opt=dict(optimizer="SGD", lr=0.05, gradient_clip_val=1.0)),
    "adamw": dict(cfg=TRAIN_CFG, fairmot=False, loss_rtol=1e-5,
                  opt=dict(TRAIN_OPT["AdamW"], gradient_clip_val=1.0)),
    "fairmot_triplet": dict(
        cfg=dict(TRAIN_CFG, reid_config=dict(REID, loss_function="triplet"),
                 reid_loss_weight=0.5),
        fairmot=True, loss_rtol=1e-4, opt=dict(TRAIN_OPT["SGD"])),
}


def global_batch(rng, fairmot):
    """4 images: the first two dark with boxes, the last two bright with
    none (their rows all masked)."""
    batch = detection_batch(rng, n=4)
    batch["image"][:2] //= 2
    batch["image"][2:] = 128 + batch["image"][2:] // 2
    batch["mask"][2:] = 0.0
    if fairmot:   # 5 identities over the valid boxes: triplets exist
        batch["ids"] = rng.integers(0, 5, batch["labels"].shape).astype(np.int32)
    return batch


def jax_step(case, variables, batch):
    jtask = (JFairMOT if case["fairmot"] else JCenterNet)(**case["cfg"])
    tx = j_make(variables["params"], **case["opt"])
    state = JState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                   batch_stats=variables["batch_stats"],
                   opt_state=tx.init(variables["params"]), tx=tx)
    state, losses = j_step(jtask, donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = variables_to_state_dict({"params": to_numpy_tree(state.params),
                                   "batch_stats": to_numpy_tree(state.batch_stats)})
    return ref, {k: float(v) for k, v in losses.items()}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """Every case's JAX reference and the two ranks' results."""
    tmp = tmp_path_factory.mktemp("steps")
    inputs, refs = {}, {}
    for i, (name, case) in enumerate(CASES.items()):
        rng = np.random.default_rng(200 + i)
        jtask = (JFairMOT if case["fairmot"] else JCenterNet)(**case["cfg"])
        variables = random_flax_variables(jtask, rng)
        batch = global_batch(rng, case["fairmot"])
        opt = dict(case["opt"], weight_decay=1e-3, norm_weight_decay=0.0,
                   warmup_epochs=1, warmup_decay=0.1, max_epochs=3,
                   steps_per_epoch=2)
        case = dict(case, opt=opt)
        refs[name] = (variables_to_state_dict(variables),
                      *jax_step(case, variables, batch))
        inputs[name] = dict(cfg=case["cfg"], fairmot=case["fairmot"], opt=opt,
                            state_dict=refs[name][0], batch=batch,
                            variants=VARIANTS)
    torch.save(inputs, tmp / "steps_in.pt")
    return refs, run_ranks("steps", tmp)


def compare(got, start, ref, ref_losses, loss_rtol, updates):
    for key in ("heatmap", "box_2d", "total") + (("reid",) if "reid" in ref_losses else ()):
        np.testing.assert_allclose(got["losses"][key], ref_losses[key],
                                   rtol=loss_rtol, err_msg=f"{key} loss")
    state = got["state"]
    for key, value in ref.items():
        if key.endswith("num_batches_tracked"):
            continue
        ref_a = value.numpy()
        np.testing.assert_allclose(state[key].numpy(), ref_a, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref_a).max()),
                                   err_msg=key)
        if updates:
            # an update read back from f32 weights is known to the weights'
            # own spacing at best
            du = (value - start[key]).numpy()
            np.testing.assert_allclose(
                (state[key] - start[key]).numpy(), du, rtol=1e-4,
                atol=max(1e-4 * float(np.abs(du).max()),
                         float(np.spacing(np.abs(ref_a).max()))),
                err_msg=f"update of {key}")


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_matches_jax_global_batch(name, steps):
    refs, ranks = steps
    start, ref, ref_losses = refs[name]
    case = CASES[name]
    got = ranks[0][name, "global"]
    compare(got, start, ref, ref_losses, case["loss_rtol"], updates=name == "sgd")
    # the ranks hold the same weights and statistics after the step
    other = ranks[1][name, "global"]
    for key, value in got["state"].items():
        assert torch.equal(value, other["state"][key]), key
    assert got["losses"] == other["losses"]
    moved = [k for k, v in ref.items() if not torch.equal(got["state"][k], start[k])]
    assert len(moved) > len(ref) // 2
    if case["fairmot"]:
        assert ref_losses["reid"] > 0


@pytest.mark.parametrize("local", ["local_norm", "local_bn"])
@pytest.mark.parametrize("name", list(CASES))
def test_per_rank_statistics_miss_the_tolerance(name, local, steps):
    """The guard: the same step with a rank's own counts (and, FairMOT,
    its own triplet pairs) or with a rank's own BatchNorm statistics lands
    outside the tolerances the port meets."""
    refs, ranks = steps
    start, ref, ref_losses = refs[name]
    with pytest.raises(AssertionError):
        compare(ranks[0][name, local], start, ref, ref_losses,
                CASES[name]["loss_rtol"], updates=name == "sgd")
