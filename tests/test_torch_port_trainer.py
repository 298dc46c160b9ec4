"""PyTorch port: the Trainer, checkpoints, metric logging, the eval step and
the train-mode forward of the API, on the CPU.

- `Trainer.fit` interrupted after its first epoch and resumed from the
  checkpoint ends bitwise equal to an uninterrupted run (weights, BatchNorm
  statistics, EMA, optimizer state, step), with gradient accumulation
  carried across the epoch boundary.
- What a checkpoint serves: `build_centernet` from the run directory (the
  EMA weights), `restore_partial`, `load_torch_checkpoint` and a
  torchvision-keyed `pretrained_backbone`.
- Against the JAX package, same weights and inputs: `make_eval_step` with
  EMA weights (detections as `assert_detections_match` compares them,
  rtol 1e-4 / atol 1e-4), the predictor's `__call__(train=True)` (outputs
  and updated BatchNorm statistics, rtol 1e-4 / atol 1e-4: convolutions
  summed in another order) and one bf16 train step (losses within 2e-2
  relative: the two frameworks round bf16 at other places).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from centernet_lightning_tpu import build_centernet as j_build
from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
from centernet_lightning_tpu.train.state import TrainState as JState
from centernet_lightning_tpu.train.state import make_eval_step as j_eval_step
from centernet_lightning_tpu.train.state import make_train_step as j_train_step

from centernet_lightning_torch import build_centernet as t_build
from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet
from centernet_lightning_torch.train import (Trainer, TrainState,
                                             make_eval_step, make_optimizer,
                                             make_train_step)
from centernet_lightning_torch.train.checkpoint import (latest_checkpoint,
                                                        restore_partial)
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import (assert_detections_match, detection_batch,
                                 random_flax_variables, to_numpy_tree)

# ResNet width 16: at width 8, training in channels_last corrupts the heap
# in this CPU build of torch, with torch's own BatchNorm2d too
SMALL = dict(num_classes=3, backbone="resnet18", backbone_config={"width": 16},
             neck="FPN", neck_config={"out_channels": 8},
             head_config={"width": 8, "depth": 1}, box_loss="GIoULoss",
             box_log=True, box_multiplier=4.0, image_size=(64, 64))
OPT = dict(optimizer="AdamW", lr=1e-3, weight_decay=1e-3, warmup_epochs=1,
           warmup_decay=0.1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [detection_batch(rng, n=2, k=4, size=64, num_classes=3)
            for _ in range(n)]


class _Interrupted(Exception):
    pass


class _StopAtEpoch:
    """A loader that raises when its `stop`-th epoch begins."""

    def __init__(self, batches, stop):
        self.batches, self.stop, self.epoch = batches, stop, 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        self.epoch += 1
        if self.epoch == self.stop:
            raise _Interrupted
        return iter(self.batches)


def _trainer(loader, **kw):
    args = dict(max_epochs=3, optimizer_config=OPT, image_size=(64, 64),
                seed=1, accumulate_grad_batches=2, ema_decay=0.9,
                device="cpu", log_every=1, logger_config={"backends": []})
    args.update(kw)
    return Trainer(TCenterNet(**SMALL), train_loader=loader, **args)


def test_fit_resume_equals_uninterrupted(tmp_path):
    batches = _batches()
    log_dir = tmp_path / "logs"
    # TensorBoard is left out: its import aborts a process that has
    # imported jaxlib; wandb, not installed here, is skipped with a warning
    with pytest.warns(UserWarning, match="wandb backend unavailable"):
        full_trainer = _trainer(batches, ckpt_dir=str(tmp_path / "full"),
                                log_dir=str(log_dir),
                                logger_config={"backends": ["wandb"]})
    full = full_trainer.fit()
    with pytest.raises(_Interrupted):
        _trainer(_StopAtEpoch(batches, 2), ckpt_dir=str(tmp_path / "cut")).fit()
    # three micro-steps: one update done, one gradient waiting in the
    # accumulator at the epoch boundary
    assert latest_checkpoint(str(tmp_path / "cut")).endswith("step_3")
    resumed_trainer = _trainer(batches, ckpt_dir=str(tmp_path / "cut"))
    assert resumed_trainer.start_epoch == 1
    resumed = resumed_trainer.fit()

    assert full.step == resumed.step == 9
    start = TCenterNet(**SMALL)
    start.init(torch.Generator().manual_seed(1))
    moved = 0
    got = resumed.model.state_dict()
    for key, value in full.model.state_dict().items():
        assert torch.equal(got[key], value), key
        moved += not torch.equal(value, start.model.state_dict()[key])
    assert moved > len(got) // 2
    for key, value in full.ema_params.items():
        assert torch.equal(resumed.ema_params[key], value), key
    a, b = full.tx.state_dict(), resumed.tx.state_dict()
    assert a["mini_step"] == b["mini_step"] == 1
    assert a["inner"]["count"] == b["inner"]["count"] == 4
    for key, slots in a["inner"]["slots"].items():
        for name, value in slots.items():
            assert torch.equal(b["inner"]["slots"][key][name], value)
    for key, value in a["acc"].items():
        assert torch.equal(b["acc"][key], value)

    lines = [json.loads(s) for s in open(log_dir / "metrics.jsonl")]
    assert [m["step"] for m in lines] == list(range(1, 10))
    for m in lines:
        assert np.isfinite(m["train/total_loss"])
        assert set(m) >= {"train/heatmap_loss", "train/box_2d_loss",
                          "train/images_per_sec", "train/lr"}
        np.testing.assert_allclose(
            m["train/lr"], float(full_trainer.lr_schedule(m["step"] // 2)),
            rtol=1e-6)


def test_checkpoint_serves_and_restores(tmp_path):
    trainer = _trainer(_batches(2), max_epochs=1, accumulate_grad_batches=1,
                       ckpt_dir=str(tmp_path / "run"))
    state = trainer.fit()
    run_dir = str(tmp_path / "run")
    hparams = json.load(open(os.path.join(run_dir, "hparams.json")))
    assert hparams["num_classes"] == 3 and hparams["image_size"] == [64, 64]

    # build_centernet from the run directory serves the EMA weights
    pred = t_build(run_dir, device="cpu")
    served = pred.model.state_dict()
    for key, value in state.ema_params.items():
        assert torch.equal(served[key], value), key
    assert not all(torch.equal(served[k], p)
                   for k, p in state.model.named_parameters())
    assert torch.equal(served["backbone.bn1.running_var"],
                       state.model.backbone.bn1.running_var)

    # fine-tuning onto five classes: all but the heatmap head's output conv
    other = TCenterNet(**dict(SMALL, num_classes=5))
    fresh = other.model.state_dict()
    restored = restore_partial(run_dir, fresh, verbose=False)
    for key, value in restored.items():
        same_shape = tuple(value.shape) == tuple(state.model.state_dict()[key].shape)
        source = state.model.state_dict()[key] if same_shape else fresh[key]
        assert torch.equal(value, source), key
    assert sum(not torch.equal(restored[k], fresh[k]) for k in fresh) > 10

    # a reference Lightning checkpoint: the `state_dict` nesting and the
    # `model.` prefix
    lightning = {"state_dict": {f"model.{k}": v
                                for k, v in state.model.state_dict().items()}}
    task = TCenterNet(**SMALL)
    task.load_torch_checkpoint(lightning)
    for key, value in state.model.state_dict().items():
        assert torch.equal(task.model.state_dict()[key], value)

    # a torchvision file: backbone keys plus the classifier, no batch counters
    tv = {k: v for k, v in state.model.backbone.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    tv["fc.weight"], tv["fc.bias"] = torch.zeros(10, 128), torch.zeros(10)
    torch.save(tv, tmp_path / "resnet18.pth")
    task = TCenterNet(**dict(SMALL, pretrained_backbone=str(tmp_path / "resnet18.pth")))
    task.init(torch.Generator().manual_seed(7))
    for key, value in tv.items():
        if not key.startswith("fc."):
            assert torch.equal(task.model.backbone.state_dict()[key], value), key
    with pytest.raises(RuntimeError, match="local path"):
        TCenterNet(**dict(SMALL, pretrained_backbone=True))


def test_trainer_options():
    batches = _batches(3)
    # validation is ported (tests/test_torch_port_validation.py), and the
    # image diagnostics (tests/test_torch_port_diagnostics.py), on by
    # default as in the JAX package
    assert _trainer(batches, val_loader=batches).val_loader is batches
    assert _trainer(batches).diagnostics is True
    assert _trainer(batches, diagnostics=False).diagnostics is False
    assert _trainer(batches, val_check_interval=0.5).val_check_steps == 1
    assert _trainer(batches, val_check_interval=2).val_check_steps == 2
    assert _trainer(batches, val_check_interval=1.0).val_check_steps is None
    with pytest.raises(ValueError, match="exceeds"):
        _trainer(batches, val_check_interval=4)


def _jax_pair(rng, cfg=SMALL):
    """(JAX task, variables, port task on the same weights)."""
    jtask = JCenterNet(**cfg)
    variables = random_flax_variables(jtask, rng)
    ttask = TCenterNet(**cfg)
    ttask.model.to(memory_format=torch.channels_last)
    ttask.model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return jtask, variables, ttask


def test_eval_step_matches_jax_with_ema():
    rng = np.random.default_rng(11)
    jtask, variables, ttask = _jax_pair(rng)
    # EMA weights apart from the live ones: the eval step must take them;
    # the heads' outputs scaled down, so scores stay apart instead of
    # saturating to ties at 1, and exp-decoded boxes stay finite-sized
    ema = jax.tree_util.tree_map(
        lambda p: (p * rng.uniform(0.95, 1.05, p.shape)).astype(np.float32),
        variables["params"])
    for head in ("heads_heatmap", "heads_box_2d"):
        ema[head]["out_conv"]["kernel"] *= 0.05
    tx = optax.sgd(0.1)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]), tx=tx, ema_params=ema)
    tstate = TrainState(model=ttask.model, tx=None, ema_params={
        k: v for k, v in variables_to_state_dict({"params": ema}).items()})
    batch = detection_batch(rng, n=2, k=4, size=64, num_classes=3)
    ref = j_eval_step(jtask, num_detections=20)(jstate, {"image": jnp.asarray(batch["image"])})
    got = make_eval_step(ttask, num_detections=20)(
        tstate, {"image": torch.from_numpy(batch["image"])})
    assert_detections_match({k: np.asarray(v) for k, v in ref.items()},
                            {k: v.numpy() for k, v in got.items()}, **TOL)


def test_call_train_mode_matches_jax():
    tiny = {"num_classes": 3, "backbone": "resnet18", "backbone_config": {"width": 16},
            "neck": "FPN", "neck_config": {"out_channels": 8},
            "head_config": {"width": 8, "depth": 1}, "image_size": [64, 64]}
    jp = j_build({"model": tiny})
    jp.variables = random_flax_variables(jp.task, np.random.default_rng(12))
    tp = t_build({"model": tiny}, device="cpu")
    tp.model.load_state_dict(variables_to_state_dict(jp.variables), strict=True)
    before = {k: v.clone() for k, v in tp.model.state_dict().items()}
    x = np.random.default_rng(13).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref_out, ref_mut = jp(jnp.asarray(x), train=True)
    got_out, got_mut = tp(x, train=True)
    for key in ("heatmap", "box_2d"):
        np.testing.assert_allclose(got_out[key].detach().numpy(),
                                   np.asarray(ref_out[key]), **TOL, err_msg=key)
    assert got_out["heatmap"].requires_grad
    ref_bs = variables_to_state_dict(to_numpy_tree(ref_mut))
    for key, value in ref_bs.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got_mut["batch_stats"][key].numpy(),
                                       value.numpy(), **TOL, err_msg=key)
    for key, value in tp.model.state_dict().items():
        assert torch.equal(value, before[key]), key
    assert not tp.model.training


def test_bf16_train_step_matches_jax_loosely():
    """bf16 compute with f32 master weights: the parameters, their updates
    and the BatchNorm statistics stay f32, and the losses agree with the
    JAX bf16 step to the precision bf16 allows."""
    rng = np.random.default_rng(14)
    jtask, variables, ttask = _jax_pair(rng)
    opt = dict(optimizer="SGD", lr=1e-3, weight_decay=1e-4, warmup_epochs=0,
               max_epochs=1, steps_per_epoch=2)
    from centernet_lightning_tpu.train.optim import make_optimizer as j_make

    tx = j_make(variables["params"], **opt)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                    batch_stats=variables["batch_stats"],
                    opt_state=tx.init(variables["params"]), tx=tx)
    tstate = TrainState(model=ttask.model, tx=make_optimizer(ttask.model, **opt))
    jstep = j_train_step(jtask, donate=False, compute_dtype="bfloat16")
    tstep = make_train_step(ttask, compute_dtype="bfloat16")
    start = {k: v.clone() for k, v in ttask.model.state_dict().items()}
    for _ in range(2):
        batch = detection_batch(rng, n=2, k=4, size=64, num_classes=3)
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tl = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("heatmap", "box_2d", "total"):
            assert tl[key].dtype == torch.float32
            np.testing.assert_allclose(float(tl[key]), float(jl[key]), rtol=2e-2,
                                       err_msg=key)
    for key, value in ttask.model.state_dict().items():
        if value.is_floating_point():
            assert value.dtype == torch.float32, key
    changed = [k for k, v in ttask.model.state_dict().items()
               if v.is_floating_point() and not torch.equal(v, start[k])]
    assert "backbone.bn1.running_var" in changed and "backbone.conv1.weight" in changed
