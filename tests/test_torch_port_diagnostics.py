"""PyTorch port: the Trainer's diagnostics, its logger, its profiler trace
and its preemption stop, against the JAX package, on the CPU.

- utils/viz.py: `apply_mpl_cmap` (with and without matplotlib),
  `draw_heatmap`, `make_image_grid`, `render_heatmap_diagnostic` and
  `convert_bboxes_to_wandb` bitwise equal to the JAX package's on seeded
  inputs.
- The JAX package's own logger and diagnostic tests
  (tests/test_utils_misc.py's `test_metric_logger_histogram_and_boxes` and
  `test_diagnostic_failure_warns_once`, tests/test_logging_wandb.py), run
  against the port (`run_on_port`).
- The Trainer's target-heatmap grid and prediction diagnostics (grid,
  score histogram, box overlay) bitwise equal to the JAX Trainer's methods
  on the same batch and detections; the backbone's channel-mean maps
  within 1e-4 of their largest magnitude on weights converted by
  utils/convert.py; `param_count_report` equal to the JAX package's text.
- A SIGTERM after step k: a checkpoint at step k, a clean return, the old
  handler back, and a resume at that epoch; `profile=True` writes a trace.
"""
import collections
import json
import os
import signal
import sys
import types

import jax
import numpy as np
import pytest

import test_logging_wandb as jax_wandb_tests
import test_utils_misc as jax_misc_tests
from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
from centernet_lightning_tpu.models.meta import (
    param_count_report as j_param_count_report)
from centernet_lightning_tpu.train.trainer import Trainer as JTrainer
from centernet_lightning_tpu.utils import viz as j_viz

from centernet_lightning_torch.models.centernet import CenterNet
from centernet_lightning_torch.models.meta import param_count_report
from centernet_lightning_torch.train import Trainer
from centernet_lightning_torch.train.checkpoint import latest_checkpoint
from centernet_lightning_torch.utils import viz as t_viz
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import detection_batch, random_flax_variables, run_on_port

fake_wandb = jax_wandb_tests.fake_wandb

IMG = 64
SMALL = dict(num_classes=3, backbone="resnet18", backbone_config={"width": 16},
             neck="FPN", neck_config={"out_channels": 8},
             head_config={"width": 8, "depth": 1}, num_detections=12,
             image_size=(IMG, IMG))
OPT = {"optimizer": "Adam", "lr": 1e-3, "warmup_epochs": 0}
# the fields of the JAX train state that its feature diagnostic reads, as a
# pytree
JState = collections.namedtuple("JState", "params batch_stats")
LOGGER_MODULES = ("centernet_lightning_tpu.train.logging",
                  "centernet_lightning_tpu.train.trainer",
                  "centernet_lightning_tpu.utils.viz")


# ---- utils/viz.py -------------------------------------------------------

@pytest.fixture
def no_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)


@pytest.mark.parametrize("mpl", ["matplotlib", "fallback"])
@pytest.mark.parametrize("cmap", ["viridis", "jet"])
def test_apply_mpl_cmap_bitwise(request, mpl, cmap):
    if mpl == "fallback":
        request.getfixturevalue("no_matplotlib")
    rng = np.random.default_rng(1)
    for values in (rng.normal(size=(2, 9, 13)), np.full((5, 5), 0.3),
                   rng.uniform(-4, 4, (16, 12)).astype(np.float32)):
        a = j_viz.apply_mpl_cmap(values, cmap)
        b = t_viz.apply_mpl_cmap(values, cmap)
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(b, a)
    if mpl == "fallback":  # grayscale: the three channels equal
        assert (b[..., 0] == b[..., 2]).all()


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_draw_heatmap_and_grids_bitwise(kind):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (5, 40, 56, 3), dtype=np.uint8)
    if kind == "float":
        imgs = (imgs / 255.0 - 0.5).astype(np.float32)
    heat = rng.uniform(size=(5, 10, 14, 3)).astype(np.float32)
    for i in range(2):
        for hm in (heat[i], heat[i, ..., 0]):
            np.testing.assert_array_equal(
                t_viz.draw_heatmap(imgs[i], hm, alpha=0.4),
                j_viz.draw_heatmap(imgs[i], hm, alpha=0.4))
    tiles = [imgs[0], imgs[1, :30], rng.integers(0, 256, (20, 20), dtype=np.uint8)]
    for ncols in (1, 2, 4):
        np.testing.assert_array_equal(t_viz.make_image_grid(tiles, ncols=ncols),
                                      j_viz.make_image_grid(tiles, ncols=ncols))
    for pred in (None, heat[::-1]):
        np.testing.assert_array_equal(
            t_viz.render_heatmap_diagnostic(imgs, heat, pred, max_images=4),
            j_viz.render_heatmap_diagnostic(imgs, heat, pred, max_images=4))


def test_convert_bboxes_to_wandb_equal():
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0, 50, (4, 4))
    labels, scores = rng.integers(0, 3, 4), rng.uniform(size=4)
    for kw in (dict(), dict(labels=labels), dict(labels=labels, scores=scores,
                                                 class_names=["a", "b", "c"]),
               dict(scores=scores, normalized_boxes=False)):
        assert (t_viz.convert_bboxes_to_wandb(boxes, **kw)
                == j_viz.convert_bboxes_to_wandb(boxes, **kw))


# ---- the JAX package's logger and diagnostic tests, on the port ---------

@pytest.mark.parametrize("module,name", [
    (jax_misc_tests, "test_metric_logger_histogram_and_boxes"),
    (jax_misc_tests, "test_diagnostic_failure_warns_once"),
    (jax_wandb_tests, "test_wandb_backend_call_contract"),
    (jax_wandb_tests, "test_wandb_unavailable_falls_back"),
], ids=lambda x: getattr(x, "__name__", x))
def test_jax_logging_tests_on_port(module, name, request, monkeypatch):
    run_on_port(module, name, request, monkeypatch, LOGGER_MODULES)


# ---- the Trainer's diagnostics against the JAX Trainer's ---------------

class SpyLogger:
    """Records every logging call: (method, tag, value, step)."""

    def __init__(self):
        self.calls = []

    def log_image(self, tag, image, step):
        self.calls.append(("image", tag, np.asarray(image), step))

    def log_histogram(self, tag, values, step):
        self.calls.append(("histogram", tag, np.asarray(values), step))

    def log_boxes(self, tag, image, boxes, labels=None, scores=None, step=0,
                  class_names=None):
        self.calls.append(("boxes", tag, (np.asarray(image), np.asarray(boxes),
                                          np.asarray(labels),
                                          np.asarray(scores)), step))

    def close(self):
        pass


def port_trainer(**kw):
    args = dict(max_epochs=1, image_size=(IMG, IMG), device="cpu",
                optimizer_config=OPT, logger_config={"backends": []})
    args.update(kw)
    return Trainer(CenterNet(**SMALL), **args)


def jax_stand_in(task, **attrs):
    """An object that runs the JAX Trainer's diagnostic methods without a
    mesh or a compiled train step: the methods read only these fields."""
    ns = types.SimpleNamespace(task=task, logger=SpyLogger(), _diag_warned=False,
                               _feature_fn=None, **attrs)
    for name in ("_log_heatmap_diagnostic", "_log_prediction_diagnostic",
                 "_log_feature_diagnostic", "_warn_diagnostic_failure"):
        setattr(ns, name, types.MethodType(getattr(JTrainer, name), ns))
    return ns


def assert_same_calls(a, b):
    assert [c[:2] for c in a] == [c[:2] for c in b]
    for ca, cb in zip(a, b):
        assert ca[3] == cb[3], ca[1]
        va = ca[2] if isinstance(ca[2], tuple) else (ca[2],)
        vb = cb[2] if isinstance(cb[2], tuple) else (cb[2],)
        for x, y in zip(va, vb):
            np.testing.assert_array_equal(y, x, err_msg=ca[1])


def test_diagnostics_default_on():
    assert port_trainer().diagnostics is True


def test_heatmap_grid_bitwise_equal_jax():
    """The fit-start target-heatmap grid of the first train batch, through
    each package's render_heatmap: the same image."""
    batch = detection_batch(np.random.default_rng(4), n=5, k=8, size=IMG,
                            num_classes=3)
    ours = port_trainer()
    ours.logger = SpyLogger()
    theirs = jax_stand_in(JCenterNet(**SMALL))
    ours._log_heatmap_diagnostic(batch)
    theirs._log_heatmap_diagnostic(batch)
    assert not ours._diag_warned and not theirs._diag_warned
    assert ours.logger.calls[0][1] == "diagnostics/target_heatmap"
    assert ours.logger.calls[0][2].shape == (IMG, 4 * (IMG + 2) - 2, 3)
    assert_same_calls(theirs.logger.calls, ours.logger.calls)


def test_prediction_diagnostic_bitwise_equal_jax():
    """The first validation batch's overlay grid, score histogram and box
    overlay: the same calls with the same images and values."""
    rng = np.random.default_rng(5)
    batch = detection_batch(rng, n=3, k=8, size=IMG, num_classes=3)
    dets = {"boxes": rng.uniform(0, IMG, (3, 12, 4)).astype(np.float32),
            "scores": rng.uniform(size=(3, 12)).astype(np.float32),
            "labels": rng.integers(0, 3, (3, 12)).astype(np.int32)}
    ours = port_trainer()
    ours.logger = SpyLogger()
    ours._log_feature_diagnostic = lambda *a: None
    theirs = jax_stand_in(JCenterNet(**SMALL))
    theirs._log_feature_diagnostic = lambda *a: None
    ours._log_prediction_diagnostic(batch, dets, 7)
    theirs._log_prediction_diagnostic(batch, dets, 7)
    assert not ours._diag_warned and not theirs._diag_warned
    assert [c[1] for c in ours.logger.calls] == [
        "diagnostics/val_predictions", "diagnostics/det_scores",
        "diagnostics/val_boxes"]
    assert_same_calls(theirs.logger.calls, ours.logger.calls)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_backbone_feature_maps_match_jax(dtype):
    """The channel means of the backbone pyramid on converted weights,
    uint8 (normalised on the device) and float inputs: within 1e-4 of the
    largest magnitude; both packages log a grid of the same shape."""
    rng = np.random.default_rng(6)
    jtask = JCenterNet(**SMALL)
    variables = random_flax_variables(jtask, rng, image_size=(IMG, IMG))
    batch = detection_batch(rng, n=2, size=IMG, num_classes=3)
    if dtype == "float32":
        batch["image"] = rng.normal(size=batch["image"].shape).astype(np.float32)
    ours = port_trainer()
    ours.state.model.load_state_dict(variables_to_state_dict(variables),
                                     strict=True)
    ours.logger = SpyLogger()
    theirs = jax_stand_in(jtask, state=JState(variables["params"],
                                              variables["batch_stats"]))
    ours._log_feature_diagnostic(batch, 3)
    theirs._log_feature_diagnostic(batch, 3)
    ref = jax.device_get(theirs._feature_fn(theirs.state, batch["image"][:1]))
    got = ours._backbone_channel_means(batch["image"][:1])
    assert len(got) == len(ref) == 4
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * np.abs(r).max())
    assert ours.state.model.training          # the train mode is restored
    (_, tag, image, step), = ours.logger.calls
    assert tag == "diagnostics/backbone_features" and step == 3
    assert image.shape == theirs.logger.calls[0][2].shape


def test_param_count_report_equal_jax():
    jtask = JCenterNet(**dict(SMALL, extra_block={"name": "SPP"}))
    shapes = jax.eval_shape(lambda k: jtask.init(k, image_size=(IMG, IMG)),
                            jax.random.PRNGKey(0))
    ours = CenterNet(**dict(SMALL, extra_block={"name": "SPP"}))
    assert param_count_report(ours.model) == j_param_count_report(shapes)


# ---- fit: diagnostics, preemption, profile ------------------------------

@pytest.fixture
def one_thread():
    """Train on one intra-op thread (restored after the test): the test
    runs beside other test processes, and these steps are tiny."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class SignallingLoader:
    """Seeded batches; sends this process SIGTERM as it yields the
    `at`-th batch (counted over epochs)."""

    def __init__(self, batches, at=None):
        self.batches, self.at, self.count = batches, at, 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for batch in self.batches:
            self.count += 1
            if self.count == self.at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def test_sigterm_checkpoints_returns_and_resumes(tmp_path, one_thread):
    """A SIGTERM as the 2nd batch of the 2nd epoch is loaded: that step
    finishes, its checkpoint is written (epoch 1), fit returns, the handler
    from before fit is back; a new Trainer resumes at epoch 1, step 4, and
    runs the rest (the interrupted epoch again, then the last)."""
    rng = np.random.default_rng(7)
    batches = [detection_batch(rng, n=2, size=IMG, num_classes=3)
               for _ in range(3)]
    ckpt = str(tmp_path / "ckpt")
    prior = signal.getsignal(signal.SIGTERM)
    t1 = port_trainer(train_loader=SignallingLoader(batches, at=5),
                      max_epochs=3, ckpt_dir=ckpt, diagnostics=False)
    state = t1.fit()
    assert state.step == 5
    assert latest_checkpoint(ckpt).endswith("step_5")
    assert signal.getsignal(signal.SIGTERM) is prior
    t2 = port_trainer(train_loader=SignallingLoader(batches), max_epochs=3,
                      ckpt_dir=ckpt, diagnostics=False)
    assert t2.state.step == 5 and t2.start_epoch == 1
    assert t2.fit().step == 5 + 2 * 3
    assert latest_checkpoint(ckpt).endswith("step_11")


def test_fit_with_diagnostics_and_profile(tmp_path, one_thread):
    """fit with the defaults (diagnostics on) and `profile`: the report is
    printed, the target heatmap and the validation diagnostics reach the
    JSONL (the score histogram), and a Chrome trace of the first epoch is
    written under ckpt_dir/profile."""
    import contextlib
    import io

    rng = np.random.default_rng(8)
    batches = [detection_batch(rng, n=2, size=IMG, num_classes=3)]
    trainer = port_trainer(train_loader=batches, val_loader=batches,
                           max_epochs=2, ckpt_dir=str(tmp_path / "ckpt"),
                           log_dir=str(tmp_path / "logs"), profile=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer.fit()
    assert "backbone" in out.getvalue() and "heads_heatmap" in out.getvalue()
    traces = os.listdir(tmp_path / "ckpt" / "profile")
    assert traces == ["trace_step_1.json"]      # the first epoch only
    with open(tmp_path / "ckpt" / "profile" / traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    rows = [json.loads(line) for line in open(tmp_path / "logs" / "metrics.jsonl")]
    assert sum("diagnostics/det_scores/p50" in r for r in rows) == 2
    assert any("val/mAP" in r for r in rows)
    assert not trainer._diag_warned


def test_second_signal_escalates_and_threads_skip():
    """A second SIGTERM restores the handler from before and raises the
    signal again (here a recording handler, so the process lives); off
    the main thread nothing is installed."""
    import threading

    seen = []
    prior = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        trainer = port_trainer(diagnostics=False)
        previous = trainer._install_preemption_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert trainer._should_stop(1) and seen == []
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
        trainer._restore_signal_handlers(previous)
        from_thread = []
        t = threading.Thread(target=lambda: from_thread.append(
            trainer._install_preemption_handler()))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive() and from_thread == [{}]
    finally:
        signal.signal(signal.SIGTERM, prior)
