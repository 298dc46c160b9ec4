"""PyTorch port: validation inside the Trainer, against the JAX package's
Trainer, on the CPU (ResNet-18 width 16, 64^2 images, 3 batches).

- `validate_detection` and `validate_tracking` of both Trainers fed the
  same detections through a stubbed eval step: metrics equal (==). The
  port's loop runs one batch deep: the next batch's eval step is queued
  before the previous batch is scored.
- Both Trainers on the same weights (`utils/convert.py`) and the same
  in-memory batches, the ground truth drawn from the JAX model's own
  detections so the metrics are far from 0: metrics within 1e-4 abs.
- The cadence: `val_interval`, mid-epoch `val_check_interval` composed
  with it (the steps the JAX Trainer's tests expect), the `best/` checkpoint
  under `monitor_mode` max and min (one checkpoint kept), `best_metric`
  through resume; one tracker a sequence, reset at each sequence's start;
  `get_dataloader` from a task's `val_data` / `train_data`; the
  diagnostics option.
"""
import contextlib
import os

import jax
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
from centernet_lightning_tpu.models.fairmot import FairMOT as JFairMOT
from centernet_lightning_tpu.train.trainer import Trainer as JTrainer

import centernet_lightning_torch.train.trainer as trainer_mod
from centernet_lightning_torch.data import CollateDetection, CollateTracking, DataLoader
from centernet_lightning_torch.models.centernet import CenterNet
from centernet_lightning_torch.models.fairmot import FairMOT
from centernet_lightning_torch.models.tracker import Tracker
from centernet_lightning_torch.train import Trainer
from centernet_lightning_torch.train.checkpoint import load_checkpoint
from centernet_lightning_torch.utils.convert import variables_to_state_dict

import test_data as jax_data_tests
from _torch_port_helpers import random_flax_variables
from test_torch_port_data import assert_same

coco_dir = jax_data_tests.coco_dir

IMG = 64
SMALL = dict(num_classes=3, backbone="resnet18", backbone_config={"width": 16},
             neck="FPN", neck_config={"out_channels": 8},
             head_config={"width": 8, "depth": 1}, num_detections=12,
             image_size=(IMG, IMG))
TRACK = dict(SMALL, num_classes=1, reid_config={"emb_dim": 8, "max_track_ids": 8})
TRACKER = {"detection_threshold": 0.0, "min_birth_age": 1, "num_detections": 12}
OPT = {"optimizer": "Adam", "lr": 1e-3, "warmup_epochs": 0}
COCO_KEYS = {f"val/{k}" for k in ("mAP", "AP50", "AP75", "AP_small", "AP_medium",
                                  "AP_large", "AR1", "AR10", "mAR", "AR_small",
                                  "AR_medium", "AR_large")}


def port_trainer(task, val=None, train=None, **kw):
    args = dict(max_epochs=1, image_size=(IMG, IMG), device="cpu",
                optimizer_config=OPT, logger_config={"backends": []})
    args.update(kw)
    return Trainer(task, train_loader=train, val_loader=val, **args)


class OneDevice:
    """A stand-in train loader of batch size 1, so that the JAX Trainer
    builds a one-device mesh: tests/conftest.py gives JAX 8 CPU devices,
    and a batch that does not divide the mesh is replicated on all 8."""
    batch_size = 1

    def __len__(self):
        return 1


def jax_trainer(task, **kw):
    return JTrainer(task, train_loader=OneDevice(), max_epochs=1,
                    image_size=(IMG, IMG), diagnostics=False,
                    optimizer_config=OPT, logger_config={"backends": []}, **kw)


@pytest.fixture(scope="module")
def jax_det():
    """One JAX detection Trainer for the module (its construction compiles
    the model's initialisation); tests change it through `monkeypatch`."""
    return jax_trainer(JCenterNet(**SMALL))


@pytest.fixture(scope="module")
def jax_track():
    return jax_trainer(JFairMOT(**TRACK), tracker_config=TRACKER)


def count_steps_only(trainer):
    """Replace the trainer's train step by one that only counts steps:
    the validation cadence and the checkpoints depend on nothing else."""
    def step(state, batch):
        state.step += 1
        return state, {"total": torch.zeros(())}
    trainer.train_step = step


def _items(rng, n, tracking=False, seq=0):
    """n samples of bright rectangles on noise, xywh boxes, with crowds and
    areas (detection) or identities and a sequence (tracking)."""
    items = []
    for f in range(n):
        img = rng.integers(0, 60, (IMG, IMG, 3), dtype=np.uint8)
        k = int(rng.integers(1, 5))
        wh = rng.uniform(6, 24, (k, 2))
        xy = rng.uniform(0, IMG - wh)
        if tracking:        # k objects moving right a pixel a frame
            k, wh = 3, np.full((3, 2), 12.0)
            xy = np.array([[4.0 + f, 6.0], [30.0, 20.0 + f], [10.0 + f, 40.0]])
        for (x, y), (w, h) in zip(xy.astype(int), wh.astype(int)):
            img[y:y + h, x:x + w] = 230
        item = {"image": img,
                "bboxes": np.concatenate([xy, wh], 1).astype(np.float32),
                "labels": rng.integers(0, 1 if tracking else 3, k)}
        if tracking:
            item.update(ids=np.arange(k) + 10 * seq, sequence_id=seq)
        else:
            item.update(iscrowd=(rng.uniform(size=k) < 0.2).astype(np.int64),
                        area=(wh.prod(1) * 0.9).astype(np.float32))
        items.append(item)
    return items


def det_batches(seed=0, n_batches=3, batch=2):
    rng = np.random.default_rng(seed)
    collate = CollateDetection(8)
    return [collate(_items(rng, batch)) for _ in range(n_batches)]


def track_batches(seed=0, frames=(4, 2), batch=2):
    """Sequences of `frames` frames, in batches that may span two
    sequences."""
    rng = np.random.default_rng(seed)
    items = [it for s, n in enumerate(frames) for it in _items(rng, n, True, s)]
    collate = CollateTracking(8)
    return [collate(items[i:i + batch]) for i in range(0, len(items), batch)]


def stub_detections(batches, seed, embeddings=False, k=12):
    """Per batch, top-k-shaped detections near the ground truth: f32 xyxy
    boxes in input pixels, f32 scores, int32 labels (the decode's dtypes)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in batches:
        n = b["image"].shape[0]
        gt = np.where(b["mask"][..., None] > 0, b["boxes"], 0)[:, :k]
        boxes = np.concatenate([gt[..., :2], gt[..., :2] + gt[..., 2:]], -1)
        boxes = np.concatenate([boxes, np.zeros((n, k - boxes.shape[1], 4))], 1)
        noise = rng.normal(0, 1.5, boxes.shape)
        fill = rng.uniform(0, IMG - 12, (n, k, 2))
        rand = np.concatenate([fill, fill + rng.uniform(4, 12, (n, k, 2))], -1)
        real = (boxes[..., 2] > 0)[..., None]
        dets = {"boxes": np.where(real, boxes + noise, rand).astype(np.float32),
                "scores": np.sort(rng.uniform(0, 1, (n, k)))[:, ::-1].astype(np.float32),
                "labels": np.where(rng.uniform(size=(n, k)) < 0.8,
                                   np.pad(b["labels"][:, :k], ((0, 0), (0, k - b["labels"][:, :k].shape[1]))),
                                   rng.integers(0, 3, (n, k))).astype(np.int32)}
        if embeddings:
            ids = np.pad(b["ids"][:, :k], ((0, 0), (0, k - b["ids"][:, :k].shape[1])))
            basis = np.random.default_rng(1).normal(size=(64, 8))
            dets["embeddings"] = (basis[ids % 64] + rng.normal(0, 0.1, (n, k, 8))
                                  ).astype(np.float32)
            dets["labels"] = np.zeros((n, k), np.int32)
        out.append(dets)
    return out


def feed(trainer, dets, monkeypatch):
    """Replace the trainer's eval step by one that returns `dets` in order
    (as tensors to the port's Trainer)."""
    it = iter(dets)
    if isinstance(trainer, Trainer):
        step = lambda state, batch: {k: torch.from_numpy(v)
                                     for k, v in next(it).items()}
    else:
        step = lambda state, batch: next(it)
    monkeypatch.setattr(trainer, "eval_step", step)


# ---- identical detections: equal metrics --------------------------------------

def test_validate_detection_equals_jax_on_identical_detections(monkeypatch, jax_det):
    batches = det_batches()
    dets = stub_detections(batches, seed=1)
    events = []

    class Logged(trainer_mod.CocoEvaluator):
        def update(self, preds, targets):
            events.append("update")
            super().update(preds, targets)

    monkeypatch.setattr(trainer_mod, "CocoEvaluator", Logged)
    got_trainer = port_trainer(CenterNet(**SMALL), val=batches)
    feed(got_trainer, dets, monkeypatch)
    inner = got_trainer.eval_step
    got_trainer.eval_step = lambda s, b: (events.append("eval"), inner(s, b))[1]
    got = got_trainer.validate()
    monkeypatch.setattr(jax_det, "val_loader", batches)
    feed(jax_det, dets, monkeypatch)
    ref = jax_det.validate()
    assert got == ref
    assert set(got) == COCO_KEYS and got["val/AP50"] > 0.3
    # one batch deep: batch i + 1 is queued before batch i is scored
    assert events == ["eval", "eval", "update", "eval", "update", "update"]
    assert got_trainer.val_stats["batches"] == 3
    assert got_trainer.val_stats["images"] == 6


def test_validate_tracking_equals_jax_on_identical_detections(monkeypatch, jax_track):
    batches = track_batches(frames=(5, 3))   # batch 2 spans both sequences
    dets = stub_detections(batches, seed=2, embeddings=True)
    got_trainer = port_trainer(FairMOT(**TRACK), val=batches, tracker_config=TRACKER)
    feed(got_trainer, dets, monkeypatch)
    monkeypatch.setattr(jax_track, "val_loader", batches)
    feed(jax_track, dets, monkeypatch)
    with pytest.warns(UserWarning, match="without a model"):
        got = got_trainer.validate()
    ref = jax_track.validate()
    assert got == ref
    assert set(got) == {f"val/{p}{m}" for p in ("", "seq0/", "seq1/")
                        for m in ("MOTA", "IDF1", "HOTA")}
    assert got["val/IDF1"] > 0.2


# ---- converted weights: metrics within 1e-4 ----------------------------------

def _converted_pair(jtrainer, ttrainer, seed, monkeypatch):
    variables = random_flax_variables(jtrainer.task, np.random.default_rng(seed),
                                      image_size=(IMG, IMG))
    # the heads' outputs scaled down, so scores stay apart instead of
    # saturating to ties, and boxes about 16 pixels wide (no two alike)
    for head in ("heads_heatmap", "heads_box_2d"):
        variables["params"][head]["out_conv"]["kernel"] *= 0.1
    variables["params"]["heads_box_2d"]["out_conv"]["bias"][:] = 2.0
    monkeypatch.setattr(jtrainer, "state", jtrainer.state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"]))
    ttrainer.state.model.load_state_dict(variables_to_state_dict(variables),
                                         strict=True)


def _ground_truth_from(detections, batches, tracking=False, top=4):
    """The batches with their ground truth replaced by the top detections
    (jittered by a pixel), so a model scores far from 0 on them."""
    rng = np.random.default_rng(9)
    out = []
    for b, d in zip(batches, detections):
        b = dict(b)
        xyxy = np.asarray(d["boxes"])[:, :top]
        xywh = np.concatenate([xyxy[..., :2], xyxy[..., 2:] - xyxy[..., :2]], -1)
        n = xywh.shape[0]
        b["boxes"] = (xywh + rng.normal(0, 1, xywh.shape)).astype(np.float32)
        b["labels"] = np.asarray(d["labels"])[:, :top].astype(np.int32)
        b["mask"] = np.ones((n, top), np.float32)
        if tracking:
            b["ids"] = np.tile(np.arange(top, dtype=np.int32), (n, 1))
        else:
            b["iscrowd"] = np.zeros((n, top), np.int32)
            b["area"] = (xywh[..., 2] * xywh[..., 3]).astype(np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("tracking", [False, True], ids=["detection", "tracking"])
def test_validation_on_converted_weights_matches_jax(tracking, request, monkeypatch):
    batches = track_batches(frames=(4, 2)) if tracking else det_batches()
    jt = request.getfixturevalue("jax_track" if tracking else "jax_det")
    tt = port_trainer((FairMOT(**TRACK) if tracking else CenterNet(**SMALL)),
                      val=batches)
    if tracking:
        # suppressed pixels score 0, and the decodes order such ties apart
        # (lax.top_k by index, torch.topk in no promised order): the
        # tracker takes no detection at 0
        tracker = dict(TRACKER, detection_threshold=0.01)
        monkeypatch.setattr(jt, "tracker_config", tracker)
        tt.tracker_config = tracker
    _converted_pair(jt, tt, seed=21, monkeypatch=monkeypatch)
    dets = [jax.device_get(jt.eval_step(jt.state, jt._shard(b))) for b in batches]
    batches = _ground_truth_from(dets, batches, tracking)
    monkeypatch.setattr(jt, "val_loader", batches)
    tt.val_loader = batches
    ref = jt.validate()
    with pytest.warns(UserWarning) if tracking else contextlib.nullcontext():
        got = tt.validate()
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        assert abs(got[key] - value) <= 1e-4, (key, got[key], value)
    if tracking:
        assert ref["val/IDF1"] > 0.2
    else:
        assert ref["val/AP50"] > 0.2


# ---- cadence and the best checkpoint ----------------------------------------

class TrainLoader:
    """n fixed training batches an epoch."""

    def __init__(self, n=8):
        self.batches = det_batches(seed=3, n_batches=n)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _scripted(trainer, scores, monitor="val/mAP"):
    """Replace validate() by one that returns `scores` in turn, and record
    the step of each call."""
    steps, it = [], iter(scores)
    trainer.validate = lambda: (steps.append(trainer.state.step),
                                {monitor: next(it)})[1]
    return steps


@pytest.mark.parametrize("vci,val_interval,epochs,expected", [
    (0.5, 1, 1, [4, 8]), (0.25, 1, 1, [2, 4, 6, 8]), (3, 1, 1, [3, 6]),
    (1.0, 1, 2, [8, 16]), (None, 2, 4, [16, 32]), (0.5, 2, 2, [12, 16])])
def test_validation_cadence(vci, val_interval, epochs, expected, tmp_path):
    """The steps at which the JAX Trainer validates (the cases of
    tests/test_frozen_and_necks.py: 8 batches an epoch)."""
    loader = TrainLoader()
    trainer = port_trainer(CenterNet(**SMALL), val=loader, train=loader,
                           max_epochs=epochs, val_interval=val_interval,
                           val_check_interval=vci, ckpt_dir=str(tmp_path / "t"))
    count_steps_only(trainer)
    steps = _scripted(trainer, [float(i) for i in range(1, 9)])
    trainer.fit()
    assert steps == expected
    assert trainer.best_metric == float(len(expected))


@pytest.mark.parametrize("mode,scores,best_epoch", [
    ("max", [0.3, 0.5, 0.4], 2), ("min", [0.5, 0.3, 0.4], 2),
    ("max", [0.1, 0.2, 0.3], 3)])
def test_best_checkpoint(mode, scores, best_epoch, tmp_path):
    loader = TrainLoader(2)
    trainer = port_trainer(CenterNet(**SMALL), val=loader, train=loader,
                           max_epochs=3, monitor_mode=mode,
                           ckpt_dir=str(tmp_path))
    count_steps_only(trainer)
    _scripted(trainer, scores)
    trainer.fit()
    best = sorted(os.listdir(tmp_path / "best"))
    assert best == ["hparams.json", f"step_{2 * best_epoch}"]
    state, hparams = load_checkpoint(str(tmp_path / "best"))
    assert state["epoch"] == best_epoch and hparams["num_classes"] == 3
    assert state["best_metric"] == trainer.best_metric == \
        (max(scores) if mode == "max" else min(scores))
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == \
        ["step_2", "step_4", "step_6"]


def test_best_metric_survives_resume(tmp_path):
    loader = TrainLoader(2)
    first = port_trainer(CenterNet(**SMALL), val=loader, train=loader,
                         max_epochs=2, ckpt_dir=str(tmp_path))
    count_steps_only(first)
    _scripted(first, [0.3, 0.5])
    first.fit()
    resumed = port_trainer(CenterNet(**SMALL), val=loader, train=loader,
                           max_epochs=4, ckpt_dir=str(tmp_path))
    assert resumed.start_epoch == 2 and resumed.best_metric == 0.5
    count_steps_only(resumed)
    _scripted(resumed, [0.4, 0.6])
    resumed.fit()
    state, _ = load_checkpoint(str(tmp_path / "best"))
    assert state["epoch"] == 4 and state["best_metric"] == 0.6
    # epoch 3's worse score did not replace the best checkpoint of epoch 2:
    # only one best checkpoint exists, the newest improvement's
    assert sorted(os.listdir(tmp_path / "best")) == ["hparams.json", "step_8"]


def test_validation_without_monitor_key_saves_no_best(tmp_path):
    loader = TrainLoader(2)
    trainer = port_trainer(CenterNet(**SMALL), val=loader, train=loader,
                           ckpt_dir=str(tmp_path), monitor="val/HOTA")
    count_steps_only(trainer)
    _scripted(trainer, [0.5])
    trainer.fit()
    assert not os.path.exists(tmp_path / "best")


def test_fit_validates_for_real_and_logs(tmp_path):
    """An unscripted fit: train steps, then COCO validation on the EMA
    weights, `val/*` in the metrics log, the best checkpoint written."""
    import json

    batches = det_batches(seed=4)
    trainer = port_trainer(CenterNet(**SMALL), val=batches, train=batches,
                           max_epochs=2, ckpt_dir=str(tmp_path / "ckpt"),
                           log_dir=str(tmp_path / "logs"), ema_decay=0.9,
                           log_every=1, monitor="val/AR10")
    trainer.fit()
    rows = [json.loads(r) for r in open(tmp_path / "logs" / "metrics.jsonl")]
    val_rows = [r for r in rows if "val/mAP" in r]
    assert [r["step"] for r in val_rows] == [3, 6]
    assert set(val_rows[0]) - {"step", "time"} == COCO_KEYS
    assert os.path.isdir(tmp_path / "ckpt" / "best")
    assert trainer.state.model.training is False     # left by the eval step
    trainer.train_step(trainer.state, {k: torch.as_tensor(v) for k, v in
                                       batches[0].items()})
    assert trainer.state.model.training is True


# ---- tracking validation (tests/test_tracking_validation.py, on the port) ----

def test_validate_tracking_runs_and_scores():
    trainer = port_trainer(FairMOT(**TRACK), val=track_batches(frames=(4,)),
                           tracker_config=TRACKER)
    with pytest.warns(UserWarning, match="without a model"):
        metrics = trainer.validate()
    assert set(metrics) == {"val/MOTA", "val/IDF1", "val/HOTA"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert 0.0 <= metrics["val/IDF1"] <= 1.0 and 0.0 <= metrics["val/HOTA"] <= 1.0


def test_validate_tracking_resets_at_sequence_boundaries(monkeypatch):
    events, seen = [], {}

    class SpyTracker(Tracker):
        def reset(self):
            events.append("reset")
            super().reset()

        def update(self, *a, **k):
            events.append("update")
            out = super().update(*a, **k)
            # the Track objects alive in each sequence (the resets count it)
            seen.setdefault(events.count("reset"), set()).update(self.tracks)
            return out

    monkeypatch.setattr(trainer_mod, "Tracker", SpyTracker)
    trainer = port_trainer(FairMOT(**TRACK), val=track_batches(frames=(2, 2)),
                           tracker_config=TRACKER)
    with pytest.warns(UserWarning):
        metrics = trainer.validate()
    assert events == ["reset", "update", "update", "reset", "update", "update"]
    assert seen[1] and seen[2] and not seen[1] & seen[2]
    assert {f"val/seq{s}/{m}" for s in (0, 1) for m in ("MOTA", "IDF1", "HOTA")} \
        <= set(metrics)
    assert trainer.val_stats["batches"] == 2


def test_batches_without_sequence_id_are_one_sequence(monkeypatch):
    batches = [{k: v for k, v in b.items() if k != "sequence_id"}
               for b in track_batches(frames=(3, 3))]
    dets = stub_detections(batches, seed=5, embeddings=True)
    trainer = port_trainer(FairMOT(**TRACK), val=batches, tracker_config=TRACKER)
    feed(trainer, dets, monkeypatch)
    with pytest.warns(UserWarning):
        metrics = trainer.validate()
    assert set(metrics) == {"val/MOTA", "val/IDF1", "val/HOTA"}


# ---- the rest ----------------------------------------------------------------

def test_get_dataloader_equals_jax(coco_dir):
    img_dir, ann = coco_dir
    data = {"type": "coco", "img_dir": img_dir, "ann_json": ann,
            "transforms": [{"name": "Resize", "init_args": {"height": 64, "width": 64}},
                           {"name": "HorizontalFlip"}],
            "batch_size": 2, "num_workers": 0, "max_boxes": 8}
    cfg = dict(SMALL, train_data=data, val_data=dict(data, batch_size=3))
    got_task, ref_task = CenterNet(**cfg), JCenterNet(**cfg)
    for train in (True, False):
        got, ref = got_task.get_dataloader(train), ref_task.get_dataloader(train)
        assert (got.batch_size, got.shuffle) == (ref.batch_size, ref.shuffle) == \
            ((2, True) if train else (3, False))
        assert_same(list(got), list(ref), f"train={train}")
    with pytest.raises(ValueError, match="no train_data"):
        CenterNet(**SMALL).get_dataloader(False)


def test_port_loader_feeds_validation(coco_dir):
    """The port's own builder and threaded loader into validate()."""
    img_dir, ann = coco_dir
    data = {"type": "coco", "img_dir": img_dir, "ann_json": ann,
            "transforms": [{"name": "Resize", "init_args": {"height": 64, "width": 64}}],
            "batch_size": 3, "num_workers": 2}
    task = CenterNet(**dict(SMALL, val_data=data))
    loader = task.get_dataloader(train=False)
    assert isinstance(loader, DataLoader) and loader.num_workers == 2
    metrics = port_trainer(task, val=loader).validate()
    assert set(metrics) == COCO_KEYS
    assert all(np.isfinite(v) for v in metrics.values())


def test_diagnostics_option():
    with pytest.raises(NotImplementedError, match="item 3"):
        port_trainer(CenterNet(**SMALL), diagnostics=True)
