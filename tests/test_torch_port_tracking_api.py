"""PyTorch port vs the JAX package: the tracking API on the CPU, a narrow
FairMOT (ResNet-18 FPN-32, heads 32 x 1, 1 class, ReID 16 x 1 -> 16) with
the same weights, on 64 x 96 uint8 frames from a seed.

`gather_tracking2d`'s scores, normalised boxes and embeddings agree within
1e-4 (f32 convolutions summed in another order; top-k ties compared as
`assert_detections_match` describes). From the same decoded arrays the
two packages' trackers give identical frames, `track_stream` keeps its
contract at pipeline depths 1 and 2, and `inference_tracking` writes the
same MOT results file as the JAX package's.
"""
import os
import warnings

import cv2
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.api import CenterNetPredictor as JPredictor
from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
from centernet_lightning_tpu.models.tracker import Tracker as JTracker

from centernet_lightning_torch import build_centernet as t_build
from centernet_lightning_torch.models.tracker import Tracker as TTracker
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import assert_detections_match, random_flax_variables

SIZE = (64, 96)
CFG = dict(num_classes=1, backbone="resnet18", backbone_config={"width": 16},
           neck="FPN", neck_config={"out_channels": 32},
           head_config={"width": 32, "depth": 1}, num_detections=40,
           box_multiplier=4.0, image_size=list(SIZE),
           reid_config={"emb_dim": 16, "max_track_ids": 30, "width": 16,
                        "depth": 1})
TRACKER = dict(detection_threshold=0.12, reid_threshold=0.3, min_birth_age=1,
               num_detections=40, max_inactive_age=3)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """The JAX predictor and the port's (CPU) with the same weights."""
    rng = np.random.default_rng(60)
    jtask = JCenterNet(**CFG)
    variables = random_flax_variables(jtask, rng, image_size=SIZE)
    jp = JPredictor(jtask, variables, image_size=SIZE)
    tp = t_build({"model": CFG}, device="cpu")
    tp.model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return jp, tp


def frames(n, seed=61):
    """Moving bright rectangles on noise, as chip_smoke.py's tracking frames."""
    rng = np.random.default_rng(seed)
    h, w = SIZE
    out = rng.integers(10, 50, (n, h, w, 3), dtype=np.uint8)
    pos = rng.uniform(0, [w - 20, h - 20], (5, 2))
    vel = rng.uniform(-2, 2, (5, 2))
    for f in range(n):
        for i, (x, y) in enumerate((pos + f * vel) % [w - 20, h - 20]):
            out[f, int(y):int(y) + 16, int(x):int(x) + 16] = 120 + 25 * i
    return out


def batches(arr, b=4):
    """(frames, n_valid) pairs, the last batch padded with zero frames."""
    for s in range(0, len(arr), b):
        chunk = arr[s:s + b]
        n = len(chunk)
        if n < b:
            chunk = np.concatenate([chunk, np.zeros((b - n, *chunk.shape[1:]),
                                                    chunk.dtype)])
        yield chunk, n


def test_gather_tracking2d_matches_jax(pair):
    jp, tp = pair
    x = frames(4)
    ref = jp.gather_tracking2d(x)
    got = tp.gather_tracking2d(x)
    assert got["embeddings"].shape == (4, 40, 16)
    assert got["embeddings"].dtype == np.float32
    assert_detections_match(ref, got, min_distinct=40, **TOL)
    # the embeddings of the untied entries (matched by their box)
    matched = 0
    for n in range(4):
        for row, box in enumerate(got["bboxes"][n]):
            hit = np.abs(ref["bboxes"][n] - box).max(axis=1) < 1e-4
            if hit.sum() == 1:
                np.testing.assert_allclose(got["embeddings"][n, row],
                                           ref["embeddings"][n][hit][0], **TOL)
                matched += 1
    assert matched >= 100
    assert np.isfinite(got["bboxes"]).all() and np.isfinite(got["embeddings"]).all()


def test_device_gather_returns_tensors(pair):
    _, tp = pair
    out = tp._gather_tracking_device(frames(2), num_detections=10)
    assert set(out) == {"boxes", "scores", "labels", "embeddings"}
    assert all(isinstance(v, torch.Tensor) for v in out.values())
    assert out["embeddings"].shape == (2, 10, 16)


def test_trackers_identical_on_port_detections(pair):
    """The port's decoded arrays into the JAX tracker and the port's: the
    same active tracks every frame."""
    _, tp = pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt, tt = JTracker(**TRACKER), TTracker(**TRACKER)
    seen = 0
    for chunk, _ in batches(frames(24)):
        dets = tp.gather_tracking2d(chunk, num_detections=40)
        for i in range(len(chunk)):
            args = [dets[k][i] for k in ("bboxes", "labels", "scores",
                                         "embeddings")]
            jt.update(*args)
            tt.update(*args)
            assert [t.track_id for t in tt.tracks] == [t.track_id for t in jt.tracks]
            assert [t.state.name for t in tt.tracks] == [t.state.name
                                                          for t in jt.tracks]
            for a, b in zip(tt.tracks, jt.tracks):
                np.testing.assert_array_equal(a.bbox, b.bbox)
                np.testing.assert_array_equal(a.embedding, b.embedding)
            seen += sum(t.active for t in tt.tracks)
    assert seen > 0 and tt.next_track_id > 0


def _stream(tp, arr, depth, b=4):
    return list(tp.track_stream(batches(arr, b), tracker_config=TRACKER,
                                pipeline_depth=depth))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_track_stream_contract(pair, depth):
    """One dict per valid frame (padding skipped), equal to associating
    gather_tracking2d's arrays frame by frame, at every depth."""
    _, tp = pair
    arr = frames(14)                       # 3 full batches and 2 valid frames
    steps = _stream(tp, arr, depth)
    assert len(steps) == 14
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = TTracker(**TRACKER)
    dets = tp.gather_tracking2d(arr, num_detections=40)
    for i, step in enumerate(steps):
        ref.update(dets["bboxes"][i], dets["labels"][i], dets["scores"][i],
                   dets["embeddings"][i])
        live = [t for t in ref.tracks if t.active]
        assert step["track_ids"] == [t.track_id for t in live]
        np.testing.assert_allclose(np.asarray(step["bboxes"]).reshape(-1, 4),
                                   np.asarray([t.bbox for t in live]).reshape(-1, 4),
                                   rtol=1e-6, atol=1e-6)
        assert step["num_detections"] == int(
            (dets["scores"][i] >= TRACKER["detection_threshold"]).sum())
    assert sum(len(s["track_ids"]) for s in steps) > 0


def test_track_stream_worker_error_reaches_consumer(pair):
    _, tp = pair

    def failing():
        yield frames(4), 4
        raise KeyError("bad batch")

    stream = tp.track_stream(failing(), tracker_config=TRACKER,
                             pipeline_depth=2)
    with pytest.raises(KeyError, match="bad batch"):
        list(stream)


def test_track_stream_needs_reid_head():
    cfg = {k: v for k, v in CFG.items() if k != "reid_config"}
    with pytest.raises(ValueError, match="reid"):
        next(t_build({"model": cfg}, device="cpu").track_stream(batches(frames(4))))


def test_inference_tracking_matches_jax(pair, tmp_path, monkeypatch):
    """Over a folder of frames, the MOT results file is the JAX package's
    byte for byte when both track the same (the port's) detections; the
    annotated frames are written."""
    jp, tp = pair
    src = tmp_path / "frames"
    src.mkdir()
    for i, img in enumerate(frames(10, seed=62)):
        cv2.imwrite(str(src / f"{i:04d}.png"), img)

    def port_dets(images, num_detections=None, nms_kernel=None):
        out = tp._gather_tracking_device(np.asarray(images),
                                         num_detections=num_detections,
                                         nms_kernel=nms_kernel)
        return {k: v.numpy() for k, v in out.items()}

    monkeypatch.setattr(jp, "_gather_tracking_device", port_dets)
    kw = dict(batch_size=4, save_results=True, tracker_config=TRACKER)
    ref = jp.inference_tracking(str(src), save_dir=str(tmp_path / "jax"), **kw)
    got = tp.inference_tracking(str(src), save_dir=str(tmp_path / "port"),
                                save_images=True, **kw)
    assert got["track_ids"] == ref["track_ids"] and len(got["track_ids"]) == 10
    text = (tmp_path / "port" / "tracking_results.txt").read_text()
    assert text == (tmp_path / "jax" / "tracking_results.txt").read_text()
    assert text.count("\n") > 0
    assert len(os.listdir(tmp_path / "port" / "images")) == 10
