"""PyTorch port vs the JAX package: the host tracker and what it imports.

The port's `Tracker` and the JAX package's take the same seeded numpy
detections (births, misses, clutter and deaths over 40 frames) and must
hold the same tracks after every frame: ids, states, ages, and boxes and
embeddings equal in float64, with and without the Kalman filter, for each
box cost, on the native Hungarian solver and on scipy's. The port's copies
of native/, utils/box_np.py and utils/kalman.py are held to the JAX
package's on the same inputs: exactly, as they are the same code.
"""
import warnings

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from centernet_lightning_tpu import native as j_native
from centernet_lightning_tpu.models import tracker as j_tracker
from centernet_lightning_tpu.utils import box_np as j_box
from centernet_lightning_tpu.utils import kalman as j_kalman

from centernet_lightning_torch import native as t_native
from centernet_lightning_torch.models import tracker as t_tracker
from centernet_lightning_torch.utils import box_np as t_box
from centernet_lightning_torch.utils import kalman as t_kalman

CONFIG = "configs/mot_tracking.yaml"


@pytest.fixture(params=["native", "scipy"])
def solver(request):
    """Both packages on the native solver, or both on scipy's."""
    native = request.param == "native"
    for mod in (j_native, t_native):
        mod.set_enabled(native)
    if native:
        assert t_native.available() and j_native.available()
    yield request.param
    for mod in (j_native, t_native):
        mod.set_enabled(True)


def scenario(seed, frames=40, objects=7, k=16, dim=16):
    """Per frame (bboxes (k, 4) xyxy, labels, scores, embeddings f32) as
    the decode gives them: objects born and dying at seeded frames, each
    missed now and then (its score under the threshold), with embeddings
    of its identity plus noise of varied size (some too noisy for the
    appearance stage, so the box stage must pair them), two clutter
    detections a frame, rows shuffled and padded with zero scores."""
    rng = np.random.default_rng(seed)
    birth = rng.integers(0, frames // 3, objects)
    death = birth + rng.integers(frames // 3, frames, objects)
    start = rng.uniform(0.1, 0.7, (objects, 2))
    vel = rng.uniform(-0.01, 0.01, (objects, 2))
    size = rng.uniform(0.05, 0.2, (objects, 2))
    ident = rng.normal(size=(objects, dim))
    out = []
    for f in range(frames):
        rows = []
        for i in range(objects):
            if not birth[i] <= f < death[i]:
                continue
            xy = start[i] + vel[i] * f + rng.normal(scale=0.003, size=2)
            box = np.concatenate([xy, xy + size[i]])
            score = rng.uniform(0.05, 0.25) if rng.uniform() < 0.15 \
                else rng.uniform(0.4, 0.95)
            e = ident[i] + rng.normal(scale=rng.choice([0.05, 0.3, 1.5]),
                                      size=dim)
            rows.append((box, 0, score, e))
        for _ in range(2):
            xy = rng.uniform(0, 0.8, 2)
            rows.append((np.concatenate([xy, xy + rng.uniform(0.02, 0.1, 2)]),
                         0, rng.uniform(0.0, 0.6), rng.normal(size=dim)))
        rng.shuffle(rows)
        while len(rows) < k:
            rows.append((np.zeros(4), 0, 0.0, np.zeros(dim)))
        boxes, labels, scores, embs = zip(*rows[:k])
        out.append((np.asarray(boxes, np.float32), np.asarray(labels, np.int32),
                    np.asarray(scores, np.float32), np.asarray(embs, np.float32)))
    return out


def snapshot(tracker):
    return [(t.track_id, t.state.name, t.birth_age, t.inactive_age, t.bbox,
             t.embedding) for t in tracker.tracks]


def assert_same_tracks(a, b, frame):
    assert len(a) == len(b), f"frame {frame}: {len(a)} vs {len(b)} tracks"
    for ta, tb in zip(a, b):
        assert ta[:4] == tb[:4], f"frame {frame}: {ta[:4]} vs {tb[:4]}"
        np.testing.assert_array_equal(ta[4], tb[4], err_msg=f"frame {frame} box")
        np.testing.assert_array_equal(ta[5], tb[5], err_msg=f"frame {frame} emb")


@pytest.mark.parametrize("use_kalman", [False, True])
@pytest.mark.parametrize("box_cost", ["iou", "giou", None])
def test_tracker_matches_jax(solver, use_kalman, box_cost):
    cfg = dict(detection_threshold=0.3, reid_threshold=0.2, box_cost=box_cost,
               box_threshold=0.7, use_kalman=use_kalman, max_inactive_age=4,
               min_birth_age=2, smoothing_factor=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # no model: fed through update()
        jt, tt = j_tracker.Tracker(**cfg), t_tracker.Tracker(**cfg)
    states, ids = set(), set()
    for frame, dets in enumerate(scenario(11)):
        jt.update(*dets)
        tt.update(*dets)
        ref, got = snapshot(jt), snapshot(tt)
        assert_same_tracks(ref, got, frame)
        states |= {s[1] for s in got}
        ids |= {s[0] for s in got}
    # births (more ids than live tracks), misses and deaths all happened
    assert {"UNCONFIRMED", "ACTIVE", "INACTIVE"} <= states
    assert len(ids) > len(tt.tracks) >= 1
    assert tt.next_track_id == jt.next_track_id


def test_tracker_reset_and_build_from_yaml():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jt = j_tracker.build_tracker(CONFIG)
        tt = t_tracker.build_tracker(CONFIG)
    for key in ("nms_kernel", "num_detections", "detection_threshold",
                "reid_threshold", "box_threshold", "smoothing_factor",
                "use_kalman", "max_inactive_age", "min_birth_age"):
        assert getattr(tt, key) == getattr(jt, key), key
    for dets in scenario(3, frames=5):
        tt.update(*dets)
    assert tt.tracks and tt.next_track_id > 0
    tt.reset()
    assert (tt.frame, tt.next_track_id, tt.tracks) == (0, 0, [])


@pytest.mark.parametrize("shape", [(6, 6), (4, 9), (9, 4), (1, 5), (0, 3)])
def test_lap_assign_optimal_and_same_as_jax(shape):
    """The native solver's pairing has scipy's optimal total cost and is
    the JAX package's pairing, ties included (integer costs)."""
    rng = np.random.default_rng(sum(shape))
    for cost in (rng.uniform(size=shape), rng.integers(0, 3, shape).astype(float)):
        rows, cols = t_native.lap_assign(cost)
        sr, sc = linear_sum_assignment(cost)
        assert len(rows) == len(sr) == min(shape)
        assert np.all(np.diff(rows) > 0)
        assert cost[rows, cols].sum() == pytest.approx(cost[sr, sc].sum(), abs=1e-12)
        jr, jc = j_native.lap_assign(cost)
        np.testing.assert_array_equal(rows, jr)
        np.testing.assert_array_equal(cols, jc)


def test_lap_assign_or_scipy_fallbacks():
    cost = np.array([[0.1, np.inf], [np.inf, 0.2], [0.3, 0.4]])
    rows, cols = t_native.lap_assign_or_scipy(cost)      # non-finite: scipy
    sr, sc = linear_sum_assignment(cost)
    np.testing.assert_array_equal(rows, sr)
    np.testing.assert_array_equal(cols, sc)
    t_native.set_enabled(False)
    try:
        assert not t_native.available()
        with pytest.raises(RuntimeError):
            t_native.lap_assign(np.eye(2))
        assert t_native.coco_match(np.eye(2), np.array([0.5]),
                                   np.zeros(2), np.zeros(2)) is None
        rows, cols = t_native.lap_assign_or_scipy(np.eye(3))
        sr, sc = linear_sum_assignment(np.eye(3))
        np.testing.assert_array_equal(rows, sr)
        np.testing.assert_array_equal(cols, sc)
    finally:
        t_native.set_enabled(True)
    assert t_native.available()


def test_coco_match_same_as_jax():
    rng = np.random.default_rng(5)
    ious = np.round(rng.uniform(size=(12, 7)), 1)       # ties at thresholds
    thrs = np.linspace(0.5, 0.95, 10)
    ig = rng.uniform(size=7) < 0.2
    crowd = rng.uniform(size=7) < 0.2
    np.testing.assert_array_equal(t_native.coco_match(ious, thrs, ig, crowd),
                                  j_native.coco_match(ious, thrs, ig, crowd))


def test_build_failure_warns_with_compiler_output(monkeypatch, tmp_path):
    """A failed build is not silent: one warning carries g++'s stderr."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(t_native, "_SRC", str(bad))
    monkeypatch.setattr(t_native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_tried", False)
    with pytest.warns(RuntimeWarning, match="(?s)did not build.*error"):
        assert not t_native.available()
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # once: no second attempt
        assert not t_native.available()


def test_box_np_same_as_jax():
    rng = np.random.default_rng(6)
    xy = rng.uniform(0, 50, (9, 2))
    a = np.concatenate([xy, xy + rng.uniform(1, 20, (9, 2))], -1)
    xy = rng.uniform(0, 50, (5, 2))
    b = np.concatenate([xy, xy + rng.uniform(1, 20, (5, 2))], -1)
    for name in ("box_iou_matrix", "box_giou_matrix", "box_iou_distance_matrix",
                 "box_giou_distance_matrix"):
        np.testing.assert_array_equal(getattr(t_box, name)(a, b),
                                      getattr(j_box, name)(a, b), err_msg=name)
    for got, ref in zip(t_box.box_inter_union_matrix(a, b),
                        j_box.box_inter_union_matrix(a, b)):
        np.testing.assert_array_equal(got, ref)
    for src in ("xyxy", "xywh", "cxcywh"):
        for dst in ("xyxy", "xywh", "cxcywh"):
            np.testing.assert_array_equal(t_box.convert_box_format(a, src, dst),
                                          j_box.convert_box_format(a, src, dst))
    np.testing.assert_array_equal(t_box.xyxy_to_xyah(a), j_box.xyxy_to_xyah(a))
    np.testing.assert_array_equal(t_box.xyah_to_xyxy(a), j_box.xyah_to_xyxy(a))


def test_kalman_same_as_jax():
    rng = np.random.default_rng(7)
    filters = [mod.KalmanFilter(dim_x=8, dim_z=4) for mod in (t_kalman, j_kalman)]
    f = np.eye(8)
    f[:4, 4:] = np.eye(4)
    for kf in filters:
        kf.F = f
        kf.x[:4] = [10, 20, 30, 60]
    for step in range(12):
        q = np.diag(rng.uniform(0.1, 1, 8))
        z = rng.uniform(0, 60, 4)
        r = np.diag(rng.uniform(0.1, 1, 4))
        for kf in filters:
            kf.predict(Q=q)
            if step % 3:
                kf.update(z, R=r)
        np.testing.assert_array_equal(filters[0].x, filters[1].x)
        np.testing.assert_array_equal(filters[0].P, filters[1].P)
