"""PyTorch port: eval/ (the COCO protocol, the MOT metrics and the format
converters) against the JAX package, on the CPU.

- The JAX package's own tests of eval/ (tests/test_coco_eval.py and
  tests/test_mot_eval.py), each run against the port's modules
  (`run_on_port`): one case a test.
- `CocoEvaluator.get_metrics()` equal (float64, ==) to JAX's on seeded
  detections with crowds, annotation areas, empty images and classes
  without ground truth, with the native matcher on and off.
- CLEAR, IDF1, HOTA, `evaluate_mot_tracking_sequence(s)` and
  `evaluate_mot_tracking_from_file` (distractor preprocessing, several
  trackers, a seqmap) equal to JAX's on seeded tracks and MOT txt files.
- The COCO converters equal to JAX's.
"""
import os

import numpy as np
import pytest

import test_coco_eval as jax_coco_tests
import test_mot_eval as jax_mot_tests
from centernet_lightning_tpu import native as j_native
from centernet_lightning_tpu.eval import coco_eval as j_coco
from centernet_lightning_tpu.eval import mot as j_mot
from centernet_lightning_tpu.eval import utils as j_utils

from centernet_lightning_torch import native as t_native
from centernet_lightning_torch.eval import coco_eval as t_coco
from centernet_lightning_torch.eval import mot as t_mot
from centernet_lightning_torch.eval import utils as t_utils

from _torch_port_helpers import jax_test_names, on_port, run_on_port

EVAL_MODULES = ("centernet_lightning_tpu.eval", "centernet_lightning_tpu.eval.coco_eval",
                "centernet_lightning_tpu.eval.mot", "centernet_lightning_tpu.eval.utils",
                "centernet_lightning_tpu.data", "centernet_lightning_tpu.data.coco",
                "centernet_lightning_tpu.data.collate",
                "centernet_lightning_tpu.data.transforms")


@pytest.mark.parametrize("name", jax_test_names(jax_coco_tests))
def test_jax_coco_eval_tests_on_port(name, request, monkeypatch):
    run_on_port(jax_coco_tests, name, request, monkeypatch, EVAL_MODULES)


@pytest.mark.parametrize("name", jax_test_names(jax_mot_tests))
def test_jax_mot_eval_tests_on_port(name, request, monkeypatch):
    run_on_port(jax_mot_tests, name, request, monkeypatch, EVAL_MODULES)


def _probe():
    from centernet_lightning_tpu.eval.mot import hota_score
    import centernet_lightning_tpu.eval.coco_eval as m

    return hota_score, m.CocoEvaluator, j_coco.box_iou_xywh


def test_run_on_port_reaches_the_port(monkeypatch):
    hota, evaluator, iou = on_port(_probe, monkeypatch, EVAL_MODULES)()
    assert hota is t_mot.hota_score and evaluator is t_coco.CocoEvaluator
    assert iou is t_coco.box_iou_xywh


# ---- COCO -------------------------------------------------------------------

NUM_CLASSES = 6   # the last class has no ground truth


def coco_scenario(seed, n_images=14, extras=True):
    """Per-image predictions and targets: jittered copies of the ground
    truth and random boxes, f32 as the decode gives them; every fifth image
    empty of ground truth, about 15% crowds, annotation areas below the
    box areas, boxes from 4 to 200 pixels (every area range)."""
    rng = np.random.default_rng(seed)
    preds, targets = [], []
    for i in range(n_images):
        g = 0 if i % 5 == 0 else int(rng.integers(1, 9))
        wh = rng.uniform(4, 200, (g, 2))
        xy = rng.uniform(0, 300, (g, 2))
        gt = np.concatenate([xy, wh], 1)
        labels = rng.integers(0, NUM_CLASSES - 1, g)
        target = {"boxes": gt.astype(np.float32), "labels": labels.astype(np.int32)}
        if extras:
            target["iscrowd"] = (rng.uniform(size=g) < 0.15).astype(np.int32)
            target["area"] = (wh.prod(1) * rng.uniform(0.4, 1.0, g)).astype(np.float32)
        keep = rng.uniform(size=g) < 0.8
        jitter = gt[keep] + rng.normal(0, 3, (int(keep.sum()), 4))
        jitter[:, 2:] = np.maximum(jitter[:, 2:], 1)
        n_rand = int(rng.integers(0, 12))
        rand = np.concatenate([rng.uniform(0, 300, (n_rand, 2)),
                               rng.uniform(2, 150, (n_rand, 2))], 1)
        boxes = np.concatenate([jitter, rand]).astype(np.float32)
        det_labels = np.concatenate([
            np.where(rng.uniform(size=len(jitter)) < 0.9, labels[keep],
                     rng.integers(0, NUM_CLASSES, len(jitter))),
            rng.integers(0, NUM_CLASSES, n_rand)]).astype(np.int32)
        preds.append({"boxes": boxes,
                      "scores": rng.uniform(0, 1, len(boxes)).astype(np.float32),
                      "labels": det_labels})
        targets.append(target)
    return preds, targets


@pytest.fixture(params=[True, False], ids=["native", "numpy"])
def native_matcher(request):
    if request.param and not (t_native.available() and j_native.available()):
        pytest.fail("the native library did not build")
    t_native.set_enabled(request.param)
    j_native.set_enabled(request.param)
    yield request.param
    t_native.set_enabled(True)
    j_native.set_enabled(True)


@pytest.mark.parametrize("seed,extras", [(0, True), (1, True), (2, False)])
def test_coco_evaluator_equals_jax(seed, extras, native_matcher):
    preds, targets = coco_scenario(seed, extras=extras)
    got, ref = t_coco.CocoEvaluator(NUM_CLASSES), j_coco.CocoEvaluator(NUM_CLASSES)
    for s in range(0, len(preds), 4):       # batches of 4 images
        got.update(preds[s:s + 4], targets[s:s + 4])
        ref.update(preds[s:s + 4], targets[s:s + 4])
    a, b = got.get_metrics(), ref.get_metrics()
    assert a == b
    assert len(a) == 12 and a["mAP"] > 0 and a["AP_large"] > -1
    np.testing.assert_array_equal(got.engine.precision, ref.engine.precision)
    np.testing.assert_array_equal(got.engine.recall, ref.engine.recall)
    got.reset()
    assert got.preds == [] and got.targets == []


def test_greedy_match_equals_jax(native_matcher):
    rng = np.random.default_rng(5)
    ious = rng.uniform(0, 1, (9, 7))
    ious[2, 3] = ious[2, 5] = 0.75          # an exact tie
    thr = np.linspace(0.5, 0.95, 10)
    gt_ig = rng.uniform(size=7) < 0.3
    crowd = np.zeros(7, bool)
    crowd[1] = True
    np.testing.assert_array_equal(t_coco._greedy_match(ious, thr, gt_ig, crowd),
                                  j_coco._greedy_match(ious, thr, gt_ig, crowd))


def test_coco_converters_equal_jax(tmp_path):
    preds, targets = coco_scenario(3)
    assert (t_utils.ground_truth_to_coco_annotations(targets, ["a", "b"])
            == j_utils.ground_truth_to_coco_annotations(targets, ["a", "b"]))
    ids = list(range(10, 10 + len(preds)))
    got = t_utils.detections_to_coco_results(ids, preds, 0.3,
                                             save_path=str(tmp_path / "t.json"))
    assert got == j_utils.detections_to_coco_results(
        ids, preds, 0.3, save_path=str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


# ---- MOT --------------------------------------------------------------------

def mot_scenario(seed, n_frames=24, n_objects=6):
    """(gt boxes, gt ids, pred boxes, pred ids) a frame: objects that move,
    enter and leave; predictions that jitter, miss, swap ids and add false
    positives."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 200, (n_objects, 2))
    vel = rng.uniform(-3, 3, (n_objects, 2))
    size = rng.uniform(15, 60, (n_objects, 2))
    born = rng.integers(0, n_frames // 2, n_objects)
    dies = born + rng.integers(n_frames // 3, n_frames, n_objects)
    gb, gi, pb, pi = [], [], [], []
    swap_at = n_frames // 2
    for f in range(n_frames):
        alive = np.flatnonzero((born <= f) & (f < dies))
        boxes = np.concatenate([start[alive] + f * vel[alive], size[alive]], 1)
        gb.append(boxes)
        gi.append(alive + 1)
        seen = rng.uniform(size=len(alive)) < 0.85
        p = boxes[seen] + rng.normal(0, 2, (int(seen.sum()), 4))
        ids = alive[seen] + 100
        if f >= swap_at and len(ids) >= 2:
            ids[[0, 1]] = ids[[1, 0]]
        n_fp = int(rng.integers(0, 3))
        p = np.concatenate([p, np.concatenate([rng.uniform(0, 250, (n_fp, 2)),
                                               rng.uniform(10, 50, (n_fp, 2))], 1)])
        ids = np.concatenate([ids, 500 + f * 10 + np.arange(n_fp)])
        pb.append(p)
        pi.append(ids)
    return gb, gi, pb, pi


def _equal_dicts(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mot_metrics_equal_jax(seed):
    gb, gi, pb, pi = mot_scenario(seed)
    gt, pr = t_mot._as_frames(gb, gi), t_mot._as_frames(pb, pi)
    for name in ("clear_metrics", "idf1_score", "hota_score"):
        _equal_dicts(getattr(t_mot, name)(gt, pr), getattr(j_mot, name)(gt, pr))
    got = t_mot.evaluate_mot_tracking_sequence(pb, pi, gb, gi)
    assert got == j_mot.evaluate_mot_tracking_sequence(pb, pi, gb, gi)
    assert 0 < got["IDF1"] < 1 and 0 < got["HOTA"] < 1


def test_mot_sequences_equal_jax():
    per_seq = {}
    for s in range(3):
        gb, gi, pb, pi = mot_scenario(10 + s, n_frames=12 + 4 * s)
        per_seq[f"seq{s}"] = {"target_bboxes": gb, "target_track_ids": gi,
                              "pred_bboxes": pb, "pred_track_ids": pi}
    per_seq["seq3"] = {k: [np.zeros((0, 4))] * 3 if "bboxes" in k else
                       [np.zeros(0, np.int64)] * 3 for k in per_seq["seq0"]}
    got = t_mot.evaluate_mot_tracking_sequences(per_seq)
    assert got == j_mot.evaluate_mot_tracking_sequences(per_seq)
    assert {"MOTA", "IDF1", "HOTA", "seq2/HOTA"} <= set(got)
    assert t_mot.evaluate_mot_tracking_sequences({}) == \
        j_mot.evaluate_mot_tracking_sequences({})


def _write_mot_tree(root, rng):
    """Two sequences of MOT-Challenge ground truth (pedestrians, zero-marked
    rows and every distractor class) and two trackers' result files."""
    seqs = ["SEQ-A", "SEQ-B"]
    for s, seq in enumerate(seqs):
        gb, gi, pb, pi = mot_scenario(20 + s, n_frames=15)
        os.makedirs(root / "gt" / seq / "gt")
        lines = []
        for f, (boxes, ids) in enumerate(zip(gb, gi), start=1):
            for box, tid in zip(boxes, ids):
                cls = rng.choice([1, 1, 1, 1, 2, 7, 8, 12, 3, -1])
                mark = 0 if rng.uniform() < 0.1 else 1
                lines.append(f"{f},{tid},{box[0]:.2f},{box[1]:.2f},{box[2]:.2f},"
                             f"{box[3]:.2f},{mark},{cls},1")
        (root / "gt" / seq / "gt" / "gt.txt").write_text("\n".join(lines) + "\n")
        for t, tracker in enumerate(("trk-a", "trk-b")):
            os.makedirs(root / "trk" / tracker, exist_ok=True)
            out = []
            for f, (boxes, ids) in enumerate(zip(pb, pi), start=1):
                for box, tid in zip(boxes, ids):
                    if t and rng.uniform() < 0.2:
                        continue
                    out.append(f"{f},{tid},{box[0]:.3f},{box[1]:.3f},"
                               f"{box[2]:.3f},{box[3]:.3f},-1,-1,-1,-1")
            (root / "trk" / tracker / f"{seq}.txt").write_text("\n".join(out) + "\n")
    (root / "seqmap.txt").write_text("name\nSEQ-B\n")


def test_mot_from_file_equals_jax(tmp_path):
    _write_mot_tree(tmp_path, np.random.default_rng(4))
    gt, trk = str(tmp_path / "gt"), str(tmp_path / "trk")
    both = t_mot.evaluate_mot_tracking_from_file(gt, trk)
    assert both == j_mot.evaluate_mot_tracking_from_file(gt, trk)
    assert set(both) == {"trk-a", "trk-b"}
    assert both["trk-a"] != both["trk-b"]
    one = t_mot.evaluate_mot_tracking_from_file(
        gt, trk, trackers_to_eval="trk-b", seqmap_file=str(tmp_path / "seqmap.txt"))
    assert one == j_mot.evaluate_mot_tracking_from_file(
        gt, trk, trackers_to_eval="trk-b", seqmap_file=str(tmp_path / "seqmap.txt"))
    assert "SEQ-B/MOTA" in one and "SEQ-A/MOTA" not in one
    path = str(tmp_path / "gt" / "SEQ-A" / "gt" / "gt.txt")
    a, b = t_mot._parse_mot_txt(path, gt=True), j_mot._parse_mot_txt(path, gt=True)
    assert a.keys() == b.keys()
    for f in a:
        for x, y in zip(a[f], b[f]):
            np.testing.assert_array_equal(x, y)
