"""Host-side multi-object tracking (port of models/tracker.py, numpy and
scipy only, on the port's own copies of native/, utils/box_np.py and
utils/kalman.py).

Two-stage Hungarian association (ReID cosine distance, then box distance
on the leftovers), a four-state track lifecycle, EMA appearance smoothing
and an optional constant-velocity Kalman filter. The card runs the
forward, the decode and the embedding gather; the top-k arrays (k x (4 +
1 + 1 + emb) floats a frame) are all that crosses to the host, where
everything in this module runs.

Behaviour (the JAX tracker's, held equal to it on the same arrays by
tests/test_torch_port_tracker.py):
 - lifecycle UNCONFIRMED -(min_birth_age hits)-> ACTIVE <-> INACTIVE
   -(max_inactive_age misses)-> TO_DELETE; unconfirmed tracks die on the
   first miss
 - association stage 1 on embedding distance (threshold accept), stage 2
   on box distance over the unmatched remainder
 - embeddings L2-normalised in float64, then blended with factor
   `smoothing_factor`
 - Kalman: 8-state constant-velocity over xyxy corners with
   extent-proportional noise (DeepSORT-style scaling)
"""
from __future__ import annotations

import warnings
from enum import Enum, auto
from typing import Callable, List, Optional, Union

import numpy as np
from scipy.spatial import distance as _sp_distance

from ..native import lap_assign_or_scipy
from ..utils.box_np import box_giou_distance_matrix, box_iou_distance_matrix
from ..utils.kalman import KalmanFilter

__all__ = ["TrackState", "Track", "Tracker", "match_with_threshold", "build_tracker"]


class TrackState(Enum):
    UNCONFIRMED = auto()
    ACTIVE = auto()
    INACTIVE = auto()
    TO_DELETE = auto()


def match_with_threshold(cost_matrix: np.ndarray, threshold: float):
    """Hungarian assignment, then discard pairs at/above `threshold`.

    Returns (accepted [(row, col), ...], leftover rows, leftover cols).
    """
    n_rows, n_cols = cost_matrix.shape
    # the in-tree C++ Jonker-Volgenant solver; scipy for non-finite costs
    rows, cols = lap_assign_or_scipy(cost_matrix)
    accept = cost_matrix[rows, cols] < threshold
    rows, cols = rows[accept], cols[accept]

    row_free = np.ones(n_rows, bool)
    col_free = np.ones(n_cols, bool)
    row_free[rows] = False
    col_free[cols] = False
    pairs = list(zip(rows.tolist(), cols.tolist()))
    return pairs, np.flatnonzero(row_free).tolist(), np.flatnonzero(col_free).tolist()


def _unit(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, float)
    return v / max(float(np.linalg.norm(v)), 1e-12)


class _Motion:
    """Constant-velocity Kalman over xyxy corners (8 states, 4 measured).

    All noise scales are proportional to the current box extent, echoing
    DeepSORT's width/height-relative uncertainty model: the bigger the
    object, the looser the filter.
    """

    INIT_POS_DIV = 10.0
    INIT_VEL_DIV = 16.0
    PROC_POS_DIV = 20.0
    PROC_VEL_DIV = 160.0
    MEAS_DIV = 20.0

    def __init__(self, box: np.ndarray):
        f = np.eye(8)
        f[:4, 4:] = np.eye(4)          # x' = x + v
        kf = KalmanFilter(dim_x=8, dim_z=4)
        kf.x[:4] = box
        kf.F = f
        kf.H = np.eye(4, 8)
        sigma = np.concatenate([
            self._extent_vec(box) / self.INIT_POS_DIV,
            self._extent_vec(box) / self.INIT_VEL_DIV,
        ])
        kf.P = np.diag(np.square(sigma))
        self._kf = kf

    @staticmethod
    def _extent_vec(box: np.ndarray) -> np.ndarray:
        """[w, h, w, h] of an xyxy box — the per-coordinate scale. Floored
        so degenerate boxes can't make the noise covariances singular."""
        wh = np.asarray(box[2:4]) - np.asarray(box[:2])
        wh = np.maximum(np.abs(wh), 1e-3)
        return np.concatenate([wh, wh])

    @property
    def box(self) -> np.ndarray:
        return self._kf.x[:4].copy()

    def predict(self) -> None:
        scale = self._extent_vec(self._kf.x[:4])
        sigma = np.concatenate([scale / self.PROC_POS_DIV,
                                scale / self.PROC_VEL_DIV])
        self._kf.predict(Q=np.diag(np.square(sigma)))

    def correct(self, measured_box: np.ndarray) -> np.ndarray:
        sigma = self._extent_vec(self._kf.x[:4]) / self.MEAS_DIV
        self._kf.update(np.asarray(measured_box, float),
                        R=np.diag(np.square(sigma)))
        return self.box


class Track:
    """One tracked object: lifecycle state + box + smoothed appearance."""

    def __init__(self, track_id, bbox, label, embedding, min_birth_age: int = 2,
                 max_inactive_age: int = 30, smoothing_factor: float = 0.9,
                 use_kalman: bool = False):
        self.track_id = track_id
        self.label = label
        self.bbox = np.asarray(bbox, float)
        self.embedding = _unit(embedding)

        self.state = TrackState.UNCONFIRMED
        self.birth_age = 0
        self.inactive_age = 0
        self.min_birth_age = min_birth_age
        self.max_inactive_age = max_inactive_age
        self.smoothing_factor = smoothing_factor

        self.motion = _Motion(self.bbox) if use_kalman else None

    # -- state queries ---------------------------------------------------

    @property
    def active(self) -> bool:
        return self.state is TrackState.ACTIVE

    @property
    def confirmed(self) -> bool:
        return self.state is not TrackState.UNCONFIRMED

    @property
    def to_delete(self) -> bool:
        return self.state is TrackState.TO_DELETE

    # -- per-frame events --------------------------------------------------

    def update_matched(self, bbox, embedding) -> None:
        """A detection was assigned to this track this frame."""
        if self.state is TrackState.UNCONFIRMED:
            self.birth_age += 1
            if self.birth_age >= self.min_birth_age:
                self.state = TrackState.ACTIVE
        elif self.state is TrackState.INACTIVE:
            self.inactive_age = 0
            self.state = TrackState.ACTIVE

        measured = np.asarray(bbox, float)
        self.bbox = (measured if self.motion is None
                     else self.motion.correct(measured))

        alpha = self.smoothing_factor
        self.embedding = (1.0 - alpha) * self.embedding + alpha * _unit(embedding)

    def update_unmatched(self) -> None:
        """No detection for this track this frame."""
        if self.state is TrackState.UNCONFIRMED:
            self.state = TrackState.TO_DELETE
        elif self.state is TrackState.ACTIVE:
            self.state = TrackState.INACTIVE
            self.inactive_age = 0
        elif self.state is TrackState.INACTIVE:
            self.inactive_age += 1
            if self.inactive_age >= self.max_inactive_age:
                self.state = TrackState.TO_DELETE

    def kalman_predict(self) -> None:
        if self.motion is not None:
            self.motion.predict()

    def __repr__(self) -> str:
        return (f"Track(id={self.track_id}, state={self.state.name}, "
                f"bbox={np.round(self.bbox, 2).tolist()}, label={self.label})")


_BOX_DISTANCES = {
    "iou": box_iou_distance_matrix,
    "giou": box_giou_distance_matrix,
}


class Tracker:
    """Two-stage association tracker over decoded detections.

    `model`, when given, is a callable (images, num_detections=, nms_kernel=)
    -> numpy dict {bboxes (N,k,4) normalised xyxy, labels, scores,
    embeddings}, such as the predictor's `gather_tracking2d`. Without a
    model, feed `update()` directly.
    """

    def __init__(self, model: Optional[Callable] = None, nms_kernel: int = 3,
                 num_detections: int = 300, detection_threshold: float = 0.3,
                 reid_cost: Union[str, Callable] = "cosine",
                 reid_threshold: float = 0.2,
                 box_cost: Union[str, Callable, None] = "iou",
                 box_threshold: float = 0.5, smoothing_factor: float = 0.5,
                 use_kalman: bool = False, max_inactive_age: int = 30,
                 min_birth_age: int = 2):
        self.model = model
        if model is None:
            warnings.warn(
                "Tracker built without a model: step_batch/step_single are "
                "unavailable; drive it through update() with decoded arrays."
            )

        self.nms_kernel = nms_kernel
        self.num_detections = num_detections
        self.detection_threshold = detection_threshold

        if callable(reid_cost):
            self.reid_cost = reid_cost
        else:
            self.reid_cost = _make_cdist(reid_cost)
        self.reid_threshold = reid_threshold
        if box_cost is None or callable(box_cost):
            self.box_cost = box_cost
        else:
            self.box_cost = _BOX_DISTANCES[box_cost]
        self.box_threshold = box_threshold

        self.smoothing_factor = smoothing_factor
        self.use_kalman = use_kalman
        self.max_inactive_age = max_inactive_age
        self.min_birth_age = min_birth_age

        self.frame = 0
        self.next_track_id = 0
        self.tracks: List[Track] = []

    def reset(self) -> None:
        self.frame = 0
        self.next_track_id = 0
        self.tracks = []

    # -- device-fed stepping -----------------------------------------------

    def step_batch(self, images, **overrides):
        """Run the device program on a batch of frames, associate each in
        order. Returns {'bboxes': [...], 'track_ids': [...]} per frame with
        only ACTIVE tracks."""
        if self.model is None:
            raise RuntimeError("step_batch requires a model")
        dets = self.model(
            images,
            num_detections=overrides.get("num_detections", self.num_detections),
            nms_kernel=overrides.get("nms_kernel", self.nms_kernel),
        )
        dets = {k: np.asarray(v) for k, v in dets.items()}  # one D2H boundary

        result = {"bboxes": [], "track_ids": []}
        for frame_idx in range(len(dets["bboxes"])):
            self.update(dets["bboxes"][frame_idx], dets["labels"][frame_idx],
                        dets["scores"][frame_idx],
                        dets["embeddings"][frame_idx], **overrides)
            self.frame += 1
            live = [t for t in self.tracks if t.active]
            result["bboxes"].append([t.bbox for t in live])
            result["track_ids"].append([t.track_id for t in live])
        return result

    def step_single(self, image, **overrides):
        batched = self.step_batch(image[None], **overrides)
        return {k: v[0] for k, v in batched.items()}

    # -- association core --------------------------------------------------

    def _associate(self, det_boxes, det_embeddings, reid_threshold,
                   box_threshold):
        """Two-stage matching of detections against self.tracks.

        Returns (pairs [(det_i, track_j)], unborn det indices,
        missed track indices)."""
        track_embeddings = np.stack([t.embedding for t in self.tracks])

        if len(det_boxes):
            appearance = self.reid_cost(det_embeddings, track_embeddings)
        else:
            appearance = np.zeros((0, len(self.tracks)))
        pairs, free_dets, free_tracks = match_with_threshold(
            appearance, reid_threshold)

        run_stage2 = (self.box_cost is not None and free_dets and free_tracks)
        if run_stage2:
            d_idx = np.asarray(free_dets)
            t_idx = np.asarray(free_tracks)
            track_boxes = np.stack([self.tracks[j].bbox for j in t_idx])
            overlap = self.box_cost(det_boxes[d_idx], track_boxes)
            pairs2, free2_d, free2_t = match_with_threshold(
                overlap, box_threshold)
            pairs += [(int(d_idx[a]), int(t_idx[b])) for a, b in pairs2]
            free_dets = [int(d_idx[a]) for a in free2_d]
            free_tracks = [int(t_idx[b]) for b in free2_t]

        return pairs, free_dets, free_tracks

    def update(self, bboxes, labels, scores, embeddings, **overrides):
        """Associate one frame of decoded detections into the track set."""
        min_score = overrides.get("detection_threshold", self.detection_threshold)
        reid_thr = overrides.get("reid_threshold", self.reid_threshold)
        box_thr = overrides.get("box_threshold", self.box_threshold)

        keep = np.asarray(scores, float) >= min_score
        det_boxes = np.asarray(bboxes, float)[keep]
        det_labels = np.asarray(labels)[keep]
        det_embeddings = np.asarray(embeddings, float)[keep]

        if self.tracks:
            pairs, newborn, missed = self._associate(
                det_boxes, det_embeddings, reid_thr, box_thr)
            for det_i, track_j in pairs:
                self.tracks[track_j].update_matched(
                    det_boxes[det_i], det_embeddings[det_i])
            for track_j in missed:
                self.tracks[track_j].update_unmatched()
        else:
            newborn = range(len(det_boxes))

        for det_i in newborn:
            self.tracks.append(Track(
                self.next_track_id, det_boxes[det_i], det_labels[det_i],
                det_embeddings[det_i], min_birth_age=self.min_birth_age,
                max_inactive_age=self.max_inactive_age,
                smoothing_factor=self.smoothing_factor,
                use_kalman=self.use_kalman,
            ))
            self.next_track_id += 1

        self.tracks = [t for t in self.tracks if not t.to_delete]
        for t in self.tracks:
            t.kalman_predict()


def _make_cdist(metric: str):
    def fn(a, b):
        return _sp_distance.cdist(a, b, metric=metric)

    return fn


def build_tracker(config, model=None) -> Tracker:
    """Config path / dict -> Tracker (the `tracker:` config section)."""
    if isinstance(config, str):
        from ..train.config import load_config

        config = load_config(config).get("tracker", {})
    return Tracker(model=model, **config)
