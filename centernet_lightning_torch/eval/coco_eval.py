"""COCO-protocol detection evaluation without pycocotools (a copy of the
JAX package's eval/coco_eval.py, which the port may not import).

Reimplements COCOeval('bbox') semantics exactly and wraps it in the
reference's CocoEvaluator interface (update / reset / get_metrics with the
12 metrics named mAP, AP50, AP75, AP_small/medium/large, AR1, AR10, mAR,
AR_small/medium/large).

Protocol details matched to pycocotools:
 - IoU thresholds 0.50:0.05:0.95 (10), recall thresholds 0:0.01:1 (101)
 - area ranges all/small/medium/large = [0,1e10]/[0,32^2]/[32^2,96^2]/[96^2,1e10];
   GT gating uses the annotation's own `area` when the target dict carries
   one (pycocotools _prepare: ann['area'], the segmentation area on real
   COCO) and box w*h otherwise; det areas are always box w*h (pycocotools
   loadRes)
 - maxDets (1, 10, 100); greedy matching in score order, each det takes the
   highest-IoU unmatched GT above threshold; GTs outside the area range are
   ignore-matched (neither TP nor FP); unmatched dets outside the range are
   ignored too
 - precision envelope (monotone non-increasing) sampled at the 101 recall
   points via searchsorted; categories with no GT excluded from means (-1)
The greedy matching runs in the C++ library of `native/` when it builds,
and in numpy otherwise, with the same results.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ["CocoEvaluator", "COCOProtocolEval", "box_iou_xywh"]

METRIC_NAMES = [
    "mAP", "AP50", "AP75", "AP_small", "AP_medium", "AP_large",
    "AR1", "AR10", "mAR", "AR_small", "AR_medium", "AR_large",
]


def box_iou_xywh(dets: np.ndarray, gts: np.ndarray,
                 gt_crowd: np.ndarray = None) -> np.ndarray:
    """Pairwise IoU, boxes in xywh. Shapes (D, 4) x (G, 4) -> (D, G).

    Crowd GT columns use IoF (intersection / det area) instead of IoU —
    pycocotools maskUtils.iou(dt, gt, iscrowd) semantics: a detection
    inside a crowd region overlaps it fully regardless of the region's
    size."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), np.float64)
    d = dets.astype(np.float64)
    g = gts.astype(np.float64)
    dx1, dy1 = d[:, 0], d[:, 1]
    dx2, dy2 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3]
    gx1, gy1 = g[:, 0], g[:, 1]
    gx2, gy2 = g[:, 0] + g[:, 2], g[:, 1] + g[:, 3]

    ix1 = np.maximum(dx1[:, None], gx1[None])
    iy1 = np.maximum(dy1[:, None], gy1[None])
    ix2 = np.minimum(dx2[:, None], gx2[None])
    iy2 = np.minimum(dy2[:, None], gy2[None])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_d = (d[:, 2] * d[:, 3])[:, None]
    area_g = (g[:, 2] * g[:, 3])[None]
    union = area_d + area_g - inter
    if gt_crowd is not None and np.any(gt_crowd):
        union = np.where(np.asarray(gt_crowd, bool)[None, :],
                         np.broadcast_to(area_d, union.shape), union)
    # union == 0 implies inter == 0; tiny floor avoids a 0/0 warning
    return inter / np.maximum(union, np.finfo(np.float64).tiny)


def _greedy_match_numpy(ious: np.ndarray, iou_thrs: np.ndarray,
                        gt_ig: np.ndarray, gt_crowd: np.ndarray) -> np.ndarray:
    """Greedy matching, vectorized over GTs per det. pycocotools semantics:
    dets in score order each take the highest-IoU unmatched GT >= thr,
    preferring ANY real GT over ignored ones (gts sorted real-first,
    iteration breaks before ignored once a real match exists). Exact-IoU
    ties break to the LAST tied GT — pycocotools' inner loop updates on
    `ious >= best` (cocoeval.evaluateImg), so the last occurrence wins.
    Crowd GTs are never marked taken — any number of dets may ignore-match
    one.

    Returns dtm (T, D): matched gt index + 1; 0 = unmatched."""
    D, G = ious.shape
    T = len(iou_thrs)
    dtm = np.zeros((T, D), np.int64)
    gt_real = ~gt_ig

    def _last_argmax(vals):
        return G - 1 - int(np.argmax(vals[::-1]))

    for t, thr in enumerate(iou_thrs):
        thr_eff = min(thr, 1 - 1e-10)
        taken = np.zeros(G, bool)
        for dind in range(D):
            row = ious[dind]
            ok = (~taken | gt_crowd) & (row >= thr_eff)
            real = ok & gt_real
            if real.any():
                m = _last_argmax(np.where(real, row, -1.0))
            elif ok.any():
                m = _last_argmax(np.where(ok, row, -1.0))
            else:
                continue
            dtm[t, dind] = m + 1
            taken[m] = True
    return dtm


def _greedy_match(ious: np.ndarray, iou_thrs: np.ndarray, gt_ig: np.ndarray,
                  gt_crowd: np.ndarray) -> np.ndarray:
    """Native (C++) greedy matching when available, numpy loop otherwise —
    bit-identical results either way (pinned by tests/test_native.py)."""
    D, G = ious.shape
    if D == 0 or G == 0:
        return np.zeros((len(iou_thrs), D), np.int64)
    from .. import native

    dtm = native.coco_match(ious, iou_thrs, gt_ig, gt_crowd)
    if dtm is not None:
        return dtm
    return _greedy_match_numpy(ious, iou_thrs, gt_ig, gt_crowd)


class COCOProtocolEval:
    """The evaluation engine over in-memory prediction/target lists."""

    def __init__(self, num_classes: int, max_dets: Sequence[int] = (1, 10, 100)):
        self.num_classes = num_classes
        self.iou_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = tuple(max_dets)
        self.area_rngs = {
            "all": (0.0, 1e10),
            "small": (0.0, 32.0 ** 2),
            "medium": (32.0 ** 2, 96.0 ** 2),
            "large": (96.0 ** 2, 1e10),
        }

    def _evaluate_img(self, det_boxes, det_scores, gt_boxes, gt_crowd, ious,
                      gt_area=None):
        """All areaRng cells for one (image, category) at the LARGEST
        maxDet; smaller maxDets are column slices in accumulation
        (pycocotools computes matches once with maxDets[-1] and truncates).

        `det_boxes`/`det_scores` arrive score-sorted and truncated to
        maxDets[-1]; `ious` is precomputed for them (shared across area
        ranges, pycocotools computeIoU). `gt_crowd` marks iscrowd GTs:
        always ignored (never in npig), matched by IoF, matchable by any
        number of dets (pycocotools cocoeval.evaluateImg crowd semantics).

        Returns, per area range in self.area_rngs order, a tuple
        (dt_scores, dt_matched, dt_ignore, npig) over the IoU-threshold
        axis T.
        """
        G = len(gt_boxes)
        D = len(det_boxes)
        if gt_area is None:
            # fallback: box w*h — what the reference's in-memory create_coco
            # feeds pycocotools (eval/coco.py:90). Real COCO annotations
            # carry a segmentation `area` instead; pass it as gt_area for
            # exact pycocotools small/medium/large bucketing (_prepare uses
            # ann['area']).
            gt_area = gt_boxes[:, 2] * gt_boxes[:, 3] if G else np.zeros(0)
        # det area is ALWAYS box w*h — pycocotools loadRes sets result
        # areas from the bbox regardless of GT area semantics
        dt_area = det_boxes[:, 2] * det_boxes[:, 3] if D else np.zeros(0)

        cells = []
        for lo, hi in self.area_rngs.values():
            gt_ig = gt_crowd | (gt_area < lo) | (gt_area > hi)
            dtm = _greedy_match(ious, self.iou_thrs, gt_ig, gt_crowd)
            # a matched det inherits its GT's ignore flag; an unmatched det
            # is ignored when its own area falls outside the range
            gt_ig_pad = np.concatenate(([False], gt_ig))
            dt_out = (dt_area < lo) | (dt_area > hi)
            dt_ig = gt_ig_pad[dtm] | ((dtm == 0) & dt_out[None, :])
            npig = int((~gt_ig).sum())
            cells.append((det_scores, dtm > 0, dt_ig, npig))
        return cells

    def evaluate(self, preds: List[Dict], targets: List[Dict]):
        """preds/targets: per image dicts of numpy arrays
        {boxes xywh, scores, labels} / {boxes xywh, labels}.
        Returns the 12-metric dict."""
        assert len(preds) == len(targets)
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        K = self.num_classes
        A = len(self.area_rngs)
        M = len(self.max_dets)

        # per-class grouping
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        max_det_all = max(self.max_dets)
        for k in range(K):
            per_img = []
            for pred, gt in zip(preds, targets):
                p_sel = np.asarray(pred["labels"]) == k
                g_sel = np.asarray(gt["labels"]) == k
                det_boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)[p_sel]
                det_scores = np.asarray(pred["scores"], np.float64).reshape(-1)[p_sel]
                gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[g_sel]
                if "iscrowd" in gt:
                    gt_crowd = np.asarray(gt["iscrowd"], bool).reshape(-1)[g_sel]
                else:
                    gt_crowd = np.zeros(len(gt_boxes), bool)
                if "area" in gt:
                    gt_area = np.asarray(gt["area"], np.float64).reshape(-1)[g_sel]
                else:
                    gt_area = None
                if len(det_boxes) == 0 and len(gt_boxes) == 0:
                    continue
                # sort + IoU computed once per (image, category), shared
                # across area ranges (pycocotools computeIoU); matching at
                # the largest maxDet, per-maxDet views in accumulation
                order = np.argsort(-det_scores, kind="mergesort")[:max_det_all]
                db, ds = det_boxes[order], det_scores[order]
                ious = box_iou_xywh(db, gt_boxes, gt_crowd)
                per_img.append(
                    self._evaluate_img(db, ds, gt_boxes, gt_crowd, ious,
                                       gt_area))

            for a in range(A):
                cells = [img_cells[a] for img_cells in per_img]
                npig = sum(c[3] for c in cells)
                if npig == 0:
                    continue
                for m, max_det in enumerate(self.max_dets):
                    scores = np.concatenate([c[0][:max_det] for c in cells])
                    order = np.argsort(-scores, kind="mergesort")
                    tps = np.concatenate([c[1][:, :max_det] for c in cells],
                                         axis=1)[:, order]
                    igs = np.concatenate([c[2][:, :max_det] for c in cells],
                                         axis=1)[:, order]

                    tp_c = np.cumsum(tps & ~igs, axis=1).astype(np.float64)
                    fp_c = np.cumsum(~tps & ~igs, axis=1).astype(np.float64)

                    for t in range(T):
                        tp, fp = tp_c[t], fp_c[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        # precision envelope (monotone from the right) —
                        # vectorized: pycocotools' backward max scan is
                        # exactly a reversed cummax (the per-det Python
                        # loop was the eval host's hottest interpreter
                        # loop after the C++ matcher landed)
                        q = np.zeros(R)
                        if nd:
                            env = np.maximum.accumulate(pr[::-1])[::-1]
                            inds = np.searchsorted(rc, self.rec_thrs,
                                                   side="left")
                            ok = inds < nd
                            q[ok] = env[inds[ok]]
                        precision[t, :, k, a, m] = q

        self.precision = precision
        self.recall = recall
        return self._summarize()

    def _summarize(self) -> Dict[str, float]:
        def ap(iou=None, area="all", max_det=100):
            a = list(self.area_rngs).index(area)
            m = self.max_dets.index(max_det)
            s = self.precision[:, :, :, a, m]
            if iou is not None:
                s = s[np.where(np.isclose(self.iou_thrs, iou))[0]]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        def ar(area="all", max_det=100):
            a = list(self.area_rngs).index(area)
            m = self.max_dets.index(max_det)
            s = self.recall[:, :, a, m]
            s = s[s > -1]
            return float(np.mean(s)) if s.size else -1.0

        return {
            "mAP": ap(),
            "AP50": ap(iou=0.5),
            "AP75": ap(iou=0.75),
            "AP_small": ap(area="small"),
            "AP_medium": ap(area="medium"),
            "AP_large": ap(area="large"),
            "AR1": ar(max_det=1),
            "AR10": ar(max_det=10),
            "mAR": ar(max_det=100),
            "AR_small": ar(area="small"),
            "AR_medium": ar(area="medium"),
            "AR_large": ar(area="large"),
        }


class CocoEvaluator:
    """Streaming evaluator matching the reference interface
    (eval/coco.py:21-59): update(preds, targets) per batch, get_metrics(),
    reset(). Arrays may be padded; pass num_dets/num_gts masks via score
    filtering upstream or give exact-length arrays."""

    def __init__(self, num_classes: int, max_dets: Sequence[int] = (1, 10, 100)):
        self.num_classes = num_classes
        self.engine = COCOProtocolEval(num_classes, max_dets)
        self.reset()

    def reset(self):
        self.preds: List[Dict] = []
        self.targets: List[Dict] = []

    def update(self, preds: List[Dict], targets: List[Dict]):
        for p in preds:
            self.preds.append({
                "boxes": np.asarray(p["boxes"], np.float64).reshape(-1, 4),
                "scores": np.asarray(p["scores"], np.float64).reshape(-1),
                "labels": np.asarray(p["labels"], np.int64).reshape(-1),
            })
        for t in targets:
            entry = {
                "boxes": np.asarray(t["boxes"], np.float64).reshape(-1, 4),
                "labels": np.asarray(t["labels"], np.int64).reshape(-1),
            }
            if "iscrowd" in t:
                entry["iscrowd"] = np.asarray(t["iscrowd"], np.int64).reshape(-1)
            if "area" in t:
                entry["area"] = np.asarray(t["area"], np.float64).reshape(-1)
            self.targets.append(entry)

    def get_metrics(self) -> Dict[str, float]:
        preds, targets = self.preds, self.targets
        return self.engine.evaluate(preds, targets)
