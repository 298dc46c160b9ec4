"""MOT tracking metrics: MOTA (CLEAR), IDF1, HOTA (a copy of the JAX
package's eval/mot.py, which the port may not import).

The reference shells out to TrackEval through temp MOT-format files
(reference eval/mot_challenge.py:9-138) and flattens the result to
{HOTA, MOTA, IDF1}. TrackEval is not available here, so the three metric
families are implemented directly, following the TrackEval algorithms:

 - CLEAR: per-frame Hungarian with a continuity bonus for persisting last
   frame's matches, threshold IoU >= 0.5; MOTA = 1 - (FN+FP+IDSW)/nGT
 - IDF1: one global bipartite matching of gt-ids to pred-ids maximizing
   co-detected frames; IDF1 = 2*IDTP / (nGT + nPred)
 - HOTA: 19 alphas in 0.05:0.05:0.95; per-alpha per-frame Hungarian on the
   global-alignment-score-weighted similarity; HOTA_a = sqrt(DetA * AssA),
   reported as the mean over alphas

Inputs are per-frame lists of (boxes xywh, ids); any consistent coordinate
scale works (IoU is scale-invariant).
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
from ..native import lap_assign_or_scipy as linear_sum_assignment

from .coco_eval import box_iou_xywh

__all__ = ["evaluate_mot_tracking_sequence", "evaluate_mot_tracking_sequences",
           "evaluate_mot_tracking_from_file", "clear_metrics", "idf1_score",
           "hota_score"]

_EPS = np.finfo(float).eps


def _as_frames(bboxes, ids):
    frames = []
    for b, i in zip(bboxes, ids):
        b = np.asarray(b, np.float64).reshape(-1, 4)
        i = np.asarray(i, np.int64).reshape(-1)
        frames.append((b, i))
    return frames


def clear_metrics(gt_frames, pred_frames, iou_threshold: float = 0.5) -> Dict[str, float]:
    """CLEAR MOT: MOTA, MOTP, FP/FN/IDSW counts."""
    num_gt = num_fp = num_fn = num_idsw = 0
    num_tp = 0
    motp_sum = 0.0
    prev_match = {}  # gt_id -> pred_id from the last frame it was matched

    for (gt_boxes, gt_ids), (pr_boxes, pr_ids) in zip(gt_frames, pred_frames):
        num_gt += len(gt_ids)
        if len(gt_ids) == 0:
            num_fp += len(pr_ids)
            continue
        if len(pr_ids) == 0:
            num_fn += len(gt_ids)
            continue

        sim = box_iou_xywh(gt_boxes, pr_boxes)
        # continuity bonus: prefer keeping last frame's id assignment
        score = sim.copy()
        for gi, gid in enumerate(gt_ids):
            if gid in prev_match:
                pj = np.where(pr_ids == prev_match[gid])[0]
                if len(pj):
                    score[gi, pj[0]] += 1000.0 * (sim[gi, pj[0]] >= iou_threshold - _EPS)
        # TrackEval CLEAR zeroes sub-threshold pairs BEFORE the assignment
        # (score_mat[sim < thr - eps] = 0): without this the Hungarian can
        # burn a prediction on a pair it must then reject, losing a valid
        # cross match (2 GT x 2 dets with IoUs [[.49,.51],[.51,.60]] must
        # yield TP=2, not TP=1)
        score[sim < iou_threshold - _EPS] = 0.0
        rows, cols = linear_sum_assignment(-score)
        matched_g, matched_p = [], []
        for r, c in zip(rows, cols):
            if sim[r, c] >= iou_threshold - _EPS:
                matched_g.append(r)
                matched_p.append(c)
                motp_sum += sim[r, c]

        num_tp += len(matched_g)
        num_fn += len(gt_ids) - len(matched_g)
        num_fp += len(pr_ids) - len(matched_p)
        for r, c in zip(matched_g, matched_p):
            gid, pid = gt_ids[r], pr_ids[c]
            if gid in prev_match and prev_match[gid] != pid:
                num_idsw += 1
            prev_match[gid] = pid

    mota = 1.0 - (num_fn + num_fp + num_idsw) / max(1, num_gt)
    motp = motp_sum / max(1, num_tp)
    return {
        "MOTA": mota, "MOTP": motp, "CLR_GT": num_gt,
        "CLR_TP": num_tp, "CLR_FN": num_fn, "CLR_FP": num_fp, "IDSW": num_idsw,
    }


def idf1_score(gt_frames, pred_frames, iou_threshold: float = 0.5) -> Dict[str, float]:
    """ID metrics via one global gt-id x pred-id bipartite match."""
    gt_ids_all = sorted({int(i) for _, ids in gt_frames for i in ids})
    pr_ids_all = sorted({int(i) for _, ids in pred_frames for i in ids})
    g_index = {g: i for i, g in enumerate(gt_ids_all)}
    p_index = {p: i for i, p in enumerate(pr_ids_all)}
    nG, nP = len(gt_ids_all), len(pr_ids_all)

    gt_counts = np.zeros(nG)
    pr_counts = np.zeros(nP)
    overlap = np.zeros((nG, nP))  # frames where the pair is IoU-matched

    for (gt_boxes, gt_ids), (pr_boxes, pr_ids) in zip(gt_frames, pred_frames):
        gi = np.array([g_index[int(i)] for i in gt_ids], dtype=int)
        pj = np.array([p_index[int(i)] for i in pr_ids], dtype=int)
        if len(gi):
            gt_counts[gi] += 1
        if len(pj):
            pr_counts[pj] += 1
        if len(gi) and len(pj):
            sim = box_iou_xywh(gt_boxes, pr_boxes)
            # ids are unique within a frame, so np.ix_ accumulation is safe
            overlap[np.ix_(gi, pj)] += sim >= iou_threshold - _EPS

    num_gt = gt_counts.sum()
    num_pr = pr_counts.sum()
    if nG == 0 and nP == 0:
        return {"IDF1": 1.0, "IDTP": 0, "IDFN": 0, "IDFP": 0}

    # square cost matrix with unmatched cost (TrackEval identity matching)
    size = nG + nP
    cost = np.zeros((size, size))
    cost[:nG, :nP] = -overlap
    rows, cols = linear_sum_assignment(cost)
    idtp = 0.0
    for r, c in zip(rows, cols):
        if r < nG and c < nP:
            idtp += overlap[r, c]
    idfn = num_gt - idtp
    idfp = num_pr - idtp
    idf1 = 2 * idtp / max(_EPS, num_gt + num_pr)
    return {"IDF1": idf1, "IDTP": idtp, "IDFN": idfn, "IDFP": idfp}


def hota_score(gt_frames, pred_frames) -> Dict[str, float]:
    """HOTA following TrackEval's two-pass algorithm."""
    alphas = np.arange(0.05, 0.96, 0.05)
    gt_ids_all = sorted({int(i) for _, ids in gt_frames for i in ids})
    pr_ids_all = sorted({int(i) for _, ids in pred_frames for i in ids})
    g_index = {g: i for i, g in enumerate(gt_ids_all)}
    p_index = {p: i for i, p in enumerate(pr_ids_all)}
    nG, nP = len(gt_ids_all), len(pr_ids_all)
    if nG == 0 or nP == 0:
        det = 0.0 if (nG or nP) else 1.0
        n_alpha = len(alphas)
        n_gt_det = sum(len(ids) for _, ids in gt_frames)
        n_pr_det = sum(len(ids) for _, ids in pred_frames)
        return {"HOTA": det, "DetA": det, "AssA": det,
                "_tp": np.zeros(n_alpha),
                "_fn": np.full(n_alpha, float(n_gt_det)),
                "_fp": np.full(n_alpha, float(n_pr_det)),
                "_assa": np.full(n_alpha, det)}

    # pass 1: global alignment score
    pot = np.zeros((nG, nP))
    g_count = np.zeros(nG)
    p_count = np.zeros(nP)
    sims = []
    for (gt_boxes, gt_ids), (pr_boxes, pr_ids) in zip(gt_frames, pred_frames):
        sim = box_iou_xywh(gt_boxes, pr_boxes)
        sims.append(sim)
        if len(gt_ids) and len(pr_ids):
            denom = sim.sum(0)[None, :] + sim.sum(1)[:, None] - sim
            sim_iou = np.where(sim > _EPS, sim / np.maximum(denom, _EPS), 0.0)
            gi = np.array([g_index[int(i)] for i in gt_ids])
            pj = np.array([p_index[int(i)] for i in pr_ids])
            pot[np.ix_(gi, pj)] += sim_iou
        for i in gt_ids:
            g_count[g_index[int(i)]] += 1
        for i in pr_ids:
            p_count[p_index[int(i)]] += 1
    align = pot / np.maximum(g_count[:, None] + p_count[None, :] - pot, _EPS)

    # pass 2: per-alpha matching
    hotas, detas, assas = [], [], []
    tps, fns, fps = [], [], []
    for alpha in alphas:
        tp = fn = fp = 0
        match_count = np.zeros((nG, nP))
        for ((gt_boxes, gt_ids), (pr_boxes, pr_ids)), sim in zip(
            zip(gt_frames, pred_frames), sims
        ):
            if len(gt_ids) == 0:
                fp += len(pr_ids)
                continue
            if len(pr_ids) == 0:
                fn += len(gt_ids)
                continue
            gi = np.array([g_index[int(i)] for i in gt_ids])
            pj = np.array([p_index[int(i)] for i in pr_ids])
            score = align[np.ix_(gi, pj)] * sim
            rows, cols = linear_sum_assignment(-score)
            kept = sim[rows, cols] >= alpha - _EPS
            n_kept = int(kept.sum())
            tp += n_kept
            fn += len(gt_ids) - n_kept
            fp += len(pr_ids) - n_kept
            for r, c in zip(rows[kept], cols[kept]):
                match_count[gi[r], pj[c]] += 1

        deta = tp / max(_EPS, tp + fn + fp)
        if tp > 0:
            ass = match_count / np.maximum(
                g_count[:, None] + p_count[None, :] - match_count, _EPS
            )
            assa = float((ass * match_count).sum() / tp)
        else:
            assa = 0.0
        detas.append(deta)
        assas.append(assa)
        hotas.append(np.sqrt(deta * assa))
        tps.append(tp)
        fns.append(fn)
        fps.append(fp)

    return {
        "HOTA": float(np.mean(hotas)),
        "DetA": float(np.mean(detas)),
        "AssA": float(np.mean(assas)),
        # per-alpha counters for multi-sequence combination
        # (TrackEval combine_sequences: sum counts, TP-weight AssA)
        "_tp": np.asarray(tps, np.float64),
        "_fn": np.asarray(fns, np.float64),
        "_fp": np.asarray(fps, np.float64),
        "_assa": np.asarray(assas, np.float64),
    }


def evaluate_mot_tracking_sequence(
    pred_bboxes: Sequence, pred_track_ids: Sequence,
    target_bboxes: Sequence, target_track_ids: Sequence,
) -> Dict[str, float]:
    """Per-frame lists of xywh boxes + track ids -> {HOTA, MOTA, IDF1}
    (the reference's flattened output, eval/mot_challenge.py:9-83)."""
    gt_frames = _as_frames(target_bboxes, target_track_ids)
    pred_frames = _as_frames(pred_bboxes, pred_track_ids)
    out = {}
    out.update({"MOTA": clear_metrics(gt_frames, pred_frames)["MOTA"]})
    out.update({"IDF1": idf1_score(gt_frames, pred_frames)["IDF1"]})
    out.update({"HOTA": hota_score(gt_frames, pred_frames)["HOTA"]})
    return out


def evaluate_mot_tracking_sequences(per_sequence: Dict) -> Dict[str, float]:
    """Evaluate each sequence SEPARATELY, then combine counters the
    TrackEval way (the reference evaluates one tracker per sequence,
    eval/mot_challenge.py:9-83 + fairmot.py:87-136; pooling frames across
    sequences corrupts IDSW/IDF1/HOTA at every boundary).

    per_sequence: {name: {'pred_bboxes', 'pred_track_ids',
                          'target_bboxes', 'target_track_ids'}}
    Returns combined {HOTA, MOTA, IDF1} plus per-sequence
    '<name>/HOTA|MOTA|IDF1'.

    Combination (TrackEval combine_sequences):
     - CLEAR: sum GT/FN/FP/IDSW -> MOTA = 1 - (FN+FP+IDSW)/GT
     - Identity: sum IDTP/IDFN/IDFP -> IDF1 = 2*IDTP/(2*IDTP+IDFN+IDFP)
     - HOTA: per-alpha sum TP/FN/FP; AssA = TP-weighted mean; finally
       HOTA = mean_alpha sqrt(DetA*AssA)
    """
    clr = {"CLR_GT": 0, "CLR_FN": 0, "CLR_FP": 0, "IDSW": 0}
    ident = {"IDTP": 0.0, "IDFN": 0.0, "IDFP": 0.0}
    hota_tp = hota_fn = hota_fp = hota_ass = None
    out: Dict[str, float] = {}

    for name, seq in per_sequence.items():
        gt_frames = _as_frames(seq["target_bboxes"], seq["target_track_ids"])
        pred_frames = _as_frames(seq["pred_bboxes"], seq["pred_track_ids"])

        c = clear_metrics(gt_frames, pred_frames)
        i = idf1_score(gt_frames, pred_frames)
        h = hota_score(gt_frames, pred_frames)
        out[f"{name}/MOTA"] = c["MOTA"]
        out[f"{name}/IDF1"] = i["IDF1"]
        out[f"{name}/HOTA"] = h["HOTA"]

        for key in clr:
            clr[key] += c[key]
        for key in ident:
            ident[key] += i[key]
        if hota_tp is None:
            hota_tp = np.zeros_like(h["_tp"])
            hota_fn = np.zeros_like(h["_fn"])
            hota_fp = np.zeros_like(h["_fp"])
            hota_ass = np.zeros_like(h["_assa"])
        hota_tp += h["_tp"]
        hota_fn += h["_fn"]
        hota_fp += h["_fp"]
        hota_ass += h["_assa"] * h["_tp"]

    out["MOTA"] = 1.0 - (clr["CLR_FN"] + clr["CLR_FP"] + clr["IDSW"]) / max(
        1, clr["CLR_GT"])
    out["IDF1"] = 2 * ident["IDTP"] / max(
        _EPS, 2 * ident["IDTP"] + ident["IDFN"] + ident["IDFP"])
    if hota_tp is None:
        out["HOTA"] = 1.0
    else:
        deta = hota_tp / np.maximum(_EPS, hota_tp + hota_fn + hota_fp)
        assa = hota_ass / np.maximum(_EPS, hota_tp)
        out["HOTA"] = float(np.mean(np.sqrt(deta * assa)))
    return out


# MOT-Challenge distractor classes: person-on-vehicle, static person,
# distractor, reflection (TrackEval MotChallenge2DBox preprocessing)
_DISTRACTOR_CLASSES = (2.0, 7.0, 8.0, 12.0)


def _parse_mot_txt(path: str, gt: bool = False):
    """MOT-Challenge txt -> per-frame arrays. For tracker files:
    {frame: (xywh boxes, ids)}. For GT files every row is kept (all
    classes, zero-marked included) as {frame: (boxes, ids, classes,
    consider)} — TrackEval's MotChallenge2DBox preprocessing needs the
    full GT set for the joint distractor assignment; scoring filters to
    considered pedestrian rows afterwards (`_preprocess_frame`)."""
    frames: Dict[int, list] = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 6:
                    continue
                frame, tid = int(float(parts[0])), int(float(parts[1]))
                box = [float(v) for v in parts[2:6]]
                if gt:
                    consider = float(parts[6]) if len(parts) > 6 else 1.0
                    cls = float(parts[7]) if len(parts) > 7 else 1.0
                    frames.setdefault(frame, []).append(
                        (box, tid, cls, consider))
                else:
                    frames.setdefault(frame, []).append((box, tid))
    out = {}
    for frame, rows in frames.items():
        boxes = np.asarray([r[0] for r in rows], np.float64)
        ids = np.asarray([r[1] for r in rows], np.int64)
        if gt:
            out[frame] = (boxes, ids,
                          np.asarray([r[2] for r in rows], np.float64),
                          np.asarray([r[3] for r in rows], np.float64))
        else:
            out[frame] = (boxes, ids)
    return out


def _preprocess_frame(gt_boxes, gt_ids, gt_classes, gt_consider,
                      pred_boxes, pred_ids, iou_threshold: float = 0.5):
    """TrackEval MotChallenge2DBox per-frame preprocessing: ONE joint
    Hungarian assignment of tracker dets against ALL GT rows (every class,
    zero-marked included; scores below the IoU threshold zeroed), then
    remove only the tracker dets whose ASSIGNED GT row is a distractor
    class — a det overlapping both a pedestrian and a distractor stays if
    the assignment prefers the pedestrian. The GT scoring set is then
    filtered to considered pedestrian rows (class 1/-1, consider != 0).

    Returns (gt_boxes, gt_ids, pred_boxes, pred_ids) ready for scoring."""
    if len(pred_boxes) and len(gt_boxes):
        sim = box_iou_xywh(gt_boxes, pred_boxes)
        scores = np.where(sim < iou_threshold - _EPS, 0.0, sim)
        rows, cols = linear_sum_assignment(-scores)
        matched = scores[rows, cols] > _EPS
        rows, cols = rows[matched], cols[matched]
        drop = cols[np.isin(gt_classes[rows], _DISTRACTOR_CLASSES)]
        keep = np.setdiff1d(np.arange(len(pred_boxes)), drop)
        pred_boxes, pred_ids = pred_boxes[keep], pred_ids[keep]
    score_mask = (gt_consider != 0) & np.isin(gt_classes, (1.0, -1.0))
    return gt_boxes[score_mask], gt_ids[score_mask], pred_boxes, pred_ids


def evaluate_mot_tracking_from_file(
    gt_folder: str, trackers_folder: str, trackers_to_eval=None,
    seqmap_file: str = None,
) -> Dict[str, float]:
    """Evaluate MOT-format result FILES against a MOT-Challenge GT tree —
    the reference's TrackEval bridge (eval/mot_challenge.py:87-138),
    implemented directly (no temp-config TrackEval run). Applies TrackEval's
    MotChallenge2DBox preprocessing: one joint Hungarian assignment per
    frame of tracker detections against ALL GT rows (IoU >= 0.5), removing
    only detections assigned to a distractor-class row (person-on-vehicle,
    static person, distractor, reflection) before scoring; zero-marked and
    non-pedestrian GT rows are excluded from the scoring set.

    Layout: `<gt_folder>/<seq>/gt/gt.txt` (+ seqinfo.ini), tracker results
    at `<trackers_folder>/<tracker>/<seq>.txt`. Sequences come from
    `seqmap_file` (one name per line, header ignored) or the gt_folder
    listing; trackers from `trackers_to_eval` or the trackers_folder
    listing. Returns the combined {HOTA, MOTA, IDF1} (+ per-sequence
    breakdowns) for a single tracker, or {tracker: metrics} for several.
    """
    if seqmap_file:
        with open(seqmap_file) as f:
            seqs = [l.strip() for l in f if l.strip() and l.strip() != "name"]
    else:
        seqs = sorted(
            d for d in os.listdir(gt_folder)
            if os.path.isdir(os.path.join(gt_folder, d))
        )
    if trackers_to_eval is None:
        trackers = sorted(
            d for d in os.listdir(trackers_folder)
            if os.path.isdir(os.path.join(trackers_folder, d))
        )
    else:
        trackers = list(np.atleast_1d(trackers_to_eval))

    results = {}
    for tracker in trackers:
        per_seq = {}
        for seq in seqs:
            gt_frames = _parse_mot_txt(
                os.path.join(gt_folder, seq, "gt", "gt.txt"), gt=True)
            pr_frames = _parse_mot_txt(
                os.path.join(trackers_folder, tracker, f"{seq}.txt"))
            last = max(list(gt_frames) + list(pr_frames) + [0])
            empty_gt = (np.zeros((0, 4)), np.zeros(0, np.int64),
                        np.zeros(0), np.zeros(0))
            empty = (np.zeros((0, 4)), np.zeros(0, np.int64))
            processed = [
                _preprocess_frame(*gt_frames.get(f, empty_gt),
                                  *pr_frames.get(f, empty))
                for f in range(1, last + 1)
            ]
            per_seq[seq] = {
                "target_bboxes": [p[0] for p in processed],
                "target_track_ids": [p[1] for p in processed],
                "pred_bboxes": [p[2] for p in processed],
                "pred_track_ids": [p[3] for p in processed],
            }
        results[tracker] = evaluate_mot_tracking_sequences(per_seq)
    if len(results) == 1:
        return next(iter(results.values()))
    return results
