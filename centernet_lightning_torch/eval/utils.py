"""Eval format converters (a copy of the JAX package's eval/utils.py):
dataset targets -> COCO-style annotation dicts, detections -> COCO results
json, plus the MOT-Challenge results writer used by inference_tracking."""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "ground_truth_to_coco_annotations",
    "voc_to_coco_annotations",
    "detections_to_coco_results",
    "write_mot_results",
]


def voc_to_coco_annotations(
    voc_dataset, save_path: Optional[str] = None
) -> Dict:
    """A VOCDataset -> in-memory COCO annotations dict (reference
    eval/utils.py:47-81), enabling COCO-protocol eval on VOC data."""
    targets = []
    for i in range(len(voc_dataset)):
        import os

        from ..data.voc import process_voc_xml

        name = voc_dataset.ids[i]
        boxes, labels = process_voc_xml(
            os.path.join(voc_dataset.data_dir, "Annotations", f"{name}.xml"),
            voc_dataset.name_to_label,
        )
        targets.append({"boxes": boxes, "labels": labels})
    out = ground_truth_to_coco_annotations(targets, voc_dataset.class_names)
    if save_path:
        with open(save_path, "w") as f:
            json.dump(out, f)
    return out


def ground_truth_to_coco_annotations(
    targets: List[Dict], cat_names: Optional[List[str]] = None
) -> Dict:
    """Per-image {boxes xywh, labels} -> an in-memory COCO annotations dict
    (reference eval/utils.py:6-46 and eval/coco.py create_coco:77-109)."""
    images, annotations = [], []
    ann_id = 1
    num_classes = 0
    for img_id, t in enumerate(targets, start=1):
        images.append({"id": img_id})
        boxes = np.asarray(t["boxes"], float).reshape(-1, 4)
        labels = np.asarray(t["labels"], int).reshape(-1)
        # honor a per-box annotation `area` when present (pycocotools GT
        # area semantics); box w*h is the reference's create_coco fallback
        areas = np.asarray(
            t["area"], float).reshape(-1) if "area" in t else (
            boxes[:, 2] * boxes[:, 3])
        crowds = np.asarray(
            t["iscrowd"], int).reshape(-1) if "iscrowd" in t else (
            np.zeros(len(labels), int))
        for box, label, area, crowd in zip(boxes, labels, areas, crowds):
            annotations.append({
                "id": ann_id,
                "image_id": img_id,
                "category_id": int(label),
                "bbox": [float(x) for x in box],
                "area": float(area),
                "iscrowd": int(crowd),
            })
            ann_id += 1
            num_classes = max(num_classes, int(label) + 1)
    # labels may exceed len(cat_names) (a lagging class_names list must
    # not crash export): fall back to the numeric name past the end
    cats = [
        {"id": i,
         "name": cat_names[i] if cat_names and i < len(cat_names) else str(i)}
        for i in range(max(num_classes, len(cat_names or [])))
    ]
    return {"images": images, "annotations": annotations, "categories": cats}


def detections_to_coco_results(
    image_ids: Sequence[int], preds: List[Dict], score_threshold: float = 0.0,
    save_path: Optional[str] = None,
) -> List[Dict]:
    """Detections -> COCO results-format list (reference eval/utils.py:83)."""
    results = []
    for img_id, p in zip(image_ids, preds):
        boxes = np.asarray(p["boxes"], float).reshape(-1, 4)
        scores = np.asarray(p["scores"], float).reshape(-1)
        labels = np.asarray(p["labels"], int).reshape(-1)
        for box, score, label in zip(boxes, scores, labels):
            if score < score_threshold:
                continue
            results.append({
                "image_id": int(img_id),
                "category_id": int(label),
                "bbox": [float(x) for x in box],
                "score": float(score),
            })
    if save_path:
        with open(save_path, "w") as f:
            json.dump(results, f)
    return results


def write_mot_results(
    path: str, frame_bboxes: Sequence, frame_track_ids: Sequence,
    img_width: float = 1.0, img_height: float = 1.0, start_frame: int = 0,
):
    """Append tracking output in MOT-Challenge format (1-based indices),
    matching the reference writer (fairmot.py:196-206)."""
    with open(path, "a") as f:
        for offset, (bboxes, ids) in enumerate(zip(frame_bboxes, frame_track_ids)):
            for box, tid in zip(bboxes, ids):
                x1 = box[0] * img_width
                y1 = box[1] * img_height
                x2 = box[2] * img_width
                y2 = box[3] * img_height
                f.write(
                    f"{start_frame + offset + 1},{int(tid) + 1},"
                    f"{x1 + 1},{y1 + 1},{x2 - x1},{y2 - y1},-1,-1,-1,-1\n"
                )
