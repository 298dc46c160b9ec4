"""Evaluation (port of eval/): the COCO protocol, the MOT metrics and the
format converters, numpy and the port's `native` library only."""
from .coco_eval import CocoEvaluator, COCOProtocolEval, box_iou_xywh
from .mot import (
    clear_metrics,
    evaluate_mot_tracking_from_file,
    evaluate_mot_tracking_sequence,
    evaluate_mot_tracking_sequences,
    hota_score,
    idf1_score,
)
from .utils import (
    voc_to_coco_annotations,
    detections_to_coco_results,
    ground_truth_to_coco_annotations,
    write_mot_results,
)

__all__ = ["CocoEvaluator", "COCOProtocolEval", "box_iou_xywh",
           "clear_metrics", "evaluate_mot_tracking_from_file",
           "evaluate_mot_tracking_sequence", "evaluate_mot_tracking_sequences",
           "hota_score", "idf1_score", "voc_to_coco_annotations",
           "detections_to_coco_results", "ground_truth_to_coco_annotations",
           "write_mot_results"]
