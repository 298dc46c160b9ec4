from . import decode, peak_decode, preprocess
from .decode import (
    decode_detections,
    decode_detections_auto,
    gather_and_decode_boxes,
    gather_at_indices,
    get_topk_from_heatmap,
    peak_class_scores,
)
from .peak_decode import (
    decode_detections_fused,
    peak_class_scores_cuda,
    peak_class_scores_reference,
)
from .preprocess import IMAGENET_MEAN, IMAGENET_STD, preprocess
