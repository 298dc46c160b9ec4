from . import dcn, dcn_fused, dcn_sample, decode, peak_decode, preprocess
from .dcn_fused import dcn_fused_conv
from .dcn_sample import dcn_sample_taps
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
