"""CenterNet detection task, inference side (port of models/centernet.py).

The dataclass keeps the JAX task's fields, so one config builds either;
`__post_init__` builds the model and its output stride. Losses, targets
and checkpoint loading come with the training slice and raise until then.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from ..ops import decode as decode_ops
from .meta import create_model, init_weights

__all__ = ["CenterNet"]

_TRAINING_SLICE = "the training slice (ROADMAP Queue 1 item 7)"


@dataclass
class CenterNet:
    num_classes: int
    backbone: str = "resnet34"
    pretrained_backbone: Any = False
    neck: str = "FPN"
    neck_config: Optional[Dict[str, Any]] = None
    head_config: Optional[Dict[str, Any]] = None
    backbone_config: Optional[Dict[str, Any]] = None

    # box params
    box_init_bias: Optional[float] = None
    box_loss: str = "L1Loss"
    box_loss_weight: float = 0.1
    box_log: bool = False
    box_multiplier: float = 1.0

    # heatmap params
    heatmap_prior: float = 0.01
    heatmap_loss: str = "CornerNetFocalLoss"
    heatmap_loss_weight: float = 1.0
    heatmap_target: str = "cornernet"
    heatmap_target_params: Optional[Dict[str, float]] = None
    center_sampling_size: int = 3

    # inference config
    nms_kernel: int = 3
    num_detections: int = 100

    image_size: Any = (512, 512)
    input_channels: int = 3

    # data + optimizer passthrough (training slice)
    train_data: Optional[Dict[str, Any]] = None
    val_data: Optional[Dict[str, Any]] = None
    optimizer_config: Dict[str, Any] = field(default_factory=dict)

    reid_config: Optional[Dict[str, Any]] = None
    extra_block: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.pretrained_backbone:
            raise NotImplementedError(
                f"pretrained_backbone is loaded with {_TRAINING_SLICE}")
        self.image_size = tuple(self.image_size)
        self.model, self.stride = create_model(
            num_classes=self.num_classes,
            backbone=self.backbone,
            neck=self.neck,
            neck_config=self.neck_config,
            head_config=self.head_config,
            heatmap_prior=self.heatmap_prior,
            box_init_bias=self.box_init_bias,
            backbone_config=self.backbone_config,
            reid_config=self.reid_config,
            extra_block=self.extra_block,
            input_channels=self.input_channels,
        )

    def init(self, generator: torch.Generator) -> None:
        """Draw the model's weights afresh from `generator` (the JAX
        package's initialisers; see models/meta.py:init_weights)."""
        init_weights(self.model, generator)

    def compute_loss(self, outputs, targets, stride=None):
        raise NotImplementedError(f"compute_loss is ported with {_TRAINING_SLICE}")

    def load_torch_checkpoint(self, path_or_state, image_size=None):
        raise NotImplementedError(
            f"load_torch_checkpoint is ported with {_TRAINING_SLICE}")

    def decode_detections(
        self,
        heatmap: torch.Tensor,
        box_offsets: torch.Tensor,
        reid: Optional[torch.Tensor] = None,
        normalize_boxes: bool = False,
        num_detections: Optional[int] = None,
        nms_kernel: Optional[int] = None,
        from_logits: bool = False,
    ) -> Dict[str, torch.Tensor]:
        """heatmap: post-sigmoid (N, H, W, C), or logits with
        from_logits=True. CUDA maps go through the fused peak kernel."""
        return decode_ops.decode_detections_auto(
            heatmap, box_offsets, reid=reid,
            num_detections=num_detections or self.num_detections,
            nms_kernel=nms_kernel or self.nms_kernel,
            normalize_boxes=normalize_boxes,
            box_log=self.box_log,
            box_multiplier=self.box_multiplier,
            stride=self.stride,
            from_logits=from_logits,
        )

    def forward_and_decode(self, images: torch.Tensor,
                           normalize_boxes: bool = False,
                           num_detections: Optional[int] = None,
                           ) -> Dict[str, torch.Tensor]:
        """Forward + decode from logits. images: NHWC, on the model's
        device and in its dtype; the caller sets the model's mode (the
        predictor keeps it in eval)."""
        outputs = self.model(images)
        return self.decode_detections(
            outputs["heatmap"], outputs["box_2d"], reid=outputs.get("reid"),
            normalize_boxes=normalize_boxes, num_detections=num_detections,
            from_logits=True,
        )
