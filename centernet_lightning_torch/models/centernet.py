"""CenterNet detection task (port of models/centernet.py).

The dataclass keeps the JAX task's fields, so one config builds either;
`__post_init__` builds the model and its output stride. `compute_loss`
takes the padded CollateDetection targets {boxes (N, K, 4) xywh, labels
(N, K), mask (N, K)}, as the JAX task does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from ..ops import decode as decode_ops
from ..ops import losses as loss_ops
from ..ops import targets as target_ops
from .meta import create_model, init_weights

__all__ = ["CenterNet", "load_state_file"]


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
        if self.pretrained_backbone is True:
            raise RuntimeError(
                "pretrained_backbone=True would download torchvision weights; "
                "pass a local path to a torch state dict instead "
                "(pretrained_backbone: /path/to/resnet34.pth)")
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
        self._heatmap_loss_fn = loss_ops.get_heatmap_loss(self.heatmap_loss)
        self._box_loss_fn = loss_ops.get_box_loss(self.box_loss)
        self._radius_fn = target_ops.get_radius_fn(
            self.heatmap_target, **(self.heatmap_target_params or {}))

    def init(self, generator: torch.Generator) -> None:
        """Draw the model's weights afresh from `generator` (the JAX
        package's initialisers; see models/meta.py:init_weights), the ReID
        head and classifier of a `reid_config` included, then load
        `pretrained_backbone` when it names a file."""
        init_weights(self.model, generator)
        if self.pretrained_backbone:
            state = _strip(load_state_file(self.pretrained_backbone),
                           ("model.backbone.", "backbone.", "module."))
            # a torchvision file also holds the classifier (fc), and older
            # ones no BatchNorm batch counters
            missing, unexpected = self.model.backbone.load_state_dict(
                state, strict=False)
            missing = [k for k in missing if not k.endswith("num_batches_tracked")]
            unexpected = [k for k in unexpected if not k.startswith("fc.")]
            if missing or unexpected:
                raise KeyError(f"pretrained_backbone {self.pretrained_backbone}: "
                               f"missing {missing[:5]}, unexpected {unexpected[:5]}")

    def load_torch_checkpoint(self, path_or_state) -> None:
        """Load a reference Lightning checkpoint (.ckpt / .pth, or its state
        dict) of the whole model into `self.model`: the port keeps the
        Lightning key layout, so only the `state_dict` nesting and the
        `model.` prefix are stripped."""
        self.model.load_state_dict(_strip(load_state_file(path_or_state),
                                          ("model.",)), strict=True)

    def compute_loss(self, outputs: Dict[str, torch.Tensor],
                     targets: Dict[str, torch.Tensor],
                     stride: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Detection losses over one padded batch, in f32 whatever the
        forward's dtype: {heatmap: focal loss / max(1, boxes), box_2d: box
        loss over the S x S centre samples / max(1, samples), total:
        their weighted sum}.

        outputs: {heatmap (N, H, W, C) logits, box_2d (N, H, W, 4)};
        targets: {boxes (N, K, 4) xywh input coords, labels, mask (N, K)}.
        """
        stride = stride or self.stride
        heatmap = outputs["heatmap"].float()
        box_offsets = outputs["box_2d"].float()
        _, out_h, out_w, _ = heatmap.shape
        boxes = targets["boxes"].float()
        labels = targets["labels"].long()
        mask = targets["mask"].float()

        target_heatmap = target_ops.render_heatmap(
            boxes, labels, mask, self.num_classes, out_h, out_w, stride,
            self._radius_fn)
        heatmap_loss = loss_ops.reduce_loss(
            self._heatmap_loss_fn(heatmap, target_heatmap), "sum",
            norm=torch.clamp(mask.sum(), min=1.0))

        idx, sample_mask, target_xyxy = target_ops.center_sample_indices(
            boxes, mask, out_h, out_w, stride,
            sample_size=self.center_sampling_size)
        pred_boxes = decode_ops.gather_and_decode_boxes(
            box_offsets, idx, box_log=self.box_log,
            box_multiplier=self.box_multiplier, stride=stride)
        box_loss = loss_ops.reduce_loss(
            self._box_loss_fn(pred_boxes, target_xyxy), "sum",
            weights=sample_mask[..., None],
            norm=torch.clamp(sample_mask.sum(), min=1.0))

        total = (heatmap_loss * self.heatmap_loss_weight
                 + box_loss * self.box_loss_weight)
        return {"heatmap": heatmap_loss, "box_2d": box_loss, "total": total}

    def get_dataloader(self, train: bool = True):
        """The train (or validation) loader of the task's `train_data` (or
        `val_data`) section (data/builder.py:loader_from_config)."""
        from ..data.builder import loader_from_config

        config = dict((self.train_data if train else self.val_data) or {})
        if not config:
            raise ValueError("no train_data/val_data configured")
        return loader_from_config(config, train=train)

    @property
    def hparams(self) -> Dict[str, Any]:
        """The dataclass fields, as a checkpoint's hparams.json holds them."""
        return {name: getattr(self, name)
                for name in self.__dataclass_fields__}

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


def load_state_file(path_or_state) -> Dict[str, torch.Tensor]:
    """A state dict from a torch file (tensors only) or a dict, with a
    Lightning checkpoint's `state_dict` nesting removed."""
    obj = (torch.load(path_or_state, map_location="cpu", weights_only=True)
           if isinstance(path_or_state, (str, bytes)) or hasattr(
               path_or_state, "__fspath__") else path_or_state)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def _strip(state: Dict[str, torch.Tensor], prefixes) -> Dict[str, torch.Tensor]:
    """Drop the first of `prefixes` that some key carries, keeping only the
    keys under it."""
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in state):
            return {k[len(prefix):]: v for k, v in state.items()
                    if k.startswith(prefix)}
    return state
