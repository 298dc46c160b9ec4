"""FairMOT tracking task: CenterNet detection + ReID identity learning
(port of models/fairmot.py).

The model gains the `reid` embedding head and the train-only identity
classifier through `reid_config` (models/meta.py). `train_forward` adds
the ReID loss to the detection losses: the embeddings are gathered at the
ground-truth box centres, and the identity objective is the classifier's
masked cross-entropy ("ce", the default) or a triplet margin loss on the
embeddings themselves ("triplet"), per `reid_config["loss_function"]`.
Over several processes both are the global batch's: the cross-entropy
divides by the global count, the triplet loss pairs the gathered rows of
every process.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from ..ops.decode import gather_at_indices
from ..ops.losses import reid_cross_entropy_loss, reid_triplet_loss
from ..parallel import dist
from .centernet import CenterNet

__all__ = ["FairMOT"]


@dataclass
class FairMOT(CenterNet):
    reid_loss_weight: float = 1.0

    def __post_init__(self):
        if self.reid_config is None:
            self.reid_config = {"emb_dim": 64, "max_track_ids": 1000}
        super().__post_init__()

    def reid_center_indices(self, batch: Dict[str, torch.Tensor], out_w: int,
                            out_h: int) -> torch.Tensor:
        """Flat map indices y*W + x of the boxes' centres (N, K): xywh
        input coordinates scaled to the map, truncated toward zero as
        JAX's astype(int32) does, then clipped to the map."""
        boxes = batch["boxes"].float()
        cx = (boxes[..., 0] + boxes[..., 2] / 2.0) / self.stride
        cy = (boxes[..., 1] + boxes[..., 3] / 2.0) / self.stride
        ix = torch.clamp(cx.to(torch.int32), 0, out_w - 1)
        iy = torch.clamp(cy.to(torch.int32), 0, out_h - 1)
        return iy * out_w + ix

    def train_forward(self, call: Callable, batch: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Detection + ReID losses of one batch, in f32.

        call(name, *args) runs the model's method `name` with the train
        step's parameters (train/state.py); batch: the detection contract
        with `image` already prepared (NHWC, the compute dtype) plus
        `ids` (N, K). Returns {heatmap, box_2d, reid, total}."""
        _, in_h, in_w, _ = batch["image"].shape
        indices = self.reid_center_indices(batch, in_w // self.stride,
                                           in_h // self.stride)
        outputs, logits = call("forward_with_classifier", batch["image"],
                               indices)
        losses = self.compute_loss(outputs, batch)
        ids = batch["ids"].reshape(-1).long()
        mask = batch["mask"].reshape(-1).float()
        if (self.reid_config or {}).get("loss_function", "ce") == "triplet":
            # the pairs span the global batch: every process scores the
            # same gathered rows
            emb = gather_at_indices(outputs["reid"], indices)
            reid_loss = reid_triplet_loss(
                dist.gather_rows(emb.reshape(-1, emb.shape[-1]).float()),
                dist.gather_rows(ids), dist.gather_rows(mask))
        else:
            reid_loss = reid_cross_entropy_loss(
                logits.float(), ids, mask,
                norm=dist.global_normalizer(mask.sum(), eps=1e-8))
        total = losses["total"] + reid_loss * self.reid_loss_weight
        return {**losses, "reid": reid_loss, "total": total}

    def gather_tracking2d(self, images: torch.Tensor,
                          num_detections: Optional[int] = None,
                          nms_kernel: Optional[int] = None
                          ) -> Dict[str, torch.Tensor]:
        """Forward + decode with normalised boxes and the ReID embeddings
        (images NHWC, on the model's device and in its dtype; the caller
        sets the model's mode)."""
        outputs = self.model(images)
        return self.decode_detections(
            outputs["heatmap"], outputs["box_2d"], reid=outputs["reid"],
            normalize_boxes=True, num_detections=num_detections,
            nms_kernel=nms_kernel, from_logits=True)
