"""Public inference API (port of api.py).

    model = build_centernet({"model": {...}})                 # or a YAML path
    dets  = model.gather_detection2d(images)                  # numpy dict
    out   = model.inference_detection(img_dir)                # folder

The predictor runs on `device` ("cuda" unless the caller says otherwise;
there is no fallback to the CPU). Images are NHWC, uint8 raw or already
normalised float; uint8 batches are normalised on the device. On CUDA the
decode's peak stage is the hand-written kernel (ops/peak_decode.py).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch.func import functional_call

from .data.inference import InferenceDataset
from .models.centernet import CenterNet
from .ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, preprocess
from .train.checkpoint import load_checkpoint
from .train.config import load_config, normalize_config

__all__ = ["CenterNetPredictor", "build_centernet"]

_TRACKING = "tracking is ported with the tracking slice (ROADMAP Queue 1 item 10)"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _extract_norm(data_cfg: Optional[Dict]) -> tuple:
    """Pull Normalize(mean, std) out of a transforms config list."""
    for t in (data_cfg or {}).get("transforms", []) or []:
        if t.get("name") == "Normalize":
            args = t.get("init_args") or t.get("params") or {}
            return tuple(args.get("mean", IMAGENET_MEAN)), tuple(
                args.get("std", IMAGENET_STD)
            )
    return tuple(IMAGENET_MEAN), tuple(IMAGENET_STD)


def _to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    res = {"bboxes": out["boxes"].cpu().numpy(),
           "labels": out["labels"].cpu().numpy(),
           "scores": out["scores"].cpu().numpy()}
    if "embeddings" in out:
        res["embeddings"] = out["embeddings"].cpu().numpy()
    return res


class CenterNetPredictor:
    """Task + weights on one device, with the reference's inference API.

    compute_dtype ("bfloat16", "float16" or "float32"; None keeps float32)
    casts the weights, BatchNorm statistics included, and the activations;
    the decode's scores and boxes stay f32. The model is kept in eval mode
    and `torch.channels_last` memory format.
    """

    def __init__(self, task: CenterNet, image_size=(512, 512),
                 mean: Sequence[float] = IMAGENET_MEAN,
                 std: Sequence[float] = IMAGENET_STD,
                 compute_dtype: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        if compute_dtype is not None and compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, "
                             f"got {compute_dtype!r}")
        self.task = task
        self.device = torch.device(device)
        self.compute_dtype = _DTYPES[compute_dtype] if compute_dtype else None
        self.model = task.model.to(
            device=self.device, dtype=self.compute_dtype or torch.float32,
            memory_format=torch.channels_last).eval()
        self.image_size = tuple(image_size)
        self.mean = tuple(mean)
        self.std = tuple(std)

    def _dtype(self) -> torch.dtype:
        return self.compute_dtype or torch.float32

    def prepare_images(self, images) -> torch.Tensor:
        """The model's input: an NHWC batch on the device, uint8 normalised
        (ops/preprocess.py), float cast to the compute dtype."""
        x = torch.as_tensor(images).to(self.device)
        if x.dtype == torch.uint8:
            return preprocess(x, mean=self.mean, std=self.std,
                              dtype=self._dtype())
        return x.to(self._dtype())

    def __call__(self, images, train: bool = False):
        """Raw forward: the encoded NHWC outputs {heatmap (logits), box_2d}.
        Images are fed as given, only cast to the compute dtype.

        train=True runs the train-mode forward (batch statistics, autograd
        on) and returns (outputs, {"batch_stats": updated BatchNorm
        buffers}), as the JAX predictor returns flax's mutated variables;
        the predictor's own statistics are left as they were."""
        x = torch.as_tensor(images).to(self.device, self._dtype())
        if train:
            stats = {k: b.clone() for k, b in self.model.named_buffers()}
            self.model.train()
            try:
                outputs = functional_call(self.model, stats, (x,))
            finally:
                self.model.eval()
            return outputs, {"batch_stats": stats}
        with torch.inference_mode():
            return self.model(x)

    def detect(self, images, num_detections: Optional[int] = None,
               nms_kernel: Optional[int] = None,
               normalize_boxes: bool = False) -> Dict[str, torch.Tensor]:
        """Preprocess + forward + decode, leaving the results on the device
        (what `gather_detection2d` copies to the host)."""
        with torch.inference_mode():
            outputs = self.model(self.prepare_images(images))
            return self.task.decode_detections(
                outputs["heatmap"], outputs["box_2d"],
                reid=outputs.get("reid"), normalize_boxes=normalize_boxes,
                num_detections=num_detections, nms_kernel=nms_kernel,
                from_logits=True)

    def gather_detection2d(self, images, num_detections: Optional[int] = None,
                           nms_kernel: Optional[int] = None,
                           normalize_boxes: bool = False) -> Dict[str, np.ndarray]:
        """Forward + decode -> numpy {bboxes xyxy, labels, scores}.

        Takes images (uint8 raw or normalised float, NHWC) or the dict of
        encoded outputs that `predictor(images)` returns (the reference's
        two-step contract).
        """
        if isinstance(images, dict):
            with torch.inference_mode():
                out = self.task.decode_detections(
                    torch.as_tensor(images["heatmap"]).to(self.device),
                    torch.as_tensor(images["box_2d"]).to(self.device),
                    reid=(torch.as_tensor(images["reid"]).to(self.device)
                          if images.get("reid") is not None else None),
                    normalize_boxes=normalize_boxes,
                    num_detections=num_detections, nms_kernel=nms_kernel,
                    from_logits=True)
            return _to_numpy(out)
        return _to_numpy(self.detect(images, num_detections=num_detections,
                                     nms_kernel=nms_kernel,
                                     normalize_boxes=normalize_boxes))

    def inference_detection(self, img_dir: str, batch_size: int = 4,
                            num_detections: int = 100,
                            score_threshold: float = 0.0) -> Dict[str, np.ndarray]:
        """Detect over a folder: numpy {bboxes (I,K,4) xyxy in ORIGINAL
        image coords, labels (I,K), scores (I,K), image_paths}. Entries
        below `score_threshold` are masked out (label -1, score/box 0)."""
        ds = InferenceDataset(img_dir, resize=self.image_size)
        all_boxes, all_labels, all_scores, paths = [], [], [], []

        for start in range(0, len(ds), batch_size):
            items = [ds[i] for i in range(start, min(start + batch_size, len(ds)))]
            n = len(items)
            batch = np.stack([x["image"] for x in items])
            if n < batch_size:  # pad to a fixed batch shape
                pad = np.zeros((batch_size - n, *batch.shape[1:]), batch.dtype)
                batch = np.concatenate([batch, pad])
            dets = self.gather_detection2d(
                batch, num_detections=num_detections, normalize_boxes=True)
            for i, item in enumerate(items):
                scale = np.array([
                    item["original_width"], item["original_height"],
                    item["original_width"], item["original_height"],
                ], np.float32)
                keep = dets["scores"][i] >= score_threshold
                all_boxes.append(dets["bboxes"][i] * scale * keep[:, None])
                all_labels.append(np.where(keep, dets["labels"][i], -1))
                all_scores.append(dets["scores"][i] * keep)
                paths.append(item["image_path"])

        return {
            "bboxes": np.stack(all_boxes) if all_boxes else np.zeros((0, num_detections, 4)),
            "labels": np.stack(all_labels) if all_labels else np.zeros((0, num_detections), int),
            "scores": np.stack(all_scores) if all_scores else np.zeros((0, num_detections)),
            "image_paths": paths,
        }

    def gather_tracking2d(self, *args, **kwargs):
        raise NotImplementedError(_TRACKING)

    def track_stream(self, *args, **kwargs):
        raise NotImplementedError(_TRACKING)

    def inference_tracking(self, *args, **kwargs):
        raise NotImplementedError(_TRACKING)

    def quantize(self, *args, **kwargs):
        raise NotImplementedError(
            "quantize is ported with the serving and int8 slice "
            "(ROADMAP Queue 1 item 11)")


def build_centernet(
    config: Union[str, Dict[str, Any]],
    checkpoint: Optional[str] = None,
    seed: int = 0,
    torch_ckpt: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> CenterNetPredictor:
    """YAML path, config dict or checkpoint directory -> predictor on
    `device`. Gen-A and Gen-B config shapes are both accepted
    (train/config.py normalises them). Weights: from `torch_ckpt` (a
    reference Lightning checkpoint), else from the port's checkpoint
    (`checkpoint`, or `config` itself when it is a run directory with
    hparams.json; its EMA weights when it kept them), else drawn from a
    torch.Generator seeded by `seed`."""
    state = None
    if isinstance(config, str) and os.path.isdir(config):
        state, model_cfg = load_checkpoint(config)
        if model_cfg is None:
            raise ValueError(f"{config} has no hparams.json")
    else:
        if isinstance(config, str):
            config = load_config(config)
        config = normalize_config(config)
        model_cfg = dict(config.get("model", config))

    task = CenterNet(**{k: v for k, v in model_cfg.items()
                        if k in CenterNet.__dataclass_fields__})
    task.init(torch.Generator().manual_seed(seed))
    if checkpoint is not None:
        state, _ = load_checkpoint(checkpoint)
    if torch_ckpt is not None:
        task.load_torch_checkpoint(torch_ckpt)
    elif state is not None:
        weights = dict(state["model"])
        weights.update(state.get("ema_params") or {})
        task.model.load_state_dict(weights, strict=True)
    image_size = tuple(model_cfg.get("image_size", (512, 512)))
    mean, std = _extract_norm(model_cfg.get("val_data"))
    return CenterNetPredictor(task, image_size=image_size, mean=mean, std=std,
                              compute_dtype=model_cfg.get("compute_dtype"),
                              device=device)
