"""Public inference API (port of api.py).

    model = build_centernet({"model": {...}})                 # or a YAML path
    dets  = model.gather_detection2d(images)                  # numpy dict
    out   = model.inference_detection(img_dir)                # folder
    out   = model.inference_tracking(img_dir, save_dir=...)   # MOT tracking
    for step in model.track_stream(batches, pipeline_depth=2): ...

The predictor runs on `device` ("cuda" unless the caller says otherwise;
there is no fallback to the CPU). Images are NHWC, uint8 raw or already
normalised float; uint8 batches go to the card from pinned memory without
waiting for it and are normalised there. On CUDA the decode's peak stage
is the hand-written kernel (ops/peak_decode.py). Tracking (a model with a
`reid_config`) runs the card's forward and decode and the host's
`Tracker` (models/tracker.py), pipelined so that the two overlap.
"""
from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence, Union

import numpy as np
import torch
from torch.func import functional_call

from .data.inference import InferenceDataset
from .eval.utils import write_mot_results
from .models.centernet import CenterNet
from .models.tracker import Tracker
from .ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, preprocess
from .train.checkpoint import load_checkpoint
from .train.config import load_config, normalize_config
from .utils import transfer
from .utils.viz import draw_boxes

__all__ = ["CenterNetPredictor", "QuantizedCenterNetPredictor", "build_centernet"]

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
        # on the device once, so preprocessing a batch makes no H2D copy
        self._norm = tuple(torch.tensor(v, dtype=self._dtype()).to(self.device)
                           for v in (self.mean, self.std))

    def _dtype(self) -> torch.dtype:
        return self.compute_dtype or torch.float32

    def upload(self, images) -> torch.Tensor:
        """`images` (numpy or a tensor) on the device. From the host, a
        CUDA upload goes through pinned memory without blocking on the
        current stream, so it returns before the card has finished the work
        queued before it (a pageable copy would wait for it)."""
        return transfer.upload(images, self.device)

    def prepare_images(self, images) -> torch.Tensor:
        """The model's input: an NHWC batch on the device, uint8 normalised
        (ops/preprocess.py), float cast to the compute dtype."""
        x = self.upload(images)
        if x.dtype == torch.uint8:
            return preprocess(x, mean=self._norm[0], std=self._norm[1],
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

    def gather_tracking2d(self, images, num_detections: Optional[int] = None,
                          nms_kernel: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Tracking decode -> numpy {bboxes (normalised xyxy), labels,
        scores, embeddings (f32)}."""
        return self.gather_detection2d(
            images, num_detections=num_detections, nms_kernel=nms_kernel,
            normalize_boxes=True)

    def _gather_tracking_device(self, images, num_detections: Optional[int] = None,
                                nms_kernel: Optional[int] = None
                                ) -> Dict[str, torch.Tensor]:
        """gather_tracking2d leaving the results on the device. Nothing in
        it waits for the card (a pinned upload, no value read back), so it
        returns while the card works and the caller overlaps host work."""
        return self.detect(images, num_detections=num_detections,
                           nms_kernel=nms_kernel, normalize_boxes=True)

    def track_stream(self, batches: Iterable, tracker_config: Optional[Dict] = None,
                     pipeline_depth: int = 1, **tracker_kwargs) -> Iterator[Dict]:
        """Pipelined tracking over an iterator of `(frames, n_valid)`
        pairs: `frames` a uint8 or float (B, H, W, 3) batch at the model's
        image size, of which the first `n_valid` are real (the rest pads a
        fixed batch shape).

        Yields one dict per valid frame, in order: {'bboxes': [xyxy
        normalised], 'track_ids': [int], 'num_detections': int} (the active
        tracks after that frame's association; num_detections counts the
        detections at or above the tracker's threshold that entered it).

        The card's forward and decode of batch i+1, and the copy of its
        top-k arrays to the host, are queued before the host associates
        batch i; the host then waits for batch i's copies alone (an event),
        not for the card's queue. pipeline_depth 1 queues on the caller's
        thread. At 2 or more a background thread keeps up to
        `pipeline_depth` batches in flight: it uploads each batch from
        pinned memory on a stream of its own, and the compute stream waits
        for that upload's event before the forward reads the frames.
        """
        if self.task.reid_config is None:
            raise ValueError("tracking needs a model with a reid head "
                             "(reid_config)")
        cfg = dict(tracker_config or {})
        cfg.update(tracker_kwargs)
        tracker = Tracker(model=self.gather_tracking2d, **cfg)
        kw = dict(num_detections=cfg.get("num_detections", tracker.num_detections),
                  nms_kernel=cfg.get("nms_kernel"))

        if pipeline_depth >= 2:
            pending = self._threaded_dispatch(batches, pipeline_depth, **kw)
        else:
            pending = self._inline_dispatch(batches, **kw)
        for n, host, event in pending:
            if event is not None:
                event.synchronize()
            boxes, labels, scores, embeddings = (
                host[k].numpy() for k in ("boxes", "labels", "scores",
                                          "embeddings"))
            for i in range(n):
                tracker.update(boxes[i], labels[i], scores[i], embeddings[i])
                tracker.frame += 1
                yield {
                    "bboxes": [t.bbox for t in tracker.tracks if t.active],
                    "track_ids": [t.track_id for t in tracker.tracks
                                  if t.active],
                    "num_detections": int(
                        (scores[i] >= tracker.detection_threshold).sum()),
                }

    def _dispatch(self, frames, **gather_kwargs):
        """Queue one batch's forward, decode and copies to the host:
        (host tensors, event)."""
        with torch.inference_mode():
            return transfer.host_copies(self._gather_tracking_device(frames,
                                                             **gather_kwargs))

    def _inline_dispatch(self, batches: Iterable, **gather_kwargs):
        """(n_valid, host tensors, event) for each batch, the next batch
        queued before the previous one is handed on."""
        pending = None
        for frames, n in batches:
            queued = (n, *self._dispatch(frames, **gather_kwargs))
            if pending is not None:
                yield pending
            pending = queued
        if pending is not None:
            yield pending

    def _threaded_dispatch(self, batches: Iterable, depth: int, **gather_kwargs):
        """Upload and queue batches on a background thread, up to `depth`
        in flight; yields (n_valid, host tensors, event) in input order. An
        exception on the thread is raised again here."""
        q: "queue.Queue" = queue.Queue(maxsize=max(depth - 1, 1))
        stop = threading.Event()
        end = object()
        cuda = self.device.type == "cuda"
        compute = torch.cuda.current_stream(self.device) if cuda else None

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                upload = torch.cuda.Stream(self.device) if cuda else None
                for frames, n in batches:
                    if stop.is_set():
                        return
                    if cuda:
                        with torch.cuda.stream(upload):
                            frames = self.upload(frames)
                        compute.wait_stream(upload)
                        # allocated on the upload stream, read on compute
                        frames.record_stream(compute)
                        with torch.cuda.stream(compute):
                            host, event = self._dispatch(frames, **gather_kwargs)
                    else:
                        host, event = self._dispatch(frames, **gather_kwargs)
                    if not put((n, host, event)):
                        return
            except BaseException as exc:  # raised again on the consumer
                put(exc)
                return
            put(end)

        thread = threading.Thread(target=worker, daemon=True,
                                  name="track_stream_dispatch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=60)

    def inference_tracking(self, img_dir: str, batch_size: int = 4,
                           save_dir: Optional[str] = None,
                           save_results: bool = False,
                           save_images: bool = False,
                           tracker_config: Optional[Dict] = None,
                           **tracker_kwargs) -> Dict[str, list]:
        """Track a folder of frames in file-name order. Returns per-frame
        {'bboxes', 'track_ids'}; with `save_dir`, writes MOT-format
        `tracking_results.txt` (save_results) and annotated frames under
        `images/` (save_images)."""
        ds = InferenceDataset(img_dir, resize=self.image_size)
        results_path = images_dir = None
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            if save_results:
                results_path = os.path.join(save_dir, "tracking_results.txt")
                if os.path.exists(results_path):
                    os.remove(results_path)
            if save_images:
                images_dir = os.path.join(save_dir, "images")
                os.makedirs(images_dir, exist_ok=True)

        # a frame's items are loaded before track_stream yields it; the
        # stream holds one batch in flight, so at most two batches wait here
        loaded_items = collections.deque()

        def batch_iter():
            for start in range(0, len(ds), batch_size):
                items = [ds[i] for i in
                         range(start, min(start + batch_size, len(ds)))]
                loaded_items.extend(items)
                batch = np.stack([x["image"] for x in items])
                if len(items) < batch_size:
                    pad = np.zeros((batch_size - len(items), *batch.shape[1:]),
                                   batch.dtype)
                    batch = np.concatenate([batch, pad])
                yield batch, len(items)

        out = {"bboxes": [], "track_ids": []}
        stream = self.track_stream(batch_iter(), tracker_config=tracker_config,
                                   **tracker_kwargs)
        for frame, step in enumerate(stream):
            item = loaded_items.popleft()
            out["bboxes"].append(step["bboxes"])
            out["track_ids"].append(step["track_ids"])
            if results_path:
                write_mot_results(
                    results_path, [step["bboxes"]], [step["track_ids"]],
                    img_width=item["original_width"],
                    img_height=item["original_height"], start_frame=frame)
            if images_dir:
                import cv2

                annotated = draw_boxes(item["image"], step["bboxes"],
                                       labels=step["track_ids"],
                                       normalized_boxes=True)
                cv2.imwrite(os.path.join(images_dir, f"{frame:06d}.jpg"),
                            cv2.cvtColor(annotated, cv2.COLOR_RGB2BGR))
        return out

    def quantize(self, calibration_images, exclude=None
                 ) -> "QuantizedCenterNetPredictor":
        """Calibrate and return an int8-serving predictor (quantize.py).

        calibration_images: one batch or a list of batches (uint8 raw or
        preprocessed float, NHWC) like the serving inputs; each is prepared
        exactly as a served batch is. The returned predictor has the same
        API, with every target convolution in int8 (on the card through
        `torch._int_mm`); this predictor's float model is left as it is.
        """
        from .quantize import default_exclude, quantize_model

        batches = (list(calibration_images)
                   if isinstance(calibration_images, (list, tuple))
                   else [calibration_images])
        with torch.no_grad():   # the copy's weights must be no inference tensors
            prepped = [self.prepare_images(b) for b in batches]
            qmodel = quantize_model(self.model, prepped,
                                    exclude=exclude or default_exclude)
        return QuantizedCenterNetPredictor(self, qmodel)


class QuantizedCenterNetPredictor(CenterNetPredictor):
    """int8-serving predictor made by `CenterNetPredictor.quantize()`.

    The same API as the float predictor (detection, tracking, the folder
    entry points and the two-step `__call__`), on a quantized copy of the
    model (`quantize.quantize_model`); `act_scales` holds the calibrated
    activation scales. `__call__(train=True)` stays the float forward of
    the predictor it was made from: int8 weights carry no gradients.
    """

    def __init__(self, base: CenterNetPredictor, qmodel: torch.nn.Module):
        self.__dict__.update(base.__dict__)
        self.model = qmodel
        self.act_scales = qmodel.act_scales
        self._float = base

    def __call__(self, images, train: bool = False):
        if train:
            return self._float(images, train=True)
        return super().__call__(images)


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
