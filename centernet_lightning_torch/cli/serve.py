"""HTTP detection server for a checkpoint (port of tools/serve.py): one
fixed-shape serving batch on the card, a micro-batching queue so that
concurrent requests share it, and a standard-library HTTP layer.

    python -m centernet_lightning_torch.cli.serve \
        --checkpoint runs/coco/checkpoints --port 8000 \
        [--batch-size 8] [--max-wait-ms 5] [--quantize-images photos/]

API:
    GET  /healthz            -> {"status": "ok", model info}
    POST /v1/detect          -> body: raw image bytes (any format OpenCV
                                decodes) or JSON {"image_b64": "..."};
                                optional query ?score_threshold=0.3
                             <- {"detections": [{"box": [x1,y1,x2,y2],
                                 "label": i, "score": s, "class_name": ...}],
                                 "width": W, "height": H, "latency_ms": t}

A request is decoded and resized on its handler thread, then queued; one
batcher thread drains up to --batch-size requests (waiting at most
--max-wait-ms for stragglers), pads them to the fixed batch and runs one
forward and decode for the batch (`gather_detection2d`). Boxes come back
in the original image's pixels (xyxy). Decoding and resizing need OpenCV.
"""
from __future__ import annotations

import argparse
import base64
import json
import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import read_class_names

__all__ = ["DetectionService", "make_server", "main"]


@dataclass
class _Pending:
    image: Any                      # uint8 (H, W, 3) at the model's size
    original_hw: tuple
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None


class DetectionService:
    """Micro-batching wrapper around a `CenterNetPredictor` (float or int8).

    `submit(image_rgb)` is thread-safe and blocks until the batcher thread
    has run the request in a shared fixed-shape batch. `batches_run` and
    `requests_served` count what it did. Usable without the HTTP layer."""

    def __init__(self, predictor, batch_size: int = 8, max_wait_ms: float = 5.0,
                 num_detections: int = 100, score_threshold: float = 0.3,
                 class_names: Optional[List[str]] = None):
        self.predictor = predictor
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.num_detections = int(num_detections)
        self.score_threshold = float(score_threshold)
        self.class_names = class_names
        self.queue: "queue.Queue[_Pending]" = queue.Queue()
        self.requests_served = 0
        self.batches_run = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._batcher, daemon=True,
                                        name="detection_batcher")

    def _run(self, batch: np.ndarray) -> Dict[str, np.ndarray]:
        return self.predictor.gather_detection2d(
            batch, num_detections=self.num_detections, normalize_boxes=True)

    def start(self, warmup: bool = True) -> "DetectionService":
        if warmup:   # the first batch's one-time costs before any request
            h, w = self.predictor.image_size
            self._run(np.zeros((self.batch_size, h, w, 3), np.uint8))
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def submit(self, image_rgb: np.ndarray, score_threshold: Optional[float] = None,
               timeout: float = 60.0) -> Dict[str, Any]:
        """image_rgb: uint8 (H, W, 3) at its original size. Returns the
        response dict (boxes in original pixels)."""
        import cv2

        oh, ow = image_rgb.shape[:2]
        h, w = self.predictor.image_size
        item = _Pending(image=cv2.resize(image_rgb, (w, h)), original_hw=(oh, ow))
        self.queue.put(item)
        if not item.event.wait(timeout):
            raise TimeoutError("detection batcher did not respond")
        if item.error:
            raise RuntimeError(item.error)
        thr = self.score_threshold if score_threshold is None else score_threshold
        dets = [d for d in item.result["detections"] if d["score"] >= thr]
        return dict(item.result, detections=dets)

    def _batcher(self) -> None:
        h, w = self.predictor.image_size
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            items = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(items) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    items.append(self.queue.get(timeout=remaining))
                except queue.Empty:
                    break
            batch = np.zeros((self.batch_size, h, w, 3), np.uint8)
            for i, it in enumerate(items):
                batch[i] = it.image
            try:
                dets = self._run(batch)
            except Exception as e:  # every waiter of the batch sees it
                for it in items:
                    it.error = f"{type(e).__name__}: {e}"
                    it.event.set()
                continue
            self.batches_run += 1
            for i, it in enumerate(items):
                oh, ow = it.original_hw
                boxes = dets["bboxes"][i] * np.array([ow, oh, ow, oh], np.float32)
                out = []
                for box, label, score in zip(boxes, dets["labels"][i],
                                             dets["scores"][i]):
                    d = {"box": [round(float(v), 2) for v in box],
                         "label": int(label), "score": round(float(score), 4)}
                    if self.class_names and 0 <= label < len(self.class_names):
                        d["class_name"] = self.class_names[int(label)]
                    out.append(d)
                it.result = {"detections": out, "width": ow, "height": oh}
                self.requests_served += 1
                it.event.set()


def make_server(service: DetectionService, host: str, port: int,
                model_info: Optional[Dict[str, Any]] = None):
    """A ThreadingHTTPServer wired to `service` (call serve_forever and
    shutdown yourself; port 0 takes a free port, `server.server_port`)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    import cv2

    info = dict(model_info or {})

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if urlparse(self.path).path in ("/healthz", "/"):
                self._reply(200, {
                    "status": "ok",
                    "requests_served": service.requests_served,
                    "batches_run": service.batches_run,
                    "batch_size": service.batch_size,
                    "image_size": list(service.predictor.image_size),
                    **info,
                })
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/v1/detect":
                self._reply(404, {"error": f"no route {parsed.path}"})
                return
            try:
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                if self.headers.get("Content-Type", "").startswith("application/json"):
                    raw = base64.b64decode(json.loads(raw)["image_b64"])
                img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
                if img is None:
                    self._reply(400, {"error": "could not decode image"})
                    return
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
                qs = parse_qs(parsed.query)
                thr = (float(qs["score_threshold"][0])
                       if "score_threshold" in qs else None)
                t0 = time.perf_counter()
                result = service.submit(img, score_threshold=thr)
                result["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
                self._reply(200, result)
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Serve a detection checkpoint")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--batch-size", type=int, default=8,
                        help="fixed device batch; concurrent requests share it")
    parser.add_argument("--max-wait-ms", type=float, default=5.0,
                        help="micro-batching window for stragglers")
    parser.add_argument("--num-detections", type=int, default=100)
    parser.add_argument("--score-threshold", type=float, default=0.3)
    parser.add_argument("--class-names", default=None,
                        help="json/txt file, one class name per line")
    parser.add_argument("--quantize-images", default=None, metavar="DIR",
                        help="serve int8, calibrated on images in DIR")
    parser.add_argument("--quantize-n", type=int, default=8,
                        help="calibration images to take from DIR")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from ..api import build_centernet

    predictor = build_centernet(
        args.config or args.checkpoint,
        checkpoint=args.checkpoint if args.config else None,
        device=args.device)
    if args.quantize_images:
        from ..quantize import load_calibration_images

        calib = load_calibration_images(args.quantize_images, args.quantize_n,
                                        predictor.image_size)
        predictor = predictor.quantize(calib)
        print(f"int8 serving: calibrated on {len(calib)} images",
              file=sys.stderr)

    service = DetectionService(
        predictor, batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
        num_detections=args.num_detections,
        score_threshold=args.score_threshold,
        class_names=read_class_names(args.class_names)).start()
    server = make_server(service, args.host, args.port,
                         model_info={"checkpoint": args.checkpoint})
    print(json.dumps({"serving": f"http://{args.host}:{server.server_port}",
                      "batch_size": args.batch_size}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
