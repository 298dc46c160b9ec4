"""PyTorch port: cli/serve.py, the micro-batching detection service and its
HTTP layer, on the CPU.

- The JAX package's tests of tools/serve.py (tests/test_serve.py, a slow
  tier there), run on the port's `DetectionService` and `make_server` with
  a port predictor of the same model: 4 concurrent requests share one
  batch, the per-request score threshold, HTTP end to end on port 0
  (healthz, raw bytes, JSON base64 with a query threshold, 404 and 400).
- Served answers equal `gather_detection2d` on the same resized image,
  scaled to the original pixels, in float and in int8.
- `python -m centernet_lightning_torch.cli.serve` with
  `--quantize-images` (in-process, its server on port 0) answers
  /healthz and /v1/detect from an int8 predictor.
"""
import json
import threading
import time
import types
import urllib.request

import cv2
import numpy as np
import pytest
import torch

import test_serve as jax_serve_tests
from centernet_lightning_torch import build_centernet
from centernet_lightning_torch.api import QuantizedCenterNetPredictor
from centernet_lightning_torch.cli import serve as t_serve
from centernet_lightning_torch.train.checkpoint import save_checkpoint

# the model of the JAX package's serving tests
MODEL = dict(num_classes=2, backbone="resnet18", neck="SimpleNeck",
             neck_config={"upsample_channels": [16, 16, 16]},
             head_config={"width": 8, "depth": 1}, num_detections=6,
             image_size=[64, 64])


@pytest.fixture(scope="module")
def predictor():
    return build_centernet({"model": MODEL}, seed=0, device="cpu")


def on_port(fn):
    """A test of tests/test_serve.py with the port's service and server."""
    glob = dict(fn.__globals__, DetectionService=t_serve.DetectionService,
                make_server=t_serve.make_server)
    return types.FunctionType(fn.__code__, glob, fn.__name__, fn.__defaults__,
                              fn.__closure__)


@pytest.mark.parametrize("name", ["test_service_micro_batching",
                                  "test_service_per_request_threshold",
                                  "test_http_server_end_to_end"])
def test_jax_serve_tests_on_port(name, predictor):
    on_port(getattr(jax_serve_tests, name))(predictor)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_served_answers_equal_gather_detection2d(predictor, int8):
    pred = predictor
    if int8:
        calib = np.stack([jax_serve_tests.make_image(s, (64, 64)) for s in range(2)])
        pred = predictor.quantize(calib)
        assert isinstance(pred, QuantizedCenterNetPredictor)
    service = t_serve.DetectionService(pred, batch_size=4, max_wait_ms=200,
                                       num_detections=6,
                                       score_threshold=0.0).start()
    images = [jax_serve_tests.make_image(s, (40 + 8 * s, 72)) for s in range(3)]
    try:
        results = [None] * 3
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, service.submit(images[i]))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        service.stop()
    assert service.requests_served == 3 and service.batches_run < 3
    for img, res in zip(images, results):
        oh, ow = img.shape[:2]
        want = pred.gather_detection2d(cv2.resize(img, (64, 64))[None],
                                       num_detections=6, normalize_boxes=True)
        boxes = want["bboxes"][0] * np.array([ow, oh, ow, oh], np.float32)
        assert (res["width"], res["height"]) == (ow, oh)
        assert [d["label"] for d in res["detections"]] == want["labels"][0].tolist()
        np.testing.assert_allclose([d["score"] for d in res["detections"]],
                                   want["scores"][0], atol=5e-5)
        np.testing.assert_allclose([d["box"] for d in res["detections"]], boxes,
                                   atol=5e-3)


def test_serve_cli_int8_end_to_end(tmp_path, monkeypatch):
    """cli.serve.main with --quantize-images on a port checkpoint; its
    server is caught as it is made, asked, then shut down."""
    from centernet_lightning_torch.models.centernet import CenterNet

    task = CenterNet(**dict(MODEL, num_classes=3))
    task.init(torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, {"model": task.model.state_dict(), "step": 0},
                    hparams=task.hparams, step=0)
    photos = tmp_path / "photos"
    photos.mkdir()
    for i in range(3):
        cv2.imwrite(str(photos / f"img_{i:03d}.jpg"),
                    jax_serve_tests.make_image(i)[..., ::-1])
    (photos / "seqinfo.ini").write_text("[Sequence]\n")

    made = []
    real = t_serve.make_server
    monkeypatch.setattr(t_serve, "make_server",
                        lambda *a, **k: made.append(real(*a, **k)) or made[-1])
    rc = []
    thread = threading.Thread(target=lambda: rc.append(t_serve.main([
        "--checkpoint", ckpt, "--host", "127.0.0.1", "--port", "0",
        "--batch-size", "2", "--quantize-images", str(photos),
        "--quantize-n", "2", "--num-detections", "6",
        "--device", "cpu"])), daemon=True)
    thread.start()
    deadline = time.time() + 120
    while not made and time.time() < deadline and thread.is_alive():
        time.sleep(0.05)
    assert made, "the server never started"
    server = made[0]
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=30).read())
        assert health["status"] == "ok" and health["batch_size"] == 2
        assert health["checkpoint"] == ckpt
        ok, buf = cv2.imencode(".png", np.full((48, 72, 3), 128, np.uint8))
        req = urllib.request.Request(base + "/v1/detect?score_threshold=0",
                                     data=buf.tobytes(),
                                     headers={"Content-Type": "image/png"})
        out = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert (out["width"], out["height"]) == (72, 48)
        assert len(out["detections"]) == 6
    finally:
        server.shutdown()
        thread.join(timeout=30)
    assert rc == [0]
