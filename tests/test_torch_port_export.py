"""PyTorch port: cli/export.py (torch.export of the serving program, the
peak stage a registered op) and cli/convert_checkpoint.py, on the CPU.

- The peak op `torch.ops.centernet_lightning.peak_class_scores`: its CPU
  implementation is the kernel's plain twin, its fake implementation
  gives the output shapes under tracing, and a CPU call launches nothing.
- `export_program` round trip, float and int8: the saved `.pt2`, loaded
  again, holds the peak op (and, in int8, the int8 weights) and gives the
  predictor's own detections bitwise.
- `python -m centernet_lightning_torch.cli.export` with and without
  `--quantize-calibrate`; `--format onnx` without the `onnx` package exits
  non-zero naming it (the JAX package's tests/test_export.py leg).
- `cli.convert_checkpoint` on a synthetic Lightning checkpoint: the
  checkpoint directory it writes serves (`build_centernet(dir)`) the
  forward of `load_torch_checkpoint` bitwise, and the JAX package's
  `build_centernet(..., torch_ckpt=...)` of the same file within 1e-4.
"""
import os

import numpy as np
import pytest
import torch
import yaml

from centernet_lightning_torch import build_centernet
from centernet_lightning_torch.cli import convert_checkpoint as t_convert
from centernet_lightning_torch.cli import export as t_export
from centernet_lightning_torch.models.centernet import CenterNet
from centernet_lightning_torch.ops import peak_decode
from centernet_lightning_torch.quantize import Int8Conv2d
from centernet_lightning_torch.train.checkpoint import save_checkpoint

TINY = {"num_classes": 2, "backbone": "resnet18", "backbone_config": {"width": 16},
        "neck": "FPN", "neck_config": {"out_channels": 16},
        "head_config": {"width": 16, "depth": 1}, "num_detections": 5,
        "image_size": [32, 32]}
PEAK_OP = "centernet_lightning.peak_class_scores.default"


def images(seed, n=2, size=32):
    return np.random.default_rng(seed).integers(0, 255, (n, size, size, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("from_logits", [False, True])
def test_peak_op_cpu_is_the_twin_and_traces(from_logits):
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 7, 9, 3)).astype(np.float32))
    before = peak_decode.peak_class_scores_cuda.launches
    got = torch.ops.centernet_lightning.peak_class_scores(x, from_logits)
    ref = peak_decode.peak_class_scores_reference(x, from_logits)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert peak_decode.peak_class_scores_cuda.launches == before
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        s, lab = peak_decode.peak_class_scores_cuda(mode.from_tensor(x), from_logits)
    assert (s.shape, s.dtype, lab.shape, lab.dtype) == (
        (2, 63), torch.float32, (2, 63), torch.int32)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_export_roundtrip(tmp_path, int8):
    pred = build_centernet({"model": TINY}, device="cpu")
    if int8:
        pred = pred.quantize(images(1))
    path = str(tmp_path / "model.pt2")
    exported = t_export.export_program(pred, path, batch_size=2, height=32,
                                       width=32)
    targets = {str(n.target) for n in exported.graph.nodes
               if n.op == "call_function"}
    assert PEAK_OP in targets
    loaded = torch.export.load(path)
    int8_tensors = [k for k, v in loaded.state_dict.items() if v.dtype == torch.int8]
    assert bool(int8_tensors) == int8
    if int8:
        n_int8 = sum(isinstance(m, Int8Conv2d) for m in pred.model.modules())
        # one int8 weight buffer a conv (the layout the card's product takes)
        assert len([k for k in int8_tensors if k.endswith("weight_q")]) == n_int8
        assert len(int8_tensors) == n_int8
    program = loaded.module()
    x = images(2)
    got = program(torch.from_numpy(x))
    want = pred.detect(x)
    assert set(got) == set(want) == {"boxes", "scores", "labels"}
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _port_checkpoint(tmp_path):
    task = CenterNet(**TINY)
    task.init(torch.Generator().manual_seed(3))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, {"model": task.model.state_dict(), "step": 0},
                    hparams=task.hparams, step=0)
    return ckpt


def test_export_cli(tmp_path, capsys):
    import cv2

    ckpt = _port_checkpoint(tmp_path)
    photos = tmp_path / "photos"
    photos.mkdir()
    for i, img in enumerate(images(4, n=3, size=40)):
        cv2.imwrite(str(photos / f"{i}.png"), img)
    out = str(tmp_path / "f.pt2")
    assert t_export.main(["--checkpoint", ckpt, "--output", out, "--height", "32",
                          "--width", "32", "--device", "cpu"]) == 0
    out8 = str(tmp_path / "q.pt2")
    assert t_export.main(["--checkpoint", ckpt, "--output", out8, "--height", "32",
                          "--width", "32", "--batch-size", "2", "--device", "cpu",
                          "--quantize-calibrate", str(photos)]) == 0
    assert "calibrated on 3 images" in capsys.readouterr().err
    x = torch.from_numpy(images(5))
    f = torch.export.load(out).module()(x[:1])
    q = torch.export.load(out8).module()(x)
    assert f["boxes"].shape == (1, 5, 4) and q["boxes"].shape == (2, 5, 4)
    pred = build_centernet(ckpt, device="cpu")
    want = pred.detect(x[:1].numpy())
    for k in want:
        assert torch.equal(f[k], want[k]), k


def test_export_onnx_leg(tmp_path):
    """--format onnx: where `onnx` imports it writes the file; without it
    the CLI exits non-zero naming the package."""
    ckpt = _port_checkpoint(tmp_path)
    out = str(tmp_path / "model.onnx")
    argv = ["--checkpoint", ckpt, "--output", out, "--format", "onnx",
            "--height", "32", "--width", "32", "--device", "cpu"]
    try:
        import onnx  # noqa: F401
    except ImportError:
        with pytest.raises(SystemExit, match="onnx") as err:
            t_export.main(argv)
        assert err.value.code not in (0, None)
        assert not os.path.exists(out)
    else:
        assert t_export.main(argv) == 0
        assert os.path.getsize(out) > 0


def test_convert_checkpoint_roundtrip(tmp_path, capsys):
    """A Lightning-style checkpoint (`state_dict` under `model.`, beside the
    trainer's own entries) through cli.convert_checkpoint."""
    import jax.numpy as jnp

    from centernet_lightning_tpu import build_centernet as j_build

    cfg = dict(TINY, val_data={"transforms": [{"name": "Normalize", "init_args": {
        "mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25]}}]})
    task = CenterNet(**TINY)
    task.init(torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    state = {}
    for k, v in task.model.state_dict().items():   # seeded, BN statistics too
        if v.is_floating_point():
            v = v + 0.05 * torch.randn(v.shape, generator=gen)
            if k.endswith("running_var"):
                v = v.abs() + 0.5
        state["model." + k] = v
    lightning = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": state, "epoch": 3, "global_step": 120,
                "pytorch-lightning_version": "1.5.0"}, lightning)
    config = tmp_path / "model.yaml"
    config.write_text(yaml.safe_dump({"model": cfg}))
    out = str(tmp_path / "converted")
    assert t_convert.main(["--config", str(config), "--torch-ckpt", lightning,
                           "--output", out]) == 0
    assert "converted" in capsys.readouterr().out

    served = build_centernet(out, device="cpu")
    ref = CenterNet(**TINY)
    ref.load_torch_checkpoint(lightning)
    ref.model.to(memory_format=torch.channels_last).eval()   # as served
    x = images(6)
    with torch.no_grad():
        a = served.model(served.prepare_images(x))
        b = ref.model(served.prepare_images(x))
    assert served.mean == (0.5, 0.5, 0.5) and served.std == (0.25, 0.25, 0.25)
    for k in ("heatmap", "box_2d"):
        assert torch.equal(a[k], b[k]), k

    jpred = j_build(str(config), torch_ckpt=lightning)
    jx = jnp.asarray(np.asarray(served.prepare_images(x)))
    j_out = jpred(jx)
    for k in ("heatmap", "box_2d"):
        r = np.asarray(j_out[k])
        np.testing.assert_allclose(a[k].numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=k)
