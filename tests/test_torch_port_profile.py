"""PyTorch port: the profile tools cli/profile_serve.py and
cli/profile_train.py (ports of tools/profile_serve.py and
tools/profile_train.py) run with --device cpu on a narrow model at 64²
and print their JSON with every category and segment; the derived
segments are the differences the JAX tool defines (bwd = grad -
fwd_loss). On the CPU the categories are host op time, and the JSON says
so; the train tool reckons no MFU from its torch-op FLOP count. Slope times on a shared CPU are noise, so
only their presence is held.
"""
import json
import math

import pytest

from centernet_lightning_torch.cli import profile_serve, profile_train

TINY = {"num_classes": 80, "backbone": "resnet18",
        "backbone_config": {"width": 16}, "neck": "FPN",
        "neck_config": {"out_channels": 16},
        "head_config": {"width": 16, "depth": 1}, "num_detections": 100}
CATEGORIES = {"conv", "peak_kernel", "quantize_dequant", "other"}


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "int8"])
def test_profile_serve_cli(quantize, monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(profile_serve, "FLAGSHIP", TINY)
    argv = ["--device", "cpu", "--batch-size", "1", "--size", "64",
            "--trace", str(tmp_path)] + (["--quantize"] if quantize else [])
    assert profile_serve.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["time_of"].startswith("host")
    assert out["metric"].endswith("int8" if quantize else "f32")
    assert set(out["categories_ms"]) == set(out["categories_pct"]) == CATEGORIES
    assert out["categories_ms"]["conv"] > 0
    assert all(v >= 0 for v in out["categories_ms"].values())
    assert sum(out["categories_ms"].values()) == pytest.approx(out["ms_per_call"])
    # slope times of one and two calls on a shared CPU: any sign
    assert math.isfinite(out["ms_per_batch"]) and math.isfinite(out["images_per_sec"])
    # int8: quantize.py's stage ranges were read
    assert (out["categories_ms"]["quantize_dequant"] > 0) == quantize
    assert bool(out["int8_stage_ms"]) == quantize
    assert (tmp_path / "serve_trace.json").stat().st_size > 0


def test_profile_train_cli(monkeypatch, capsys):
    monkeypatch.setattr(profile_train, "FLAGSHIP", TINY)
    assert profile_train.main(["--device", "cpu", "--batch-size", "2",
                               "--size", "64"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["dtype"] == "f32"
    ms = out["ms"]
    assert set(ms) == {"full", "fwd", "fwd_loss", "grad", "render", "optim"}
    derived = out["ms_derived"]
    assert derived["bwd (grad - fwd_loss)"] == ms["grad"] - ms["fwd_loss"]
    assert derived["loss+render (fwd_loss - fwd)"] == ms["fwd_loss"] - ms["fwd"]
    assert derived["optimizer-in-context (full - grad)"] == ms["full"] - ms["grad"]
    # the torch ops' FLOPs, labelled as such; no utilization is reckoned
    assert out["torch_op_flops_per_step"] > 0
    assert "mfu_vs_peak" not in out and "peak_flops" not in out
    assert all(math.isfinite(v) for v in ms.values())
    assert math.isfinite(out["images_per_sec"])
