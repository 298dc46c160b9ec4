"""PyTorch port: the command-line entry points (cli/) against the JAX
package's root train.py and tools/, in-process on the CPU.

- The JAX package's own tests of train.py's helpers
  (tests/test_utils_misc.py: the logger config, the validation interval,
  the resolved config), run against cli/train.py (`run_on_port`).
- For every shipped YAML, with `Trainer` and the loaders stubbed in both
  CLIs so nothing trains: the resolved config.yaml byte-equal to the JAX
  CLI's, the same warnings, the same loader configs and the same Trainer
  keyword arguments (the port's adds `device`, "cuda" by default).
- One `cli.train` run at 64^2 on packs (2 steps, validation, diagnostics)
  writes the metric names that a JAX train.py run of the same YAML writes.
- `cli.validate`, `cli.detect` and `cli.track` against tools/validate.py,
  tools/detect.py and tools/track.py on a JAX checkpoint carried into the
  port's checkpoint format by utils/convert.py: the metrics within 1e-4,
  the same COCO results (labels, boxes within 1e-4), the same MOT track
  ids; `--quantize 2` calibrates each tool's predictor and serves int8;
  the entry points default to the card.
- `python -m centernet_lightning_torch.cli.train --help` in a subprocess.
"""
import glob
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)   # the JAX package's train CLI lives at the root

import train as jax_train_cli  # noqa: E402
import test_packed as jax_packed_tests  # noqa: E402
import test_track_cli as jax_track_tests  # noqa: E402
import test_utils_misc as jax_misc_tests  # noqa: E402
from centernet_lightning_tpu.data.packed import pack_dataset  # noqa: E402
from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet  # noqa: E402
from centernet_lightning_tpu.models.fairmot import FairMOT as JFairMOT  # noqa: E402
from centernet_lightning_tpu.train import checkpoint as j_ckpt  # noqa: E402
from centernet_lightning_tpu.utils import compilation_cache  # noqa: E402

import centernet_lightning_torch.api as t_api  # noqa: E402
from centernet_lightning_torch.cli import detect as t_detect  # noqa: E402
from centernet_lightning_torch.cli import track as t_track  # noqa: E402
from centernet_lightning_torch.cli import train as t_train  # noqa: E402
from centernet_lightning_torch.cli import validate as t_validate  # noqa: E402
from centernet_lightning_torch.models.centernet import CenterNet  # noqa: E402
from centernet_lightning_torch.models.fairmot import FairMOT  # noqa: E402
from centernet_lightning_torch.train.checkpoint import save_checkpoint  # noqa: E402
from centernet_lightning_torch.utils.convert import variables_to_state_dict  # noqa: E402

from _torch_port_helpers import (assert_detections_match,  # noqa: E402
                                 random_flax_variables, run_on_port)

coco_dir = jax_packed_tests.coco_dir
mot_sequence = jax_track_tests.mot_sequence
SHIPPED = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
IMG = 64
SMALL = dict(num_classes=2, backbone="resnet18", backbone_config={"width": 16},
             neck="FPN", neck_config={"out_channels": 8},
             head_config={"width": 8, "depth": 1}, num_detections=6,
             image_size=[IMG, IMG])


def run_jax_main(path, argv, monkeypatch, capsys):
    """A JAX package CLI (root train.py or tools/*.py), in-process, with
    the persistent compilation cache left off; returns its stdout."""
    monkeypatch.setattr(compilation_cache, "enable_compilation_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [os.path.basename(path), *argv])
    capsys.readouterr()
    if path.endswith("train.py"):
        jax_train_cli.main()
    else:
        runpy.run_path(path, run_name="__main__")
    return capsys.readouterr().out


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


# ---- train.py's helpers ------------------------------------------------

@pytest.mark.parametrize("name", [
    "test_parse_logger_config", "test_parse_logger_config_lightning_shapes",
    "test_val_interval_mapping", "test_save_resolved_config_writes_yaml"])
def test_jax_cli_helper_tests_on_port(name, request, monkeypatch):
    monkeypatch.setitem(sys.modules, "train", t_train)
    run_on_port(jax_misc_tests, name, request, monkeypatch, ())


# ---- every shipped YAML, nothing trained -------------------------------

class StubTrainer:
    """Records its arguments; fit() does nothing."""
    seen = None

    def __init__(self, task, **kwargs):
        StubTrainer.seen = (task, kwargs)

    def fit(self):
        pass


def stubbed_run(module, monkeypatch, run):
    """Run a CLI (`run()` returns its stdout) with its Trainer and loaders
    stubbed: (task, Trainer kwargs, loader calls, stdout)."""
    calls = []

    def loader(cfg, train, seed=None):
        calls.append((json.dumps(cfg, sort_keys=True), train))
        return ("loader", len(calls))

    monkeypatch.setattr(module, "Trainer", StubTrainer)
    monkeypatch.setattr(module, "loader_from_config", loader)
    out = run()
    return (*StubTrainer.seen, calls, out)


@pytest.mark.parametrize("config", SHIPPED, ids=os.path.basename)
def test_train_cli_same_config_and_trainer_args(config, tmp_path, monkeypatch,
                                               capsys):
    argv = ["--config", config, "--max-epochs", "3"]
    j_task, j_kw, j_calls, j_out = stubbed_run(
        jax_train_cli, monkeypatch, lambda: run_jax_main(
            "train.py", argv + ["--workdir", str(tmp_path / "j")],
            monkeypatch, capsys))
    t_task, t_kw, t_calls, t_out = stubbed_run(
        t_train, monkeypatch, lambda: (
            t_train.main(argv + ["--workdir", str(tmp_path / "t")]),
            capsys.readouterr().out)[1])
    with open(tmp_path / "j" / "config.yaml", "rb") as f:
        j_yaml = f.read()
    with open(tmp_path / "t" / "config.yaml", "rb") as f:
        assert f.read() == j_yaml
    assert t_out == j_out                       # the unknown-key warnings
    assert t_calls == j_calls
    assert type(t_task).__name__ == type(j_task).__name__
    shared = set(t_task.hparams) & set(j_task.hparams)
    assert {k: t_task.hparams[k] for k in shared} == {
        k: j_task.hparams[k] for k in shared}
    assert t_kw.pop("device") == "cuda"
    for key in ("ckpt_dir", "log_dir"):
        assert os.path.relpath(t_kw.pop(key), tmp_path / "t") == \
            os.path.relpath(j_kw.pop(key), tmp_path / "j")
    assert t_kw == j_kw
    assert t_kw["max_epochs"] == 3


# ---- one real run of each train CLI on packs ---------------------------

def packs(coco_dir, tmp_path):
    cfg = jax_packed_tests.data_cfg(coco_dir)
    for split in ("train", "val"):
        pack_dataset(cfg, str(tmp_path / split), train=split == "train")
    return str(tmp_path / "train"), str(tmp_path / "val")


@pytest.fixture
def one_thread():
    """Torch on one intra-op thread (restored after the test): the test
    runs beside other test processes, and its models are tiny."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_cli_metric_names_equal_jax(coco_dir, tmp_path, monkeypatch,
                                          capsys, one_thread):
    """The same YAML through both CLIs (2 steps, a validation, the
    diagnostics, the JSONL logger only): the same metric names."""
    import yaml

    train_dir, val_dir = packs(coco_dir, tmp_path)
    config = {
        "model": dict(SMALL, optimizer_config={"optimizer": "Adam", "lr": 1e-3,
                                               "warmup_epochs": 0},
                      train_data={"type": "packed", "data_dir": train_dir,
                                  "batch_size": 2, "flip_p": 0.5},
                      val_data={"type": "packed", "data_dir": val_dir,
                                "batch_size": 2}),
        # wandb is not installed: the JSONL file is the only backend
        "trainer": {"max_epochs": 1, "log_every_n_steps": 1,
                    "logger": "WandbLogger"}}
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(config))

    def names(workdir):
        rows = [json.loads(line) for line in
                open(os.path.join(workdir, "logs", "metrics.jsonl"))]
        return rows, {k for r in rows for k in r} - {"step", "time"}

    with pytest.warns(UserWarning, match="wandb"):
        assert t_train.main(["--config", str(path), "--workdir",
                             str(tmp_path / "t"), "--device", "cpu"]) == 0
    with pytest.warns(UserWarning, match="wandb"):
        run_jax_main("train.py", ["--config", str(path), "--workdir",
                                  str(tmp_path / "j")], monkeypatch, capsys)
    t_rows, t_names = names(tmp_path / "t")
    j_rows, j_names = names(tmp_path / "j")
    assert t_names == j_names
    assert {"train/total_loss", "train/lr", "train/images_per_sec", "val/mAP",
            "diagnostics/det_scores/p50"} <= t_names
    assert [r["step"] for r in t_rows] == [r["step"] for r in j_rows]
    assert all(np.isfinite(v) for r in t_rows for k, v in r.items())
    assert os.listdir(tmp_path / "t" / "checkpoints" / "best")


# ---- validate / detect / track against tools/ ---------------------------

def checkpoints(tmp_path, task_cls_pair, cfg, seed):
    """A JAX checkpoint of seeded weights and the same weights carried into
    the port's checkpoint format: (jax_dir, port_dir)."""
    j_cls, t_cls = task_cls_pair
    jtask = j_cls(**cfg)
    variables = random_flax_variables(jtask, np.random.default_rng(seed),
                                      image_size=(IMG, IMG))
    # seeded weights on raw images saturate the scores at 1: a smaller last
    # heatmap convolution spreads them around the prior
    out_conv = variables["params"]["heads_heatmap"]["out_conv"]
    out_conv["kernel"] = out_conv["kernel"] * np.float32(1e-3)
    j_dir, t_dir = str(tmp_path / "j_ckpt"), str(tmp_path / "t_ckpt")
    j_ckpt.save_checkpoint(j_dir, {**variables, "step": 0},
                           hparams=jtask.hparams, step=0)
    restored, hparams = j_ckpt.load_checkpoint(j_dir)
    save_checkpoint(t_dir, {"model": variables_to_state_dict(restored),
                            "step": 0},
                    hparams=t_cls(**{k: v for k, v in hparams.items()
                                     if k in t_cls.__dataclass_fields__}).hparams,
                    step=0)
    return j_dir, t_dir


def results_arrays(results, n_images, k):
    """A COCO results list (each image's detections in score order) as
    (n_images, k) arrays, images in id order, boxes xywh."""
    out = {"scores": np.zeros((n_images, k)), "labels": np.zeros((n_images, k), int),
           "boxes": np.zeros((n_images, k, 4))}
    row = {i: n for n, i in enumerate(sorted({r["image_id"] for r in results}))}
    count = [0] * n_images
    for r in results:
        i = row[r["image_id"]]
        j = count[i]
        count[i] += 1
        out["scores"][i, j], out["labels"][i, j] = r["score"], r["category_id"]
        out["boxes"][i, j] = r["bbox"]
    assert count == [k] * n_images
    return out


def test_validate_cli_equal_jax(coco_dir, tmp_path, monkeypatch, capsys,
                                one_thread):
    img_dir, ann = coco_dir
    j_dir, t_dir = checkpoints(tmp_path, (JCenterNet, CenterNet), SMALL, 1)
    args = ["--img-dir", img_dir, "--ann-json", ann, "--batch-size", "2",
            "--image-size", str(IMG), "--num-detections", "6"]
    j_metrics = last_json(run_jax_main(
        os.path.join(REPO, "tools", "validate.py"),
        args + ["--checkpoint", j_dir,
                "--save-results", str(tmp_path / "j.json")], monkeypatch, capsys))
    assert t_validate.main(args + ["--checkpoint", t_dir, "--device", "cpu",
                                   "--save-results", str(tmp_path / "t.json")]) == 0
    t_metrics = last_json(capsys.readouterr().out)
    assert t_metrics.keys() == j_metrics.keys() and len(t_metrics) == 12
    for k, v in j_metrics.items():
        assert abs(t_metrics[k] - v) <= 1e-4 + 1e-9, k
    assert_detections_match(
        results_arrays(json.load(open(tmp_path / "j.json")), 5, 6),
        results_arrays(json.load(open(tmp_path / "t.json")), 5, 6),
        rtol=1e-4, atol=1e-4)


def test_validate_cli_audits_dcn_offsets(coco_dir, tmp_path, capsys,
                                         one_thread):
    """A model with deformable FPN merges: the offsets of the first batch,
    as the model sees it, are audited on stderr before validation (the
    audit itself is held to the JAX package's in
    test_torch_port_dcn_model.py)."""
    from centernet_lightning_torch.utils.dcn_audit import (
        audit_dcn_offsets, format_dcn_audit)

    img_dir, ann = coco_dir
    cfg = dict(SMALL, neck_config=dict(SMALL["neck_config"], conv_type="dcn"))
    _, t_dir = checkpoints(tmp_path, (JCenterNet, CenterNet), cfg, 4)
    assert t_validate.main(["--checkpoint", t_dir, "--img-dir", img_dir,
                            "--ann-json", ann, "--batch-size", "2",
                            "--image-size", str(IMG), "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert len(last_json(captured.out)) == 12
    pred = t_api.build_centernet(t_dir, device="cpu")
    first = next(iter(validate_loader(img_dir, ann, pred)))
    expected = format_dcn_audit(
        audit_dcn_offsets(pred.task, pred.prepare_images(first["image"])), None)
    assert expected.startswith("DCN offset audit over 3 layer(s)")
    assert expected in captured.err


def validate_loader(img_dir, ann, pred):
    """The loader cli.validate builds (Resize to IMG, the predictor's
    Normalize, batches of 2)."""
    from centernet_lightning_torch.data import (CocoDetection, build_dataloader,
                                                build_transforms)

    tf = build_transforms([
        {"name": "Resize", "init_args": {"height": IMG, "width": IMG}},
        {"name": "Normalize", "init_args": {"mean": list(pred.mean),
                                            "std": list(pred.std)}}])
    return build_dataloader(CocoDetection(img_dir, ann, transforms=tf),
                            batch_size=2, shuffle=False, num_workers=0,
                            max_boxes=128, drop_last=False)


def test_detect_cli_equal_jax(coco_dir, tmp_path, monkeypatch, capsys,
                              one_thread):
    img_dir, _ = coco_dir
    j_dir, t_dir = checkpoints(tmp_path, (JCenterNet, CenterNet), SMALL, 2)
    names = tmp_path / "names.txt"
    names.write_text("cat\ndog\n")
    args = ["--images", img_dir, "--batch-size", "2", "--num-detections", "6",
            "--score-threshold", "0.0", "--save-images",
            "--class-names", str(names)]
    j_sum = last_json(run_jax_main(
        os.path.join(REPO, "tools", "detect.py"),
        args + ["--checkpoint", j_dir, "--out", str(tmp_path / "j")],
        monkeypatch, capsys))
    assert t_detect.main(args + ["--checkpoint", t_dir, "--device", "cpu",
                                 "--out", str(tmp_path / "t")]) == 0
    t_sum = last_json(capsys.readouterr().out)
    for s, d in ((j_sum, "j"), (t_sum, "t")):
        assert s.pop("results") == str(tmp_path / d / "detections.json")
    assert t_sum == j_sum == {"images": 5, "detections": 30,
                              "detections_in_json": 30}
    assert_detections_match(
        results_arrays(json.load(open(tmp_path / "j" / "detections.json")), 5, 6),
        results_arrays(json.load(open(tmp_path / "t" / "detections.json")), 5, 6),
        rtol=1e-4, atol=1e-4)
    for name in ("image_paths.json",):
        assert (open(tmp_path / "t" / name).read()
                == open(tmp_path / "j" / name).read())
    assert (sorted(os.listdir(tmp_path / "t" / "images"))
            == sorted(os.listdir(tmp_path / "j" / "images")))


def read_mot(path):
    rows = [line.split(",") for line in open(path).read().splitlines() if line]
    return ([(int(r[0]), int(r[1])) for r in rows],
            np.array([[float(x) for x in r[2:6]] for r in rows]))


def test_track_cli_equal_jax(mot_sequence, tmp_path, monkeypatch, capsys,
                             one_thread):
    gt_root, frames = mot_sequence
    cfg = dict(SMALL, num_classes=1, reid_config={"emb_dim": 8,
                                                  "max_track_ids": 8})
    j_dir, t_dir = checkpoints(tmp_path, (JFairMOT, FairMOT), cfg, 3)
    args = ["--frames", frames, "--batch-size", "2", "--eval-gt", gt_root,
            "--seq", "SEQ-01", "--tracker", "detection_threshold=0.0",
            "min_birth_age=1"]
    j_sum = last_json(run_jax_main(
        os.path.join(REPO, "tools", "track.py"),
        args + ["--checkpoint", j_dir, "--out", str(tmp_path / "j")],
        monkeypatch, capsys))
    assert t_track.main(args + ["--checkpoint", t_dir, "--device", "cpu",
                                "--out", str(tmp_path / "t")]) == 0
    t_sum = last_json(capsys.readouterr().out)
    for s, d in ((j_sum, "j"), (t_sum, "t")):
        assert s.pop("results") == str(tmp_path / d / "tracking_results.txt")
    assert t_sum.keys() == j_sum.keys() and {"HOTA", "MOTA", "IDF1"} <= set(t_sum)
    for k, v in j_sum.items():
        assert abs(t_sum[k] - v) <= 1e-4, k
    j_ids, j_boxes = read_mot(tmp_path / "j" / "tracking_results.txt")
    t_ids, t_boxes = read_mot(tmp_path / "t" / "tracking_results.txt")
    assert t_ids == j_ids and len(t_ids) > 0
    np.testing.assert_allclose(t_boxes, j_boxes, rtol=1e-4, atol=1e-3)


def port_checkpoint(tmp_path, cfg, seed):
    """A port checkpoint directory of seeded weights (the port's init)."""
    task_cls = FairMOT if cfg.get("reid_config") else CenterNet
    task = task_cls(**cfg)
    task.init(torch.Generator().manual_seed(seed))
    out = str(tmp_path / "q_ckpt")
    save_checkpoint(out, {"model": task.model.state_dict(), "step": 0},
                    hparams=task.hparams, step=0)
    return out


@pytest.mark.parametrize("module", [t_validate, t_detect, t_track],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tools_quantize_runs_int8_and_card_default(module, tmp_path, monkeypatch,
                                                   capsys, request, one_thread):
    """`--quantize 2 --device cpu` calibrates on two images, frames or
    batches, serves in int8 (a QuantizedCenterNetPredictor) and writes the
    tool's outputs; without `--device` the tool builds on the card."""
    name = module.__name__.rsplit(".", 1)[-1]
    if name == "track":
        gt_root, frames = request.getfixturevalue("mot_sequence")
        cfg = dict(SMALL, num_classes=1, reid_config={"emb_dim": 8,
                                                      "max_track_ids": 8})
        args = ["--frames", frames, "--out", str(tmp_path / "out"),
                "--batch-size", "2", "--tracker", "detection_threshold=0.0"]
        unit, wrote = "frames", "tracking_results.txt"
    else:
        img_dir, ann = request.getfixturevalue("coco_dir")
        cfg = SMALL
        if name == "validate":
            args = ["--img-dir", img_dir, "--ann-json", ann, "--batch-size", "2",
                    "--image-size", str(IMG), "--save-results",
                    str(tmp_path / "out" / "results.json")]
            unit, wrote = "batches", "results.json"
        else:
            args = ["--images", img_dir, "--out", str(tmp_path / "out"),
                    "--batch-size", "2", "--score-threshold", "0.0"]
            unit, wrote = "images", "detections.json"
    os.makedirs(tmp_path / "out", exist_ok=True)
    args += ["--checkpoint", port_checkpoint(tmp_path, cfg, 5)]

    served = []
    quantize = t_api.CenterNetPredictor.quantize

    def spy(self, calibration_images, exclude=None):
        served.append(quantize(self, calibration_images, exclude))
        return served[-1]

    monkeypatch.setattr(t_api.CenterNetPredictor, "quantize", spy)
    capsys.readouterr()
    assert module.main(args + ["--quantize", "2", "--device", "cpu"]) == 0
    captured = capsys.readouterr()
    assert f"int8 serving: calibrated on 2 {unit}" in captured.err
    assert len(served) == 1
    assert isinstance(served[0], t_api.QuantizedCenterNetPredictor)
    assert served[0].act_scales
    assert os.path.getsize(tmp_path / "out" / wrote) > 0
    summary = last_json(captured.out)
    assert {"validate": len(summary) == 12, "detect": summary.get("images") == 5,
            "track": summary.get("frames") == 6}[name], summary

    class Built(Exception):
        pass

    def build(config, checkpoint=None, device="cuda", **kw):
        raise Built(device)

    monkeypatch.setattr(t_api, "build_centernet", build)
    with pytest.raises(Built, match="^cuda$"):
        module.main(args)


def test_train_cli_help_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "centernet_lightning_torch.cli.train", "--help"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    for text in ("--config", "--workdir", "--max-epochs", "--profile",
                 "--no-resume", "--device", "--multihost", "LOCAL_RANK"):
        assert text in out.stdout, text
    # --multihost is an option now, no longer a note that it waits
    assert "[--multihost]" in out.stdout and "waits" not in out.stdout
