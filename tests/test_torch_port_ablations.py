"""PyTorch port: the ablation tool (cli/run_ablations.py) and the shapes
datasets (data/shapes.py) against tools/run_ablations.py and
tools/make_shapes_dataset.py, on the CPU.

- ARMS, SUITES, REF and DATASET_SEED equal the tool's; each arm's task,
  loaders and Trainer arguments equal what the tool's `run_arm` passes to
  the JAX package (its classes stubbed to record them), the device and
  precision aside;
- every arm builds, with the JAX package's parameter count;
- one arm (dcn_fast, so the offset audit runs) trains one epoch on the
  24-image smoke set, writes its result file, and `--report` renders it;
  the tool's own preemption and dataset-marker tests, on the port;
- the shapes writers give the same JPEG bytes and JSON as the tool's for
  the same seed, v1 and v2.
"""
import json
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tools.make_shapes_dataset as j_shapes
import tools.run_ablations as j_abl
from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet

from centernet_lightning_torch.cli import run_ablations as t_abl
from centernet_lightning_torch.data import shapes as t_shapes
from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet

ARM_IDS = list(j_abl.ARMS)


def test_tables_equal_the_tool():
    assert t_abl.ARMS == j_abl.ARMS
    assert list(t_abl.ARMS) == list(j_abl.ARMS)
    assert t_abl.SUITES == j_abl.SUITES
    assert t_abl.REF == j_abl.REF
    assert t_abl.DATASET_SEED == j_abl.DATASET_SEED


class _Recorded(Exception):
    pass


def jax_arm_arguments(arm, seed, out, root, monkeypatch):
    """What the tool's run_arm passes to CenterNet, loader_from_config and
    Trainer: (task kwargs, [(loader config, train, seed)], Trainer kwargs)."""
    import centernet_lightning_tpu.data.builder as j_builder
    import centernet_lightning_tpu.models.centernet as j_centernet
    import centernet_lightning_tpu.train.trainer as j_trainer
    import centernet_lightning_tpu.utils.compilation_cache as j_cache

    seen = {"loaders": []}

    def task(**kwargs):
        seen["task"] = kwargs
        return "task"

    def loader(cfg, train, seed=None):
        seen["loaders"].append((cfg, train, seed))
        return "loader"

    def trainer(task, train_loader, val_loader, **kwargs):
        assert (train_loader, val_loader) == ("loader", "loader")
        seen["trainer"] = kwargs
        raise _Recorded

    monkeypatch.setattr(j_centernet, "CenterNet", task)
    monkeypatch.setattr(j_builder, "loader_from_config", loader)
    monkeypatch.setattr(j_trainer, "Trainer", trainer)
    monkeypatch.setattr(j_cache, "enable_compilation_cache", lambda: None)
    monkeypatch.setattr(j_abl, "ensure_dataset", lambda out, v2=False: root)
    with pytest.raises(_Recorded):
        j_abl.run_arm(arm, seed, out, 40)
    monkeypatch.undo()
    return seen["task"], seen["loaders"], seen["trainer"]


@pytest.mark.parametrize("arm", ARM_IDS)
def test_arm_recipe_equals_the_tool(arm, tmp_path, monkeypatch):
    out, root = str(tmp_path / "out"), str(tmp_path / "root")
    j_task, j_loaders, j_trainer = jax_arm_arguments(arm, 1, out, root,
                                                     monkeypatch)
    task, train_data, val_data, trainer = t_abl.arm_setup(
        arm, 1, out, 40, root, on_card=False)
    assert task == j_task
    assert [(train_data, True, 1), (val_data, False, None)] == j_loaders
    assert trainer == j_trainer           # precision None on the CPU, both
    _, _, _, card = t_abl.arm_setup(arm, 1, out, 40, root, on_card=True)
    assert card["precision"] == "bf16"


@pytest.mark.parametrize("arm", ARM_IDS)
def test_every_arm_builds_with_the_jax_parameter_count(arm, tmp_path):
    task_kwargs = t_abl.arm_setup(arm, 0, str(tmp_path), 40, str(tmp_path),
                                  on_card=False)[0]
    port = TCenterNet(**task_kwargs)
    n_port = sum(p.numel() for p in port.model.parameters())
    jtask = JCenterNet(**task_kwargs)
    tree = jax.eval_shape(jtask.model.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(tree["params"]))
    assert n_port == n_jax


def test_one_arm_one_epoch_and_report(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CENTERNET_TPU_SMOKE_DATASET", "1")
    out = str(tmp_path / "abl")
    assert t_abl.main(["--out", out, "--arm", "dcn_fast", "--epochs", "1",
                       "--device", "cpu"]) == 0
    with open(os.path.join(out, "dcn_fast_s0.json")) as f:
        result = json.load(f)
    assert set(result) == {"arm", "seed", "epochs", "final", "best_mAP",
                           "dcn_audit"}
    assert result["arm"] == "dcn_fast" and result["epochs"] == 1
    assert "val/mAP" in result["final"] and len(result["final"]) == 12
    assert result["dcn_audit"]["engine_bound"] == 2
    assert os.listdir(os.path.join(out, "dcn_fast_s0", "checkpoints", "best"))
    capsys.readouterr()
    assert t_abl.main(["--out", out, "--report"]) == 0
    report = capsys.readouterr().out
    assert "| dcn_fast | 37.5 | s0: " in report


def test_preemption_runner_on_port(tmp_path, monkeypatch):
    """The tool's test_grid_driver_preemption_paths on the port's arm runner:
    an existing result spawns nothing; a hanging arm is SIGTERMed at its
    budget and retried once; two hanging attempts report it missing."""
    from test_run_ablations import test_grid_driver_preemption_paths

    def port_runner(arm, seed, out, epochs, arm_timeout):
        return t_abl.run_arm_subprocess(arm, seed, out, epochs, arm_timeout,
                                        "cpu")

    # the test patches subprocess.Popen, which the port's runner calls too
    assert t_abl.subprocess is j_abl.subprocess is subprocess
    monkeypatch.setattr(j_abl, "run_arm_subprocess", port_runner)
    test_grid_driver_preemption_paths(tmp_path, monkeypatch)


def test_dataset_size_marker_on_port(tmp_path, monkeypatch):
    """The tool's test_dataset_size_marker_blocks_mismatched_reuse on the
    port's ensure_dataset."""
    from test_run_ablations import \
        test_dataset_size_marker_blocks_mismatched_reuse as jax_test

    monkeypatch.setattr(j_abl, "ensure_dataset", t_abl.ensure_dataset)
    jax_test(tmp_path, monkeypatch)


def _files(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("v2", [False, True], ids=["v1", "v2"])
def test_shapes_byte_equal_to_the_tool(v2, tmp_path):
    if v2:
        args = dict(n_images=6, val_fraction=0.5, seed=7)
        ref = j_shapes.make_shapes_v2_dataset(str(tmp_path / "j"), **args)
        got = t_shapes.make_shapes_v2_dataset(str(tmp_path / "t"), **args)
    else:
        args = dict(n_images=8, size=96, min_shapes=2, max_shapes=6,
                    val_fraction=0.25, seed=7)
        ref = j_shapes.make_shapes_dataset(str(tmp_path / "j"), **args)
        got = t_shapes.make_shapes_dataset(str(tmp_path / "t"), **args)
    assert {k: v for k, v in got.items() if k != "img_dir"} == \
        {k: v for k, v in ref.items() if k != "img_dir"}
    j_files, t_files = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert sorted(t_files) == sorted(j_files)
    assert len(t_files) == args["n_images"] + 2
    assert t_files == j_files
    assert t_shapes.CLASSES == j_shapes.CLASSES
    assert t_shapes.V2_CLASSES == j_shapes.V2_CLASSES
