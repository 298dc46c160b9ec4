"""PyTorch port: data parallelism over processes (parallel/dist.py, the
Trainer's multi-process paths, rank-sharded data, `cli.train --multihost`),
on the CPU.

- `gather_object_lists` and the tracking merge: the JAX package's own
  contract tests (tests/test_multihost_gather.py, test_multihost_tracking.py)
  run against the port's functions with their in-process allgather,
  a process with no items included.
- Two gloo ranks (tests/_torch_port_parallel_worker.py, a FileStore in
  tmp_path, so parallel test processes never share a port): detection and
  tracking validation on stubbed detections give metrics == to one
  process's, each rank forwarding only its share; SIGTERM on rank 1
  alone stops both ranks at step 10 with one checkpoint; `cli.train
  --multihost --device cpu` trains, and only rank 0 writes the run
  directory.
- Rank shards of a pack and of a COCO set (the builder reading the group's
  rank and size): disjoint, of equal length, their union the epoch; the
  validation loaders stay whole.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_multihost_gather as jax_gather_tests
import test_multihost_tracking as jax_tracking_tests
from centernet_lightning_torch.data import builder
from centernet_lightning_torch.data.packed import pack_dataset, write_pack
from centernet_lightning_torch.data.shapes import make_shapes_dataset
from centernet_lightning_torch.parallel import dist
from centernet_lightning_torch.train.trainer import allgather_tracking_results

import _torch_port_parallel_worker as worker

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def run_ranks(scenario, tmp, world=2, timeout=240):
    """Run a worker scenario on `world` gloo ranks at once; their results
    in rank order."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_torch_port_parallel_worker.py"),
         scenario, str(rank), str(world), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(world)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{out[-4000:]}"
    return [torch.load(os.path.join(tmp, f"{scenario}_{rank}.pt"),
                       weights_only=False) for rank in range(world)]


# ---- the merge contracts -------------------------------------------------

@pytest.mark.parametrize("name", [
    "test_gather_unions_ragged_lists_in_process_order",
    "test_gather_with_empty_process",
    "test_merged_metrics_equal_single_process"])
def test_gather_object_lists_contract(name, monkeypatch):
    monkeypatch.setattr(jax_gather_tests, "gather_object_lists",
                        dist.gather_object_lists)
    monkeypatch.setattr(jax_gather_tests, "CocoEvaluator",
                        __import__("centernet_lightning_torch.eval.coco_eval",
                                   fromlist=["CocoEvaluator"]).CocoEvaluator)
    getattr(jax_gather_tests, name)()


def test_tracking_merge_contract(monkeypatch):
    monkeypatch.setattr(jax_tracking_tests, "_allgather_tracking_results",
                        allgather_tracking_results)
    jax_tracking_tests.test_allgather_tracking_results_roundtrip()


def test_one_process_is_the_identity():
    """Without a process group every helper hands its input back."""
    g = {"a": torch.ones(3)}
    assert dist.process_count() == 1 and dist.process_index() == 0
    assert dist.mean_gradients(g) is g and dist.mean_losses(g) is g
    x = torch.arange(4.0, requires_grad=True)
    assert dist.all_reduce_sum(x) is x and dist.gather_rows(x) is x
    tree = {"k": np.arange(3)}
    assert dist.all_gather_host(tree) is tree
    items = [{"k": np.ones(2)}]
    assert dist.gather_object_lists(items, {"k": ((), np.float64)}) == items
    count = torch.tensor(0.0)
    assert torch.equal(dist.global_normalizer(count, floor=1.0),
                       torch.clamp(count, min=1.0))
    assert dist.process_local_batch_size(32) == 32


# ---- two ranks -------------------------------------------------------------

@pytest.fixture(scope="module")
def validated(tmp_path_factory):
    return run_ranks("validate", tmp_path_factory.mktemp("validate"))


@pytest.mark.parametrize("kind", ["detection", "tracking"])
def test_two_rank_validation_equals_one_process(kind, validated):
    ref, forwarded = worker.validation_metrics(kind == "tracking")
    batches = worker.val_batches(kind == "tracking")
    assert forwarded == len(batches)
    shares = []
    for rank_out in validated:
        got, n = rank_out[kind]
        assert got == ref
        shares.append(n)
    if kind == "detection":
        assert ref["val/AP50"] > 0.3
        assert shares == [2, 3]     # contiguous blocks of the 5 batches
    else:
        assert ref["val/IDF1"] > 0.2
        # rank 0 tracks sequences 0 and 2, rank 1 sequence 1; a batch that
        # spans two sequences is forwarded by both ranks
        assert 0 < shares[0] < len(batches) and 0 < shares[1] < len(batches)
        assert {f"val/seq{s}/HOTA" for s in range(3)} <= set(ref)


def test_stop_agreed_across_ranks(tmp_path):
    """SIGTERM reaches rank 1 alone, during step 3: both ranks stop after
    step 10, the first agreement point, and rank 0 writes the one
    checkpoint."""
    outs = run_ranks("stop", tmp_path)
    assert [o["step"] for o in outs] == [10, 10]
    assert all(o["stop"] for o in outs)
    assert outs[0]["ckpts"] == outs[1]["ckpts"]
    assert [c for c in outs[0]["ckpts"] if c.startswith("step_")] == ["step_10"]


def test_train_cli_multihost_writes_from_rank_zero(tmp_path):
    """`cli.train --multihost --device cpu` on two ranks over packs: both
    exit 0, rank 0 alone writes config.yaml, metrics.jsonl and the
    checkpoints (one set), and the metrics are finite."""
    import yaml

    shapes = tmp_path / "shapes"
    make_shapes_dataset(str(shapes), n_images=10, size=64, val_fraction=0.4,
                        seed=1)
    packs = {}
    for split in ("train", "val"):
        cfg = {"type": "coco", "img_dir": str(shapes / "images"),
               "ann_json": str(shapes / f"{split}.json"), "batch_size": 2,
               "num_workers": 0, "max_boxes": 8}
        pack_dataset(cfg, str(tmp_path / split), train=split == "train")
        packs[split] = str(tmp_path / split)
    config = {"model": dict(worker.SMALL,
                            optimizer_config=worker.OPT,
                            train_data={"type": "packed",
                                        "data_dir": packs["train"],
                                        "batch_size": 1},
                            val_data={"type": "packed",
                                      "data_dir": packs["val"],
                                      "batch_size": 2}),
              "trainer": {"max_epochs": 1, "log_every_n_steps": 1,
                          "logger": "WandbLogger"}}
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(config))
    workdir = tmp_path / "run"
    (tmp_path / "cli_args.json").write_text(json.dumps(
        ["--multihost", "--device", "cpu", "--config", str(path),
         "--workdir", str(workdir)]))
    outs = run_ranks("cli", tmp_path)
    assert [o["rc"] for o in outs] == [0, 0]
    # the group the worker brought up is the caller's: the CLI leaves it
    assert all(o["initialized"] for o in outs)
    rows = [json.loads(line) for line in open(workdir / "logs" / "metrics.jsonl")]
    # 6 training images in 2 shards of 3: three steps of the global batch 2
    steps = [r["step"] for r in rows if "train/total_loss" in r]
    assert steps == [1, 2, 3]
    assert any("val/mAP" in r for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))
    assert sorted(os.listdir(workdir)) == ["checkpoints", "config.yaml", "logs"]
    assert len([f for f in os.listdir(workdir / "logs")
                if f.endswith(".jsonl")]) == 1


# ---- rank shards ----------------------------------------------------------

def _as_rank(monkeypatch, rank, world):
    monkeypatch.setattr(dist, "process_count", lambda: world)
    monkeypatch.setattr(dist, "process_index", lambda: rank)


def _epoch_ids(loader, key):
    return [int(v) for b in loader for v in np.asarray(b[key]).reshape(-1)]


@pytest.mark.parametrize("world", [2, 3])
def test_pack_rank_shards_partition_the_epoch(world, tmp_path, monkeypatch):
    n = 12
    write_pack(str(tmp_path / "pack"), {
        "image": np.arange(n, dtype=np.uint8)[:, None, None, None]
        * np.ones((1, 4, 4, 3), np.uint8),
        "index": np.arange(n, dtype=np.int64)})
    cfg = {"type": "packed", "data_dir": str(tmp_path / "pack"),
           "batch_size": 2}
    shards = []
    for rank in range(world):
        _as_rank(monkeypatch, rank, world)
        loader = builder.loader_from_config(cfg, train=True, seed=3)
        assert (loader.shard_id, loader.num_shards) == (rank, world)
        shards.append(_epoch_ids(loader, "index"))
        # validation stays whole on every rank
        val = builder.loader_from_config(cfg, train=False)
        assert _epoch_ids(val, "index") == list(range(n))
    assert len({len(s) for s in shards}) == 1
    union = [i for s in shards for i in s]
    assert len(set(union)) == len(union) == n // world * world
    # the unsharded shuffled epoch, dealt out rank by rank
    monkeypatch.undo()
    whole = builder.loader_from_config(dict(cfg, drop_last=False), train=True,
                                       seed=3)
    order = _epoch_ids(whole, "index")
    assert sorted(union) == sorted(order[:n // world * world])


def test_coco_rank_shards_partition_the_epoch(tmp_path, monkeypatch):
    shapes = tmp_path / "shapes"
    make_shapes_dataset(str(shapes), n_images=9, size=64, val_fraction=0.0,
                        seed=2)
    cfg = {"type": "coco", "img_dir": str(shapes / "images"),
           "ann_json": str(shapes / "train.json"), "batch_size": 2,
           "num_workers": 0, "max_boxes": 8, "drop_last": False}
    shards = []
    for rank in range(2):
        _as_rank(monkeypatch, rank, 2)
        shards.append(_epoch_ids(builder.loader_from_config(cfg, train=True),
                                 "image_id"))
        val = builder.loader_from_config(cfg, train=False)
        assert sorted(_epoch_ids(val, "image_id")) == list(range(1, 10))
    assert len(shards[0]) == len(shards[1]) == 4
    union = shards[0] + shards[1]
    assert len(set(union)) == 8
    monkeypatch.undo()
    whole = builder.loader_from_config(cfg, train=True)
    assert sorted(union) == sorted(_epoch_ids(whole, "image_id")[:8])
