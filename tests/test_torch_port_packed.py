"""PyTorch port: the packed dataset cache (data/packed.py, the builder's
`type: packed` branch and cli/pack_dataset.py) against the JAX package,
on the CPU.

- The JAX package's own tests/test_packed.py, each run against the port's
  modules (`run_on_port`; its CLI test runs tools/pack_dataset.py with the
  port's packed module and config in place of the JAX package's).
- A pack written by the port is byte-equal to the JAX package's for the
  same config and seed, file for file; a pack written by either loads in
  the other; the two loaders give bitwise-equal batches over two epochs,
  shuffled, with `flip_p` and with shards; `loader_from_config` of a
  `type: packed` section equals the JAX builder's; the port's CLI prints
  the same JSON line as the JAX tool; `write_pack` of collated arrays
  writes the files `pack_dataset` writes.
"""
import json
import os

import numpy as np
import pytest

import test_packed as jax_packed_tests
from centernet_lightning_tpu.data import builder as j_builder
from centernet_lightning_tpu.data import packed as j_packed

from centernet_lightning_torch.cli import pack_dataset as t_cli
from centernet_lightning_torch.data import builder as t_builder
from centernet_lightning_torch.data import packed as t_packed

from _torch_port_helpers import jax_test_names, run_on_port
from test_torch_port_data import assert_same

coco_dir = jax_packed_tests.coco_dir
data_cfg = jax_packed_tests.data_cfg

PACKED_MODULES = tuple(f"centernet_lightning_tpu.data.{m}" for m in (
    "builder", "packed", "coco", "collate", "loader", "transforms", "mot")) + (
    "centernet_lightning_tpu.data", "centernet_lightning_tpu.train.config")


@pytest.mark.parametrize("name", jax_test_names(jax_packed_tests))
def test_jax_packed_tests_on_port(name, request, monkeypatch):
    run_on_port(jax_packed_tests, name, request, monkeypatch, PACKED_MODULES)


def _files(pack_dir):
    return {name: open(os.path.join(pack_dir, name), "rb").read()
            for name in sorted(os.listdir(pack_dir))}


@pytest.mark.parametrize("copies", [1, 2])
def test_pack_bytes_equal_jax(coco_dir, tmp_path, copies):
    """The same config and seed: the same files, byte for byte (the
    random crop makes the two copies' augmentations differ)."""
    cfg = data_cfg(coco_dir, transforms=[
        {"name": "RandomResizedCrop", "init_args": {"height": 48, "width": 48}},
        {"name": "HorizontalFlip"}])
    j_meta = j_packed.pack_dataset(cfg, str(tmp_path / "j"), copies=copies, seed=3)
    t_meta = t_packed.pack_dataset(cfg, str(tmp_path / "t"), copies=copies, seed=3)
    assert t_meta == j_meta
    j_files, t_files = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert t_files.keys() == j_files.keys()
    for name in j_files:
        assert t_files[name] == j_files[name], name


def test_write_pack_equals_pack_dataset(coco_dir, tmp_path):
    """The live loader's batches, concatenated and written by `write_pack`:
    the JAX package's `pack_dataset` files, byte for byte."""
    cfg = data_cfg(coco_dir)
    j_packed.pack_dataset(cfg, str(tmp_path / "j"))
    batches = list(t_builder.loader_from_config(
        dict(cfg, shuffle=False, drop_last=False), train=True, seed=0))
    meta = t_packed.write_pack(str(tmp_path / "t"), {
        k: np.concatenate([b[k] for b in batches]) for k in batches[0]})
    assert meta["n"] == 5
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


@pytest.fixture
def pack(coco_dir, tmp_path):
    """One pack of the 5 images at 64^2, written by the JAX package."""
    out = str(tmp_path / "pack")
    j_packed.pack_dataset(data_cfg(coco_dir), out)
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=2),
    dict(batch_size=2, shuffle=True, seed=4),
    dict(batch_size=2, shuffle=True, drop_last=False, flip_p=0.5, seed=7),
    dict(batch_size=3, flip_p=1.0),
    dict(batch_size=1, shuffle=True, flip_p=0.5, seed=2, shard_id=1,
         num_shards=2),
], ids=["plain", "shuffle", "flip", "flip_all", "shard"])
def test_loaders_bitwise_equal_jax(pack, kw):
    """The two PackedLoaders over two epochs: the same batches, bitwise."""
    j_loader = j_packed.PackedLoader(pack, **kw)
    t_loader = t_packed.PackedLoader(pack, **kw)
    assert len(t_loader) == len(j_loader)
    assert len(t_loader.dataset) == len(j_loader.dataset)
    for epoch in range(2):
        j_batches, t_batches = list(j_loader), list(t_loader)
        assert len(t_batches) == len(j_batches) > 0
        for i, (a, b) in enumerate(zip(j_batches, t_batches)):
            assert_same(a, b, f"epoch {epoch} batch {i}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pack_loads_in_the_other_package(coco_dir, tmp_path, writer):
    """A pack written by one package, read by the other package's loader,
    gives the batches that the writer's own loader gives."""
    out = str(tmp_path / "pack")
    write, read = ((j_packed, t_packed) if writer == "jax"
                   else (t_packed, j_packed))
    write.pack_dataset(data_cfg(coco_dir), out, train=False)
    ref = list(write.PackedLoader(out, batch_size=2, flip_p=0.5, seed=1))
    got = list(read.PackedLoader(out, batch_size=2, flip_p=0.5, seed=1))
    assert len(got) == len(ref) == 3
    for i, (a, b) in enumerate(zip(ref, got)):
        assert_same(a, b, f"batch {i}")


@pytest.mark.parametrize("section", [
    {"batch_size": 2},
    {"batch_size": 2, "flip_p": 0.5, "shuffle": True},
    {"batch_size": 4, "drop_last": True, "shard_id": 0, "num_shards": 2},
], ids=["eval", "flip", "shard"])
@pytest.mark.parametrize("train", [True, False])
def test_loader_from_config_packed_equal_jax(pack, section, train):
    """`type: packed` through both builders (train and eval defaults),
    with an explicit shard: the same loader settings and batches."""
    cfg = {"type": "packed", "data_dir": pack, **section}
    j_loader = j_builder.loader_from_config(cfg, train=train, seed=5)
    t_loader = t_builder.loader_from_config(cfg, train=train, seed=5)
    assert isinstance(t_loader, t_packed.PackedLoader)
    for key in ("batch_size", "shuffle", "drop_last", "flip_p", "seed",
                "shard_id", "num_shards"):
        assert getattr(t_loader, key) == getattr(j_loader, key), key
    for i, (a, b) in enumerate(zip(list(j_loader), list(t_loader))):
        assert_same(a, b, f"batch {i}")


def test_pack_cli_json_line_equal_jax(coco_dir, tmp_path, capsys, monkeypatch):
    """The port's CLI (in-process, `--data`) writes the JAX tool's pack and
    prints its JSON line (but for the output path)."""
    import runpy
    import sys

    cfg = json.dumps(data_cfg(coco_dir))
    assert t_cli.main(["--data", cfg, "--out", str(tmp_path / "t")]) == 0
    t_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "pack_dataset.py")
    monkeypatch.setattr(sys, "argv", ["pack_dataset.py", "--data", cfg,
                                      "--out", str(tmp_path / "j")])
    runpy.run_path(script, run_name="__main__")
    j_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert t_line.pop("out") == str(tmp_path / "t")
    assert j_line.pop("out") == str(tmp_path / "j")
    assert t_line == j_line and t_line["n"] == 5
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    with pytest.raises(SystemExit):
        t_cli.main(["--out", str(tmp_path / "x")])
