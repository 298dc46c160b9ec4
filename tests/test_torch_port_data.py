"""PyTorch port: data/ (dataset readers, transforms, collate, the threaded
loader, mosaic and the builder) against the JAX package, on the CPU.

- The JAX package's own tests of data/ (tests/test_data.py, its loader
  sharding class included), each run against the port's modules
  (`run_on_port`): one case a test.
- Every dataset reader on a fixture written to `tmp_path` (PNG images,
  lossless, also where the reader asks for a `.jpg` name: OpenCV decodes
  by content), every transform with the same seed, `build_transforms` from
  every shipped YAML's lists, the collates, the loader's batches and order
  (shuffled, 0 and 2 workers, two epochs), mosaic, DetectionForTracking,
  `build_dataset` / `loader_from_config`: bitwise equal to the JAX
  package's (same keys, dtypes, shapes and values).
- The port's data package loads without OpenCV (test_torch_port_imports.py).
"""
import glob
import json
import os

import cv2
import numpy as np
import pytest

import test_data as jax_data_tests
from centernet_lightning_tpu import data as j_data
from centernet_lightning_tpu.data import transforms as j_tf

from centernet_lightning_torch import data as t_data
from centernet_lightning_torch.data import transforms as t_tf
from centernet_lightning_torch.train.config import load_config

from _torch_port_helpers import jax_test_names, run_on_port

# the JAX tests' fixtures, for the mirrored tests
coco_dir = jax_data_tests.coco_dir
voc_dir = jax_data_tests.voc_dir
mot_dir = jax_data_tests.mot_dir

DATA_MODULES = tuple(f"centernet_lightning_tpu.data.{m}" for m in (
    "builder", "coco", "collate", "crowdhuman", "detection_for_tracking",
    "kitti", "loader", "mosaic", "mot", "transforms", "voc")) + (
    "centernet_lightning_tpu.data", "centernet_lightning_tpu.utils.box_np")
MIRRORED = jax_test_names(jax_data_tests) + [
    f"TestLoaderSharding.{n}" for n in vars(jax_data_tests.TestLoaderSharding)
    if n.startswith("test_")]


@pytest.mark.parametrize("name", MIRRORED)
def test_jax_data_tests_on_port(name, request, monkeypatch):
    run_on_port(jax_data_tests, name, request, monkeypatch, DATA_MODULES)


def assert_same(a, b, where="sample"):
    """Bitwise: the same keys, types, dtypes, shapes and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (where, a.dtype, b.dtype,
                                                          a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _png_as(path, img):
    """`img` (RGB) written losslessly to `path`, whatever its extension."""
    ok, buf = cv2.imencode(".png", np.ascontiguousarray(img[..., ::-1]))
    assert ok
    with open(path, "wb") as f:
        f.write(buf.tobytes())


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


# ---- dataset fixtures --------------------------------------------------------

@pytest.fixture
def coco_png(tmp_path):
    """6 images of two sizes, 4 categories with sparse ids, crowds, boxes
    past the border, a degenerate box, an annotation without `area` and an
    image without annotations."""
    rng = np.random.default_rng(3)
    (tmp_path / "img").mkdir()
    images, anns = [], []
    for i in range(6):
        h, w = (72, 96) if i % 2 else (80, 64)
        name = f"{i:03d}.png"
        _png_as(tmp_path / "img" / name, _image(rng, h, w))
        images.append({"id": 10 + i, "file_name": name, "width": w, "height": h})
        for j in range(0 if i == 4 else int(rng.integers(1, 6))):
            bw, bh = rng.uniform(1, 50, 2)
            x, y = rng.uniform(-10, w - 5), rng.uniform(-10, h - 5)
            ann = {"id": len(anns) + 1, "image_id": 10 + i,
                   "category_id": int(rng.choice([3, 7, 8, 21])),
                   "bbox": [float(x), float(y), float(bw), float(bh)],
                   "iscrowd": int(rng.uniform() < 0.2)}
            if j != 1:
                ann["area"] = float(bw * bh * rng.uniform(0.5, 1))
            anns.append(ann)
    cats = [{"id": c, "name": f"c{c}"} for c in (21, 3, 8, 7)]
    path = tmp_path / "ann.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": cats}))
    return str(tmp_path / "img"), str(path)


@pytest.fixture
def crowdhuman_dir(tmp_path):
    rng = np.random.default_rng(4)
    (tmp_path / "Images").mkdir()
    lines = []
    for i in range(4):
        _png_as(tmp_path / "Images" / f"im{i}.jpg", _image(rng, 60, 90))
        boxes = []
        for j in range(5):
            x, y = rng.uniform(-20, 80), rng.uniform(-20, 50)
            tag = "mask" if j == 3 else "person"
            extra = {"ignore": 1} if j == 2 else {}
            boxes.append({"tag": tag, "fbox": [float(x), float(y),
                                               float(rng.uniform(0.5, 40)),
                                               float(rng.uniform(2, 40))],
                          "extra": extra})
        lines.append(json.dumps({"ID": f"im{i}", "gtboxes": boxes}))
    (tmp_path / "annotation_val.odgt").write_text("\n".join(lines) + "\n")
    return str(tmp_path)


@pytest.fixture
def mot_png(tmp_path):
    """Two sequences of PNG frames; pedestrians, other classes, zero-marked
    rows, boxes past the border and degenerate ones."""
    rng = np.random.default_rng(5)
    for s, (name, n) in enumerate((("S-01", 4), ("S-02", 3))):
        seq = tmp_path / name
        (seq / "img1").mkdir(parents=True)
        (seq / "gt").mkdir()
        for f in range(1, n + 1):
            _png_as(seq / "img1" / f"{f:06d}.png", _image(rng, 48, 64))
        (seq / "seqinfo.ini").write_text(
            f"[Sequence]\nname={name}\nimDir=img1\nframeRate=25\nseqLength={n}\n"
            "imWidth=64\nimHeight=48\nimExt=.png\n")
        rows = []
        for f in range(1, n + 1):
            for tid in range(1, 5 + s):
                x, y = rng.uniform(-5, 60), rng.uniform(-5, 44)
                rows.append(f"{f},{tid},{x:.2f},{y:.2f},{rng.uniform(0.5, 20):.2f},"
                            f"{rng.uniform(2, 20):.2f},{int(rng.uniform() > 0.1)},"
                            f"{rng.choice([1, 1, 1, 2, 7])},1")
        (seq / "gt" / "gt.txt").write_text("\n".join(rows) + "\n")
    return str(tmp_path)


@pytest.fixture
def kitti_dir(tmp_path):
    rng = np.random.default_rng(6)
    for name in ("0000", "0001"):
        d = tmp_path / "training" / "image_02" / name
        d.mkdir(parents=True)
        for f in range(3):
            _png_as(d / f"{f:06d}.png", _image(rng, 40, 70))
        rows = []
        for f in range(3):
            for tid, cls in enumerate(("Car", "Pedestrian", "DontCare", "Van")):
                x1, y1 = rng.uniform(-5, 60), rng.uniform(-5, 35)
                rows.append(f"{f} {tid if cls != 'DontCare' else -1} {cls} 0 0 0 "
                            f"{x1:.2f} {y1:.2f} {x1 + rng.uniform(0.5, 30):.2f} "
                            f"{y1 + rng.uniform(2, 20):.2f} 0 0 0 0 0 0 0")
        label = tmp_path / "training" / "label_02"
        label.mkdir(exist_ok=True)
        (label / f"{name}.txt").write_text("\n".join(rows) + "\n")
    return str(tmp_path)


def _pairs(request, kind):
    """(port dataset, JAX dataset) of one kind on its fixture."""
    if kind == "coco":
        img_dir, ann = request.getfixturevalue("coco_png")
        return [(m.CocoDetection(img_dir, ann), m) for m in (t_data, j_data)]
    if kind == "voc":
        d = request.getfixturevalue("voc_dir")
        return [(m.VOCDataset(d, split="train"), m) for m in (t_data, j_data)]
    if kind == "crowdhuman":
        d = request.getfixturevalue("crowdhuman_dir")
        return [(m.CrowdHumanDataset(d, split="val"), m) for m in (t_data, j_data)]
    if kind == "mot":
        d = request.getfixturevalue("mot_png")
        return [(m.MOTTrackingDataset(d), m) for m in (t_data, j_data)]
    d = request.getfixturevalue("kitti_dir")
    return [(m.KITTITrackingDataset(d), m) for m in (t_data, j_data)]


@pytest.mark.parametrize("kind", ["coco", "voc", "crowdhuman", "mot", "kitti"])
def test_dataset_equals_jax(kind, request):
    (got, _), (ref, _) = _pairs(request, kind)
    assert len(got) == len(ref) > 2
    assert got.num_classes == ref.num_classes
    for attr in ("label_map", "cat_names", "class_names", "max_track_ids",
                 "id_offsets", "index"):
        if hasattr(ref, attr):
            assert getattr(got, attr) == getattr(ref, attr), attr
    n_boxes = 0
    for i in range(len(ref)):
        a, b = got[i], ref[i]
        assert_same(a, b, f"{kind}[{i}]")
        n_boxes += len(a["labels"])
    assert n_boxes > 0


@pytest.mark.parametrize("kind", ["coco", "voc", "crowdhuman"])
def test_detection_for_tracking_equals_jax(kind, request):
    (got, tm), (ref, jm) = _pairs(request, kind)
    got, ref = tm.DetectionForTracking(got), jm.DetectionForTracking(ref)
    assert got.max_track_ids == ref.max_track_ids
    np.testing.assert_array_equal(got.id_offsets, ref.id_offsets)
    for i in range(len(ref)):
        assert_same(got[i], ref[i], f"{kind}[{i}]")


# ---- transforms --------------------------------------------------------------

TRANSFORM_CASES = [
    ("Resize", {"height": 64, "width": 80}),
    ("SmallestMaxSize", {"max_size": 70}),
    ("LongestMaxSize", {"max_size": 100}),
    ("RandomCrop", {"height": 64, "width": 64}),
    ("RandomCrop", {"height": 120, "width": 150}),        # resizes up first
    ("CenterCrop", {"height": 60, "width": 90}),
    ("RandomResizedCrop", {"height": 64, "width": 64}),
    ("RandomResizedCrop", {"height": 48, "width": 48, "scale": [0.99, 1.0],
                           "ratio": [10.0, 11.0]}),         # the fallback
    ("PadIfNeeded", {"min_height": 100, "min_width": 140,
                     "pad_height_divisor": 32, "pad_width_divisor": 32}),
    ("HorizontalFlip", {}),
    ("VerticalFlip", {}),
    ("ColorJitter", {"brightness": 0.4, "contrast": 0.4, "saturation": 0.4,
                     "hue": 0.1, "p": 1.0}),
    ("Normalize", {}),
    ("Cutout", {"num_holes": 5, "max_h_size": 20, "max_w_size": 15, "p": 1.0}),
    ("MotionBlur", {"blur_limit": [3, 15], "p": 1.0}),
    ("Affine", {"rotate": 30, "shear_x": 10, "shear_y": 5, "translate_x": 10,
                "translate_y": 8}),
    ("TrivialAugmentWide", {"p": 1.0}),
]


def _sample(seed, h=96, w=128, k=6):
    rng = np.random.default_rng(seed)
    wh = rng.uniform(4, 60, (k, 2))
    xy = rng.uniform(-5, [w - 10, h - 10], (k, 2))
    return {"image": _image(rng, h, w),
            "bboxes": np.concatenate([xy, wh], 1).astype(np.float32),
            "labels": rng.integers(0, 3, k), "ids": np.arange(k) + 40,
            "iscrowd": (rng.uniform(size=k) < 0.3).astype(np.int64),
            "area": (wh.prod(1) * 0.8).astype(np.float32)}


def test_transform_registry_equals_jax():
    assert sorted(t_tf.TRANSFORMS) == sorted(j_tf.TRANSFORMS)
    assert {n for n, _ in TRANSFORM_CASES} == set(j_tf.TRANSFORMS)


@pytest.mark.parametrize("name,kwargs", TRANSFORM_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(TRANSFORM_CASES)])
def test_transform_equals_jax(name, kwargs):
    for seed in range(4):
        got = t_tf.Compose([t_tf.TRANSFORMS[name](**kwargs)], seed=seed)
        ref = j_tf.Compose([j_tf.TRANSFORMS[name](**kwargs)], seed=seed)
        for call in range(3):       # the generator moves on between calls
            sample = _sample(10 * seed + call)
            assert_same(got(dict(sample)), ref(dict(sample)), f"{name} {seed}/{call}")
        # an explicit generator, as the mosaic's post-pipeline passes none
        a = got(_sample(99), np.random.default_rng(seed))
        b = ref(_sample(99), np.random.default_rng(seed))
        assert_same(a, b, name)


def _yaml_transform_lists():
    cases = []
    for path in sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                              "configs", "*.yaml"))):
        model = load_config(path).get("model", {})
        for section in ("train_data", "val_data"):
            tfs = (model.get(section) or {}).get("transforms")
            if tfs:
                cases.append((os.path.basename(path), section, tfs))
    return cases


YAML_CASES = _yaml_transform_lists()


def test_every_shipped_yaml_with_transforms_is_covered():
    assert len({c[0] for c in YAML_CASES}) >= 5 and len(YAML_CASES) >= 10


@pytest.mark.parametrize("yaml_name,section,tfs", YAML_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in YAML_CASES])
def test_yaml_build_transforms_equals_jax(yaml_name, section, tfs):
    got, ref = t_tf.build_transforms(tfs, seed=7), j_tf.build_transforms(tfs, seed=7)
    assert [type(t).__name__ for t in got.transforms] == \
        [type(t).__name__ for t in ref.transforms]
    for i in range(3):
        sample = _sample(i, h=600 + 20 * i, w=700)
        assert_same(got(dict(sample)), ref(dict(sample)), f"{yaml_name} {section} {i}")


# ---- collate and loader ------------------------------------------------------

def _items(seed, n=5, crowd=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(0, 12))
        item = {"image": _image(rng, 16, 16), "bboxes": rng.uniform(0, 10, (k, 4)).astype(np.float32),
                "labels": rng.integers(0, 4, k), "ids": rng.integers(0, 99, k),
                "image_id": 100 + i, "sequence_id": i // 2,
                "area": rng.uniform(1, 9, k).astype(np.float32)}
        if crowd:
            item["iscrowd"] = (rng.uniform(size=k) < 0.3).astype(np.int64)
        out.append(item)
    return out


@pytest.mark.parametrize("max_boxes", [None, 8, 64])
def test_collate_equals_jax(max_boxes):
    for crowd in (True, False):
        items = _items(1, crowd=crowd)
        for name in ("CollateDetection", "CollateTracking"):
            got = getattr(t_data, name)(max_boxes)
            ref = getattr(j_data, name)(max_boxes)
            with _truncation_warning() if max_boxes == 8 else _no_warning():
                a = got(items)
            with _truncation_warning() if max_boxes == 8 else _no_warning():
                b = ref(items)
            assert_same(a, b, name)
            assert got.truncation.truncated_batches == ref.truncation.truncated_batches
    floats = [dict(it, image=it["image"] / 255.0) for it in _items(2)]
    assert_same(t_data.CollateDetection(16)(floats), j_data.CollateDetection(16)(floats))
    from centernet_lightning_torch.data.collate import coco_detection_collate_fn as tc
    from centernet_lightning_tpu.data.collate import coco_detection_collate_fn as jc

    assert_same(tc(_items(3)), jc(_items(3)))


def _truncation_warning():
    return pytest.warns(RuntimeWarning, match="DROPPED")


class _no_warning:
    def __enter__(self):
        import warnings

        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


class _Items:
    def __init__(self, n):
        self.items = _items(4, n=n)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (True, True),
                                               (False, False)])
def test_loader_equals_jax(workers, shuffle, drop_last):
    loaders = [m.DataLoader(_Items(11), batch_size=3, shuffle=shuffle,
                            collate_fn=m.CollateTracking(16), num_workers=workers,
                            drop_last=drop_last, seed=5)
               for m in (t_data, j_data)]
    assert len(loaders[0]) == len(loaders[1])
    for epoch in range(2):      # the seed moves with the epoch
        got, ref = (list(loader) for loader in loaders)
        assert len(got) == len(ref) == len(loaders[0])
        assert_same(got, ref, f"epoch {epoch}")


# ---- mosaic and the builder --------------------------------------------------

def test_mosaic_equals_jax(coco_png):
    img_dir, ann = coco_png
    for p in (1.0, 0.5):
        post = [{"name": "HorizontalFlip"}, {"name": "Normalize"}]
        got = t_data.MosaicDataset(t_data.CocoDetection(img_dir, ann), out_h=64,
                                   out_w=48, p=p, seed=3,
                                   post_transforms=t_tf.build_transforms(post, seed=1))
        ref = j_data.MosaicDataset(j_data.CocoDetection(img_dir, ann), out_h=64,
                                   out_w=48, p=p, seed=3,
                                   post_transforms=j_tf.build_transforms(post, seed=1))
        for i in list(range(len(ref))) * 2:
            assert_same(got[i], ref[i], f"mosaic p={p} [{i}]")


@pytest.mark.parametrize("extra", [{}, {"mosaic": {"height": 64, "width": 64, "p": 1.0}},
                                   {"detection_for_tracking": True}],
                         ids=["plain", "mosaic", "detection_for_tracking"])
def test_build_dataset_and_loader_equal_jax(coco_png, extra):
    img_dir, ann = coco_png
    cfg = {"type": "coco", "img_dir": img_dir, "ann_json": ann,
           "transforms": [{"name": "RandomResizedCrop",
                           "init_args": {"height": 64, "width": 64}},
                          {"name": "HorizontalFlip"},
                          {"name": "Normalize"}],
           "batch_size": 4, "num_workers": 2, "max_boxes": 16, **extra}
    from centernet_lightning_torch.data.builder import loader_from_config as tl
    from centernet_lightning_tpu.data.builder import loader_from_config as jl

    for train in (True, False):
        got, ref = tl(dict(cfg), train=train), jl(dict(cfg), train=train)
        assert type(got.collate_fn).__name__ == type(ref.collate_fn).__name__
        assert (got.shuffle, got.drop_last, got.num_workers) == \
            (ref.shuffle, ref.drop_last, ref.num_workers) == (train, train, 2)
        # one dataset call at a time: the datasets' generators are shared
        # by the workers, so threads would reorder the draws
        got.num_workers = ref.num_workers = 0
        assert_same(list(got), list(ref), f"train={train}")


def test_builder_registry_and_packed():
    assert set(t_data.DATASETS) == set(j_data.DATASETS)
    with pytest.raises(NotImplementedError, match="item 4"):
        t_data.loader_from_config({"type": "packed", "data_dir": "x"}, train=True)
