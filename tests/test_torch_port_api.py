"""PyTorch port vs the JAX package: weights carry-over, the whole serving
slice through the public API, and the port's own copy of the config code.

The whole slice runs the JAX `build_centernet` and the port's
`build_centernet(..., device="cpu")` with the same weights. Tolerances:
scores and boxes rtol 1e-4, atol 1e-4 (f32 convolutions summed in another
order); top-k ties are compared as `assert_detections_match` describes.
"""
import inspect
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu import build_centernet as j_build
from centernet_lightning_tpu.data import transforms as j_transforms
from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
from centernet_lightning_tpu.train import config as j_config
from centernet_lightning_tpu.train.optim import make_optimizer
from centernet_lightning_tpu.utils.torch_convert import (
    convert_centernet_checkpoint,
)

from centernet_lightning_torch import build_centernet as t_build
from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet
from centernet_lightning_torch.train import config as t_config
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import (
    assert_detections_match, perturb_batch_norm, to_numpy_tree,
)

TINY = {
    "num_classes": 3,
    "backbone": "resnet18",
    "backbone_config": {"width": 16},
    "neck": "FPN",
    "neck_config": {"out_channels": 32},
    "head_config": {"width": 32, "depth": 1},
    "num_detections": 20,
    "image_size": [64, 64],
}
TOL = dict(rtol=1e-4, atol=1e-4)
CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


@pytest.fixture(scope="module")
def pair():
    """(JAX predictor, port predictor) with the same perturbed weights."""
    jp = j_build({"model": TINY})
    variables = perturb_batch_norm(to_numpy_tree(jp.variables),
                                   np.random.default_rng(0))
    # keep the heatmap logits moderate, so sigmoid scores stay apart
    # instead of saturating to ties at 1.0
    out_conv = variables["params"]["heads_heatmap"]["out_conv"]
    out_conv["kernel"] = out_conv["kernel"] * 0.05
    jp.variables = variables
    tp = t_build({"model": TINY}, device="cpu")
    tp.model.load_state_dict(variables_to_state_dict(jp.variables),
                             strict=True)
    return jp, tp


@pytest.mark.parametrize("backbone", ["resnet18", "resnet50"])
def test_weights_carry_over_and_round_trip(backbone):
    kw = dict(TINY, backbone=backbone)
    kw.pop("num_detections")
    jtask = JCenterNet(**kw)
    variables = to_numpy_tree(jtask.init(jax.random.PRNGKey(0)))
    sd = variables_to_state_dict(variables)
    ttask = TCenterNet(**kw)
    result = ttask.model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert set(sd) == set(ttask.model.state_dict())
    assert all(k.split(".")[0] in ("backbone", "neck", "heads") for k in sd)

    # back through the JAX package's torch->flax converter
    back = convert_centernet_checkpoint(ttask.model.state_dict(), variables,
                                        backbone_arch=backbone)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(to_numpy_tree(back)))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_random_init_matches_jax_statistics():
    """Same initialisers (different random streams): per-tensor std of
    every weight within 15% of the JAX package's, biases identical."""
    kw = dict(TINY)
    kw.pop("num_detections")
    jvars = to_numpy_tree(JCenterNet(**kw).init(jax.random.PRNGKey(0)))
    ttask = TCenterNet(**kw)
    ttask.init(torch.Generator().manual_seed(0))
    tsd = ttask.model.state_dict()
    for key, ref in variables_to_state_dict(jvars).items():
        got = tsd[key].float().numpy()
        ref = ref.float().numpy()
        assert got.shape == ref.shape, key
        if key.endswith("conv.weight") or key.endswith("conv1.weight"):
            assert abs(got.std() / ref.std() - 1) < 0.15, key
        elif not key.endswith("weight"):
            np.testing.assert_array_equal(got, ref, err_msg=key)


def test_gather_detection2d_uint8_parity(pair):
    jp, tp = pair
    images = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    ref = jp.gather_detection2d(jnp.asarray(images))
    got = tp.gather_detection2d(images)
    assert got["bboxes"].shape == (2, 20, 4)
    assert got["labels"].dtype == np.int32
    assert_detections_match(ref, got, min_distinct=10, **TOL)
    normed = tp.gather_detection2d(torch.from_numpy(images),
                                   normalize_boxes=True, num_detections=7)
    assert normed["bboxes"].shape == (2, 7, 4)


def test_gather_detection2d_encoded_dict_parity(pair):
    jp, tp = pair
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref_enc = jp(jnp.asarray(x))
    got_enc = tp(x)
    for key in ("heatmap", "box_2d"):
        assert got_enc[key].shape == tuple(ref_enc[key].shape)
        np.testing.assert_allclose(got_enc[key].numpy(),
                                   np.asarray(ref_enc[key]), **TOL)
    ref = jp.gather_detection2d({k: v for k, v in ref_enc.items()})
    got = tp.gather_detection2d(got_enc)
    assert_detections_match(ref, got, min_distinct=10, **TOL)
    # the task-level single call (forward + decode from logits)
    ref = jp.task.forward_and_decode(jp.variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tp.task.forward_and_decode(torch.from_numpy(x))
    assert_detections_match({k: np.asarray(v) for k, v in ref.items()},
                            {k: v.numpy() for k, v in got.items()},
                            min_distinct=10, **TOL)


def test_inference_detection_parity(pair, tmp_path):
    import cv2

    jp, tp = pair
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate([(100, 140), (64, 64), (50, 80)]):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"frame_{i:03d}.png"), img)
    ref = jp.inference_detection(str(tmp_path), batch_size=2, num_detections=20)
    got = tp.inference_detection(str(tmp_path), batch_size=2, num_detections=20)
    assert got["image_paths"] == ref["image_paths"]
    assert got["bboxes"].shape == (3, 20, 4)
    assert_detections_match(ref, got, min_distinct=10, **TOL)


def test_build_from_yaml_and_deferred_options(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    import yaml

    cfg.write_text(yaml.safe_dump({"model": dict(TINY, compute_dtype="bfloat16")}))
    pred = t_build(str(cfg), device="cpu")
    assert pred.compute_dtype == torch.bfloat16 and pred.task.stride == 4
    assert next(pred.model.parameters()).dtype == torch.bfloat16
    dets = pred.gather_detection2d(np.zeros((1, 64, 64, 3), np.uint8))
    assert dets["scores"].dtype == np.float32 and np.isfinite(dets["bboxes"]).all()
    # the options and backbones once deferred now build and serve
    for extra, check in [
        ({"backbone": "dla34", "backbone_config": {"channels": [8, 8, 16, 16, 24, 24]}},
         lambda bb: type(bb).__name__ == "DLA"),
        ({"backbone_config": {"width": 16, "stem_space_to_depth": True}},
         lambda bb: type(bb).__name__ == "ResNet"),
        ({"backbone_config": {"width": 16, "remat": True}},
         lambda bb: bb.remat),
    ]:
        built = t_build({"model": {**TINY, **extra}}, device="cpu")
        assert check(built.model.backbone), extra
        dets = built.gather_detection2d(np.zeros((1, 64, 64, 3), np.uint8))
        assert dets["scores"].shape == (1, TINY["num_detections"])
    # checkpoints load now (test_torch_port_train.py); a run directory
    # without one is an error
    with pytest.raises(FileNotFoundError):
        t_build({"model": TINY}, checkpoint=str(tmp_path), device="cpu")


def test_default_device_is_cuda_without_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        t_build({"model": TINY})


def test_config_copy_matches_the_jax_package():
    known = {name for name, p in inspect.signature(make_optimizer).parameters.items()
             if p.kind is not p.VAR_KEYWORD} - {"params", "optimizer", "lr_scheduler"}
    assert t_config.OPTIMIZER_KEYS == known
    assert t_config.TRANSFORM_NAMES == set(j_transforms.TRANSFORMS) | {"Mosaic"}
    names = sorted(f for f in os.listdir(CONFIG_DIR) if f.endswith(".yaml"))
    assert names
    for name in names:
        path = os.path.join(CONFIG_DIR, name)
        raw = t_config.load_config(path)
        assert raw == j_config.load_config(path), name
        with warnings.catch_warnings():
            # both normalisers may warn about unmapped keys; the warnings
            # are not what this test compares
            warnings.simplefilter("ignore")
            assert t_config.normalize_config(raw) == \
                j_config.normalize_config(raw), name


@pytest.mark.parametrize("compute_dtype", ["float32", "float32_ieee"])
def test_tf32_flags_during_the_forward(compute_dtype):
    """"float32" leaves TF32 to the process's flags; "float32_ieee" turns
    them off while its forward runs (the raw call and the serving path)
    and puts them back after, as they were."""
    pred = t_build({"model": dict(TINY, compute_dtype=compute_dtype)}, device="cpu")
    assert pred.compute_dtype == torch.float32
    seen = []
    pred.model.register_forward_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for flags in [(True, True), (True, False)]:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            seen.clear()
            pred(np.zeros((1, 64, 64, 3), np.float32))
            pred.gather_detection2d(np.zeros((1, 64, 64, 3), np.uint8))
            inside = (False, False) if compute_dtype == "float32_ieee" else flags
            assert seen == [inside, inside]
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == flags
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_overlapping_ieee_forwards_restore_the_flags_once():
    from centernet_lightning_torch.api import _IEEE_FLOAT32

    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with _IEEE_FLOAT32:
            with _IEEE_FLOAT32:
                assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
