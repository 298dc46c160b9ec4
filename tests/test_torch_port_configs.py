"""PyTorch port vs the JAX package: the shipped detection YAMLs built
on the CPU at full size (configs/centernet.yaml, base_resnet34.yaml,
helmet.yaml), and the weight converter's new scopes: JAX -> the port ->
the JAX package's torch->flax converter -> JAX, bitwise, for CSPDarknet,
MobileNetV3 and a conv-transpose SimpleNeck with skips; and the
multilevel forward (every head on every BiFPN level) at rtol 1e-4 with an
atol of 1e-4 of the logits' largest magnitude.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet
from centernet_lightning_tpu.utils.torch_convert import (
    convert_centernet_checkpoint,
)

from centernet_lightning_torch import build_centernet as t_build
from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import (
    NARROW_DARKNET, perturb_batch_norm, to_numpy_tree,
)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def _variables(task, rng, size):
    v = to_numpy_tree(task.init(jax.random.PRNGKey(0), image_size=(size, size)))
    return perturb_batch_norm(v, rng)


def test_multilevel_forward_parity():
    rng = np.random.default_rng(33)
    cfg = dict(num_classes=3, head_config={"width": 8, "depth": 1},
               backbone="resnet18", backbone_config={"width": 8},
               neck="BiFPN", neck_config={"out_channels": 16})
    jtask = JCenterNet(**cfg)
    v = _variables(jtask, rng, 64)
    ttask = TCenterNet(**cfg)
    ttask.model.load_state_dict(variables_to_state_dict(v), strict=True)
    ttask.model.eval()
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    refs = jtask.model.apply(v, jnp.asarray(x),
                             method=jtask.model.multilevel_forward)
    with torch.no_grad():
        gots = ttask.model.multilevel_forward(torch.from_numpy(x))
    assert len(gots) == len(refs) == 4
    for ref, got in zip(refs, gots):
        for key in ("heatmap", "box_2d"):
            r = np.asarray(ref[key])
            np.testing.assert_allclose(got[key].numpy(), r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max())


ROUND_TRIP = {
    "cspdarknet": dict(backbone="cspdarknet53", backbone_config=NARROW_DARKNET,
                       neck_config={"out_channels": 16}),
    "mobilenet_v3_large": dict(backbone="mobilenet_v3_large",
                               neck_config={"out_channels": 16}),
    "conv_transpose_simple_neck": dict(
        backbone="resnet18", backbone_config={"width": 8}, neck="SimpleNeck",
        neck_config={"upsample_channels": [16, 12, 8], "skip_kernel": 1,
                     "upsample_type": "conv_transpose"}),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIP))
def test_converter_round_trip(name):
    """JAX -> the port (strict load) -> the JAX package's structural
    torch->flax converter -> JAX: every leaf comes back bitwise."""
    cfg = dict(num_classes=3, head_config={"width": 8, "depth": 1},
               **ROUND_TRIP[name])
    rng = np.random.default_rng(34)
    variables = _variables(JCenterNet(**cfg), rng, 64)
    ttask = TCenterNet(**cfg)
    result = ttask.model.load_state_dict(variables_to_state_dict(variables),
                                         strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    arch = cfg["backbone"] if cfg["backbone"].startswith("resnet") else None
    back = convert_centernet_checkpoint(ttask.model.state_dict(), variables,
                                        backbone_arch=arch)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(to_numpy_tree(back)))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_converter_refuses_unported_scopes():
    with pytest.raises(KeyError):
        variables_to_state_dict({"params": {"backbone": {
            "OSAStage_0": {"Conv_0": {"kernel": np.zeros((1, 1, 2, 2))}}}}})


@pytest.mark.parametrize("name,backbone,neck", [
    ("centernet.yaml", "CSPDarknet53", "FPN"),
    ("base_resnet34.yaml", "ResNet", "SimpleNeck"),
    ("helmet.yaml", "MobileNetV2", "SimpleNeck"),
    ("mot_tracking.yaml", "ResNet", "FPN"),
    ("crowdhuman_tracking.yaml", "ResNet", "FPN"),
    ("base_tracking_resnet34_fpn.yaml", "ResNet", "FPN"),
])
def test_shipped_config_builds(name, backbone, neck):
    """The shipped YAML builds on the CPU at full size, with the JAX
    model's parameter count (a tracking config's ReID head and identity
    classifier included, as the JAX task's init creates it) and stride."""
    from centernet_lightning_tpu.train.config import (load_config,
                                                      normalize_config)

    path = os.path.join(CONFIG_DIR, name)
    pred = t_build(path, device="cpu")
    model = pred.model
    assert type(model.backbone).__name__ == backbone
    assert type(model.neck).__name__ == neck
    # the JAX task as its build_centernet makes it, traced, not initialised
    j_cfg = normalize_config(load_config(path))["model"]
    jtask = JCenterNet(**{k: v for k, v in j_cfg.items()
                          if k in JCenterNet.__dataclass_fields__})
    shapes = jax.eval_shape(lambda k: jtask.init(k, image_size=(64, 64)),
                            jax.random.PRNGKey(0))
    j_params = sum(int(np.prod(s.shape))
                   for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in model.parameters()) == j_params
    assert pred.task.stride == jtask.stride == 4
    dets = pred.gather_detection2d(np.zeros((1, 64, 64, 3), np.uint8))
    k = min(pred.task.num_detections, 16 * 16)    # 64^2 at stride 4
    assert dets["bboxes"].shape == (1, k, 4)
    assert np.isfinite(dets["scores"]).all()
    if pred.task.reid_config is not None:
        assert dets["embeddings"].shape == (1, k, 64)
        assert model.classifier.fc2.out_features == \
            pred.task.reid_config["max_track_ids"]
