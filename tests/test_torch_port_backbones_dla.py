"""PyTorch port vs the JAX package: DLA-34 and DLA-34-small, on the CPU
with the same seeded numpy inputs and converted weights (BatchNorm
statistics perturbed), rtol 1e-4 / atol 1e-4 (f32 convolutions summed in
another order than XLA's).

`dla34_small`'s topology at narrow `channels` runs at 64^2 and at 63 x 95
(odd: level1's 3x3 / s2 rounds up to 32 x 48, which the Trees then halve);
the narrow widths give Trees with and without a projection, the dropped
one of a `levels > 1` Tree among them. One train-mode forward moves every
BatchNorm's statistics as JAX's does, that dropped `project_bn` included.
Full-width parameter counts are JAX's (traced, not run), and the original
CenterNet recipe, DLA-34 with the IDA neck and heads x 2, runs as a whole
serving slice at narrow widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.backbones import dla as j_dla

from centernet_lightning_torch.models.backbones import build_backbone

from _torch_port_helpers import (backbone_parity, jax_param_count, nchw,
                                 random_module_variables, scoped_state_dict,
                                 serving_slice_parity, to_numpy_tree)

# level2 12 -> 16 projects; level3 (levels 2) 16 -> 16 does not; level4
# (levels 2) 16 -> 24 projects and drops it; level5 24 -> 32 projects
NARROW = {"channels": (8, 12, 16, 16, 24, 32)}


@pytest.mark.parametrize("size", [(64, 64), (63, 95)])
def test_dla_pyramid_parity(size):
    rng = np.random.default_rng(50)
    x = rng.normal(size=(1,) + size + (3,)).astype(np.float32)
    t = build_backbone("dla34_small", **NARROW)
    gots = backbone_parity(j_dla.dla34_small(**NARROW), t, x, rng, jit=True)
    h, w = -(-size[0] // 2), -(-size[1] // 2)
    assert [tuple(g.shape[2:]) for g in gots] == [
        (h // 2 ** i, w // 2 ** i) for i in range(1, 5)]
    assert [t.level3.project_conv, t.level4.project_conv is None] == [None, False]


def test_dla_train_forward_statistics_match_jax():
    """A train-mode forward (batch statistics) moves every running
    statistic as flax's does, the dropped `project_bn` of level4 too;
    maps and statistics within rtol 1e-4 / atol 1e-4 of each one's largest
    magnitude, as the train-step tests hold them (level5 normalises over
    8 values a channel, which magnifies rounding)."""
    rng = np.random.default_rng(51)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    j = j_dla.dla34_small(**NARROW)
    v = random_module_variables(j, x, rng)
    ref_feats, upd = jax.jit(lambda v, x: j.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    ref = scoped_state_dict({"params": v["params"],
                             "batch_stats": to_numpy_tree(upd["batch_stats"])},
                            "backbone", "backbone.")
    start = scoped_state_dict(v, "backbone", "backbone.")
    t = build_backbone("dla34_small", **NARROW)
    t.load_state_dict(start, strict=True)
    t.train()
    with torch.no_grad():
        feats = t(nchw(x))
    for f, r in zip(feats, ref_feats):   # batch statistics: as train steps
        r = np.asarray(r)
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max())
    got = t.state_dict()
    keys = [k for k in ref if "running" in k]
    assert "level4.project_bn.running_mean" in keys
    for key in keys:
        r = ref[key].numpy()
        assert not torch.equal(got[key], start[key]), key
        np.testing.assert_allclose(got[key].numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=key)


@pytest.mark.parametrize("name", ["dla34", "dla34_small"])
def test_full_width_parameter_count(name):
    with torch.device("meta"):
        t = build_backbone(name)
    assert sum(p.numel() for p in t.parameters()) == jax_param_count(
        getattr(j_dla, name)())
    assert t.out_channels == getattr(j_dla, name)().out_channels


def test_dla34_ida_serving_slice():
    """bench_suite.py's `dla34_ida` (IDA neck, heads x 2), narrow."""
    serving_slice_parity({
        "num_classes": 5, "backbone": "dla34", "backbone_config": NARROW,
        "neck": "IDA", "neck_config": {"out_channels": 16},
        "head_config": {"width": 16, "depth": 2}, "num_detections": 20},
        np.random.default_rng(52))
