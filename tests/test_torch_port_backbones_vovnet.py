"""PyTorch port vs the JAX package: VoVNet-19 / 39 / 57, on the CPU with
the same seeded numpy inputs and converted weights (BatchNorm statistics
perturbed), rtol 1e-4 / atol 1e-4 (f32 convolutions summed in another
order than XLA's).

Narrow `stage_channels` / `concat_channels` at 64^2 and 66 x 70 reach both
of flax's SAME paddings ((0, 1) and (1, 1)) in the strided stem
convolutions and the stage pools, and VoVNet-39's identity blocks; the
full-width parameter counts are JAX's (traced, not run); the reference's
best COCO recipe, VoVNet-39 FPN-256 with heads 256 x 3, runs as a whole
serving slice at narrow widths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.backbones import vovnet as j_vovnet

from centernet_lightning_torch.models.backbones import build_backbone
from centernet_lightning_torch.models.backbones import vovnet as t_vovnet

from _torch_port_helpers import (backbone_parity, jax_param_count,
                                 serving_slice_parity)

NARROW = {"stage_channels": (8, 8, 12, 12), "concat_channels": (16, 16, 24, 24)}


# 64^2: every SAME pad (0, 1); 66 x 70: the stem's first s2 conv pads
# (0, 1), its second and the pools (1, 1) (odd sizes 33 x 35 and on)
@pytest.mark.parametrize("name", ["vovnet19", "vovnet39"])
@pytest.mark.parametrize("size", [(64, 64), (66, 70)])
def test_vovnet_pyramid_parity(name, size):
    rng = np.random.default_rng(40)
    x = rng.normal(size=(1,) + size + (3,)).astype(np.float32)
    t = build_backbone(name, **NARROW)
    gots = backbone_parity(getattr(j_vovnet, name)(**NARROW), t, x, rng,
                           jit=True)
    # stem s4 (SAME), then three SAME pools: ceil halvings
    h, w = -(-size[0] // 4), -(-size[1] // 4)
    assert [tuple(g.shape[2:]) for g in gots] == [
        (-(-h // 2 ** i), -(-w // 2 ** i)) for i in range(4)]
    identity = [b.identity for b in t.blocks]
    assert identity == ([False] * 4 if name == "vovnet19"
                        else [False, False, False, True, False, True])


@pytest.mark.parametrize("size", [8, 9])
def test_stage_pool_pads_same(size):
    """The stage pool pads as flax's SAME reduce_window, -inf in the pad:
    (0, 1) on an even size, where max_pool2d(padding=1) pads (1, 1)."""
    import jax

    x = np.random.default_rng(41).normal(size=(1, size, size, 3)).astype(np.float32)
    x -= 10.0                                # all negative: a 0 pad would win
    ref = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = t_vovnet.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref))


def test_ese_gate_and_identity():
    ese = t_vovnet.ESE(4)
    with torch.no_grad():
        ese.conv.weight.zero_()
        ese.conv.bias.copy_(torch.tensor([-9.0, -3.0, 0.0, 6.0]))
        y = ese(torch.ones(1, 4, 2, 2))
    # clip(s / 6 + 0.5, 0, 1)
    np.testing.assert_array_equal(y[0, :, 0, 0].numpy(), [0.0, 0.0, 0.5, 1.0])


@pytest.mark.parametrize("name", ["vovnet19", "vovnet39", "vovnet57"])
def test_full_width_parameter_count(name):
    with torch.device("meta"):
        t = build_backbone(name)
    assert sum(p.numel() for p in t.parameters()) == jax_param_count(
        getattr(j_vovnet, name)())
    assert t.out_channels == getattr(j_vovnet, name)().out_channels


def test_vovnet39_fpn_serving_slice():
    """bench_suite.py's `vovnet39` (FPN, heads x 3), narrow."""
    serving_slice_parity({
        "num_classes": 5, "backbone": "vovnet39", "backbone_config": NARROW,
        "neck": "FPN", "neck_config": {"out_channels": 16},
        "head_config": {"width": 16, "depth": 3}, "num_detections": 20},
        np.random.default_rng(42))
