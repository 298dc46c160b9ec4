"""PyTorch port vs the JAX package: EfficientNet-B0..B3, on the CPU with
the same seeded numpy inputs and converted weights (BatchNorm statistics
perturbed), rtol 1e-4 / atol 1e-4 (f32 convolutions summed in another
order than XLA's).

B0 at `width_mult` 0.25 runs at 64 x 68 (strided depthwise SAME pads,
k = 3 and 5, on even and odd sizes); B3's compound-scaled
widths and depths, and every full-width parameter count, are JAX's
(traced, not run); stochastic depth is deterministic in eval, drops whole
rows in training with a generator and raises without one (parity is held
at drop rate 0 and in eval, as the JAX draws come from jax.random); the
reference's backbone-grid entry, B0 with a separable FPN and heads x 2,
runs as a whole serving slice at narrow widths.
"""
import math

import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.backbones import efficientnet as j_eff

from centernet_lightning_torch.models.backbones import build_backbone
from centernet_lightning_torch.models.backbones import efficientnet as t_eff

from _torch_port_helpers import (backbone_parity, jax_param_count,
                                 serving_slice_parity)

NAMES = ["efficientnet_b0", "efficientnet_b1", "efficientnet_b2",
         "efficientnet_b3"]


def test_b0_pyramid_parity():
    # 64 x 68: the strided depthwise convs see even sizes along H (SAME
    # pads (0, 1) at k = 3, (1, 2) at k = 5) and, from the s4 map on (68 /
    # 4 = 17), odd ones along W ((1, 1) and (2, 2))
    rng = np.random.default_rng(60)
    size = (64, 68)
    x = rng.normal(size=(1,) + size + (3,)).astype(np.float32)
    t = build_backbone("efficientnet_b0", width_mult=0.25)
    gots = backbone_parity(j_eff.efficientnet_b0(width_mult=0.25), t, x, rng,
                           jit=True)
    assert [g.shape[2] for g in gots] == [-(-size[0] // s) for s in (4, 8, 16, 32)]
    assert t.taps == [3, 5, 11]       # the maps entering the s2 blocks at s4/8/16
    assert all(b.se.reduce.out_channels == max(1, b.convs[0].conv.in_channels // 4)
               for b in t.blocks)


@pytest.mark.parametrize("name", NAMES)
def test_full_width_parameter_count(name):
    with torch.device("meta"):
        t = build_backbone(name)
    j = getattr(j_eff, name)()
    assert sum(p.numel() for p in t.parameters()) == jax_param_count(j)
    assert t.out_channels == j.out_channels


def test_b3_widths_and_depths():
    t = build_backbone("efficientnet_b3")
    j = j_eff.efficientnet_b3()
    assert t.out_channels == j.out_channels == [32, 48, 136, 384]
    depths = [math.ceil(n * 1.4) for *_, n in t_eff.STAGES]
    assert len(t.blocks) == sum(depths) == 26
    assert t.convs[0].conv.out_channels == j._c(32) == 40
    widths = [b.convs[-1].conv.out_channels for b in t.blocks]
    stage_widths = [j._c(c) for _, _, _, c, _ in j._cfg]
    assert widths == [w for w, d in zip(stage_widths, depths) for _ in range(d)]


def _sd_block():
    torch.manual_seed(0)
    return t_eff.MBConv(8, 8, kernel=3, stride=1, expand=2, sd_prob=0.5)


def test_stochastic_depth():
    x = torch.randn(16, 8, 6, 6, generator=torch.Generator().manual_seed(1))
    block = _sd_block().eval()
    with torch.no_grad():
        a, b = block(x), block(x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b)                      # eval: no draw, no drop
    block.train()
    with pytest.raises(ValueError, match="generator"):
        block(x)
    full = _sd_block().train()
    full.sd_prob = 0.0
    with torch.no_grad():
        kept = full(x) - x                       # the branch, batch statistics
        out = block(x, torch.Generator().manual_seed(3))
        again = block(x, torch.Generator().manual_seed(3))
    assert torch.equal(out, again)                # the generator decides
    dropped = [bool(torch.equal(out[i], x[i])) for i in range(16)]
    assert 0 < sum(dropped) < 16                  # whole rows, not all
    for i in range(16):
        if not dropped[i]:
            torch.testing.assert_close(out[i], kept[i] / 0.5 + x[i])
    # the backbone hands its generator to the blocks
    net = build_backbone("efficientnet_b0", width_mult=0.25,
                         stochastic_depth_prob=0.2).train()
    with pytest.raises(ValueError, match="generator"):
        net(x[:2, :3])
    net.generator = torch.Generator().manual_seed(4)
    assert len(net(x[:2, :3])) == 4


def test_b0_separable_fpn_serving_slice():
    """bench_suite.py's `efficientnet_b0` (separable FPN, heads x 2),
    narrow."""
    serving_slice_parity({
        "num_classes": 5, "backbone": "efficientnet_b0",
        "backbone_config": {"width_mult": 0.25}, "neck": "FPN",
        "neck_config": {"out_channels": 16, "conv_type": "separable"},
        "head_config": {"width": 16, "depth": 2}, "num_detections": 20},
        np.random.default_rng(62))


def test_init_weights_squeeze_excite_and_convs():
    """init_weights draws the JAX package's distributions for the new
    families: he_normal for ConvBNSiLU, ConvBN and DLA's convolutions,
    lecun_normal with zero biases for EfficientNet's SE and VoVNet's eSE
    convolutions (flax's default `nn.Conv`)."""
    from centernet_lightning_torch.models.backbones import vovnet as t_vovnet
    from centernet_lightning_torch.models.meta import init_weights

    def init(name, **cfg):
        backbone = build_backbone(name, **cfg)
        init_weights(backbone, torch.Generator().manual_seed(0))
        return backbone

    def std_ratio(convs, gain):
        w = torch.cat([c.weight.flatten() / np.sqrt(gain / c.weight[0].numel())
                       for c in convs])
        return w.std().item()

    eff = init("efficientnet_b0", width_mult=0.5)
    se = [m for m in eff.modules() if isinstance(m, t_eff.SqueezeExciteSiLU)]
    assert abs(std_ratio([c for m in se for c in (m.reduce, m.expand)], 1.0) - 1) < 0.05
    assert all(not m.reduce.bias.any() and not m.expand.bias.any() for m in se)
    convs = [m.conv for m in eff.modules() if isinstance(m, t_eff.ConvBNSiLU)]
    assert abs(std_ratio(convs, 2.0) - 1) < 0.05
    vov = init("vovnet19", stage_channels=(16, 16, 16, 16),
               concat_channels=(32, 32, 48, 48))
    ese = [m.conv for m in vov.modules() if isinstance(m, t_vovnet.ESE)]
    assert abs(std_ratio(ese, 1.0) - 1) < 0.05
    assert all(not c.bias.any() for c in ese)
    dla = init("dla34_small")
    assert abs(std_ratio([dla.level4.project_conv, dla.level5.root.conv], 2.0) - 1) < 0.05
