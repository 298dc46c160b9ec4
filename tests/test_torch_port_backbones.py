"""PyTorch port vs the JAX package: the MobileNets (V2 at width 0.25,
V3-Large and V3-Small at 32 x 32), on the CPU with identical seeded
inputs and converted weights, BatchNorm statistics perturbed.

Tolerances rtol 1e-4 / atol 1e-4 (f32 convolutions summed in another
order than XLA's), as the other module tests. CSPDarknet-53 is held in
test_torch_port_models.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.backbones import mobilenet as j_mobilenet

from centernet_lightning_torch.models.backbones import mobilenet as t_mobilenet

from _torch_port_helpers import backbone_parity

@pytest.mark.parametrize("arch,size", [
    ("mobilenet_v2", 64), ("mobilenet_v3_large", 32), ("mobilenet_v3_small", 32),
])
def test_mobilenet_pyramid_parity(arch, size):
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    kw = {"width_mult": 0.25} if arch == "mobilenet_v2" else {}
    backbone_parity(getattr(j_mobilenet, arch)(**kw),
                     getattr(t_mobilenet, arch)(**kw), x, rng)


def test_mobilenet_blocks():
    """V3's SE convolutions carry biases; BatchNorm keeps flax's eps 1e-3;
    hidden widths copy the JAX package's int(round(...))."""
    net = t_mobilenet.mobilenet_v3_large()
    se = net.blocks[3].se
    assert se.reduce.bias is not None and se.expand.bias is not None
    assert se.reduce.out_channels == j_mobilenet._make_divisible(72 // 4)
    assert all(m.eps == 1e-3 for m in net.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
    v2 = t_mobilenet.mobilenet_v2(width_mult=0.35)
    assert v2.out_channels == j_mobilenet.MobileNetV2(width_mult=0.35).out_channels


