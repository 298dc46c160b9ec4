"""PyTorch port vs the JAX package: CSPDarknet-53 at narrow widths, and
the whole model of each shipped detection config family (CSPDarknet FPN
with the SPP extra block, MobileNetV2 with a separable SimpleNeck,
ResNet-34 with a nearest SimpleNeck, ResNet-18 BiFPN), on the CPU with identical seeded inputs and converted
weights, BatchNorm statistics perturbed.

Tolerances rtol 1e-4 / atol 1e-4 (f32 convolutions summed in another
order than XLA's); whole models compare the logits at an atol of 1e-4 of
their largest magnitude. mish: torch's softplus returns x above 20,
flax's logaddexp(x, 0) adds a term below 2.1e-9 there, which f32 rounds
away; the two differ by rounding only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centernet_lightning_tpu.models.backbones import darknet as j_darknet
from centernet_lightning_tpu.models.centernet import CenterNet as JCenterNet

from centernet_lightning_torch.models.backbones import darknet as t_darknet
from centernet_lightning_torch.models.centernet import CenterNet as TCenterNet
from centernet_lightning_torch.utils.convert import variables_to_state_dict

from _torch_port_helpers import (
    NARROW_DARKNET, backbone_parity, perturb_batch_norm, to_numpy_tree,
)


def test_cspdarknet_pyramid_parity():
    rng = np.random.default_rng(30)
    x = rng.normal(size=(2, 64, 62, 3)).astype(np.float32) * 2
    gots = backbone_parity(j_darknet.CSPDarknet53(**NARROW_DARKNET),
                            t_darknet.CSPDarknet53(**NARROW_DARKNET), x, rng)
    assert [g.shape[2] for g in gots] == [16, 8, 4, 2]


FAMILIES = {
    # configs/centernet.yaml's family, with the SPP extra block
    "cspdarknet_fpn_spp": dict(
        backbone="cspdarknet53", backbone_config=NARROW_DARKNET,
        neck="FPN", neck_config={"out_channels": 16},
        extra_block={"name": "SPP", "pool_sizes": [3, 5]}),
    # configs/helmet.yaml's
    "mobilenet_v2_simple_separable": dict(
        backbone="mobilenet_v2", backbone_config={"width_mult": 0.25},
        neck="SimpleNeck", neck_config={"upsample_channels": [16, 12, 8],
                                        "conv_type": "separable"}),
    # configs/base_resnet34.yaml's
    "resnet34_simple_nearest": dict(
        backbone="resnet34", backbone_config={"width": 8},
        neck="SimpleNeck", neck_config={"upsample_channels": [16, 12, 8]}),
    # the reference's ResNet-34 BiFPN
    "resnet18_bifpn": dict(
        backbone="resnet18", backbone_config={"width": 8},
        neck="BiFPN", neck_config={"out_channels": 16}),
}


def _variables(task, rng, size):
    v = to_numpy_tree(task.init(jax.random.PRNGKey(0), image_size=(size, size)))
    return perturb_batch_norm(v, rng)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_whole_model_parity(family):
    rng = np.random.default_rng(32)
    cfg = dict(num_classes=3, head_config={"width": 8, "depth": 1},
               **FAMILIES[family])
    jtask = JCenterNet(**cfg)
    v = _variables(jtask, rng, 64)
    ttask = TCenterNet(**cfg)
    ttask.model.load_state_dict(variables_to_state_dict(v), strict=True)
    ttask.model.eval()
    assert ttask.stride == jtask.stride
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    ref = jtask.model.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = ttask.model(torch.from_numpy(x))
    for key in ("heatmap", "box_2d"):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key].numpy(), r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=key)


def test_init_weights_new_modules():
    """init_weights draws the JAX package's distributions for the slice's
    modules: the transpose conv is `_bilinear_kernel` (or he_normal over
    fan-in k^2 C_in), the squeeze-excite convs lecun_normal with zero
    biases, the fusion weights ones, a depthwise conv he_normal over k^2."""
    from centernet_lightning_tpu.models.layers import _bilinear_kernel

    from centernet_lightning_torch.models import layers as t_layers
    from centernet_lightning_torch.models.backbones import mobilenet as t_mb

    def build(**cfg):
        task = TCenterNet(num_classes=3, head_config={"width": 8, "depth": 1},
                          **cfg)
        task.init(torch.Generator().manual_seed(0))
        return task.model

    model = build(backbone="resnet18", backbone_config={"width": 8},
                  neck="SimpleNeck", neck_config={
                      "upsample_channels": [64, 32, 16],
                      "upsample_type": "conv_transpose"})
    for up in model.neck.upsamples:
        w = up.conv.weight.detach().numpy()             # (in, out, k, k)
        ref = _bilinear_kernel(4, w.shape[0])[::-1, ::-1].transpose(2, 3, 0, 1)
        np.testing.assert_array_equal(w, ref)
    model = build(backbone="resnet18", backbone_config={"width": 8},
                  neck="SimpleNeck", neck_config={
                      "upsample_channels": [256, 128, 64],
                      "upsample_type": "conv_transpose",
                      "deconv_init_bilinear": False})
    w = model.neck.upsamples[0].conv.weight
    assert abs(w.std().item() / np.sqrt(2.0 / (16 * 256)) - 1) < 0.1
    model = build(backbone="mobilenet_v3_large", neck="BiFPN",
                  neck_config={"out_channels": 16})
    se = [m for m in model.modules() if isinstance(m, t_mb.SqueezeExcite)]
    reduce = torch.cat([m.reduce.weight.flatten() * np.sqrt(m.reduce.in_channels)
                        for m in se])
    assert abs(reduce.std().item() - 1) < 0.1
    assert all(not m.reduce.bias.any() and not m.expand.bias.any() for m in se)
    fuses = [m for m in model.modules() if isinstance(m, t_layers.Fuse)]
    assert fuses and all(torch.equal(f.fuse_weights, torch.ones(len(f.fuse_weights)))
                         for f in fuses)
    dw = model.backbone.blocks[-1].convs[1].conv.weight      # (960, 1, 5, 5)
    assert abs(dw.std().item() / np.sqrt(2.0 / 25) - 1) < 0.05
