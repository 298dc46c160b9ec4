"""PyTorch port vs the JAX package: three SGD train steps of a narrow
CSPDarknet-53 FPN (stage filters 32/32/32/64/64, one ResBlock a stage,
widths of 16 or more), as test_torch_port_train.py does for the ResNet:
mish, BatchNorm in train mode and the strided SAME convolutions, forward
and backward, under the same tolerances (losses rtol 1e-5; parameters,
BatchNorm statistics and EMA rtol 1e-4 with an atol of 1e-4 of each
tensor's largest magnitude)."""
from _torch_port_helpers import train_step_parity

DARKNET = {"backbone": "cspdarknet53",
           "backbone_config": {"stage_blocks": (1, 1, 1, 1, 1),
                               "stage_filters": (32, 32, 32, 64, 64)}}


def test_darknet_train_steps_match_jax():
    train_step_parity("SGD", frozen_stages=0, model=DARKNET)
