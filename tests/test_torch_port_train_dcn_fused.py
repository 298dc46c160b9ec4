"""PyTorch port vs the JAX package: one SGD train step of the DCN model on
the fused engine (`dcn_fused_d1`, whose backward runs through the fused
kernel's `autograd.Function`); as test_torch_port_train_dcn.py."""
from _torch_port_helpers import train_step_parity


def test_dcn_fused_train_step_matches_jax():
    train_step_parity("SGD", frozen_stages=0, steps=1, conv_type="dcn_fused_d1")
