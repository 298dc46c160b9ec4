"""PyTorch port vs the JAX package: three AdamW train steps with the stem and
the first two ResNet stages frozen; as test_torch_port_train_frozen.py."""
from _torch_port_helpers import train_step_parity


def test_adamw_train_steps_with_frozen_stages_match_jax():
    train_step_parity("AdamW", frozen_stages=2)
