"""PyTorch port vs the JAX package: three AdamW train steps, no stage
frozen; model, batches and tolerances as in test_torch_port_train.py."""
from _torch_port_helpers import train_step_parity


def test_adamw_train_steps_match_jax():
    train_step_parity("AdamW", frozen_stages=0)
