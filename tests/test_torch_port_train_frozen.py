"""PyTorch port vs the JAX package: the train step with the stem and the
first two ResNet stages frozen (`backbone_config.frozen_stages: 2`), on
the CPU: their BatchNorms run on running statistics in train mode, no
gradient reaches them and the optimizer leaves them (decay included)
unchanged. Same model, batches, steps and tolerances as
test_torch_port_train.py; SGD here, AdamW in
test_torch_port_train_frozen_adamw.py.
"""
from _torch_port_helpers import train_step_parity


def test_train_steps_with_frozen_stages_match_jax():
    train_step_parity("SGD", frozen_stages=2)
