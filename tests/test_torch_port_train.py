"""PyTorch port vs the JAX package: the train step (train/state.py) on the
CPU, from the same weights on the same batches.

ResNet-18, FPN-32, heads 32 x 1, 5 classes, GIoU with `box_log`, batch 2 of
uint8 64 x 64 images (normalised inside the step), f32, three steps of
JAX's `make_train_step` (jitted) against three of the port's, with an EMA
of the weights. After every step the losses must agree at rtol 1e-5;
after the third the parameters, the BatchNorm statistics (flax's biased
running variance: n = 8 at stride 32, where torch's own unbiased update
would be 14% off) and the EMA at rtol 1e-4, with an atol of 1e-4 of each
tensor's largest magnitude (convolutions and their gradients summed in
another order; the learning rates are chosen so that the drift that such
rounding starts at ReLU kinks stays inside these, see
_torch_port_helpers.TRAIN_OPT). SGD here, with no stage frozen; AdamW is in
test_torch_port_train_adamw.py and frozen stages in
test_torch_port_train_frozen*.py (one JAX step compile a file keeps each
file well inside a minute).
"""
from _torch_port_helpers import train_step_parity


def test_train_steps_match_jax():
    train_step_parity("SGD", frozen_stages=0)
