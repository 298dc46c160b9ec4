"""PyTorch port vs the JAX package: the train step of the DCN model on the
CPU, the slice as a whole: ResNet-18, FPN-32 with DCNv2 merge blocks on
the sampler's engine (`dcn_fast_d1`, whose backward runs through the
sampler's `autograd.Function`; the fused engine is in
test_torch_port_train_dcn_fused.py), heads 32 x 1, 5 classes, batch 2 of
uint8 64 x 64 images, f32, one SGD step against JAX's `make_train_step`: the losses at rtol 1e-5, the
updated parameters, BatchNorm statistics and EMA at rtol 1e-4 with an atol
of 1e-4 of each tensor's largest magnitude.

The offset and mask convolutions are seeded draws, scaled so offsets pass
+-1 (see `_calibrate_dcn`); continuous draws sit on no clamp tie. One step,
not three: the coarsest DCN layer runs on 4 x 4 maps, where one ReLU or
GIoU kink moves a layer's gradient by percents, and at this seed the
port's own gradient after one update changes by 12% under a 1e-7 change
of the input, so the two trajectories part for reasons of rounding alone.
"""
from _torch_port_helpers import train_step_parity


def test_dcn_fast_train_step_matches_jax():
    train_step_parity("SGD", frozen_stages=0, steps=1, conv_type="dcn_fast_d1")
