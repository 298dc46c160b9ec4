"""Device kernels launched a training step, over the traced steps."""
from cnbench.readers import kernels_per_step as read  # noqa: F401
