"""Share of the device's kernel time in BatchNorm and activation kernels (cnbench/readers.py:NORM_ACT), offline serving."""
from cnbench.readers import NORM_ACT, kernel_share


def read(rec):
    return kernel_share(rec, NORM_ACT)
