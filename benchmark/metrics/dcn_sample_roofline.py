"""csrc/dcn_sample.cu's least time (roofline/kernels.py:dcn_sample_s) over its measured time, summed over the traced launches."""
from cnbench.readers import dcn_sample_bound, roofline


def read(rec):
    return roofline(rec, "dcn_sample_kernel", dcn_sample_bound(rec))
