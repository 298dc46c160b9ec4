"""csrc/peak_decode.cu's least time (roofline/kernels.py:peak_decode_s) over its measured time, summed over the traced launches."""
from cnbench.readers import peak_bound, roofline


def read(rec):
    return roofline(rec, "peak_rows_kernel", peak_bound(rec))
