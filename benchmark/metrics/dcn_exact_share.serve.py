"""Share of the traced slice's kernel time in kernels launched inside the span `dcn.exact` (ops/dcn.py:exact_taps, the exact DCN engine's sampling), offline serving."""
from cnbench.spans import span_kernel_share


def read(rec):
    return span_kernel_share(rec, ("dcn.exact",))
