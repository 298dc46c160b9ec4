"""Share of the traced steps' kernel time in kernels launched inside the span `dcn.recompute` (ops/dcn.py:twin_vjp, the DCN kernels' backward recomputing their plain twins)."""
from cnbench.spans import span_kernel_share


def read(rec):
    return span_kernel_share(rec, ("dcn.recompute",))
