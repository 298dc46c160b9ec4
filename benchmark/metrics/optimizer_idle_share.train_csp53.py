"""Share of the traced training steps of the csp53 cell in which the device ran nothing inside the span `train.optimizer`."""
from cnbench.spans import span_idle_share


def read(rec):
    return span_idle_share(rec, ("train.optimizer",))
