"""Model FLOPs (the reference's forward) of the images served in the traced slice, over its length, against the bf16 peak."""
from cnbench.readers import mfu


def read(rec):
    return mfu(rec, passes=1)
