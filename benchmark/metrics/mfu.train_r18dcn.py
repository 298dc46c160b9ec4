"""Model FLOPs (three forwards of the reference an image) of the traced steps, over their length, against the bf16 peak."""
from cnbench.readers import mfu


def read(rec):
    return mfu(rec, passes=3)
