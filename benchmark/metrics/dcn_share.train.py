"""Share of the traced steps' device time (CUDA events) inside the DCN blocks' forwards and backwards (module hooks)."""
from cnbench.readers import share


def read(rec):
    return share(rec.get("dcn_block_s"), rec.get("steps_device_s"))
