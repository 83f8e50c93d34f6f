"""mfu.infer: the inpaint pipeline's model operations in the traced window (work/flops.py, CFG doubling included) against the window's seconds at the bf16 dense peak, in %."""
from port_bench import readers


def read(ctx):
    return readers.mfu(ctx)
