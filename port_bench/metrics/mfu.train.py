"""mfu.train: the training step's model operations (forward and backward, work/flops.py) in the traced window against its seconds at the bf16 dense peak, in %."""
from port_bench import readers


def read(ctx):
    return readers.mfu(ctx)
