"""glue_share.train: elementwise, copy and norm kernels' device seconds against all device seconds of the traced steps, in %."""
from port_bench import readers


def read(ctx):
    return readers.glue_share(ctx)
