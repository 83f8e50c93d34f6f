"""glue_share.infer: elementwise, copy and norm kernels' device seconds against all device seconds of the traced batches, in %."""
from port_bench import readers


def read(ctx):
    return readers.glue_share(ctx)
