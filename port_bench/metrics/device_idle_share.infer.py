"""device_idle_share.infer: 1 - the union of device operation intervals over the traced batches' wall, in %."""
from port_bench import readers


def read(ctx):
    return readers.idle_share(ctx)
