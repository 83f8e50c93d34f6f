"""device_idle_share.train: 1 - the union of device operation intervals over the traced steps' wall, in %."""
from port_bench import readers


def read(ctx):
    return readers.idle_share(ctx)
