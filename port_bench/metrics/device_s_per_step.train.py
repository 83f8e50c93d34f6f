"""device_s_per_step.train: the device's busy seconds (union of device intervals) a traced step: the device work of the unit, steadier than the end-to-end rate, which the host also sets."""
from port_bench import readers


def read(ctx):
    return readers.device_s_per_unit(ctx)
