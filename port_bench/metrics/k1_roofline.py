"""k1_roofline: K1's calls' least time by the two physical roofs (work/attention.py) against the device time of the attention_forward kernel class, in %."""
from port_bench import readers


def read(ctx):
    return readers.roofline(ctx, ("attention_forward",))
