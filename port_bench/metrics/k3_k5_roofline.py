"""k3_k5_roofline: the training step's flash calls (the K1 call, K3, K4 and K5) by their least time against the device time of the attention_forward and attention_backward classes, in %."""
from port_bench import readers


def read(ctx):
    return readers.roofline(ctx, ("attention_forward", "attention_backward"))
