"""peak_mem_gib.train: torch.cuda.max_memory_allocated over the traced steps, in GiB."""
from port_bench import readers


def read(ctx):
    return readers.peak_gib(ctx)
