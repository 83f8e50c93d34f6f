"""peak_mem_gib.infer: torch.cuda.max_memory_allocated over the traced batches, in GiB."""
from port_bench import readers


def read(ctx):
    return readers.peak_gib(ctx)
