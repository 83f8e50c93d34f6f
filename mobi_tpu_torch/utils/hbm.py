"""Pre-flight memory check on the card (mobi_tpu utils/hbm.py).

The JAX package checks a compiled program's memory plan against the device
before its first dispatch. CUDA has no compiled plan: PyTorch allocates as
it runs. The port measures instead: it runs a program once under
`torch.cuda.reset_peak_memory_stats` and reads what the caching allocator
held (`measure`), as a record with the five fields of JAX's
CompiledMemoryStats, and `check_fits` holds that record against the card's
memory with the JAX package's arithmetic and message. An over-budget probe
on the card raises torch's OutOfMemoryError before it gets that far; the
check catches what fits the card but not a smaller budget a caller sets.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch


class HbmOverBudgetError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class MemoryRecord:
    """What one run of a program held on the card, under the field names of
    jax's CompiledMemoryStats: the bytes live before it (its arguments, and
    everything else the process holds), the bytes it left live (its
    outputs), and the peak above both (its temporaries). CUDA programs have
    no separate code or aliased bytes."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    generated_code_size_in_bytes: int = 0
    alias_size_in_bytes: int = 0


def device_hbm_budget(device=None) -> Optional[int]:
    """The card's memory in bytes from the CUDA runtime, or None on the CPU
    (or with no CUDA device)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.cuda.mem_get_info(dev)[1]


def check_fits(stats, limit_bytes: int, label: str = "program") -> None:
    """Raise HbmOverBudgetError when a memory record exceeds the budget.
    Arguments, outputs, temps, and generated code coexist at execute time;
    aliased bytes are counted once."""
    need = (
        stats.generated_code_size_in_bytes
        + stats.argument_size_in_bytes
        + stats.output_size_in_bytes
        + stats.temp_size_in_bytes
        - stats.alias_size_in_bytes
    )
    if need > limit_bytes:
        gb = 1024**3
        raise HbmOverBudgetError(
            f"{label} needs {need / gb:.2f} GiB HBM "
            f"(args {stats.argument_size_in_bytes / gb:.2f} + temps "
            f"{stats.temp_size_in_bytes / gb:.2f} + outputs "
            f"{stats.output_size_in_bytes / gb:.2f} + code "
            f"{stats.generated_code_size_in_bytes / gb:.2f}) but the device "
            f"has {limit_bytes / gb:.2f} GiB. Reduce the batch size (bench: "
            "MOBI_BENCH_BATCH_PAIRS) or enable remat/chunking."
        )


def measure(fn: Callable, device=None) -> Tuple[object, MemoryRecord]:
    """(fn(), the memory record of that run on `device`): the allocator's
    bytes before and after the call, and its peak in between."""
    dev = torch.device("cuda" if device is None else device)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_allocated(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return out, MemoryRecord(argument_size_in_bytes=before, output_size_in_bytes=max(after - before, 0),
                             temp_size_in_bytes=max(peak - max(after, before), 0))


def assert_fits(record: Optional[MemoryRecord], device=None, label: str = "program",
                limit_bytes: Optional[int] = None) -> bool:
    """Check a measured record against the card's memory (or `limit_bytes`).
    Returns True when the check ran, False where there is no budget (the CPU)
    or no record (then the check is skipped, not failed)."""
    limit = device_hbm_budget(device) if limit_bytes is None else limit_bytes
    if limit is None or record is None:
        return False
    check_fits(record, limit, label)
    return True


def live_hbm_gb(device=None) -> float:
    """The bytes the caching allocator holds in live tensors, in GiB (0 on
    the CPU): logged between the oracle's phases, so an out-of-memory error
    in the drive's log comes with data."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    return torch.cuda.memory_allocated(dev) / 2**30
