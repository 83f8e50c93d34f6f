"""The arithmetic the per-layer readers under metrics/ share. Each takes
the context of a traced window: `trace` (trace.TraceSummary), `work` (the
generator's counts for the traced units: `model_flops` and, by kernel
class, a list of ((operations, bytes, exponentials), calls)), `peaks`
(work/peaks.json), `peak_bytes` and `window_s`. A reader that finds
nothing to read returns None, and the metric is left out of the line."""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

from port_bench.work.attention import bound_s

GLUE_CLASSES = ("elementwise", "copy_permute", "norm")


def mfu(ctx: Mapping) -> Optional[float]:
    """The window's model operations against the bf16 dense peak, in %."""
    flops, window = ctx["work"].get("model_flops"), ctx["window_s"]
    if not flops or not window:
        return None
    return 100.0 * flops / (window * ctx["peaks"]["bf16_flops_per_s"])


def roofline(ctx: Mapping, classes: Sequence[str]) -> Optional[float]:
    """The least time the calls of `classes` could take (the larger of
    their operations at the bf16 peak and their bytes at HBM bandwidth),
    against their device time in the window, in %."""
    calls = [c for cls in classes for c in ctx["work"].get("kernels", {}).get(cls, [])]
    device = sum(ctx["trace"].device_s_by_class.get(cls, 0.0) for cls in classes)
    if not calls or device <= 0:
        return None
    least = sum(bound_s(w, ctx["peaks"]) * n for w, n in calls)
    return 100.0 * least / device


def glue_share(ctx: Mapping) -> Optional[float]:
    """Device seconds of PyTorch's elementwise, copy and norm kernels
    against all device seconds, in %."""
    by_class = ctx["trace"].device_s_by_class
    total = sum(by_class.values())
    if total <= 0:
        return None
    return 100.0 * sum(by_class.get(c, 0.0) for c in GLUE_CLASSES) / total


def idle_share(ctx: Mapping) -> Optional[float]:
    """The share of the traced window in which no device operation ran, in %."""
    t = ctx["trace"]
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def device_s_per_unit(ctx: Mapping) -> Optional[float]:
    """Device-busy seconds (the union of device intervals) a traced batch or
    step: the device's share of the unit, steadier than the wall's rate."""
    t = ctx["trace"]
    return t.busy_s / t.units if t.units and t.busy_s > 0 else None


def peak_gib(ctx: Mapping) -> Optional[float]:
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
