"""The traced window: torch.profiler over whole units of a run (CUDA
activity only: recording every host operation as well slowed the
flagship's host by a third and made the card wait on it), reduced in
memory to what the per-layer readers and the result's `breakdown` need. No
trace file is written.

The reduction sums the raw kineto device events by name (not
`key_averages()`, which builds a Python object per event), classes them by
the patterns under `kernels/`, takes the device's busy time as the union of
its event intervals, and labels each idle gap between them by the device
operations on either side of it: the host was launching the one after.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TraceSummary:
    window_s: float                 # host wall of the traced units, ended by a synchronize
    busy_s: float                   # union of device event intervals
    device_s_by_name: Dict[str, Tuple[float, int]]   # kernel name -> (seconds, count)
    device_s_by_class: Dict[str, float]
    gaps: List[Tuple[str, float]]   # the longest idle gaps, (label, seconds)
    units: int                      # batches or steps traced


def union_seconds(intervals: Sequence[Tuple[int, int]]) -> Tuple[float, List[Tuple[int, int]]]:
    """Total length (s) of the union of [start_ns, end_ns) intervals, and
    the idle gaps between the merged intervals as (start_ns, end_ns)."""
    if not len(intervals):
        return 0.0, []
    iv = np.asarray(sorted(intervals), dtype=np.int64)
    total, gaps = 0, []
    cur_s, cur_e = int(iv[0, 0]), int(iv[0, 1])
    for s, e in iv[1:]:
        s, e = int(s), int(e)
        if s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total / 1e9, gaps


def classify(names: Sequence[str], classes: Sequence[Tuple[str, Sequence[str]]]) -> Dict[str, str]:
    """Kernel name -> class: the first class (in priority order) one of
    whose patterns the name contains, else "other"."""
    return {n: next((c for c, pats in classes if any(p in n for p in pats)), "other") for n in names}


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return name[:min(cut)] if cut else name


def label_gaps(gaps: Sequence[Tuple[int, int]], events: Sequence[Tuple[int, int, str]], top: int = 10):
    """(label, seconds) of the `top` longest gaps, each labelled "after A /
    before B" by the device events that end it and follow it; `events`
    holds the device events as (start_ns, end_ns, name)."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    if not longest:
        return []
    ev = sorted(events)
    starts = np.asarray([e[0] for e in ev], dtype=np.int64)
    ends = np.asarray([e[1] for e in ev], dtype=np.int64)
    out = []
    for g0, g1 in longest:
        nxt = int(np.searchsorted(starts, g1))
        before = ev[nxt][2] if nxt < len(ev) else "end"
        done = np.flatnonzero(ends <= g0)
        after = ev[int(done[np.argmax(ends[done])])][2] if len(done) else "start"
        out.append((f"after {short_name(after)} / before {short_name(before)}", (g1 - g0) / 1e9))
    return out


def summarize(events, window_s: float, units: int, classes) -> TraceSummary:
    """Reduce kineto events (`prof.profiler.kineto_results.events()`)."""
    from torch.autograd import DeviceType

    device, by_name = [], {}
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
        dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)
        device.append((start, start + dur, e.name()))
        row = by_name.setdefault(e.name(), [0, 0])
        row[0] += dur
        row[1] += 1
    busy, gaps = union_seconds([(s, e) for s, e, _ in device])
    of = classify(list(by_name), classes)
    by_class: Dict[str, float] = {}
    for name, (ns, _) in by_name.items():
        by_class[of[name]] = by_class.get(of[name], 0.0) + ns / 1e9
    return TraceSummary(
        window_s=window_s, busy_s=busy,
        device_s_by_name={n: (ns / 1e9, c) for n, (ns, c) in by_name.items()},
        device_s_by_class=by_class, gaps=label_gaps(gaps, device), units=units)


class Tracer:
    """`with tracer.window(): ...` profiles the units run inside and, on
    exit, synchronizes and reduces them into `tracer.summary`."""

    def __init__(self, classes, device):
        self.classes, self.device = classes, device
        self.summary: Optional[TraceSummary] = None
        self.units = 0

    @contextlib.contextmanager
    def window(self) -> Iterator["Tracer"]:
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield self
            torch.cuda.synchronize(self.device)
            window_s = time.perf_counter() - t0
        self.summary = summarize(prof.profiler.kineto_results.events(), window_s, self.units, self.classes)


def breakdown(summary: TraceSummary, top: int = 10) -> Dict[str, list]:
    ops = sorted(((n, s) for n, (s, _) in summary.device_s_by_name.items()), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[label[:120], s] for label, s in summary.gaps[:top]]}
