"""One run of one cell of the port's benchmark:

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the cell's model on weights made
from the seed, warms up every shape of the cell, measures for `--seconds`
(`--trace 0`: the cell's end-to-end metrics) or profiles whole units
(`--trace 1`: its per-layer metrics), checks what the measured path
produced against the plain float32 reference, checks that nothing of JAX
or of the JAX package was loaded, and prints one JSON object as the last
line of its standard output. Earlier lines are JSON objects with a `line`
key. It needs as many CUDA devices as the cell asks for and exits 2 with
no result without them.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()  # before torch: set-up counts the imports

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional, Sequence  # noqa: E402

from port_bench import harness  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's CUDA library builds into build/kernels/ there itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)


class Run:
    def __init__(self, cell: harness.Cell, seed: int, seconds: float, trace: bool, device):
        self.cell, self.seed, self.seconds, self.trace, self.device = cell, seed, seconds, trace, device
        self.setup_s: Optional[float] = None
        self.phases: Dict[str, float] = {}
        self._last = _T0

    def mark(self, phase: str, now: Optional[float] = None) -> None:
        """End the set-up phase `phase` (now, or at `now`): its seconds go on
        the `window` line."""
        now = time.perf_counter() if now is None else now
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self._last
        self._last = now

    def window_started(self) -> None:
        """Called by the generator just before its first measured unit."""
        if self.setup_s is None:
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
            self.mark("until_window")
            self.setup_s = time.perf_counter() - _T0


def parse(argv: Optional[Sequence[str]]):
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device: Optional[str] = None,
         bench_dir: Path = harness.BENCH_DIR) -> int:
    """`device` is for the CPU tests: "cpu" skips the look for a card."""
    args = parse(argv)
    pin_caches()
    import torch

    imported = time.perf_counter()
    cell = harness.find_cell(args.workload, bench_dir)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"port_bench: {cell.name} needs {cell.chips} CUDA device(s); {n} available", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    # one host thread for PyTorch's CPU work: the card's work is launched
    # from this thread alone, and idle pool threads only take cores from it
    torch.set_num_threads(1)
    run = Run(cell, args.seed, args.seconds, bool(args.trace), dev)
    run.mark("import_torch", imported)
    cuda = dev.type == "cuda"
    if cuda:
        torch.zeros(1, device=dev)
    run.mark("cuda_context")
    gen = harness.generator(cell)
    run.mark("modules")
    if cuda:
        from mobi_tpu_torch.ops import _build

        _build.library()  # loads the kernel library, built on a checkout's first run
        run.mark("kernel_library")
        torch.cuda.reset_peak_memory_stats(dev)

    state = gen.prepare(run)
    build_s, setup_peak = None, 0
    if cuda:
        from mobi_tpu_torch.ops import _build

        build_s = dict(_build.compile_seconds)
        _build.reset_launches()
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    tracer = None
    if run.trace:
        from port_bench.trace import Tracer

        tracer = Tracer(harness.kernel_classes(bench_dir), dev)
        with tracer.window():
            result = gen.window(run, state, tracer)
    else:
        result = gen.window(run, state)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    harness.log(line="window", cell=cell.name, seed=run.seed, seconds=run.seconds, trace=run.trace,
                units=result["units"], elapsed_s=result["elapsed_s"], setup_s=run.setup_s,
                setup_phases_s=run.phases, kernel_build_s=build_s, end_to_end=result["end_to_end"],
                launches=_launches() if cuda else None)

    metrics = {}
    if run.trace:
        summary = tracer.summary
        work = gen.work(run, state, summary.units)
        ctx = {"trace": summary, "work": work, "peaks": harness.peaks(bench_dir), "peak_bytes": peak,
               "window_s": summary.window_s}
        harness.log(line="trace", window_s=summary.window_s, busy_s=summary.busy_s, units=summary.units,
                    traced_rate=result["end_to_end"], device_s_by_class=summary.device_s_by_class)
        for m in cell.per_layer:
            value = harness.metric_reader(cell, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(result["end_to_end"], setup_s=run.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    checks = gen.check(run, state)
    correct = all(c.ok for c in checks) and result["failed"] == 0
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"port_bench: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": cell.chips, "memory_peak_bytes": max(peak, setup_peak)}
    out = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
           "metrics": metrics, "device": device_info}
    if run.trace:
        from port_bench.trace import breakdown

        device_info.update(busy_s=tracer.summary.busy_s, window_s=tracer.summary.window_s)
        out["breakdown"] = breakdown(tracer.summary)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _launches():
    from mobi_tpu_torch.ops import _build

    return dict(_build.launches)


if __name__ == "__main__":
    sys.exit(main())
