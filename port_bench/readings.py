"""The readings that a cell's limits are set from, many seeds in one
process (set-up is long): for each seed the program's numbers as its check
computes them, and on the control seeds the control's and those of the
faults the cell's generator plants. Each generator's `readings(run,
control)` makes them from its own set-up, loop and comparison.

    python3 -m port_bench.readings --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

One JSON line a seed; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import torch

from port_bench import harness, run as bench_run


def main(argv: Optional[Sequence[str]] = None, device: Optional[str] = None,
         bench_dir=harness.BENCH_DIR) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    bench_run.pin_caches()
    cell = harness.find_cell(args.workload, bench_dir)
    gen = harness.generator(cell)
    dev = torch.device(device or "cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(control - set(seeds)):
        t = time.perf_counter()
        row = gen.readings(bench_run.Run(cell, seed, 0.0, False, dev), seed in control)
        harness.log(line="readings", cell=cell.name, seed=seed, seconds=time.perf_counter() - t, **row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
