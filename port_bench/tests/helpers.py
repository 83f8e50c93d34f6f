"""Running the harness in process and reading its result line."""
from __future__ import annotations

import contextlib
import io
import json

from port_bench import run


def run_cell(bench, cell: str, device: str = "cpu", seed: int = 2147483901, seconds: float = 0.5,
             trace: int = 0):
    """(exit code, result object or None, earlier lines) of one run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                      device=device, bench_dir=bench)
    lines = [json.loads(x) for x in out.getvalue().splitlines() if x.startswith("{")]
    result = lines[-1] if lines and "correct" in lines[-1] else None
    return rc, result, lines[:-1], err.getvalue()
