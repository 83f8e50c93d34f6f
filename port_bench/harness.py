"""What every cell of the benchmark shares: finding a cell's configuration,
traffic mix, limits, per-layer readers and kernel classes by name; building
the program's model on seeded weights; the import check; the result line.

Everything that belongs to one configuration, one traffic mix, one cell's
limits, one per-layer metric or one kernel class is a file of its own
under this folder, found by the name `BENCHMARK.json` gives it:

  configs/<config>.json       the configuration as it is run
  traffic/<mix>.json          a mix's parameters and the generator that reads them
  generators/<kind>.py        a generator: set-up, the measured window, the check,
                              and the readings a cell's limits are set from
  limits/<cell>.json          each compared number's limit, and the readings it was set from
  metrics/<metric>.py         a per-layer metric's reader, `read(ctx)` -> number or None
  kernels/<class>/*.json      profiler name patterns of a kernel class (their union)
  work/peaks.json             the card's published peaks
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Sequence, Tuple

BENCH_DIR = Path(__file__).resolve().parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "mobi_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import a file of this folder by its path (its name may hold dots)."""
    name = "port_bench._loaded." + path.relative_to(path.parents[1]).as_posix().replace("/", ".")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    mix: Dict[str, Any]
    chips: int
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path

    @property
    def arch(self) -> Dict[str, Any]:
        return self.config["model"]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of BENCHMARK.json (at the checkout's root, beside
    this folder) with its files."""
    spec = load_json(bench_dir.parent / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, config=load_json(bench_dir.parent / config["file"]),
        mix=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        chips=int(entry["chips"]), limits=load_json(bench_dir / "limits" / f"{name}.json")["limits"],
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        bench_dir=bench_dir)


def generator(cell: Cell) -> ModuleType:
    return load_module(cell.bench_dir / "generators" / f"{cell.mix['generator']}.py")


def metric_reader(cell: Cell, name: str) -> ModuleType:
    return load_module(cell.bench_dir / "metrics" / f"{name}.py")


def kernel_classes(bench_dir: Path = BENCH_DIR) -> List[Tuple[str, List[str]]]:
    """(class, patterns) in priority order: each class is the union of the
    files in its folder, and its priority the least that they give."""
    found = []
    for folder in sorted(p for p in (bench_dir / "kernels").iterdir() if p.is_dir()):
        files = [load_json(f) for f in sorted(folder.glob("*.json"))]
        if files:
            pats = [p for f in files for p in f["patterns"]]
            found.append((min(f["priority"] for f in files), folder.name, pats))
    return [(name, pats) for _, name, pats in sorted(found)]


def peaks(bench_dir: Path = BENCH_DIR) -> Dict[str, float]:
    return load_json(bench_dir / "work" / "peaks.json")


# ------------------------------------------------------------------ model
def mobi_config(cell: Cell):
    import torch

    from mobi_tpu_torch.models.diffusion import MobiConfig

    a = dict(cell.arch)
    fields = {f.name for f in dataclasses.fields(MobiConfig)}
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in a.items() if k in fields}
    kw["dtype"] = getattr(torch, cell.config["dtype"])
    return MobiConfig(**kw)


def cond_stage(cell: Cell):
    from mobi_tpu_torch.models.encoders import CondStageModel

    a, cfg = cell.arch, mobi_config(cell)
    return CondStageModel(conditions=tuple(a["cond_stage_key"]), clip_width=a["clip_width"],
                          clip_image_size=a["ref_image_size"], clip_patch_size=a["clip_patch_size"],
                          clip_layers=a["clip_layers"], clip_heads=a["clip_heads"],
                          mapper_layers=a["mapper_layers"], bbox_proj_dims=tuple(a["bbox_proj_dims"]),
                          dtype=cfg.dtype)


def build_model(run, for_training: bool = False):
    """The program's model on the run's device, holding the benchmark's
    weights for the run's seed. Returns (model, layout)."""
    import torch

    from mobi_tpu_torch.models.diffusion import MobiDiffusion
    from port_bench import weights

    cell, device = run.cell, run.device
    with torch.device(device):
        cs = cond_stage(cell)
    model = MobiDiffusion(mobi_config(cell), device=device, cond_stage_model=cs, for_training=for_training)
    run.mark("model")
    layout = weights.layout_of(model.state_dict())
    model.load_state_dict(weights.generate(layout, run.seed, device), strict=True)
    run.mark("weights")
    return model, layout


# ---------------------------------------------------------------- checks
def forbidden_loaded(modules: Sequence[str] = None) -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of FORBIDDEN_MODULES, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN_MODULES)


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


def check_lines(checks: Sequence[Check]) -> List[str]:
    return [f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}" for c in checks]


def log(**fields) -> None:
    """An earlier line of the run's standard output: one JSON object."""
    print(json.dumps(fields, default=float), flush=True)
