"""The reference's whole product loop on a synthetic raw nuScenes tree, run
as one chain (mobi_tpu's scripts/tpu_lifecycle_drive.py):

  raw tree -> preprocessing (PBE database + infos) -> the inference test
  bench's inpainting (edited sample files + objects.json) ->
  checkpoint-driven BEVFusion detection eval over the edited scenes,
  restricted to the edited objects.

    MOBI_LIFECYCLE_DIR=build/lifecycle MOBI_LIFECYCLE_CKPT=<checkpoint> \\
        python -m mobi_tpu_torch.lifecycle_drive [--device cpu]

The five phases, each in a process of its own (this module with `--phase
NAME`), each skipped when its output is already there, as in the JAX drive:

  raw         `build_synthetic_nuscenes_raw`, 2 scenes x 3 samples
  preprocess  `python -m mobi_tpu_torch.data.preprocess --split val
              --num-erase 4 --write-infos`
  inpaint     `python -m mobi_tpu_torch.inference_test_bench` on
              configs/mobi_nusc_512.yaml with MOBI_LIFECYCLE_CKPT, DDIM-50 at
              scale 5, 4 objects a batch, 2 batches, seed 321, the JAX drive's
              dataset overrides, objects.json inside `samples_seed321/`
  det_ckpt    a lidar-only detector checkpoint with the JAX drive's draws
              (`eval.fabricate.det_drive_state_dict`, seed 7)
  detect      `python -m mobi_tpu_torch.detection_eval --edited-samples-path
              <samples_seed321> --edited-objects-restrict --sweeps-num 2`

MOBI_LIFECYCLE_DIR defaults to build/lifecycle beside the package. A
MOBI_LIFECYCLE_CKPT is what the bench's --ckpt takes (a reference .ckpt, a
torch file or a checkpoint directory of the port's training CLI); unset, the
bench samples with its seeded random weights. `--device` (default cuda)
is handed to the bench and the eval.

Each phase writes `<dir>/phases/<name>.json` (its seconds, the kernel
launches it made, what it checked); the drive then checks that the eval's
dataset reads edited files (at least one lidar cloud and one camera frame
from `samples_seed321/`, the keyframe points equal to the edited cloud) and
that the metrics are finite, writes `<dir>/lifecycle.json` and prints it as
its last line. A failed phase or check exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Sequence

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("raw", "preprocess", "inpaint", "det_ckpt", "detect")
SEED = 321          # the bench's --seed
DET_SEED = 7        # the JAX detection drive's numpy seed
BENCH_OVERRIDES = ("ref_mode=track-ref", "data.params.test.params.num_samples_per_class=4",
                   "data.params.test.params.min_lidar_points=1",
                   "data.params.test.params.reference_image_min_h=1",
                   "data.params.test.params.reference_image_min_w=1",
                   "data.params.test.params.camera_visibility_min=0.0")


def paths(work: str) -> Dict[str, str]:
    """Every file and directory of a drive under `work`."""
    itb = os.path.join(work, "itb")
    edited = os.path.join(itb, f"samples_seed{SEED}")
    db = os.path.join(work, "db")
    return {"work": work, "raw": os.path.join(work, "raw"), "db": db, "itb": itb, "edited": edited,
            # objects.json lives inside the edited-samples directory: the
            # eval reads <edited_samples_path>/objects.json
            "objects_json": os.path.join(edited, "objects.json"),
            "csv": os.path.join(db, "nuscenes_dbinfos_pbe_val.csv"),
            "pkl": os.path.join(db, "nuscenes_scene_infos_pbe_val.pkl"),
            "det_ckpt": os.path.join(work, "det_fabricated.pth"),
            "results": os.path.join(work, "results_edited.json"), "out": os.path.join(work, "out"),
            "phases": os.path.join(work, "phases")}


def done(name: str, p: Dict[str, str]) -> bool:
    """Whether phase `name`'s output is already there (the JAX drive's
    skip rules; the eval always runs)."""
    return {"raw": os.path.exists(os.path.join(p["raw"], "v1.0-mini")),
            "preprocess": os.path.exists(p["csv"]),
            "inpaint": os.path.exists(p["objects_json"]),
            "det_ckpt": os.path.exists(p["det_ckpt"]),
            "detect": False}[name]


def phase_raw(p: Dict[str, str]) -> Dict:
    from mobi_tpu_torch.data.synthetic import build_synthetic_nuscenes_raw

    build_synthetic_nuscenes_raw(p["raw"], num_scenes=2, samples_per_scene=3)
    return {"num_scenes": 2, "samples_per_scene": 3}


def phase_preprocess(p: Dict[str, str]) -> Dict:
    from mobi_tpu_torch.data import preprocess

    out = preprocess.main(["--dataroot", p["raw"], "--out-dir", p["db"], "--split", "val",
                           "--num-erase", "4", "--write-infos"])
    if not (os.path.exists(p["csv"]) and os.path.exists(p["pkl"])):
        raise RuntimeError(f"preprocess wrote no {p['csv']} or {p['pkl']}")
    with open(p["csv"]) as f:
        return {"objects": sum(1 for _ in f) - 1, "files": sorted(out)}


def phase_inpaint(p: Dict[str, str], ckpt: str, device: str, steps: int = 50, batches: int = 2,
                  n_samples: int = 4, overrides: Sequence[str] = (), model=None) -> Dict:
    """The bench with the JAX drive's flags; `overrides` go after the
    drive's own, `model` replaces the config's (the tests' tiny one)."""
    from mobi_tpu_torch import inference_test_bench

    argv = ["--config", str(ROOT / "configs" / "mobi_nusc_512.yaml"), "--outdir", p["itb"], "--ddim_steps", str(steps), "--scale", "5",
            "--n_samples", str(n_samples), "--n_workers", "1", "--seed", str(SEED), "--save_samples",
            "--max_batches", str(batches), "--device", device]
    argv += ["--ckpt", ckpt] if ckpt else []
    argv += list(BENCH_OVERRIDES) + [f"data.params.test.params.object_database_path={p['csv']}",
                                     f"data.params.test.params.scene_database_path={p['pkl']}",
                                     f"data.params.test.params.object_meta_dump_path={p['objects_json']}"]
    stats = inference_test_bench.main(argv + list(overrides), model=model)
    if not os.path.exists(p["objects_json"]):
        raise RuntimeError(f"the bench wrote no {p['objects_json']}")
    files = sorted(os.listdir(p["edited"]))
    return {"objects": stats["objects"], "batches": len(stats["batches"]), "steps": steps,
            "device_s": [b["device_s"] for b in stats["batches"]], "wall_s": stats["wall_s"],
            "edited_files": len(files), "ckpt": ckpt or None}


def phase_det_ckpt(p: Dict[str, str]) -> Dict:
    from mobi_tpu_torch import convert
    from mobi_tpu_torch.eval.fabricate import det_drive_state_dict
    from mobi_tpu_torch.models.bevfusion import BEVFusionDetector

    sd = det_drive_state_dict(BEVFusionDetector(use_camera=False, device="cpu"), DET_SEED)
    convert.save_reference_checkpoint(sd, p["det_ckpt"])
    return {"seed": DET_SEED, "float_entries": sum(v.numel() for v in sd.values() if v.is_floating_point())}


def edited_in_eval(p: Dict[str, str]) -> Dict:
    """The eval's dataset (the detection CLI's arguments): the sensor files
    that come from the edited samples, and each edited keyframe cloud
    against the points the detector is handed."""
    import numpy as np

    from mobi_tpu_torch.data.detection_dataset import DetectionSceneDataset
    from mobi_tpu_torch.data.nuscenes_tables import load_lidar_points

    ds = DetectionSceneDataset(p["raw"], edited_samples_path=p["edited"], load_images=False,
                               sweeps_num=2)
    root = os.path.abspath(p["edited"])
    lidar, camera, clouds_equal = [], [], 0
    for i, sample in enumerate(ds.tables.samples_of_split()):
        rec = ds.tables.sample_record(sample)
        camera += [x for x in rec["image_paths"] if os.path.abspath(x).startswith(root)]
        if os.path.abspath(rec["lidar_path"]).startswith(root):
            lidar.append(rec["lidar_path"])
            key = load_lidar_points(rec["lidar_path"]).astype(np.float32)
            clouds_equal += bool(np.array_equal(ds[i]["points"][:len(key), :4], key))
    return {"samples": len(ds), "lidar": len(lidar), "camera": len(camera), "clouds_equal": clouds_equal,
            "lidar_files": sorted(os.path.basename(x) for x in lidar)[:4],
            "camera_files": sorted(os.path.basename(x) for x in camera)[:4]}


def phase_detect(p: Dict[str, str], device: str) -> Dict:
    from mobi_tpu_torch import detection_eval

    timings: list = []
    metrics = detection_eval.main(
        ["--dataroot", p["raw"], "--results", p["results"], "--out-dir", p["out"], "--checkpoint", p["det_ckpt"],
         "--sweeps-num", "2", "--edited-samples-path", p["edited"], "--edited-objects-restrict",
         "--verbose-inference", "--device", device], timings=timings)
    with open(p["results"]) as f:
        results = json.load(f)["results"]
    return {"edited_in_eval": edited_in_eval(p), "mean_ap": metrics["mean_ap"], "nd_score": metrics["nd_score"],
            "tp_errors": metrics["tp_errors"], "results_samples": len(results),
            "boxes": sum(len(v) for v in results.values()), "timings": timings}


def run_phase(name: str, p: Dict[str, str], ckpt: str, device: str) -> Dict:
    """Phase `name` in this process: its record, written to
    `<dir>/phases/<name>.json`."""
    from mobi_tpu_torch.ops import _build

    _build.reset_launches()
    t0 = time.perf_counter()
    if name == "raw":
        rec = phase_raw(p)
    elif name == "preprocess":
        rec = phase_preprocess(p)
    elif name == "inpaint":
        rec = phase_inpaint(p, ckpt, device)
    elif name == "det_ckpt":
        rec = phase_det_ckpt(p)
    else:
        rec = phase_detect(p, device)
    rec.update(phase=name, seconds=time.perf_counter() - t0,
               launches={k: v for k, v in _build.launches.items() if v})
    os.makedirs(p["phases"], exist_ok=True)
    with open(os.path.join(p["phases"], f"{name}.json"), "w") as f:
        json.dump(rec, f, default=float)
    return rec


def check(records: Dict[str, Dict]) -> None:
    """The drive's gates over the phase records: edited files in the eval's
    dataset (a lidar cloud, its points handed on unchanged, and a camera
    frame), every sample in results.json, finite metrics."""
    det = records["detect"]
    seen = det["edited_in_eval"]
    if not (seen["lidar"] >= 1 and seen["camera"] >= 1 and seen["clouds_equal"] == seen["lidar"]):
        raise RuntimeError(f"the eval's dataset does not read the edited files: {seen}")
    if det["results_samples"] != seen["samples"]:
        raise RuntimeError(f"results.json holds {det['results_samples']} of {seen['samples']} samples")
    values = [det["mean_ap"], det["nd_score"], *det["tp_errors"].values()]
    if not all(math.isfinite(float(v)) for v in values):
        raise RuntimeError(f"non-finite metrics: mAP {det['mean_ap']}, NDS {det['nd_score']}, {det['tp_errors']}")


def _read(path: str) -> Dict:
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def log(t0: float, msg: str) -> None:
    print(f"# {time.time() - t0:7.1f}s {msg}", flush=True)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="the bench's and the eval's device (cpu: the plain path)")
    ap.add_argument("--phase", choices=PHASES, default=None, help="run this one phase in this process")
    args = ap.parse_args(argv)
    p = paths(os.environ.get("MOBI_LIFECYCLE_DIR", str(ROOT / "build" / "lifecycle")))
    ckpt = os.environ.get("MOBI_LIFECYCLE_CKPT", "")
    if args.phase:
        return run_phase(args.phase, p, ckpt, args.device)

    t0 = time.time()
    os.makedirs(p["work"], exist_ok=True)
    records: Dict[str, Dict] = {}
    for name in PHASES:
        path = os.path.join(p["phases"], f"{name}.json")
        if done(name, p):
            log(t0, f"[{name}] already done, skipping")
            records[name] = {**_read(path), "skipped": True, "rc": 0, "wall_s": 0.0}
            continue
        cmd = [sys.executable, "-m", "mobi_tpu_torch.lifecycle_drive", "--phase", name, "--device", args.device]
        log(t0, f"[{name}] {' '.join(cmd)}")
        t = time.time()
        rc = subprocess.run(cmd, cwd=ROOT).returncode
        if rc != 0:
            raise SystemExit(f"lifecycle phase {name} failed rc={rc}")
        records[name] = {**_read(path), "skipped": False, "rc": rc, "wall_s": time.time() - t}
        log(t0, f"[{name}] done in {records[name]['wall_s']:.1f}s")
    check(records)
    summary = {"lifecycle": "complete", "dir": p["work"], "device": args.device, "phases": records}
    with open(os.path.join(p["work"], "lifecycle.json"), "w") as f:
        json.dump(summary, f, default=float)
    log(t0, "LIFECYCLE COMPLETE")
    print(json.dumps(summary, default=float), flush=True)
    return summary


if __name__ == "__main__":
    main()
