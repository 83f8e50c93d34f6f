"""A copy of the benchmark folder with tiny cells, for the CPU tests: the
flagship's and the camera-only model's layers at a few channels, a
one-layer CLIP, 64 x 64 frames, 3 DDIM steps and 2-pair batches."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from port_bench import harness

TINY_MODEL = {
    "latent_size": 8, "image_height": 64, "image_width": 64, "range_height": 64, "range_width": 64,
    "unet_channels": 32, "unet_channel_mult": [1, 2], "unet_num_heads": 2, "unet_attention_resolutions": [1, 2],
    "context_dim": 32, "vae_ch": 32, "vae_ch_mult": [1, 2, 2, 2], "clip_width": 64, "ref_image_size": 28,
    "clip_patch_size": 14, "clip_layers": 1, "clip_heads": 2, "mapper_layers": 1, "bbox_proj_dims": [32, 32, 32, 32],
}
CELLS = {
    "tiny_bulk": ("tiny_mobi", "tiny_bulk_b2"),
    "tiny_camera": ("tiny_camera", "tiny_bulk_b2"),
    "tiny_train": ("tiny_mobi", "tiny_train_b2"),
}
LIMITS = {  # float32 on the CPU on both sides: agreement to rounding
    "tiny_bulk": {"camera_rel_l2": 1e-4, "lidar_rel_l2": 1e-4},
    "tiny_camera": {"camera_rel_l2": 1e-4},
    "tiny_train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3},
}


def make(root: Path) -> Path:
    """root/port_bench (a copy of the real folder plus the tiny files) and
    root/BENCHMARK.json naming the tiny cells; returns the folder."""
    bench = root / "port_bench"
    shutil.copytree(harness.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((harness.BENCH_DIR.parent / "BENCHMARK.json").read_text())
    flag = json.loads((bench / "configs" / "mobi_nusc_512.json").read_text())
    cam = json.loads((bench / "configs" / "pbe_camera_256.json").read_text())
    for name, base in (("tiny_mobi", flag), ("tiny_camera", cam)):
        cfg = copy.deepcopy(base)
        cfg["model"].update(TINY_MODEL)
        cfg["dtype"] = "float32"
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny_bulk_b2.json").write_text(json.dumps(
        {"generator": "bulk_inference", "pairs": 2, "num_steps": 3, "guidance_scale": 5.0,
         "check_pairs": 2, "trace_units": 1}))
    (bench / "traffic" / "tiny_train_b2.json").write_text(json.dumps(
        {"generator": "train_steps", "pairs": 2, "pool_batches": 2, "base_lr": 8e-2, "warm_up_steps": 2,
         "u_cond_percent": 0.2, "check_steps": 3, "trace_units": 2}))
    for cell, limits in LIMITS.items():
        (bench / "limits" / f"{cell}.json").write_text(json.dumps({"limits": limits}))
    spec["configs"] += [{"name": n, "source": "test", "file": f"port_bench/configs/{n}.json", "reduced": [],
                         "why": "tiny"} for n in ("tiny_mobi", "tiny_camera")]
    spec["workloads"] += [{"name": c, "config": cfg, "traffic": mix, "chips": 1, "why": "tiny"}
                          for c, (cfg, mix) in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            kind = "train" if any("train" in w for w in m["workloads"]) else "bulk"
            m["workloads"] += [c for c in CELLS if (c == "tiny_train") == (kind == "train")]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench
