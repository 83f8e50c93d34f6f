"""The port's detector training CLI (python -m mobi_tpu_torch.train_detector,
in process through `main` with a small grid: voxels 0.8 x 0.8 x 0.2 over
+-25.6 m, 16 proposals, views 64 x 176) on the CPU, on a synthetic raw
nuScenes tree with a GT database built by the port: lidar with GT paste for
10 steps (one metrics.jsonl line), lidar at --batch-size 2 and camera +
lidar with --image-aug and --grid-mask 0.5 for 2 steps. Gated: finite
metrics every step, num_pos > 0 on some step, the JAX CLI's metrics.jsonl
schema, checkpoints at the --save-every steps and the last, each loaded
strict by detection_eval's loader (`detector_inference.build_detector`).
"""
import json
import os

import numpy as np
import pytest
import torch

from mobi_tpu_torch import train_detector
from mobi_tpu_torch.data import det_pipeline as PP
from mobi_tpu_torch.data.detection_dataset import DetectionSceneDataset
from mobi_tpu_torch.data.synthetic import build_synthetic_nuscenes_raw

torch.set_num_threads(1)

SMALL = dict(voxel_size=(0.8, 0.8, 0.2), pc_range=(-25.6, -25.6, -5.0, 25.6, 25.6, 3.2), num_proposals=16,
             image_size=(64, 176), lss_kwargs=dict(image_size=(64, 176), feature_size=(8, 22),
                                                   xbound=(-25.6, 25.6, 3.2), ybound=(-25.6, 25.6, 3.2)))


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("det_cli_raw"))
    build_synthetic_nuscenes_raw(root, num_scenes=1, samples_per_scene=2)
    db = PP.build_gt_database(DetectionSceneDataset(root, load_images=False), os.path.join(root, "gt_db"),
                              train_detector.NUSC_CLASSES)
    return root, db


def run_cli(raw_tree, logdir, extra, db=None):
    argv = ["--dataroot", raw_tree, "--logdir", str(logdir), "--max-steps", "10", "--device", "cpu",
            "--sweeps", "1", "--max-gt", "16", "--save-every", "5"] + extra
    if db:
        argv += ["--gt-db", db]
    timings = []
    history = train_detector.main(argv, timings=timings, overrides=SMALL)
    return history, timings


@pytest.mark.parametrize("case", ["lidar", "lidar_batch2", "camera"])
def test_cli_trains_and_writes_strict_checkpoints(raw_tree, tmp_path, case):
    from mobi_tpu_torch.detector_inference import build_detector, load_checkpoint_state_dict

    extra = {"lidar": ["--max-steps", "10"], "lidar_batch2": ["--max-steps", "2", "--batch-size", "2"],
             "camera": ["--max-steps", "2", "--camera", "--image-aug", "--grid-mask", "0.5"]}[case]
    root, db = raw_tree
    history, timings = run_cli(root, tmp_path, extra, db if case != "camera" else None)
    steps = len(history)
    assert [h["step"] for h in history] == list(range(1, steps + 1)) and len(timings) == steps
    keys = {"loss", "loss_cls", "loss_bbox", "loss_heatmap", "num_pos", "matched_iou", "grad_norm"}
    assert all(set(h) == keys | {"step"} and all(np.isfinite(h[k]) for k in keys) for h in history)
    assert max(h["num_pos"] for h in history) > 0
    ckpts = sorted(p for p in os.listdir(tmp_path) if p.endswith(".pth"))
    assert ckpts == sorted({f"ckpt_{s}.pth" for s in range(5, steps + 1, 5)} | {f"ckpt_{steps}.pth"})
    if steps >= 10:
        with open(tmp_path / "metrics.jsonl") as f:
            line = json.loads(f.readline())
        assert set(line) == keys | {"step", "wall_s"} and line["step"] == 10
        assert line["loss"] == pytest.approx(history[9]["loss"])
    use_camera = case == "camera"
    sd = load_checkpoint_state_dict(str(tmp_path / f"ckpt_{steps}.pth"))
    model = build_detector(sd, use_camera, SMALL["voxel_size"], SMALL["pc_range"], SMALL["image_size"], device="cpu")
    assert sum(v.numel() for v in sd.values() if v.is_floating_point()) == sum(
        p.numel() for p in model.parameters())
