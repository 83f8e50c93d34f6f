"""The lifecycle drive of the port (mobi_tpu_torch/lifecycle_drive.py) on the
CPU: its five phase functions in order, at the tiny config of
tests/test_diffusion.py (a seeded tiny model saved as the checkpoint the
bench loads, DDIM-3, 1 batch of 2 objects at 32 x 32) and the detection
CLI's small grid of tests/test_torch_detection_eval.py; then the drive's
checks. Also the JAX drive's detector draws that chip_smoke and the drive
share (`eval.fabricate.det_drive_state_dict`), bitwise.
"""
import functools
import hashlib
import json
import math
import os

import numpy as np
import pytest
import torch

from mobi_tpu_torch import detector_inference
from mobi_tpu_torch import lifecycle_drive as drive
from mobi_tpu_torch.eval.fabricate import det_drive_state_dict
from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.models.bevfusion import BEVFusionDetector
from mobi_tpu_torch.ops import _build
from tests.test_diffusion import TINY
from tests.test_torch_detection_eval import GRID
from mobi_tpu_torch.models.encoders import CondStageModel
from tests.test_torch_models import few_torch_threads, port_config  # noqa: F401

# The bench's tiny overrides (tests/test_torch_test_bench.py): 32 x 32
# images, 32-row range views twice as wide (the lidar metrics' window).
TINY_OVERRIDES = [f"data.params.test.params.{k}={v}" for k, v in
                  dict(image_height=32, image_width=32, range_height=32, range_width=64).items()]


def tiny_model(seed):
    """The tiny config with a two-layer CLIP of width 96 that takes the
    dataset's 224 x 224 reference crops (patch 32)."""
    cond = CondStageModel(clip_width=96, clip_image_size=224, clip_patch_size=32, clip_layers=2, clip_heads=4,
                          mapper_layers=2, bbox_proj_dims=(64, 48, 48, 64))
    return tdiff.MobiDiffusion(port_config(TINY), device="cpu", cond_stage_model=cond, seed=seed)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The five phases on the CPU; returns (paths, phase records)."""
    p = drive.paths(str(tmp_path_factory.mktemp("lifecycle")))
    records = {}
    records["raw"] = drive.phase_raw(p)
    records["preprocess"] = drive.phase_preprocess(p)
    model = tiny_model(3)
    ckpt = os.path.join(p["work"], "tiny.pt")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    fresh = tiny_model(4)
    _build.reset_launches()
    records["inpaint"] = drive.phase_inpaint(p, ckpt, "cpu", steps=3, batches=1, n_samples=2,
                                             overrides=TINY_OVERRIDES, model=fresh)
    loaded = {k: v.equal(model.state_dict()[k]) for k, v in fresh.state_dict().items()}
    records["det_ckpt"] = drive.phase_det_ckpt(p)
    mp = pytest.MonkeyPatch()
    mp.setattr(detector_inference, "run_detector", functools.partial(detector_inference.run_detector, **GRID))
    try:
        records["detect"] = drive.phase_detect(p, "cpu")
    finally:
        mp.undo()
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"
    return p, records, all(loaded.values())


def test_every_phase_writes_its_outputs(chain):
    p, rec, loaded = chain
    assert os.path.isdir(os.path.join(p["raw"], "v1.0-mini"))
    assert rec["preprocess"]["objects"] > 0 and os.path.exists(p["csv"]) and os.path.exists(p["pkl"])
    assert loaded, "the bench did not load the checkpoint into its model"
    assert rec["inpaint"]["objects"] == 2 and rec["inpaint"]["batches"] == 1
    assert os.path.exists(p["objects_json"])
    with open(p["objects_json"]) as f:
        assert json.load(f)
    names = os.listdir(p["edited"])
    assert any(n.endswith(".png") for n in names) and any(n.endswith(".npy") for n in names)
    assert rec["det_ckpt"]["float_entries"] == 8_907_086 and os.path.exists(p["det_ckpt"])
    for path in (p["results"], os.path.join(p["out"], "metrics_summary.json")):
        assert os.path.exists(path), path
    assert [n for n in drive.PHASES if not drive.done(n, p)] == ["detect"]  # what a rerun would run


def test_edited_files_are_swapped_into_the_eval(chain):
    """At least one camera frame and one lidar cloud of the eval's dataset
    come from samples_seed321/, and the edited keyframe cloud is the points
    the detector gets."""
    p, rec, _ = chain
    seen = rec["detect"]["edited_in_eval"]
    assert seen["lidar"] >= 1 and seen["camera"] >= 1 and seen["clouds_equal"] == seen["lidar"]
    names = set(os.listdir(p["edited"]))
    assert set(seen["lidar_files"]) | set(seen["camera_files"]) <= names
    assert all(f.endswith(".npy") for f in seen["lidar_files"])
    assert all(f.endswith(".png") for f in seen["camera_files"])


def test_results_and_metrics_are_finite(chain):
    p, rec, _ = chain
    drive.check(rec)
    with open(p["results"]) as f:
        results = json.load(f)["results"]
    assert len(results) == rec["detect"]["edited_in_eval"]["samples"] == 6
    for boxes in results.values():
        for b in boxes:
            assert all(math.isfinite(v) for v in b["translation"] + b["size"] + b["rotation"] + b["velocity"])
    with open(os.path.join(p["out"], "metrics_summary.json")) as f:
        summary = json.load(f)
    assert math.isfinite(summary["mean_ap"]) and math.isfinite(summary["nd_score"])
    assert all(math.isfinite(v) for v in summary["tp_errors"].values())


# sha256 over (key, bytes) in key order of the state dicts chip_smoke's
# detection phase drew at seed 0 before the draws moved into the package
DRIVE_DIGESTS = {False: "b8c5745e2106ff925fc5e235e5d19f70f1ec1ba9cc8732068f52bcc512d74b02",
                 True: "69e96574d65710cc5fc57f11b3f24db3eae722fafc4a95d431fb2fedc46cd536"}


@pytest.mark.parametrize("use_camera", [False, True], ids=["lidar", "camera"])
def test_det_drive_draws_are_chip_smokes(use_camera):
    sd = det_drive_state_dict(BEVFusionDetector(use_camera=use_camera, device="cpu"), 0)
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().cpu().contiguous().numpy().tobytes())
    assert h.hexdigest() == DRIVE_DIGESTS[use_camera]
    var = [v for k, v in sd.items() if k.endswith("running_var")]
    assert var and all(bool((v >= 0.5).all()) for v in var)
    assert np.isclose(float(torch.cat([v.flatten() for k, v in sd.items() if k.endswith("weight")]).std()), 0.05,
                      rtol=0.01)


def test_phase_cli_writes_its_record(tmp_path, monkeypatch):
    """`--phase NAME` (each phase's own process in the drive) runs that phase
    under MOBI_LIFECYCLE_DIR and writes its record; the drive's parent reads
    it back."""
    monkeypatch.setenv("MOBI_LIFECYCLE_DIR", str(tmp_path))
    rec = drive.main(["--phase", "det_ckpt", "--device", "cpu"])
    p = drive.paths(str(tmp_path))
    assert drive.done("det_ckpt", p) and not drive.done("raw", p)
    with open(os.path.join(p["phases"], "det_ckpt.json")) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(rec)) and written["seed"] == drive.DET_SEED
    assert written["phase"] == "det_ckpt" and written["seconds"] > 0 and written["launches"] == {}
