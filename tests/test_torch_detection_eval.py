"""The port's detection evaluation path (mobi_tpu_torch.data.detection_dataset,
data.det_pipeline, eval.detection, detector_inference, the detection_eval
CLI) against the JAX package's, on the CPU, on a synthetic raw nuScenes
tree (1 scene x 2 samples).

Tolerances: dataset fields exactly, the resized views within 1e-6 (cv2's
float resize is followed to 2 ulp); DetectionEval metrics within 1e-9 of
JAX's on the same results; results.json from one exported checkpoint the
same boxes as JAX's within 1e-4.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu.data import detection_dataset as jds
from mobi_tpu.data.nuscenes_tables import NuScenesTables as JaxTables
from mobi_tpu.data.synthetic import build_synthetic_nuscenes_raw
from mobi_tpu.eval import detection as jev
from mobi_tpu_torch import detection_eval
from mobi_tpu_torch.data import detection_dataset as pds
from mobi_tpu_torch.data.nuscenes_tables import NuScenesTables
from mobi_tpu_torch.eval import detection as pev

torch.set_num_threads(1)

# the JAX CLI test's small grid: z gives the production ladder 41 -> 2
GRID = dict(voxel_size=(0.15, 0.15, 0.1), pc_range=(-9.6, -9.6, -3.0, 9.6, 9.6, 1.0))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("det_eval_raw"))
    build_synthetic_nuscenes_raw(root, num_scenes=1, samples_per_scene=2)
    return root


@pytest.fixture(scope="module")
def edited_root(raw_root, tmp_path_factory):
    """A copy of the tree with an edited lidar cloud and an edited camera
    frame under samples-edited/ and an objects.json naming each sample's
    first object."""
    import shutil

    root = shutil.copytree(raw_root, str(tmp_path_factory.mktemp("det_eval_edited") / "raw"))
    tables = JaxTables(root)
    rec = tables.sample_record(next(tables.samples_of_split()))
    edited = os.path.join(root, "samples-edited")
    os.makedirs(edited)
    stem = os.path.basename(rec["lidar_path"]).split(".")[0]
    pts = np.fromfile(rec["lidar_path"], np.float32).reshape(-1, 5)
    np.save(os.path.join(edited, stem + ".npy"), pts[::2] + np.float32(0.25))
    from PIL import Image

    cam = os.path.basename(rec["image_paths"][0]).split(".")[0]
    Image.fromarray(np.full((225, 400, 3), 200, np.uint8)).save(os.path.join(edited, cam + ".png"))
    gt, _ = jev.load_gt_from_tables(tables)
    with open(os.path.join(edited, "objects.json"), "w") as f:
        json.dump({t: [bl[0].tracking_id] for t, bl in gt.items() if bl}, f)
    return root


def _same_item(a, b, image_atol=0.0):
    assert sorted(a) == sorted(b)
    for k in a:
        if k == "images":
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype == np.float32
            assert np.abs(a[k] - b[k]).max() <= image_atol, k
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("kw", [dict(sweeps_num=0, max_points=512), dict(sweeps_num=2),
                                dict(sweeps_num=2, image_size=(128, 352))],
                         ids=["keyframe_fixed", "sweeps", "sweeps_resized"])
def test_dataset_equal_jax(raw_root, kw):
    got, want = pds.DetectionSceneDataset(raw_root, **kw), jds.DetectionSceneDataset(raw_root, **kw)
    assert len(got) == len(want) == 2
    for i in range(2):
        # the JAX resize is cv2's float INTER_LINEAR, the port's follows it to 2 ulp
        _same_item(got[i], want[i], image_atol=1e-6 if "image_size" in kw else 0.0)


def test_dataset_edited_swap_equal_jax(edited_root):
    kw = dict(edited_samples_path="samples-edited", sweeps_num=2, image_size=(128, 352))
    got, want = pds.DetectionSceneDataset(edited_root, **kw), jds.DetectionSceneDataset(edited_root, **kw)
    a, b = got[0], want[0]
    _same_item(a, b, image_atol=1e-6)
    plain = pds.DetectionSceneDataset(edited_root, sweeps_num=2, image_size=(128, 352))[0]
    assert not np.array_equal(a["points"], plain["points"])
    assert not np.array_equal(a["images"][0], plain["images"][0])
    assert np.array_equal(a["images"][1], plain["images"][1])


def test_image_resize_folds_into_projection(raw_root):
    """With image_size set, a lidar point's pixel under the folded
    lidar2image equals the view's affine applied to its pixel before, and
    K' = A K."""
    plain = pds.DetectionSceneDataset(raw_root, sweeps_num=0)[0]
    sized = pds.DetectionSceneDataset(raw_root, sweeps_num=0, image_size=(256, 704))[0]
    assert sized["images"].shape == (6, 256, 704, 3)
    p = np.array([5.0, 1.0, 0.0, 1.0])
    seen = 0
    for v in range(6):
        uvd = plain["lidar2image"][v] @ p
        if uvd[2] < 0.5:
            continue
        seen += 1
        aug = sized["img_aug_matrix"][v]
        expect = aug[:2, :2] @ (uvd[:2] / uvd[2]) + aug[:2, 3]
        uvd2 = sized["lidar2image"][v] @ p
        np.testing.assert_allclose(uvd2[:2] / uvd2[2], expect, atol=1e-3)
        A = np.eye(3)
        A[:2, :2], A[:2, 2] = aug[:2, :2], aug[:2, 3]
        np.testing.assert_allclose(sized["camera_intrinsics"][v][:3, :3], A @ plain["camera_intrinsics"][v][:3, :3],
                                   atol=1e-3)
    assert seen


def _write_results(gt, path, jitter, seed):
    rng = np.random.default_rng(seed)
    results = {}
    for token, boxes in gt.items():
        dets = []
        for b in boxes:
            for extra in range(2):  # a near hit and a looser duplicate
                t = np.asarray(b.translation) + rng.normal(0, jitter * (1 + 3 * extra), 3)
                dets.append({"sample_token": token, "translation": [float(v) for v in t], "size": list(b.size),
                             "rotation": [float(np.cos(b.yaw / 2)), 0.0, 0.0, float(np.sin(b.yaw / 2))],
                             "velocity": [float(v) for v in rng.normal(0, 0.3, 2)],
                             "detection_name": b.detection_name if extra == 0 else "pedestrian",
                             "detection_score": float(rng.uniform(0.1, 1.0)),
                             "attribute_name": b.attribute_name})
        results[token] = dets
    with open(path, "w") as f:
        json.dump({"meta": {}, "results": results}, f)


def _close(a, b, path="metrics"):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    else:
        a, b = float(a), float(b)
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-9, (path, a, b)


@pytest.mark.parametrize("restrict", [False, True], ids=["all", "edited_objects"])
def test_detection_eval_metrics_equal_jax(edited_root, tmp_path, restrict):
    gt_p, ego_p = pev.load_gt_from_tables(NuScenesTables(edited_root))
    gt_j, ego_j = jev.load_gt_from_tables(JaxTables(edited_root))
    assert ego_p == ego_j and list(gt_p) == list(gt_j)
    assert [[vars(b) for b in v] for v in gt_p.values()] == [[vars(b) for b in v] for v in gt_j.values()]
    path = str(tmp_path / "results.json")
    _write_results(gt_j, path, jitter=0.3, seed=1)
    kw = dict(edited_samples_path=os.path.join(edited_root, "samples-edited"), edited_objects_restrict=True) \
        if restrict else {}
    got = pev.DetectionEval(gt_p, pev.load_prediction(path), pev.DetectionConfig(), ego_positions=ego_p, **kw).evaluate()
    want = jev.DetectionEval(gt_j, jev.load_prediction(path), jev.DetectionConfig(), ego_positions=ego_j,
                             **kw).evaluate()
    _close(got, want)
    if not restrict:
        assert 0 < got["mean_ap"] < 1
        for th in (0.5, 1.0, 2.0, 4.0):  # the pieces: accumulate, calc_ap, calc_tp
            md_p = pev.accumulate(gt_p, pev.load_prediction(path), "car", th)
            md_j = jev.accumulate(gt_j, jev.load_prediction(path), "car", th)
            for f in ("recall", "precision", "confidence", "trans_err", "vel_err", "scale_err", "orient_err",
                      "attr_err"):
                assert np.allclose(getattr(md_p, f), getattr(md_j, f), rtol=0, atol=1e-9, equal_nan=True), f
            assert abs(pev.calc_ap(md_p, 0.1, 0.1) - jev.calc_ap(md_j, 0.1, 0.1)) <= 1e-9
            assert abs(pev.calc_tp(md_p, 0.1, "trans_err") - jev.calc_tp(md_j, 0.1, "trans_err")) <= 1e-9


def _fill(tree, rng, key=""):
    if hasattr(tree, "items"):
        return {k: _fill(v, rng, k) for k, v in tree.items()}
    std = float(np.prod(tree.shape[:-1])) ** -0.5 if key == "kernel" and len(tree.shape) > 1 else 0.05
    a = rng.normal(0, std, tree.shape).astype(np.float32)
    return np.abs(a) + 0.5 if key.endswith("_var") else (a + 1.0 if key.endswith("scale") else a)


@pytest.fixture(scope="module")
def jax_run(raw_root, tmp_path_factory):
    """One lidar-only checkpoint exported by the JAX package, and JAX's
    run_detector over it."""
    from mobi_tpu.detector_inference import run_detector
    from mobi_tpu.export_bevfusion import save_reference_checkpoint
    from mobi_tpu.models.bevfusion import BEVFusionDetector, prepare_lidar_inputs

    out = tmp_path_factory.mktemp("det_eval_run")
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform(-9.0, 9.0, (1500, 2)), rng.uniform(-2.5, 0.5, (1500, 1)),
                          rng.uniform(0, 1, (1500, 2))], axis=1).astype(np.float32)
    det = BEVFusionDetector(use_camera=False)
    args = prepare_lidar_inputs(pts, **GRID)
    shapes = jax.eval_shape(lambda r: det.init(r, *args), jax.random.PRNGKey(0))["params"]
    ckpt = save_reference_checkpoint(_fill(shapes, rng), str(out / "det.pth"), use_camera=False)
    results = str(out / "results_jax.json")
    run_detector(raw_root, ckpt, results, sweeps_num=1, max_samples=2, score_threshold=0.0, **GRID)
    return ckpt, results


def _boxes_equal(got, want):
    assert sorted(got) == sorted(want) and len(got) == 2
    for token in want:
        a, b = got[token], want[token]
        assert len(a) == len(b) > 0, token
        for d in a:
            num = np.concatenate([d["translation"], d["size"], d["rotation"], d["velocity"], [d["detection_score"]]])
            match = [np.abs(num - np.concatenate([e["translation"], e["size"], e["rotation"], e["velocity"],
                                                  [e["detection_score"]]])).max() / (1 + np.abs(num).max())
                     for e in b]
            j = int(np.argmin(match))
            assert match[j] < 1e-4, (token, match[j])
            assert (b[j]["detection_name"], b[j]["attribute_name"], b[j]["sample_token"]) == (
                d["detection_name"], d["attribute_name"], d["sample_token"])


def test_run_detector_results_equal_jax(raw_root, jax_run, tmp_path):
    from mobi_tpu_torch.detector_inference import run_detector

    ckpt, want_path = jax_run
    path = str(tmp_path / "results.json")
    timings = []
    run_detector(raw_root, ckpt, path, sweeps_num=1, max_samples=2, score_threshold=0.0, device="cpu",
                 timings=timings, **GRID)
    with open(path) as f, open(want_path) as g:
        got, want = json.load(f), json.load(g)
    assert got["meta"] == want["meta"]
    _boxes_equal(got["results"], want["results"])
    assert len(timings) == 2 and all(t["voxels"] > 0 and t["forward_s"] > 0 for t in timings)


@pytest.mark.parametrize("restrict", [False, True], ids=["all", "edited_objects"])
def test_detection_eval_cli_end_to_end(raw_root, edited_root, jax_run, tmp_path, monkeypatch, restrict):
    """The CLI's inference stage on the exported checkpoint (lidar-only,
    default score threshold, run_detector's grid set to the small one) and
    its evaluation, against JAX's CLI on the same results, with and
    without --edited-objects-restrict."""
    import functools

    from mobi_tpu_torch import detector_inference

    monkeypatch.setattr(detector_inference, "run_detector", functools.partial(detector_inference.run_detector, **GRID))
    ckpt, _ = jax_run
    root = edited_root if restrict else raw_root
    results = str(tmp_path / "results.json")
    argv = ["--dataroot", root, "--results", results, "--out-dir", str(tmp_path / "out"),
            "--checkpoint", ckpt, "--sweeps-num", "1", "--max-samples", "2", "--device", "cpu"]
    if restrict:
        argv += ["--edited-samples-path", "samples-edited", "--edited-objects-restrict"]
    got = detection_eval.main(argv)
    with open(tmp_path / "out" / "metrics_summary.json") as f:
        written = json.load(f)
    assert written["nd_score"] == got["nd_score"] and os.path.exists(results)
    with open(results) as f:
        assert len(json.load(f)["results"]) == 2

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import detection_eval as jax_cli

    jargv = argv[:argv.index("--checkpoint")] + argv[argv.index("--max-samples"):argv.index("--device")]
    jargv += argv[argv.index("--device") + 2:]
    jargv[jargv.index("--out-dir") + 1] = str(tmp_path / "out_jax")
    want = jax_cli.main(jargv)
    _close(got, want)
    if restrict:
        assert got["mean_ap"] == 0.0
