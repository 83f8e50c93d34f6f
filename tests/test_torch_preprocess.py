"""The port's preprocessing (mobi_tpu_torch.data: nuscenes_tables,
infos_converter, preprocess and its CLI, geometry's collision and frustum
tests, build_synthetic_nuscenes_raw) against the JAX package's, on a
2-scene x 2-sample synthetic raw tree at 400 x 225.

Host modules must equal JAX's exactly: arrays by np.array_equal, pickles
and parsed CSVs field by field. The one exception is camera pixels: the JAX
package writes them as JPEG, the port as PNG under the same `.jpg` names.
"""
import csv
import filecmp
import json
import os
import pickle

import numpy as np
import pytest

from mobi_tpu.data import geometry as jgeo
from mobi_tpu.data import nuscenes_tables as jtab
from mobi_tpu.data.infos_converter import create_nuscenes_infos as jax_infos
from mobi_tpu.data.preprocess import build_pbe_database as jax_pbe
from mobi_tpu.data.preprocess import check_erase_bbox as jax_check_erase
from mobi_tpu.data.preprocess import synthesize_erase_boxes as jax_erase
from mobi_tpu.data.synthetic import build_synthetic_nuscenes_raw as jax_raw
from mobi_tpu_torch.data import geometry as pgeo
from mobi_tpu_torch.data import image_io
from mobi_tpu_torch.data import nuscenes_tables as ptab
from mobi_tpu_torch.data import preprocess as ppre
from mobi_tpu_torch.data.synthetic import build_synthetic_nuscenes_raw as port_raw


def assert_same(a, b, path="root"):
    """Field-by-field equality of nested dicts / lists / arrays / scalars,
    arrays by np.array_equal with their dtypes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, type(a), type(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, (path, a.dtype, getattr(b, "dtype", None))
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_preprocess")
    jax_root = jax_raw(str(root / "raw_jax"), num_scenes=2, samples_per_scene=2)
    port_root = port_raw(str(root / "raw_port"), num_scenes=2, samples_per_scene=2)
    return root, jax_root, port_root


@pytest.fixture(scope="module")
def processed(trees):
    """The port's CLI and the JAX functions over the JAX package's tree."""
    root, jax_root, _ = trees
    out_j, out_p = str(root / "out_jax"), str(root / "out_port")
    want = jax_pbe(jax_root, out_j, num_erase=2)
    want.update(jax_infos(jax_root, out_j))
    got = ppre.main(["--dataroot", jax_root, "--out-dir", out_p, "--num-erase", "2", "--write-infos"])
    return want, got


def test_synthetic_raw_tree_matches_jax(trees):
    _, jax_root, port_root = trees
    frames = 0
    for d, _, files in os.walk(jax_root):
        for f in files:
            a = os.path.join(d, f)
            b = os.path.join(port_root, os.path.relpath(a, jax_root))
            assert os.path.exists(b), b
            if f.endswith(".json"):
                with open(a) as fa, open(b) as fb:
                    assert json.load(fa) == json.load(fb), f
            elif f.endswith(".jpg"):
                from PIL import Image

                frames += 1
                got = image_io.read_image(b)
                with open(b, "rb") as fb:
                    assert fb.read(8) == b"\x89PNG\r\n\x1a\n"
                with Image.open(b) as im:  # PIL reads the PNG under its .jpg name too
                    assert np.array_equal(np.asarray(im.convert("RGB")), got)
                assert image_io.image_size(b) == image_io.image_size(a) == (400, 225)
                # the same draws: the JAX frame is their JPEG (on this
                # uniform noise JPEG keeps a correlation of ~0.37; two
                # different frames correlate ~0.00)
                jpeg = image_io.read_image(a).astype(np.float64)
                assert got.min() >= 40 and got.max() < 90
                assert np.corrcoef(jpeg.ravel(), got.ravel().astype(np.float64))[0, 1] > 0.3, f
            else:
                assert filecmp.cmp(a, b, shallow=False), f
    assert frames == 2 * 2 * 6


def test_table_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        assert np.array_equal(ptab.quat_to_rot(q), jtab.quat_to_rot(q))
    boxes = rng.normal(size=(6, 7))
    assert np.array_equal(ptab.box7d_to_corners(boxes), jtab.box7d_to_corners(boxes))
    assert np.array_equal(ptab.box7d_to_corners(boxes[0]), jtab.box7d_to_corners(boxes[0]))
    assert ptab.CLASS_MAP == jtab.CLASS_MAP and ptab.CAM_ORDER == jtab.CAM_ORDER


def test_tables_records_equal_jax(trees):
    _, jax_root, _ = trees
    pt, jt = ptab.NuScenesTables(jax_root), jtab.NuScenesTables(jax_root)
    samples = list(pt.samples_of_split())
    assert samples == list(jt.samples_of_split()) and len(samples) == 4
    for s in samples:
        rec_p, rec_j = pt.sample_record(s), jt.sample_record(s)
        assert_same(rec_p, rec_j)
        assert np.array_equal(ptab.load_lidar_points(rec_p["lidar_path"]), jtab.load_lidar_points(rec_j["lidar_path"]))
        for ann in pt._sample_anns[s["token"]]:
            assert np.array_equal(pt.box_velocity(ann["token"]), jt.box_velocity(ann["token"]), equal_nan=True)


def test_edited_samples_swap_equal_jax(trees, tmp_path):
    import shutil

    jax_root = shutil.copytree(trees[1], str(tmp_path / "raw"))
    rec = jtab.NuScenesTables(jax_root).sample_record(next(jtab.NuScenesTables(jax_root).samples_of_split()))
    edited = os.path.join(jax_root, "samples-edited-pre")
    os.makedirs(edited, exist_ok=True)
    stem = os.path.basename(rec["lidar_path"]).split(".")[0]
    np.save(os.path.join(edited, stem + ".npy"), np.ones((7, 5), np.float32))
    pt = ptab.NuScenesTables(jax_root, edited_samples_path="samples-edited-pre")
    jt = jtab.NuScenesTables(jax_root, edited_samples_path="samples-edited-pre")
    recs_p = [pt.sample_record(s) for s in pt.samples_of_split()]
    recs_j = [jt.sample_record(s) for s in jt.samples_of_split()]
    assert recs_p[0]["lidar_path"].endswith(stem + ".npy")
    assert_same(recs_p, recs_j)
    assert np.array_equal(ptab.load_lidar_points(recs_p[0]["lidar_path"]), np.ones((7, 4), np.float32))


def test_preprocess_cli_database_equal_jax(processed):
    want, got = processed
    assert sorted(got) == sorted(want)
    with open(want["object_database_path"], newline="") as fa, open(got["object_database_path"], newline="") as fb:
        rows_j, rows_p = list(csv.reader(fa)), list(csv.reader(fb))
    assert rows_p[0] == rows_j[0] and "camera_visibility_mask" in rows_p[0]
    assert len(rows_p) == len(rows_j) > 3
    assert sum(r[rows_j[0].index("is_erase_box")] == "True" for r in rows_j[1:]) == 2
    for rp, rj in zip(rows_p[1:], rows_j[1:]):
        assert rp == rj
    import pandas as pd

    assert pd.read_csv(got["object_database_path"]).equals(pd.read_csv(want["object_database_path"]))
    with open(want["scene_database_path"], "rb") as fa, open(got["scene_database_path"], "rb") as fb:
        scenes_j, scenes_p = pickle.load(fa), pickle.load(fb)
    for token in scenes_j:
        for k, v in scenes_j[token].items():
            if k.startswith("range_") and k.endswith("_path"):
                assert np.array_equal(np.load(scenes_p[token][k]), np.load(v))
                scenes_p[token][k] = v  # the directories differ
    assert_same(scenes_p, scenes_j)


def test_preprocess_cli_infos_equal_jax(processed):
    want, got = processed
    for split in ("train", "val"):
        with open(want[split], "rb") as fa, open(got[split], "rb") as fb:
            assert_same(pickle.load(fb), pickle.load(fa))


def _random_corners(rng, n):
    boxes = np.concatenate([rng.uniform(-20, 20, (n, 2)), rng.uniform(-2, 0, (n, 1)),
                            rng.uniform(1, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    return jtab.box7d_to_corners(boxes)


def test_collision_and_frustum_tests_equal_jax():
    rng = np.random.default_rng(3)
    a, b = _random_corners(rng, 12), _random_corners(rng, 9)
    # a box straddling +x (the phi wrap) and one behind the sensor
    a[0] = jtab.box7d_to_corners(np.array([10.0, 0.0, -1.0, 4.0, 2.0, 1.5, 0.2]))
    a[1] = jtab.box7d_to_corners(np.array([-8.0, 0.5, -1.0, 4.0, 2.0, 1.5, 1.0]))
    assert np.array_equal(pgeo._box_bev_corners(a), jgeo._box_bev_corners(a))
    for i in range(4):
        assert pgeo._polygon_overlap_2d(a[i, :4, :2], b[i, :4, :2]) == jgeo._polygon_overlap_2d(a[i, :4, :2], b[i, :4, :2])
    coll = pgeo.box_collision_test(a, b)
    assert np.array_equal(coll, jgeo.box_collision_test(a, b)) and coll.any() and not coll.all()
    pts = rng.normal(size=(50, 3)) * 10
    assert np.array_equal(pgeo.transform_to_spherical(pts), jgeo.transform_to_spherical(pts))
    fa, fb = pgeo.get_frustum(a), pgeo.get_frustum(b)
    assert np.array_equal(fa, jgeo.get_frustum(a)) and np.array_equal(fb, jgeo.get_frustum(b))
    assert (fa[:, 2, 0, 1] >= 0).any()  # the wrap case ran
    assert np.array_equal(pgeo.get_frustum(a[0]), jgeo.get_frustum(a[0]))
    assert np.array_equal(pgeo.frustum_iou_matrix(fa), jgeo.frustum_iou_matrix(fa))
    assert np.array_equal(pgeo.frustum_iou_matrix(fa, fb), jgeo.frustum_iou_matrix(fa, fb))
    for th in (0.3, 0.7):
        assert np.array_equal(pgeo.frustum_collision_test(fa, fb, thresh=th), jgeo.frustum_collision_test(fa, fb, thresh=th))
    for n in range(2, 12):
        assert ppre.check_erase_bbox(a[:n]) == jax_check_erase(a[:n])


def test_synthesize_erase_boxes_equal_jax(processed):
    want, _ = processed
    with open(want["scene_database_path"], "rb") as f:
        scenes = pickle.load(f)
    with open(want["object_database_path"], newline="") as f:
        rows = [{"scene_token": r["scene_token"], "scene_obj_idx": int(r["scene_obj_idx"]), "track_id": r["track_id"]}
                for r in csv.DictReader(f) if r["is_erase_box"] == "False"]
    import copy

    sp, sj = copy.deepcopy(scenes), copy.deepcopy(scenes)
    got = ppre.synthesize_erase_boxes(sp, rows, 5, np.random.default_rng(1), max_tries=400)
    exp = jax_erase(sj, rows, 5, np.random.default_rng(1), max_tries=400)
    assert_same(got, exp)
    assert_same(sp, sj)


def test_image_size_reads_headers(tmp_path):
    from PIL import Image

    img = np.random.default_rng(0).integers(0, 255, (37, 53, 3), dtype=np.uint8)
    for name, kw in (("a.jpg", {}), ("b.jpg", {"progressive": True}), ("c.png", {})):
        Image.fromarray(img).save(tmp_path / name, **kw)
        with Image.open(tmp_path / name) as im:
            assert image_io.image_size(str(tmp_path / name)) == im.size == (53, 37)
