"""The port's host data path (mobi_tpu_torch/data/, ops/ranges.py,
utils/config.py) against the JAX package's, on inputs made from numpy seeds
and on the JAX package's own synthetic database.

Tolerances: masks, crop windows, integer fields and strings exactly equal;
range fields, bbox coordinates and other floats within 1e-6; camera pixels
within the JPEG tolerance of tests/test_torch_imaging.py (2 levels, 1/127.5
in the model's [-1, 1] range) when the frames are JPEGs, within 1e-5 when
they are PNGs; the synthetic builder's npys, pickle fields and CSV equal.
"""
import dataclasses
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from mobi_tpu.data import geometry as jgeom
from mobi_tpu.data import range_projection as jrp
from mobi_tpu.data import synthetic as jsynth
from mobi_tpu.data.augment import ref_augment as jref_augment
from mobi_tpu.data.nuscenes import NuScenesDataset as JaxDataset
from mobi_tpu.ops import ranges as jranges
from mobi_tpu.utils import config as jconfig
from mobi_tpu_torch.data import geometry as tgeom
from mobi_tpu_torch.data import range_projection as trp
from mobi_tpu_torch.data import synthetic as tsynth
from mobi_tpu_torch.data import table
from mobi_tpu_torch.data.augment import ref_augment
from mobi_tpu_torch.data.loader import PrefetchLoader
from mobi_tpu_torch.data.nuscenes import NuScenesDataset, collate
from mobi_tpu_torch.ops import ranges as tranges
from mobi_tpu_torch.utils import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_512 = os.path.join(ROOT, "configs", "mobi_nusc_512.yaml")
FLOAT_TOL, JPEG_TOL, PNG_TOL = 1e-6, 2 / 127.5 + 1e-6, 1e-5
# the camera fields that hold decoded pixels
PIXEL_FIELDS = {"image/GT", "image/inpaint_image", "image/orig/image", "image/cond/ref_image",
                "lidar/cond/ref_image"}


def assert_same(a, b, pixel_tol, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_same(a[k], b[k], pixel_tol, f"{path}/{k}" if path else k)
    elif isinstance(a, (str, list)):
        assert a == b, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype.kind == "f":
            # the reference crop is CLIP-normalized: a level is 1/(255 std)
            tol = pixel_tol if path in PIXEL_FIELDS else FLOAT_TOL
            if path.endswith("cond/ref_image"):
                tol = tol * 127.5 / 255 / 0.26130258 + FLOAT_TOL
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=path)
        else:
            assert (a == b).all(), path


@pytest.fixture(scope="module")
def jpeg_db(tmp_path_factory):
    """The JAX package's synthetic database at 320 x 180 (JPEG frames)."""
    root = str(tmp_path_factory.mktemp("db_jpeg"))
    return jsynth.build_synthetic_database(root, img_w=320, img_h=180, seed=0)


@pytest.fixture(scope="module")
def png_db(jpeg_db, tmp_path_factory):
    """The same database with its frames as PNGs (decoded by PIL)."""
    root = str(tmp_path_factory.mktemp("db_png"))
    with open(jpeg_db["scene_database_path"], "rb") as f:
        scenes = pickle.load(f)
    for info in scenes.values():
        paths = []
        for p in info["image_paths"]:
            q = os.path.join(root, os.path.basename(p)[:-4] + ".png")
            Image.open(p).convert("RGB").save(q)
            paths.append(q)
        info["image_paths"] = paths
    pkl = os.path.join(root, "scenes.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(scenes, f)
    return {"object_database_path": jpeg_db["object_database_path"], "scene_database_path": pkl}


def split_params(split, db, **over):
    params = dict(tconfig.load_config([CFG_512])["data"]["params"][split]["params"])
    params.update(db, return_original_image=True, **over)
    return params


SPLITS = {
    # (split, overrides, indices)
    "test": ("test", dict(num_samples_per_class=3), range(6)),
    "rotation_test": ("rotation_test", dict(num_samples_per_class=1), range(0, 24, 5)),
    # ref_aug, prob_erase_box 0.3, object_random_crop and random per-class
    # sampling: every draw of the shared generator, in order
    "train": ("train", dict(seed=3), range(10)),
}


@pytest.mark.parametrize("frames", ["jpeg", "png"])
@pytest.mark.parametrize("name", list(SPLITS))
def test_dataset_matches_jax_field_by_field(name, frames, jpeg_db, png_db):
    split, over, indices = SPLITS[name]
    params = split_params(split, jpeg_db if frames == "jpeg" else png_db, **over)
    jds, tds = JaxDataset(**params), NuScenesDataset(**params)
    assert len(jds) == len(tds)
    classes = set()
    for i in indices:
        want, got = jds[i], tds[i]
        assert_same(want, got, JPEG_TOL if frames == "jpeg" else PNG_TOL)
        classes.add(got["ref_class"])
    if name == "train":  # erase boxes and objects both drawn
        assert "empty" in classes and len(classes) > 1


def test_dataset_modes_match_jax(jpeg_db):
    """The other constructor branches: sample_each_frame, specific_object
    and the ref modes."""
    base = split_params("test", jpeg_db, num_samples_per_class=None, ref_aug=False)
    objects = pd.read_csv(jpeg_db["object_database_path"], index_col=0)
    row = objects[objects["track_id"] == "erase1"].iloc[0]  # a track id without "_"
    specific = f"sample-{row['scene_token']}_track-{row['track_id']}_time-{row['timestamp']}"
    cases = [dict(sample_each_frame=True), dict(specific_object=specific)]
    cases += [dict(ref_mode=m) for m in ("id-ref", "in-domain-ref", "cross-domain-ref", "erase-ref")]
    for over in cases:
        jds, tds = JaxDataset(**{**base, **over}), NuScenesDataset(**{**base, **over})
        assert len(jds) == len(tds) > 0, over
        for i in range(min(len(jds), 3)):
            assert_same(jds[i], tds[i], JPEG_TOL)


def test_collate_and_loader_order(jpeg_db):
    params = split_params("test", jpeg_db, num_samples_per_class=5)
    ds = NuScenesDataset(**params)
    serial = [collate([ds[i] for i in range(b, min(b + 3, len(ds)))]) for b in range(0, len(ds), 3)]
    assert serial[0]["image"]["GT"].shape == (3, 512, 512, 3) and len(serial[0]["id_name"]) == 3
    assert serial[-1]["lidar"]["range_data"].shape[0] == len(ds) - 3 * (len(serial) - 1)
    for kw in (dict(num_threads=3), dict(num_procs=2)):
        loader = PrefetchLoader(NuScenesDataset(**params), 3, shuffle=False, drop_last=False, **kw)
        got = list(loader)
        assert len(got) == len(serial)
        for a, b in zip(got, serial):
            assert_same(a, b, 0.0)


def test_ranges_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (64, 64))
    lo, hi = -0.3, 0.4
    pairs = [
        (jranges.depth_normalization(x, lo, hi, 0.75), tranges.depth_normalization(x, lo, hi, 0.75)),
        (jranges.inverse_depth_normalization(x, lo, hi, 0.75), tranges.inverse_depth_normalization(x, lo, hi, 0.75)),
        (jranges.intensity_normalization(x), tranges.intensity_normalization(x)),
        (jranges.inverse_intensity_normalization(x), tranges.inverse_intensity_normalization(x)),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(got, want)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(tranges.inverse_depth_normalization(t, lo, hi).numpy(),
                               jranges.inverse_depth_normalization(x, lo, hi), atol=1e-12)
    np.testing.assert_allclose(tranges.inverse_intensity_normalization(t).numpy(),
                               jranges.inverse_intensity_normalization(x), atol=1e-12)


def random_box(rng):
    return jsynth._make_box(np.array([rng.uniform(5, 25), rng.uniform(-8, 8), -1.0]),
                            (4.5, 1.9, 1.6), yaw=rng.uniform(0, np.pi))


def test_range_projection_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-40, 40, (5000, 3)) * np.array([1, 1, 0.05])
    inten = rng.uniform(0, 255, 5000)
    want, got = jrp.pcd_to_range(pts, inten), trp.pcd_to_range(pts, inten)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    depth, _, _, pitch, yaw = got
    for a, b in zip(jrp.range_to_pcd(depth, pitch, yaw, np.arange(depth.size)),
                    trp.range_to_pcd(depth, pitch, yaw, np.arange(depth.size))):
        np.testing.assert_array_equal(a, b)
    assert (trp.RANGE_H, trp.RANGE_W, trp.DEPTH_MIN, trp.DEPTH_MAX) == (jrp.RANGE_H, jrp.RANGE_W, jrp.DEPTH_MIN,
                                                                       jrp.DEPTH_MAX)
    np.testing.assert_array_equal(trp.BEAM_PITCH, jrp.BEAM_PITCH)
    for _ in range(5):
        box = random_box(rng)
        coords = trp.bbox_range_coords(box)
        np.testing.assert_array_equal(coords, jrp.bbox_range_coords(box))
        args = (coords, depth, np.abs(depth) * 255, (depth > 0).astype(np.float32))
        j = jrp.apply_range_transforms(*args, out_h=512, out_w=512)
        t = trp.apply_range_transforms(*args, out_h=512, out_w=512)
        for a, b in zip(j[:4], t[:4]):
            np.testing.assert_array_equal(a, b)
        assert dataclasses.asdict(j[4]) == dataclasses.asdict(t[4])
        crop = rng.uniform(-1, 1, (512, 512))
        for a, b in zip(jrp.undo_range_transforms(j[4], crop, depth, crop, depth),
                        trp.undo_range_transforms(t[4], crop, depth, crop, depth)):
            np.testing.assert_array_equal(a, b)
    odd = rng.uniform(-1, 1, (32, 100)).astype(np.float32)
    np.testing.assert_array_equal(trp.resize_range(odd, 512, 512), jrp.resize_range(odd, 512, 512))


def test_geometry_matches_jax():
    rng = np.random.default_rng(2)
    l2i = jsynth._pinhole(0.0, 320, 180)
    for k in range(12):
        box = random_box(rng)
        rotate = tgeom.rotate_bbox(box, 30.0 * k)
        np.testing.assert_array_equal(rotate, jgeom.rotate_bbox(box, 30.0 * k))
        np.testing.assert_array_equal(tgeom.translate_bbox(box, (3, -10, -1.5)), jgeom.translate_bbox(box, (3, -10, -1.5)))
        np.testing.assert_array_equal(tgeom.project_to_image(box, l2i, True), jgeom.project_to_image(box, l2i, True))
        np.testing.assert_array_equal(tgeom.get_2d_bbox(box, l2i, 180, 320, 0.1), jgeom.get_2d_bbox(box, l2i, 180, 320, 0.1))
        for use_3d in (True, False):
            np.testing.assert_array_equal(tgeom.get_inpaint_mask(rotate, l2i, 180, 320, 0.1, use_3d),
                                          jgeom.get_inpaint_mask(rotate, l2i, 180, 320, 0.1, use_3d))
        np.testing.assert_array_equal(tgeom.get_range_inpaint_mask(rotate, 512, 512, 0.1),
                                      jgeom.get_range_inpaint_mask(rotate, 512, 512, 0.1))
        pts = rng.uniform(-30, 30, (2000, 3))
        np.testing.assert_array_equal(tgeom.points_in_bbox_corners(pts, box[None]),
                                      jgeom.points_in_bbox_corners(pts, box[None]))


def test_ref_augment_matches_jax():
    """The same generator draws in the same order, and cv2's rotate, blur
    and resize: equal crops."""
    img = np.random.default_rng(3).integers(0, 256, (61, 47, 3), dtype=np.uint8)
    for seed in range(8):
        want = jref_augment(img, np.random.default_rng(seed))
        j, t = np.random.default_rng(seed), np.random.default_rng(seed)
        got = ref_augment(img, t)
        jref_augment(img, j)
        assert (got == want).all() and j.uniform() == t.uniform()
    assert (ref_augment(img, None, enabled=False) == jref_augment(img, None, enabled=False)).all()


def test_synthetic_builder_matches_jax(tmp_path, monkeypatch):
    saved = {}
    save = Image.Image.save

    def recording_save(self, fp, *a, **kw):
        saved[os.path.basename(str(fp))] = np.asarray(self).copy()
        return save(self, fp, *a, **kw)

    monkeypatch.setattr(Image.Image, "save", recording_save)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jpaths = jsynth.build_synthetic_database(jroot, img_w=96, img_h=54, seed=5)
    tpaths = tsynth.build_synthetic_database(troot, img_w=96, img_h=54, seed=5)
    with open(jpaths["object_database_path"], "rb") as f, open(tpaths["object_database_path"], "rb") as g:
        assert f.read() == g.read()
    with open(jpaths["scene_database_path"], "rb") as f, open(tpaths["scene_database_path"], "rb") as g:
        jscenes, tscenes = pickle.load(f), pickle.load(g)
    assert list(jscenes) == list(tscenes)
    for token, j in jscenes.items():
        t = tscenes[token]
        assert set(j) == set(t)
        for key, value in j.items():
            if key == "image_paths":
                assert [os.path.basename(p)[:-4] for p in value] == [os.path.basename(p)[:-4] for p in t[key]]
                for p in t[key]:
                    assert p.endswith(".png")
                    assert (np.asarray(Image.open(p)) == saved[os.path.basename(p)[:-4] + ".jpg"]).all()
            elif key.endswith("_path"):
                assert os.path.relpath(value, jroot) == os.path.relpath(t[key], troot)
                np.testing.assert_array_equal(np.load(value), np.load(t[key]))
            elif isinstance(value, np.ndarray):
                np.testing.assert_array_equal(value, t[key])
            else:
                assert value == t[key], key


def test_table_matches_pandas(tmp_path):
    rng = np.random.default_rng(4)
    n = 23
    df = pd.DataFrame({
        "cls": rng.choice(["car", "pedestrian", "bus"], n), "scene": rng.choice(["s0", "s1", "s2", "s3"], n),
        "points": rng.integers(0, 5, n), "dist": rng.uniform(0, 50, n).round(3),
        "erase": rng.random(n) < 0.3, "note": ["a,b" if i % 5 == 0 else "x" for i in range(n)],
    })
    df.loc[3, "dist"] = np.nan
    path = str(tmp_path / "t.csv")
    df.to_csv(path)
    pdf, t = pd.read_csv(path, index_col=0), table.read_csv(path, index_col=0)
    assert list(pdf.columns) == t.columns
    for c in pdf.columns:
        want = pdf[c].to_numpy()
        assert t[c].dtype.kind == want.dtype.kind, c
        np.testing.assert_array_equal(t[c], want)

    def same(p, q):
        assert list(p.index) == list(q.index)
        for c in p.columns:
            np.testing.assert_array_equal(q[c], p[c].to_numpy())

    mask = (pdf["points"] >= 2) & ~pdf["erase"]
    same(pdf[mask], t[(t["points"] >= 2) & ~t["erase"]])
    same(pdf[pdf["cls"].isin(["car", "bus"])], t[np.isin(t["cls"], ["car", "bus"])])
    for seed in range(4):
        same(pdf.sample(5, random_state=seed), t.sample(5, random_state=seed))
        same(pdf.sample(40, replace=True, random_state=seed), t.sample(40, replace=True, random_state=seed))
        same(pdf.groupby("scene").sample(n=1, random_state=seed), t.groupby("scene").sample(n=1, random_state=seed))
        for (jk, jg), (tk, tg) in zip(pdf.groupby("cls"), t.groupby("cls")):
            assert jk == tk
            same(jg.sample(7, replace=True, random_state=seed), tg.sample(7, replace=True, random_state=seed))
    same(pdf.sort_values("points", ascending=False).groupby("scene").head(3),
         t.sort_values("points", ascending=False).groupby("scene").head(3))
    same(pd.concat([pdf[mask], pdf[:4]]).reset_index(drop=True), table.concat([t[mask], t[np.arange(n) < 4]]).reset_index())
    assert pdf.loc[7].to_dict() == t.loc(7)
    assert [i for i, _ in pdf.iterrows()] == [i for i, _ in t.iterrows()]


def shipped_yamls():
    return sorted(f for f in os.listdir(os.path.join(ROOT, "configs")) if f.endswith(".yaml"))


@pytest.mark.parametrize("name", shipped_yamls())
def test_every_shipped_yaml_matches_jax(name):
    """load_config + mobi_config_from_yaml in both packages: the same tree,
    and the same value in every field the two MobiConfigs share (the range
    normalizations and the widths included)."""
    path = os.path.join(ROOT, "configs", name)
    tree = tconfig.load_config([path])
    assert tree == jconfig.load_config([path])
    try:
        want = jconfig.mobi_config_from_yaml(jconfig.load_config([path]))
    except KeyError:
        with pytest.raises(KeyError):
            tconfig.mobi_config_from_yaml(tree)
        return
    got = tconfig.mobi_config_from_yaml(tree)
    shared = set(got.__dataclass_fields__) & set(want.__dataclass_fields__)
    assert {"range_object_norm", "range_object_norm_scale", "range_int_norm", "image_width",
            "range_width"} <= shared
    for field in shared - {"dtype"}:
        assert getattr(got, field) == getattr(want, field), field
    assert str(got.dtype).replace("torch.", "") == str(np.dtype(want.dtype))


def test_instantiate_from_config_maps_dataset_targets(jpeg_db):
    node = {"target": "mobi_tpu.data.nuscenes.NuScenesDataset",
            "params": split_params("test", jpeg_db, num_samples_per_class=1)}
    assert isinstance(tconfig.instantiate_from_config(node), NuScenesDataset)
    node["target"] = "ldm.data.nuscenes.NuScenesDataset"
    assert isinstance(tconfig.instantiate_from_config(node), NuScenesDataset)
    with pytest.raises(NotImplementedError, match="cannot build"):
        tconfig.instantiate_from_config({"target": "mobi_tpu.models.unet.UNetModel", "params": {}})
    with pytest.raises(KeyError):
        tconfig.instantiate_from_config({"params": {}})
