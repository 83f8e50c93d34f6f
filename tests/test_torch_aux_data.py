"""The port's legacy host surfaces against the JAX package's (which draw
with cv2 5.0): the auxiliary datasets on a tmp tree of cv2-written JPEGs and
PNGs, cv2's fillPoly / line / arrowedLine / IMREAD_GRAYSCALE as `imgproc`
and `image_io` redo them, the BEV view, and `python -m
mobi_tpu_torch.visualise_data` against scripts/visualise_data.py.

Tolerances: fields derived from uint8 pixels, masks, drawings and written
files exactly equal; fields resized in float (cv2's float INTER_LINEAR,
which `imgproc.resize_linear` meets within 2 ulp) within 1e-6.
"""
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest
import yaml

from mobi_tpu import viz as jviz
from mobi_tpu.data import aux_datasets as jaux
from mobi_tpu.utils import config as jconfig
from mobi_tpu_torch import viz as tviz
from mobi_tpu_torch import visualise_data
from mobi_tpu_torch.data import aux_datasets as taux
from mobi_tpu_torch.data import image_io, imgproc
from mobi_tpu_torch.data import synthetic as tsynth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_RESIZED = {"GT", "inpaint_image", "inpaint_mask"}  # OpenImages' float resizes


def photo(h, w, seed):
    """A smooth uint8 BGR picture (JPEG-friendly) from a numpy seed."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return cv2.GaussianBlur(img, (7, 7), 3)


def assert_items_equal(want, got, float_resized=()):
    assert set(want) == set(got)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in float_resized:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=k)
        else:
            assert np.array_equal(a, b), k


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("aux")
    # OpenImages: three train files (wide, tall, square), boxes at the borders
    # too, one BAD_LIST name, and a validation file
    oi = root / "oi"
    specs = [("train_0", "a1", (64, 96), "20 10 60 40\n0 0 30 25\n"),
             ("train_3", "b2", (90, 60), "5 50 59 89\n10 10 40 30\n33 40 50 70\n"),
             ("train_f", "c3", (70, 70), "0 30 69 69\n"),
             ("validation", "d4", (48, 80), "12 8 70 40\n")]
    for i, (split, stem, (h, w), boxes) in enumerate(specs):
        (oi / "bbox" / split).mkdir(parents=True, exist_ok=True)
        (oi / "images" / split).mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(oi / "images" / split / f"{stem}.jpg"), photo(h, w, i))
        (oi / "bbox" / split / f"{stem}.txt").write_text(boxes)
    (oi / "bbox" / "train_0" / "1af17f3d912e9aac.txt").write_text("1 1 5 5\n")
    # the COCO test bench: a gray mask PNG and a colour one
    tb = root / "bench"
    for d in ("GT_3500", "Ref_3500", "Mask_bbox_3500"):
        (tb / d).mkdir(parents=True)
    for i, sid in enumerate((7, 123456)):
        name = str(sid).zfill(12)
        cv2.imwrite(str(tb / "GT_3500" / f"{name}_GT.png"), photo(40, 56, 10 + i))
        cv2.imwrite(str(tb / "Ref_3500" / f"{name}_ref.png"), photo(33, 27, 20 + i))
        mask = np.zeros((40, 56), np.uint8)
        mask[8:30, 10 + 5 * i:40] = 255
        cv2.imwrite(str(tb / "Mask_bbox_3500" / f"{name}_mask.png"),
                    mask if i == 0 else cv2.merge([mask, mask // 2, mask]))
    np.save(tb / "id_list.npy", np.array([7, 123456]))
    # ImageNet / LSUN folders
    im = root / "imgs"
    for i, (syn, name, (h, w)) in enumerate([("n01440764", "x.jpg", (40, 60)), ("n01440764", "y.png", (50, 30)),
                                              ("n02102040", "z.jpg", (45, 45))]):
        (im / syn).mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(im / syn / name), photo(h, w, 30 + i))
    (root / "list.txt").write_text("n01440764/x.jpg\nn02102040/z.jpg\nn01440764/y.png\n")
    lsun = root / "lsun"
    (lsun / "churches").mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(lsun / "churches" / f"{i}.jpg"), photo(30 + 10 * i, 50, 40 + i))
    (lsun / "church_outdoor_train.txt").write_text("0.jpg\n1.jpg\n2.jpg\n")
    return root


@pytest.mark.parametrize("state,arbitrary", [("train", 0.0), ("train", 0.6), ("train", 1.0), ("validation", 1.0)])
def test_open_images_matches_jax(tree, state, arbitrary):
    kw = dict(image_size=32, arbitrary_mask_percent=arbitrary, seed=3)
    jds = jaux.OpenImagesDataset(state, str(tree / "oi"), **kw)
    tds = taux.OpenImagesDataset(state, str(tree / "oi"), **kw)
    assert tds.bbox_paths == jds.bbox_paths and len(tds) == (3 if state == "train" else 1)
    for i in list(range(len(jds))) * 3:  # the shared generator's draws, in order
        assert_items_equal(jds[i], tds[i], FLOAT_RESIZED)


def test_coco_test_bench_matches_jax(tree):
    jds, tds = jaux.COCOTestBenchDataset(str(tree / "bench")), taux.COCOTestBenchDataset(str(tree / "bench"))
    assert len(tds) == len(jds) == 2
    for i in range(2):
        assert_items_equal(jds[i], tds[i])


@pytest.mark.parametrize("cls,kw", [
    ("ImageNetFolder", dict(size=16, flip_p=0.5, seed=2)),
    ("ImageNetFolder", dict(size=None, file_list="list.txt")),
    ("ImageNetSR", dict(size=32, downscale_f=4, flip_p=0.5, seed=5)),
])
def test_imagenet_matches_jax(tree, cls, kw):
    if "file_list" in kw:
        kw = dict(kw, file_list=str(tree / kw["file_list"]))
    jds, tds = getattr(jaux, cls)(str(tree / "imgs"), **kw), getattr(taux, cls)(str(tree / "imgs"), **kw)
    assert tds.rel_paths == jds.rel_paths and tds.synset_to_idx == jds.synset_to_idx
    for i in list(range(len(jds))) * 2:
        assert_items_equal(jds[i], tds[i])


def test_lsun_matches_jax(tree):
    pairs = [(jaux.LSUNBase(str(tree / "list.txt"), str(tree / "imgs"), size=20, seed=4),
              taux.LSUNBase(str(tree / "list.txt"), str(tree / "imgs"), size=20, seed=4)),
             (jaux.lsun_split("churches", "train", data_root=str(tree / "lsun"), size=24, seed=1),
              taux.lsun_split("churches", "train", data_root=str(tree / "lsun"), size=24, seed=1))]
    assert pairs[1][1].flip_p == 0.5
    for jds, tds in pairs:
        for i in list(range(len(jds))) * 3:
            assert_items_equal(jds[i], tds[i])


# ------------------------------------------------------------ cv2 drawing


def random_polygon(rng, h, w, margin):
    n = int(rng.integers(3, 12))
    return np.stack([rng.integers(-margin, w + margin, n), rng.integers(-margin, h + margin, n)], 1).astype(np.int32)


@pytest.mark.parametrize("margin", [0, 30, 200])
def test_fill_poly_matches_cv2(margin):
    """fillPoly with LINE_8, bitwise, on 300 random polygons; with a margin
    their vertices fall off the image, where cv2 5.0 runs an edge along its
    clipped ends."""
    rng = np.random.default_rng(margin)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(4, 70, 2))
        pts = np.minimum(random_polygon(rng, h, w, margin), [w - 1, h - 1]) if margin == 0 else \
            random_polygon(rng, h, w, margin)
        want = cv2.fillPoly(np.zeros((h, w), np.uint8), [pts], 1)
        assert np.array_equal(imgproc.fill_poly(np.zeros((h, w), np.uint8), pts, 1), want), (h, w, pts.tolist())


def test_smooth_polygon_mask_matches_jax():
    """The JAX package's bezier ring (filled by cv2) from the same draws,
    bitwise, on 300 random boxes, border boxes included."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        h, w = (int(v) for v in rng.integers(20, 160, 2))
        x0, y0 = int(rng.integers(0, w - 4)), int(rng.integers(0, h - 4))
        bbox = [x0, y0, int(rng.integers(x0 + 2, w + 1)), int(rng.integers(y0 + 2, h + 1))]
        seed = int(rng.integers(1 << 30))
        want = jaux._smooth_polygon_mask(h, w, bbox, np.random.default_rng(seed))
        got = taux._smooth_polygon_mask(h, w, bbox, np.random.default_rng(seed))
        assert got.dtype == np.float32 and np.array_equal(got, want), (h, w, bbox)


@pytest.mark.parametrize("channels", [1, 3])
def test_lines_and_arrows_match_cv2(channels):
    """line (LINE_8 and LINE_AA, which blends twice as cv2 does) and
    arrowedLine (tip 0.1) on random canvases, ends on and off the image."""
    rng = np.random.default_rng(channels)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(5, 60, 2))
        p1, p2 = ((int(rng.integers(-20, w + 20)), int(rng.integers(-20, h + 20))) for _ in range(2))
        base = rng.integers(0, 256, (h, w, channels) if channels == 3 else (h, w)).astype(np.uint8)
        color = tuple(int(v) for v in rng.integers(0, 256, 3)) if channels == 3 else int(rng.integers(256))
        for lt in (cv2.LINE_8, cv2.LINE_AA):
            want = cv2.line(base.copy(), p1, p2, color, 1, lt)
            assert np.array_equal(imgproc.line(base.copy(), p1, p2, color, lt), want), (lt, h, w, p1, p2)
            want = cv2.arrowedLine(base.copy(), p1, p2, color, 1, lt, tipLength=0.1)
            assert np.array_equal(imgproc.arrowed_line(base.copy(), p1, p2, color, lt, 0.1), want)


def test_read_gray_matches_cv2(tmp_path):
    """IMREAD_GRAYSCALE: a colour JPEG's luma plane (4:2:0 and 4:4:4), a
    gray JPEG, a colour PNG through libpng's rgb_to_gray, RGBA, gray."""
    img = photo(37, 53, 50)
    files = {"c420.jpg": (img, []), "c444.jpg": (img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
             "g.jpg": (img[..., 1], []), "c.png": (img, []), "g.png": (img[..., 2], []),
             "a.png": (cv2.merge([*cv2.split(img), img[..., 0]]), [])}
    for name, (data, flags) in files.items():
        cv2.imwrite(str(tmp_path / name), data, flags)
        assert np.array_equal(image_io.read_gray(str(tmp_path / name)),
                              cv2.imread(str(tmp_path / name), cv2.IMREAD_GRAYSCALE)), name


@pytest.mark.parametrize("lims,dpi", [((-54, 54), 5), ((-10, 10), 20)])
def test_visualize_lidar_bev_matches_jax(tmp_path, lims, dpi):
    """Boxes (their corners' xy) and points at visualise_data's size and at
    the default one; the PNG written holds the same pixels."""
    rng = np.random.default_rng(dpi)
    span = lims[1]
    boxes = []
    for _ in range(4):
        c, (l, wd), yaw = rng.uniform(-span, span, 2), rng.uniform(0.5, span / 3, 2), rng.uniform(-np.pi, np.pi)
        corners = np.array([[l, wd], [l, -wd], [-l, -wd], [-l, wd]]) / 2
        rot = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
        ring = corners @ rot.T + c
        boxes.append(np.concatenate([ring, ring])[[0, 1, 2, 3, 4, 5, 6, 7]])
    boxes = np.stack(boxes)
    points = rng.uniform(-1.2 * span, 1.2 * span, (500, 4))
    kw = dict(bboxes=boxes, xlim=lims, ylim=lims, dpi=dpi)
    want = jviz.visualize_lidar_bev(points, fpath=str(tmp_path / "j.png"), **kw)
    got = tviz.visualize_lidar_bev(points, fpath=str(tmp_path / "t.png"), **kw)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert np.array_equal(image_io.read_image(str(tmp_path / "t.png")), cv2.imread(str(tmp_path / "j.png"))[..., ::-1])
    one = tviz.visualize_lidar_bev(bboxes=boxes[0], xlim=lims, ylim=lims, dpi=dpi)
    assert np.array_equal(one, jviz.visualize_lidar_bev(bboxes=boxes[0], xlim=lims, ylim=lims, dpi=dpi))


def test_visualise_data_matches_the_jax_script(tmp_path, monkeypatch):
    """Both CLIs on the port's synthetic database (PNG frames) through one
    YAML: the same files, equal pixels, except in gt.png: the dataset's GT
    is resized in float, where the port sits within 2 ulp of cv2 (ROADMAP
    queue 3, the 1e-5 of tests/test_torch_data.py), and a few of its pixels
    round to the next level (at most one, in under 0.1% of them; inpaint.png,
    the same image masked, and the rest are exact). The JAX script hands load_config its
    path as a string, which load_config iterates character by character
    (ROADMAP queue 3); the test wraps it in a list there."""
    db = tsynth.build_synthetic_database(str(tmp_path / "db"), img_w=160, img_h=90, seed=1)
    cfg = jconfig.load_config([os.path.join(ROOT, "configs", "mobi_nusc_512.yaml")])
    cfg["data"]["params"]["train"]["params"].update(db)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["--config", str(path), "--split", "train", "--num", "2"]

    spec = importlib.util.spec_from_file_location("jax_visualise_data", os.path.join(ROOT, "scripts", "visualise_data.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    load = jconfig.load_config
    monkeypatch.setattr(jconfig, "load_config", lambda p, *a: load([p] if isinstance(p, str) else p, *a))
    monkeypatch.setattr(sys, "argv", ["visualise_data.py", *args, "--outdir", str(tmp_path / "jax")])
    script.main()
    assert visualise_data.main([*args, "--outdir", str(tmp_path / "port")]) == 2

    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                           for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert {os.path.basename(n) for n in names} == {"gt.png", "inpaint.png", "mask.png", "ref.png", "range.png",
                                                    "range_mask.png", "bev.png"}
    for n in names:
        want = cv2.imread(str(tmp_path / "jax" / n), cv2.IMREAD_UNCHANGED)
        got = image_io.decode_png((tmp_path / "port" / n).read_bytes())
        want = want[..., ::-1] if want.ndim == 3 else want
        if os.path.basename(n) == "gt.png":
            diff = np.abs(got.astype(np.int64) - want)
            assert got.shape == want.shape and diff.max() <= 1 and (diff > 0).mean() < 1e-3, n
        else:
            assert np.array_equal(got, want), n
