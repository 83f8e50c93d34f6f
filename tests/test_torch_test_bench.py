"""The port's inference test bench (mobi_tpu_torch/inference_test_bench.py)
against scripts/inference_test_bench.py, on the CPU.

Tolerances: the host stages given the same batch and outputs write the same
files: lidar npys exactly equal, lidar_sample_metrics within 1e-9 relative,
the range PNGs, collages and the overlay on the original frame exactly
equal, the camera images within 1 level (the float resize and Gaussian
blend agree with cv2's to ~1e-7, and truncating to uint8 can flip a level
there). metrics.csv is byte-equal
to pandas' output on the same dict. The whole slice on the tiny config
(tests/test_diffusion.py TINY, weights carried across by
convert.state_dict_from_jax): the port's pipeline outputs within 2e-4 of
JAX's (tests/test_torch_models.py's pipeline tolerance), then both host
stages on those outputs give the files above.
"""
import copy
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import chip_smoke
from mobi_tpu.data.nuscenes import NuScenesDataset as JaxDataset
from mobi_tpu.data.nuscenes import collate as jcollate
from mobi_tpu.data.synthetic import build_synthetic_database
from mobi_tpu.eval.lidar_metrics import lidar_sample_metrics as jmetrics
from mobi_tpu.models.diffusion import MobiDiffusion as JaxMobi
from mobi_tpu.utils import config as jconfig
from mobi_tpu_torch import inference_test_bench as bench
from mobi_tpu_torch.checkpoint import CheckpointManager
from mobi_tpu_torch.eval.lidar_metrics import lidar_sample_metrics
from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.models.ema import LitEma
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.pipeline import make_inpaint_pipeline
from mobi_tpu_torch.training import TrainState
from mobi_tpu_torch.utils import config as tconfig
from scripts import inference_test_bench as jbench
from tests.test_diffusion import TINY, TinyCondStage
from tests.test_torch_models import few_torch_threads, port_config, random_params, tiny_cond_stage  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_512 = os.path.join(ROOT, "configs", "mobi_nusc_512.yaml")
STEPS, GUIDANCE, SEED = 5, 5.0, 321


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """The JAX package's synthetic database at its default size (JPEG
    frames, 800 x 450)."""
    return build_synthetic_database(str(tmp_path_factory.mktemp("db")), seed=0)


def overrides(db, split, size=32):
    """The bench's dotted overrides: the database, one object a class, the tiny
    config's 32 x 32 images and 32-row range views. The range view is twice
    as wide: the lidar metrics pool each crop to its window width, which is
    at least 64 columns (range_projection.default_width_crop)."""
    keys = dict(db, num_samples_per_class=1, image_height=size, image_width=size, range_height=size,
                range_width=max(2 * size, 64))
    return [f"data.params.{split}.params.{k}={v}" for k, v in keys.items()]


def argv(outdir, db, rotation=False, extra=()):
    split = "rotation_test" if rotation else "test"
    return (["--config", CFG_512, "--outdir", str(outdir), "--ddim_steps", str(STEPS), "--scale", str(GUIDANCE),
             "--n_samples", "2", "--seed", str(SEED), "--save_samples", "--save_visualisations",
             "--max_batches", "1", "--n_workers", "2", "--device", "cpu"]
            + (["--rotation_test"] if rotation else []) + list(extra) + overrides(db, split))


def test_parse_args_matches_jax():
    """Every dest and default of the JAX bench, and --device (cuda)."""
    cases = [["--config", "c.yaml"],
             ["--config", "c.yaml", "--plms", "--ddim_steps", "7", "--scale", "5", "--n_samples", "3", "--seed", "9",
              "--fixed_code", "--rotation_test", "--save_samples", "--save_visualisations", "--copy-paste",
              "--fixed-intensity-paste", "--max_batches", "2", "--sample-segments", "5", "--encoder-interval", "2",
              "--mesh-dp", "2", "--ckpt", "m.ckpt", "--outdir", "o", "--ddim_eta", "0.5", "--n_workers", "1",
              "a.b=1", "c=d"]]
    for case in cases:
        got = vars(bench.parse_args(case))
        assert got.pop("device") == "cuda"
        assert got == vars(jbench.parse_args(case))
    assert bench.parse_args(["--config", "c", "--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("metrics", [
    {"mse": {"b": 1.5, "a": 0.1}, "median_error": {"a": 0.2}},
    {"mse": {"b": 1.5}, "median_error": {"c": 0.2, "a": 1 / 3}},
    {"mse": {}, "median_error": {}},
    {"mse": {"object_pred_depth": 123456789.123, "mask_pred_int": 1e-20},
     "median_error": {"object_pred_depth": 2.0, "mask_pred_int": float("nan")}},
])
def test_metrics_csv_is_pandas_byte_for_byte(tmp_path, metrics):
    ours, theirs = tmp_path / "a.csv", tmp_path / "b.csv"
    bench.write_metrics_csv(str(ours), metrics)
    pd.DataFrame(metrics).to_csv(str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()


class RecordingCv2:
    """cv2 for the JAX bench's host stages, with imwrite recording the
    arrays it is handed (relative path -> array) instead of encoding them."""

    def __init__(self, root):
        self.root, self.written = root, {}

    def __getattr__(self, name):
        return getattr(cv2, name)

    def imwrite(self, path, img):
        self.written[os.path.relpath(path, self.root)] = np.array(img)
        return True


def as_rgb(img):
    return img[..., ::-1] if img.ndim == 3 else img


def jax_host_stage(outdir, batch, cam, lid, opt, mcfg):
    """The JAX bench's finish_batch (scripts/inference_test_bench.py) on
    these outputs: the composites, the visuals, and the metrics."""
    rec = RecordingCv2(str(outdir))
    camera_path, lidar_path = str(outdir / "camera"), str(outdir / "lidar")
    sample_path = str(outdir / f"samples_seed{opt.seed}")
    for d in (camera_path, lidar_path, sample_path):
        os.makedirs(d, exist_ok=True)
    for i, seg in enumerate(batch["id_name"]):
        recon = jbench.composite_camera(cam[i], batch, i, camera_path, sample_path, seg, opt, rec)
        jbench.composite_lidar(lid[i], batch, i, lidar_path, sample_path, seg, opt, mcfg, recon)
        jbench.save_camera_grid(cam[i], batch, i, camera_path, seg, opt, rec)
        jbench.save_lidar_visuals(lid[i], batch, i, lidar_path, seg, opt, rec)
    lb = batch["lidar"]
    m = jmetrics(pred=lid, gt=lb["range_data"], instance_mask=lb["range_instance_mask"],
                 edit_mask=lb["range_mask"], width_crop=lb["width_crop"], min_depth_obj=lb["min_depth_obj"],
                 max_depth_obj=lb["max_depth_obj"], range_object_norm=mcfg.range_object_norm,
                 range_object_norm_scale=mcfg.range_object_norm_scale, range_int_norm=mcfg.range_int_norm)
    return rec.written, m


def assert_same_files(port_dir, jax_dir, written):
    """Every file the port wrote against the JAX bench's: npys exactly, the
    lidar images exactly, the camera images within 1 level; .jpg outputs of
    JAX are the port's same-stem PNGs."""
    port_files = sorted(os.path.relpath(os.path.join(d, f), port_dir)
                        for d, _, fs in os.walk(port_dir) for f in fs if f != "metrics.csv")
    jax_files = sorted([os.path.splitext(p)[0] + ".png" for p in written]
                       + [os.path.relpath(os.path.join(d, f), jax_dir) for d, _, fs in os.walk(jax_dir) for f in fs])
    assert port_files == jax_files
    jpg_of = {os.path.splitext(p)[0] + ".png": p for p in written}
    for rel in port_files:
        path = os.path.join(port_dir, rel)
        if rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(path), np.load(os.path.join(jax_dir, rel)), err_msg=rel)
            continue
        got = np.asarray(Image.open(path))
        want = as_rgb(written[jpg_of[rel]]) if rel in jpg_of else np.asarray(Image.open(os.path.join(jax_dir, rel)))
        tol = 1 if rel.startswith(("samples_seed", "camera/")) or "overlay_pred" in rel else 0
        assert got.shape == want.shape, rel
        d = np.abs(got.astype(np.int64) - want)
        assert d.max() <= tol, (rel, np.argwhere(d > tol)[:5].tolist())


def test_host_stage_matches_jax(tmp_path, db):
    """The port's host stage and JAX's on one batch of the port's dataset and
    the same random outputs (bench options: copy-paste off and on)."""
    params = tconfig.load_config([CFG_512], overrides(db, "test", size=64))["data"]["params"]["test"]["params"]
    ds = JaxDataset(**params, return_original_image=True)
    batch = jcollate([ds[0], ds[1]])
    rng = np.random.default_rng(0)
    cam = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    lid = batch["lidar"]["range_data"]
    lid = np.clip(lid + rng.normal(0, 0.05, lid.shape), -1, 1).astype(np.float32)
    mcfg = tconfig.mobi_config_from_yaml(tconfig.load_config([CFG_512]))
    for extra in ([], ["--copy-paste", "--fixed-intensity-paste"]):
        opt = bench.parse_args(["--config", CFG_512, "--seed", "5"] + extra)
        port_dir, jax_dir = tmp_path / f"port{len(extra)}", tmp_path / f"jax{len(extra)}"
        for d in ("camera", "lidar", "samples_seed5"):
            os.makedirs(port_dir / d)
        for i, seg in enumerate(batch["id_name"]):
            recon = bench.composite_camera(cam[i], batch, i, str(port_dir / "camera"), str(port_dir / "samples_seed5"),
                                           seg, opt)
            bench.composite_lidar(lid[i], batch, i, str(port_dir / "lidar"), str(port_dir / "samples_seed5"), seg,
                                  opt, mcfg, recon)
            bench.save_camera_grid(cam[i], batch, i, str(port_dir / "camera"), seg, opt)
            bench.save_lidar_visuals(lid[i], batch, i, str(port_dir / "lidar"), seg, opt)
        written, want = jax_host_stage(jax_dir, batch, cam, lid, opt, mcfg)
        assert_same_files(str(port_dir), str(jax_dir), written)
        lb = batch["lidar"]
        got = lidar_sample_metrics(lid, lb["range_data"], lb["range_instance_mask"], lb["range_mask"],
                                   lb["width_crop"], lb["min_depth_obj"], lb["max_depth_obj"], True, 0.75, True)
        assert set(got) == set(want) and got
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny model in both packages with the same weights, and JAX's
    pipeline (posterior-mode encode, DDIM-5 at CFG 5 from a given x_T)."""
    jmodel = JaxMobi(TINY)
    jmodel.cond_model = TinyCondStage(conditions=("ref_image", "ref_bbox"))
    params_np = random_params(jmodel)
    params = jax.tree.map(jnp.asarray, params_np)
    tmodel = tdiff.MobiDiffusion(port_config(TINY), device="cpu", cond_stage_model=tiny_cond_stage())
    tmodel.load_jax_params(params_np)

    @jax.jit
    def jax_pipeline(batch, x_T):
        data = jmodel.get_input(params, batch, jax.random.PRNGKey(0), encode_cond=True, deterministic=True)
        latents = jmodel.sample(params, data, jax.random.PRNGKey(1), num_steps=STEPS, guidance_scale=GUIDANCE,
                                sampler="ddim", x_T=x_T)
        return jmodel.decode_sample(params, latents, data["z_lidar_full"], data["lidar_geom"])

    return jax_pipeline, tmodel


def small_ref(batch_ref):
    """The tiny CLIP's 32 x 32 reference crops: the same resize both sides."""
    return np.stack([cv2.resize(np.asarray(r), (32, 32), interpolation=cv2.INTER_LINEAR) for r in batch_ref])


@pytest.mark.parametrize("rotation", [False, True])
def test_slice_matches_jax_on_tiny(tmp_path, db, tiny_pair, monkeypatch, rotation):
    """The bench end to end on the CPU (--device cpu) with the tiny model:
    one batch of each split through the port's main (deterministic encode,
    pinned x_T, DDIM-5 at CFG 5) and through the JAX model and bench host
    stage. No kernel launches (the autouse fixture)."""
    jax_pipeline, tmodel = tiny_pair
    x_T = np.random.default_rng(7).standard_normal((4, 8, 8, 4)).astype(np.float32)
    seen = {}

    def pinned_pipeline(model, **kw):
        kw.pop("sample_segments"), kw.pop("encoder_interval")
        run = make_inpaint_pipeline(model, deterministic_encode=True, **kw)

        def call(batch, generator):
            batch["image"]["cond"]["ref_image"] = small_ref(batch["image"]["cond"]["ref_image"])
            out = run(batch, generator, x_T=torch.from_numpy(x_T))
            seen["batch"], seen["out"] = batch, {k: v.numpy() for k, v in out.items()}
            return out

        return call

    monkeypatch.setattr(bench, "make_inpaint_pipeline", pinned_pipeline)
    port_dir = tmp_path / "port"
    args = argv(port_dir, db, rotation)
    stats = bench.main(args, model=tmodel)
    assert stats["objects"] == 2 and len(stats["batches"]) == 1 and stats["batches"][0]["device_s"] is None

    # JAX: the same split and batch, its model on the same inputs
    cfg = jconfig.load_config([CFG_512], [s for s in args if "=" in s])
    split = "rotation_test" if rotation else "test"
    ds = JaxDataset(**cfg["data"]["params"][split]["params"], return_original_image=True)
    batch = jcollate([ds[0], ds[1]])
    stripped = jax.tree.map(jnp.asarray, bench._strip(batch))
    stripped["image"]["cond"]["ref_image"] = jnp.asarray(seen["batch"]["image"]["cond"]["ref_image"])
    decoded = jax_pipeline(stripped, jnp.asarray(x_T))
    for name in ("camera", "lidar"):
        np.testing.assert_allclose(seen["out"][name], np.asarray(decoded[name]), atol=2e-4, rtol=2e-4)

    # the JAX bench's host stage on the port's outputs: the same files
    opt = jbench.parse_args([a for a in args if a not in ("--device", "cpu")])
    mcfg = jconfig.mobi_config_from_yaml(cfg)
    written, metrics = jax_host_stage(tmp_path / "jax", batch, seen["out"]["camera"], seen["out"]["lidar"], opt,
                                      mcfg)
    assert_same_files(str(port_dir), str(tmp_path / "jax"), written)
    got = pd.read_csv(port_dir / "metrics.csv", index_col=0)
    table = {"mse": {}, "median_error": {}}
    for k, v in metrics.items():
        group, name = k.split("/")
        table[group][name] = v
    want = pd.DataFrame(table)
    assert list(got.index) == list(want.index) and list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=1e-9)
    assert np.isfinite(got.to_numpy()).all()


def test_unported_options_raise(tmp_path, db, tiny_pair):
    """--mesh-dp > 1 raises; an orbax --ckpt directory of the JAX package
    raises, naming the conversion; a checkpoint directory the port's
    training CLI writes (its CheckpointManager) loads, EMA shadow and all."""
    _, tmodel = tiny_pair
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        bench.main(argv(tmp_path / "a", db, extra=["--mesh-dp", "2"]), model=tmodel)
    (tmp_path / "orbax" / "100").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="convert.state_dict_from_jax"):
        bench.main(argv(tmp_path / "b", db, extra=["--ckpt", str(tmp_path / "orbax")]), model=tmodel)

    trained = copy.deepcopy(tmodel)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in trained.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 1e-2)
    ema = LitEma(trained.unet)
    for v in ema.shadow.values():
        v.mul_(0.5)
    state = TrainState(12, trained, None, ema)
    CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2).save(12, state)
    for use_ema in (False, True):
        loaded = copy.deepcopy(tmodel)
        extra = ["--ckpt", str(tmp_path / "ckpt"), "--max_batches", "0", f"model.params.use_ema={use_ema}"]
        bench.main(argv(tmp_path / f"c{use_ema}", db, extra=extra), model=loaded)
        for k, v in loaded.state_dict().items():
            name = k[len(tdiff.UNET_PREFIX):]
            want = ema.shadow[name] if use_ema and k.startswith(tdiff.UNET_PREFIX) else trained.state_dict()[k]
            assert torch.equal(v, want), k


def test_cuda_is_the_default_device():
    """Without --device the bench asks for CUDA, and with no card it raises
    rather than moving to the CPU."""
    assert bench.parse_args(["--config", CFG_512]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench.main(["--config", CFG_512, "--max_batches", "0"])


def test_chip_smoke_config_dict_is_the_yaml():
    """chip_smoke hands the bench this dict where PyYAML is not installed."""
    assert chip_smoke.BENCH_CONFIG == tconfig.load_config([CFG_512])


def test_object_without_edit_region_fails_in_both_benches(tmp_path):
    """A fault of the JAX reference, kept by the port (ROADMAP queue 3): the
    synthetic builder marks every object camera-visible, and at 320 x 180
    one object's box misses its camera's frame; its edit mask is then
    empty, and both benches' composite_camera fail on it."""
    small = build_synthetic_database(str(tmp_path / "db"), img_w=320, img_h=180, seed=0)
    params = tconfig.load_config([CFG_512], overrides(small, "test", size=64))["data"]["params"]["test"]["params"]
    ds = JaxDataset(**{**params, "num_samples_per_class": 4}, return_original_image=True)
    unseen = [s for s in (ds[i] for i in range(len(ds))) if not (s["image"]["orig"]["mask"] == 0).any()]
    assert unseen and unseen[0]["id_name"].startswith("sample-scene0001_track-scene0001_obj2")
    batch = jcollate(unseen[:1])
    cam = np.zeros((1, 64, 64, 3), np.float32)
    opt = bench.parse_args(["--config", CFG_512])
    for d in ("p", "j"):
        os.makedirs(tmp_path / d)
    with pytest.raises(ValueError):
        bench.composite_camera(cam[0], batch, 0, str(tmp_path / "p"), str(tmp_path / "p"), "x", opt)
    with pytest.raises(ValueError):
        jbench.composite_camera(cam[0], batch, 0, str(tmp_path / "j"), str(tmp_path / "j"), "x", opt,
                                RecordingCv2(str(tmp_path / "j")))
