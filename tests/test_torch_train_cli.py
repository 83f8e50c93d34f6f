"""The port's training CLI (mobi_tpu_torch/train.py) and what it reaches:
activation remat, validation, the image logger's collage, the seeded init,
the zero-init knob, the lidar auto-load and the refusals, against the JAX
package on the tiny config of tests/test_diffusion.py, on the CPU; then the
CLI end to end with --platform cpu and a bitwise --resume.

The CLI builds its model from a YAML: `tiny_yaml` writes one that gives the
tiny MobiConfig in both packages (the CLIP width and crop size are not YAML
keys in either, so the CLI is handed a small conditioning stage of the
default width). Tolerances: remat against no remat 1e-6 of the largest
gradient; against JAX as tests/test_torch_training.py holds gradients
(rtol 1e-3, atol 1e-4 of the largest) and losses (rtol 1e-5); the init's
per-tensor std within 10% of JAX's; everything else exact.
"""
import dataclasses
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import train as jtrain
from mobi_tpu import import_torch as jimport
from mobi_tpu import training as jtraining
from mobi_tpu import viz as jviz
from mobi_tpu.models.diffusion import MobiDiffusion as JaxMobi
from mobi_tpu.models.ema import EmaState
from mobi_tpu.parallel.mesh import create_mesh
from mobi_tpu.utils import config as jconfig
from mobi_tpu_torch import checkpoint as tckpt
from mobi_tpu_torch import convert
from mobi_tpu_torch import train
from mobi_tpu_torch import training as ttraining
from mobi_tpu_torch import viz
from mobi_tpu_torch.data.synthetic import build_synthetic_database
from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.models.ema import LitEma
from mobi_tpu_torch.models.encoders import CondStageModel
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops import distributions as tdist
from mobi_tpu_torch.utils import config as tconfig
from tests.test_diffusion import TINY, TinyCondStage
from tests.test_torch_models import few_torch_threads, numpy_batch, port_config, random_params, tiny_cond_stage  # noqa: F401
from tests.test_torch_checkpoint import _JaxSaves
from tests.test_torch_training import injected, jax_loss, to_port_names

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_512 = os.path.join(ROOT, "configs", "mobi_nusc_512.yaml")
SCHEDULER = "ldm.lr_scheduler.LambdaLinearScheduler"


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


@pytest.fixture
def posterior_mode(monkeypatch):
    monkeypatch.setattr(tdist.DiagonalGaussian, "sample", lambda self, generator=None: self.mode())


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """The port's synthetic database at its default size (PNG frames)."""
    return build_synthetic_database(str(tmp_path_factory.mktemp("db")), seed=0)


def tiny_yaml(path, db, scheduler=SCHEDULER, use_ema=True):
    """configs/mobi_nusc_512.yaml cut to the tiny config (fp32), its train
    and validation splits on `db` with two objects a class (the range view
    64 wide: the lidar metrics pool each crop to a window of at least 64
    columns), written to `path`."""
    cfg = tconfig.load_config([CFG_512])
    cfg.update(image_height=32, image_width=32, range_height=32, range_width=32, latent_size=8, precision="fp32")
    mp = cfg["model"]["params"]
    mp.update(image_size=8, use_ema=use_ema)
    mp["scheduler_config"]["target"] = scheduler
    mp["unet_config"]["params"].update(model_channels=32, channel_mult=[1, 2], num_res_blocks=1,
                                       attention_resolutions=[2, 1], num_heads=4, context_dim=64)
    for k in ("first_stage_config", "lidar_stage_config"):
        mp[k]["params"]["ddconfig"].update(ch=16, ch_mult=[1, 1, 2], num_res_blocks=1, resolution=32)
    data = cfg["data"]["params"]
    for split in ("test", "rotation_test"):
        data.pop(split)
    for split in ("train", "validation"):
        data[split]["params"].update(db, image_height=32, image_width=32, range_height=32, range_width=64,
                                     num_samples_per_class=2)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def cli_cond_stage():
    """A one-layer conditioning stage of the default CLIP width (1024, what
    proj_out takes) at the dataset's 224 px crops, patch 56."""
    return CondStageModel(clip_width=1024, clip_image_size=224, clip_patch_size=56, clip_layers=1, clip_heads=16,
                          mapper_layers=1, bbox_proj_dims=(64, 48, 48, 64))


def test_tiny_yaml_gives_the_tiny_config(tmp_path, db):
    cfg = tconfig.load_config([tiny_yaml(tmp_path / "tiny.yaml", db)])
    skip = {"clip_width", "ref_image_size", "dtype", "unet_use_checkpoint", "vae_use_checkpoint"}
    want = {f.name: getattr(TINY, f.name) for f in dataclasses.fields(TINY) if f.name not in skip}
    got_jax = jconfig.mobi_config_from_yaml(cfg)
    got = tconfig.mobi_config_from_yaml(cfg)
    for name, value in want.items():
        assert getattr(got_jax, name) == value, name
        if hasattr(got, name):
            assert getattr(got, name) == (tuple(value) if isinstance(value, list) else value), name
    assert got.dtype == torch.float32 and not got.unet_use_checkpoint and not got.vae_use_checkpoint


def test_parse_args_matches_jax():
    argv = ["--base", "a.yaml", "b.yaml", "--seed", "3", "--scale_lr", "--max_steps", "7", "--save_top_k", "2",
            "--profile-dir", "p", "--optimizer", "adafactor", "--platform", "cpu", "x.y=1"]
    got, got_rest = train.parse_args(argv)
    want, want_rest = jtrain.parse_args(argv)
    assert vars(got) == vars(want) and got_rest == want_rest == ["x.y=1"]


# ----------------------------------------------------------------- remat
@pytest.fixture(scope="module")
def jax_pair():
    jmodel = JaxMobi(dataclasses.replace(TINY, unet_use_checkpoint=True))
    jmodel.cond_model = TinyCondStage(conditions=("ref_image", "ref_bbox"))
    params_np = random_params(jmodel, seed=3)
    return jmodel, jax.tree.map(jnp.asarray, params_np), params_np


def port_model(params_np, **cfg):
    model = tdiff.MobiDiffusion(dataclasses.replace(port_config(TINY), **cfg), device="cpu",
                                cond_stage_model=tiny_cond_stage(), for_training=True)
    model.load_jax_params(params_np)
    return model


def trainable_grads(model, batch, t, noise, drop):
    ttraining.create_train_state(model, device="cpu")
    loss, _ = model.training_loss(numpy_batch(batch), t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise),
                                  drop=drop)
    loss.backward()
    return loss.item(), {n: p.grad.numpy().copy() for n, p in model.named_parameters() if p.requires_grad}


@pytest.fixture(scope="module")
def jax_remat_grads(jax_pair):
    """JAX's trainable gradients with every UNet block remat'd."""
    jmodel, params, _ = jax_pair
    t, noise, batch = injected()
    (jl, _), jgrads = jax.jit(jax.value_and_grad(jax_loss(jmodel, t, noise, True), has_aux=True))(params, batch)
    return float(jl), to_port_names(jax.tree.map(np.asarray, jgrads))


@pytest.mark.parametrize("use_checkpoint", [True, "transformer"])
def test_remat_gradients_match(jax_pair, jax_remat_grads, use_checkpoint, posterior_mode, monkeypatch):
    """Recomputing every block (True) or the transformers only: the loss and
    the trainable gradients equal the port's without remat within 1e-6, and
    JAX's remat'd ones as tests/test_torch_training.py holds gradients; the
    recomputed forward runs each remat'd transformer's attentions again."""
    _, _, params_np = jax_pair
    t, noise, batch = injected()
    base_loss, base = trainable_grads(port_model(params_np), batch, t, noise, True)
    from mobi_tpu_torch.models import unet as tunet

    calls = {"transformer": 0}
    forward = tunet.SpatialTransformer.forward

    def counted(self, x, context):
        calls["transformer"] += 1
        return forward(self, x, context)

    monkeypatch.setattr(tunet.SpatialTransformer, "forward", counted)
    model = port_model(params_np, unet_use_checkpoint=use_checkpoint)
    loss, got = trainable_grads(model, batch, t, noise, True)
    assert calls["transformer"] == 2 * sum(isinstance(m, tunet.SpatialTransformer) for m in model.modules())
    scale = max(np.abs(g).max() for g in base.values())
    assert loss == pytest.approx(base_loss, rel=1e-6)
    assert got.keys() == base.keys()
    for name in base:
        assert np.abs(got[name] - base[name]).max() <= 1e-6 * scale, name
    jl, want = jax_remat_grads
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3, atol=1e-4 * scale, err_msg=name)


def test_vae_remat_gradients_match():
    """vae_use_checkpoint: the gradients of a reconstruction loss through a
    lidar VAE's encoder and decoder equal those without remat within 1e-6."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 2, 32, 32)).astype(np.float32))
    grads = []
    for remat in (False, True):
        model = tdiff.MobiDiffusion(dataclasses.replace(port_config(TINY), vae_use_checkpoint=remat), device="cpu",
                                    seed=2, cond_stage_model=tiny_cond_stage())
        vae = model.lidar_stage_model
        loss = (vae.decode(vae.encode(x).mode()) - x).abs().mean()
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in vae.named_parameters()})
    scale = max(float(g.abs().max()) for g in grads[0].values())
    assert all(float((grads[1][n] - g).abs().max()) <= 1e-6 * scale for n, g in grads[0].items())


def test_bad_use_checkpoint_raises_jax_text():
    jmodel = JaxMobi(dataclasses.replace(TINY, unet_use_checkpoint="transfomer"))
    x, t, ctx = jnp.zeros((2, 8, 8, 9)), jnp.zeros((2,), jnp.int32), jnp.zeros((2, 2, 64))
    with pytest.raises(ValueError) as want:
        jax.eval_shape(lambda: jmodel.unet.init(jax.random.PRNGKey(0), x, t, ctx))
    model = tdiff.MobiDiffusion(dataclasses.replace(port_config(TINY), unet_use_checkpoint="transfomer"),
                                device="cpu", cond_stage_model=tiny_cond_stage())
    with pytest.raises(ValueError) as got:
        model.unet(torch.zeros(2, 9, 8, 8), torch.zeros(2, dtype=torch.long), torch.zeros(2, 2, 64))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ validation
def test_validate_matches_jax(jax_pair, posterior_mode, monkeypatch):
    """Two batches, two draws a batch, live and EMA weights: the port's
    validate gives JAX's val/loss_simple and val/loss_simple_ema, with
    the draws injected in the same order on both sides (each weight set
    sees draws 0 and 1) and the encodes at the posterior mode."""
    jmodel, params, params_np = jax_pair
    draws = [injected(seed=40 + i) for i in range(2)]
    drops = [False, True]
    batches = [injected(seed=50 + i)[2] for i in range(2)]
    rng = np.random.default_rng(6)
    ema_np = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), params_np["unet"])

    count = itertools.count()

    def jax_training_loss(p, b, key):
        i = next(count) % 2
        return jax_loss(jmodel, draws[i][0], draws[i][1], drops[i])(p, b)

    monkeypatch.setattr(jmodel, "training_loss", jax_training_loss)
    jstate = jtraining.TrainState(step=jnp.zeros((), jnp.int32), params=params, opt_state=None,
                                  ema=EmaState(jax.tree.map(jnp.asarray, ema_np), jnp.zeros((), jnp.int32)))
    mesh = create_mesh(devices=jax.devices("cpu")[:1])
    want = jtrain.validate(jmodel, jstate, batches, lambda b: b, mesh, jax.random.PRNGKey(0), t_draws=2)

    model = port_model(params_np)
    ema = LitEma(model.unet)
    shadow = {k[len(tdiff.UNET_PREFIX):]: v for k, v in to_port_names({**params_np, "unet": ema_np}).items()
              if k.startswith(tdiff.UNET_PREFIX)}
    for name, value in shadow.items():
        ema.shadow[name].copy_(torch.from_numpy(value))
    state = ttraining.TrainState(0, model, None, ema)
    port_count = itertools.count()
    loss_fn = model.training_loss

    def port_training_loss(b, generator):
        i = next(port_count) % 2
        t, noise, _ = draws[i]
        return loss_fn(b, generator, t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise), drop=drops[i])

    model.training_loss = port_training_loss
    got = train.validate(model, state, [numpy_batch(b) for b in batches], lambda b: b, torch.Generator(),
                         t_draws=2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert got["val/loss_simple"] != got["val/loss_simple_ema"]
    assert next(port_count) == 8  # 2 batches x 2 draws x (live, EMA)


def test_camera_log_collage_equals_jax():
    """Rows of other sizes (nearest resize), grey and one-channel rows, a
    uint8 row: the same pixels as the JAX package's (cv2) collage."""
    rng = np.random.default_rng(1)
    rows = [rng.uniform(-1.2, 1.2, (32, 48, 3)).astype(np.float32), rng.uniform(-1, 1, (13, 21)),
            rng.uniform(-1, 1, (20, 48, 1)).astype(np.float32), rng.integers(0, 256, (32, 48, 3), dtype=np.uint8),
            rng.uniform(-1, 1, (40, 30, 3)).astype(np.float32)]
    for case in (rows[:1], rows[:2], rows, rows[3:]):
        np.testing.assert_array_equal(viz.camera_log_collage(case), jviz.camera_log_collage(case))


# ------------------------------------------------------------- the init
@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's init of the tiny model (flax initializers, the
    reference's zero layers), as port names. Drawn with JAX's RBG key, which
    compiles in half the time of threefry: the tests read the initializers'
    distributions and zeros, not the values."""
    jmodel = JaxMobi(TINY)
    jmodel.cond_model = TinyCondStage(conditions=("ref_image", "ref_bbox"))
    key = jax.random.key(0, impl="unsafe_rbg")
    params = jax.tree.map(np.asarray, jax.jit(jmodel._init_params_impl)(key))
    return params, to_port_names(params)


def test_seeded_init_std_matches_jax(jax_init):
    """The model the CLI trains from scratch (seeded, the reference's zero
    layers zeroed): every tensor of 1000 or more elements has JAX's std
    within 10% (proj_out and CLIP's patch embedding drew std / sqrt(3)
    before the port followed JAX's initializers for them)."""
    _, want = jax_init
    model = tdiff.MobiDiffusion(port_config(TINY), device="cpu", seed=0, cond_stage_model=tiny_cond_stage())
    model.zero_init_reference_layers_()
    checked = 0
    for name, value in model.state_dict().items():
        if value.numel() < 1000:
            continue
        got, ref = float(value.double().std()), float(np.std(want[name], ddof=1))
        assert abs(got - ref) <= 0.1 * ref, (name, got, ref)
        checked += 1
    assert checked > 50


def test_zero_init_knob_over_the_whole_tree_counts_as_jax(jax_init):
    """MOBI_RANDOMIZE_ZERO_INIT over the whole model: from JAX's initial
    weights the port perturbs the tensors train.py's tree map perturbs
    (every all-zero >= 2-D leaf, train.py:237-251), and from the CLI's own
    from-scratch model as many."""
    params, _ = jax_init
    marks = jax.tree.map(lambda x: np.full(x.shape, float(x.ndim >= 2 and not np.any(x)), np.float32), params)
    want = {n for n, v in to_port_names(marks).items() if v.size and v.flat[0] == 1.0}
    model = tdiff.MobiDiffusion(port_config(TINY), device="cpu", cond_stage_model=tiny_cond_stage())
    model.load_jax_params(params)
    got = ttraining.randomize_zero_init(model, seed=23)
    assert set(got) == want and len(want) > 10
    fresh = tdiff.MobiDiffusion(port_config(TINY), device="cpu", seed=23, cond_stage_model=tiny_cond_stage())
    fresh.zero_init_reference_layers_()
    assert len(ttraining.randomize_zero_init(fresh, seed=23)) == len(want)


# ------------------------------------------------------- lidar auto-load
def test_lidar_ckpt_path_autoload_and_warning(tmp_path, jax_pair, capsys):
    """lidar_stage_config.params.ckpt_path: a bare AutoencoderKL checkpoint
    and a whole model's lidar_stage_model.* overlay the lidar VAE as JAX's
    import does (every other weight kept); a missing file prints JAX's
    warning and changes nothing."""
    _, _, params_np = jax_pair
    model = port_model(params_np)
    rng = np.random.default_rng(2)
    vae_sd = {k: (v + torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32)))
              for k, v in model.lidar_stage_model.state_dict().items()}
    files = {"bare": {"state_dict": vae_sd},
             "whole": {"lidar_stage_model." + k: v for k, v in vae_sd.items()}
             | {"first_stage_model.conv_out.weight": torch.zeros(1)}}
    for name, content in files.items():
        path = tmp_path / f"{name}.ckpt"
        torch.save(content, path)
        dd = {"ch_mult": [1, 1, 2], "num_res_blocks": 1, "resolution": 32, "lidar_adapter": True}
        cfg = {"model": {"params": {"use_lidar": True,
                                    "lidar_stage_config": {"params": {"ckpt_path": str(path), "ddconfig": dd}}}}}
        want = to_port_names(jimport.import_lidar_stage_from_config(cfg, jax.tree.map(np.array, params_np)))
        model = port_model(params_np)
        assert convert.import_lidar_stage_from_config(cfg, model)
        got = model.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    capsys.readouterr()
    cfg = {"model": {"params": {"use_lidar": True,
                                "lidar_stage_config": {"params": {"ckpt_path": str(tmp_path / "none.ckpt")}}}}}
    jimport.import_lidar_stage_from_config(cfg, {})
    want = capsys.readouterr().out
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not convert.import_lidar_stage_from_config(cfg, model)
    assert capsys.readouterr().out == want and want.startswith("WARNING: lidar_stage_config")
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


# ---------------------------------------------------------- the refusals
def test_shipped_scheduler_target_raises_before_the_model(tmp_path, db, monkeypatch):
    """The shipped configs' scheduler target raises JAX's ValueError in the
    CLI, before any model is built."""
    path = tiny_yaml(tmp_path / "tiny.yaml", db, scheduler="mobi_tpu.training.lambda_linear_schedule")
    cfg = jconfig.load_config([path])
    with pytest.raises(ValueError) as want:
        jtraining.schedule_from_config(8e-5, cfg["model"]["params"]["scheduler_config"])

    def no_model(*a, **k):
        raise AssertionError("the model was built")

    monkeypatch.setattr(train, "MobiDiffusion", no_model)
    with pytest.raises(ValueError) as got:
        train.main(["--base", path, "--logdir", str(tmp_path / "logs"), "--platform", "cpu", "--max_steps", "1"])
    assert str(got.value) == str(want.value) and "unknown scheduler target" in str(got.value)


@pytest.mark.parametrize("flags", [["--fsdp", "2"], ["--coordinator", "localhost:1234"], ["--num_processes", "2"]])
def test_item6_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        train.main(["--base", CFG_512, "--logdir", str(tmp_path), "--platform", "cpu"] + flags)
    assert not os.listdir(tmp_path)


def test_cli_needs_cuda_unless_cpu(tmp_path):
    """Without --platform the CLI asks for CUDA: with no card it raises
    before it writes anything, rather than moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--base", CFG_512, "--logdir", str(tmp_path)])
    assert not os.listdir(tmp_path)


# ------------------------------------------------------ the CLI end to end
COMMON = ["--platform", "cpu", "--log_every", "1", "--val_every", "2", "--save_every", "2", "--image_log_every", "2",
          "--image_log_steps", "2", "--image_log_max", "2", "--save_top_k", "2", "--num_workers", "2"]


def test_cli_end_to_end_and_bitwise_resume(tmp_path, db, monkeypatch):
    """4 steps (validation, a save and collages at 2 and 4), then --resume
    to 6: the restored model, optimizer, EMA shadow and step are the saved
    ones bit for bit; metrics.jsonl holds every step; the retained
    checkpoints are orbax's under the same saves; convert.load_checkpoint
    of the directory gives the last checkpoint's weights."""
    monkeypatch.setenv("MOBI_RANDOMIZE_ZERO_INIT", "1")
    path = tiny_yaml(tmp_path / "tiny.yaml", db)
    stats = train.main(["--base", path, "--logdir", str(tmp_path / "logs"), "--max_steps", "4"] + COMMON,
                       cond_stage_model=cli_cond_stage())
    logdir = stats["logdir"]
    assert stats["step"] == 4 and os.path.exists(os.path.join(logdir, "configs", "merged.yaml"))
    saved = tckpt.read_step(os.path.join(stats["ckpt_dir"], "4"))
    assert saved["step"] == 4

    restored = {}
    restore = tckpt.CheckpointManager.restore

    def spy(self, step=None, state=None):
        out = restore(self, step, state)
        restored.update(step=state.step, model={k: v.clone() for k, v in state.model.state_dict().items()},
                        inner={i: {k: v.clone() for k, v in st.items()}
                               for i, st in state.opt.inner.state_dict()["state"].items()},
                        counts=(state.opt.count, state.opt.mini_step),
                        ema={k: v.clone() for k, v in state.ema.shadow.items()}, updates=state.ema.num_updates)
        return out

    monkeypatch.setattr(tckpt.CheckpointManager, "restore", spy)
    stats = train.main(["--resume", logdir, "--max_steps", "6"] + COMMON, cond_stage_model=cli_cond_stage())
    assert stats["step"] == 6 and restored["step"] == 4
    for k, v in saved["model"].items():
        assert restored["model"][k].dtype == v.dtype and torch.equal(restored["model"][k], v), k
    for k, v in saved["ema"]["shadow"].items():
        assert torch.equal(restored["ema"][k], v), k
    assert restored["updates"] == saved["ema"]["num_updates"] == 4
    assert restored["counts"] == (saved["optimizer"]["count"], saved["optimizer"]["mini_step"]) == (4, 0)
    for i, st in saved["optimizer"]["inner"]["state"].items():
        for key, v in st.items():
            assert torch.equal(restored["inner"][i][key], v), (i, key)

    records = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    train_recs = [r for r in records if "train/loss" in r]
    assert [r["train/step"] for r in train_recs] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(r["train/loss"]) and r["train/grad_norm"] > 0 for r in train_recs)
    vals = [r for r in records if "val/loss_simple" in r]
    assert [r["step"] for r in vals] == [2, 4, 6]
    assert all(np.isfinite(r["val/loss_simple"]) and r["val/loss_simple_ema"] != r["val/loss_simple"] for r in vals)
    assert [r["step"] for r in records if any(k.startswith("imagelog/") for k in r)] == [2, 4, 6]
    images = os.listdir(os.path.join(logdir, "images"))
    for step in (2, 4, 6):
        for stem in ("cam0", "cam1", "range_depth0", "range_depth1", "range_intensity0", "range_intensity1"):
            assert f"step{step:08d}_{stem}.png" in images

    # orbax under the JAX package's options, fed the same saves: each run's
    # validation saves, then its final save without metrics (which raises
    # in orbax's ranking when the last validation's checkpoint was dropped;
    # the port's CLI warns there, the JAX CLI stops)
    mon = "val/loss_simple"
    jax_dir = str(tmp_path / "orbax")
    for run in (vals[:2], vals[2:]):
        saves = _JaxSaves(jax_dir, 2, mon)
        for r in run:
            saves.save(r["step"], {mon: r[mon]})
        saves.save(run[-1]["step"], None)
    mgr = tckpt.CheckpointManager(stats["ckpt_dir"])
    assert (mgr.all_steps(), mgr.latest_step()) == saves.steps() and mgr.latest_step() == 6

    model = tdiff.MobiDiffusion(tconfig.mobi_config_from_yaml(tconfig.load_config([path])), device="cpu", seed=1,
                                cond_stage_model=cli_cond_stage())
    info = convert.load_checkpoint(model, stats["ckpt_dir"])
    last = tckpt.read_step(os.path.join(stats["ckpt_dir"], "6"), parts=("model",))["model"]
    # the last step is kept whatever its validation loss: ranked and kept, or
    # written again without metrics by the final save
    assert info["step"] == 6 and not info["missing"]
    assert all(torch.equal(v, last[k]) for k, v in model.state_dict().items())
