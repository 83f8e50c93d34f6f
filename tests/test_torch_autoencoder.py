"""The port's range-VAE finetuning and checkpoint CLIs
(mobi_tpu_torch/train_autoencoder.py, extract_autoencoder.py,
export_checkpoint.py) against the JAX package on the CPU, in fp32, at a
tiny ddconfig with the lidar adapter.

The training step is held against a JAX step assembled from
mobi_tpu.models.losses and optax as scripts/train_autoencoder.py:104-196
assembles it inside its main() (copied below, the posterior's draw
replaced by injected noise: jax.random and torch draws never match). The
exporter is held against mobi_tpu.export_torch.export_from_config.
Tolerances are stated in each test.
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from mobi_tpu.export_torch import export_from_config
from mobi_tpu.import_torch import import_mobi_checkpoint
from mobi_tpu.models import losses as jlosses
from mobi_tpu.models.diffusion import MobiDiffusion as JaxMobi
from mobi_tpu.models.vae import AutoencoderKL as JaxVAE
from mobi_tpu.utils import config as jconfig
from mobi_tpu_torch import checkpoint as tckpt
from mobi_tpu_torch import convert, export_checkpoint, extract_autoencoder
from mobi_tpu_torch import train_autoencoder as tae
from mobi_tpu_torch.data.synthetic import build_synthetic_database
from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.models.vae import autoencoder_from_config
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.utils import config as tconfig
from tests.test_diffusion import TINY
from tests.test_torch_models import few_torch_threads, port_config, tiny_cond_stage  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AE_YAML = os.path.join(ROOT, "configs", "range_autoencoder.yaml")
CFG_512 = os.path.join(ROOT, "configs", "mobi_nusc_512.yaml")
DD = dict(double_z=True, z_channels=4, resolution=32, in_channels=2, out_ch=2, ch=64, ch_mult=[1, 2],
          num_res_blocks=1, attn_resolutions=[], lidar_adapter=True, dropout=0.0)
LOSS = dict(kl_weight=1.0e-6, disc_weight=0.5, disc_in_channels=2)
LR = 2e-4


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def port_vae(vae_params):
    with torch.device("cpu"):
        vae = autoencoder_from_config(embed_dim=4, ddconfig=DD)
    vae.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in to_port(vae_params).items()}, strict=True)
    return vae


def to_port(vae_params):
    return convert.vae_state_dict_numpy(vae_params, ch_mult=DD["ch_mult"], num_res_blocks=DD["num_res_blocks"],
                                        resolution=DD["resolution"], lidar_adapter=True)


# --------------------------------------------- JAX's step (scripts/train_autoencoder.py)
def jax_train_step(vae, loss, lr):
    """scripts/train_autoencoder.py:104-196 with `posterior.sample(key)`
    replaced by mean + std * noise, jitted without donation."""
    def mask_fn(params):
        return jax.tree_util.tree_map_with_path(
            lambda kp, _: any("lidar" in str(getattr(k, "key", k)) for k in kp), params)

    def make(vae_params):
        g_mask = mask_fn(vae_params)
        tx_g = optax.chain(optax.masked(optax.set_to_zero(), jax.tree_util.tree_map(lambda m: not m, g_mask)),
                           optax.masked(optax.adam(lr, b1=0.5, b2=0.9), g_mask))
        tx_d = optax.adam(lr, b1=0.5, b2=0.9)
        return g_mask, tx_g, tx_d

    def last_conv(vp):
        dec = vp["decoder"]
        name = "conv_out_lidar" if "conv_out_lidar" in dec else "conv_out"
        return dec[name]["Conv_0"], name

    def g_loss_fn(vp, lp, batch_x, noise, step):
        posterior = vae.apply({"params": vp}, batch_x, method=vae.encode)
        z = posterior.mean + posterior.std * noise
        rec, h_pre = vae.apply({"params": vp}, z, True, method=vae.decode)
        h_sg = jax.lax.stop_gradient(h_pre)
        post_sg = jax.tree_util.tree_map(jax.lax.stop_gradient, posterior)
        conv, name = last_conv(vp)
        bias_sg = jax.lax.stop_gradient(conv["bias"])

        def rec_of_kernel(k):
            out = jax.lax.conv_general_dilated(h_sg, k, window_strides=(1, 1), padding="SAME",
                                               dimension_numbers=("NHWC", "HWIO", "NHWC"))
            return out + bias_sg

        def nll_of_kernel(k):
            rec2 = rec_of_kernel(k)
            nll, _, _ = loss.nll_and_kl(lp, batch_x, rec2, post_sg)
            logits_fake = loss.discriminator.apply({"params": lp["discriminator"]}, rec2)
            return nll, -jnp.mean(logits_fake)

        k0 = conv["kernel"]
        nll_g = jax.grad(lambda k: nll_of_kernel(k)[0])(k0)
        gan_g = jax.grad(lambda k: nll_of_kernel(k)[1])(k0)
        total, log = loss.generator_loss(lp, batch_x, rec, posterior, step, last_layer_grads=(nll_g, gan_g))
        return total, (log, rec)

    def d_loss_fn(dp, lp, batch_x, rec, step):
        return loss.discriminator_loss({**lp, "discriminator": dp}, batch_x, rec, step)

    def build(vae_params):
        g_mask, tx_g, tx_d = make(vae_params)

        @jax.jit
        def train_step(vp, lp, og, od, batch_x, noise, step):
            (gl, (log, rec)), grads = jax.value_and_grad(g_loss_fn, has_aux=True)(vp, lp, batch_x, noise, step)
            upd, og = tx_g.update(grads, og, vp)
            vp = optax.apply_updates(vp, upd)
            (dl, dlog), dgrads = jax.value_and_grad(d_loss_fn, has_aux=True)(lp["discriminator"], lp, batch_x,
                                                                             rec, step)
            dupd, od = tx_d.update(dgrads, od, lp["discriminator"])
            lp = {**lp, "discriminator": optax.apply_updates(lp["discriminator"], dupd)}
            return vp, lp, og, od, {**log, **dlog}

        return g_mask, tx_g, tx_d, train_step

    return build


@pytest.fixture(scope="module")
def jax_ae():
    """JAX's tiny range VAE (lidar adapter) and range loss, initialised by
    flax; the batch and the injected noise of two steps."""
    vae = JaxVAE(embed_dim=4, ch=DD["ch"], ch_mult=tuple(DD["ch_mult"]), num_res_blocks=DD["num_res_blocks"],
                 resolution=DD["resolution"], z_channels=4, out_ch=2, lidar_adapter=True)
    rng = jax.random.PRNGKey(23)
    x0 = jnp.zeros((1, 32, 32, 2))
    vae_params = jax.tree.map(np.asarray, jax.jit(lambda r: vae.init(r, x0, r)["params"])(rng))
    data = np.random.default_rng(9)
    x = data.uniform(-1, 1, (2, 32, 32, 2)).astype(np.float32)
    noise = [data.normal(0, 1, (2, 16, 16, 4)).astype(np.float32) for _ in range(2)]
    # one loss and one compiled step for every disc_start: the JAX losses
    # read the step only through adopt_weight(., step, disc_start), so the
    # step a test passes is its own less its disc_start
    loss = jlosses.LidarWithDiscriminator(disc_start=0, **LOSS)
    lp = jax.tree.map(np.asarray, jax.jit(lambda r: loss.init_params(r, spatial=32))(jax.random.PRNGKey(5)))
    return {"vae": vae, "vae_params": vae_params, "x": x, "noise": noise, "loss": loss, "loss_params": lp,
            "step": jax_train_step(vae, loss, LR)(vae_params)}


def check_updates(got, want, start):
    """The updates of the tensors in `want` against JAX's: within 1e-2
    relative L2, and at most 1e-4 of their elements off by more than a
    tenth of the lr. Adam's first updates are near lr * g / |g|, so an
    element whose gradient is rounding noise takes either sign (one of
    3.3e5 here, in decoder.res_block_lidar1.conv2, at step 0); every other
    element agrees to float rounding."""
    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum((want[k] - start[k]) ** 2)) for k in want)
    off = sum(int(np.sum(np.abs(got[k] - want[k]) > 0.1 * LR)) for k in want)
    n = sum(want[k].size for k in want)
    assert np.sqrt(num / den) <= 1e-2 and off <= 1e-4 * n, (np.sqrt(num / den), off, n)


@pytest.mark.parametrize("disc_start", [0, 1])
def test_gan_steps_match_the_jax_script(jax_ae, disc_start):
    """Two steps of GanStep (remat on) against the JAX script's step (one
    compile, the step passed less disc_start) on the
    same weights, batch and noise, with disc_start 0 (the adaptive weight
    and the discriminator step run from step 0) and 1 (step 0 gated):
    every logged value of each step within 1e-4 relative (the losses are
    sums of 2048 residuals; d_weight a ratio of two gradient norms); the
    trainable set equal to the JAX mask; every frozen VAE parameter and,
    while gated, every discriminator parameter bitwise at its start; the
    trained ones' updates as `check_updates` holds them after each step.
    The ddconfig is 64 wide, so each GroupNorm group holds two channels
    (at 16 or 32 each conv bias before a norm has a gradient of pure
    rounding noise, which Adam turns into updates of either sign)."""
    vp, lp = jax_ae["vae_params"], jax_ae["loss_params"]
    g_mask, tx_g, tx_d, jstep = jax_ae["step"]
    og, od = tx_g.init(vp), tx_d.init(lp["discriminator"])

    vae = port_vae(vp)
    tl = tae.build_loss({"params": dict(LOSS, disc_start=disc_start)}, 2, seed=0)
    tl.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in convert.loss_state_dict_numpy(lp).items()})
    step_fn = tae.GanStep(vae, tl, LR)
    marks = to_port(jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), g_mask, vp))
    want_set = {k for k, v in marks.items() if v.size and v.flat[0] == 1.0}
    assert set(tae.trainable_names(vae)) == want_set and len(want_set) == 40

    start_vae, start_d = to_port(vp), convert.loss_state_dict_numpy(lp)
    jv, jlp = vp, lp
    for step in range(2):
        jv, jlp, og, od, jlog = jstep(jv, jlp, og, od, jnp.asarray(jax_ae["x"]), jnp.asarray(jax_ae["noise"][step]),
                                      jnp.asarray(step - disc_start))
        log = step_fn(nchw(jax_ae["x"]), step, noise=nchw(jax_ae["noise"][step]))
        assert set(log) == set(jlog)
        for key in jlog:
            np.testing.assert_allclose(float(log[key]), float(jlog[key]), rtol=1e-4, atol=1e-6, err_msg=(step, key))
        gated = step < disc_start
        assert float(log["train/d_weight"]) > 0 and float(log["train/disc_factor"]) == (0.0 if gated else 1.0)
        got_v = {k: v.detach().numpy() for k, v in vae.state_dict().items()}
        want_v = to_port(jax.tree.map(np.asarray, jv))
        for k in got_v:
            if k not in want_set:
                np.testing.assert_array_equal(got_v[k], start_vae[k], err_msg=k)
        check_updates(got_v, {k: want_v[k] for k in want_set}, start_vae)
        got_d = {k: v.detach().numpy() for k, v in tl.state_dict().items()}
        want_d = convert.loss_state_dict_numpy(jax.tree.map(np.asarray, jlp))
        np.testing.assert_array_equal(got_d["logvar"], start_d["logvar"])
        moved = {k for k in want_d if not np.array_equal(want_d[k], start_d[k])}
        if step < disc_start:
            assert not moved
            for k in got_d:
                np.testing.assert_array_equal(got_d[k], start_d[k], err_msg=k)
        else:
            assert moved
            check_updates(got_d, {k: want_d[k] for k in moved}, start_d)


@pytest.fixture(scope="module")
def tiny_model():
    """The port's tiny model (tests/test_diffusion.py TINY), seeded."""
    return tdiff.MobiDiffusion(port_config(TINY), device="cpu", seed=3, cond_stage_model=tiny_cond_stage())


# ------------------------------------------------------------------- the CLI
def ae_yaml(path, db, **loss):
    """configs/range_autoencoder.yaml at the tiny ddconfig, 32 x 32 range
    views of `db`, batch 2."""
    cfg = tconfig.load_config([AE_YAML])
    cfg.update(image_height=32, image_width=32, range_height=32, range_width=32, batch_size=2)
    mp = cfg["model"]["params"]
    mp["ddconfig"] = dict(DD)
    mp["lossconfig"]["params"].update(loss)
    data = cfg["data"]["params"]
    data["batch_size"] = 2
    data.pop("validation")
    data["train"]["params"].update(db, num_samples_per_class=2, image_height=32, image_width=32, range_height=32,
                                   range_width=32)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A 3-step CLI run (disc_start 1: step 0 gated) from a saved Stable
    Diffusion-like VAE: no adapter keys, plus a loss entry and the plain
    conv_in the adapter replaces."""
    d = tmp_path_factory.mktemp("ae")
    db = build_synthetic_database(str(d / "db"), seed=0)
    with torch.device("cpu"):
        sd_vae = autoencoder_from_config(embed_dim=4, ddconfig=dict(DD, lidar_adapter=False)).init_random_(7)
    pre = {k: v for k, v in sd_vae.state_dict().items()}
    pre["loss.logvar"] = torch.zeros(())
    torch.save({"state_dict": {f"first_stage_model.{k}": v for k, v in pre.items()}}, d / "sd_vae.ckpt")
    out = tae.main(["--base", ae_yaml(d / "ae.yaml", db, disc_start=1), "--logdir", str(d / "logs"),
                    "--max_steps", "3", "--log_every", "1", "--save_every", "2", "--num_workers", "1",
                    "--platform", "cpu", "--pretrained_model", str(d / "sd_vae.ckpt")])
    return {**out, "pretrained_sd": pre, "dir": d}


def test_cli_three_steps_from_a_pretrained_vae(cli_run):
    """metrics.jsonl holds each step with the JAX script's keys; the
    checkpoints at 2 and 3 hold vae.pt and loss.pt; the pretrained load
    left missing exactly the adapter and read no key beyond import_vae's;
    every frozen VAE parameter is bitwise the pretrained value, every
    adapter parameter moved, the lr is base_learning_rate x batch_size."""
    res = cli_run
    lines = [json.loads(s) for s in open(os.path.join(res["logdir"], "metrics.jsonl"))]
    keys = {f"train/{k}" for k in ("total_loss", "logvar", "kl_loss", "nll_loss", "rec_loss", "d_weight",
                                   "disc_factor", "g_loss", "disc_loss", "logits_real", "logits_fake")}
    assert [ln["step"] for ln in lines] == [1, 2, 3] and all(set(ln) == keys | {"step"} for ln in lines)
    assert [ln["train/disc_factor"] for ln in lines] == [0.0, 1.0, 1.0]
    assert all(np.isfinite(ln["train/total_loss"]) for ln in lines)
    assert sorted(os.listdir(res["ckpt_dir"])) == ["2", "3"]
    for s in ("2", "3"):
        assert sorted(os.listdir(os.path.join(res["ckpt_dir"], s))) == ["loss.pt", "meta.json", "vae.pt"]
    assert res["lr"] == pytest.approx(4.5e-6 * 2)
    adapter = set(res["trainable"])
    assert set(res["pretrained"]["missing"]) == adapter
    assert set(res["pretrained"]["unexpected"]) == {"loss.logvar", "encoder.conv_in.weight", "encoder.conv_in.bias",
                                                    "decoder.norm_out.weight", "decoder.norm_out.bias",
                                                    "decoder.conv_out.weight", "decoder.conv_out.bias"}
    saved = tckpt.read_step(os.path.join(res["ckpt_dir"], "3"), parts=("vae", "loss"))
    with torch.device("cpu"):
        init = autoencoder_from_config(embed_dim=4, ddconfig=DD).init_random_(23).state_dict()
    for k, v in saved["vae"].items():
        if k in adapter:
            assert not torch.equal(v, init[k]) or k.endswith("bias") or ".norm" in k, k
        else:
            assert torch.equal(v, res["pretrained_sd"][k]), k
    assert sum(not torch.equal(saved["vae"][k], init[k]) for k in adapter) >= 20


def test_load_pretrained_refuses_partial_adapters_and_strays(cli_run, tmp_path):
    pre = dict(cli_run["pretrained_sd"])
    with torch.device("cpu"):
        vae = autoencoder_from_config(embed_dim=4, ddconfig=DD)
    torch.save({**pre, "model.diffusion_model.out.2.weight": torch.zeros(1)}, tmp_path / "stray.pt")
    with pytest.raises(ValueError, match="unexpected"):
        tae.load_pretrained(vae, str(tmp_path / "stray.pt"))
    torch.save({**pre, "encoder.conv_in_lidar.weight": vae.encoder.conv_in_lidar.weight.detach()},
               tmp_path / "partial.pt")
    with pytest.raises(ValueError, match="missing"):
        tae.load_pretrained(vae, str(tmp_path / "partial.pt"))


def test_extract_then_load(cli_run, tiny_model, tmp_path):
    """extract_autoencoder of the CLI's directory (its vae part) loads
    strict into a fresh range VAE, bitwise, and as --pretrained_model with
    nothing missing or unexpected; of a whole model's checkpoint directory
    and of a Lightning file, each subtree loads strict into its module."""
    out = tmp_path / "vae.pt"
    sd = extract_autoencoder.main(["--ckpt", cli_run["ckpt_dir"], "--out", str(out)])
    with torch.device("cpu"):
        vae = autoencoder_from_config(embed_dim=4, ddconfig=DD)
    vae.load_state_dict(torch.load(out), strict=True)
    want = tckpt.read_step(os.path.join(cli_run["ckpt_dir"], "3"), parts=("vae",))["vae"]
    assert all(torch.equal(vae.state_dict()[k], v) for k, v in want.items())
    assert tae.load_pretrained(vae, str(out)) == {"missing": [], "unexpected": []}
    with pytest.raises(ValueError, match="only --subtree vae"):
        extract_autoencoder.read_subtree(cli_run["ckpt_dir"], "unet")

    model = tiny_model
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpts"))
    mgr.save(6, types.SimpleNamespace(model=model, opt=None, ema=None))
    torch.save({"state_dict": model.state_dict()}, tmp_path / "model.ckpt")
    for src in (str(tmp_path / "ckpts"), str(tmp_path / "model.ckpt")):
        for subtree, module in (("vae", model.first_stage_model), ("lidar_vae", model.lidar_stage_model),
                                ("unet", model.unet)):
            got = extract_autoencoder.read_subtree(src, subtree)
            module.load_state_dict(got, strict=True)
            assert all(torch.equal(module.state_dict()[k], v) for k, v in got.items())


# ------------------------------------------------------------------- export
def test_export_matches_export_from_config(tiny_model, tmp_path):
    """export_checkpoint of a checkpoint directory holding the tiny model's
    seeded weights and an EMA shadow equals mobi_tpu.export_torch.
    export_from_config on the same weights (imported into a JAX tree by
    mobi_tpu.import_torch) key for key and bitwise in fp32: the state dict,
    `model_ema.*` with num_updates and decay, and the schedule buffers of
    the config; global_step is the directory's step. The file loads back
    into a fresh port model with strict=True (convert.load_checkpoint:
    nothing missing) and its EMA through convert.extract_ema_state_dict;
    --no-schedule drops the buffers only."""
    cfg = port_config(TINY)
    model_sd = {k: v.detach().clone() for k, v in tiny_model.state_dict().items()}
    shadow = {k: v * 0.5 for k, v in tiny_model.unet.state_dict().items()}
    structure = dict(channel_mult=TINY.unet_channel_mult, num_res_blocks=TINY.unet_num_res_blocks,
                     attention_resolutions=TINY.unet_attention_resolutions, vae_resolution=TINY.image_height,
                     vae_ch_mult=TINY.vae_ch_mult, vae_num_res_blocks=TINY.vae_num_res_blocks)
    params = import_mobi_checkpoint(model_sd, **structure)
    ema_unet = import_mobi_checkpoint({convert.UNET_PREFIX + k: v for k, v in shadow.items()}, **structure)["unet"]
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpts"))
    mgr.save(5, types.SimpleNamespace(model=types.SimpleNamespace(state_dict=lambda: model_sd), opt=None,
                                      ema=types.SimpleNamespace(shadow=shadow, num_updates=7)))
    out = tmp_path / "exported.ckpt"
    export_checkpoint.main(["--config", CFG_512, "--ckpt", str(tmp_path / "ckpts" / "5"), "--out", str(out)])
    jcfg = jconfig.mobi_config_from_yaml(jconfig.load_config([CFG_512]))
    want = export_from_config(TINY, params, ema_unet=ema_unet, ema_num_updates=7, schedule=JaxMobi(jcfg).schedule)
    blob = torch.load(out, weights_only=False)
    got = blob["state_dict"]
    assert blob["global_step"] == 5 and blob["epoch"] == 0
    assert set(got) == set(want) and any(k.startswith("model_ema.") for k in got) and "betas" in got
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)

    fresh = tdiff.MobiDiffusion(cfg, device="cpu", seed=9, cond_stage_model=tiny_cond_stage())
    info = convert.load_checkpoint(fresh, str(out))
    assert not info["missing"]
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in model_sd.items())
    ema, n = convert.extract_ema_state_dict(got)
    assert n == 7 and all(np.array_equal(ema[convert.UNET_PREFIX + k], v.numpy()) for k, v in shadow.items())
    bare = export_checkpoint.main(["--config", CFG_512, "--ckpt", str(tmp_path / "ckpts"), "--out",
                                   str(tmp_path / "bare.ckpt"), "--no-schedule"])
    assert set(bare) == set(got) - set(export_checkpoint.SCHEDULE_BUFFERS)


def test_export_of_a_lightning_ckpt_round_trips(tmp_path):
    """A Lightning .ckpt input is loaded into the config's model and
    written again, without EMA (as the JAX script writes it): its model
    entries equal the file's, bitwise, beside the schedule buffers."""
    from tests.test_torch_train_cli import cli_cond_stage, tiny_yaml

    cfg_path = tiny_yaml(tmp_path / "tiny.yaml", {"object_database_path": "unused.csv",
                                                 "scene_database_path": "unused.pkl"})
    model = tdiff.MobiDiffusion(tconfig.mobi_config_from_yaml(tconfig.load_config([cfg_path])), device="cpu",
                                seed=6, cond_stage_model=cli_cond_stage())
    want = model.state_dict()
    torch.save({"state_dict": want, "global_step": 3}, tmp_path / "in.ckpt")
    got = export_checkpoint.main(["--config", cfg_path, "--ckpt", str(tmp_path / "in.ckpt"), "--out",
                                  str(tmp_path / "out.ckpt"), "--platform", "cpu"], cond_stage_model=cli_cond_stage())
    assert set(got) == set(want) | set(export_checkpoint.SCHEDULE_BUFFERS)
    assert all(torch.equal(got[k], v.float()) for k, v in want.items())
