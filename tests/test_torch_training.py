"""The port's training surface (mobi_tpu_torch training.py, models/ema.py,
utils/config.py and MobiDiffusion's trainable mask and losses) against the
JAX package on the tiny config of tests/test_diffusion.py, in fp32 on the
CPU.

As in tests/test_torch_models.py, one JAX model gets seeded random
parameters, converted with `mobi_tpu_torch.convert` and loaded into the port
with strict=True. Random draws never match across the two frameworks, so
the losses and gradients are compared with the encodes pinned to the
posterior mode and with t, noise and the CFG drop injected. The JAX suite runs its matmuls at
"highest" precision (tests/conftest.py), so both sides compute in full fp32.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mobi_tpu import training as jtraining
from mobi_tpu.models.diffusion import MobiDiffusion as JaxMobi
from mobi_tpu.models.ema import ema_init, ema_update
from mobi_tpu.utils import config as jconfig
from mobi_tpu_torch import convert
from mobi_tpu_torch import training as ttraining
from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops import attention as tattn
from mobi_tpu_torch.ops import distributions as tdist
from mobi_tpu_torch.ops import flash_attention as tfa
from mobi_tpu_torch.utils import config as tconfig
from tests.test_diffusion import TINY, TinyCondStage, make_batch
from tests.test_torch_models import numpy_batch, port_config, random_params, tiny_cond_stage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_512 = os.path.join(ROOT, "configs", "mobi_nusc_512.yaml")


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """One intra-op thread: the suite runs several test processes side by
    side (see tests/test_torch_models.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


@pytest.fixture(scope="module")
def jax_pair():
    jmodel = JaxMobi(TINY)
    jmodel.cond_model = TinyCondStage(conditions=("ref_image", "ref_bbox"))
    params_np = random_params(jmodel, seed=3)
    return jmodel, jax.tree.map(jnp.asarray, params_np), params_np


def port_model(params_np):
    """A fresh port model with the JAX parameters, built for training."""
    model = tdiff.MobiDiffusion(port_config(TINY), device="cpu", cond_stage_model=tiny_cond_stage(),
                                for_training=True)
    model.load_jax_params(params_np)
    return model


def to_port_names(tree):
    """A JAX-shaped tree (parameters, gradients, masks) -> {port name: array}."""
    return convert.state_dict_numpy(tree, port_config(TINY))


@pytest.fixture
def posterior_mode(monkeypatch):
    """The VAE encodes take the posterior mode, as JAX's deterministic=True:
    the two frameworks' posterior samples never match."""
    monkeypatch.setattr(tdist.DiagonalGaussian, "sample", lambda self, generator=None: self.mode())


def injected(seed=21, b=2):
    """t, noise and a batch of `b` pairs: the same draws for both packages."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, TINY.timesteps, 2 * b).astype(np.int32)
    noise = rng.standard_normal((2 * b, TINY.latent_size, TINY.latent_size, 4)).astype(np.float32)
    return t, noise, make_batch(b=b, rng=rng)


@pytest.mark.parametrize("full", [False, True])
def test_trainable_mask_equals_jax(jax_pair, full, monkeypatch):
    """The port's trainable names are JAX's `trainable_mask` mapped through
    convert.py, adapter-only and with MOBI_TRAIN_UNET_FULL=1; the lidar VAE
    stays frozen although its names contain "lidar"."""
    jmodel, params, params_np = jax_pair
    monkeypatch.setenv("MOBI_TRAIN_UNET_FULL", "1" if full else "0")
    jmask = jmodel.trainable_mask(params)
    marked = to_port_names(jax.tree.map(lambda p, m: np.full(np.shape(p), float(m), np.float32),
                                        params_np, jmask))
    want = set()
    for name, value in marked.items():
        assert np.all(value == value.flat[0]), name  # one leaf, one flag
        if value.flat[0] == 1.0:
            want.add(name)
    got = {n for n, t in port_model(params_np).trainable_mask().items() if t}
    assert got == want
    assert not any(n.startswith("lidar_stage_model.") for n in got)
    assert "bbox_uncond_vector" in got and "learnable_vector" not in got
    assert any("cross_modal_attn_lidar" in n for n in got)
    assert any(n.startswith("cond_stage_model.bbox_embedder.") for n in got)
    assert all(n.startswith("model.diffusion_model.") for n in got
               if not (n.startswith("cond_stage_model.bbox_embedder.") or n == "bbox_uncond_vector"))
    unet = [n for n in marked if n.startswith("model.diffusion_model.")]
    assert all(n in got for n in unet) is full


def test_training_dtype_policy_keeps_trainable_fp32():
    """bf16 training model: frozen >= 2-D weights bf16, trainable ones and
    every 1-D norm scale and bias fp32 (train.py:253-271)."""
    cfg = port_config(TINY, torch.bfloat16)
    model = tdiff.MobiDiffusion(cfg, device="cpu", cond_stage_model=tiny_cond_stage(), for_training=True)
    mask = model.trainable_mask()
    for name, p in model.named_parameters():
        want = torch.float32 if (mask[name] or p.dim() < 2) else torch.bfloat16
        assert p.dtype == want, name


def test_p_losses_matches_jax(jax_pair):
    jmodel, params, params_np = jax_pair
    model = port_model(params_np)
    rng = np.random.default_rng(22)
    z = rng.standard_normal((4, 8, 8, 9)).astype(np.float32)
    ctx = rng.standard_normal((4, 2, TINY.context_dim)).astype(np.float32)
    t = np.array([999, 500, 37, 1], np.int32)
    noise = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    _, want = jax.jit(lambda p: jmodel.p_losses(p, jnp.asarray(z), jnp.asarray(ctx), jnp.asarray(t),
                                                jax.random.PRNGKey(0), noise=jnp.asarray(noise)))(params)
    with torch.no_grad():
        loss, got = model.p_losses(torch.from_numpy(z), torch.from_numpy(ctx),
                                   torch.from_numpy(t).long(), torch.from_numpy(noise))
    assert set(got) == set(want) == {"loss", "loss_simple", "loss_vlb", "loss_camera", "loss_lidar"}
    assert float(loss) == float(got["loss"])
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)


def jax_loss(jmodel, t, noise, drop):
    """JAX's train-step loss (training.py:290-303) with a deterministic
    encode and t, noise and the CFG drop injected."""

    def loss_fn(params, batch):
        mask = jmodel.trainable_mask(params)
        p = jax.tree.map(lambda x, m: x if m else jax.lax.stop_gradient(x), params, mask)
        data = jmodel.get_input(p, batch, jax.random.PRNGKey(0), encode_cond=False, deterministic=True)
        z = data["z"]
        ctx = jmodel.get_learned_conditioning(p, data["cond_raw"])
        ctx = jnp.where(drop, jmodel.uncond_tokens(p, z.shape[0]), ctx)
        return jmodel.p_losses(p, z, ctx, jnp.asarray(t), jax.random.PRNGKey(1), noise=jnp.asarray(noise))

    return loss_fn


@pytest.fixture(scope="module")
def jax_loss_grads(jax_pair):
    """JAX's value_and_grad of `jax_loss` at injected()'s t and noise, the
    CFG drop an argument: compiled once for both drop cases."""
    t, noise, _ = injected()
    return jax.jit(jax.value_and_grad(lambda p, b, drop: jax_loss(jax_pair[0], t, noise, drop)(p, b),
                                      has_aux=True))


@pytest.mark.parametrize("drop", [False, True])
def test_trainable_gradients_match_jax(jax_pair, jax_loss_grads, drop, posterior_mode):
    """The gradient of every trainable leaf equals JAX's value_and_grad over
    the stop-gradient-masked loss; the frozen leaves get none."""
    jmodel, params, params_np = jax_pair
    t, noise, batch = injected()
    (jl, _), jgrads = jax_loss_grads(params, batch, jnp.asarray(drop))
    want = to_port_names(jax.tree.map(np.asarray, jgrads))
    model = port_model(params_np)
    _, tx = ttraining.create_train_state(model, device="cpu")
    loss, _ = model.training_loss(numpy_batch(batch), t=torch.from_numpy(t).long(),
                                  noise=torch.from_numpy(noise), drop=drop)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    mask = model.trainable_mask()
    scale = max(np.abs(want[n]).max() for n in mask if mask[n])
    for name, p in model.named_parameters():
        if not mask[name]:
            assert p.grad is None and not p.requires_grad, name
            assert not np.any(want[name]), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-3, atol=1e-4 * scale, err_msg=name)
    # CFG dropout routes the gradient to one conditioning path or the other
    assert bool(np.any(want["bbox_uncond_vector"])) is drop
    assert bool(np.any(want["cond_stage_model.bbox_embedder.bbox_proj.weight"])) is (not drop)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_two_adamw_updates_match_optax(jax_pair, accumulate):
    """Parameters after two AdamW updates (2 x accumulate calls, each with
    its own gradients) equal optax's `make_optimizer` updates applied to the
    same gradients; the frozen set stays as it was."""
    jmodel, params, params_np = jax_pair
    jsched = jtraining.lambda_linear_schedule(1e-2, warm_up_steps=1, f_start=0.5)
    tsched = ttraining.lambda_linear_schedule(1e-2, warm_up_steps=1, f_start=0.5)
    tx = jtraining.make_optimizer(jmodel, params, schedule=jsched, accumulate_steps=accumulate)
    opt_state = tx.init(params)

    @jax.jit
    def jax_update(grads, opt_state, jparams):
        updates, opt_state = tx.update(grads, opt_state, jparams)
        return optax.apply_updates(jparams, updates), opt_state

    model = port_model(params_np)
    opt = ttraining.make_optimizer(model, schedule=tsched, accumulate_steps=accumulate)
    rng = np.random.default_rng(23)
    jparams = params
    applied = []
    for _ in range(2 * accumulate):
        grads_np = jax.tree.map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params_np)
        jparams, opt_state = jax_update(jax.tree.map(jnp.asarray, grads_np), opt_state, jparams)
        grads = to_port_names(grads_np)
        for name, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[name].copy())
        applied.append(opt.update())
    assert applied == ([True, True] if accumulate == 1 else [False, True, False, True])
    assert opt.count == 2
    want = to_port_names(jax.tree.map(np.asarray, jparams))
    start = to_port_names(params_np)
    mask = model.trainable_mask()
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if mask[name]:
            assert not np.array_equal(got, start[name]), name
            np.testing.assert_allclose(got, want[name], rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(got, start[name], err_msg=name)
            np.testing.assert_array_equal(want[name], start[name], err_msg=name)


def test_schedules_match_jax():
    """Every LR schedule equals JAX's at steps 0-1000 (float32 both sides)."""
    steps = np.arange(1001)
    pairs = [
        ("lambda_linear_schedule", (8e-5,), {}),
        ("lambda_linear_schedule", (1e-3,), dict(warm_up_steps=50, f_start=0.1, f_max=1.0,
                                                 f_min=0.2, cycle_length=700)),
        ("lambda_warmup_cosine_schedule", (1e-3, 100, 0.1, 1.0, 0.01, 800), {}),
        ("multi_cycle_schedule", (1e-3, [100, 50], [0.5, 0.1], [1.0, 0.8], [1e-6, 0.2],
                                  [400, 10000]), dict(shape="linear")),
        ("multi_cycle_schedule", (1e-3, [100, 50], [0.5, 0.1], [1.0, 0.8], [1e-6, 0.2],
                                  [400, 10000]), dict(shape="cosine")),
    ]
    for name, args, kw in pairs:
        want = np.asarray(jax.vmap(getattr(jtraining, name)(*args, **kw))(jnp.asarray(steps)))
        sched = getattr(ttraining, name)(*args, **kw)
        got = np.array([sched(int(s)) for s in steps])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=0, err_msg=f"{name} {kw}")


def test_schedule_from_config_matches_jax_and_raises_on_shipped_target():
    """The shipped configs name `mobi_tpu.training.lambda_linear_schedule`,
    which `schedule_from_config` does not know, in both packages (a fault of
    the JAX reference, recorded in ROADMAP); the reference class names
    select the same schedules."""
    block = tconfig.load_config([CFG_512])["model"]["params"]["scheduler_config"]
    for mod in (jtraining, ttraining):
        with pytest.raises(ValueError, match="unknown scheduler target"):
            mod.schedule_from_config(8e-5, block)
    steps = np.arange(0, 1001, 7)
    for target in ("ldm.lr_scheduler.LambdaLinearScheduler", "ldm.lr_scheduler.LambdaWarmUpCosineScheduler2"):
        cfg = dict(block, target=target)
        want = np.asarray(jax.vmap(jtraining.schedule_from_config(8e-5, cfg))(jnp.asarray(steps)))
        got = np.array([ttraining.schedule_from_config(8e-5, cfg)(int(s)) for s in steps])
        np.testing.assert_allclose(got, want, rtol=2e-6, err_msg=target)
    assert ttraining.schedule_from_config(8e-5, None)(200) == jtraining.schedule_from_config(8e-5, None)(200)


def test_ema_updates_match_jax(jax_pair):
    """Three LitEma updates over the UNet equal JAX's ema_update; inside
    `params_with_ema` the UNet holds the average, after it the trained
    weights again."""
    jmodel, params, params_np = jax_pair
    model = port_model(params_np)
    state, _ = ttraining.create_train_state(model, use_ema=True, device="cpu")
    jema = ema_init(params["unet"])
    rng = np.random.default_rng(24)
    unet_np = params_np["unet"]
    for _ in range(3):
        unet_np = jax.tree.map(lambda p: (p + 0.1 * rng.standard_normal(np.shape(p))).astype(np.float32),
                               unet_np)
        jema = ema_update(jema, jax.tree.map(jnp.asarray, unet_np))
        model.load_state_dict(convert.state_dict_from_jax({"unet": unet_np}, port_config(TINY)), strict=False)
        state.ema.update(model.unet)
    assert state.ema.num_updates == int(jema.num_updates) == 3
    want = to_port_names({"unet": jax.tree.map(np.asarray, jema.ema_params)})
    prefix = tdiff.UNET_PREFIX
    assert {prefix + n for n in state.ema.shadow} == {n for n in want if n.startswith(prefix)}
    for name, e in state.ema.shadow.items():
        np.testing.assert_allclose(e.numpy(), want[prefix + name], rtol=1e-6, atol=1e-7, err_msg=name)
    trained = {n: p.detach().clone() for n, p in model.unet.named_parameters()}
    with ttraining.params_with_ema(state) as swapped:
        for name, p in swapped.unet.named_parameters():
            assert torch.equal(p, state.ema.shadow[name]), name
    for name, p in model.unet.named_parameters():
        assert torch.equal(p, trained[name]), name


def test_train_step_updates_only_the_trainable_set(jax_pair):
    """Two train steps through the entry points: finite metrics, a positive
    grad_norm, every trainable tensor moved (one step drops the
    conditioning, as CFG dropout does), every frozen one bitwise unchanged."""
    _, _, params_np = jax_pair
    model = port_model(params_np)
    state, tx = ttraining.create_train_state(model, base_lr=1e-2, device="cpu",
                                             schedule=ttraining.lambda_linear_schedule(1e-2, 1, 0.5))
    step = ttraining.make_train_step(model, tx, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    gen = torch.Generator().manual_seed(0)
    batch = numpy_batch(make_batch(b=1))
    for drop in (False, True):
        state, metrics = step(state, batch, gen, drop=drop)
        assert set(metrics) == {"loss", "loss_simple", "loss_vlb", "loss_camera", "loss_lidar", "grad_norm"}
        assert all(torch.isfinite(v) for v in metrics.values()) and float(metrics["grad_norm"]) > 0
    assert state.step == 2 and tx.count == 2
    mask = model.trainable_mask()
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]) is (not mask[name]), name


def test_train_step_moves_the_ema_as_jax(jax_pair):
    """A train step on a state made with use_ema=True moves the UNet's EMA
    after the optimizer, as JAX's ema_update does on the same updated
    weights (here a tree keyed by the port's UNet names): the shadow of
    every trainable UNet tensor moves, that of every frozen one stays."""
    _, _, params_np = jax_pair
    model = port_model(params_np)
    state, tx = ttraining.create_train_state(model, use_ema=True, device="cpu",
                                             schedule=ttraining.lambda_linear_schedule(1e-2, 1, 0.5))
    step = ttraining.make_train_step(model, tx, device="cpu")

    def unet_np():
        return {n: p.detach().numpy().copy() for n, p in model.unet.named_parameters()}

    start = unet_np()
    jema = ema_init(start)
    gen = torch.Generator().manual_seed(0)
    batch = numpy_batch(make_batch(b=1))
    for drop in (False, True):
        state, _ = step(state, batch, gen, drop=drop)
        jema = ema_update(jema, unet_np())
    assert state.ema.num_updates == int(jema.num_updates) == 2
    mask = model.trainable_mask()
    assert set(state.ema.shadow) == set(start)
    for name, e in state.ema.shadow.items():
        np.testing.assert_allclose(e.numpy(), np.asarray(jema.ema_params[name]), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
        assert (not np.array_equal(e.numpy(), start[name])) is mask[tdiff.UNET_PREFIX + name], name
    assert ttraining.create_train_state(model, device="cpu")[0].ema is None


@pytest.mark.parametrize("full", [False, True])
def test_flash_calls_that_carry_a_gradient(jax_pair, full, monkeypatch, posterior_mode):
    """Which flash calls of a training step go through the autograd Function
    (K3 forward, K4 + K5 backward on the card) and which take the plain
    forward (K1): with adapter-only training every call but the first
    (input_blocks.1's attn1, whose inputs come from frozen layers), with
    MOBI_TRAIN_UNET_FULL=1 every call. The tiny config's attention is below
    the 1024-token flash threshold, so the threshold is lowered to 1 here;
    chip_smoke.py asserts the same counts at full width."""
    _, _, params_np = jax_pair
    monkeypatch.setenv("MOBI_TRAIN_UNET_FULL", "1" if full else "0")
    monkeypatch.setattr(tattn, "FLASH_MIN_SEQ", 1)
    calls = []
    for name in ("flash_fwd", "flash_fwd_lse", "flash_bwd"):
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    model = port_model(params_np)
    ttraining.create_train_state(model, device="cpu")
    t, noise, batch = injected(b=1)
    loss, _ = model.training_loss(numpy_batch(batch), t=torch.from_numpy(t).long(),
                                  noise=torch.from_numpy(noise), drop=False)
    loss.backward()
    # 7 transformers at the tiny config (2 down, 1 middle, 4 up), 3 flash calls each
    n = 7 * 3
    assert calls[0] == ("flash_fwd_lse" if full else "flash_fwd")
    assert calls.count("flash_fwd") == (0 if full else 1)
    assert calls.count("flash_fwd_lse") == calls.count("flash_bwd") == (n if full else n - 1)


def test_mobi_config_from_yaml_matches_jax():
    """The shipped 512 config through the port's loader and through JAX's:
    the same merged tree, and the same value in every field the port's
    MobiConfig has (bf16 precision, u_cond_percent 0.2, full width)."""
    tree = tconfig.load_config([CFG_512])
    assert tree == jconfig.load_config([CFG_512])
    got = tconfig.mobi_config_from_yaml(tree)
    want = jconfig.mobi_config_from_yaml(jconfig.load_config([CFG_512]))
    for field in tdiff.MobiConfig.__dataclass_fields__:
        if field == "dtype":
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            continue
        assert getattr(got, field) == getattr(want, field), field
    assert got.u_cond_percent == 0.2 and got.unet_channels == 320 and got.image_height == 512
    assert tree["batch_size"] == 2 and tree["model"]["base_learning_rate"] == 8e-5
    over = ["model.params.u_cond_percent=0.5", "precision=fp32"]
    assert tconfig.load_config([CFG_512], over) == jconfig.load_config([CFG_512], over)
    assert tconfig.mobi_config_from_yaml(tconfig.load_config([CFG_512], over)).dtype == torch.float32
    assert tconfig.parse_override("a.b=[1, 2]") == jconfig.parse_override("a.b=[1, 2]") == ("a.b", [1, 2])


def test_training_entry_points_need_cuda_unless_cpu(jax_pair, monkeypatch):
    _, _, params_np = jax_pair
    model = port_model(params_np)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttraining.create_train_state(model)
    _, tx = ttraining.create_train_state(model, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttraining.make_train_step(model, tx)
    ttraining.make_train_step(model, tx, device="cpu")
    # the optimizer options build on the CPU too (adafactor with the JAX
    # package's warning); tests/test_torch_oracle.py holds their updates
    with pytest.warns(UserWarning, match="adafactor"):
        assert isinstance(ttraining.make_optimizer(model, optimizer="adafactor").inner, ttraining.Adafactor)
    assert isinstance(ttraining.make_optimizer(model, adam_mu_dtype=torch.bfloat16).inner, ttraining.AdamWLowMu)


def test_optimizer_refuses_bf16_trainable_weights():
    """A model built for inference holds its trainable weights in bf16; the
    optimizer needs fp32 masters and says how to get them."""
    cfg = port_config(TINY, torch.bfloat16)
    model = tdiff.MobiDiffusion(cfg, device="cpu", cond_stage_model=tiny_cond_stage())
    with pytest.raises(ValueError, match="for_training=True"):
        ttraining.make_optimizer(model)
