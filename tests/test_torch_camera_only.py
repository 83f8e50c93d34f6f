"""The camera-only (Paint-by-Example) configuration of the port against the
JAX package on the CPU: configs/pbe.yaml and configs/pbe_camera_256.yaml's
structure at the tiny size of tests/test_diffusion.py, `use_lidar=False`
and conditioning on the reference image alone (no lidar stage, no bbox
token, one CLIP token of context, batches that are not interleaved).

As in tests/test_torch_models.py, one JAX model gets seeded random
parameters, converted with `mobi_tpu_torch.convert` and loaded into the
port strict; encodes take the posterior mode and x_T, t, noise and the CFG
drop are injected. Tolerances are those of the joint model's tests: the
UNet, conditioning and get_input within 1e-4, the samplers, decode and
the pipeline within 2e-4 (tests/test_torch_models.py); the training loss
within 1e-5 relative, trainable gradients within 1e-3 relative (1e-4 of
their largest entry absolute) (tests/test_torch_training.py); a train
step's AdamW update within 1e-3 lr where the gradient is at least 1e-6
and within 2 lr everywhere (a first Adam step is about lr times the
gradient's sign).

The camera-only UNet has no adapter (no cond_adapter, lidar or cross_modal
layer), so its adapter-only trainable set is `bbox_uncond_vector` alone,
which the loss does not read: JAX's step gives it a zero gradient and AdamW
only decays it. MOBI_TRAIN_UNET_FULL=1 trains the whole UNet instead; both
are held against JAX.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mobi_tpu import training as jtraining
from mobi_tpu.export_torch import export_from_config
from mobi_tpu.models.diffusion import MobiDiffusion as JaxMobi
from mobi_tpu.utils import config as jconfig
from mobi_tpu_torch import convert
from mobi_tpu_torch import training as ttraining
from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.models.encoders import CondStageModel
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops import distributions as tdist
from mobi_tpu_torch.pipeline import make_inpaint_pipeline
from mobi_tpu_torch.utils import config as tconfig
from tests.test_diffusion import TINY, TinyCondStage, make_batch
from tests.test_torch_models import few_torch_threads, numpy_batch, port_config, random_params  # noqa: F401

CAM = dataclasses.replace(TINY, use_lidar=False, cond_stage_key=("ref_image",))
STEPS, GUIDANCE = 3, 5.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


@pytest.fixture
def posterior_mode(monkeypatch):
    monkeypatch.setattr(tdist.DiagonalGaussian, "sample", lambda self, generator=None: self.mode())


def camera_batch(b=2, rng=None):
    """tests/test_diffusion.py's batch without its lidar half and bbox."""
    batch = make_batch(b=b, rng=rng)
    del batch["lidar"]
    del batch["image"]["cond"]["ref_bbox"]
    return batch


def port_model(params_np, for_training=False):
    cond = CondStageModel(conditions=("ref_image",), clip_width=96, clip_image_size=32, clip_patch_size=16,
                          clip_layers=2, clip_heads=4, mapper_layers=2)
    model = tdiff.MobiDiffusion(port_config(CAM), device="cpu", cond_stage_model=cond, for_training=for_training)
    model.load_jax_params(params_np)
    return model


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxMobi(CAM)
    jmodel.cond_model = TinyCondStage(conditions=("ref_image",))
    params_np = random_params(jmodel, seed=5)
    params = jax.tree.map(jnp.asarray, params_np)
    tmodel = port_model(params_np)
    batch = camera_batch()
    data = jax.jit(lambda p, b: jmodel.get_input(p, b, jax.random.PRNGKey(0), encode_cond=True,
                                                 deterministic=True))(params, batch)
    x_T = np.random.default_rng(7).standard_normal(data["z"].shape[:3] + (4,)).astype(np.float32)
    ref = {"batch": batch, "data": data, "x_T": x_T}
    for sampler in ("ddim", "plms"):
        ref[sampler] = jax.jit(lambda p, d, x, s=sampler: jmodel.sample(
            p, d, jax.random.PRNGKey(1), num_steps=STEPS, guidance_scale=GUIDANCE, sampler=s, x_T=x))(
            params, data, jnp.asarray(x_T))
    return jmodel, params, params_np, tmodel, ref


def nchw(x):
    return torch.from_numpy(np.array(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def to_port_names(tree):
    return convert.state_dict_numpy(tree, port_config(CAM))


@pytest.mark.parametrize("full", [False, True], ids=["adapter", "full_unet"])
def test_trainable_set_equals_jax(pair, full, monkeypatch):
    """The port's trainable names are JAX's `trainable_mask` through
    convert.py: `bbox_uncond_vector` alone adapter-only (the camera-only
    UNet has no adapter, the cond stage no bbox embedder), and with it the
    whole UNet under MOBI_TRAIN_UNET_FULL=1."""
    jmodel, params, params_np, tmodel, _ = pair
    monkeypatch.setenv("MOBI_TRAIN_UNET_FULL", "1" if full else "0")
    marked = to_port_names(jax.tree.map(lambda p, m: np.full(np.shape(p), float(m), np.float32),
                                        params_np, jmodel.trainable_mask(params)))
    want = {n for n, v in marked.items() if v.flat[0] == 1.0}
    got = {n for n, t in tmodel.trainable_mask().items() if t}
    assert got == want
    unet = {n for n in marked if n.startswith(tdiff.UNET_PREFIX)}
    assert got == ({"bbox_uncond_vector"} | (unet if full else set()))


def test_exported_state_dict_loads_strict(pair):
    """JAX's exporter and the port's converter give the same state dict, with
    no `lidar_stage_model.*`, bbox embedder or adapter key; it loads into a
    fresh camera-only port model with strict=True."""
    _, _, params_np, tmodel, _ = pair
    want = export_from_config(CAM, params_np)
    got = convert.state_dict_numpy(params_np, port_config(CAM))
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert set(want) == set(tmodel.state_dict())
    assert not [k for k in want if k.startswith("lidar_stage_model.") or "bbox_embedder" in k
                or "cross_modal" in k or "cond_adapter" in k]
    assert "bbox_uncond_vector" in want and "learnable_vector" in want
    fresh = port_model(params_np)
    fresh.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in want.items()}, strict=True)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("name", ["pbe.yaml", "pbe_camera_256.yaml"])
def test_yaml_parses_to_jax_config(name):
    """Both packages' config from the YAML: camera only, the reference image
    as the one condition, bf16; pbe_camera_256 at 256 x 256 (latent 32),
    with no `data` section."""
    path = os.path.join(ROOT, "configs", name)
    tree = tconfig.load_config([path])
    assert tree == jconfig.load_config([path])
    want = jconfig.mobi_config_from_yaml(jconfig.load_config([path]))
    got = tconfig.mobi_config_from_yaml(tree)
    for field in set(got.__dataclass_fields__) & set(want.__dataclass_fields__) - {"dtype"}:
        assert getattr(got, field) == getattr(want, field), field
    assert got.dtype == torch.bfloat16 and str(np.dtype(want.dtype)) == "bfloat16"
    assert not got.use_lidar and got.use_camera and tuple(got.cond_stage_key) == ("ref_image",)
    assert (got.image_height, got.latent_size) == ((256, 32) if "256" in name else (512, 64))
    assert ("data" in tree) is (name == "pbe.yaml")


def test_tokens_and_get_input_match_jax(pair):
    """One CLIP token of context; the unconditional token is
    `learnable_vector` alone; get_input's latents are not interleaved and
    carry no lidar geometry."""
    jmodel, params, _, tmodel, ref = pair
    rng = np.random.default_rng(13)
    cond = {"ref_image": rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)}
    want = np.asarray(jax.jit(jmodel.get_learned_conditioning)(params, jax.tree.map(jnp.asarray, cond)))
    with torch.no_grad():
        got = tmodel.get_learned_conditioning({"ref_image": torch.from_numpy(cond["ref_image"])})
    assert got.shape == (3, 1, CAM.context_dim)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    unc = tmodel.uncond_tokens(3).detach().numpy()
    assert unc.shape == (3, 1, CAM.context_dim)
    np.testing.assert_array_equal(unc, np.asarray(jmodel.uncond_tokens(params, 3)))
    np.testing.assert_array_equal(unc[1, 0], tmodel.learnable_vector.detach().numpy()[0, 0])

    data = tmodel.get_input(numpy_batch(ref["batch"]), encode_cond=True, deterministic=True)
    assert set(data) == set(ref["data"]) == {"z", "cond"}
    assert data["z"].shape == (2, 8, 8, 9) and data["cond"].shape == (2, 1, CAM.context_dim)
    np.testing.assert_allclose(data["z"].numpy(), np.asarray(ref["data"]["z"]), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(data["z"][..., 8].numpy(), np.asarray(ref["data"]["z"])[..., 8])
    np.testing.assert_allclose(data["cond"].numpy(), np.asarray(ref["data"]["cond"]), atol=1e-4, rtol=1e-4)


def test_unet_matches_jax(pair):
    jmodel, params, _, tmodel, _ = pair
    rng = np.random.default_rng(11)
    x9 = rng.standard_normal((2, 8, 8, 9)).astype(np.float32)
    t = np.array([999, 37], np.int32)
    ctx = rng.standard_normal((2, 1, CAM.context_dim)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply_model)(params, jnp.asarray(x9), jnp.asarray(t), jnp.asarray(ctx)))
    assert not any("cross_modal" in n or "cond_adapter" in n for n, _ in tmodel.unet.named_parameters())
    with torch.no_grad():
        got = nhwc(tmodel.apply_model(nchw(x9), torch.from_numpy(t), torch.from_numpy(ctx)))
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def injected(seed=21, b=2):
    """t, noise and a camera batch of `b` rows: the same draws for both."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, CAM.timesteps, b).astype(np.int32)
    noise = rng.standard_normal((b, CAM.latent_size, CAM.latent_size, 4)).astype(np.float32)
    return t, noise, camera_batch(b, rng)


_VALUE_AND_GRAD = []


def jax_value_and_grad(jmodel, params):
    """JAX's train-step loss and its gradients with the whole UNet trainable
    (tests/test_torch_training.py's `jax_loss`: a deterministic encode, t,
    noise and the CFG drop injected), jitted once: `f(params, batch, t,
    noise, drop)`."""
    if not _VALUE_AND_GRAD:
        os.environ["MOBI_TRAIN_UNET_FULL"] = "1"
        try:
            mask = jmodel.trainable_mask(params)
        finally:
            del os.environ["MOBI_TRAIN_UNET_FULL"]

        def loss_fn(params, batch, t, noise, drop):
            p = jax.tree.map(lambda x, m: x if m else jax.lax.stop_gradient(x), params, mask)
            data = jmodel.get_input(p, batch, jax.random.PRNGKey(0), encode_cond=False, deterministic=True)
            ctx = jmodel.get_learned_conditioning(p, data["cond_raw"])
            ctx = jnp.where(drop, jmodel.uncond_tokens(p, data["z"].shape[0]), ctx)
            return jmodel.p_losses(p, data["z"], ctx, t, jax.random.PRNGKey(1), noise=noise)

        _VALUE_AND_GRAD.append(jax.jit(jax.value_and_grad(loss_fn, has_aux=True)))
    return _VALUE_AND_GRAD[0]


@pytest.mark.parametrize("drop", [False, True])
def test_training_loss_matches_jax(pair, drop, posterior_mode):
    """`training_loss` with injected t, noise and CFG drop: the loss and its
    metrics (no per-modality split), with the whole UNet trainable so the
    gradients are held too."""
    jmodel, params, params_np, _, _ = pair
    t, noise, batch = injected()
    (jl, jm), jgrads = jax_value_and_grad(jmodel, params)(params, batch, t, noise, drop)
    os.environ["MOBI_TRAIN_UNET_FULL"] = "1"
    try:
        model = port_model(params_np, for_training=True)
        ttraining.make_optimizer(model)  # requires_grad on the trainable set
        mask = model.trainable_mask()
    finally:
        del os.environ["MOBI_TRAIN_UNET_FULL"]
    loss, metrics = model.training_loss(numpy_batch(batch), t=torch.from_numpy(t).long(),
                                        noise=torch.from_numpy(noise), drop=drop)
    assert set(metrics) == set(jm) == {"loss", "loss_simple", "loss_vlb"}
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]), rtol=1e-5, err_msg=k)
    loss.backward()
    want = to_port_names(jax.tree.map(np.asarray, jgrads))
    scale = max(np.abs(want[n]).max() for n in mask if mask[n])
    for name, p in model.named_parameters():
        if not mask[name]:
            assert p.grad is None and not np.any(want[name]), name
        elif name == "bbox_uncond_vector":  # the loss never reads it
            assert p.grad is None and not np.any(want[name])
        else:
            np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-3, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("full", [False, True], ids=["adapter", "full_unet"])
def test_train_step_matches_jax(pair, full, posterior_mode, monkeypatch):
    """One train step through `make_train_step` (injected t, noise, no CFG
    drop) against JAX's loss, value_and_grad and `make_optimizer` update:
    the loss, every trainable tensor after the update, the frozen ones
    unchanged. Adapter-only the step's one trainable tensor has no gradient
    and is only decayed, as optax's AdamW decays it."""
    jmodel, params, params_np, _, _ = pair
    monkeypatch.setenv("MOBI_TRAIN_UNET_FULL", "1" if full else "0")
    t, noise, batch = injected(seed=31)
    jsched = jtraining.lambda_linear_schedule(1e-2, warm_up_steps=1, f_start=0.5)
    tx = jtraining.make_optimizer(jmodel, params, schedule=jsched)

    # the whole UNet's gradients serve both sets: optax's masked AdamW zeroes
    # the update of every leaf outside the trainable set
    (jl, _), jgrads = jax_value_and_grad(jmodel, params)(params, batch, t, noise, False)
    jparams = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(jgrads, params)
    model = port_model(params_np, for_training=True)
    state, opt = ttraining.create_train_state(model, device="cpu",
                                              schedule=ttraining.lambda_linear_schedule(1e-2, 1, 0.5))
    step = ttraining.make_train_step(model, opt, device="cpu")
    state, metrics = step(state, numpy_batch(batch), t=torch.from_numpy(t).long(), noise=torch.from_numpy(noise),
                          drop=False)
    np.testing.assert_allclose(float(metrics["loss"]), float(jl), rtol=1e-5)
    assert state.step == 1 and np.isfinite(float(metrics["grad_norm"]))
    assert (float(metrics["grad_norm"]) > 0) is full
    want, start = to_port_names(jax.tree.map(np.asarray, jparams)), to_port_names(params_np)
    mask = model.trainable_mask()
    assert sum(mask.values()) == (1 + full * len([n for n in start if n.startswith(tdiff.UNET_PREFIX)]))
    # A first Adam step moves each entry by lr * g / (|g| + 1e-8): about lr
    # times the gradient's sign, but where |g| nears 1e-8 (rounding noise
    # on a random tiny UNet) the gradients' 1e-3 relative agreement no
    # longer fixes it. So the updates are held within 1e-3 lr where JAX's
    # gradient is at least 1e-6, and within 2 lr everywhere.
    lr = float(jsched(0))
    grads = to_port_names(jax.tree.map(np.asarray, jgrads))
    diffs, firm = [], []
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if mask[name]:
            assert not np.array_equal(got, start[name]), name
            diffs.append(np.abs(got - want[name]).ravel())
            firm.append(np.abs(grads[name]).ravel() >= 1e-6)
        else:
            np.testing.assert_array_equal(got, start[name], err_msg=name)
    diffs, firm = np.concatenate(diffs), np.concatenate(firm)
    assert firm.sum() >= (0.9 * firm.size if full else 0)
    assert (diffs[firm] <= 1e-3 * lr).all() and diffs.max() <= 2 * lr, diffs.max() / lr
    if not full:  # the one tensor, decayed only: exactly optax's arithmetic
        np.testing.assert_allclose(model.bbox_uncond_vector.detach().numpy(), want["bbox_uncond_vector"],
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("sampler", ["ddim", "plms"])
def test_samplers_with_cfg_match_jax(pair, sampler):
    """DDIM-3 and PLMS-3 at CFG 5 from the same x_T and encoded data."""
    jmodel, params, _, tmodel, ref = pair
    want = ref[sampler]
    data = {k: torch.tensor(np.asarray(v)) for k, v in ref["data"].items()}
    got = tmodel.sample(data, num_steps=STEPS, guidance_scale=GUIDANCE, sampler=sampler,
                        x_T=torch.from_numpy(ref["x_T"]))
    assert got.shape == (2, 8, 8, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_decode_sample_and_pipeline_match_jax(pair):
    """decode_sample gives the camera alone; the whole pipeline
    (deterministic encode, pinned x_T, DDIM-3 at CFG 5) equals JAX's
    get_input -> sample -> decode_sample."""
    jmodel, params, _, tmodel, ref = pair
    rng = np.random.default_rng(9)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    want = jax.jit(jmodel.decode_sample)(params, jnp.asarray(lat))
    with torch.no_grad():
        got = tmodel.decode_sample(torch.from_numpy(lat))
    assert set(got) == set(want) == {"camera"}
    np.testing.assert_allclose(got["camera"].numpy(), np.asarray(want["camera"]), atol=2e-4, rtol=2e-4)

    want = np.asarray(jax.jit(lambda p, lat: jmodel.decode_sample(p, lat)["camera"])(params, ref["ddim"]))
    pipeline = make_inpaint_pipeline(tmodel, num_steps=STEPS, guidance_scale=GUIDANCE, deterministic_encode=True,
                                     device="cpu")
    out = pipeline(numpy_batch(ref["batch"]), x_T=torch.from_numpy(ref["x_T"]))
    assert set(out) == {"camera"} and tuple(out["camera"].shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(out["camera"].numpy(), want, atol=2e-4, rtol=2e-4)
