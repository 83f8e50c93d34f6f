"""The port's samplers (mobi_tpu_torch/models/samplers.py and
MobiDiffusion.sample) against the JAX package on the tiny config, in fp32 on
the CPU: PLMS, encoder propagation, stochastic encode / decode and DDPM.

The JAX and port models share weights through the `pair` fixture of
tests/test_torch_models.py; random draws never match across the frameworks,
so every test pins x_T and, for DDPM, hands the port the JAX run's own
noise. The tolerances are those of the DDIM parity test there: both sides
compute in full fp32 and differ in summation order over the tiny model's
depth, a few 1e-6 per UNet evaluation, compounded over the steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu.models import samplers as jS
from mobi_tpu.ops import schedules as jsched
from mobi_tpu_torch.models import samplers as tS
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops import schedules as tsched
from mobi_tpu_torch.pipeline import make_inpaint_pipeline
from tests.test_torch_models import few_torch_threads, pair  # noqa: F401 (fixtures)

STEPS, GUIDANCE = 5, 5.0
SCHED_KW = dict(linear_start=0.00085, linear_end=0.012)  # MobiConfig's
ATOL = RTOL = 2e-4


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


def port_data(ref):
    return {k: (torch.tensor(np.asarray(v)) if k != "lidar_geom" else v)
            for k, v in ref["data"].items()}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("num_steps", [50, 5, 3, 7])
def test_plms_tables_equal_jax(num_steps):
    """timesteps_next and the Adams-Bashforth rows equal JAX's, including
    the clamped grid of a step count that does not divide 1000."""
    jt = jsched.SamplerTables.create(jsched.DiffusionSchedule.create(**SCHED_KW), num_steps)
    tt = tsched.SamplerTables.create(tsched.DiffusionSchedule.create(**SCHED_KW), num_steps)
    np.testing.assert_array_equal(tt.timesteps_next, np.asarray(jt.timesteps_next))
    np.testing.assert_array_equal(tt.plms_coeffs, np.asarray(jt.plms_coeffs))
    np.testing.assert_array_equal(tsched.make_plms_coeffs(num_steps),
                                  jsched.make_plms_coeffs(num_steps))
    assert tt.plms_coeffs.shape == (tt.num_steps - 1, 4)  # 3 -> a 4-step grid


def test_plms_steps_with_cfg_match_jax(pair):
    """5 PLMS steps at CFG 5 from the same x_T and the same encoded data:
    the double-evaluated step 0, then Adams-Bashforth of orders 2, 3, 4, 4."""
    jmodel, params, _, tmodel, ref = pair
    want = np.asarray(jmodel.sample(params, ref["data"], jax.random.PRNGKey(1), num_steps=STEPS,
                                    guidance_scale=GUIDANCE, sampler="plms",
                                    x_T=jnp.asarray(ref["x_T"])))
    got = tmodel.sample(port_data(ref), num_steps=STEPS, guidance_scale=GUIDANCE,
                        sampler="plms", x_T=torch.from_numpy(ref["x_T"]))
    assert got.dtype == torch.float32
    assert not np.allclose(want, ref["latents"], atol=1e-3)  # PLMS is not DDIM here
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_sample_defaults_to_plms(pair):
    _, _, _, tmodel, ref = pair
    data, x_T = port_data(ref), torch.from_numpy(ref["x_T"])
    default = tmodel.sample(data, num_steps=3, x_T=x_T)
    torch.testing.assert_close(default, tmodel.sample(data, num_steps=3, sampler="plms", x_T=x_T),
                               atol=0, rtol=0)
    assert not torch.allclose(default, tmodel.sample(data, num_steps=3, sampler="ddim", x_T=x_T))


def test_unknown_sampler_raises(pair):
    _, _, _, tmodel, ref = pair
    with pytest.raises(ValueError, match="unknown sampler"):
        tmodel.sample(port_data(ref), num_steps=2, sampler="dpm")
    with pytest.raises(ValueError, match="unknown sampler"):
        make_inpaint_pipeline(tmodel, sampler="dpm", device="cpu")


def test_encoder_propagation_matches_jax(pair):
    """DDIM with encoder_interval = 2: steps 0, 2 and 4 run the whole UNet
    and cache its encoder; steps 1 and 3 run the decoder on the cache."""
    jmodel, params, _, tmodel, ref = pair
    kw = dict(num_steps=STEPS, guidance_scale=GUIDANCE, sampler="ddim", encoder_interval=2)
    want = np.asarray(jmodel.sample(params, ref["data"], jax.random.PRNGKey(1),
                                    x_T=jnp.asarray(ref["x_T"]), **kw))
    got = tmodel.sample(port_data(ref), x_T=torch.from_numpy(ref["x_T"]), **kw)
    assert not np.allclose(want, ref["latents"], atol=1e-3)  # the cache changes the result
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_ddim_stochastic_encode_and_decode_match_jax(pair):
    """Noise a latent to step t_index of the 5-step DDIM grid, then decode
    the first 3 steps back, at CFG 5."""
    jmodel, params, _, tmodel, ref = pair
    rng = np.random.default_rng(21)
    z = np.asarray(ref["data"]["z"])
    x0, rest, cond = z[..., :4], z[..., 4:], np.asarray(ref["data"]["cond"])
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t_index = np.array([4, 2, 0, 3], np.int32)[: x0.shape[0]]
    jt = jsched.SamplerTables.create(jmodel.schedule, STEPS)
    tt = tsched.SamplerTables.create(tmodel.schedule, STEPS)
    want_enc = np.asarray(jS.ddim_stochastic_encode(jt, jnp.asarray(x0), jnp.asarray(t_index),
                                                    jnp.asarray(noise)))
    got_enc = tS.ddim_stochastic_encode(tt, nchw(x0), torch.from_numpy(t_index), nchw(noise))
    np.testing.assert_allclose(nhwc(got_enc), want_enc, atol=1e-6, rtol=1e-6)

    uncond = jmodel.uncond_tokens(params, x0.shape[0])
    want = np.asarray(jS.ddim_decode(
        lambda x9, t, c: jmodel.apply_model(params, x9, t, c), jt, jnp.asarray(want_enc), 3,
        jnp.asarray(cond), jnp.asarray(rest), uncond, GUIDANCE))
    with torch.no_grad():
        got = tS.ddim_decode(tmodel.apply_model, tt, nchw(want_enc), 3, torch.tensor(cond),
                             nchw(rest), tmodel.uncond_tokens(x0.shape[0]), GUIDANCE)
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="t_start"):
        tS.ddim_decode(tmodel.apply_model, tt, nchw(want_enc), STEPS + 1, torch.tensor(cond),
                       nchw(rest))


def test_ddpm_short_schedule_matches_jax(pair):
    """The full ancestral DDPM loop over a 6-step schedule at CFG 5 (the
    model's 1000-step schedule is too long for a CPU test), with the noise
    of every step taken from the JAX run's own key chain and handed to the
    port."""
    jmodel, params, _, tmodel, ref = pair
    jsch = jsched.DiffusionSchedule.create(timesteps=6, **SCHED_KW)
    tsch = tsched.DiffusionSchedule.create(timesteps=6, **SCHED_KW)
    z = np.asarray(ref["data"]["z"])
    rest, cond, x_T = z[..., 4:], np.asarray(ref["data"]["cond"]), ref["x_T"]
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jS.ddpm_sample(
        lambda x9, t, c: jmodel.apply_model(params, x9, t, c), jsch, rng, jnp.asarray(x_T),
        jnp.asarray(cond), jnp.asarray(rest), jmodel.uncond_tokens(params, z.shape[0]), GUIDANCE,
        clip_denoised=True))
    noises, key = [], rng
    for _ in range(6):  # the split chain of jS.ddpm_sample's scan
        key, sub = jax.random.split(key)
        noises.append(nchw(jax.random.normal(sub, x_T.shape, dtype=jnp.float32)))
    with torch.no_grad():
        got = tS.ddpm_sample(tmodel.apply_model, tsch, nchw(x_T), torch.tensor(cond), nchw(rest),
                             tmodel.uncond_tokens(z.shape[0]), GUIDANCE, clip_denoised=True,
                             noises=noises)
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL, rtol=RTOL)
