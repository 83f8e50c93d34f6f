"""The port's VAE losses (mobi_tpu_torch models/losses.py, eval/lpips.py and
the rest of ops/distributions.py) against the JAX package's
(mobi_tpu/models/losses.py, eval/lpips.py, ops/distributions.py), in fp32
on the CPU at tiny shapes.

Inputs come from numpy seeds. The JAX modules are initialised by flax and
their parameters converted with `mobi_tpu_torch.convert`; LPIPS, whose
published weights are not here, takes seeded state dicts under the
published names, imported into JAX with `import_lpips_weights` and loaded
into the port as they are. Tolerances are stated in each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mobi_tpu.eval import lpips as jlpips
from mobi_tpu.models import losses as jlosses
from mobi_tpu.ops import distributions as jdist
from mobi_tpu_torch import convert
from mobi_tpu_torch.eval import lpips as tlpips
from mobi_tpu_torch.models import losses as tlosses
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops import distributions as tdist
from tests.test_torch_models import few_torch_threads  # noqa: F401

RTOL = 1e-5  # fp32, the same formula: summation order only


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def gaussians(rng, shape=(2, 5, 6, 4)):
    """Two posteriors from NHWC moments, JAX's and the port's of each."""
    out = []
    for _ in range(2):
        m = rng.normal(0, 1, shape[:-1] + (2 * shape[-1],)).astype(np.float32) * 3
        out.append((jdist.DiagonalGaussian.from_moments(jnp.asarray(m)),
                    tdist.DiagonalGaussian.from_moments(nchw(m))))
    return out


@pytest.mark.parametrize("jaxes,dims", [((1, 2, 3), (1, 2, 3)), ((1, 2), (2, 3)), ((3,), (1,))])
def test_diagonal_gaussian_kl_nll_match_jax(jaxes, dims):
    """kl to N(0, 1), kl to another posterior and nll of a sample, JAX axes
    over NHWC against the port's dims over NCHW (the default, H and W, C),
    within 1e-5 relative; normal_kl elementwise with broadcasting."""
    rng = np.random.default_rng(0)
    (ja, ta), (jb, tb) = gaussians(rng)
    sample = rng.normal(0, 1, (2, 5, 6, 4)).astype(np.float32)

    def back(t):  # the port's sum over `dims` -> JAX's axis order
        t = t.numpy()
        return np.transpose(t, (0, 2, 3, 1)) if t.ndim == 4 else (np.transpose(t, (0, 2, 1)) if t.ndim == 3 else t)

    pairs = [(ja.kl(axes=jaxes), ta.kl(dims=dims)), (ja.kl(jb, axes=jaxes), ta.kl(tb, dims=dims)),
             (ja.nll(jnp.asarray(sample), axes=jaxes), ta.nll(nchw(sample), dims=dims))]
    for want, got in pairs:
        got = back(got) if dims != (1,) else got.numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(ta.kl().numpy(), np.asarray(ja.kl()), rtol=RTOL)
    m1, l1 = rng.normal(0, 1, (3, 4)).astype(np.float32), rng.normal(0, 1, (3, 4)).astype(np.float32)
    m2, l2 = rng.normal(0, 1, (4,)).astype(np.float32), 0.5
    np.testing.assert_allclose(tdist.normal_kl(torch.from_numpy(m1), torch.from_numpy(l1), torch.from_numpy(m2), l2),
                               np.asarray(jdist.normal_kl(m1, l1, m2, l2)), rtol=RTOL, atol=1e-6)


# ------------------------------------------------------------ discriminator
def jax_loss(cls=jlosses.LidarWithDiscriminator, spatial=32, in_ch=2, seed=1, **kw):
    """A JAX loss and its parameters: the discriminator's and logvar by
    flax's init (the LPIPS tree, where there is one, is the caller's)."""
    loss = cls(disc_start=kw.pop("disc_start", 0), disc_in_channels=in_ch, **kw)
    init = jax.jit(lambda key: jlosses.LidarWithDiscriminator.init_params(loss, key, spatial=spatial))
    return loss, jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def port_loss(params, cls=tlosses.LidarWithDiscriminator, in_ch=2, **kw):
    loss = cls(disc_start=kw.pop("disc_start", 0), disc_in_channels=in_ch, **kw)
    loss.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in convert.loss_state_dict_numpy(params).items()},
                         strict=True)
    return loss


def test_discriminator_matches_jax():
    """NLayerDiscriminator (GroupNorm of group size 1, eps 1e-6, no bias on
    conv1-conv3) on a [2, 32, 40, 2] input: the logits within 1e-4
    relative L2 of JAX's (five convs in fp32, another summation order)."""
    jl, params = jax_loss()
    tl = port_loss(params)
    x = np.random.default_rng(1).normal(0, 1, (2, 32, 40, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jl.discriminator.apply)({"params": params["discriminator"]}, jnp.asarray(x)))
    got = tl.discriminator(nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, 2, 3, 1)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def test_discriminator_seeded_init_std_matches_jax():
    """The port's seeded init is flax's default: every kernel's std within
    10% of the JAX init's (lecun normal, truncated), biases 0, norms (1, 0)."""
    _, params = jax_loss(spatial=32)
    want = convert.loss_state_dict_numpy(params)
    got = tlosses.LidarWithDiscriminator(disc_start=0, disc_in_channels=2, seed=5).state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        if name.endswith("bias") or ".norm" in name or name == "logvar":
            np.testing.assert_array_equal(value.numpy(), want[name], err_msg=name)
        else:
            assert abs(float(value.std()) - float(np.std(want[name], ddof=1))) <= 0.1 * float(np.std(want[name])), name


def test_d_losses_and_adopt_weight_match_jax():
    rng = np.random.default_rng(2)
    real, fake = (rng.normal(0, 1.5, (2, 3, 3, 1)).astype(np.float32) for _ in range(2))
    for jf, tf in ((jlosses.hinge_d_loss, tlosses.hinge_d_loss), (jlosses.vanilla_d_loss, tlosses.vanilla_d_loss)):
        np.testing.assert_allclose(float(tf(torch.from_numpy(real), torch.from_numpy(fake))),
                                   float(jf(jnp.asarray(real), jnp.asarray(fake))), rtol=RTOL)
    for step in (0, 4, 5, 9):
        assert tlosses.adopt_weight(0.7, step, 5) == pytest.approx(float(jlosses.adopt_weight(0.7, step, 5)))


# -------------------------------------------------------------------- LPIPS
def lpips_dicts(seed=3):
    """Seeded weights under the published names: the lpips package's heads
    and torchvision AlexNet's state dict (classifier included)."""
    rng = np.random.default_rng(seed)
    alex, cin = {}, 3
    for ti, (cout, k, _, _) in zip((0, 3, 6, 8, 10), ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
                                                      (256, 3, 1, 1), (256, 3, 1, 1))):
        alex[f"features.{ti}.weight"] = rng.normal(0, (cin * k * k) ** -0.5, (cout, cin, k, k)).astype(np.float32)
        alex[f"features.{ti}.bias"] = rng.normal(0, 0.1, (cout,)).astype(np.float32)
        cin = cout
    alex["classifier.1.weight"] = rng.normal(0, 0.01, (16, 8)).astype(np.float32)
    heads = {f"lin{i}.model.1.weight": np.abs(rng.normal(0, 0.1, (1, c, 1, 1))).astype(np.float32)
             for i, c in enumerate((64, 192, 384, 256, 256))}
    return heads, alex


def test_lpips_matches_jax():
    """The published names load into the port strict; its distances on two
    [2, 64, 72, 3] batches within 1e-4 relative of JAX's with the same
    weights imported by import_lpips_weights (five convs, VALID pools)."""
    heads, alex = lpips_dicts()
    jparams = jlpips.import_lpips_weights(heads, alex)
    model = tlpips.LPIPS()
    tlpips.load_published(model, {k: torch.from_numpy(v) for k, v in heads.items()},
                          {k: torch.from_numpy(v) for k, v in alex.items()})
    rng = np.random.default_rng(4)
    x, y = (rng.uniform(-1, 1, (2, 64, 72, 3)).astype(np.float32) for _ in range(2))
    want = np.asarray(jlpips.LPIPS().apply(jparams, jnp.asarray(x), jnp.asarray(y)))
    got = model(nchw(x), nchw(y)).detach().numpy()
    assert want.shape == got.shape == (2,) and np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(model(nchw(x), nchw(x)).detach().numpy(), 0.0, atol=1e-7)


# ------------------------------------------------------------ whole losses
def last_conv_case(rng, in_ch):
    """A decoder's last conv on a fixed input h: (h, kernel, bias, inputs,
    posterior moments), NHWC numpy."""
    h = rng.normal(0, 1, (2, 32, 32, 8)).astype(np.float32)
    k = rng.normal(0, 0.2, (3, 3, 8, in_ch)).astype(np.float32)
    b = rng.normal(0, 0.1, (in_ch,)).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 32, 32, in_ch)).astype(np.float32)
    m = rng.normal(0, 1, (2, 8, 8, 8)).astype(np.float32)
    return h, k, b, x, m


def jax_generator(jl, params, case, step):
    """JAX's generator loss with the adaptive weight's grads taken as
    scripts/train_autoencoder.py:126-172 takes them (on the last kernel),
    and its discriminator loss, jitted."""
    logs = jax.jit(_jax_terms, static_argnums=(0,))(jl, params, tuple(jnp.asarray(a) for a in case), step)
    return {k2: float(v) for k2, v in logs.items()}


def _jax_terms(jl, params, case, step):
    h, k, b, x, m = case
    post = jdist.DiagonalGaussian.from_moments(m)

    def rec_of(kernel):
        return jax.lax.conv_general_dilated(h, kernel, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")) + b

    def terms(kernel):
        rec = rec_of(kernel)
        nll, _, _ = jl.nll_and_kl(params, x, rec, post)
        return nll, -jnp.mean(jl.discriminator.apply({"params": params["discriminator"]}, rec))

    grads = (jax.grad(lambda kk: terms(kk)[0])(k), jax.grad(lambda kk: terms(kk)[1])(k))
    _, log = jl.generator_loss(params, x, rec_of(k), post, step, last_layer_grads=grads)
    _, dlog = jl.discriminator_loss(params, x, rec_of(k), step)
    return {**log, **dlog}


def port_generator(tl, case, step):
    h, k, b, x, m = case
    kernel = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))).requires_grad_(True)
    rec = F.conv2d(nchw(h), kernel, torch.from_numpy(b), padding=1)
    post = tdist.DiagonalGaussian.from_moments(nchw(m))
    _, log = tl.generator_loss(nchw(x), rec, post, step, last_layer=kernel)
    _, dlog = tl.discriminator_loss(nchw(x), rec, step)
    return {k2: float(v.detach()) for k2, v in {**log, **dlog}.items()}


@pytest.mark.parametrize("perceptual", [False, True])
@pytest.mark.parametrize("step", [0, 3])
def test_generator_and_discriminator_losses_match_jax(perceptual, step):
    """LidarWithDiscriminator (2 channels) and LPIPSWithDiscriminator (3
    channels, seeded LPIPS weights), disc_start 2 with kl_weight 1e-3,
    disc_weight 0.5 and logvar_init 0.3: every logged key of both terms at a
    gated step (0) and an open one (3), within 1e-4 relative (d_weight, a
    ratio of two gradient norms, within 1e-4 too); the adaptive weight is
    computed at both, as in JAX."""
    kw = dict(disc_start=2, kl_weight=1e-3, disc_weight=0.5, logvar_init=0.3)
    in_ch = 3 if perceptual else 2
    jcls = jlosses.LPIPSWithDiscriminator if perceptual else jlosses.LidarWithDiscriminator
    tcls = tlosses.LPIPSWithDiscriminator if perceptual else tlosses.LidarWithDiscriminator
    jl, params = jax_loss(jcls, in_ch=in_ch, **dict(kw))
    if perceptual:
        heads, alex = lpips_dicts()
        params["lpips"] = jax.tree.map(np.asarray, jlpips.import_lpips_weights(heads, alex)["params"])
    tl = port_loss(params, tcls, in_ch=in_ch, **dict(kw))
    assert not tl.logvar.requires_grad
    assert not perceptual or not any(p.requires_grad for p in tl.lpips.parameters())
    case = last_conv_case(np.random.default_rng(5), in_ch)
    want, got = jax_generator(jl, params, case, step), port_generator(tl, case, step)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    assert got["train/d_weight"] > 0 and got["train/disc_factor"] == (0.0 if step < 2 else 1.0)
