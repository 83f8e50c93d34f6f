"""The port's learning path (mobi_tpu_torch overfit_oracle.py, utils/hbm.py,
SegmentedInpaint.preflight, the optimizer options of training.py and the
zero-init knob) against the JAX package on the tiny config of
tests/test_diffusion.py, in fp32 on the CPU.

As in tests/test_torch_training.py, one JAX model gets seeded random
parameters, converted with `mobi_tpu_torch.convert` and loaded into the port.
Random draws never match across the two frameworks, so the VAE loss takes
injected posterior noise, the optimizers take fixed gradients, and where a
JAX function draws its own noise its scoring is held on the port's sampled
arrays. The tolerances are stated in each test.
"""
import os
import time
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mobi_tpu import overfit_oracle as joracle
from mobi_tpu.models.diffusion import MobiDiffusion as JaxMobi
from mobi_tpu.utils import hbm as jhbm
from mobi_tpu_torch import overfit_oracle as toracle
from mobi_tpu_torch import training as ttraining
from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.pipeline import make_inpaint_pipeline
from mobi_tpu_torch.utils import hbm as thbm
from tests.test_diffusion import TINY, TinyCondStage
from tests.test_torch_models import port_config, random_params, tiny_cond_stage
from tests.test_torch_training import to_port_names


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
    params_np = random_params(jmodel, seed=5)
    return jmodel, jax.tree.map(jnp.asarray, params_np), params_np


def port_model(params_np=None):
    """The oracle's model at the tiny config on the CPU (fp32), with the JAX
    parameters when given."""
    model = toracle.oracle_model(port_config(TINY), device="cpu", cond_stage_model=tiny_cond_stage())
    if params_np is not None:
        model.load_jax_params(params_np)
    return model


# ----------------------------------------------------------------- dataset
@pytest.mark.parametrize("kw", [
    dict(),                                                  # the oracle's default set
    dict(n_objects=3, h=64, w=48, seed=5),                   # another size and seed
    dict(n_objects=4, h=32, w=32, seed=0, ref_hw=(40, 24)),  # a reference crop off the frame size
])
def test_make_object_set_equals_jax(kw):
    """array_equal, leaf by leaf, dtype included."""
    got, want = toracle.make_object_set(**kw), joracle.make_object_set(**kw)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_masked_psnr_equals_jax():
    """Within 1e-9 dB (both float64)."""
    rng = np.random.default_rng(1)
    pred, gt = rng.uniform(-1, 1, (2, 2, 16, 16, 3))
    region = (rng.uniform(size=(2, 16, 16, 1)) > 0.5).astype(np.float32)
    assert abs(toracle.masked_psnr(pred, gt, region) - joracle.masked_psnr(pred, gt, region)) < 1e-9


# ------------------------------------------------------------------ hbm.py
@pytest.mark.parametrize("fields,limit", [
    ((1 << 30, 2 << 30, 3 << 30, 1 << 20, 1 << 29), 6 << 30),   # fits
    ((1 << 30, 2 << 30, 3 << 30, 1 << 20, 0), 6 << 30),         # over by the code
    ((5 << 30, 1 << 30, 4 << 30, 0, 0), 9 << 30),               # over by one GiB
])
def test_check_fits_equals_jax(fields, limit):
    """The same five numbers pass or raise alike, with the same message."""
    names = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
             "generated_code_size_in_bytes", "alias_size_in_bytes")
    record = thbm.MemoryRecord(**dict(zip(names, fields)))
    stats = types.SimpleNamespace(**dict(zip(names, fields)))
    outcomes = []
    for check, err, rec in ((thbm.check_fits, thbm.HbmOverBudgetError, record),
                            (jhbm.check_fits, jhbm.HbmOverBudgetError, stats)):
        try:
            check(rec, limit, "inpaint (prep)")
            outcomes.append(None)
        except err as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) is (sum(fields[:4]) - fields[4] <= limit)


def test_no_budget_on_the_cpu():
    """device_hbm_budget is None on the CPU, preflight returns False there,
    and an unknown budget skips the check (False) as JAX's assert_fits."""
    assert thbm.device_hbm_budget("cpu") is None
    assert thbm.assert_fits(thbm.MemoryRecord(1, 1, 1), "cpu") is False
    assert thbm.live_hbm_gb("cpu") == 0.0
    model = port_model()
    seg = make_inpaint_pipeline(model, num_steps=4, guidance_scale=5.0, sampler="plms",
                                deterministic_encode=True, sample_segments=2, device="cpu")
    assert seg.preflight(toracle.make_object_set(2, 32, 32)) is False


def test_preflight_checks_each_call_and_changes_nothing(monkeypatch):
    """With a budget (measured records faked on the CPU: the bytes the call's
    output holds), preflight runs prep, one probe for each distinct segment
    length (PLMS-6 in 2 segments: 2 and 3 steps) and decode, names the
    first call over the budget, and leaves the caller's generator and the
    pipeline as they were: the next call's output is bitwise the one of a
    pipeline that was never preflighted."""
    model = port_model()
    batch = toracle.make_object_set(2, 32, 32)
    calls = []

    def fake_measure(fn, device=None):
        out = fn()
        calls.append(out)
        return out, thbm.MemoryRecord(1 << 20, 0, 1 << 20)

    monkeypatch.setattr(thbm, "device_hbm_budget", lambda device=None: 8 << 30)
    monkeypatch.setattr(thbm, "measure", fake_measure)

    def make():
        return make_inpaint_pipeline(model, num_steps=6, guidance_scale=5.0, sampler="plms",
                                     deterministic_encode=True, sample_segments=2, device="cpu")

    seg, gen = make(), torch.Generator().manual_seed(3)
    assert seg.preflight(batch, gen) is True
    assert len(calls) == 4  # prep, segments of 2 and 3 steps, decode
    out = seg(batch, gen)
    ref = make()(batch, torch.Generator().manual_seed(3))
    assert all(torch.equal(out[k], ref[k]) for k in ref)
    with pytest.raises(thbm.HbmOverBudgetError, match=r"inpaint \(prep\) needs 0.00 GiB"):
        seg.preflight(batch, limit_bytes=1 << 20)


def test_preflight_leaves_the_global_rng_as_it_was(monkeypatch):
    """Without a generator the calls draw from the global RNG: preflight
    restores it, so the next call without a generator is bitwise the one of
    a pipeline that was never preflighted."""
    model = port_model()
    batch = toracle.make_object_set(2, 32, 32)
    monkeypatch.setattr(thbm, "device_hbm_budget", lambda device=None: 8 << 30)
    monkeypatch.setattr(thbm, "measure", lambda fn, device=None: (fn(), thbm.MemoryRecord(1 << 20, 0, 1 << 20)))

    def make():
        return make_inpaint_pipeline(model, num_steps=4, guidance_scale=5.0, sampler="plms",
                                     deterministic_encode=True, sample_segments=2, device="cpu")

    seg = make()
    torch.manual_seed(11)
    assert seg.preflight(batch) is True
    out = seg(batch)
    torch.manual_seed(11)
    ref = make()(batch)
    assert all(torch.equal(out[k], ref[k]) for k in ref)


# ------------------------------------------------------------ VAE overfit
@pytest.mark.parametrize("vae_name,port_attr,key", [("vae_camera", "first_stage_model", "GT"),
                                                    ("vae_lidar", "lidar_stage_model", "range_data")])
def test_vae_loss_and_grads_equal_jax(jax_pair, vae_name, port_attr, key):
    """The oracle's VAE loss (L1 + 1e-4 KL / numel) with the same posterior
    noise in both packages: the loss within rel 1e-5, the gradient within
    rel L2 1e-4, as one vector and tensor by tensor. JAX's loss is a
    closure inside overfit_vaes, rebuilt here from the JAX VAE's encode,
    posterior and decode as it writes them."""
    jmodel, params, params_np = jax_pair
    vae = getattr(jmodel, vae_name)
    batch = toracle.make_object_set(2, 32, 32, seed=4)
    modality = "image" if key == "GT" else "lidar"
    x = np.concatenate([batch[modality][key], batch[modality][key] * 0.5])
    moments = jax.eval_shape(lambda vp: vae.apply({"params": vp}, jnp.asarray(x), method=vae.encode).mean,
                             params[vae_name])
    noise = np.random.default_rng(6).standard_normal(moments.shape).astype(np.float32)

    def jloss(vp):
        post = vae.apply({"params": vp}, jnp.asarray(x), method=vae.encode)
        rec = vae.apply({"params": vp}, post.mean + post.std * jnp.asarray(noise), method=vae.decode)
        l1 = jnp.abs(rec - x).mean()
        kl = post.kl().mean() / float(np.prod(x.shape[1:]))
        return l1 + 1e-4 * kl

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params[vae_name])
    model = port_model(params_np)
    tvae = getattr(model, port_attr)
    loss, _ = toracle.vae_loss(tvae, torch.from_numpy(x).permute(0, 3, 1, 2), 1e-4,
                               noise=torch.from_numpy(noise).permute(0, 3, 1, 2))
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    full = jax.tree.map(np.zeros_like, params_np)
    full[vae_name] = jax.tree.map(np.asarray, jgrads)
    ref = {n: g for n, g in to_port_names(full).items() if n.startswith(port_attr + ".")}
    got = {f"{port_attr}.{n}": p.grad for n, p in tvae.named_parameters()}
    assert set(ref) == set(got)
    names = sorted(ref)
    want_v = np.concatenate([ref[n].ravel() for n in names])
    got_v = np.concatenate([got[n].numpy().ravel() for n in names])
    assert np.linalg.norm(got_v - want_v) <= 1e-4 * np.linalg.norm(want_v)
    # tensor by tensor where the gradient is not ~0: a conv bias that feeds a
    # GroupNorm group of one channel has an exactly-zero gradient, left as
    # rounding noise in both packages
    top = max(np.linalg.norm(g) for g in ref.values())
    for name, g in ref.items():
        if np.linalg.norm(g) > 1e-3 * top:
            err = np.linalg.norm(got[name].numpy() - g) / np.linalg.norm(g)
            assert err <= 1e-4, (name, err)


# ------------------------------------------------------------- optimizers
SHAPES = [(256, 130), (4, 160, 144), (3, 3, 16, 8), (40,)]  # factored 2-D and 3-D, whole, 1-D


def fixed_problem(seed=8):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10 ** -k for s in SHAPES] for k in (1, 2, 3)]
    return params, grads


def run_optax(tx, params, grads):
    p = [jnp.asarray(a) for a in params]
    state = tx.init(p)
    for g in grads:
        upd, state = tx.update([jnp.asarray(a) for a in g], state, p)
        p = optax.apply_updates(p, upd)
    return [np.asarray(a) for a in p]


def run_port(make, schedule, params, grads):
    p = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in params]
    opt = make(p)
    for i, g in enumerate(grads):
        for t, a in zip(p, g):
            t.grad = torch.from_numpy(a)
        for group in opt.param_groups:
            group["lr"] = float(schedule(i))
        opt.step()
    return [t.detach().numpy() for t in p]


@pytest.mark.parametrize("case", ["adam_cosine", "adamw_warmup_cosine", "adamw_mu_bf16", "adafactor"])
def test_optimizer_steps_equal_optax(case):
    """Three steps on fixed gradients against optax: the VAE phase's adam on
    cosine_decay_schedule(lr, 5, alpha=0.05) and the diffusion phase's adamw
    on warmup_cosine_decay_schedule(0, lr, 1, 4, lr / 20) within 1e-6 max
    abs; adamw with a bf16 first moment, the update (the parameters' change)
    within rel 1e-2 of optax's (mu_dtype=bfloat16); adafactor with the JAX
    package's arguments (multiply_by_parameter_scale=False,
    clipping_threshold=1.0, and the learning-rate schedule) within 1e-6."""
    params, grads = fixed_problem()
    lr = 3e-3
    if case == "adam_cosine":
        jsched, tsched = (m.cosine_decay_schedule(lr, 5, alpha=0.05) for m in (optax, ttraining))
        want = run_optax(optax.adam(jsched), params, grads)
        got = run_port(lambda p: torch.optim.Adam(p, lr=lr, betas=(0.9, 0.999), eps=1e-8), tsched, params, grads)
    else:
        jsched, tsched = (m.warmup_cosine_decay_schedule(0.0, lr, 1, 4, lr / 20) for m in (optax, ttraining))
        for i in range(6):
            assert abs(float(tsched(i)) - float(jsched(i))) <= 1e-9, i
        if case == "adafactor":
            tx = optax.adafactor(learning_rate=jsched, multiply_by_parameter_scale=False, clipping_threshold=1.0)
            kw = dict(optimizer="adafactor")
        else:
            mu = jnp.bfloat16 if case == "adamw_mu_bf16" else None
            tx = optax.adamw(learning_rate=jsched, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2, mu_dtype=mu)
            kw = dict(adam_mu_dtype=torch.bfloat16 if mu is not None else None)
        want = run_optax(tx, params, grads)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = run_port(lambda p: ttraining.make_inner_optimizer(p, lr=0.0, weight_decay=1e-2, **kw),
                           tsched, params, grads)
        assert any("failed to train the full-UNet" in str(w.message) for w in caught) is (case == "adafactor")
    for a, g, w in zip(params, got, want):
        if case == "adamw_mu_bf16":
            assert np.abs((g - a) - (w - a)).max() <= 1e-2 * np.abs(w - a).max()
        else:
            assert np.abs(g - w).max() <= 1e-6
    if case == "adafactor":  # the factored second moment where optax factors it
        opt = ttraining.Adafactor([torch.zeros(1)], lr=0.0)
        assert [opt.factored_dims(s) for s in SHAPES] == [(1, 0), (2, 1), None, None]


def test_optimizer_options_reach_the_train_state(monkeypatch):
    """create_train_state takes both options: AdamWLowMu keeps mu in bf16 and
    moves every trainable tensor; adafactor warns as the JAX package does."""
    model = port_model()
    state, tx = ttraining.create_train_state(model, adam_mu_dtype=torch.bfloat16, device="cpu",
                                             schedule=lambda step: np.float32(1e-3))
    assert isinstance(tx.inner, ttraining.AdamWLowMu)
    before = [p.detach().clone() for p in tx.params]
    for p in tx.params:
        p.grad = torch.ones_like(p)
    tx.update()
    assert all(not torch.equal(a, p) for a, p in zip(before, tx.params))
    assert all(s["mu"].dtype == torch.bfloat16 for s in tx.inner.state.values())
    with pytest.warns(UserWarning, match="adafactor"):
        _, tx = ttraining.create_train_state(model, optimizer="adafactor", device="cpu")
    assert isinstance(tx.inner, ttraining.Adafactor)
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttraining.make_optimizer(model, optimizer="sgd")


def test_oracle_model_keeps_fp32_masters_of_what_it_trains():
    """bf16 compute: the UNet and both VAEs fp32 (what the oracle trains),
    as the adapter set, the other >= 2-D weights bf16; a model built for training without them
    refuses the VAE and the whole-UNet phases."""
    cfg = port_config(TINY, torch.bfloat16)
    model = toracle.oracle_model(cfg, device="cpu", cond_stage_model=tiny_cond_stage())
    mask = model.trainable_mask()  # the adapter set: fp32 as in any training model
    for name, p in model.named_parameters():
        keep = name.startswith(toracle.FP32_PREFIXES) or mask[name] or p.dim() < 2
        want = torch.float32 if keep else torch.bfloat16
        assert p.dtype == want, name
    assert any(p.dtype == torch.bfloat16 for p in model.cond_stage_model.parameters())
    plain = tdiff.MobiDiffusion(cfg, device="cpu", cond_stage_model=tiny_cond_stage(), for_training=True)
    batch = toracle.make_object_set(2, 32, 32)
    with pytest.raises(ValueError, match="oracle_model"):
        toracle.overfit_vaes(plain, batch, steps=1)
    with pytest.raises(ValueError, match="oracle_model"):
        toracle.overfit_diffusion(plain, batch, steps=1)


# ------------------------------------------------------------ zero init
def test_randomize_zero_init_perturbs_the_names_jax_does(jax_pair):
    """Some >= 2-D UNet leaves, a 1-D UNet leaf and a >= 2-D camera-VAE leaf
    set to zero: the port's knob over the UNet perturbs exactly the names
    JAX's zero check selects (overfit_oracle.py:302-317), mapped through
    convert.py, draws N(0, 0.02), and leaves every value off the UNet as it
    was (the VAE's zero leaf included)."""
    _, _, params_np = jax_pair
    tree = jax.tree.map(np.array, params_np)
    leaves, treedef = jax.tree_util.tree_flatten(tree["unet"])
    for i, leaf in enumerate(leaves):
        if (leaf.ndim >= 2 and i % 5 == 0) or (leaf.ndim == 1 and i == 1):
            leaf[...] = 0
    jax.tree.leaves(tree["vae_camera"])[-2][...] = 0
    is_zero = jax.tree.map(lambda x: bool(np.all(x == 0)) if x.ndim >= 2 else False, tree["unet"])
    marks = jax.tree.map(lambda x: np.zeros(x.shape, np.float32), tree)
    marks["unet"] = jax.tree.map(lambda x, z: np.full(x.shape, float(z), np.float32), tree["unet"], is_zero)
    want = {n for n, v in to_port_names(marks).items() if v.size and v.flat[0] == 1.0}
    assert len(want) > 5

    model = port_model(tree)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    got = ttraining.randomize_zero_init(model.unet, seed=0, prefix=tdiff.UNET_PREFIX)
    assert set(got) == want
    after = model.state_dict()
    for name in got:
        assert bool(before[name].eq(0).all()) and 0.01 < float(after[name].std()) < 0.03, name
    assert all(torch.equal(before[n], after[n]) for n in before if n not in want)
    assert any(not bool(t.any()) for n, t in after.items() if n.startswith("first_stage_model."))


def test_oracle_model_zeroes_the_layers_jax_zero_initialises(jax_pair):
    """The oracle trains from the reference's init: the >= 2-D UNet
    parameters `zero_init_reference_layers_` zeroes are exactly those the
    JAX UNet's flax init leaves at zero (zero_init=True), mapped through
    convert.py; the port's seeded weights fill every other one."""
    jmodel, _, params_np = jax_pair
    x = jnp.zeros((4, TINY.latent_size, TINY.latent_size, 9))
    ctx = jnp.zeros((4, 2, TINY.context_dim))
    unet = jax.tree.map(np.asarray, jax.jit(jmodel.unet.init)(jax.random.PRNGKey(0), x, jnp.zeros((4,), jnp.int32),
                                                              ctx)["params"])
    marks = jax.tree.map(lambda a: np.zeros(np.shape(a), np.float32), params_np)
    marks["unet"] = jax.tree.map(lambda a: np.full(a.shape, float(a.ndim >= 2 and not a.any()), np.float32), unet)
    want = {n for n, v in to_port_names(marks).items() if v.size and v.flat[0] == 1.0}
    model = port_model()
    got = {n for n, p in model.named_parameters() if p.dim() >= 2 and not bool(p.any())}
    assert got == want and len(want) > 10
    assert set(tdiff.MobiDiffusion(port_config(TINY), device="cpu", cond_stage_model=tiny_cond_stage())
               .zero_init_reference_layers_()) >= want


# ---------------------------------------------------------- diagnostics
def test_vae_ceiling_and_latent_stats_equal_jax(jax_pair):
    """Deterministic (posterior-mode) encodes: the VAE ceiling within 1e-3
    dB, the latent statistics within 1e-4."""
    jmodel, params, params_np = jax_pair
    model = port_model(params_np)
    batch = toracle.make_object_set(2, 32, 32, seed=2)
    got, want = toracle.vae_ceiling(model, batch), joracle.vae_ceiling(jmodel, params, batch)
    assert got.keys() == want.keys() and all(abs(got[k] - want[k]) <= 1e-3 for k in got)
    got, want = toracle.latent_stats(model, batch), joracle.latent_stats(jmodel, params, batch)
    assert got.keys() == want.keys() and all(abs(got[k] - want[k]) <= 1e-4 for k in got), (got, want)


def test_sample_and_score_scores_as_jax(jax_pair):
    """The JAX pipeline draws its own noise, so JAX's sample_and_score scores
    the port's sampled arrays (its `pipeline` argument returns them): every
    number within 1e-4. x_T pins the port's initial noise: the same x_T gives
    the same scores."""
    jmodel, params, params_np = jax_pair
    model = port_model(params_np)
    batch = toracle.make_object_set(2, 32, 32, seed=2)
    pipe = make_inpaint_pipeline(model, num_steps=3, guidance_scale=1.0, sampler="ddim",
                                 deterministic_encode=True, device="cpu")
    x_T = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 8, 8, 4)).astype(np.float32))
    got = toracle.sample_and_score(model, batch, pipeline=pipe, x_T=x_T)
    assert toracle.sample_and_score(model, batch, num_steps=3, x_T=x_T) == got
    out = {k: v.numpy() for k, v in pipe(batch, None, x_T).items()}
    want = joracle.sample_and_score(jmodel, params, batch, pipeline=lambda p, b, k: out)
    assert got.keys() == want.keys() and all(abs(got[k] - want[k]) <= 1e-4 for k in got), (got, want)
    lat = toracle.sample_latent_mse(model, batch, num_steps=3, x_T=x_T)
    assert set(lat) == {"camera_latent_mse", "camera_latent_mse_rel", "lidar_latent_mse",
                        "lidar_latent_mse_rel"} and all(np.isfinite(v) for v in lat.values())


# --------------------------------------------------------------- training
@pytest.mark.parametrize("prev", [None, "0"])
def test_overfit_diffusion_scopes_the_full_unet_switch(prev, monkeypatch):
    """MOBI_TRAIN_UNET_FULL is "1" inside the call (the whole UNet is
    trainable) and as it was after; options beside a caller's state raise
    the JAX package's ValueError."""
    if prev is None:
        monkeypatch.delenv("MOBI_TRAIN_UNET_FULL", raising=False)
    else:
        monkeypatch.setenv("MOBI_TRAIN_UNET_FULL", prev)
    model = port_model()
    batch = toracle.make_object_set(2, 32, 32)
    state, out = toracle.overfit_diffusion(model, batch, steps=0)
    assert os.environ.get("MOBI_TRAIN_UNET_FULL") == prev
    assert all(p.requires_grad for n, p in model.named_parameters() if n.startswith(tdiff.UNET_PREFIX))
    assert out["losses"] == [] and np.isnan(out["final_loss"])
    for kw in (dict(optimizer="adafactor"), dict(cosine_decay=True), dict(randomize_zero_init=True),
               dict(adam_mu_dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="caller-provided `state`"):
            toracle.overfit_diffusion(model, batch, steps=1, state=state, **kw)
    assert os.environ.get("MOBI_TRAIN_UNET_FULL") == prev


def test_short_overfit_descends():
    """Both phases learn on the CPU at the tiny config: the VAEs' recon L1
    and the diffusion loss (window means of 10 steps, AdamW with the bf16
    first moment on the warm-up cosine, the zero-init knob as the drive
    sets it) fall. Measured 14 s on the CPU with
    one torch thread; held under 60 s."""
    t0 = time.perf_counter()
    model = port_model()
    batch = toracle.make_object_set(2, 32, 32)
    first = toracle.overfit_vaes(model, batch, steps=1)
    model = port_model()
    last = toracle.overfit_vaes(model, batch, steps=40, lr=3e-3)
    assert all(last[k] < 0.8 * first[k] for k in first), (first, last)
    _, out = toracle.overfit_diffusion(model, batch, steps=40, lr=1e-3, cosine_decay=True,
                                       randomize_zero_init=True, adam_mu_dtype=torch.bfloat16)
    assert len(out["zero_init_perturbed"]) > 10  # the reference's zero layers
    losses = out["losses"]
    assert len(losses) == 40 and all(np.isfinite(losses))
    assert np.mean(losses[-10:]) < 0.8 * np.mean(losses[:10]), losses
    assert time.perf_counter() - t0 < 60
