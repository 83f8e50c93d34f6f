"""The port's ops (mobi_tpu_torch/ops) against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both packages; the
JAX Pallas kernels run in interpret mode, as tests/test_flash_attention.py
runs them. On CPU tensors the port's kernel wrappers take their plain
versions, so the launch counters stay 0. The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu.ops import schedules as jsched
from mobi_tpu.ops.attention import dot_product_attention as jax_attention
from mobi_tpu.ops.flash_attention import (
    _flash_bwd_impl,
    _flash_fwd_impl,
    _flash_fwd_lse_impl,
    _xla_reference,
)
from mobi_tpu.ops.fused_norm import _gn_silu_reference
from mobi_tpu.ops.fused_norm import fused_groupnorm_silu as jax_gn_silu
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops import attention as tattn
from mobi_tpu_torch.ops import flash_attention as tfa
from mobi_tpu_torch.ops import fused_norm as tfn
from mobi_tpu_torch.ops import schedules as tsched

SCHED_KW = dict(linear_start=0.00085, linear_end=0.012)  # MobiConfig's
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


def test_diffusion_schedule_equals_jax():
    js = jsched.DiffusionSchedule.create(**SCHED_KW)
    ts = tsched.DiffusionSchedule.create(**SCHED_KW)
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2", "lvlb_weights"):
        np.testing.assert_array_equal(getattr(ts, name), np.asarray(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("num_steps,eta", [(50, 0.0), (3, 0.0), (7, 0.5)])
def test_sampler_tables_equal_jax(num_steps, eta):
    """Equal tables, including the clamp of the last DDIM index to 999 for a
    step count that does not divide 1000."""
    jt = jsched.SamplerTables.create(jsched.DiffusionSchedule.create(**SCHED_KW), num_steps, eta=eta)
    tt = tsched.SamplerTables.create(tsched.DiffusionSchedule.create(**SCHED_KW), num_steps, eta=eta)
    for name in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(tt, name), np.asarray(getattr(jt, name)), err_msg=name)
    assert tt.eta_is_zero == jt.eta_is_zero and tt.num_steps == jt.num_steps
    assert tt.timesteps.max() <= 999
    per_step = tt.per_step("cpu")
    assert per_step.dtype == torch.float32 and tuple(per_step.shape) == (tt.num_steps, 4)


@pytest.mark.parametrize("dim", [320, 33])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 37, 500, 999], np.int32)
    want = np.asarray(jsched.timestep_embedding(jnp.asarray(t), dim))
    got = tsched.timestep_embedding(torch.from_numpy(t), dim).numpy()
    # the arguments t * freq are fp32 products up to 999, where one fp32 ulp
    # is 6.1e-5: the two libraries' products and sin/cos differ by about that
    np.testing.assert_allclose(got, want, atol=1e-4)


def _qkv(shape, seed, q_scale=1.0, k_scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape).astype(np.float32) * q_scale
    k = rng.standard_normal(shape).astype(np.float32) * k_scale
    v = rng.standard_normal(shape).astype(np.float32)
    return q, k, v


# Head dims above 128, which the CUDA kernels split into slices of the
# output columns (the UNet's d = 160 under attn_backend: flash; 256).
WIDE_SHAPES = [(1, 256, 2, 160), (1, 128, 1, 256)]


@pytest.mark.parametrize("shape", [(2, 256, 4, 40), (1, 1024, 2, 64), (3, 512, 8, 80)] + WIDE_SHAPES)
def test_flash_plain_matches_jax_kernel(shape):
    """The K1 plain version against the Pallas kernel (interpret mode), fp32,
    at the shapes of tests/test_flash_attention.py and at head dims above
    128; atol 2e-5 as there."""
    q, k, v = _qkv(shape, 0)
    want = np.asarray(_flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_flash_plain_extreme_logits():
    """Large logits (q = 8, k ~ 8 N(0, 1)): the online max/sum of the kernel
    and the plain softmax agree; atol 5e-5 as in the JAX test."""
    shape = (1, 256, 2, 40)
    _, k, v = _qkv(shape, 1, k_scale=8.0)
    q = np.full(shape, 8.0, np.float32)
    want = np.asarray(_flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("shape", [(2, 256, 4, 40), (1, 512, 2, 32)])
def test_flash_tav_plain_matches_jax_tav_kernel(shape, monkeypatch):
    """K2: with the transposed-accumulator switch on in both packages, the
    port's forward on the CPU (K2's plain version, `attention_plain`)
    against the JAX `_flash_kernel_tav` in interpret mode, fp32, atol 2e-5
    as K1's."""
    import mobi_tpu.ops.flash_attention as jfa

    monkeypatch.setattr(jfa, "TRANSPOSED_AV", True)
    monkeypatch.setattr(tfa, "TRANSPOSED_AV", True)
    q, k, v = _qkv(shape, 5)
    want = np.asarray(_flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(tfa.flash_fwd_tav(*map(torch.from_numpy, (q, k, v))).numpy(), want,
                               atol=2e-5)


def test_transposed_av_switch(monkeypatch):
    """The switch reads MOBI_FLASH_TRANSPOSED_AV at import, as the JAX
    package does, and `set_transposed_av` flips it."""
    monkeypatch.setattr(tfa, "TRANSPOSED_AV", False)
    tfa.set_transposed_av(True)
    assert tfa.TRANSPOSED_AV is True
    tfa.set_transposed_av(False)
    assert tfa.TRANSPOSED_AV is False
    code = "import mobi_tpu_torch.ops.flash_attention as f; print(f.TRANSPOSED_AV)"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, MOBI_FLASH_TRANSPOSED_AV="1"), timeout=120)
    assert out.stdout.strip() == "True", out.stderr


BWD_SHAPES = [(2, 256, 4, 40), (2, 512, 3, 80)]


@pytest.mark.parametrize("shape", BWD_SHAPES + [(1, 1024, 2, 64)] + WIDE_SHAPES)
def test_flash_lse_plain_matches_jax_kernel(shape):
    """K3's plain version against `_flash_fwd_lse_impl` (interpret mode), fp32,
    at the shapes and tolerances of tests/test_flash_attention.py: o at atol
    2e-5, lse at 2e-4."""
    b, n, h, d = shape
    q, k, v = _qkv(shape, 5)
    want_o, want_lse = _flash_fwd_lse_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    o, lse = tfa.flash_fwd_lse(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, n)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(b, h, n), atol=2e-4)


def _bwd_case(shape, seed, extreme=False):
    """q, k, v, dO (numpy) and the JAX kernels' o, lse, dq, dk, dv."""
    q, k, v = _qkv(shape, seed, k_scale=8.0 if extreme else 1.0)
    if extreme:  # tests/test_flash_attention.py:184-201
        q = np.full(shape, 8.0, np.float32)
    do = np.random.default_rng(seed + 100).standard_normal(shape).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = _flash_fwd_lse_impl(jq, jk, jv, interpret=True)
    grads = _flash_bwd_impl(jq, jk, jv, o, lse, jdo, interpret=True)
    b, n, h, _ = shape
    return (q, k, v, do), np.array(o), np.array(lse).reshape(b, h, n), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shape,extreme", [(s, False) for s in BWD_SHAPES + WIDE_SHAPES]
                         + [((1, 256, 2, 40), True)])
def test_flash_bwd_plain_matches_jax_kernels(shape, extreme):
    """K4's and K5's plain versions against `_flash_bwd_impl` (interpret
    mode) on the JAX kernels' own o and lse, fp32, atol 5e-4 as in
    tests/test_flash_attention.py; with extreme logits too."""
    (q, k, v, do), o, lse, want = _bwd_case(shape, 6, extreme)
    t = [torch.from_numpy(a) for a in (q, k, v, o)]
    got = tfa.flash_bwd(*t, torch.from_numpy(lse), torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert np.all(np.isfinite(g.numpy())), name
        np.testing.assert_allclose(g.numpy(), w, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_function_gradients_on_cpu(shape):
    """`flash_attention` with grad on CPU tensors runs the `FlashAttention`
    Function through the plain versions: its gradients equal the JAX
    kernels' (`_flash_bwd_impl`) and torch autograd through
    `attention_plain`, at atol 5e-4."""
    (q, k, v, do), _, _, want = _bwd_case(shape, 7)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    plain = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tfa.attention_plain(*plain).backward(torch.from_numpy(do))
    for name, leaf, w, ref in zip(("dq", "dk", "dv"), leaves, want, plain):
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=5e-4, err_msg=name)
        np.testing.assert_allclose(leaf.grad.numpy(), ref.grad.numpy(), atol=5e-4, err_msg=name)
    with torch.no_grad():
        assert tfa.flash_attention(*leaves).grad_fn is None


def test_flash_bwd_xla_mode_matches_jax_vjp(monkeypatch):
    """MOBI_FLASH_BWD=xla: the forward without lse, the backward autograd
    through `attention_plain`; the gradients equal jax.vjp of the JAX
    package's `_xla_reference`."""
    monkeypatch.setattr(tfa, "BWD_MODE", "xla")
    shape = (2, 256, 4, 40)
    (q, k, v, do), _, _, _ = _bwd_case(shape, 8)
    _, vjp = jax.vjp(_xla_reference, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention(*leaves)
    assert type(out.grad_fn).__name__ == "_PlainBackwardBackward"
    out.backward(torch.from_numpy(do))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=5e-4)
    monkeypatch.setattr(tfa, "BWD_MODE", "other")
    with pytest.raises(ValueError, match="MOBI_FLASH_BWD"):
        tfa.flash_attention(*leaves)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 16, 16, 96)])
def test_gn_silu_function_gradients_match_jax_vjp(shape, monkeypatch):
    """The K6 Function's backward (autograd of the plain version, recomputed
    from the saved x, weight and bias) against jax.vjp of
    `_gn_silu_reference`, fp32. Its forward is the kernel, which runs only
    on the card, so here it is replaced by the plain version."""
    monkeypatch.setattr(tfn, "_gn_silu_cuda", tfn.groupnorm_silu_plain)
    rng = np.random.default_rng(9)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s_, b_: _gn_silu_reference(a, s_, b_, 32, 1e-5),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dy))]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    st, bt = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    y = tfn.GroupNormSiLU.apply(xt, st, bt, 32, 1e-5)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), want[0], atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(st.grad.numpy(), want[1], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), want[2], atol=1e-3, rtol=1e-4)


def test_q_sample_matches_jax():
    js = jsched.DiffusionSchedule.create(**SCHED_KW)
    ts = tsched.DiffusionSchedule.create(**SCHED_KW)
    rng = np.random.default_rng(10)
    x, noise = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 500, 999], np.int32)
    want = np.asarray(js.q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise)))
    got = ts.q_sample(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nq,nk,masked,backend,want", [
    (4096, 4096, False, "auto", True),    # attn1 and cross-modal at 64x64
    (1024, 1024, False, "auto", True),    # ... at 32x32
    (256, 256, False, "auto", False),     # 16x16 level: below 1024 tokens
    (4096, 1, False, "auto", False),      # attn2: CLIP token only
    (4096, 2, False, "auto", False),      # bbox adapter
    (1024, 1024, True, "auto", False),    # a mask always takes the formula
    (4096, 4096, False, "xla", False),    # VAE mid attention, CLIP, xf mapper
    (1024, 4096, False, "auto", False),   # Nq != Nk
    (4096, 1, False, "flash", True),      # "flash" takes every call, as in JAX
    (256, 256, True, "flash", True),      # ... masked or short
])
def test_attention_auto_rule(nq, nk, masked, backend, want, monkeypatch):
    assert tattn.uses_flash(nq, nk, object() if masked else None, backend) is want
    calls = []
    monkeypatch.setattr(tattn, "flash_attention", lambda q, k, v: calls.append(q.shape) or tfa.attention_plain(q, k, v))
    q = torch.zeros(1, nq, 16)
    kv = torch.zeros(1, nk, 16)
    mask = torch.ones(1, nq, nk, dtype=torch.bool) if masked else None
    out = tattn.dot_product_attention(q, kv, kv, num_heads=2, mask=mask, backend=backend)
    assert tuple(out.shape) == (1, nq, 16)
    assert bool(calls) is want


def test_flash_min_seq_switch_is_read_as_in_jax():
    """MOBI_FLASH_MIN_SEQ, read at import by both packages: one process sees
    256 in both, and the port's "auto" rule takes a 256-token call then."""
    code = ("import mobi_tpu.ops.attention as j, mobi_tpu_torch.ops.attention as t; "
            "print(j._FLASH_MIN_SEQ, t.FLASH_MIN_SEQ, t.uses_flash(256, 256, None, 'auto'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, MOBI_FLASH_MIN_SEQ="256", JAX_PLATFORMS="cpu"),
                         timeout=120)
    assert out.stdout.strip() == "256 256 True", out.stderr
    assert tattn.FLASH_MIN_SEQ == 1024  # this process: the default


@pytest.mark.parametrize("d", [8, 16, 20, 32, 40, 56, 64, 72, 80, 88, 96, 128, 130, 136, 160,
                               192, 250, 256, 264, 320])
def test_flash_head_dim_limit(d):
    """The kernels take every head dim up to 256 (csrc/flash_common.cuh
    `head_dims` picks the instantiation and its slices of the head dim; the
    card tests run each width): the CUDA wrappers pad it to a multiple of 8,
    and above 256 refuse it, naming the caller's d, before any copy."""
    assert tfa.MAX_HEAD_DIM == 256
    t = torch.zeros(1, 4, 2, d)
    if d > tfa.MAX_HEAD_DIM:
        with pytest.raises(ValueError, match=f"head dim {d}:"):
            tfa._pad_head_dim(t, t, t)
    else:
        assert all(p.shape[-1] == -(-d // 8) * 8 for p in tfa._pad_head_dim(t, t, t))


def test_flash_pads_a_head_dim_off_the_16_byte_grid():
    """d = 20 (320 channels, 16 heads): q, k, v are copied into zero-padded
    tensors of head dim 24, which leave every logit and, sliced back, every
    output unchanged at the true d's scale."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 33, 3, 20)).astype(np.float32))
               for _ in range(3))
    qp, kp, vp = tfa._pad_head_dim(q, k, v)
    assert qp.shape == (2, 33, 3, 24) and not qp[..., 20:].any()
    assert tfa._pad_head_dim(qp)[0] is qp  # a multiple of 8 is left as it is
    logits = torch.einsum("bqhd,bkhd->bhqk", qp, kp) * 20 ** -0.5
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), vp)
    torch.testing.assert_close(tfa._unpad(out, 20), tfa.attention_plain(q, k, v), atol=1e-6, rtol=1e-6)
    assert tfa._unpad(out, 20).is_contiguous()


def test_attention_plain_with_mask_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 24, 12)).astype(np.float32) for _ in range(3))
    mask = rng.uniform(size=(2, 24, 24)) > 0.3
    mask[:, :, 0] = True
    want = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=3,
                                    mask=jnp.asarray(mask), backend="xla"))
    got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                      num_heads=3, mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 16, 16, 96), (2, 8, 8, 320)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_silu_plain_matches_jax_kernel(shape, dtype):
    """The K6 plain version (two-pass variance) against the Pallas kernel
    (interpret mode; variance as E[x^2] - mean^2). fp32: the two variance
    formulas differ by ~1e-7 relative at these magnitudes, so atol 2e-5.
    bf16: both read and write bf16 with fp32 statistics; the formulas can
    flip an output's rounding, so one bf16 ulp (rtol 2^-7)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jax_gn_silu(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5, True)
    want = np.asarray(want.astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).contiguous()
    got = tfn.fused_groupnorm_silu(xt, torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-5)
    assert got.dtype == tdt
    got = got.float().permute(0, 2, 3, 1).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=2 ** -7)


# The 14 (B, C, H, W) of the flagship's UNet norms at batch 8, and spans off
# them: odd H * W, a span shorter than a warp's 16-byte loads, one channel a
# group, a span past a cluster's shared memory in fp32.
GN_PLAN_SHAPES = [
    (8, 320, 64, 64), (8, 320, 32, 32), (8, 640, 32, 32), (8, 640, 16, 16), (8, 1280, 16, 16),
    (8, 1280, 8, 8), (8, 2560, 8, 8), (8, 2560, 16, 16), (8, 1920, 16, 16), (8, 1920, 32, 32),
    (8, 1280, 32, 32), (8, 960, 32, 32), (8, 960, 64, 64), (8, 640, 64, 64),
    (2, 64, 7, 9), (2, 96, 5, 5), (2, 128, 90, 90), (3, 31, 240, 240), (2, 64, 2, 2), (1, 16, 4, 4),
    (1, 32, 1, 1), (1, 64, 512, 512), (1, 32, 1024, 1024),
]


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("shape", GN_PLAN_SHAPES)
def test_gn_plan_covers_every_span_once(shape, elem_bytes):
    """K6's launch plan: the blocks of a cluster cover a span exactly once,
    each with a non-empty chunk of whole 16-byte entries; a cluster has at
    most 8 blocks (16 is the hardware's most); a block's chunk fits its 227
    KB of shared memory, or its registers (8 entries a thread); every
    main-path shape takes a cluster variant, never the streaming one."""
    b, c, h, w = shape
    g = min(32, c)
    span, hw, vec = c // g * h * w, h * w, 16 // elem_bytes
    plan = tfn.gn_plan(b, c, g, hw, elem_bytes)
    assert plan.variant in tfn.GN_VARIANTS and 32 <= plan.threads <= 512 and plan.threads % 32 == 0
    if plan.variant.startswith("cluster"):
        assert 1 <= plan.cluster <= min(tfn.GN_MAX_CLUSTER, 16)
        assert plan.chunk % vec == 0 and plan.chunk * elem_bytes <= 227 * 1024
        if plan.variant == "cluster_regs":
            assert plan.chunk <= plan.threads * 8 * vec
        covered = np.zeros(span, np.int64)
        for rank in range(plan.cluster):
            lo, hi = rank * plan.chunk, min((rank + 1) * plan.chunk, span)
            assert hi > lo, "a block of the cluster has nothing to do"
            covered[lo:hi] += 1
        assert (covered == 1).all()
    else:
        assert plan.threads == tfn.GN_STREAM_THREADS
        assert span * elem_bytes % 16 or span * elem_bytes > 8 * tfn.GN_MAX_CHUNK_BYTES
    if shape in GN_PLAN_SHAPES[:14]:
        assert plan.variant != "stream"


def test_group_norm_clamps_groups_for_tiny_widths():
    x = torch.randn(2, 16, 4, 4)
    y = tfn.group_norm(x, torch.ones(16), torch.zeros(16), 32, 1e-6)
    per_channel = x.reshape(2, 16, -1)
    want = (per_channel - per_channel.mean(-1, keepdim=True)) / torch.sqrt(
        per_channel.var(-1, unbiased=False, keepdim=True) + 1e-6)
    torch.testing.assert_close(y, want.reshape(x.shape), atol=1e-5, rtol=1e-5)


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    from mobi_tpu_torch.models.diffusion import MobiConfig, MobiDiffusion, resolve_device
    from mobi_tpu_torch.models.encoders import CondStageModel
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MobiConfig(latent_size=8, image_height=32, range_height=32,
                     unet_channels=32, unet_channel_mult=(1, 2),
                     unet_num_res_blocks=1, unet_attention_resolutions=(2, 1),
                     unet_num_heads=4, context_dim=64, ref_image_size=32, vae_ch=16,
                     vae_ch_mult=(1, 1, 2), vae_num_res_blocks=1, clip_width=96)

    def cond_stage():
        return CondStageModel(clip_width=96, clip_image_size=32, clip_patch_size=16,
                              clip_layers=1, clip_heads=4, mapper_layers=1,
                              bbox_proj_dims=(64, 48, 48, 64))

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MobiDiffusion(cfg, cond_stage_model=cond_stage())
    model = MobiDiffusion(cfg, device="cpu", cond_stage_model=cond_stage())
    assert model.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_inpaint_pipeline(model)
    make_inpaint_pipeline(model, device="cpu")
    make_inpaint_pipeline(model, sampler="plms", device="cpu")  # PLMS is ported
    with pytest.raises(ValueError, match="unknown sampler"):
        make_inpaint_pipeline(model, sampler="dpm", device="cpu")


def test_wrappers_take_the_plain_path_only_on_cpu():
    """A tensor that is not on the CPU never reaches the plain version: it
    goes to the kernel's checks, which here refuse a meta tensor."""
    q = torch.empty(1, 64, 2, 40, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="flash_attention"):
        tfa.flash_attention(q, q, q)
    x = torch.empty(1, 64, 4, 4, device="meta", dtype=torch.bfloat16)
    w = torch.empty(64, device="meta")
    with pytest.raises(ValueError, match="fused_groupnorm_silu"):
        tfn.fused_groupnorm_silu(x, w, w)
