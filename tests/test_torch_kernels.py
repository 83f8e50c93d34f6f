"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU or interpret mode. The plain versions themselves are held
against the JAX package on the CPU by tests/test_torch_ops.py. This file
imports neither jax nor the JAX package, so it also runs where only the port
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Inputs come from a seeded torch generator on the card.
"""
import pytest
import torch

from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops import flash_attention as fa
from mobi_tpu_torch.ops import fused_norm as fn

pytestmark = pytest.mark.cuda

# bf16 kernel against the bf16 plain version; chip_smoke.py holds the same.
# Both round their outputs to bf16: up to two bf16 ulps relative. K1's
# absolute term scales with its output, which averages V (std ~ sqrt(e / N)):
# rounding P to bf16 before or after the sum moves an output by ~2^-9 of that
# std, and the tolerance is 2^-5 of it. K6's outputs are of unit scale.
# K3's lse is fp32: the kernel's and the plain version's sums of N
# exponentials differ in order and in ex2.approx's 2^-22 relative error, a
# few 1e-6 of lse; one dropped 64-key tile of N = 4096 moves it by 0.016.
# K4 and K5 (dq, dk, dv) use K1's tolerance: the largest difference is dS,
# which both round to bf16 from fp32 values summed in another order, so a
# few of its elements round the other way (2^-9 relative), and a gradient
# sums many of them with both signs. Where dP - delta cancels (one key, or
# the nearly one-hot rows of extreme logits) the exact gradient and its std
# are ~0, and what is left is fp32 rounding of dP - delta carried through K
# or Q: ~1e-7 at unit-scale inputs, ~2e-5 at q = 8, k ~ 8 N(0, 1). The floor
# FLASH_ATOL_MIN times the inputs' scale (rms of q and k, at least 1) covers
# it, and is under 1e-3 of the gradients' std at the UNet's shapes.
BF16_RTOL = 2 ** -6
FLASH_ATOL_STD = 2 ** -5
FLASH_ATOL_MIN = 1e-5
LSE_ATOL, LSE_RTOL = 1e-3, 1e-5
GN_ATOL = 1e-2
# fp32 kernels against the fp32 plain versions with TF32 off. K1 and K2 run
# their products as 3xTF32 (about 22 bits a operand) with ex2.approx: atol
# 2e-5, the JAX kernel's own fp32 tolerance (tests/test_flash_attention.py:27).
# K3-K5 in fp32 (3xTF32 too) against their fp32 plain versions: outputs and
# gradients within F32_ATOL_STD of the reference's std (plus F32_ATOL_MIN
# times the inputs' scale, the floor where dP - delta cancels), the lse
# within LSE_F32_ATOL. What is left at 3xTF32 is ex2.approx, the summation
# order and the tensor cores' fp32 accumulation, about 1e-4 of the std; the
# plain version with TF32 on (11 bits a operand) misses by 1e-2 of the std
# and must fail the same tolerance, so the tests tell fp32 from TF32. JAX's
# own fp32 bound for these gradients, 5e-4 absolute
# (tests/test_flash_attention.py:179-181), is above every tolerance here.
# K6 takes the variance as E[x^2] - mean^2 and SiLU with __expf, the plain
# version two-pass and exact: a few 1e-6 at unit-scale outputs.
F32_ATOL = 2e-5
GN_F32_ATOL, GN_F32_RTOL = 2e-5, 1e-5
F32_ATOL_STD, F32_ATOL_MIN, LSE_F32_ATOL = 2 ** -10, 1e-6, 2e-5


@pytest.fixture
def no_tf32():
    """fp32 plain versions in full fp32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def counts(**launched):
    """Every kernel's launch count: 0 but for those named."""
    return {**dict.fromkeys(_build.launches, 0), **launched}


def randn(dev, *shape, scale=1.0, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)


def assert_close(out, ref, atol, rtol):
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out.float()).all())
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)


# Head dims off the UNet's two: every instantiation (48, 64, 80, 128), a box
# wholly past d (16 and 32 in the 48 build), a head dim that is not a
# multiple of 8 (20: the wrapper pads it to 24), and the 128 build at a
# larger shape.
HEAD_DIM_SHAPES = [(1, 300, 257, 2, d) for d in (16, 20, 32, 56, 64, 96, 128)] + [(2, 1024, 1024, 4, 128)]


@pytest.mark.parametrize("b,nq,nk,h,d", [
    (2, 4096, 4096, 8, 40),   # the UNet's 64x64 level
    (2, 1024, 1024, 8, 80),   # ... its 32x32 level
    (1, 1000, 1000, 8, 40),   # ragged N in both queries and keys
    (2, 130, 77, 4, 80),      # Nq != Nk, both ragged
    (1, 64, 1, 2, 40),        # a single key
    (1, 300, 300, 2, 48),     # the other head dims of the two instantiations
    (1, 300, 300, 2, 72),
    (2, 1024, 300, 8, 40),    # keys cut the third 128-key tile
    (2, 512, 100, 8, 80),     # fewer keys than one tile
    (1, 1000, 257, 4, 80),    # ragged queries, one key into the third tile
] + HEAD_DIM_SHAPES)
def test_flash_matches_plain(dev, b, nq, nk, h, d):
    q = randn(dev, b, nq, h, d, seed=1)
    k, v = randn(dev, b, nk, h, d, seed=2), randn(dev, b, nk, h, d, seed=3)
    _build.reset_launches()
    out = fa.flash_attention(q, k, v)
    assert _build.launches == counts(flash_fwd=1) and out.is_contiguous()
    ref = fa.attention_plain(q, k, v)
    assert_close(out, ref, FLASH_ATOL_STD * ref.float().std().item(), BF16_RTOL)


def test_flash_extreme_logits(dev):
    """q = 8, k ~ 8 N(0, 1) (tests/test_flash_attention.py:30-39): the online
    max keeps every exponent finite."""
    q = torch.full((1, 256, 2, 40), 8.0, device=dev, dtype=torch.bfloat16)
    k, v = randn(dev, 1, 256, 2, 40, scale=8.0, seed=4), randn(dev, 1, 256, 2, 40, seed=5)
    ref = fa.attention_plain(q, k, v)
    assert_close(fa.flash_attention(q, k, v), ref, FLASH_ATOL_STD * ref.float().std().item(), BF16_RTOL)


def test_flash_takes_strided_views(dev):
    """q, k, v as views into one fused projection [B, N, 3, H, D], and a
    [B, H, N, D] tensor seen as [B, N, H, D]: the kernel reads them through
    their strides, with the same result as on contiguous copies."""
    qkv = randn(dev, 2, 1024, 3, 8, 40, seed=6)
    q, k, v = qkv.unbind(2)
    v = randn(dev, 2, 8, 1024, 40, seed=7).transpose(1, 2)
    assert not (q.is_contiguous() or v.is_contiguous())
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out, ref)


def assert_close_std(out, ref, input_scale=1.0):
    """bf16 against bf16 at FLASH_ATOL_STD of the reference's std."""
    atol = FLASH_ATOL_STD * ref.float().std().item() + FLASH_ATOL_MIN * input_scale
    assert_close(out, ref, atol, BF16_RTOL)


def rms(t):
    return t.float().pow(2).mean().sqrt().item()


BWD_SHAPES = [
    (2, 4096, 4096, 8, 40),   # the UNet's 64x64 level
    (2, 1024, 1024, 8, 80),   # ... its 32x32 level
    (1, 1000, 1000, 8, 40),   # ragged N in both queries and keys
    (2, 130, 77, 4, 80),      # Nq != Nk, both ragged
    (1, 64, 1, 2, 40),        # a single key
    (1, 300, 300, 2, 48),     # the other head dims of the two instantiations
    (1, 300, 300, 2, 72),
    (2, 200, 100, 4, 40),     # cut K5's 64-query tile and K4's 128-key tile
    (1, 1000, 257, 4, 80),    # one key into K4's third tile and its second 64-key step
] + HEAD_DIM_SHAPES


@pytest.mark.parametrize("b,nq,nk,h,d", BWD_SHAPES)
def test_flash_lse_matches_plain(dev, b, nq, nk, h, d):
    """K3: the forward's output and its fp32 logsumexp [B, H, Nq]."""
    q = randn(dev, b, nq, h, d, seed=1)
    k, v = randn(dev, b, nk, h, d, seed=2), randn(dev, b, nk, h, d, seed=3)
    _build.reset_launches()
    out, lse = fa.flash_fwd_lse(q, k, v)
    assert _build.launches == counts(flash_fwd_lse=1)
    ref, ref_lse = fa.attention_lse_plain(q, k, v)
    assert_close_std(out, ref)
    assert_close(lse, ref_lse, LSE_ATOL, LSE_RTOL)


def test_flash_lse_bf16_runs_the_wgmma_kernel(dev, monkeypatch):
    """bf16 K3 launches the sm90 forward (K1's wgmma kernel with its lse
    pointer set); fp32 K3 the mma.sync one."""
    lib, entries = _build.library(), []

    class Spy:
        def __getattr__(self, name):
            entries.append(name)
            return getattr(lib, name)

    monkeypatch.setattr(_build, "library", lambda: Spy())
    q = randn(dev, 1, 256, 2, 40, seed=1)
    _build.reset_launches()
    fa.flash_fwd_lse(q, q, q)
    fa.flash_fwd_lse(q.float(), q.float(), q.float())
    assert entries == ["mobi_flash_fwd_sm90", "mobi_flash_fwd"]
    assert _build.launches == counts(flash_fwd_lse=2)


def bwd_inputs(dev, b, nq, nk, h, d, extreme=False):
    if extreme:  # q = 8, k ~ 8 N(0, 1): nearly one-hot softmax rows
        q = torch.full((b, nq, h, d), 8.0, device=dev, dtype=torch.bfloat16)
        k = randn(dev, b, nk, h, d, scale=8.0, seed=12)
    else:
        q, k = randn(dev, b, nq, h, d, seed=11), randn(dev, b, nk, h, d, seed=12)
    v, do = randn(dev, b, nk, h, d, seed=13), randn(dev, b, nq, h, d, seed=14)
    o, lse = fa.attention_lse_plain(q, k, v)
    return q, k, v, o, lse, do


def check_bwd_against_plain(q, k, v, o, lse, do):
    delta = fa.flash_bwd_delta(o, do)
    _build.reset_launches()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
    assert _build.launches == counts(flash_bwd_dq=1, flash_bwd_dkv=1)
    assert dq.is_contiguous() and dk.is_contiguous() and dv.is_contiguous()
    ref_dq, ref_dk, ref_dv = fa.flash_bwd_plain(q, k, v, o, lse, do)
    scale = max(rms(q), rms(k), 1.0)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert_close_std(got, ref, scale)


@pytest.mark.parametrize("b,nq,nk,h,d", BWD_SHAPES)
def test_flash_bwd_matches_plain(dev, b, nq, nk, h, d):
    """K4 and K5 against the JAX kernels' formula on the same o and lse."""
    check_bwd_against_plain(*bwd_inputs(dev, b, nq, nk, h, d))


def test_flash_bwd_extreme_logits(dev):
    check_bwd_against_plain(*bwd_inputs(dev, 1, 256, 256, 2, 40, extreme=True))


@pytest.mark.parametrize("b,n,h,d", [(2, 1024, 8, 40), (1, 4096, 8, 40), (1, 1024, 8, 80)])
def test_flash_bwd_takes_strided_views(dev, b, n, h, d):
    """q, k, v and dO as strided views: the same gradients as on contiguous
    copies (the backward has no cross-block reduction, so it is
    deterministic)."""
    qkv = randn(dev, b, n, 3, h, d, seed=15)
    q, k, v = qkv.unbind(2)
    do = randn(dev, b, h, n, d, seed=16).transpose(1, 2)
    o, lse = fa.attention_lse_plain(q, k, v)
    delta = fa.flash_bwd_delta(o, do)
    got = (fa.flash_bwd_dq(q, k, v, do, lse, delta), *fa.flash_bwd_dkv(q, k, v, do, lse, delta))
    c = [t.contiguous() for t in (q, k, v, do)]
    want = (fa.flash_bwd_dq(*c, lse, delta), *fa.flash_bwd_dkv(*c, lse, delta))
    torch.cuda.synchronize()
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,nq,nk,h,d", [(4, 4096, 4096, 8, 40), (4, 1024, 1024, 8, 80), (2, 130, 77, 4, 80)])
def test_flash_bwd_is_deterministic(dev, b, nq, nk, h, d):
    """Two runs of K4 and K5 on the same inputs give the same bits: every
    gradient element is summed by one block in a fixed order."""
    q, k, v, o, lse, do = bwd_inputs(dev, b, nq, nk, h, d)
    delta = fa.flash_bwd_delta(o, do)
    first = (fa.flash_bwd_dq(q, k, v, do, lse, delta), *fa.flash_bwd_dkv(q, k, v, do, lse, delta))
    second = (fa.flash_bwd_dq(q, k, v, do, lse, delta), *fa.flash_bwd_dkv(q, k, v, do, lse, delta))
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
def test_flash_attention_backward_gives_the_plain_gradients(dev, mode, monkeypatch):
    """`flash_attention(q, k, v).sum().backward()` on the card reaches q, k
    and v (the kernels used to return tensors with no grad_fn), with the
    gradients of autograd through `attention_plain`. "pallas" runs K3, K4
    and K5; "xla" (MOBI_FLASH_BWD) runs K1 and the plain backward."""
    monkeypatch.setattr(fa, "BWD_MODE", mode)
    leaves = [randn(dev, 2, 1024, 8, 40, seed=s).requires_grad_() for s in (17, 18, 19)]
    _build.reset_launches()
    out = fa.flash_attention(*leaves)
    out.float().sum().backward()
    torch.cuda.synchronize()
    launched = dict(_build.launches)
    if mode == "pallas":
        assert launched == counts(flash_fwd_lse=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    else:
        assert launched == counts(flash_fwd=1)
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    fa.attention_plain(*plain).float().sum().backward()
    for got, ref in zip(leaves, plain):
        assert got.grad is not None
        assert_close_std(got.grad, ref.grad)


def test_flash_attention_without_grad_runs_k1_alone(dev):
    q = randn(dev, 1, 1024, 8, 40, seed=20).requires_grad_()
    _build.reset_launches()
    with torch.no_grad():
        out = fa.flash_attention(q, q, q)
    assert out.grad_fn is None
    assert _build.launches == counts(flash_fwd=1)


@pytest.mark.parametrize("b,nq,nk,h,d", [
    (2, 4096, 4096, 8, 40),   # the UNet's 64x64 level, the one K2 serves
    (1, 1000, 1000, 8, 40),   # ragged N in both queries and keys
    (2, 130, 77, 4, 40),      # Nq != Nk, both ragged
    (1, 64, 1, 2, 40),        # a single key
    (1, 300, 300, 2, 48),     # the other head dims that pad to 48
    (2, 1024, 300, 8, 40),    # keys cut the third 128-key tile
    (2, 512, 100, 8, 40),     # fewer keys than one tile
    (1, 1000, 257, 4, 40),    # ragged queries, one key into the third tile
    (1, 300, 257, 2, 16),     # two of the 48 build's three boxes wholly past d
    (1, 300, 257, 2, 56),     # the 64 build
])
def test_flash_tav_matches_plain(dev, b, nq, nk, h, d):
    """K2 (the transposed accumulator) against its plain version, and the
    forward's switch: on, d < 64 goes to K2; off, to K1."""
    q = randn(dev, b, nq, h, d, seed=1)
    k, v = randn(dev, b, nk, h, d, seed=2), randn(dev, b, nk, h, d, seed=3)
    ref = fa.attention_plain(q, k, v)
    _build.reset_launches()
    out = fa.flash_fwd_tav(q, k, v)
    assert _build.launches == counts(flash_fwd_tav=1) and out.is_contiguous()
    assert_close(out, ref, FLASH_ATOL_STD * ref.float().std().item(), BF16_RTOL)
    saved = fa.TRANSPOSED_AV
    try:
        fa.set_transposed_av(True)
        _build.reset_launches()
        with torch.no_grad():
            switched = fa.flash_attention(q, k, v)
        assert _build.launches == counts(flash_fwd_tav=1)
    finally:
        fa.set_transposed_av(saved)
    torch.cuda.synchronize()
    assert torch.equal(switched, out)


def test_flash_tav_extreme_logits_and_strided_views(dev):
    q = torch.full((1, 256, 2, 40), 8.0, device=dev, dtype=torch.bfloat16)
    k, v = randn(dev, 1, 256, 2, 40, scale=8.0, seed=4), randn(dev, 1, 256, 2, 40, seed=5)
    ref = fa.attention_plain(q, k, v)
    assert_close(fa.flash_fwd_tav(q, k, v), ref, FLASH_ATOL_STD * ref.float().std().item(), BF16_RTOL)
    qkv = randn(dev, 2, 1024, 3, 8, 40, seed=6)
    q, k, v = qkv.unbind(2)
    out = fa.flash_fwd_tav(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, fa.flash_fwd_tav(q.contiguous(), k.contiguous(), v.contiguous()))


@pytest.mark.parametrize("kernel,b,nq,nk,h,d", [
    ("flash_fwd", 2, 4096, 4096, 8, 40),
    ("flash_fwd", 2, 1024, 1024, 8, 80),
    ("flash_fwd", 2, 130, 77, 4, 40),
    ("flash_fwd", 1, 300, 300, 2, 72),
    ("flash_fwd_tav", 2, 4096, 4096, 8, 40),  # K2: head dims below 64
    ("flash_fwd_tav", 2, 130, 77, 4, 40),
    ("flash_fwd", 1, 300, 257, 2, 20),        # the other builds, and d padded to 24
    ("flash_fwd", 1, 300, 257, 2, 64),
    ("flash_fwd", 2, 1024, 1024, 4, 128),
    ("flash_fwd_tav", 1, 300, 257, 2, 56),
])
def test_flash_fp32_matches_plain(dev, no_tf32, kernel, b, nq, nk, h, d):
    """K1 and K2 in fp32 (3xTF32 products) against the fp32 plain version,
    atol 2e-5."""
    q = randn(dev, b, nq, h, d, dtype=torch.float32, seed=1)
    k = randn(dev, b, nk, h, d, dtype=torch.float32, seed=2)
    v = randn(dev, b, nk, h, d, dtype=torch.float32, seed=3)
    _build.reset_launches()
    out = getattr(fa, kernel)(q, k, v)
    assert _build.launches == counts(**{kernel: 1}) and out.dtype == torch.float32
    assert_close(out, fa.attention_plain(q, k, v), F32_ATOL, 0)


def tf32_plain(fn, *args):
    """fn(*args) with TF32 matmuls: the control the fp32 tolerances must reject."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def assert_fp32_close(name, out, ref, ctl, input_scale=1.0):
    """out within F32_ATOL_STD of ref's std (+ the floor); the TF32 control
    ctl outside it."""
    atol = F32_ATOL_STD * ref.float().std().item() + F32_ATOL_MIN * input_scale
    assert_close(out, ref, atol, 0)
    assert (ctl - ref).abs().max().item() > atol, f"{name}: the TF32 control passes the fp32 tolerance"


FP32_SHAPES = [
    (2, 4096, 4096, 8, 40),   # the UNet's 64x64 level
    (2, 1024, 1024, 8, 80),   # ... its 32x32 level
    (2, 130, 77, 4, 80),      # Nq != Nk, both ragged
    (1, 300, 300, 2, 72),     # another head dim that pads to 80
    (2, 200, 100, 4, 40),     # Nq > Nk, neither a multiple of a tile
    (1, 300, 257, 2, 20),     # the other builds, and d padded to 24
    (1, 300, 257, 2, 64),
    (2, 1024, 1024, 4, 128),
]


@pytest.mark.parametrize("b,nq,nk,h,d", FP32_SHAPES)
def test_flash_lse_fp32_matches_plain(dev, no_tf32, b, nq, nk, h, d):
    """K3 in fp32 (3xTF32 products) against its fp32 plain version: o within
    F32_ATOL_STD of its std, lse within LSE_F32_ATOL; the plain version with
    TF32 on fails the o tolerance."""
    q = randn(dev, b, nq, h, d, dtype=torch.float32, seed=1)
    k = randn(dev, b, nk, h, d, dtype=torch.float32, seed=2)
    v = randn(dev, b, nk, h, d, dtype=torch.float32, seed=3)
    _build.reset_launches()
    out, lse = fa.flash_fwd_lse(q, k, v)
    assert _build.launches == counts(flash_fwd_lse=1) and out.dtype == torch.float32
    ref, ref_lse = fa.attention_lse_plain(q, k, v)
    assert_fp32_close("o", out, ref, tf32_plain(fa.attention_lse_plain, q, k, v)[0])
    assert_close(lse, ref_lse, LSE_F32_ATOL, 0)


@pytest.mark.parametrize("b,nq,nk,h,d", FP32_SHAPES)
def test_flash_bwd_fp32_matches_plain(dev, no_tf32, b, nq, nk, h, d):
    """K4 and K5 in fp32 against their fp32 plain versions on the plain
    forward's o and lse, and the gradients of `flash_attention` (K3, K4, K5)
    against autograd through `attention_plain`; the plain versions with TF32
    on fail the same tolerance."""
    q, k = (randn(dev, b, n, h, d, dtype=torch.float32, seed=s) for n, s in ((nq, 11), (nk, 12)))
    v, do = randn(dev, b, nk, h, d, dtype=torch.float32, seed=13), randn(
        dev, b, nq, h, d, dtype=torch.float32, seed=14)
    o, lse = fa.attention_lse_plain(q, k, v)
    delta = fa.flash_bwd_delta(o, do)
    _build.reset_launches()
    got = (fa.flash_bwd_dq(q, k, v, do, lse, delta), *fa.flash_bwd_dkv(q, k, v, do, lse, delta))
    assert _build.launches == counts(flash_bwd_dq=1, flash_bwd_dkv=1)
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in got)
    ref = fa.flash_bwd_plain(q, k, v, o, lse, do)
    ctl = tf32_plain(fa.flash_bwd_plain, q, k, v, o, lse, do)
    scale = max(rms(q), rms(k), 1.0)
    for name, g_, r_, c_ in zip(("dq", "dk", "dv"), got, ref, ctl):
        assert_fp32_close(name, g_, r_, c_, scale)

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves).backward(do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.attention_plain(*plain).backward(do)
    for name, got_, ref_, c_ in zip(("dq", "dk", "dv"), leaves, plain, ctl):
        assert_fp32_close(f"autograd {name}", got_.grad, ref_.grad, c_, scale)


@pytest.mark.parametrize("shape", [(8, 960, 64, 64), (2, 320, 64, 64), (2, 96, 8, 9), (2, 64, 7, 9)])
def test_gn_silu_fp32_matches_plain(dev, no_tf32, shape):
    c = shape[1]
    x = randn(dev, *shape, scale=2.0, dtype=torch.float32, seed=8) + 0.5
    w = randn(dev, c, dtype=torch.float32, seed=9).abs() + 0.5
    bias = randn(dev, c, dtype=torch.float32, seed=10)
    _build.reset_launches()
    out = fn.fused_groupnorm_silu(x, w, bias, 32, 1e-5)
    assert _build.launches == counts(gn_silu=1) and out.dtype == torch.float32
    assert_close(out, fn.groupnorm_silu_plain(x, w, bias, 32, 1e-5), GN_F32_ATOL, GN_F32_RTOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [136, 160, 192, 256])
@pytest.mark.parametrize("n", [64, 256, 1000])
def test_flash_wide_head_dims_match_plain(dev, no_tf32, dtype, d, n):
    """Head dims above 128, which the kernels split into slices of the output
    columns (80 for d <= 160, else 64; 136 pads to the 160 build and leaves a
    slice half past d, 192 and 256 fill theirs): K1, K3 (o and lse), K4 and
    K5 against their plain versions, with the tolerances of the UNet's head
    dims (bf16: FLASH_ATOL_STD of the std; fp32: 2e-5 for K1, F32_ATOL_STD
    of the std for the others). N = 64 is less than one tile; 1000 is ragged."""
    shape = (2, n, 2, d)
    q, k, v, do = (randn(dev, *shape, dtype=dtype, seed=s) for s in (31, 32, 33, 34))
    _build.reset_launches()
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    o, lse = fa.flash_fwd_lse(q, k, v)
    ref_o, ref_lse = fa.attention_lse_plain(q, k, v)
    delta = fa.flash_bwd_delta(ref_o, do)
    got = (fa.flash_bwd_dq(q, k, v, do, ref_lse, delta), *fa.flash_bwd_dkv(q, k, v, do, ref_lse, delta))
    assert _build.launches == counts(flash_fwd=1, flash_fwd_lse=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    assert all(t.shape == shape and t.is_contiguous() for t in (out, o, *got))
    refs = fa.flash_bwd_plain(q, k, v, ref_o, ref_lse, do)
    scale = max(rms(q), rms(k), 1.0)
    if dtype == torch.bfloat16:
        assert_close(out, ref_o, FLASH_ATOL_STD * ref_o.float().std().item(), BF16_RTOL)
        assert_close_std(o, ref_o)
        assert_close(lse, ref_lse, LSE_ATOL, LSE_RTOL)
        for g_, r_ in zip(got, refs):
            assert_close_std(g_, r_, scale)
    else:
        assert_close(out, ref_o, F32_ATOL, 0)
        assert_close(lse, ref_lse, LSE_F32_ATOL, 0)
        for g_, r_ in zip((o, *got), (ref_o, *refs)):
            assert_close(g_, r_, F32_ATOL_STD * r_.std().item() + F32_ATOL_MIN * scale, 0)


def test_flash_refuses_what_the_kernel_does_not_take(dev):
    q = randn(dev, 1, 128, 2, 40)
    _build.reset_launches()
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    for d in (264, 320):  # above the widest build, 256 (the JAX kernel takes them)
        with pytest.raises(ValueError, match=f"head dim {d}:"):
            other = randn(dev, 1, 128, 2, d)
            fa.flash_attention(other, other, other)
    with pytest.raises(ValueError, match="unit stride"):
        fa.flash_attention(q, q, randn(dev, 1, 128, 40, 2).transpose(2, 3))
    with pytest.raises(ValueError, match="aligned"):
        padded = randn(dev, 1, 128, 2, 48)[..., 1:41]
        fa.flash_attention(padded, padded, padded)
    with pytest.raises(ValueError, match="cpu"):
        fa.flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError):  # mixed dtypes
        fa.flash_attention(q, q.float(), q)
    for d in (64, 80):  # K2 serves head dims below 64, as in the JAX package
        with pytest.raises(ValueError, match="head dim"):
            other = randn(dev, 1, 128, 2, d)
            fa.flash_fwd_tav(other, other, other)
    with pytest.raises(TypeError):
        fa.flash_fwd_tav(q.half(), q.half(), q.half())
    assert _build.launches == counts()


def test_flash_lse_and_bwd_refuse_what_the_kernels_do_not_take(dev):
    q = randn(dev, 1, 128, 2, 40)
    lse = torch.zeros(1, 2, 128, device=dev)
    _build.reset_launches()
    with pytest.raises(TypeError):  # bf16 and fp32 only
        fa.flash_fwd_lse(q.half(), q.half(), q.half())
    for fn_ in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(TypeError):
            fn_(q.half(), q.half(), q.half(), q.half(), lse, lse)
        with pytest.raises(TypeError):  # dO in another dtype
            fn_(q, q, q, q.float(), lse, lse)
        with pytest.raises(ValueError, match="float32"):
            fn_(q, q, q, q, lse.bfloat16(), lse)
        with pytest.raises(ValueError, match="float32"):  # lse of another shape
            fn_(q, q, q, q, lse[:, :, :64], lse)
    for d in (264, 320):  # above the widest build, 256
        other = randn(dev, 1, 128, 2, d)
        with pytest.raises(ValueError, match=f"head dim {d}:"):
            fa.flash_fwd_lse(other, other, other)
        for fn_ in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
            with pytest.raises(ValueError, match=f"head dim {d}:"):
                fn_(other, other, other, other, lse, lse)
    assert _build.launches == counts()


@pytest.mark.parametrize("shape", [
    (2, 320, 64, 64),   # the UNet's widest-span ResBlock norms
    (2, 960, 64, 64),
    (2, 1920, 16, 16),
    (2, 2560, 8, 8),
    (2, 96, 8, 9),      # a span that is not a multiple of the block's loads
    (2, 16, 4, 4),      # fewer channels than groups: one channel a group
    (2, 64, 7, 9),      # H * W not a multiple of 8: unaligned spans, chunks across channels
    (2, 96, 5, 5),      # ... and spans shorter than one 16-byte load's reach
])
def test_gn_silu_matches_plain(dev, shape):
    c = shape[1]
    x = randn(dev, *shape, scale=2.0, seed=8) + 0.5
    w = randn(dev, c, dtype=torch.float32, seed=9).abs() + 0.5
    bias = randn(dev, c, dtype=torch.float32, seed=10)
    _build.reset_launches()
    out = fn.fused_groupnorm_silu(x, w, bias, 32, 1e-5)
    assert _build.launches == counts(gn_silu=1)
    assert_close(out, fn.groupnorm_silu_plain(x, w, bias, 32, 1e-5), GN_ATOL, BF16_RTOL)


# The 14 shapes (B, C, H, W) of the 45 ResBlock norms of one UNet forward at
# the flagship's batch 8 (configs/mobi_nusc_512.yaml; chip_smoke.py's
# unet_norm_calls), widest span first by level.
GN_MAIN_SHAPES = [
    (8, 320, 64, 64), (8, 320, 32, 32), (8, 640, 32, 32), (8, 640, 16, 16), (8, 1280, 16, 16),
    (8, 1280, 8, 8), (8, 2560, 8, 8), (8, 2560, 16, 16), (8, 1920, 16, 16), (8, 1920, 32, 32),
    (8, 1280, 32, 32), (8, 960, 32, 32), (8, 960, 64, 64), (8, 640, 64, 64),
]


def gn_case(dev, shape, dtype, plan=None):
    """The kernel (with `plan`, else gn_plan's) against the plain version."""
    c = shape[1]
    x = randn(dev, *shape, scale=2.0, dtype=dtype, seed=8) + 0.5
    w = randn(dev, c, dtype=torch.float32, seed=9).abs() + 0.5
    bias = randn(dev, c, dtype=torch.float32, seed=10)
    _build.reset_launches()
    out = fn._gn_silu_cuda(x, w, bias, 32, 1e-5, plan)
    assert _build.launches == counts(gn_silu=1) and out.dtype == dtype
    atol, rtol = (GN_ATOL, BF16_RTOL) if dtype == torch.bfloat16 else (GN_F32_ATOL, GN_F32_RTOL)
    assert_close(out, fn.groupnorm_silu_plain(x, w, bias, 32, 1e-5), atol, rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GN_MAIN_SHAPES)
def test_gn_silu_main_path_shapes_match_plain(dev, no_tf32, shape, dtype):
    """K6 at every main-path shape, in both dtypes, with the plan the
    wrapper picks (no main-path shape takes the streaming variant)."""
    b, c, h, w = shape
    assert fn.gn_plan(b, c, 32, h * w, torch.tensor([], dtype=dtype).element_size()).variant != "stream"
    gn_case(dev, shape, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,want", [
    ((3, 31, 240, 240), "cluster_smem"),  # 93 spans: B * G not a multiple of the cluster size
    ((2, 128, 90, 90), "cluster_smem"),   # H * W not a multiple of 8: chunks across channels
    ((2, 64, 6, 6), "cluster_regs"),      # ... in a span of 72 elements held in registers
    ((2, 64, 2, 2), "cluster_regs"),      # a span of 8 elements, less than one thread's share
    ((2, 96, 5, 5), "stream"),       # a span of 75 elements: not a multiple of 16 bytes
])
def test_gn_silu_edges_match_plain(dev, no_tf32, shape, want, dtype):
    b, c, h, w = shape
    plan = fn.gn_plan(b, c, min(32, c), h * w, torch.tensor([], dtype=dtype).element_size())
    assert plan.variant == want
    if shape[0] == 3:
        assert (b * min(32, c)) % plan.cluster
    gn_case(dev, shape, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("plan", [
    fn.GnPlan("stream", 1, 0, 512),
    fn.GnPlan("cluster_smem", 1, 0, 128), fn.GnPlan("cluster_smem", 2, 0, 512),
    fn.GnPlan("cluster_smem", 3, 0, 256), fn.GnPlan("cluster_smem", 8, 0, 256),
    fn.GnPlan("cluster_smem", 5, 0, 32),
    fn.GnPlan("cluster_regs", 1, 0, 256), fn.GnPlan("cluster_regs", 1, 0, 512),
    fn.GnPlan("cluster_regs", 3, 0, 128), fn.GnPlan("cluster_regs", 8, 0, 64),
])
def test_gn_silu_every_variant_matches_plain(dev, no_tf32, plan, dtype):
    """Each variant and cluster size on one span (2, 640, 16, 16): 10 KB in
    bf16, 20 KB in fp32, which all of them take; the chunk is the span over
    the cluster."""
    span = 640 // 32 * 16 * 16
    if plan.variant.startswith("cluster"):
        plan = fn.GnPlan(plan.variant, plan.cluster, -(-span // plan.cluster // 8) * 8, plan.threads)
    gn_case(dev, (2, 640, 16, 16), dtype, plan)


def test_gn_silu_refuses_a_plan_the_kernel_does_not_take(dev):
    """The C entry point checks the plan: a cluster past 8 blocks, chunks
    that leave part of the span or an empty block, a block size off the
    warps or past 512, a chunk past a block's registers (8 16-byte entries a
    thread), a stream block other than 512."""
    x = randn(dev, 2, 640, 16, 16)
    w = torch.ones(640, device=dev)
    span = 640 // 32 * 16 * 16
    _build.reset_launches()
    for plan in (fn.GnPlan("cluster_smem", 9, span // 8, 256), fn.GnPlan("cluster_smem", 2, span // 4, 256),
                 fn.GnPlan("cluster_regs", 4, span // 2, 256), fn.GnPlan("cluster_smem", 1, span, 1024),
                 fn.GnPlan("cluster_regs", 1, span, 48), fn.GnPlan("cluster_regs", 1, span, 32),
                 fn.GnPlan("stream", 1, span, 256)):
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            fn._gn_silu_cuda(x, w, w, 32, 1e-5, plan)
    assert _build.launches == counts()


def test_gn_silu_backward_gives_the_plain_gradients(dev):
    """A fused norm on the card keeps the autograd graph: the kernel
    forward, then autograd of the plain version recomputed from (x, weight,
    bias), the same gradients as autograd through the plain version."""
    x = (randn(dev, 2, 320, 64, 64, scale=2.0, seed=21) + 0.5).requires_grad_()
    w = (randn(dev, 320, dtype=torch.float32, seed=22).abs() + 0.5).requires_grad_()
    bias = randn(dev, 320, dtype=torch.float32, seed=23).requires_grad_()
    r = randn(dev, 2, 320, 64, 64, dtype=torch.float32, seed=24)
    _build.reset_launches()
    (fn.fused_groupnorm_silu(x, w, bias, 32, 1e-5).float() * r).sum().backward()
    assert _build.launches == counts(gn_silu=1)
    plain = [t.detach().clone().requires_grad_() for t in (x, w, bias)]
    (fn.groupnorm_silu_plain(*plain, 32, 1e-5).float() * r).sum().backward()
    torch.cuda.synchronize()
    for got, ref in zip((x, w, bias), plain):
        assert torch.equal(got.grad, ref.grad)


def test_gn_silu_refuses_what_the_kernel_does_not_take(dev):
    x = randn(dev, 2, 64, 8, 8)
    w = torch.ones(64, device=dev)
    _build.reset_launches()
    with pytest.raises(TypeError):  # bf16 and fp32 only
        fn.fused_groupnorm_silu(x.half(), w, w)
    with pytest.raises(ValueError, match="contiguous"):
        fn.fused_groupnorm_silu(x.to(memory_format=torch.channels_last), w, w)
    with pytest.raises(ValueError, match="float32"):
        fn.fused_groupnorm_silu(x, w.bfloat16(), w)
    with pytest.raises(ValueError, match="divisible"):
        fn.fused_groupnorm_silu(randn(dev, 2, 48, 8, 8), torch.ones(48, device=dev),
                                torch.ones(48, device=dev))
    assert _build.launches == counts()
