"""The port's lidar VQ autoencoder (mobi_tpu_torch/models/lidar_vq.py)
against the JAX package's on the CPU, in fp32: the circular padding, the
circular conv at every table stride and kernel, the encoder and decoder,
the quantizer, VQModel with and without its mask channel and
VQModelInterface. Each JAX tree is filled from a numpy seed, converted with
`convert.vq_state_dict` and loaded with strict=True.

Tolerances: the padding exact, the quantizer's indices equal, its loss
within 1e-6 relative, everything else within 1e-5 relative L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu.models import lidar_vq as jvq
from mobi_tpu_torch import convert
from mobi_tpu_torch.models import lidar_vq as tvq
from tests.test_torch_legacy_models import few_torch_threads, launches_stay_zero, nchw, random_tree, rel_l2  # noqa: F401

DD = dict(ch=32, ch_mult=(1, 2), strides=((1, 2),), num_res_blocks=1, attn_levels=(1,),
          in_channels=1, z_channels=8)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def range_image(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("pad", [(2, 2, 0, 0), (0, 1, 1, 1), (3, 3, 0, 0), (0, 0, 2, 2), (1, 2, 0, 0), (5, 0, 1, 0)])
def test_circular_pad_matches_jax(pad):
    x = range_image((2, 4, 6, 3))
    want = np.asarray(jvq.circular_pad(jnp.asarray(x), pad))
    assert np.array_equal(nhwc(tvq.circular_pad(nchw(x), pad)), want)


CONV_CASES = ([("down", s) for s in tvq.DOWN_TABLE] + [("up", s) for s in tvq.UP_TABLE]
              + [("kernel", k) for k in tvq.KERNEL2PAD])


@pytest.mark.parametrize("table,key", CONV_CASES)
def test_circular_conv_matches_jax(table, key):
    if table == "kernel":
        kernel, strides, pad = key, (1, 1), None
    else:
        kernel, pad = (tvq.DOWN_TABLE if table == "down" else tvq.UP_TABLE)[key]
        strides = key if table == "down" else (1, 1)
    assert (kernel, pad) == ((jvq._DOWN_TABLE if table == "down" else jvq._UP_TABLE)[key]
                             if table != "kernel" else (key, None))
    x = range_image((2, 8, 32, 3), seed=1)
    jm = jvq.CircularConv(5, kernel, strides, pad)
    params = random_tree(jm, x, seed=2)
    tm = tvq.CircularConv(3, 5, kernel, strides, pad)
    tm.load_state_dict(convert.vq_state_dict(params), strict=True)
    want = np.asarray(jm.apply({"params": params}, x))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape and rel_l2(got, want) < 1e-5


@pytest.mark.parametrize("strides", [((1, 2),), ((2, 2),), ((2, 1),), ((1, 4),)])
def test_encoder_and_decoder_match_jax(strides):
    dd = dict(DD, strides=strides)
    x = range_image((2, 8, 32, 1), seed=3)
    je = jvq.VQEncoder(**dd)
    ep = random_tree(je, x, seed=4)
    te = tvq.VQEncoder(**dd)
    te.load_state_dict(convert.vq_state_dict(ep), strict=True)
    z = np.asarray(jax.jit(je.apply)({"params": ep}, x))
    with torch.no_grad():
        zt = nhwc(te(nchw(x)))
    assert rel_l2(zt, z) < 1e-5

    dec_kw = {k: v for k, v in dd.items() if k != "in_channels"}
    jd = jvq.VQDecoder(out_ch=1, **dec_kw)
    dp = random_tree(jd, z, seed=5)
    td = tvq.VQDecoder(out_ch=1, **dec_kw)
    td.load_state_dict(convert.vq_state_dict(dp), strict=True)
    want = np.asarray(jax.jit(jd.apply)({"params": dp}, z))
    with torch.no_grad():
        got = nhwc(td(nchw(z)))
    assert got.shape == want.shape == x.shape and rel_l2(got, want) < 1e-5


def test_vector_quantizer_matches_jax():
    jm = jvq.VectorQuantizer(n_embed=64, embed_dim=4)
    z = np.random.default_rng(6).normal(0, 0.02, (2, 3, 5, 4)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(7), z)["params"]  # flax's U[0, 2 / n_embed) codebook
    quant, loss, idx = (np.asarray(a) for a in jm.apply({"params": params}, z))
    tm = tvq.VectorQuantizer(64, 4)
    sd = convert.vq_state_dict({"quantize": params})
    tm.load_state_dict({k.removeprefix("quantize."): v for k, v in sd.items()}, strict=True)
    zt = nchw(z).requires_grad_(True)
    q, l, i = tm(zt)
    assert np.array_equal(i.numpy(), idx) and len(np.unique(idx)) > 1
    assert rel_l2(l.detach(), loss) < 1e-6
    assert rel_l2(nhwc(q), quant) < 1e-6
    (q * 2.0).sum().backward()  # straight-through: d quant / d z = identity
    assert torch.equal(zt.grad, torch.full_like(zt, 2.0))


@pytest.mark.parametrize("use_mask", [False, True])
def test_vqmodel_matches_jax(use_mask):
    x = range_image((2, 8, 32, 1), seed=8)
    jm = jvq.VQModel(ddconfig=DD, n_embed=32, embed_dim=4, use_mask=use_mask)
    params = random_tree(jm, x, seed=9)
    tm = tvq.VQModel(ddconfig=DD, n_embed=32, embed_dim=4, use_mask=use_mask, device="cpu")
    tm.load_state_dict(convert.vq_state_dict(params), strict=True)
    rec, emb_loss = (np.asarray(a) for a in jax.jit(jm.apply)({"params": params}, x))
    with torch.no_grad():
        got, got_loss = tm(nchw(x))
    assert got.shape == (2, 1, 8, 32)
    assert rel_l2(nhwc(got), rec) < 1e-5 and rel_l2(got_loss, emb_loss) < 1e-5
    if use_mask:  # masked pixels are -1 exactly, on both sides alike
        assert np.array_equal(nhwc(got) == -1.0, rec == -1.0) and (rec == -1.0).any()


def test_vqmodel_interface_matches_jax():
    x = range_image((1, 8, 32, 2), seed=10)
    jm = jvq.VQModelInterface(ddconfig=DD, n_embed=32, embed_dim=4)
    params = random_tree(jm, x, seed=11)
    tm = tvq.VQModelInterface(ddconfig=DD, n_embed=32, embed_dim=4, device="cpu")
    tm.load_state_dict(convert.vq_state_dict(params), strict=True)
    h = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a, method=jvq.VQModelInterface.encode))(params, x))
    decode = jax.jit(lambda p, a, force: jm.apply({"params": p}, a, force, method=jvq.VQModelInterface.decode),
                     static_argnums=2)
    with torch.no_grad():
        ht = tm.encode(nchw(x))
    assert ht.shape == (1, 4, 8, 16) and rel_l2(nhwc(ht), h) < 1e-5
    for force in (False, True):
        want = np.asarray(decode(params, h, force))
        with torch.no_grad():
            got = nhwc(tm.decode(nchw(h), force_not_quantize=force))
        assert rel_l2(got, want) < 1e-5, force
    with torch.no_grad():
        assert torch.equal(tm(nchw(x)), tm.decode(tm.encode(nchw(x))))
