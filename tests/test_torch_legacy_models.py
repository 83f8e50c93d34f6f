"""The port's legacy model surfaces against the JAX package on the CPU, in
fp32: EncoderUNetModel (every pool), the noisy-latent classifier's loss,
gradients and Adam step, ClassEmbedder, the CLIP text tower, the text
transformer (TransformerWrapper, BERTEmbedder) and SpatialRescaler.

Each JAX tree is filled from a numpy seed (no layer at its zero init, so
every branch reaches the output), converted with `mobi_tpu_torch.convert`
and loaded with strict=True. JAX's matmuls run at "highest" precision
(tests/conftest.py). Tolerances, relative L2: the models' outputs 1e-5, the
classifier's loss, metrics and gradients 1e-4, Adam's update on the same
gradients 1e-6 of optax's (a whole step from each side's own gradients
1e-3), SpatialRescaler 1e-6, ClassEmbedder exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mobi_tpu.models.classifier import NoisyLatentClassifier as JaxClassifier
from mobi_tpu.models.clip import CLIPTextTower as JaxCLIPText
from mobi_tpu.models.encoders import ClassEmbedder as JaxClassEmbedder
from mobi_tpu.models.text_transformer import BERTEmbedder as JaxBERT
from mobi_tpu.models.text_transformer import SpatialRescaler as JaxRescaler
from mobi_tpu.models.text_transformer import TransformerWrapper as JaxWrapper
from mobi_tpu.models.unet import EncoderUNetModel as JaxEncoderUNet
from mobi_tpu_torch import convert
from mobi_tpu_torch.models.classifier import NoisyLatentClassifier, make_classifier_train_step
from mobi_tpu_torch.models.clip import CLIPTextTower
from mobi_tpu_torch.models.encoders import ClassEmbedder
from mobi_tpu_torch.models.text_transformer import BERTEmbedder, SpatialRescaler, TransformerWrapper
from mobi_tpu_torch.models.unet import EncoderUNetModel
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops import attention as tattn
from mobi_tpu_torch.training import AdamWLowMu


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """One intra-op thread, as tests/test_torch_models.py: the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


def random_tree(module, *args, seed=0):
    """`module`'s JAX parameter tree (shapes by eval_shape) filled from a
    numpy seed: kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.01), other
    vectors N(0, 0.01), embedding tables N(0, 0.02)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = jax.tree_util.keystr(path)
        if len(s.shape) >= 2 and "kernel" not in key:  # a table or a learned query
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5).astype(np.float32)
        base = 1.0 if key.endswith("['scale']") else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


ENC_KW = dict(in_channels=4, model_channels=32, out_channels=7, num_res_blocks=1,
              attention_resolutions=(1, 2), channel_mult=(1, 2), num_heads=2)


def encoder_pair(pool, size=8, seed=0):
    """A JAX and a port EncoderUNetModel with the same seeded weights, and
    inputs: x [2, size, size, 4] (NHWC), t [2]."""
    jm = JaxEncoderUNet(pool=pool, **ENC_KW)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    t = np.array([3, 700], np.int32)
    params = random_tree(jm, x, t, seed=seed)
    tm = EncoderUNetModel(pool=pool, **ENC_KW)
    tm.load_state_dict(convert.encoder_unet_state_dict(params), strict=True)
    return jm, params, tm, x, t


@pytest.mark.parametrize("pool", ["adaptive", "spatial", "spatial_v2", "attention"])
def test_encoder_unet_matches_jax(pool):
    jm, params, tm, x, t = encoder_pair(pool)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, x, t))
    with torch.no_grad():
        got = tm(nchw(x), torch.from_numpy(t))
    assert got.dtype == torch.float32 and got.shape == (2, 7)
    assert rel_l2(got, want) < 1e-5


def test_encoder_unet_routes_long_attention_to_flash(monkeypatch):
    """With the "auto" rule's least length lowered to the 8 x 8 level's 64
    tokens, the trunk attentions at ds 1 go through the flash wrapper (its
    plain version on the CPU) with and without a gradient, those at ds 2
    (16 tokens) and the one-query pool do not, and the logits and the input
    gradient equal JAX's."""
    jm, params, tm, x, t = encoder_pair("attention")
    monkeypatch.setattr(tattn, "FLASH_MIN_SEQ", 64)
    calls, flash = [], tattn.flash_attention
    monkeypatch.setattr(tattn, "flash_attention", lambda q, k, v: calls.append(q.shape) or flash(q, k, v))

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, t) ** 2)

    want_val, want_grad = jax.jit(jax.value_and_grad(loss, argnums=1))(params, x)
    xt = nchw(x).requires_grad_(True)
    val = (tm(xt, torch.from_numpy(t)) ** 2).sum()
    val.backward()
    assert calls == [(2, 64, 2, 16)]
    assert rel_l2(val.detach(), want_val) < 1e-5
    assert rel_l2(xt.grad.permute(0, 2, 3, 1), want_grad) < 1e-5
    with torch.no_grad():
        tm(nchw(x), torch.from_numpy(t))
    assert len(calls) == 2


def test_classifier_loss_gradients_and_adam_step_match_jax():
    """The JAX loss draws t and the noise from its key; the same draws go to
    the port. Widths of 64 keep two channels a norm group, so no conv bias
    ahead of a norm has a gradient of pure rounding noise for Adam's first
    step to turn into an update of either sign."""
    kw = dict(num_classes=3, in_channels=4, model_channels=64, channel_mult=(1,),
              num_res_blocks=1, attention_resolutions=(1,), pool="attention", num_timesteps=50)
    jclf = JaxClassifier(**kw)
    params = random_tree(jclf.model, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32), seed=3)
    rng = np.random.default_rng(4)
    z0 = rng.standard_normal((4, 8, 8, 4)).astype(np.float32)
    labels = np.array([0, 2, 1, 2], np.int32)
    key = jax.random.PRNGKey(5)
    k_t, k_n = jax.random.split(key)
    t = np.array(jax.random.randint(k_t, (4,), 0, 50))
    noise = np.array(jax.random.normal(k_n, z0.shape, jnp.float32))

    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(jclf.loss, has_aux=True))(
        params, z0, labels, key)

    clf = NoisyLatentClassifier(device="cpu", **kw)
    clf.model.load_state_dict(convert.encoder_unet_state_dict(params), strict=True)
    before = {k: v.detach().clone() for k, v in clf.model.named_parameters()}
    loss, m = clf.loss(torch.from_numpy(z0).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(labels),
                       t=torch.from_numpy(t), noise=nchw(noise))
    loss.backward()
    assert rel_l2(loss.detach(), want_loss) < 1e-4
    for name in ("loss", "accuracy", "t_mean"):
        assert rel_l2(m[name], want_m[name]) < 1e-4, name
    grads = convert.encoder_unet_state_dict(jax.tree.map(np.asarray, want_g))
    for name, p in clf.model.named_parameters():
        assert rel_l2(p.grad, grads[name]) < 1e-4, name

    # Adam on the same gradients: optax's update within 1e-6
    tx = optax.adam(1e-3)
    want_upd = jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])(want_g, params)
    want_upd = convert.encoder_unet_state_dict(jax.tree.map(np.asarray, want_upd))
    opt = AdamWLowMu(clf.model.parameters(), 1e-3, torch.float32, weight_decay=0.0)
    with torch.no_grad():  # from zero, the parameters after the step are the update, unrounded
        for name, p in clf.model.named_parameters():
            p.zero_()
            p.grad = grads[name].clone()
    opt.step()
    names = [n for n, _ in clf.model.named_parameters()]
    got = np.concatenate([p.detach().numpy().ravel() for p in clf.model.parameters()])
    assert rel_l2(got, np.concatenate([want_upd[n].numpy().ravel() for n in names])) < 1e-6

    # the whole step from the port's own gradients against JAX's step (its
    # gradients, then optax's update: make_classifier_train_step's body): entries
    # whose gradient is below Adam's eps (1e-8) turn rounding into updates of
    # up to ~7% of lr, so the tree agrees to ~2e-4 (1e-6 on shared gradients)
    clf.model.load_state_dict(convert.encoder_unet_state_dict(params), strict=True)
    step = make_classifier_train_step(clf, AdamWLowMu(clf.model.parameters(), 1e-3, torch.float32,
                                                         weight_decay=0.0))
    metrics = step(torch.from_numpy(z0).permute(0, 3, 1, 2).contiguous(), torch.from_numpy(labels),
                   t=torch.from_numpy(t), noise=nchw(noise))
    assert rel_l2(metrics["loss"], want_loss) < 1e-4
    got = np.concatenate([(p.detach() - before[n]).numpy().ravel() for n, p in clf.model.named_parameters()])
    assert rel_l2(got, np.concatenate([want_upd[n].numpy().ravel() for n in names])) < 1e-3


def test_classifier_draws_t_and_noise_from_its_generator():
    clf = NoisyLatentClassifier(num_classes=3, model_channels=32, channel_mult=(1,), num_res_blocks=1,
                                attention_resolutions=(), pool="adaptive", num_timesteps=10, device="cpu")
    z0 = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    runs = [clf.loss(z0, torch.tensor([0, 1]), generator=torch.Generator().manual_seed(s))[1]["t_mean"]
            for s in (1, 1, 2)]
    assert runs[0] == runs[1] and 0 <= float(runs[0]) < 10
    # JAX's init: the adaptive head is zero, so are its logits
    assert not clf.model.out_proj.weight.any()


def test_class_embedder_matches_jax():
    jm = JaxClassEmbedder(num_classes=5, embed_dim=16)
    labels = np.array([0, 3, 3, 4], np.int32)
    params = random_tree(jm, labels, seed=6)
    tm = ClassEmbedder(5, 16, device="cpu")
    tm.load_state_dict(convert.class_embedder_state_dict(params), strict=True)
    want = np.asarray(jm.apply({"params": params}, labels))
    assert np.array_equal(tm(torch.from_numpy(labels)).numpy(), want)
    table = np.asarray(params["text_embeddings"])
    assert np.array_equal(ClassEmbedder(5, 16, table_init=table, device="cpu")(torch.from_numpy(labels)).numpy(),
                          want)
    assert not ClassEmbedder(5, 16, device="cpu").text_embeddings.requires_grad


def test_clip_text_tower_matches_jax():
    kw = dict(vocab_size=64, max_positions=16, width=32, layers=2, heads=4)
    jm = JaxCLIPText(**kw)
    ids = np.random.default_rng(7).integers(0, 64, (2, 12)).astype(np.int32)
    params = random_tree(jm, ids, seed=8)
    tm = CLIPTextTower(device="cpu", **kw)
    tm.load_state_dict(convert.clip_text_state_dict(params), strict=True)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    assert rel_l2(got, want) < 1e-5
    # causal: a later token leaves the earlier positions as they were
    ids2 = ids.copy()
    ids2[:, 9] = (ids2[:, 9] + 1) % 64
    with torch.no_grad():
        got2 = tm(torch.from_numpy(ids2).long())
    assert torch.equal(got2[:, :9], got[:, :9]) and not torch.equal(got2[:, 9:], got[:, 9:])


TW_KW = dict(num_tokens=50, max_seq_len=8, dim=32, depth=2, heads=2)


@pytest.mark.parametrize("masked", ["none", "padding", "fully_padded_row"])
def test_transformer_wrapper_matches_jax(masked):
    jm = JaxWrapper(**TW_KW)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 50, (3, 8)).astype(np.int32)
    mask = None
    if masked != "none":
        mask = np.arange(8)[None] < np.array([[3], [8], [5]])
        if masked == "fully_padded_row":
            mask[1] = False
    params = random_tree(jm, ids, mask, seed=10)
    tm = TransformerWrapper(**TW_KW)
    tm.load_state_dict(convert.text_transformer_state_dict(params), strict=True)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, ids, mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), None if mask is None else torch.from_numpy(mask))
    assert bool(torch.isfinite(got).all()) and np.isfinite(want).all()
    assert rel_l2(got, want) < 1e-5


def test_bert_embedder_matches_jax():
    kw = dict(n_embed=32, n_layer=2, vocab_size=100, max_seq_len=12)
    jm = JaxBERT(**kw)
    ids = np.random.default_rng(11).integers(0, 100, (2, 12)).astype(np.int32)
    params = random_tree(jm, ids, seed=12)
    tm = BERTEmbedder(device="cpu", **kw)
    tm.load_state_dict(convert.text_transformer_state_dict(params), strict=True)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, ids))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long())
    assert rel_l2(got, want) < 1e-5
    # the padding mask reaches the wrapper: a masked key leaves kept rows alone
    mask = torch.arange(12)[None].expand(2, 12) < 7
    ids2 = ids.copy()
    ids2[:, 9] = (ids2[:, 9] + 1) % 100
    with torch.no_grad():
        a, b = tm(torch.from_numpy(ids).long(), mask), tm(torch.from_numpy(ids2).long(), mask)
    assert torch.allclose(a[:, :7], b[:, :7], rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_stages,multiplier,out_channels,method", [
    (1, 0.5, None, "bilinear"), (2, 0.5, 4, "bilinear"), (1, 2.0, None, "bilinear"),
    (1, 0.5, None, "nearest"),
])
def test_spatial_rescaler_matches_jax(n_stages, multiplier, out_channels, method):
    kw = dict(n_stages=n_stages, multiplier=multiplier, out_channels=out_channels, method=method)
    jm = JaxRescaler(**kw)
    x = np.random.default_rng(13).standard_normal((2, 16, 12, 3)).astype(np.float32)
    params = random_tree(jm, x, seed=14) if out_channels else {}
    tm = SpatialRescaler(in_channels=3, device="cpu", **kw)
    tm.load_state_dict(convert.text_transformer_state_dict(params), strict=True)
    want = np.asarray(jm.apply({"params": params}, x))
    with torch.no_grad():
        got = tm(nchw(x)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert rel_l2(got, want) < 1e-6
