"""The port's models (mobi_tpu_torch) against the JAX package on the tiny
config of tests/test_diffusion.py, in fp32 on the CPU.

One JAX model gets seeded random parameters, which are converted with
`mobi_tpu_torch.convert` and loaded into the port with strict=True. Random
draws never match across the two frameworks, so the parity tests encode
with the posterior mode and pin x_T. The JAX suite runs its matmuls at
"highest" precision (tests/conftest.py), so both sides compute in full fp32;
the tolerances below cover summation order over the tiny model's depth.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu.export_torch import export_from_config
from mobi_tpu_torch import convert
from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.models.encoders import CondStageModel
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops import fused_norm as tfn
from mobi_tpu_torch.pipeline import make_inpaint_pipeline
from mobi_tpu.models.diffusion import MobiDiffusion as JaxMobi
from tests.test_diffusion import TINY, TinyCondStage, make_batch

STEPS, GUIDANCE = 5, 5.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_config(cfg, dtype=torch.float32):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(tdiff.MobiConfig)
              if f.name != "dtype"}
    return tdiff.MobiConfig(dtype=dtype, **fields)


def tiny_cond_stage():
    """The port's twin of tests/test_diffusion.py::TinyCondStage."""
    return CondStageModel(clip_width=96, clip_image_size=32, clip_patch_size=16,
                          clip_layers=2, clip_heads=4, mapper_layers=2,
                          bbox_proj_dims=(64, 48, 48, 64))


def numpy_batch(batch):
    return jax.tree.map(np.asarray, batch)


def random_params(jmodel, seed=0):
    """The JAX parameter tree of `jmodel` filled from a numpy seed: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.01), other vectors N(0, 0.01).
    No layer sits at its zero init, so every branch reaches the output (at
    flax init the UNet's eps is exactly 0 in both packages). The shapes come
    from eval_shape, which is far quicker than running flax init here."""
    shapes = jax.eval_shape(jmodel._init_params_impl, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5).astype(np.float32)
        base = 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else 0.0
        return (base + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """One intra-op thread: the suite runs several test processes side by
    side, and torch's default of one thread per core oversubscribes the host
    (the tiny model's many small ops then spend their time waiting)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jmodel = JaxMobi(TINY)
    jmodel.cond_model = TinyCondStage(conditions=("ref_image", "ref_bbox"))
    params_np = random_params(jmodel)
    params = jax.tree.map(jnp.asarray, params_np)
    tmodel = tdiff.MobiDiffusion(port_config(TINY), device="cpu",
                                 cond_stage_model=tiny_cond_stage())
    tmodel.load_jax_params(params_np)

    batch = make_batch(b=2)

    def get_input(p, b):
        d = jmodel.get_input(p, b, jax.random.PRNGKey(0), encode_cond=True, deterministic=True)
        del d["lidar_geom"]  # static shape math, not an array
        return d

    data = jax.jit(get_input)(params, batch)
    data["lidar_geom"] = jmodel.lidar_latent_geometry(data["z_lidar_full"].shape)
    x_T = np.random.default_rng(7).standard_normal(data["z"].shape[:3] + (4,)).astype(np.float32)
    latents = jmodel.sample(params, data, jax.random.PRNGKey(1), num_steps=STEPS,
                            guidance_scale=GUIDANCE, sampler="ddim", x_T=jnp.asarray(x_T))
    decoded = jmodel.decode_sample(params, latents, data["z_lidar_full"], data["lidar_geom"])
    ref = {"batch": batch, "data": data, "x_T": x_T, "latents": np.asarray(latents),
           "decoded": {k: np.asarray(v) for k, v in decoded.items()}}
    return jmodel, params, params_np, tmodel, ref


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_converter_equals_export_from_config(pair):
    _, _, params_np, tmodel, _ = pair
    want = export_from_config(TINY, params_np)
    got = convert.state_dict_numpy(params_np, port_config(TINY))
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert set(got) == set(tmodel.state_dict())
    for k, v in tmodel.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_state_dict_names_are_the_reference_names(pair):
    keys = set(pair[3].state_dict())
    for k in ("model.diffusion_model.input_blocks.1.0.in_layers.0.weight",
              "model.diffusion_model.input_blocks.1.1.transformer_blocks.0.attn1.to_q.weight",
              "model.diffusion_model.output_blocks.1.2.conv.weight",
              "model.diffusion_model.out.2.weight",
              "first_stage_model.encoder.down.0.downsample.conv.weight",
              "lidar_stage_model.encoder.conv_in_lidar.weight",
              "lidar_stage_model.decoder.norm_out_lidar1.weight",
              "cond_stage_model.transformer.vision_model.pre_layrnorm.weight",
              "cond_stage_model.mapper.resblocks.1.attn.c_qkv.weight",
              "cond_stage_model.bbox_embedder.second_linear.4.weight",
              "proj_out.weight", "learnable_vector", "bbox_uncond_vector"):
        assert k in keys, k


def test_unet_matches_jax_on_interleaved_batch(pair):
    jmodel, params, _, tmodel, _ = pair
    rng = np.random.default_rng(11)
    x9 = rng.standard_normal((4, 8, 8, 9)).astype(np.float32)  # [cam0, lid0, cam1, lid1]
    t = np.array([999, 500, 37, 1], np.int32)
    ctx = rng.standard_normal((4, 2, TINY.context_dim)).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply_model)(params, jnp.asarray(x9), jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = nhwc(tmodel.apply_model(nchw(x9), torch.from_numpy(t), torch.from_numpy(ctx)))
    assert np.abs(want).max() > 1e-2  # the layers are off zero-init
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_unet_encoder_cache_matches_jax(pair):
    """`return_cache` hands back the input blocks' skips and the middle
    output; a forward given them (at another t and context) skips the
    encoder. Both against the JAX UNet; the cache is NHWC there."""
    jmodel, params, _, tmodel, _ = pair
    rng = np.random.default_rng(17)
    x9, x9b = (rng.standard_normal((4, 8, 8, 9)).astype(np.float32) for _ in range(2))
    t, tb = np.array([999, 500, 37, 1], np.int32), np.array([980, 480, 17, 0], np.int32)
    ctx, ctxb = (rng.standard_normal((4, 2, TINY.context_dim)).astype(np.float32) for _ in range(2))
    want, cache = jmodel.apply_model(params, jnp.asarray(x9), jnp.asarray(t), jnp.asarray(ctx),
                                     return_cache=True)
    want_b = jmodel.apply_model(params, jnp.asarray(x9b), jnp.asarray(tb), jnp.asarray(ctxb),
                                encoder_cache=cache)
    with torch.no_grad():
        got, tcache = tmodel.apply_model(nchw(x9), torch.from_numpy(t), torch.from_numpy(ctx),
                                         return_cache=True)
        got_b = tmodel.apply_model(nchw(x9b), torch.from_numpy(tb), torch.from_numpy(ctxb),
                                   encoder_cache=tcache)
        plain_b = tmodel.apply_model(nchw(x9b), torch.from_numpy(tb), torch.from_numpy(ctxb))
    assert len(tcache) == len(cache) == len(tmodel.unet.input_blocks) + 1
    for g, w in zip(tcache, cache):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(nhwc(got_b), np.asarray(want_b), atol=1e-4, rtol=1e-4)
    assert not torch.allclose(got_b, plain_b, atol=1e-3)  # the cache stood in for the encoder


def test_fused_gn_switch_sees_contiguous_nchw(pair, monkeypatch):
    """With the fused GroupNorm + SiLU switch on, every norm input is
    contiguous NCHW (the CUDA kernel's layout) even when the caller passes a
    permuted view, and eps equals the unfused forward's."""
    from mobi_tpu_torch.models import layers

    _, _, _, tmodel, _ = pair
    seen = []

    def checked(x, w, b, g, eps):
        seen.append(x.is_contiguous())
        return tfn.groupnorm_silu_plain(x, w, b, g, eps)

    monkeypatch.setattr(layers, "fused_groupnorm_silu", checked)
    rng = np.random.default_rng(15)
    x9 = torch.from_numpy(rng.standard_normal((4, 8, 8, 9)).astype(np.float32)).permute(0, 3, 1, 2)
    t = torch.tensor([999, 500, 37, 1])
    ctx = torch.from_numpy(rng.standard_normal((4, 2, TINY.context_dim)).astype(np.float32))
    with torch.no_grad():
        want = tmodel.apply_model(x9, t, ctx)
        tmodel.unet.set_fused_gn(True)
        try:
            got = tmodel.apply_model(x9, t, ctx)
        finally:
            tmodel.unet.set_fused_gn(False)
    levels, nrb = len(TINY.unet_channel_mult), TINY.unet_num_res_blocks
    res_blocks = nrb * levels + 2 + (nrb + 1) * levels
    assert len(seen) == 2 * res_blocks + 1 and all(seen)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("which", ["vae_camera", "vae_lidar"])
def test_vae_encode_mode_and_decode_match_jax(pair, which):
    jmodel, params, _, tmodel, _ = pair
    jvae = getattr(jmodel, which)
    tvae = tmodel.first_stage_model if which == "vae_camera" else tmodel.lidar_stage_model
    ch = 3 if which == "vae_camera" else 2
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, 32, 32, ch)).astype(np.float32)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    want_z = np.asarray(jax.jit(lambda p, x: jvae.apply({"params": p}, x, method=jvae.encode).mode())(
        params[which], jnp.asarray(x)))
    want_x = np.asarray(jax.jit(lambda p, z: jvae.apply({"params": p}, z, method=jvae.decode))(
        params[which], jnp.asarray(z)))
    with torch.no_grad():
        got_z = nhwc(tvae.encode(nchw(x)).mode())
        got_x = nhwc(tvae.decode(nchw(z)))
    np.testing.assert_allclose(got_z, want_z, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_x, want_x, atol=1e-4, rtol=1e-4)


def test_conditioning_tokens_match_jax(pair):
    jmodel, params, _, tmodel, _ = pair
    rng = np.random.default_rng(13)
    cond = {"ref_image": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32),
            "ref_bbox": rng.uniform(0, 1, (2, 8, 3)).astype(np.float32)}
    want = np.asarray(jax.jit(jmodel.get_learned_conditioning)(params, jax.tree.map(jnp.asarray, cond)))
    with torch.no_grad():
        got = tmodel.get_learned_conditioning({k: torch.from_numpy(v) for k, v in cond.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tmodel.uncond_tokens(3).detach().numpy(),
                                  np.asarray(jmodel.uncond_tokens(params, 3)))


def test_get_input_matches_jax(pair):
    _, _, _, tmodel, ref = pair
    data = tmodel.get_input(numpy_batch(ref["batch"]), encode_cond=True, deterministic=True)
    want = ref["data"]
    assert data["lidar_geom"] == want["lidar_geom"]
    np.testing.assert_allclose(data["z"].numpy(), np.asarray(want["z"]), atol=1e-4, rtol=1e-4)
    # the floor-index mask resize is exact
    np.testing.assert_array_equal(data["z"][..., 8].numpy(), np.asarray(want["z"])[..., 8])
    np.testing.assert_allclose(data["z_lidar_full"].numpy(), np.asarray(want["z_lidar_full"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(data["cond"].numpy(), np.asarray(want["cond"]), atol=1e-4, rtol=1e-4)


def test_ddim_steps_with_cfg_match_jax(pair):
    """5 DDIM steps at CFG 5 from the same x_T and the same encoded data."""
    _, _, _, tmodel, ref = pair
    data = {k: (torch.tensor(np.asarray(v)) if k != "lidar_geom" else v)
            for k, v in ref["data"].items()}
    got = tmodel.sample(data, num_steps=STEPS, guidance_scale=GUIDANCE, sampler="ddim",
                        x_T=torch.from_numpy(ref["x_T"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref["latents"], atol=2e-4, rtol=2e-4)


def test_ddim_eta_nonzero_draws_from_the_generator(pair):
    _, _, _, tmodel, ref = pair
    data = {k: (torch.tensor(np.asarray(v)) if k != "lidar_geom" else v)
            for k, v in ref["data"].items()}
    x_T = torch.from_numpy(ref["x_T"])

    def run(eta, seed):
        return tmodel.sample(data, torch.Generator().manual_seed(seed), num_steps=3,
                             guidance_scale=GUIDANCE, sampler="ddim", eta=eta, x_T=x_T)

    a, b, c = run(0.5, 0), run(0.5, 0), run(0.5, 1)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a, run(0.0, 0))


def test_pipeline_matches_jax(pair):
    """The whole pipeline (deterministic encode, pinned x_T) against JAX's
    get_input -> sample -> decode_sample."""
    _, _, _, tmodel, ref = pair
    pipeline = make_inpaint_pipeline(tmodel, num_steps=STEPS, guidance_scale=GUIDANCE,
                                     deterministic_encode=True, device="cpu")
    out = pipeline(numpy_batch(ref["batch"]), x_T=torch.from_numpy(ref["x_T"]))
    assert set(out) == {"camera", "lidar"}
    for name, shape in (("camera", (2, 32, 32, 3)), ("lidar", (2, 32, 32, 2))):
        assert tuple(out[name].shape) == shape
        np.testing.assert_allclose(out[name].numpy(), ref["decoded"][name], atol=2e-4, rtol=2e-4)


def test_lidar_alignment_crop_pad_and_paste_back():
    """The crop/pad of a wide, short lidar latent and its paste-back, against
    the JAX package (including the negative-pad crop branch)."""
    jmodel = JaxMobi(TINY)
    tmodel = tdiff.MobiDiffusion.__new__(tdiff.MobiDiffusion)
    torch.nn.Module.__init__(tmodel)
    tmodel.config = port_config(TINY)
    rng = np.random.default_rng(14)
    for shape in ((1, 4, 16, 9), (1, 12, 16, 9)):
        z = rng.standard_normal(shape).astype(np.float32)
        bbox = rng.uniform(0, 1, (1, 8, 3)).astype(np.float32)
        jz, jb, jgeom = jmodel.align_lidar_latent(jnp.asarray(z), jnp.asarray(bbox))
        tz, tb, tgeom = tmodel.align_lidar_latent(torch.from_numpy(z), torch.from_numpy(bbox))
        assert tgeom == jgeom
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)


def test_clip_normalize_matches_jax():
    from mobi_tpu.models.clip import clip_normalize as jax_clip_normalize
    from mobi_tpu_torch.models.clip import clip_normalize

    x = np.random.default_rng(16).uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(clip_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_clip_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_interleave_roundtrip():
    a, b = torch.arange(12).reshape(3, 4), -torch.arange(12).reshape(3, 4)
    inter = tdiff.interleave_modalities([a, b])
    assert torch.equal(inter[0], a[0]) and torch.equal(inter[1], b[0])
    a2, b2 = tdiff.deinterleave_modalities(inter)
    assert torch.equal(a2, a) and torch.equal(b2, b)


def test_bf16_policy_and_fp32_carry():
    """bf16 mode: >= 2-D parameters in bf16, 1-D norm scales and biases in
    fp32; the sampler carry stays fp32."""
    cfg = port_config(TINY, torch.bfloat16)
    model = tdiff.MobiDiffusion(cfg, device="cpu", cond_stage_model=tiny_cond_stage())
    for name, p in model.named_parameters():
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32), name
    data = model.get_input(numpy_batch(make_batch(b=1)), torch.Generator().manual_seed(0),
                           encode_cond=True)
    latents = model.sample(data, torch.Generator().manual_seed(1), num_steps=2)
    assert latents.dtype == torch.float32 and torch.isfinite(latents).all()


CFG_512 = os.path.join(ROOT, "configs", "mobi_nusc_512.yaml")


def yaml_tree(unet=None, first=None, **top):
    """The shipped 512 config's tree with extra keys in the unet's params,
    the first stage's params and at the top level."""
    from mobi_tpu_torch.utils import config as tconfig

    tree = tconfig.load_config([CFG_512])
    mp = tree["model"]["params"]
    mp["unet_config"]["params"].update(unet or {})
    mp["first_stage_config"]["params"].update(first or {})
    tree.update(top)
    return tree


@pytest.mark.parametrize("unet,top,want", [
    ({"attn_backend": "xla"}, {}, "xla"),
    ({}, {"attn_backend": "xla"}, "xla"),
    ({"attn_backend": "flash"}, {"attn_backend": "xla"}, "flash"),  # the unet key first
    ({}, {}, "auto"),
])
def test_attn_backend_from_yaml_matches_jax(unet, top, want):
    from mobi_tpu.utils import config as jconfig
    from mobi_tpu_torch.utils import config as tconfig

    got = tconfig.mobi_config_from_yaml(yaml_tree(unet, **top)).attn_backend
    assert got == jconfig.mobi_config_from_yaml(yaml_tree(unet, **top)).attn_backend == want


@pytest.mark.parametrize("backend,flash", [("xla", False), ("auto", True)])
def test_unet_from_a_yaml_backend_routes_its_attention(backend, flash, monkeypatch):
    """A tiny port UNet whose backend comes from the YAML: with "xla" none of
    its attentions reaches flash_attention, even where the "auto" rule
    (its least length lowered to the tiny latent's 16 tokens) would send
    the self- and cross-modal attentions there."""
    from mobi_tpu_torch.ops import attention as tattn
    from mobi_tpu_torch.ops import flash_attention as tfa
    from mobi_tpu_torch.utils import config as tconfig

    cfg = dataclasses.replace(port_config(TINY), attn_backend=tconfig.mobi_config_from_yaml(
        yaml_tree({"attn_backend": backend})).attn_backend)
    model = tdiff.MobiDiffusion(cfg, device="cpu", cond_stage_model=tiny_cond_stage())
    calls = []
    monkeypatch.setattr(tattn, "FLASH_MIN_SEQ", 16)
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda q, k, v: calls.append(q.shape) or tfa.attention_plain(q, k, v))
    g = torch.Generator().manual_seed(0)
    s = cfg.latent_size
    with torch.no_grad():
        eps = model.unet(torch.randn(2, 9, s, s, generator=g), torch.tensor([10, 500]),
                         torch.randn(2, len(cfg.cond_stage_key), cfg.context_dim, generator=g))
    assert eps.shape == (2, 4, s, s) and bool(torch.isfinite(eps).all())
    assert bool(calls) is flash


@pytest.mark.parametrize("where,value", [
    ("unet", True), ("first", True), ("unet", "transformer"), ("unet", False), ("first", False),
])
def test_use_checkpoint_in_yaml_raises_until_remat_is_ported(where, value):
    """A YAML that asks for activation remat raises, naming the queue item;
    false (the shipped configs) or absent reads as the JAX package reads it."""
    from mobi_tpu.utils import config as jconfig
    from mobi_tpu_torch.utils import config as tconfig

    tree = yaml_tree(**{where: {"use_checkpoint": value}})
    if value:
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            tconfig.mobi_config_from_yaml(tree)
    else:
        got = tconfig.mobi_config_from_yaml(tree)
        assert got.unet_channels == jconfig.mobi_config_from_yaml(tree).unet_channels == 320


def test_port_imports_without_jax():
    """Every module of mobi_tpu_torch (the training modules included), and
    chip_smoke.py, import with jax, flax, optax and mobi_tpu made
    unimportable."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "mobi_tpu"):
                    raise ImportError(f"blocked: {name}")
                return None

        sys.meta_path.insert(0, Block())
        import mobi_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(mobi_tpu_torch.__path__, "mobi_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        importlib.import_module("chip_smoke")
        leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "mobi_tpu")]
        assert not leaked, leaked
        for name in ("mobi_tpu_torch.training", "mobi_tpu_torch.models.ema",
                     "mobi_tpu_torch.utils.config"):
            assert name in names, name
        print(len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 21
