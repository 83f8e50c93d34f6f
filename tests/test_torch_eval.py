"""The port's evaluation modules (mobi_tpu_torch/eval/{frechet,clip_embed,
inception,rangenet}.py, data/imgproc.resize_bicubic_pil) against the JAX
package on the CPU; the scorers, format_results and the realism bench are
tests/test_torch_eval_cli.py's.

Weights: one seeded state dict in the published names and layouts
(mobi_tpu_torch/eval/fabricate.py: HF CLIPModel, torchvision
inception_v3 and alexnet, the lpips heads, RangeNet++ darknet53) goes through
JAX's importers into the JAX modules and through the port's loaders, strict,
into the port's. Tolerances, and why:

  * frechet_distance: bitwise (the same numpy float64 operations);
  * resize_bicubic_pil: bit-exact against Pillow (integer arithmetic after
    the same float64 coefficients);
  * clip_preprocess_image: 1e-6 max-abs (both the same float32 numpy ops on
    the same uint8 pixels; it is exact in practice);
  * networks: the JAX modules run on XLA:CPU, the port's on PyTorch's CPU
    kernels, both fp32 with different summation orders: CLIP tower +
    projection 1e-4 max-abs (the tiny config of tests/test_fid_clip.py);
    Inception pool3 and RangeNet features 1e-4 relative L2 at full width
    (75 x 75 and 16 x 64 inputs);
  * range_npy_to_input: exactly equal (the same numpy);
  * fid_score --backbone inception: the printed line equal to the JAX
    CLI's pieces'.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from PIL import Image

from mobi_tpu.eval import clip_embed as jclip
from mobi_tpu.eval import frechet as jfrechet
from mobi_tpu.eval import inception as jinception
from mobi_tpu.eval import rangenet as jrangenet
from mobi_tpu.models.clip import CLIPVisionTower as JaxTower
from mobi_tpu_torch.data.image_io import read_image
from mobi_tpu_torch.data.imgproc import resize_bicubic_pil
from mobi_tpu_torch.eval import clip_embed, fabricate, frechet, inception, rangenet
from mobi_tpu_torch.ops import _build
from tests.test_torch_models import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def layouts():
    return fabricate.published_layouts()


# ------------------------------------------------------------------ frechet


@pytest.mark.parametrize("n,d", [(64, 8), (6, 16)], ids=["n_gt_d", "n_lt_d"])
def test_frechet_distance_bitwise(n, d):
    rng = np.random.default_rng(n)
    f1 = rng.standard_normal((n, d)).astype(np.float32)
    f2 = (1.3 * rng.standard_normal((n, d)) + 0.2).astype(np.float32)
    got = frechet.frechet_from_features(f1, f2)
    assert got == jfrechet.frechet_from_features(f1, f2)
    mu1, s1 = frechet.fit_gaussian(f1)
    mu2, s2 = frechet.fit_gaussian(f2)
    jmu, js = jfrechet.fit_gaussian(f1)
    assert np.array_equal(mu1, jmu) and np.array_equal(s1, js)
    assert frechet.frechet_distance(mu1, s1, mu2, s2) == got
    # a covariance that is not finite: both packages refuse it the same way
    s_inf = s2.copy()
    s_inf[0, 0] = np.inf
    for fd in (frechet.frechet_distance, jfrechet.frechet_distance):
        with pytest.raises(np.linalg.LinAlgError):
            fd(mu1, s1, mu2, s_inf)


# ------------------------------------------------------------- PIL bicubic


def short_side_224(w, h):
    return (224, max(int(224 * h / w), 224)) if w <= h else (max(int(224 * w / h), 224), 224)


def pattern_image(h, w, channels, seed):
    """Noise over a gradient: every level and sharp edges."""
    rng = np.random.default_rng(seed)
    ramp = np.add.outer(np.linspace(0, 180, h), np.linspace(0, 60, w))
    img = np.clip(ramp[..., None] + rng.integers(-60, 76, (h, w, 3)), 0, 255).astype(np.uint8)
    return img if channels == 3 else img[..., 0]


@pytest.mark.parametrize("channels", [3, 1], ids=["RGB", "L"])
@pytest.mark.parametrize("src,dst", [
    ((400, 225), None), ((123, 456), None), ((224, 224), None), ((640, 360), None), ((1600, 900), None),
    ((17, 5), None), ((1, 9), None), ((9, 1), None), ((1, 1), (3, 3)), ((7, 1), (2, 5)), ((300, 3), (1, 1)),
], ids=["400x225", "123x456", "224x224", "640x360", "1600x900", "17x5_up", "1x9", "9x1", "1x1_to_3x3",
        "7x1_to_2x5", "300x3_to_1x1"])
def test_resize_bicubic_pil_bit_exact(src, dst, channels):
    """Bit for bit Pillow's Image.resize(BICUBIC) (PIL 12 here): w x h
    sizes, the shorter side to 224 where no target is given."""
    w, h = src
    nw, nh = dst or short_side_224(w, h)
    img = pattern_image(h, w, channels, seed=w * 7 + h)
    want = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BICUBIC))
    got = resize_bicubic_pil(img, nh, nw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), np.argwhere(got != want)[:5].tolist()


def test_resize_bicubic_pil_refuses_other_arrays():
    with pytest.raises(ValueError):
        resize_bicubic_pil(np.zeros((4, 4, 4), np.uint8), 2, 2)
    with pytest.raises(ValueError):
        resize_bicubic_pil(np.zeros((4, 4), np.float32), 2, 2)


# --------------------------------------------------------------------- CLIP


@pytest.mark.parametrize("size,mode", [((400, 225), "RGB"), ((123, 456), "RGB"), ((224, 224), "RGB"),
                                       ((640, 360), "RGB"), ((90, 120), "L")])
def test_clip_preprocess_matches_jax(tmp_path, size, mode):
    """The port on read_image of a PNG against JAX on PIL's open of it."""
    w, h = size
    img = pattern_image(h, w, 3 if mode == "RGB" else 1, seed=w + h)
    path = str(tmp_path / "x.png")
    Image.fromarray(img).save(path)
    got = clip_embed.clip_preprocess_image(read_image(path))
    want = jclip.clip_preprocess_image(Image.open(path))
    assert got.dtype == np.float32 and got.shape == want.shape == (224, 224, 3)
    assert np.abs(got - want).max() <= 1e-6


def tiny_clip_layout():
    """The tiny tower of tests/test_fid_clip.py (width 64, 2 layers, 4 heads,
    32 px, patch 16, projection 48) in HF names, with CLIPModel's
    text_projection and logit_scale beside it."""
    with torch.device("meta"):
        model = clip_embed.ClipImageEmbedder(32, 16, 64, 2, 4, projection_dim=48)
    layout = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return {**layout, "text_projection.weight": (48, 48), "logit_scale": ()}


def test_clip_embedder_matches_jax_and_hf(few_torch_threads):  # noqa: F811
    """ClipImageEmbedder + load_clip_b32 against JAX's tower @ proj through
    import_clip_b32, and against transformers' image_embeds (1e-4)."""
    sd = fabricate.fill_published(tiny_clip_layout(), seed=11)
    model = clip_embed.ClipImageEmbedder(32, 16, 64, 2, 4, projection_dim=48)
    clip_embed.load_clip_b32(model, sd)
    x = np.random.default_rng(5).standard_normal((3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()

    params, proj = jclip.import_clip_b32(numpy_sd(sd), num_layers=2)
    tower = JaxTower(image_size=32, patch_size=16, width=64, layers=2, heads=4)
    want = np.asarray(tower.apply({"params": params}, jnp.asarray(x)) @ jnp.asarray(proj))
    assert got.shape == want.shape == (3, 48)
    assert np.abs(got - want).max() <= 1e-4

    cfg = transformers.CLIPVisionConfig(hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                                        num_attention_heads=4, image_size=32, patch_size=16, projection_dim=48,
                                        hidden_act="quick_gelu")
    hf = transformers.CLIPVisionModelWithProjection(cfg).eval()
    hf.load_state_dict({k: v for k, v in sd.items() if k.startswith(("vision_model.", "visual_projection."))},
                       strict=False)
    with torch.no_grad():
        hf_out = hf(pixel_values=torch.from_numpy(x).permute(0, 3, 1, 2)).image_embeds.numpy()
    assert np.abs(got - hf_out).max() <= 1e-4


def test_clip_b32_published_layout_loads_strict(layouts):
    """On the meta device: transformers' CLIPModel(CLIPConfig()) (ViT-B/32)
    has exactly fabricate's layout, and load_clip_b32 takes its state dict
    strict after dropping the text keys; a position_ids buffer equal to the
    positions is taken, another value or any other unknown key raises."""
    with torch.device("meta"):
        hf_sd = transformers.CLIPModel(transformers.CLIPConfig()).state_dict()
        model = clip_embed.ClipImageEmbedder()
    assert {k: tuple(v.shape) for k, v in hf_sd.items()} == layouts["clip"]
    dropped = [k for k in hf_sd if k.startswith(("text_model.", "text_projection.")) or k == "logit_scale"]
    assert len(dropped) == 16 * 12 + 6
    clip_embed.load_clip_b32(model, hf_sd)
    clip_embed.load_clip_b32(model, {**hf_sd, "vision_model.embeddings.position_ids": torch.arange(50)[None]})
    with pytest.raises(ValueError, match="position_ids"):
        clip_embed.load_clip_b32(model, {**hf_sd, "vision_model.embeddings.position_ids": torch.zeros(1, 50)})
    with pytest.raises(RuntimeError, match="Unexpected"):
        clip_embed.load_clip_b32(model, {**hf_sd, "vision_model.extra.weight": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Missing"):
        clip_embed.load_clip_b32(model, {k: v for k, v in hf_sd.items() if k != "visual_projection.weight"})


# ---------------------------------------------------------------- Inception


@pytest.fixture(scope="module")
def inception_pair(layouts, tmp_path_factory):
    """Seeded torchvision-layout weights (fc and AuxLogits included) in both
    packages, Mixed_7c's BatchNorms scaled down so that pool3 is about a unit
    wide; two folders `a` and `b` of 2 PNGs each (RGB and gray, odd sizes)
    under a tmp directory; their 4 images as the JAX FID CLI's loader gives
    them at 75 x 75; and JAX's pool3 features of that batch, op by op (the
    one JAX Inception call of this module)."""
    from eval_tool.camera import fid_score as jfid

    sd = {k: v * 0.05 if k.startswith("Mixed_7c.") and ".bn." in k and k.endswith(("weight", "bias")) else v
          for k, v in fabricate.fill_published(layouts["inception"], seed=3).items()}
    model = inception.InceptionV3Features()
    inception.load_published(model, sd)
    root = tmp_path_factory.mktemp("inception")
    for name, sizes, lo in (("a", [(120, 90), (64, 64)], 0), ("b", [(90, 130), (100, 75)], 90)):
        (root / name).mkdir()
        for i, (w, h) in enumerate(sizes):
            img = np.clip(pattern_image(h, w, 3, seed=lo + i).astype(np.int64) // 2 + lo, 0, 255).astype(np.uint8)
            Image.fromarray(img[..., 0] if i else img).save(root / name / f"{i}.png")
    paths = [str(root / name / f"{i}.png") for name in "ab" for i in range(2)]
    x = np.asarray(jfid.load_batch_inception(paths, size=75), np.float32)
    params = jinception.import_inception_weights(numpy_sd(sd))
    want = np.asarray(jinception.InceptionV3Features().apply({"params": params}, jnp.asarray(x)))
    return sd, model, x, want, root


def test_inception_matches_jax(inception_pair):
    sd, model, x, want, _ = inception_pair
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (4, inception.FEATURE_DIM)
    assert rel_l2(got, want) <= 1e-4


def test_inception_drops_exactly_fc_and_auxlogits(inception_pair):
    sd, *_ = inception_pair
    dropped = set(inception.dropped_keys(sd))
    assert dropped == {k for k in sd if k.startswith(("fc.", "AuxLogits."))} and len(dropped) == 16
    model = inception.InceptionV3Features()
    inception.load_published(model, {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")})
    with pytest.raises(RuntimeError, match="Unexpected"):
        inception.load_published(model, {**sd, "Mixed_5b.branch1x1.extra": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="Missing"):
        inception.load_published(model, {k: v for k, v in sd.items() if not k.startswith("Mixed_7c.branch_pool")})


def test_inception_pool_mix_moves_pool3(inception_pair, monkeypatch):
    """The JAX module's average pools exclude the padding (pytorch-fid's
    choice) while Mixed_7c keeps torchvision's average pool. With
    torchvision's count_include_pad=True instead, pool3 moves well past the
    parity tolerance (ROADMAP queue 3)."""
    _, model, x, want, _ = inception_pair
    monkeypatch.setattr(inception, "_avg_pool", lambda t: torch.nn.functional.avg_pool2d(
        t, 3, stride=1, padding=1, count_include_pad=True))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    moved = rel_l2(got, want)
    print(f"pool3 relative L2 with count_include_pad=True: {moved:.4f}")
    assert moved > 1e-2


def test_fid_cli_inception_matches_jax(inception_pair, monkeypatch, capsys, few_torch_threads):  # noqa: F811
    """`fid_score --backbone inception` whole on inception_pair's two folders
    of 2 images (RGB and gray PNGs) against the JAX CLI's pieces: its loader
    (equal to the port's exactly at 299 x 299), InceptionV3Features at 75 x
    75 (the fixture's features of both folders' 4 images in one call; each
    image's features do not depend on the others; the JAX CLI itself
    jit-compiles Inception twice, 24 s each beside a loaded host) and
    frechet_from_features. The fixture's Mixed_7c scaling puts the FID's
    fourth decimal above the two packages' fp32 rounding. The printed line
    is equal."""
    from eval_tool.camera import fid_score as jfid

    from mobi_tpu_torch.eval_tool.camera import fid_score

    sd, _, _, both, root = inception_pair
    torch.save(sd, root / "inception_v3.pth")
    folders = [fid_score.list_images(str(root / name)) for name in "ab"]
    assert np.array_equal(fid_score.load_batch_inception(folders[0] + folders[1]),
                          jfid.load_batch_inception(folders[0] + folders[1]))
    want = f"FID: {jfrechet.frechet_from_features(both[:2], both[2:]):.4f}"

    cut = fid_score.load_batch_inception
    monkeypatch.setattr(fid_score, "load_batch_inception", lambda paths: cut(paths, size=75))
    capsys.readouterr()
    fid_score.main(["--path_target", str(root / "a"), "--path_pred", str(root / "b"), "--backbone",
                    "inception", "--weights", str(root / "inception_v3.pth"), "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want


# ----------------------------------------------------------------- RangeNet


def test_rangenet_matches_jax(layouts, few_torch_threads):  # noqa: F811
    """Full widths (darknet53, 5 up-convs) at a 16 x 64 input, batch 2: the
    port's ConvTranspose2d against JAX's dilated-conv detour."""
    bb = fabricate.fill_published(layouts["rangenet_backbone"], seed=4)
    dec = fabricate.fill_published(layouts["rangenet_decoder"], seed=5)
    model = rangenet.RangeNetFRD()
    rangenet.load_published(model, bb, dec)
    x = np.random.default_rng(2).normal(0, 3, (2, 16, 64, 5)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    params = jrangenet.import_rangenet_weights(numpy_sd(bb), numpy_sd(dec))
    want = np.asarray(jrangenet.RangeNetFRD().apply({"params": params}, jnp.asarray(x)))
    assert got.shape == want.shape == (2, rangenet.FEATURE_DIM)
    assert np.isfinite(got).all() and rel_l2(got, want) <= 1e-4
    with pytest.raises(RuntimeError, match="Unexpected"):
        rangenet.load_published(model, {**bb, "head.weight": torch.zeros(1)}, dec)
    with pytest.raises(RuntimeError, match="Missing"):
        rangenet.load_published(model, bb, {k: v for k, v in dec.items() if not k.startswith("dec1.")})


def range_view(seed, h=32, w=1096):
    """A saved range stack as the bench writes it (depth_norm, intensity,
    pitch, yaw) at the bench's 32 x 1096, a tenth of it out of range."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(-0.95, 0.99, (h, w))
    depth[rng.random((h, w)) < 0.1] = rng.choice([-1.0, 1.0, -0.99])
    inten = rng.uniform(-1, 1, (h, w))
    pitch = np.repeat(np.linspace(0.18, -0.54, h)[:, None], w, 1)
    yaw = np.repeat(np.linspace(np.pi, -np.pi, w)[None], h, 0)
    return np.stack([depth, inten, pitch, yaw]).astype(np.float32)


@pytest.mark.parametrize("out_hw", [(64, 1024), (16, 64), (32, 1096)])
def test_range_npy_to_input_matches_jax(out_hw):
    npy = range_view(7)
    got = rangenet.range_npy_to_input(npy, *out_hw)
    want = jrangenet.range_npy_to_input(npy, *out_hw)
    assert got.dtype == want.dtype == np.float32 and got.shape == (*out_hw, 5)
    assert np.array_equal(got, want)
    assert (got == -1).all(-1).any()  # invalid pixels survive the resize


def test_eval_modules_import_without_jax_or_the_jax_tools():
    """The slice's modules import with jax, flax, mobi_tpu, eval_tool and
    scripts made unimportable, and their sources name none of them."""
    names = ["mobi_tpu_torch.eval.frechet", "mobi_tpu_torch.eval.clip_embed", "mobi_tpu_torch.eval.inception",
             "mobi_tpu_torch.eval.rangenet", "mobi_tpu_torch.eval_tool.camera.fid_score",
             "mobi_tpu_torch.eval_tool.camera.clip_score", "mobi_tpu_torch.eval_tool.camera.lpips_score",
             "mobi_tpu_torch.eval_tool.lidar.frd_score", "mobi_tpu_torch.format_results",
             "mobi_tpu_torch.realism_test_bench"]
    code = textwrap.dedent(f"""
        import importlib, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "mobi_tpu", "eval_tool", "scripts"):
                    raise ImportError(f"blocked: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        for name in {names!r}:
            importlib.import_module(name)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    for name in names:
        src = open(os.path.join(ROOT, *name.split(".")) + ".py").read()
        for line in src.splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "flax", "mobi_tpu", "eval_tool", "scripts"), line
