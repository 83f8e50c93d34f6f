"""The port's scorers, format_results and the realism bench
(mobi_tpu_torch/eval_tool/*, format_results.py, realism_test_bench.py)
against the JAX package's CLIs (eval_tool/*, scripts/format_results.py) on
the CPU, with the seeded published-layout weights of tests/test_torch_eval.py
written to files.

Groups: fid_score (CLIP-FID), clip_score and lpips_score run whole in both
packages on the same folders and files, and their printed lines are equal
(the test weights keep the features about a unit wide, so the two packages'
fp32 rounding, ~1e-7 relative, stays below the printed digits). frd_score
runs whole in both with its input cut from 64 x 1024 to 16 x 64 (the full
input costs ~0.36 TFLOP a sample), its loader at full size held exactly;
fid_score --backbone inception likewise at 75 x 75 in tests/test_torch_eval.py.
chip_smoke's eval phase runs both at full size on the card against the CPU. format_results' stdout is
equal to the JAX script's. The realism bench runs on the tiny model.
"""
import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from mobi_tpu.eval import rangenet as jrangenet
from mobi_tpu_torch import format_results
from mobi_tpu_torch import inference_test_bench as tbench
from mobi_tpu_torch import realism_test_bench as rtb
from mobi_tpu_torch.data import imgproc
from mobi_tpu_torch.eval import fabricate, rangenet
from mobi_tpu_torch.eval_tool import metric_scope, network, reuse_networks
from mobi_tpu_torch.eval_tool.camera import clip_score, fid_score, lpips_score
from mobi_tpu_torch.eval_tool.lidar import frd_score
from mobi_tpu_torch.models import diffusion as tdiff
from scripts import format_results as jformat
from tests.test_diffusion import TINY
from tests.test_torch_eval import launches_stay_zero, layouts, pattern_image, range_view  # noqa: F401
from tests.test_torch_models import few_torch_threads, port_config, tiny_cond_stage  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_512 = os.path.join(ROOT, "configs", "mobi_nusc_512.yaml")


# --------------------------------------------------------------------- CLIs


@pytest.fixture(scope="module")
def weights(layouts, tmp_path_factory):
    """Weight files as published: the B/32 vision tower with CLIPModel's
    text_projection and logit_scale (the text tower itself left out for
    size), inception_v3 with fc and AuxLogits, torchvision alexnet with its
    classifier, the lpips heads, darknet53."""
    root = tmp_path_factory.mktemp("weights")
    files = {}
    for i, (name, layout) in enumerate(layouts.items()):
        if name == "clip":
            layout = {k: v for k, v in layout.items() if not k.startswith("text_model.")}
        sd = fabricate.fill_published(layout, seed=20 + i)
        # features about a unit wide, so that the printed digits of FID and
        # FRD lie above the two packages' fp32 rounding: the last affine
        # maps before the features scaled down (the CLIP projection,
        # Mixed_7c's BatchNorms; RangeNet's stem skip and dec1's last maps)
        for k in sd:
            if (k == "visual_projection.weight" or (k.startswith("Mixed_7c.") and ".bn." in k
                                                    and k.endswith(("weight", "bias")))):
                sd[k] *= 0.05
            elif name == "rangenet_backbone" and k in ("bn1.weight", "bn1.bias"):
                sd[k] *= 0.01
            elif name == "rangenet_decoder" and k.startswith(("dec1.bn.", "dec1.residual.bn2.")) and \
                    k.endswith(("weight", "bias")):
                sd[k] *= 0.01
        files[name] = str(root / name)
        torch.save(sd, files[name])
    return files


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Two camera folders of 4 images each (RGB and gray PNGs, a baseline
    JPEG, sizes off 224) and two range folders of 3 npys."""
    root = tmp_path_factory.mktemp("folders")
    dirs = {k: root / k for k in ("a", "b", "ra", "rb")}
    for k, d in dirs.items():
        d.mkdir()
    rng = np.random.default_rng(0)
    for d, lo in ((dirs["a"], 0), (dirs["b"], 90)):
        for i, (w, h) in enumerate([(120, 90), (90, 130), (64, 64), (100, 75)]):
            img = np.clip(pattern_image(h, w, 3, seed=lo + i).astype(np.int64) // 2 + lo, 0, 255).astype(np.uint8)
            if i == 2:
                Image.fromarray(img[..., 0]).save(d / f"{i}.png")
            elif i == 3:
                Image.fromarray(img).save(d / f"{i}.jpg", quality=90)
            else:
                Image.fromarray(img).save(d / f"{i}.png")
        (d / "notes.txt").write_text("not an image")
    for d, shift in ((dirs["ra"], 0.0), (dirs["rb"], 0.1)):
        for i in range(3):
            npy = range_view(int(rng.integers(1 << 30)))
            npy[0] = np.clip(npy[0] + shift, -1, 1)
            np.save(d / f"{i}.npy", npy)
    return {k: str(v) for k, v in dirs.items()}


def jax_cli(module, argv, monkeypatch, capsys):
    """A JAX CLI's main() on argv; its last printed line."""
    monkeypatch.setattr(sys, "argv", ["cli"] + argv)
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out.strip().splitlines()[-1]


def port_cli(main, argv, capsys):
    capsys.readouterr()
    main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_fid_cli_matches_jax(weights, folders, monkeypatch, capsys, few_torch_threads):  # noqa: F811
    """The camera FID line (the default CLIP-FID) on the same folders and
    weight file; `--backbone inception` is tests/test_torch_eval.py's."""
    from eval_tool.camera import fid_score as jfid

    argv = ["--path_target", folders["a"], "--path_pred", folders["b"], "--weights", weights["clip"]]
    want = jax_cli(jfid, argv, monkeypatch, capsys)
    got = port_cli(fid_score.main, argv, capsys)
    assert got == want and got.startswith("FID: ")


def test_clip_score_cli_matches_jax(weights, folders, monkeypatch, capsys, few_torch_threads):  # noqa: F811
    from eval_tool.camera import clip_score as jclip_score

    argv = ["--path_ref", folders["a"], "--path_pred", folders["b"], "--weights", weights["clip"]]
    want = jax_cli(jclip_score, argv, monkeypatch, capsys)
    got = port_cli(clip_score.main, argv, capsys)
    assert got == want and got.startswith("CLIP score: ")


def test_lpips_cli_matches_jax(weights, folders, monkeypatch, capsys, few_torch_threads):  # noqa: F811
    """The published alexnet file with its classifier: load_published reads
    its features and leaves the classifier."""
    from eval_tool.camera import lpips_score as jlpips_score

    assert any(k.startswith("classifier.") for k in torch.load(weights["alexnet"]))
    argv = ["--path_target", folders["a"], "--path_pred", folders["b"], "--lpips_weights", weights["lpips"],
            "--alexnet_weights", weights["alexnet"], "--batch-size", "3"]
    want = jax_cli(jlpips_score, argv, monkeypatch, capsys)
    got = port_cli(lpips_score.main, argv, capsys)
    assert got == want and got.startswith("LPIPS: ")


def test_frd_cli_matches_jax_at_a_small_input(weights, folders, monkeypatch, capsys,
                                              few_torch_threads):  # noqa: F811
    """FRD's fixed 64 x 1024 input costs ~0.36 TFLOP a sample, too much for
    the JAX CLI here: both CLIs run whole with range_npy_to_input cut to 16
    x 64 (the card's run holds the full input, chip_smoke's eval phase).
    The port's loader at its default size equals JAX's pieces exactly."""
    from eval_tool.lidar import frd_score as jfrd

    files = frd_score.list_npys(folders["ra"])
    full = frd_score.load_batch(files)
    assert full.shape == (3, 64, 1024, 5)
    assert np.array_equal(full, np.stack([jrangenet.range_npy_to_input(np.load(f)) for f in files]))

    def small(cut):
        return lambda npy: cut(npy, 16, 64)

    monkeypatch.setattr(jrangenet, "range_npy_to_input", small(jrangenet.range_npy_to_input))
    monkeypatch.setattr(frd_score, "range_npy_to_input", small(rangenet.range_npy_to_input))
    argv = ["--path_orig", folders["ra"], "--path_pred", folders["rb"], "--backbone-weights",
            weights["rangenet_backbone"], "--decoder-weights", weights["rangenet_decoder"]]
    want = jax_cli(jfrd, argv, monkeypatch, capsys)
    got = port_cli(frd_score.main, argv, capsys)
    assert got == want and got.startswith("FRD: ")


@pytest.mark.parametrize("name", ["fid", "clip", "lpips", "frd"])
def test_cli_exits_and_device(name, weights, folders, monkeypatch):
    """Each CLI's exit message without weights, as JAX's; its default device
    is the card, and without one it raises instead of running on the CPU."""
    for var in ("CLIP_B32_WEIGHTS", "INCEPTION_WEIGHTS", "LPIPS_WEIGHTS", "ALEXNET_WEIGHTS",
                "RANGENET_BACKBONE", "RANGENET_DECODER"):
        monkeypatch.delenv(var, raising=False)
    main, paths, with_weights, msg = {
        "fid": (fid_score.main, ["--path_target", folders["a"], "--path_pred", folders["b"]],
                ["--weights", weights["clip"]], "camera FID requires CLIP ViT-B/32 weights"),
        "clip": (clip_score.main, ["--path_ref", folders["a"], "--path_pred", folders["b"]],
                 ["--weights", weights["clip"]], "CLIP score requires --weights"),
        "lpips": (lpips_score.main, ["--path_target", folders["a"], "--path_pred", folders["b"]],
                  ["--lpips_weights", weights["lpips"], "--alexnet_weights", weights["alexnet"]],
                  "LPIPS requires weights"),
        "frd": (frd_score.main, ["--path_orig", folders["ra"], "--path_pred", folders["rb"]],
                ["--backbone-weights", weights["rangenet_backbone"], "--decoder-weights",
                 weights["rangenet_decoder"]], "FRD requires the RangeNet"),
    }[name]
    with pytest.raises(SystemExit, match=msg):
        main(paths + ["--device", "cpu"])
    module = sys.modules[main.__module__]
    assert module.parse_args(paths).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(paths + with_weights)


def test_reuse_networks_builds_once_per_scope():
    """network() builds anew outside a reuse_networks() scope; inside, once
    for each build function and arguments, a nested scope sharing the
    outer's, and nothing is kept after the outermost scope."""
    built = []

    def build(path, device):
        built.append((path, device))
        return torch.nn.Linear(1, 1)

    cpu = torch.device("cpu")
    assert network(build, "a", cpu) is not network(build, "a", cpu)
    with reuse_networks() as nets:
        a = network(build, "a", cpu)
        with reuse_networks() as inner:
            assert inner is nets and network(build, "a", cpu) is a
        assert network(build, "b", cpu) is not a and network(build, "a", cpu) is a
        assert len(nets) == 2
    assert built == [("a", cpu)] * 3 + [("b", cpu)]
    with reuse_networks():
        assert network(build, "a", cpu) is not a


def test_metric_scope_turns_tf32_off_and_back():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with metric_scope("cpu") as dev:
            assert dev == torch.device("cpu") and not torch.is_grad_enabled()
            assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------ format_results


HEADER = "Model,Reference Type,FID,LPIPS,CLIP,D-LPIPS,I-LPIPS"
TABLES = {
    "full": [HEADER, "m,in-domain-ref,10.645,0.1235,79,0.2,0.3", "m,id-ref,12.5,0.0005,80.125,0.2225,0.5",
             "m,track-ref,1.005,0.2345,70.005,0.1115,0.7", "m,cross-domain-ref,2.675,1.0005,0.285,0.4,0.6"],
    "duplicate_and_missing": [HEADER, "m,in-domain-ref,10.645,0.1235,79,,", "m,id-ref,nan,0.0005,80.125,0.2225,0.5",
                              "m,id-ref,1,2,3,4,5", "m,cross-domain-ref,2.675,1.0005,0.285,,"],
    "no_lidar": [HEADER, "m,track-ref,5.015,0.0015,1.005,,", "m,in-domain-ref,nan,nan,nan,nan,nan"],
    "frd_column": [HEADER + ",FRD", "m,track-ref,1,2,3,4,5,6.125", "m,id-ref,1,2,3,4,5,7.135",
                   "m,cross-domain-ref,0.5,0.25,0.125,0.0625,0.03125,8.145"],
    "one_mode": [HEADER, "m,id-ref,3.14159,0.0015,99.995,0.0025,0.0035"],
}


@pytest.mark.parametrize("name", sorted(TABLES) + ["random"])
def test_format_results_prints_as_the_jax_script(tmp_path, name, capsys):
    lines = TABLES.get(name)
    if lines is None:  # half-way values, nan and empty cells, modes in any order and repeated
        rng = np.random.default_rng(1)
        lines = [HEADER + ",FRD"]
        for mode in rng.permutation(list(rtb.MODES) + ["id-ref", "track-ref"]):
            cells = [rng.choice(["%.4f" % rng.uniform(0, 100), "%.3f5" % rng.uniform(0, 2), "", "nan",
                                 str(rng.integers(0, 99))]) for _ in range(6)]
            lines.append(",".join(["m", str(mode)] + cells))
    path = str(tmp_path / "realism_table.csv")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    jformat.main(path)
    want = capsys.readouterr().out
    format_results.main(path)
    assert capsys.readouterr().out == want


# ------------------------------------------------------- the realism bench


@pytest.fixture(scope="module")
def realism_setup(tmp_path_factory):
    """The tiny model on the CPU (saved as tiny_model.ckpt, which the bench
    loads back into it) and the port's synthetic database (800 x 450)."""
    from mobi_tpu_torch.data.synthetic import build_synthetic_database

    root = tmp_path_factory.mktemp("realism")
    db = build_synthetic_database(str(root / "db"), seed=0)
    model = tdiff.MobiDiffusion(port_config(TINY), device="cpu", cond_stage_model=tiny_cond_stage(), seed=3)
    ckpt = str(root / "tiny_model.ckpt")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    return db, model, ckpt


@pytest.fixture
def small_refs(monkeypatch):
    """The tiny CLIP's 32 x 32 reference crops (the dataset cuts 224)."""
    make = tbench.make_inpaint_pipeline

    def small(model, **kw):
        run = make(model, **kw)

        def call(batch, generator):
            refs = batch["image"]["cond"]["ref_image"]
            batch["image"]["cond"]["ref_image"] = np.stack([imgproc.resize_linear(np.asarray(r), 32, 32)
                                                            for r in refs])
            return run(batch, generator)

        return call

    monkeypatch.setattr(tbench, "make_inpaint_pipeline", small)


def realism_argv(out, db, ckpt, use_lidar="True", extra=""):
    sizes = dict(db, image_height=32, image_width=32, range_height=32, range_width=64)
    overrides = " ".join(f"data.params.test.params.{k}={v}" for k, v in sizes.items())
    return ["--ckpt", ckpt, "--config", CFG_512, "--out", str(out), "--steps", "2", "--n_per_class", "1",
            "--max_batches", "1", "--use_lidar", use_lidar, "--extra_overrides", f"{overrides} {extra}".strip(),
            "--device", "cpu"]


def test_realism_bench_on_tiny(tmp_path, realism_setup, weights, small_refs, monkeypatch, capsys,
                               few_torch_threads):  # noqa: F811
    """Four modes in the shell's order, its header, Model without .ckpt.
    With the LPIPS weights set and no CLIP weights: the LPIPS, D-LPIPS and
    I-LPIPS fields hold what lpips_score prints on the mode's folders, FID
    and CLIP are nan with the scorers' errors on stderr. A second run with
    use_lidar False appends rows with empty D- and I-LPIPS fields (the
    dataset keeps its lidar through EXTRA_OVERRIDES: the test bench reads
    the batch's lidar whatever use_lidar says, in JAX too, ROADMAP queue 3).
    No kernel launches on the CPU."""
    db, model, ckpt = realism_setup
    for var in ("CLIP_B32_WEIGHTS", "INCEPTION_WEIGHTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("LPIPS_WEIGHTS", weights["lpips"])
    monkeypatch.setenv("ALEXNET_WEIGHTS", weights["alexnet"])
    out = tmp_path / "realism"
    built = []
    build = lpips_score.lpips_model
    monkeypatch.setattr(lpips_score, "lpips_model", lambda *a: built.append(a) or build(*a))
    res = rtb.main(realism_argv(out, db, ckpt), model=model)
    captured = capsys.readouterr()
    assert list(res) == list(rtb.MODES)
    assert len(built) == 1  # LPIPS, D- and I-LPIPS of four modes on one network
    assert captured.err.count("camera FID requires CLIP ViT-B/32 weights") == 4
    assert captured.err.count("CLIP score requires --weights") == 4
    with open(out / "realism_table.csv") as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    assert ",".join(rows[0]) == HEADER == rtb.HEADER
    assert [r[:2] for r in rows[1:]] == [["tiny_model", m] for m in rtb.MODES]
    for mode, row in zip(rtb.MODES, rows[1:]):
        assert row[2] == "nan" and row[4] == "nan", row
        d = out / mode
        for field, (a, b) in zip(row[3:4] + row[5:7], [("camera/patch_gt", "camera/patch_pred"),
                                                       ("lidar/range_depth_target", "lidar/range_depth_pred"),
                                                       ("lidar/range_intensity_target",
                                                        "lidar/range_intensity_pred")]):
            line = port_cli(lpips_score.main, ["--path_target", str(d / a), "--path_pred", str(d / b)], capsys)
            assert line == f"LPIPS: {field}" and np.isfinite(float(field))

    rtb.main(realism_argv(out, db, ckpt, use_lidar="False", extra="use_lidar=True"), model=model)
    with open(out / "realism_table.csv") as f:
        rows = [line.rstrip("\n").split(",") for line in f]
    assert len(rows) == 9 and rows.count(rows[0]) == 1
    for row in rows[5:]:
        assert row[5:] == ["", ""] and row[3] != "nan", row
    # the table formats, the empty fields as NaN
    capsys.readouterr()
    format_results.main(str(out / "realism_table.csv"))
    got = capsys.readouterr().out
    jformat.main(str(out / "realism_table.csv"))
    assert got == capsys.readouterr().out and got.startswith("latex row: nan & ")


def test_realism_bench_arguments(monkeypatch):
    """The shell's variables as flags (defaults from the environment, else
    the shell's), the inference arguments of run_experiment, and the model
    name of `basename $CKPT .ckpt`."""
    for var in ("CKPT", "CONFIG", "OUT", "STEPS", "SCALE", "USE_LIDAR", "N_PER_CLASS", "MAX_BATCHES",
                "EXTRA_OVERRIDES"):
        monkeypatch.delenv(var, raising=False)
    opt = rtb.parse_args([])
    assert (opt.ckpt, opt.config, opt.out, opt.steps, opt.scale, opt.use_lidar, opt.n_per_class,
            opt.max_batches, opt.extra_overrides, opt.device) == (
        "checkpoints/mobi_nusc_512/mobi_nuscenes_epoch28.ckpt", "configs/mobi_nusc_512.yaml", "results/realism",
        "50", "5", "True", "100", "", "", "cuda")
    monkeypatch.setenv("STEPS", "7")
    monkeypatch.setenv("EXTRA_OVERRIDES", "a.b=1  c=d")
    opt = rtb.parse_args(["--max_batches", "2"])
    assert rtb.bench_argv(opt, "track-ref") == [
        "--config", "configs/mobi_nusc_512.yaml", "--ckpt", "checkpoints/mobi_nusc_512/mobi_nuscenes_epoch28.ckpt",
        "--outdir", "results/realism/track-ref", "--plms", "--ddim_steps", "7", "--scale", "5", "--n_samples", "4",
        "--seed", "321", "--save_samples", "--save_visualisations", "--device", "cuda", "--max_batches", "2",
        "ref_mode=track-ref", "data.params.test.params.num_samples_per_class=100", "use_lidar=True", "a.b=1",
        "c=d"]
    assert tbench.parse_args(rtb.bench_argv(opt, "id-ref")).plms
    for ckpt, name in (("a/b/model.ckpt", "model"), ("model.ckpt", "model"), ("x/y.pth", "y.pth"),
                       ("dir/run/", "run"), (".ckpt", ".ckpt"), ("", "")):
        assert rtb.model_name(ckpt) == name


def test_score_keeps_the_shells_number():
    """The field is what `grep -oP 'LABEL:\\s*\\K[0-9.]+'` takes from the
    scorer's output: a negative number or no line is nan."""
    def printing(text):
        def tool(argv):
            print(text)
        return tool

    assert rtb.score(printing("FID: 12.3400"), "FID", []) == "12.3400"
    assert rtb.score(printing("FID: -0.0001"), "FID", []) == "nan"
    assert rtb.score(printing("CLIP score: 81.25"), "CLIP score", []) == "81.25"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert rtb.score(lambda argv: sys.exit("no weights"), "FID", ["--x"]) == "nan"
    assert "no weights" in err.getvalue()
