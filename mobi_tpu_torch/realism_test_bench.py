"""The realism bench (scripts/realism_test_bench.sh of the JAX package):
inference over N objects a class in each of four reference modes, then FID,
LPIPS and CLIP on the camera patches, and D-LPIPS and I-LPIPS on the saved
normalised range-view PNGs, a row a mode appended to `realism_table.csv`.

  python -m mobi_tpu_torch.realism_test_bench --ckpt model.ckpt --config configs/mobi_nusc_512.yaml \
      --out results/realism [--steps 50] [--scale 5] [--use_lidar True] [--n_per_class 100] \
      [--max_batches N] [--extra_overrides "a.b=1 c=d"] [--device cuda]

The shell's variables (CKPT CONFIG OUT STEPS SCALE USE_LIDAR N_PER_CLASS
MAX_BATCHES EXTRA_OVERRIDES) are flags of the same names in lower case, and
each flag's default is the variable where the environment sets it, else
the shell's default. The modes run in the shell's order (in-domain-ref,
id-ref, track-ref, cross-domain-ref): each runs `inference_test_bench.main`
with the shell's arguments into OUT/<mode>, then the scorers in this
process on its folders, with their weights from the environment as the
shell leaves them (CLIP_B32_WEIGHTS, LPIPS_WEIGHTS, ALEXNET_WEIGHTS). A field
holds the number the scorer printed, as the shell's grep takes it, or `nan`
when the scorer failed; its error goes to stderr. `Model` is the
checkpoint's basename without `.ckpt`. The D- and I-LPIPS fields are empty
unless use_lidar is True. The bench and the scorers run on the card unless
`--device cpu`; the scorers in fp32 with TF32 off.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import sys
from typing import Callable, Dict, List

from mobi_tpu_torch import inference_test_bench
from mobi_tpu_torch.eval_tool import reuse_networks
from mobi_tpu_torch.eval_tool.camera import clip_score, fid_score, lpips_score

MODES = ("in-domain-ref", "id-ref", "track-ref", "cross-domain-ref")
HEADER = "Model,Reference Type,FID,LPIPS,CLIP,D-LPIPS,I-LPIPS"


def parse_args(argv=None):
    env = os.environ.get
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", default=env("CKPT", "checkpoints/mobi_nusc_512/mobi_nuscenes_epoch28.ckpt"))
    p.add_argument("--config", default=env("CONFIG", "configs/mobi_nusc_512.yaml"))
    p.add_argument("--out", default=env("OUT", "results/realism"))
    p.add_argument("--steps", default=env("STEPS", "50"))
    p.add_argument("--scale", default=env("SCALE", "5"))
    p.add_argument("--use_lidar", default=env("USE_LIDAR", "True"))
    p.add_argument("--n_per_class", default=env("N_PER_CLASS", "100"))
    p.add_argument("--max_batches", default=env("MAX_BATCHES", ""),
                   help="cap the batches of each mode (empty: all)")
    p.add_argument("--extra_overrides", default=env("EXTRA_OVERRIDES", ""),
                   help="extra config dotlist overrides, split on whitespace")
    p.add_argument("--device", default="cuda", help="where the bench and the scorers run (cpu for the CPU)")
    return p.parse_args(argv)


def model_name(ckpt: str) -> str:
    """`basename "$CKPT" .ckpt`."""
    name = os.path.basename(ckpt.rstrip("/"))
    return name[:-len(".ckpt")] if name.endswith(".ckpt") and name != ".ckpt" else name


def bench_argv(opt, mode: str) -> List[str]:
    """The shell's run_experiment arguments for one mode."""
    return (["--config", opt.config, "--ckpt", opt.ckpt, "--outdir", os.path.join(opt.out, mode),
             "--plms", "--ddim_steps", opt.steps, "--scale", opt.scale,
             "--n_samples", "4", "--seed", "321", "--save_samples", "--save_visualisations",
             "--device", opt.device]
            + (["--max_batches", opt.max_batches] if opt.max_batches else [])
            + [f"ref_mode={mode}", f"data.params.test.params.num_samples_per_class={opt.n_per_class}",
               f"use_lidar={opt.use_lidar}"]
            + opt.extra_overrides.split())


def score(tool: Callable, label: str, argv: List[str]) -> str:
    """One scorer in this process: the number after `label:` in what it
    prints (the shell's `grep -oP "label:\\s*\\K[0-9.]+"`), or "nan" when
    there is none; a failure's message goes to stderr."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            tool(argv)
    except (Exception, SystemExit) as err:
        msg = err.code if isinstance(err, SystemExit) else f"{type(err).__name__}: {err}"
        print(f"realism_test_bench: {tool.__module__} {' '.join(argv)}: {msg}", file=sys.stderr)
    hit = re.search(rf"{re.escape(label)}:\s*([0-9.]+)", out.getvalue())
    return hit.group(1) if hit else "nan"


def compute_scores(opt, mode: str) -> Dict[str, str]:
    d = os.path.join(opt.out, mode)
    dev = ["--device", opt.device]

    def pair(a, b, target="--path_target"):
        return [target, os.path.join(d, a), "--path_pred", os.path.join(d, b)] + dev

    fields = {
        "FID": score(fid_score.main, "FID", pair("camera/patch_gt", "camera/patch_pred")),
        "LPIPS": score(lpips_score.main, "LPIPS", pair("camera/patch_gt", "camera/patch_pred")),
        "CLIP": score(clip_score.main, "CLIP score", pair("camera/object_ref", "camera/object_pred", "--path_ref")),
        "D-LPIPS": "", "I-LPIPS": "",
    }
    if opt.use_lidar == "True":
        fields["D-LPIPS"] = score(lpips_score.main, "LPIPS",
                                  pair("lidar/range_depth_target", "lidar/range_depth_pred"))
        fields["I-LPIPS"] = score(lpips_score.main, "LPIPS",
                                  pair("lidar/range_intensity_target", "lidar/range_intensity_pred"))
    return fields


def main(argv=None, model=None) -> Dict[str, Dict]:
    """Run the bench. `model` goes to every `inference_test_bench.main` call
    (an in-memory model in place of the config's; a --ckpt still loads into
    it). The scorers build each network once for all four modes
    (`eval_tool.reuse_networks`). Returns {mode: {"bench": its stats,
    "fields": its CSV fields}}."""
    opt = parse_args(argv)
    table = os.path.join(opt.out, "realism_table.csv")
    os.makedirs(opt.out, exist_ok=True)
    if not os.path.isfile(table):
        with open(table, "w") as f:
            f.write(HEADER + "\n")
    name = model_name(opt.ckpt)
    results = {}
    with reuse_networks():
        for mode in MODES:
            stats = inference_test_bench.main(bench_argv(opt, mode), model=model)
            fields = compute_scores(opt, mode)
            with open(table, "a") as f:
                f.write(",".join([name, mode] + [fields[k] for k in HEADER.split(",")[2:]]) + "\n")
            results[mode] = {"bench": stats, "fields": fields}
    with open(table) as f:
        print(f.read(), end="")
    return results


if __name__ == "__main__":
    main()
