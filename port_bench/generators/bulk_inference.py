"""Bulk inpainting, a closed loop with one client: back-to-back batches of
`pairs` through the pipeline that `make_inpaint_pipeline` returns, each
batch's host inputs (in the dataset's schema) handed to the pipeline,
which stages them on the card, and its outputs copied back to the host,
as a bulk editing job saves them. Whole batches run until the window's
seconds have passed. The host inputs are a pool of POOL_BATCHES batches
drawn from (seed, pool index) in set-up, so the window times the program
and not the benchmark's own draws; batch i takes pool batch
i mod POOL_BATCHES and its own x_T.

The draws are fixed through the pipeline's own arguments, so the reference
can make them again: the posterior means (`deterministic_encode=True`) and
x_T from a card generator seeded by (seed, batch).

The check runs after the window on the program's state freed: a sample of
the window's pairs, drawn from the seed, each recomputed by the float32
reference from the same inputs and x_T, compared by the relative L2 of
each modality's output.

Mix parameters: pairs, num_steps, guidance_scale, check_pairs,
trace_units (whole batches in a traced window).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import harness, inputs, weights
from port_bench.work import attention, flops

# host batches drawn in set-up; a few hundred MB at the cells' sizes
POOL_BATCHES = 4


def _rows_per_pair(arch) -> int:
    return 2 if arch["use_camera"] and arch["use_lidar"] else 1


def make_inputs(cell: harness.Cell, seed: int, index: int, pairs: int):
    """The host inputs of window batch `index` (or of the warm-up's, -1)."""
    a = cell.arch
    if index >= 0:
        index %= POOL_BATCHES
    return inputs.make_batch(seed, index, pairs, a["image_height"], a["range_height"], a["use_lidar"],
                             "ref_bbox" in a["cond_stage_key"], a["ref_image_size"])


def x_T(cell: harness.Cell, seed: int, index: int, pairs: int, device) -> torch.Tensor:
    a = cell.arch
    g = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + int(index)) % (1 << 63))
    rows = pairs * _rows_per_pair(a)
    return torch.randn((rows, a["latent_size"], a["latent_size"], a["channels"]), generator=g, device=device)


def prepare(run) -> Dict:
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline

    cell, mix = run.cell, run.cell.mix
    model, layout = harness.build_model(run)
    pipeline = make_inpaint_pipeline(model, num_steps=mix["num_steps"], guidance_scale=mix["guidance_scale"],
                                     sampler="ddim", deterministic_encode=True, device=run.device)
    # warm-up: every shape of the window (a DDIM step is the same UNet call
    # at every step, so two steps hold them all), on inputs of a stream the
    # window never uses
    warm = make_inpaint_pipeline(model, num_steps=2, guidance_scale=mix["guidance_scale"], sampler="ddim",
                                 deterministic_encode=True, device=run.device)
    out = warm(make_inputs(cell, run.seed, -1, mix["pairs"]), None, x_T=x_T(cell, run.seed, -1, mix["pairs"], run.device))
    {k: v.cpu() for k, v in out.items()}
    run.mark("warm_up")
    pool = [make_inputs(cell, run.seed, j, mix["pairs"]) for j in range(POOL_BATCHES)]
    run.mark("inputs")
    return {"model": model, "pipeline": pipeline, "layout": layout, "pool": pool}


def window(run, state: Dict, tracer=None) -> Dict:
    cell, mix = run.cell, run.cell.mix
    pairs, pipeline, pool = mix["pairs"], state["pipeline"], state["pool"]
    outputs: List[Dict[str, torch.Tensor]] = []
    run.window_started()
    start = time.perf_counter()
    while True:
        if tracer is not None:
            if len(outputs) >= mix["trace_units"]:
                break
        elif outputs and time.perf_counter() - start >= run.seconds:
            break
        i = len(outputs)
        out = pipeline(pool[i % len(pool)], None, x_T=x_T(cell, run.seed, i, pairs, run.device))
        outputs.append({k: v.cpu() for k, v in out.items()})
        if tracer is not None:
            tracer.units = len(outputs)
    elapsed = time.perf_counter() - start
    done = pairs * len(outputs)
    finite = [bool(torch.isfinite(o[k][p].float()).all()) for o in outputs for p in range(pairs) for k in o]
    per_pair = len(outputs[0])
    state["outputs"] = outputs
    return {"end_to_end": {"inpaints_per_hour": done * 3600.0 / elapsed},
            "attempted": done, "failed": sum(not all(finite[i:i + per_pair]) for i in range(0, len(finite), per_pair)),
            "elapsed_s": elapsed, "units": len(outputs)}


def work(run, state: Dict, units: int) -> Dict:
    """Operations and attention calls of `units` batches."""
    cell, mix = run.cell, run.cell.mix
    split = flops.inference(cell.arch, state["layout"], mix["num_steps"])
    unet_batch = 2 * _rows_per_pair(cell.arch) * mix["pairs"]
    calls = attention.unet_calls(cell.arch, unet_batch)
    forwards = units * mix["num_steps"]
    peaks = harness.peaks(cell.bench_dir)
    k1 = [attention.forward_work(c) for c in calls]
    # K1's least time by each roof; the exp units' is printed, not used
    least = {"flops": sum(w[0] for w in k1) / peaks["bf16_flops_per_s"] * forwards,
             "bytes": sum(w[1] for w in k1) / peaks["hbm_bytes_per_s"] * forwards,
             "exp": sum(w[2] for w in k1) / peaks["exp_per_s"] * forwards}
    harness.log(line="work", flops_per_pair=split, flops_per_batch=split["total"] * mix["pairs"],
                flash_calls_per_unet_forward=[list(c) for c in calls], unet_forwards=forwards,
                k1_least_s_by_roof=least)
    return {"model_flops": split["total"] * mix["pairs"] * units,
            "kernels": {"attention_forward": [(attention.forward_work(c), forwards) for c in calls]}}


def sample(seed: int, units: int, pairs: int, k: int):
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 7])
    picks = rng.choice(units * pairs, size=min(k, units * pairs), replace=False)
    return sorted((int(p) // pairs, int(p) % pairs) for p in picks)


def release(state: Dict) -> None:
    for key in ("pipeline", "model", "pool"):
        state.pop(key, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_pair(run, layout, P, batch_index: int, pair: int, cast=None) -> Dict[str, torch.Tensor]:
    """The reference's outputs for one pair of a batch of the window."""
    from port_bench.reference import diffusion as D
    from port_bench.reference.nn import exact_fp32, operand_cast

    cell, mix = run.cell, run.cell.mix
    rows = _rows_per_pair(cell.arch)
    batch = inputs.pairs_of(make_inputs(cell, run.seed, batch_index, mix["pairs"]), pair, pair + 1)
    batch = inputs.tree_map(lambda x: torch.from_numpy(x).to(run.device), batch)
    noise = x_T(cell, run.seed, batch_index, mix["pairs"], run.device)[rows * pair:rows * (pair + 1)]
    with exact_fp32(), operand_cast(cast):
        return D.inpaint(P, cell.arch, batch, noise, mix["num_steps"], mix["guidance_scale"])


def rel_l2(out: torch.Tensor, ref: torch.Tensor) -> float:
    out, ref = out.double(), ref.double()
    return float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref))


def gaps(run, layout, picks, *answers) -> List[Dict[str, float]]:
    """For each answer, the widest relative L2 of each modality over the
    picked pairs against the float32 reference. An answer is a function
    (batch index, pair, reference weights) -> {modality: [1, ...] output}."""
    P = weights.generate(layout, run.seed, run.device, fp32=True)
    worst: List[Dict[str, float]] = [{} for _ in answers]
    for j, p in picks:
        ref = reference_pair(run, layout, P, j, p)
        for w, answer in zip(worst, answers):
            got = answer(j, p, P)
            for k, r in ref.items():
                w[k] = max(w.get(k, 0.0), rel_l2(got[k].to(run.device), r))
    del P
    return worst


def _judged(run, state: Dict, control: bool = False):
    """The program's gaps on the sample of the window's pairs, with the
    program's state freed first; with `control`, also the control's: the
    reference in fp8 (the precision below bf16) put in the program's place."""
    from port_bench.reference.control import fp8_e4m3

    mix = run.cell.mix
    outputs = state["outputs"]
    picks = sample(run.seed, len(outputs), mix["pairs"], mix["check_pairs"])
    release(state)
    answers = [lambda j, p, P: {k: v[p:p + 1] for k, v in outputs[j].items()}]
    if control:
        answers.append(lambda j, p, P: reference_pair(run, state["layout"], P, j, p, fp8_e4m3))
    return picks, gaps(run, state["layout"], picks, *answers)


def check(run, state: Dict) -> List[harness.Check]:
    picks, (worst,) = _judged(run, state)
    harness.log(line="check_sample", pairs=[list(p) for p in picks])
    return [harness.Check(f"{k}_rel_l2", v, run.cell.limits[f"{k}_rel_l2"]) for k, v in sorted(worst.items())]


def readings(run, control: bool) -> Dict:
    """What a limit is set from, for one seed: the program's gaps after one
    batch of the window's own set-up and loop, and with `control` the
    control's on the same pairs."""
    state = prepare(run)
    window(run, state)  # a window of 0 s runs one whole batch
    t = time.perf_counter()
    _, found = _judged(run, state, control)
    row = {"program": found[0], "reference_s": time.perf_counter() - t}
    if control:
        row["control"] = found[1]
    return row
