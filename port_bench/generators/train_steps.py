"""Adapter fine-tuning: back-to-back steps of the `train_step` that
`training.make_train_step` returns, on the state `training.create_train_state`
builds (adapter-only AdamW under LDM's linear warm-up). A pool of seeded
batches is staged on the card; step k takes pool batch k mod pool_batches
and injected draws made from (seed, k): its timesteps, its noise and its
whole-batch CFG drop. The posterior samples of the encodes come from the
step's generator, seeded from the seed. The loop never synchronizes; one
synchronize ends the window.

Set-up drives the state through its first `check_steps` steps, on pool
batches that all differ, through the same call and feed, and keeps what
the check compares: each step's loss, each trainable tensor's first
gradient as the optimizer got it (its first moment after step 1 over
1 - beta1) and its change after the last of those steps. The window goes
on from there with the same state. After the window, with the program's
state freed, the float32 reference makes the same steps from the same
weights, batches and draws, and the check compares the three by the worst
trainable tensor.

Mix parameters: pairs, pool_batches, base_lr, warm_up_steps,
u_cond_percent, check_steps, trace_units (steps in a traced window).
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import harness, inputs, weights
from port_bench.work import attention, flops

BETA1 = 0.9
# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone and are left out of the gradient and change checks
NOUGHT_SHARE = 1e-3


def _rows(arch, pairs: int) -> int:
    return pairs * (2 if arch["use_camera"] and arch["use_lidar"] else 1)


def draws(cell: harness.Cell, seed: int, k: int, device, noise_dtype):
    """(t [rows], noise [rows, h, w, 4], drop) of step k."""
    a, mix = cell.arch, cell.mix
    rows, lat = _rows(a, mix["pairs"]), a["latent_size"]
    g = torch.Generator(device=device).manual_seed((int(seed) * 1_000_033 + int(k)) % (1 << 63))
    t = torch.randint(0, a["timesteps"], (rows,), generator=g, device=device)
    noise = torch.randn((rows, lat, lat, a["channels"]), generator=g, device=device).to(noise_dtype)
    drop = bool(np.random.default_rng([int(seed) & ((1 << 64) - 1), int(k), 3]).random() < mix["u_cond_percent"])
    return t, noise, drop


def posterior_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((int(seed) * 7 + 11) % (1 << 63))


def pool_batch(cell: harness.Cell, seed: int, j: int):
    a = cell.arch
    return inputs.make_batch(seed, 1000 + j, cell.mix["pairs"], a["image_height"], a["range_height"],
                             a["use_lidar"], "ref_bbox" in a["cond_stage_key"], a["ref_image_size"])


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def prepare(run) -> Dict:
    from mobi_tpu_torch import training as T

    cell, mix = run.cell, run.cell.mix
    model, layout = harness.build_model(run, for_training=True)
    state, tx = T.create_train_state(model, schedule=T.lambda_linear_schedule(mix["base_lr"], mix["warm_up_steps"]),
                                     device=run.device)
    step = T.make_train_step(model, tx, device=run.device)
    pool = [inputs.tree_map(lambda x: torch.from_numpy(x).to(run.device), pool_batch(cell, run.seed, j))
            for j in range(mix["pool_batches"])]
    gen = posterior_generator(run.seed, run.device)
    dtype = getattr(torch, cell.config["dtype"])
    names = {id(p): n for n, p in model.named_parameters()}
    init = {names[id(p)]: p.detach().clone() for p in tx.params}
    st = {"model": model, "state": state, "tx": tx, "step": step, "pool": pool, "gen": gen, "dtype": dtype,
          "layout": layout, "k": 0, "losses": []}
    run.mark("train_state")
    for k in range(mix["check_steps"]):
        _, metrics = _step(run, st)
        st["losses"].append(float(metrics["loss"]))
        if k == 0:
            # an optimizer that never got a gradient holds no moment: nought
            st["first_grad"] = leaf_norms({names[id(p)]: tx.inner.state[p].get("exp_avg", torch.zeros(()))
                                           / (1 - BETA1) for p in tx.params})
    st["change"] = leaf_norms({names[id(p)]: p.detach() - init[names[id(p)]] for p in tx.params})
    del init
    run.mark("checked_steps")
    return st


def _step(run, st):
    cell = run.cell
    k = st["k"]
    t, noise, drop = draws(cell, run.seed, k, run.device, st["dtype"])
    batch = st["pool"][k % len(st["pool"])]
    st["k"] = k + 1
    return st["step"](st["state"], batch, st["gen"], t=t, noise=noise, drop=drop)


def window(run, state: Dict, tracer=None) -> Dict:
    mix = run.cell.mix
    losses = []
    run.window_started()
    start = time.perf_counter()
    while True:
        if tracer is not None:
            if len(losses) >= mix["trace_units"]:
                break
        elif losses and time.perf_counter() - start >= run.seconds:
            break
        _, metrics = _step(run, state)
        losses.append(metrics["loss"])
        if tracer is not None:
            tracer.units = len(losses)
    torch.cuda.synchronize(run.device) if run.device.type == "cuda" else None
    elapsed = time.perf_counter() - start
    finite = torch.isfinite(torch.stack(losses)).tolist()
    return {"end_to_end": {"train_pairs_per_s": len(losses) * mix["pairs"] / elapsed},
            "attempted": len(losses), "failed": sum(not f for f in finite), "elapsed_s": elapsed,
            "units": len(losses)}


def work(run, state: Dict, units: int) -> Dict:
    from port_bench.reference.diffusion import trainable

    cell, mix = run.cell, run.cell.mix
    step_flops = flops.training(cell.arch, state["layout"], mix["pairs"],
                                [n for n in state["layout"] if trainable(n)])["step"]
    calls = attention.unet_calls(cell.arch, _rows(cell.arch, mix["pairs"]))
    # the first call's q, k and v come from frozen layers and the latent
    # alone, so it runs without a gradient (K1); every later one carries one
    harness.log(line="work", flops_per_step=step_flops, flash_calls_per_unet_forward=[list(c) for c in calls],
                steps=units)
    fwd = [(attention.forward_work(c), units) for c in calls[:1]] + [(attention.forward_lse_work(c), units)
                                                                     for c in calls[1:]]
    bwd = [(attention.backward_work(c), units) for c in calls[1:]]
    return {"model_flops": step_flops * units,
            "kernels": {"attention_forward": fwd, "attention_backward": bwd}}


def release(state: Dict) -> None:
    for key in ("step", "tx", "state", "model", "pool", "gen"):
        state.pop(key, None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_steps(run, layout, steps: int, cast=None, rows_kept=None) -> Dict:
    """The reference's first `steps` steps: each step's loss, the first
    gradient's and the last change's norm of each trainable tensor, and
    each tensor's largest gradient norm over the steps. It runs one pair at
    a time, its gradients summed over the batch, so that it fits beside
    nothing else on the card. `rows_kept` (a fault for the tests and
    readings) takes the loss over the batch's first pairs only."""
    from port_bench.reference import diffusion as D
    from port_bench.reference.nn import exact_fp32, operand_cast

    cell, mix = run.cell, run.cell.mix
    a = cell.arch
    dtype = getattr(torch, cell.config["dtype"])
    P = weights.generate(layout, run.seed, run.device, fp32=True)
    names = [n for n in layout if D.trainable(n)]
    params = {n: P[n].clone().requires_grad_(True) for n in names}
    init = {n: P[n].clone() for n in names}
    view = {**P, **params}
    gen = posterior_generator(run.seed, run.device)
    opt_state: Dict = {}
    pairs = mix["pairs"]
    rpp = _rows(a, 1)
    down = 2 ** (len(a["vae_ch_mult"]) - 1)
    losses, first_grad, max_grad = [], None, {n: 0.0 for n in names}
    for k in range(steps):
        t, noise, drop = draws(cell, run.seed, k, run.device, dtype)
        noise = noise.float()
        batch = inputs.tree_map(lambda x: torch.from_numpy(x).to(run.device),
                                pool_batch(cell, run.seed, k % mix["pool_batches"]))
        post = []
        for _, size in (("image", a["image_height"]), ("lidar", a["range_height"]))[: 2 if a["use_lidar"] else 1]:
            for _ in range(2):
                post.append(torch.randn((pairs, 4, size // down, size // down), generator=gen, device=run.device,
                                        dtype=dtype).float())
        kept = pairs if rows_kept is None else rows_kept
        total = 0.0
        with exact_fp32(), operand_cast(cast):
            for i in range(kept):
                sub = inputs.pairs_of(batch, i, i + 1)
                loss = D.training_loss(view, a, sub, t[i * rpp:(i + 1) * rpp], noise[i * rpp:(i + 1) * rpp], drop,
                                       [p[i:i + 1] for p in post])
                (loss / kept).backward()
                total += float(loss.detach()) / kept
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in params.items()}
        norms = leaf_norms(grads)
        if k == 0:
            first_grad = norms
        for n in names:
            max_grad[n] = max(max_grad[n], norms[n])
        losses.append(total)
        D.adamw_step({n: p.data for n, p in params.items()}, {n: g.detach() for n, g in grads.items()},
                     opt_state, D.lambda_linear_lr(mix["base_lr"], mix["warm_up_steps"], k))
        for p in params.values():
            p.grad = None
    change = leaf_norms({n: params[n].detach() - init[n] for n in names})
    del P, view, params, init
    return {"losses": losses, "first_grad": first_grad, "change": change, "max_grad": max_grad}


def worst_leaf(got: Dict[str, float], ref: Dict[str, float], gate: Dict[str, float]) -> float:
    """The widest gap of the two norms of a tensor, against the larger of
    the reference's norm of that tensor and of the median tensor's, over
    the tensors whose reference gradient `gate` is not nought to rounding."""
    med_gate = statistics.median(gate.values())
    keep = [n for n in ref if gate[n] >= NOUGHT_SHARE * med_gate]
    med = statistics.median(ref[n] for n in keep)
    return max(abs(got[n] - ref[n]) / max(ref[n], med) for n in keep)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
            "grad_gap": worst_leaf(prog["first_grad"], ref["first_grad"], ref["first_grad"]),
            "change_gap": worst_leaf(prog["change"], ref["change"], ref["max_grad"])}


def check(run, state: Dict) -> List[harness.Check]:
    mix = run.cell.mix
    prog = {"losses": state["losses"], "first_grad": state["first_grad"], "change": state["change"]}
    release(state)
    ref = reference_steps(run, state["layout"], mix["check_steps"])
    gaps = compare(prog, ref)
    harness.log(line="check_readings", program_losses=prog["losses"], reference_losses=ref["losses"])
    return [harness.Check(k, v, run.cell.limits[k]) for k, v in sorted(gaps.items())]


def readings(run, control: bool) -> Dict:
    """What a limit is set from, for one seed: the program's gaps after
    set-up's checked steps, and with `control` the control's (the reference
    in fp8, the precision below bf16, put in the program's place) and the
    fault of a loss over half of the batch."""
    mix = run.cell.mix
    st = prepare(run)
    prog = {"losses": st["losses"], "first_grad": st["first_grad"], "change": st["change"]}
    release(st)
    t = time.perf_counter()
    ref = reference_steps(run, st["layout"], mix["check_steps"])
    row = {"program": compare(prog, ref), "reference_s": time.perf_counter() - t,
           "losses": {"program": prog["losses"], "reference": ref["losses"]}}
    if control:
        from port_bench.reference.control import fp8_e4m3

        row["control"] = compare(reference_steps(run, st["layout"], mix["check_steps"], fp8_e4m3), ref)
        half = reference_steps(run, st["layout"], mix["check_steps"], rows_kept=mix["pairs"] // 2)
        row["fault_half_batch"] = compare(half, ref)
    return row
