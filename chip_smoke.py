#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (mobi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

  1. device   the card's name and power limit (nvidia-smi), TF32 settings
  2. build    nvcc builds mobi_tpu_torch/csrc/*.cu for sm_90a; when it
              built them in this run, each source's nvcc seconds and the
              registers, stack and spills that ptxas reports for each
              instantiation
  3. kernels  each CUDA kernel against its plain PyTorch version, with
              kernel, plain and library times and the least time the card
              could take (bound): K1 (flash forward) and K2 (flash forward
              with the transposed accumulator), in bf16 the wgmma/TMA
              kernel of csrc/flash_fwd_sm90.cu, and K6 (fused GroupNorm +
              SiLU) at the flagship's shapes and edge cases, in bf16 and
              (at the largest shapes) fp32, with the host's cost per call
              of the TMA kernel; K3 (flash forward with logsumexp; in bf16
              the same sm90 kernel with its lse output), K4 (dq) and K5
              (dk, dv; in bf16 the wgmma/TMA kernels of
              csrc/flash_bwd_sm90.cu, checked bitwise equal on a second run)
              at every shape of the training step and at edge cases, and in
              fp32 at the training shapes; every flash kernel at the head
              dims off the UNet's default two (64, 128, 160 and 256, with
              SDPA's time, the bound's share and the spills of the
              instantiation that ran; K2 at 56); K6 with the launch plan of
              each shape, the first port's design timed beside it, and at
              spans off the main path (odd H * W, B * G not a multiple of
              the cluster size, 8 elements), in bf16 and fp32
  4. flagship the 512x512 joint camera + lidar DDIM-50 CFG-5 inpaint at the
              full width of MobiConfig() in bf16, seeded random weights,
              2 pairs: counts the kernel launches of one batch, times
              TIMED_BATCHES more with CUDA events, profiles a 2-step and a 4-step batch
              (device time by kernel class, scaled to 50 steps), and counts
              one batch with the fused GroupNorm + SiLU switch on
  5. switches one full-width UNet forward with the kernels against the same
              forward through the plain versions (fused GroupNorm + SiLU on
              and off; K1, K2 and the plain formula; attn_backend "flash",
              which sends the d = 160 calls of the 16x16 level and the
              middle block to K1 too)
  6. serve    the serving path (mobi_tpu_torch.serve_http.build_service,
              InpaintService) at the same full width, PLMS-50 CFG-5, 2 pairs
              a batch: 5 queued requests as batches [2, 2, 1 + 1 padded]
              (counters, launches, walls, outputs equal to direct pipeline
              calls, one served batch's device time under torch.profiler),
              then 2 requests over HTTP from 2 threads;
              plms_tav: one of those batches again with the K2 switch on
  7. fp32     the default MobiConfig() (fp32) at full width: one UNet
              forward through K1, K2 and K6 in fp32 against the plain
              versions, and the trainable gradients of one fp32 training
              loss at 1 pair through K3, K4 and K5 against the plain path
  8. train    the adapter training step at the same full width (bf16
              compute, fp32 trainable masters, AdamW at lr 8e-5 with the
              200-step warm-up of configs/mobi_nusc_512.yaml), 2 pairs: one
              counted step, three timed with CUDA events, one with the fused
              GroupNorm + SiLU switch on, and the launches of one
              whole-UNet backward (MOBI_TRAIN_UNET_FULL=1)
  9. train_switches  the trainable gradients of one full-width training
              loss at 1 pair with the kernels against the plain versions
              (MOBI_FLASH_BWD kernels and xla; fused norm on and off;
              attn_backend "flash", K3-K5 at d = 160 included)
  10. the {"kernels": [...]} line (K1-K6), then the card's name and power
     limit, and last {"ok": true, "device": {...}}.

It needs a CUDA device and the mobi_tpu_torch package beside it; without
either it exits 2 and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAIRS = 2
STEPS = 50
GUIDANCE = 5.0
TIMED_BATCHES = 2       # few: the script's time limit
PROFILE_STEPS = (2, 4)
SEED = 0
TRAIN_PAIRS = 2         # batch_size of configs/mobi_nusc_512.yaml
TRAIN_TIMED_STEPS = 3   # likewise
TRAIN_LR, TRAIN_WARMUP = 8e-5, 200   # base_learning_rate, warm_up_steps
SWITCH_PAIRS = 1
SERVE_PAIRS = 2         # the service's batch_pairs
SERVE_REQUESTS = 5      # queued before the dispatcher starts: batches [2, 2, 1 + 1 padded]
PLMS_EVALS = STEPS + 1  # PLMS-50 evaluates the UNet twice at step 0

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit) and the
# special-function (exp2) rate cited by FlashAttention-3. The fp32 flash
# kernels run each product as three tf32 products on the tensor cores
# (3xTF32), so their bound counts 3x the flops at the TF32 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_SFU_OPS = 3.9e12
PEAK_BYTES = 3.35e12
# cuda_ms's spin kernel: cycles per second at the H100's 1.98 GHz boost clock
# (at a lower clock the spin only lasts longer)
SPIN_CYCLES_PER_S = 1.98e9

# Kernel vs plain version, both in bf16: |kernel - plain| <= ATOL + RTOL*|plain|.
# K1: both round their output to bf16, so RTOL is two bf16 ulps relative. The
# absolute term scales with the output: attention averages V, so with unit
# V the outputs have a std of about sqrt(e / N), 0.026 at N = 4096. Rounding
# the weights P to bf16 (2^-9 relative, the kernel before the sum, the plain
# version after it) moves an output by about 2^-9 x that std, so the tails
# over 10^7 outputs should stay near 0.01 std; ATOL is 2^-5 = 0.031 std of
# the plain output. Dropping one 64-key tile of 4096 moves an output by
# about 0.08 std. Each row prints its max error over the tolerance.
K1_ATOL_STD, K1_RTOL = 2 ** -5, 2 ** -6
# K6: outputs silu(GN(x) * gamma + beta) are of unit scale; the kernel takes the
# variance as E[x^2] - mean^2 and the plain version two-pass, both fp32, so
# the bf16 output rounding dominates.
K6_ATOL, K6_RTOL = 1e-2, 2 ** -6
# fp32 kernels against the fp32 plain versions (TF32 off). K1 and K2: atol
# 2e-5, the JAX kernel's own fp32 tolerance (tests/test_flash_attention.py:27);
# their 3xTF32 products keep ~22 bits of each operand. Each main-path row
# also runs the plain version with TF32 on (11 bits) as a control, which
# must fail that tolerance, so the check tells fp32 from TF32. K6: the two
# variance formulas and __expf differ by a few 1e-6 at unit-scale outputs.
F32_ATOL = 2e-5
K6_F32_ATOL, K6_F32_RTOL = 2e-5, 1e-5
# Whole-UNet eps with kernels vs plain versions, relative L2 error: bf16
# rounding differences compound over ~100 layers.
UNET_REL_L2 = 3e-2
# The same in fp32: the kernels differ from the plain versions by ~1e-6
# relative per call (3xTF32 products, ex2.approx, another summation order),
# compounded over the same depth; 1e-4 leaves that two decades.
FP32_UNET_REL_L2 = 1e-4
# K3's lse is fp32: the kernel's and the plain version's sums of N
# exponentials differ in order and by ex2.approx's 2^-22 relative error, a
# few 1e-6 of lse; dropping one 64-key tile of 4096 moves it by 0.016.
LSE_ATOL, LSE_RTOL = 1e-3, 1e-5
# K4 and K5 (dq, dk, dv) take K1's tolerance, 2^-5 of the plain output's std
# plus two bf16 ulps relative: the largest difference is dS, which both round
# to bf16 from fp32 values summed in another order, so some elements round
# the other way (2^-9 relative) and a gradient sums many with both signs.
# Where dP - delta cancels (nearly one-hot rows of extreme logits) the exact
# gradient is ~0 and fp32 rounding of dP - delta, carried through K or Q, is
# left: ~1e-7 at unit-scale inputs, ~2e-5 at q = 8, k ~ 8 N(0, 1). The floor
# BWD_ATOL_MIN times the inputs' scale (rms of q and k, at least 1) covers it.
BWD_ATOL_STD, BWD_ATOL_MIN, BWD_RTOL = 2 ** -5, 1e-5, 2 ** -6
# The bf16 K4 and K5 that the wgmma kernels of csrc/flash_bwd_sm90.cu
# replaced (mma.sync, csrc/flash_bwd.cu), ms per call at the training step's
# shapes (B, N, H, D), as this script's kernel phase timed them on an H100
# 80GB HBM3 at 700 W (PERF.md): each main-path row prints them as "was_ms".
MMA_SYNC_BWD_MS = {
    "flash_bwd_dq": {(4, 4096, 8, 40): 0.6922, (2, 4096, 8, 40): 0.3494,
                     (4, 1024, 8, 80): 0.0775, (2, 1024, 8, 80): 0.0402},
    "flash_bwd_dkv": {(4, 4096, 8, 40): 0.9493, (2, 4096, 8, 40): 0.4897,
                      (4, 1024, 8, 80): 0.0976, (2, 1024, 8, 80): 0.0504},
}
# The bf16 K3 that the sm90 kernel's lse output replaced (mma.sync,
# csrc/flash_fwd.cu, removed since), ms per training step at UNet batch 4,
# as this script's kernel phase timed it on an H100 80GB HBM3 at 700 W
# (PERF.md): the train_kernels_per_step line prints it under
# "was_ms_not_measured_here", and the kernels line leaves it out.
MMA_SYNC_K3_MS_PER_STEP = 4.657
# Kernel rows off the UNet's default head dims, (B, N, H, D): each flash
# kernel at the 64 and 128 builds, at d = 160 (the 16x16 and 8x8 levels'
# calls under attn_backend: flash, two slices of 80) and at 256 (four slices
# of 64), with times, bound and SDPA; K2, which serves d < 64, at 56. K6 at
# spans off the main path: an H * W that is not a multiple of 8 (the
# streaming variant), B * G not a multiple of the cluster size, a span of 8
# elements.
HEAD_DIM_SHAPES = ((4, 1024, 8, 64), (4, 1024, 4, 128), (8, 256, 8, 160), (8, 64, 8, 160), (4, 1024, 4, 256))
TAV_HEAD_DIM_SHAPES = ((4, 1024, 8, 56),)
GN_SPAN_SHAPES = ((2, 64, 7, 9), (3, 31, 240, 240), (2, 64, 2, 2))
TIMED_CASES = ("main_path", "head_dim")  # kernel rows with times and bound
# Trainable gradients of one training loss, kernels vs plain versions,
# relative L2: the gradient passes the depth twice (the forward, then the
# backward), so twice the forward's UNET_REL_L2; in fp32 twice FP32_UNET_REL_L2.
GRAD_REL_L2 = 2 * UNET_REL_L2
FP32_GRAD_REL_L2 = 2 * FP32_UNET_REL_L2
# fp32 K3-K5 against their fp32 plain versions (TF32 off), as
# tests/test_torch_kernels.py holds them: o, dq, dk and dv within 2^-10 of
# the reference's std (plus 1e-6 times the inputs' scale, the floor where
# dP - delta cancels), the lse within 2e-5 absolute. 3xTF32 with ex2.approx
# leaves about 1e-4 to 6e-4 of the std (the tensor cores' fp32 accumulation
# over N keys); the plain version with TF32 on misses by about 1e-2 of the
# std, and each main-path row asserts that this control fails the tolerance.
F32_ATOL_STD, F32_ATOL_MIN, LSE_F32_ATOL = 2 ** -10, 1e-6, 2e-5


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also gets the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def kernel_name(mangled: str) -> str:
    """name<template args> of a mangled kernel: the first identifier that
    ends in "kernel", is preceded by its length and followed by template
    arguments."""
    import re

    for m in re.finditer(r"(?=((?:flash|gn)_\w*?kernel)I(\w+?)EE)", mangled):
        if mangled[:m.start()].endswith(str(len(m[1]))):
            return f"{m[1]}<{', '.join(re.findall(r'L[a-z](\d+)', m[2])) or m[2]}>"
    return mangled


def ptxas_report(log: Path):
    """Registers, stack and spill bytes that ptxas -v reported for each
    kernel instantiation of every source, from the build's log, with the
    notes that name the instantiation (setmaxnreg, "Potential Performance
    Loss")."""
    import re

    rows, source = [], None
    for line in log.read_text().splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif source:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                rows.append({"source": source, "kernel": kernel_name(m.group(1)), "mangled": m.group(1)})
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and rows:
                rows[-1].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m and rows:
                rows[-1]["registers"] = int(m[1])
    notes = [line.strip() for line in log.read_text().splitlines()
             if "setmaxnreg" in line or "Performance" in line]
    for row in rows:
        row["notes"] = [n.split(")", 1)[-1].split(" for the function")[0].strip()
                        for n in notes if row["mangled"] in n]
        if not row["notes"]:
            del row["notes"]
        del row["mangled"]
    return rows


# The instantiations of each flash kernel, by (name, dtype): the kernel's
# name in the ptxas report and, for a kernel built with and without a flag,
# the flag's value (K2 in the sm90 forward; K3 in the fp32 forward).
_INSTANTIATIONS = {
    ("flash_fwd", "bfloat16"): ("flash_fwd_sm90_kernel", "0"),
    ("flash_fwd_lse", "bfloat16"): ("flash_fwd_sm90_kernel", "0"),
    ("flash_fwd_tav", "bfloat16"): ("flash_fwd_sm90_kernel", "1"),
    ("flash_fwd", "float32"): ("flash_fwd_kernel", "0"),
    ("flash_fwd_lse", "float32"): ("flash_fwd_kernel", "1"),
    ("flash_fwd_tav", "float32"): ("flash_fwd_tav_kernel", None),
    ("flash_bwd_dq", "bfloat16"): ("flash_bwd_dq_sm90_kernel", None),
    ("flash_bwd_dq", "float32"): ("flash_bwd_dq_kernel", None),
    ("flash_bwd_dkv", "bfloat16"): ("flash_bwd_dkv_sm90_kernel", None),
    ("flash_bwd_dkv", "float32"): ("flash_bwd_dkv_kernel", None),
}


def ptxas_for(report, name: str, dtype: str, d: int):
    """The instantiation that ran flash kernel `name` at head dim d, with its
    registers and spill bytes (stores + loads) from the build's ptxas report:
    the narrowest built width that holds d. Empty without a report."""
    base, flag = _INSTANTIATIONS[(name, dtype)]

    def width(row):
        return int(row["kernel"][len(base) + 1:].split(",")[0].rstrip(">"))

    built = [r for r in report if r["kernel"].startswith(base + "<")
             and (flag is None or r["kernel"].endswith(f", {flag}>")) and width(r) >= -(-d // 8) * 8]
    if not built:
        return {}
    row = min(built, key=width)
    return {"instantiation": row["kernel"], "registers": row.get("registers"),
            "spill_bytes": row.get("spill_stores", 0) + row.get("spill_loads", 0)}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `iters` launches, CUDA events.
    The launches are queued behind a spin kernel, so the card runs them back
    to back and a kernel shorter than its wrapper's host cost (40-50 us a
    call) is timed, not the host's launch rate. Where the host took longer
    to queue them than the spin lasted, the run is repeated behind a spin of
    twice that."""
    import torch

    for _ in range(warmup):
        fn()
    spin_s = 0.02
    for _ in range(3):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if host_s < spin_s:
            break
        spin_s = 2 * host_s
    return start.elapsed_time(end) / iters


def bound(flops: float, sfu: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops = max(flops / peak_flops, sfu / PEAK_SFU_OPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def unet_flash_calls(cfg, unet_batch: int, backend: str = "auto"):
    """(B, N, H, D) of every flash call of one UNet forward, in order: each
    transformer's self-attention and its two cross-modal attentions, at the
    levels the "auto" rule takes (N >= 1024), or at every level with the
    backend "flash" (MobiConfig.attn_backend)."""
    calls, size, ds = [], cfg.latent_size, 1
    res = list(cfg.unet_attention_resolutions)
    mc, heads = cfg.unet_channels, cfg.unet_num_heads
    levels = []  # (ds, channels) of each transformer
    for level, mult in enumerate(cfg.unet_channel_mult):
        levels += [(ds, mult * mc)] * (cfg.unet_num_res_blocks if ds in res else 0)
        if level != len(cfg.unet_channel_mult) - 1:
            ds *= 2
    levels.append((ds, cfg.unet_channel_mult[-1] * mc))
    for level, mult in reversed(list(enumerate(cfg.unet_channel_mult))):
        levels += [(ds, mult * mc)] * ((cfg.unet_num_res_blocks + 1) if ds in res else 0)
        if level:
            ds //= 2
    for ds, ch in levels:
        n = (size // ds) ** 2
        if backend == "flash" or n >= 1024:  # the "auto" rule: Nq == Nk >= 1024
            d = ch // heads
            calls += [(unet_batch, n, heads, d), (unet_batch // 2, n, heads, d),
                      (unet_batch // 2, n, heads, d)]
    return calls


def unet_norm_calls(cfg, unet_batch: int):
    """(B, C, H, W) of every fused GroupNorm + SiLU call of one UNet forward."""
    mc, size, nrb = cfg.unet_channels, cfg.latent_size, cfg.unet_num_res_blocks
    mults = list(cfg.unet_channel_mult)
    calls, skips, ch, ds = [], [mc], mc, 1

    def res(cin, cout, ds):
        s = size // ds
        calls.extend([(unet_batch, cin, s, s), (unet_batch, cout, s, s)])

    for level, mult in enumerate(mults):
        for _ in range(nrb):
            res(ch, mult * mc, ds)
            ch = mult * mc
            skips.append(ch)
        if level != len(mults) - 1:
            skips.append(ch)
            ds *= 2
    res(ch, ch, ds)
    res(ch, ch, ds)
    for level, mult in reversed(list(enumerate(mults))):
        for i in range(nrb + 1):
            res(ch + skips.pop(), mc * mult, ds)
            ch = mc * mult
            if level and i == nrb:
                ds //= 2
    calls.append((unet_batch, ch, size, size))
    return calls


def launch_counts(**launched):
    """Every kernel's launch count: 0 but for those named."""
    from mobi_tpu_torch.ops import _build

    return {**dict.fromkeys(_build.launches, 0), **launched}


def check_close(name, out, ref, atol, rtol):
    """(max abs error, max of error / tolerance) of out against ref."""
    import torch

    err = (out.float() - ref.float()).abs()
    ratio = (err / (atol + rtol * ref.float().abs())).max().item()
    if not bool(torch.isfinite(out.float()).all()) or ratio > 1:
        raise AssertionError(f"{name}: kernel disagrees with its plain version, max abs err "
                             f"{err.max().item()}, {ratio} x the tolerance")
    return err.max().item(), ratio


def flash_inputs(g, dev, case, b, nq, nk, h, d, dtype=None):
    """q, k, v for one kernel row: random, or the edge cases' own."""
    import torch

    dtype = dtype or torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    if case == "extreme_logits":  # tests/test_flash_attention.py:30-39
        q = torch.full((b, nq, h, d), 8.0, device=dev, dtype=dtype)
        return q, randn(b, nk, h, d, scale=8.0), randn(b, nk, h, d)
    if case == "strided_views":  # q, k, v of one fused [B, N, 3, H, D] projection
        return randn(b, nq, 3, h, d).unbind(2)
    return randn(b, nq, h, d), randn(b, nk, h, d), randn(b, nk, h, d)


def flash_rows(name, fn, cases, g, dev, dtype=None, fp32=False, other=None):
    """Rows of a flash forward kernel `fn` against `attention_plain`, with
    times and bound at the main-path shapes. fp32: atol F32_ATOL, the bound
    at 3x the flops at the TF32 rate, and the TF32 control. `other`: a second kernel whose difference from this
    one on the same inputs is reported. Returns (every row, the main-path
    rows by (B, N, H, D))."""
    import torch
    import torch.nn.functional as F

    from mobi_tpu_torch.ops import flash_attention as fa

    rows, per_shape = [], {}
    for (b, nq, nk, h, d), case in cases.items():
        q, k, v = flash_inputs(g, dev, case, b, nq, nk, h, d, dtype)
        out = fn(q, k, v)
        torch.cuda.synchronize()
        ref = fa.attention_plain(q, k, v)
        atol, rtol = (F32_ATOL, 0.0) if fp32 else (K1_ATOL_STD * ref.float().std().item(), K1_RTOL)
        err, ratio = check_close(f"{name} {case} {(b, nq, nk, h, d)}", out, ref, atol, rtol)
        row = {"phase": "kernel", "name": name, "dtype": str(q.dtype).replace("torch.", ""),
               "shape_b_nq_nk_h_d": [b, nq, nk, h, d], "case": case, "max_abs_err": err,
               "atol": atol, "rtol": rtol, "err_over_tol": ratio}
        if fp32 and case == "main_path":
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                ctl = fa.attention_plain(q, k, v)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            row["tf32_control_max_abs_err"] = float((ctl - ref).abs().max())
            del ctl
            if row["tf32_control_max_abs_err"] <= atol:
                raise AssertionError(f"{name} {case}: the plain version in TF32 passes the fp32 "
                                     f"tolerance {atol}, so the check cannot tell fp32 from TF32")
        if other is not None:
            row["max_abs_diff_vs_" + other.__name__] = float((out.float() - other(q, k, v).float()).abs().max())
        if case in TIMED_CASES:
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            flops = 4 * b * h * nq * nk * d
            row["ms"] = cuda_ms(lambda: fn(q, k, v), 20)
            row["plain_ms"] = cuda_ms(lambda: fa.attention_plain(q, k, v), 3, warmup=1)
            row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
            row["bound_ms"], row["bound_by"] = bound(
                3 * flops if fp32 else flops, b * h * nq * nk, q.element_size() * 4 * b * nq * h * d,
                peak_flops=PEAK_TF32_FLOPS if fp32 else PEAK_BF16_FLOPS)
            row["tflops"] = flops / row["ms"] / 1e9
            if case == "main_path":
                per_shape[(b, nq, h, d)] = row
            del qt, kt, vt
        emit(row)
        rows.append(row)
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return rows, per_shape


def head_dim_rows(rows):
    """The timed rows off the main path's head dims, as the kernels line
    lists them."""
    keys = ("dtype", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err", "err_over_tol")
    return [{"shape_b_nq_nk_h_d": r["shape_b_nq_nk_h_d"], **{k: r[k] for k in keys if k in r},
             "bound_share": r["bound_ms"] / r["ms"]}
            for r in rows if r["case"] == "head_dim"]


def kernel_entry(name, source, replaces, rows, per_shape, calls, per):
    """The kernels-line entry of one kernel: worst error over `rows`, times
    summed over the main path's `calls` (shapes keyed as in per_shape)."""
    kern = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "per": per,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "err_over_tol": max(r["err_over_tol"] for r in rows), "head_dims": head_dim_rows(rows)}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        kern[key] = sum(per_shape[c][key] for c in calls)
    kern["bound_by"] = max(per_shape.values(), key=lambda r: r["bound_ms"])["bound_by"]
    return kern


def phase_kernels(cfg, unet_batch: int):
    """K1 and K2 (flash forward, and with the transposed accumulator) and K6
    (fused GroupNorm + SiLU) against their plain versions at the flagship's
    shapes and at edge cases, in bf16; then K1, K2 and K6 in fp32 at the
    flagship's largest shapes."""
    import torch
    import torch.nn.functional as F

    from mobi_tpu_torch.ops import flash_attention as fa
    from mobi_tpu_torch.ops import fused_norm as fn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    flash_calls = unet_flash_calls(cfg, unet_batch)
    # nq_ne_nk cuts the third 128-key tile, short_keys has fewer keys than one
    edges = {(1, 256, 256, 2, 40): "extreme_logits", (2, 1000, 1000, 8, 40): "ragged_n",
             (2, 1024, 300, 8, 40): "nq_ne_nk", (2, 1024, 1024, 8, 40): "strided_views",
             (2, 1024, 100, 8, 40): "short_keys"}

    def main_cases(calls):
        return {(b, n, n, h, d): "main_path" for b, n, h, d in sorted(set(calls), key=calls.index)}

    head_dims = {(b, n, n, h, d): "head_dim" for b, n, h, d in HEAD_DIM_SHAPES}
    rows, per_shape = flash_rows("flash_fwd", fa.flash_fwd, {**main_cases(flash_calls), **edges, **head_dims},
                                 g, dev)
    k1 = kernel_entry("flash_fwd", "mobi_tpu_torch/csrc/flash_fwd_sm90.cu",
                      "mobi_tpu/ops/flash_attention.py:106", rows, per_shape,
                      flash_calls, f"one UNet forward at batch {unet_batch} ({len(flash_calls)} launches)")

    # ---- K2 at the d < 64 calls of the forward (the switch's path) + edges
    tav_calls = [c for c in flash_calls if c[3] < fa.TAV_MAX_HEAD_DIM]
    tav_head_dims = {(b, n, n, h, d): "head_dim" for b, n, h, d in TAV_HEAD_DIM_SHAPES}
    rows, per_shape = flash_rows("flash_fwd_tav", fa.flash_fwd_tav,
                                 {**main_cases(tav_calls), **edges, **tav_head_dims}, g, dev, other=fa.flash_fwd)
    k2 = kernel_entry("flash_fwd_tav", "mobi_tpu_torch/csrc/flash_fwd_sm90.cu",
                      "mobi_tpu/ops/flash_attention.py:56", rows, per_shape,
                      tav_calls, f"one UNet forward at batch {unet_batch} with the K2 switch on "
                                 f"({len(tav_calls)} launches; K1 takes the d = 80 calls)")
    k2["max_abs_diff_vs_flash_fwd"] = max(r["max_abs_diff_vs_flash_fwd"] for r in rows)
    k2["plain"] = "attention_plain (K1's plain version)"

    # ---- K6: fused GroupNorm + SiLU at every ResBlock norm of the UNet
    norm_calls = unet_norm_calls(cfg, unet_batch)

    def gn_row(b, c, hh, ww, dtype, atol, rtol, case="main_path"):
        x = (torch.randn(b, c, hh, ww, generator=g, device=dev) * 2.0).to(dtype) + 0.5
        w = (torch.rand(c, generator=g, device=dev) + 0.5)
        bias = torch.randn(c, generator=g, device=dev)
        groups = min(32, c)
        out = fn.fused_groupnorm_silu(x, w, bias, groups, 1e-5)
        torch.cuda.synchronize()
        ref = fn.groupnorm_silu_plain(x, w, bias, groups, 1e-5)
        err, ratio = check_close(f"gn_silu {(b, c, hh, ww)} {dtype}", out, ref, atol, rtol)
        plan = fn.gn_plan(b, c, groups, hh * ww, x.element_size())
        # the first port's design (one block a span, two reads), now the
        # streaming variant: timed here beside the plan's, not a kernels-line number
        first = fn.GnPlan("stream", 1, c // groups * hh * ww, fn.GN_STREAM_THREADS)
        row = {"phase": "kernel", "name": "gn_silu", "dtype": str(dtype).replace("torch.", ""),
               "shape_bchw": [b, c, hh, ww], "case": case, "plan": list(dataclasses.astuple(plan)),
               "max_abs_err": err, "atol": atol, "rtol": rtol, "err_over_tol": ratio,
               "ms": cuda_ms(lambda: fn.fused_groupnorm_silu(x, w, bias, groups, 1e-5), 50),
               "first_design_ms": cuda_ms(lambda: fn._gn_silu_cuda(x, w, bias, groups, 1e-5, first), 50),
               # moving the same bytes with no arithmetic: the practical floor under the bound
               "copy_ms": cuda_ms(lambda: out.copy_(x), 50),
               "plain_ms": cuda_ms(lambda: fn.groupnorm_silu_plain(x, w, bias, groups, 1e-5), 10),
               "library_ms": cuda_ms(
                   lambda: F.silu(F.group_norm(x, groups, w.to(x.dtype), bias.to(x.dtype), 1e-5)), 50)}
        row["bound_ms"], row["bound_by"] = bound(0, 0, 2 * x.element_size() * x.numel())
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["gbps"] = 2 * x.element_size() * x.numel() / row["ms"] / 1e6
        emit(row)
        return row

    per_shape = {s: gn_row(*s, torch.bfloat16, K6_ATOL, K6_RTOL)
                 for s in sorted(set(norm_calls), key=norm_calls.index)}
    spans = [gn_row(*s, torch.bfloat16, K6_ATOL, K6_RTOL, "span") for s in GN_SPAN_SHAPES]
    k6 = kernel_entry("gn_silu", "mobi_tpu_torch/csrc/gn_silu.cu", "mobi_tpu/ops/fused_norm.py:45",
                      list(per_shape.values()) + spans, per_shape, norm_calls,
                      f"one UNet forward at batch {unet_batch} ({len(norm_calls)} launches)")
    k6["spans"] = [{k: r[k] for k in ("dtype", "shape_bchw", "plan", "ms", "plain_ms", "library_ms", "bound_ms",
                                      "max_abs_err", "err_over_tol")} for r in spans]
    emit({"phase": "gn_silu_per_forward", "per": k6["per"], "ms": k6["ms"], "bound_ms": k6["bound_ms"],
          "bound_share": k6["bound_ms"] / k6["ms"],
          "first_design_ms": sum(per_shape[c]["first_design_ms"] for c in norm_calls),
          "copy_ms": sum(per_shape[c]["copy_ms"] for c in norm_calls),
          "slower_than_first_design": [list(s) for s, r in per_shape.items() if r["ms"] > r["first_design_ms"]]})

    # ---- fp32: K1 at batch 8 of both levels, K2 at d = 40, K6 at the widest
    # norm; and each at the head dims and span off the main path
    f32_cases = {(b, n, n, h, d): "main_path" for b, n, h, d in sorted(set(flash_calls))
                 if b == unet_batch}
    fp32 = {"flash_fwd": flash_rows("flash_fwd", fa.flash_fwd, {**f32_cases, **head_dims}, g, dev,
                                    torch.float32, fp32=True)[0],
            "flash_fwd_tav": flash_rows("flash_fwd_tav", fa.flash_fwd_tav,
                                        {**{c: v for c, v in f32_cases.items() if c[4] < fa.TAV_MAX_HEAD_DIM},
                                         **tav_head_dims}, g, dev, torch.float32, fp32=True)[0]}
    widest = max(set(norm_calls), key=lambda s: s[0] * s[1] * s[2] * s[3])
    fp32["gn_silu"] = [gn_row(*widest, torch.float32, K6_F32_ATOL, K6_F32_RTOL)] + [
        gn_row(*s, torch.float32, K6_F32_ATOL, K6_F32_RTOL, "span") for s in GN_SPAN_SHAPES]
    sources = {"flash_fwd": "mobi_tpu_torch/csrc/flash_fwd.cu",
               "flash_fwd_tav": "mobi_tpu_torch/csrc/flash_fwd_tav.cu",
               "gn_silu": "mobi_tpu_torch/csrc/gn_silu.cu"}
    for kern in (k1, k2, k6):
        kern["fp32"] = [{"source": sources[kern["name"]],
                         **{k: v for k, v in r.items() if k not in ("phase", "name")}}
                        for r in fp32[kern["name"]]]
    k1["host_us_per_call"] = host_cost(g, dev)
    torch.cuda.empty_cache()
    return k1, k2, k6


def host_cost(g, dev, calls: int = 2000):
    """Host microseconds per K1 call on a tiny shape, where the card keeps
    up and the time is the wrapper's: bf16 (the TMA kernel: three tensor
    maps encoded per call) against fp32 (the mma.sync kernel: none)."""
    import torch

    from mobi_tpu_torch.ops import flash_attention as fa

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(1, 128, 1, 40, generator=g, device=dev).to(dtype)
        for _ in range(10):
            fa.flash_fwd(q, q, q)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fa.flash_fwd(q, q, q)
        out[str(dtype).replace("torch.", "")] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    emit({"phase": "host_overhead", "k1_host_us_per_call": out,
          "bf16_minus_fp32_us": out["bfloat16"] - out["float32"]})
    return out


def train_flash_calls(cfg, unet_batch: int, backend: str = "auto"):
    """(B, N, H, D) of the flash calls of one adapter-only training forward
    that carry a gradient: every call but the first, input_blocks.1's attn1,
    whose q, k and v come from frozen layers and a latent input only (every
    later call sees an adapter's output). That one runs K1."""
    return unet_flash_calls(cfg, unet_batch, backend)[1:]


def phase_train_kernels(cfg, unet_batch: int):
    """K3, K4 and K5 against their plain versions at every flash shape of
    the training step and at edge cases; times at the training shapes."""
    import torch
    import torch.nn.functional as F

    from mobi_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    calls = train_flash_calls(cfg, unet_batch)
    cases = {(b, n, n, h, d): "main_path" for b, n, h, d in sorted(set(calls), key=calls.index)}
    # ragged_both: neither N divides any tile; single_key: less than one tile
    cases.update({(1, 256, 256, 2, 40): "extreme_logits", (2, 1000, 1000, 8, 40): "ragged_n",
                  (2, 1024, 300, 8, 80): "nq_ne_nk", (2, 1024, 1024, 8, 40): "strided_views",
                  (2, 130, 77, 4, 80): "ragged_both", (1, 64, 1, 2, 40): "single_key",
                  **{(b, n, n, h, d): "head_dim" for b, n, h, d in HEAD_DIM_SHAPES}})
    rows = {"flash_fwd_lse": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for (b, nq, nk, h, d), case in cases.items():
        if case == "extreme_logits":  # tests/test_flash_attention.py:184-201
            q = torch.full((b, nq, h, d), 8.0, device=dev, dtype=torch.bfloat16)
            k, v = randn(b, nk, h, d, scale=8.0), randn(b, nk, h, d)
        elif case == "strided_views":  # q, k, v of one fused [B, N, 3, H, D] projection
            q, k, v = randn(b, nq, 3, h, d).unbind(2)
        else:
            q, k, v = randn(b, nq, h, d), randn(b, nk, h, d), randn(b, nk, h, d)
        # dO as a [B, H, N, D] tensor seen as [B, N, H, D] in the strided case
        do = randn(b, h, nq, d).transpose(1, 2) if case == "strided_views" else randn(b, nq, h, d)
        o, lse = fa.flash_fwd_lse(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.attention_lse_plain(q, k, v)
        err_o, ratio_o = check_close(f"flash_fwd_lse o {case}", o, ref_o,
                                     K1_ATOL_STD * ref_o.float().std().item(), K1_RTOL)
        err_l, ratio_l = check_close(f"flash_fwd_lse lse {case}", lse, ref_lse, LSE_ATOL, LSE_RTOL)
        # the backward kernels take the plain forward's o and lse, so each
        # is held against its own plain version alone
        delta = fa.flash_bwd_delta(ref_o, do)
        args = (q, k, v, do, ref_lse, delta)
        dq = fa.flash_bwd_dq(*args)
        dk, dv = fa.flash_bwd_dkv(*args)
        again = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)):
            raise AssertionError(f"flash_bwd {case} {(b, nq, nk, h, d)}: a second run differs")
        del again

        scale = max(1.0, *(t.float().pow(2).mean().sqrt().item() for t in (q, k)))

        def check_bwd(name, out, ref):
            atol = BWD_ATOL_STD * ref.float().std().item() + BWD_ATOL_MIN * scale
            return check_close(f"{name} {case}", out, ref, atol, BWD_RTOL)

        err_q, ratio_q = check_bwd("flash_bwd_dq", dq, fa.flash_bwd_dq_plain(*args))
        (err_k, ratio_k), (err_v, ratio_v) = (
            check_bwd(f"flash_bwd_dkv {n}", out, ref)
            for n, out, ref in zip("kv", (dk, dv), fa.flash_bwd_dkv_plain(*args)))
        base = {"phase": "kernel", "dtype": "bfloat16", "shape_b_nq_nk_h_d": [b, nq, nk, h, d], "case": case}
        new = {"flash_fwd_lse": dict(base, name="flash_fwd_lse", max_abs_err=max(err_o, err_l),
                                     max_abs_err_o=err_o, max_abs_err_lse=err_l,
                                     err_over_tol=max(ratio_o, ratio_l)),
               "flash_bwd_dq": dict(base, name="flash_bwd_dq", max_abs_err=err_q, err_over_tol=ratio_q),
               "flash_bwd_dkv": dict(base, name="flash_bwd_dkv", max_abs_err=max(err_k, err_v),
                                     err_over_tol=max(ratio_k, ratio_v))}
        if case in TIMED_CASES:
            n2, bh = nq * nk, b * h
            qkv_bytes = 2 * (b * nq * h * d + 2 * b * nk * h * d)
            stat_bytes = 4 * bh * nq
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(qt, kt, vt)
            dot = do.transpose(1, 2).contiguous()
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True), 20)
            r = new["flash_fwd_lse"]
            r["ms"] = cuda_ms(lambda: fa.flash_fwd_lse(q, k, v), 20)
            r["plain_ms"] = cuda_ms(lambda: fa.attention_lse_plain(q, k, v), 3, warmup=1)
            with torch.no_grad():
                r["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
            r["bound_ms"], r["bound_by"] = bound(4 * bh * n2 * d, bh * n2,
                                                 qkv_bytes + 2 * b * nq * h * d + stat_bytes)
            r = new["flash_bwd_dq"]
            r["ms"] = cuda_ms(lambda: fa.flash_bwd_dq(*args), 20)
            r["plain_ms"] = cuda_ms(lambda: fa.flash_bwd_dq_plain(*args), 3, warmup=1)
            r["bound_ms"], r["bound_by"] = bound(6 * bh * n2 * d, bh * n2,
                                                 qkv_bytes + 4 * b * nq * h * d + 2 * stat_bytes)
            r = new["flash_bwd_dkv"]
            r["ms"] = cuda_ms(lambda: fa.flash_bwd_dkv(*args), 20)
            r["plain_ms"] = cuda_ms(lambda: fa.flash_bwd_dkv_plain(*args), 3, warmup=1)
            r["bound_ms"], r["bound_by"] = bound(8 * bh * n2 * d, bh * n2,
                                                 qkv_bytes + 2 * b * nq * h * d + 2 * stat_bytes
                                                 + 4 * b * nk * h * d)
            # one SDPA backward computes dq, dk and dv together: the
            # yardstick of K4 + K5, given on both rows
            new["flash_bwd_dq"]["library_ms"] = new["flash_bwd_dkv"]["library_ms"] = lib_bwd
            for name in MMA_SYNC_BWD_MS:
                new[name]["was_ms"] = MMA_SYNC_BWD_MS[name].get((b, nq, h, d))
            del qt, kt, vt, sdpa
        for name, row in new.items():
            rows[name][(b, nq, nk, h, d, case)] = row
            emit(row)
        del q, k, v, do, o, lse, ref_o, ref_lse, delta, args, dq, dk, dv
        torch.cuda.empty_cache()

    per = f"one training step at UNet batch {unet_batch} ({len(calls)} launches)"
    meta = {"flash_fwd_lse": ("mobi_tpu_torch/csrc/flash_fwd_sm90.cu", "mobi_tpu/ops/flash_attention.py:228"),
            "flash_bwd_dq": ("mobi_tpu_torch/csrc/flash_bwd_sm90.cu", "mobi_tpu/ops/flash_attention.py:303"),
            "flash_bwd_dkv": ("mobi_tpu_torch/csrc/flash_bwd_sm90.cu", "mobi_tpu/ops/flash_attention.py:335")}
    out = []
    for name, by_case in rows.items():
        main = {(b, nq, h, d): r for (b, nq, _, h, d, case), r in by_case.items()
                if case == "main_path"}
        kern = {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
                "per": per, "max_abs_err": max(r["max_abs_err"] for r in by_case.values()),
                "err_over_tol": max(r["err_over_tol"] for r in by_case.values()),
                "head_dims": head_dim_rows(by_case.values())}
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            kern[key] = sum(main[(bb, n, hh, dd)][key] for bb, n, hh, dd in calls)
        kern["bound_by"] = max(main.values(), key=lambda r: r["bound_ms"])["bound_by"]
        out.append(kern)
    emit({"phase": "train_kernels_per_step", "per": per,
          **{k["name"]: {key: k[key] for key in ("ms", "bound_ms", "library_ms")} for k in out},
          "was_ms_not_measured_here": {
              "flash_fwd_lse": MMA_SYNC_K3_MS_PER_STEP,
              **{name: sum(ms[c] for c in calls) for name, ms in MMA_SYNC_BWD_MS.items()}}})
    return out


def phase_train_kernels_fp32(cfg, unet_batch: int):
    """K3, K4 and K5 in fp32 (3xTF32) against their fp32 plain versions
    (TF32 off) at the flash shapes of the training step, each with the plain
    version in TF32 as a control that must fail the tolerance; times, and the
    bound at 3x the flops at the TF32 rate. Returns the rows by kernel."""
    import torch
    import torch.nn.functional as F

    from mobi_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def tf32(fn, *args):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def check(name, out, ref, ctl, atol):
        err, ratio = check_close(name, out, ref, atol, 0.0)
        ctl_err = float((ctl.float() - ref.float()).abs().max())
        if ctl_err <= atol:
            raise AssertionError(f"{name}: the plain version in TF32 passes the fp32 tolerance {atol}, "
                                 "so the check cannot tell fp32 from TF32")
        return {"max_abs_err": err, "atol": atol, "err_over_tol": ratio, "tf32_control_max_abs_err": ctl_err}

    calls = train_flash_calls(cfg, unet_batch)
    rows = {"flash_fwd_lse": [], "flash_bwd_dq": [], "flash_bwd_dkv": []}
    cases = {**{c: "main_path" for c in sorted(set(calls), key=calls.index)},
             **{c: "head_dim" for c in HEAD_DIM_SHAPES}}
    for (b, n, h, d), case in cases.items():
        q, k, v, do = (torch.randn(b, n, h, d, generator=g, device=dev) for _ in range(4))
        scale = max(1.0, *(t.pow(2).mean().sqrt().item() for t in (q, k)))
        o, lse = fa.flash_fwd_lse(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.attention_lse_plain(q, k, v)
        ctl_o = tf32(fa.attention_lse_plain, q, k, v)[0]
        row_o = check(f"flash_fwd_lse fp32 o {(b, n, h, d)}", o, ref_o, ctl_o,
                      F32_ATOL_STD * ref_o.std().item() + F32_ATOL_MIN)
        err_l, ratio_l = check_close(f"flash_fwd_lse fp32 lse {(b, n, h, d)}", lse, ref_lse, LSE_F32_ATOL, 0.0)
        delta = fa.flash_bwd_delta(ref_o, do)
        args = (q, k, v, do, ref_lse, delta)
        got = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
        torch.cuda.synchronize()
        ref = fa.flash_bwd_plain(q, k, v, ref_o, ref_lse, do)
        ctl = tf32(fa.flash_bwd_plain, q, k, v, ref_o, ref_lse, do)
        grad = {nm: check(f"{nm} fp32 {(b, n, h, d)}", a, r, c,
                          F32_ATOL_STD * r.std().item() + F32_ATOL_MIN * scale)
                for nm, a, r, c in zip(("dq", "dk", "dv"), got, ref, ctl)}
        del ref, ctl, ctl_o
        torch.cuda.empty_cache()

        n2, bh = n * n, b * h
        io = 4 * b * n * h * d  # bytes of one [B, N, H, D] fp32 tensor
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2).contiguous()
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), dot, retain_graph=True), 5)
        with torch.no_grad():
            lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 5)
        del qt, kt, vt, sdpa, dot
        base = {"phase": "kernel", "dtype": "float32", "shape_b_nq_nk_h_d": [b, n, n, h, d],
                "case": case}
        r3 = dict(base, name="flash_fwd_lse", **row_o, max_abs_err_lse=err_l, lse_atol=LSE_F32_ATOL,
                  ms=cuda_ms(lambda: fa.flash_fwd_lse(q, k, v), 5),
                  plain_ms=cuda_ms(lambda: fa.attention_lse_plain(q, k, v), 2, warmup=1), library_ms=lib_fwd)
        r3["err_over_tol"] = max(r3["err_over_tol"], ratio_l)
        r3["bound_ms"], r3["bound_by"] = bound(3 * 4 * bh * n2 * d, bh * n2, 4 * io + 4 * bh * n,
                                               peak_flops=PEAK_TF32_FLOPS)
        r4 = dict(base, name="flash_bwd_dq", **grad["dq"], ms=cuda_ms(lambda: fa.flash_bwd_dq(*args), 5),
                  plain_ms=cuda_ms(lambda: fa.flash_bwd_dq_plain(*args), 2, warmup=1), library_ms=lib_bwd)
        r4["bound_ms"], r4["bound_by"] = bound(3 * 6 * bh * n2 * d, bh * n2, 5 * io + 8 * bh * n,
                                               peak_flops=PEAK_TF32_FLOPS)
        worst = max((grad["dk"], grad["dv"]), key=lambda r: r["err_over_tol"])
        r5 = dict(base, name="flash_bwd_dkv", **worst, max_abs_err_dk=grad["dk"]["max_abs_err"],
                  max_abs_err_dv=grad["dv"]["max_abs_err"], ms=cuda_ms(lambda: fa.flash_bwd_dkv(*args), 5),
                  plain_ms=cuda_ms(lambda: fa.flash_bwd_dkv_plain(*args), 2, warmup=1), library_ms=lib_bwd)
        r5["bound_ms"], r5["bound_by"] = bound(3 * 8 * bh * n2 * d, bh * n2, 6 * io + 8 * bh * n,
                                               peak_flops=PEAK_TF32_FLOPS)
        for r in (r3, r4, r5):
            emit(r)
            rows[r["name"]].append({"source": ("mobi_tpu_torch/csrc/flash_fwd.cu" if r is r3 else
                                               "mobi_tpu_torch/csrc/flash_bwd.cu"),
                                    **{key: val for key, val in r.items()
                                       if key not in ("phase", "name")}})
        del q, k, v, do, o, lse, ref_o, ref_lse, delta, args, got
        torch.cuda.empty_cache()
    return rows


def make_batch(pairs: int):
    """Seeded inputs in the NuScenes batch schema (NHWC), as bench.py's."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    f32 = np.float32

    def u(*shape):
        return rng.uniform(-1, 1, shape).astype(f32)

    return {
        "image": {
            "GT": u(pairs, 512, 512, 3),
            "inpaint_image": u(pairs, 512, 512, 3),
            "inpaint_mask": np.ones((pairs, 512, 512, 1), f32),
            "cond": {"ref_image": u(pairs, 224, 224, 3),
                     "ref_bbox": rng.uniform(0, 1, (pairs, 8, 3)).astype(f32)},
        },
        "lidar": {
            "range_data": u(pairs, 512, 512, 2),
            "range_data_inpaint": u(pairs, 512, 512, 2),
            "range_mask": np.ones((pairs, 512, 512, 1), f32),
            "cond": {"ref_bbox": rng.uniform(0, 1, (pairs, 8, 3)).astype(f32)},
        },
    }


def phase_flagship(model, smi: str):
    """The main path, counted: one batch with the defaults (flash attention,
    GroupNorm then SiLU), timed batches, and one batch with the fused
    GroupNorm + SiLU switch on (the path of the gn_silu kernel)."""
    import torch

    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline

    pipeline = make_inpaint_pipeline(model, num_steps=STEPS, guidance_scale=GUIDANCE, sampler="ddim")
    batch = make_batch(PAIRS)
    gen = torch.Generator(device=model.device)
    per_forward = {"flash_fwd": len(unet_flash_calls(model.config, 4 * PAIRS)),
                   "gn_silu": len(unet_norm_calls(model.config, 4 * PAIRS))}

    def counted(fused: bool):
        model.unet.set_fused_gn(fused)
        gen.manual_seed(SEED)
        _build.reset_launches()
        out = pipeline(batch, gen)
        torch.cuda.synchronize()
        counts = dict(_build.launches)
        model.unet.set_fused_gn(False)
        want = launch_counts(flash_fwd=STEPS * per_forward["flash_fwd"],
                             gn_silu=STEPS * per_forward["gn_silu"] if fused else 0)
        if counts != want:
            raise AssertionError(f"flagship (fused_gn={fused}) launches {counts}, expected {want}")
        for name, shape in (("camera", (PAIRS, 512, 512, 3)), ("lidar", (PAIRS, 512, 512, 2))):
            t = out[name]
            if tuple(t.shape) != shape or not bool(torch.isfinite(t.float()).all()):
                raise AssertionError(f"flagship {name}: shape {tuple(t.shape)} (want {shape}) or non-finite")
        return out, counts

    torch.cuda.reset_peak_memory_stats()  # the kernel phase's plain attention peaks higher
    out, counts = counted(False)
    stats = {name: [float(out[name].float().mean()), float(out[name].float().std())] for name in out}
    walls = []
    for i in range(TIMED_BATCHES):
        gen.manual_seed(SEED + 1 + i)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        pipeline(batch, gen)
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end) / 1e3)
    med = statistics.median(walls)
    emit({"phase": "flagship", "pairs": PAIRS, "steps": STEPS, "guidance": GUIDANCE,
          "launches": counts, "output_mean_std": stats, "batch_s": walls,
          "median_batch_s": med, "inpaints_per_hour": PAIRS / med * 3600.0,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "card": smi})

    phase_profile(model, batch, gen, med)
    out_fused, counts_fused = counted(True)
    diff = {name: float((out_fused[name].float() - out[name].float()).abs().max())
            for name in out}
    emit({"phase": "flagship_fused_gn", "launches": counts_fused,
          "max_abs_diff_vs_default": diff})
    return counts, counts_fused


KERNEL_CLASSES = (  # (class, substrings of the CUDA kernel name), first match wins
    # fp32 K3; bf16 K3 is K1's sm90 kernel with its lse output, so in bf16
    # the flash_fwd class holds both
    ("flash_fwd_lse", tuple(f"flash_fwd_kernel<{dk}, {dv}, true"
                            for dk, dv in ((48, 48), (64, 64), (80, 80), (128, 128), (160, 80), (192, 64),
                                           (256, 64)))),
    ("flash_fwd_tav", ("flash_fwd_tav_kernel", "flash_fwd_sm90_kernel<48, 48, true",
                       "flash_fwd_sm90_kernel<64, 64, true")),
    ("flash_fwd", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel")),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel")),
    ("gn_silu", ("gn_silu_",)),
    ("conv", ("conv", "cudnn", "implicit", "xmma", "fprop", "dgrad", "nchwToNhwc", "nhwcToNchw")),
    ("matmul", ("gemm", "cutlass", "nvjet", "cublas", "sm90_", "splitK")),
    ("softmax", ("softmax",)),
    ("norm_reduce", ("norm", "reduce", "welford", "Reduce")),
    ("copy_cat_permute", ("copy", "cat", "Cat", "transpose", "permute", "index", "upsample")),
    ("elementwise", ("elementwise", "vectorized", "Elementwise", "unrolled")),
)


def profile_classes(fn):
    """Device seconds by kernel class of fn(), and its top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    classes, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in e.key for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + us / 1e6
        top.append((us / 1e6, e.count, e.key[:90]))
    return classes, sorted(top, reverse=True)


def phase_profile(model, batch, gen, median_batch_s: float):
    """Device time by kernel class of the flagship batch, from two short
    batches under torch.profiler (CUDA activity only): the difference of a
    2-step and a 4-step batch gives each class's time per DDIM step, the
    rest its time outside the steps (encodes, decodes); the flagship's is
    that plus STEPS steps. Also the busy share of the unprofiled median
    wall."""
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline

    (a, b), runs = PROFILE_STEPS, {}
    for steps in PROFILE_STEPS:
        short = make_inpaint_pipeline(model, num_steps=steps, guidance_scale=GUIDANCE, sampler="ddim")
        gen.manual_seed(SEED)
        runs[steps] = profile_classes(lambda: short(batch, gen))
    ca, cb = runs[a][0], runs[b][0]
    est, per_step, fixed = {}, {}, {}
    for cls in set(ca) | set(cb):
        per_step[cls] = (cb.get(cls, 0.0) - ca.get(cls, 0.0)) / (b - a)
        fixed[cls] = ca.get(cls, 0.0) - a * per_step[cls]
        est[cls] = fixed[cls] + STEPS * per_step[cls]
    busy = sum(est.values())
    emit({"phase": "profile", "profiled_steps": list(PROFILE_STEPS),
          "device_busy_s_est": busy if busy else None,
          "busy_share_of_median_wall": busy / median_batch_s if busy else None,
          "device_s_by_class_est": dict(sorted(est.items(), key=lambda kv: -kv[1])),
          "device_s_per_step": dict(sorted(per_step.items(), key=lambda kv: -kv[1])),
          "device_s_outside_steps": dict(sorted(fixed.items(), key=lambda kv: -kv[1])),
          f"top_kernels_s_count_{b}_steps": runs[b][1][:12]})


def attention_targets(unet, backend: str):
    """The UNet attentions a variant's backend is set on: "flash", as
    MobiConfig.attn_backend does, the backend-routed ones (each transformer's
    self-attention and its cross-modal attentions; the CLIP and bbox
    attentions keep "auto"); "auto" and "xla" every one."""
    from mobi_tpu_torch.models.unet import CrossAttention

    return [m for name, m in unet.named_modules() if isinstance(m, CrossAttention)
            and (backend != "flash" or name.endswith("attn1") or "cross_modal_attn" in name)]


def unet_switches(model, b: int, tol: float, variants, phase: str):
    """One full-width UNet forward at batch b with each variant (label,
    fused GroupNorm + SiLU, attention backend, K2 switch) against the same
    forward through the plain versions (GroupNorm then SiLU, the plain
    attention formula): relative L2 of eps within `tol`, and the launches
    each variant must make. The backend "flash" sends every routed call to
    the kernels, the d = 160 calls of the 16x16 and 8x8 levels included."""
    import torch

    from mobi_tpu_torch.models.unet import CrossAttention
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.ops import flash_attention as fa

    cfg, unet = model.config, model.unet
    s = cfg.latent_size
    g = torch.Generator(device=model.device).manual_seed(SEED + 100)
    x9 = torch.randn(b, 9, s, s, generator=g, device=model.device)
    t = torch.randint(0, cfg.timesteps, (b,), generator=g, device=model.device)
    ctx = torch.randn(b, len(cfg.cond_stage_key), cfg.context_dim, generator=g, device=model.device)
    attns = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    saved = [m.attn_backend for m in attns]

    def forward(fused: bool, backend: str, tav: bool):
        unet.set_fused_gn(fused)
        fa.set_transposed_av(tav)
        for m in attention_targets(unet, backend):
            m.attn_backend = backend
        _build.reset_launches()
        try:
            with torch.inference_mode():
                eps = unet(x9, t, ctx)
            torch.cuda.synchronize()
        finally:
            unet.set_fused_gn(False)
            fa.set_transposed_av(False)
            for m, was in zip(attns, saved):
                m.attn_backend = was
        return eps, dict(_build.launches)

    ref, n_ref = forward(False, "xla", False)
    if n_ref != launch_counts():
        raise AssertionError(f"{phase}: the plain forward launched {n_ref}")
    results = {"plain": {}}
    for label, fused, backend, tav in variants:
        eps, n = forward(fused, backend, tav)
        rel = float((eps.float() - ref.float()).norm() / ref.float().norm())
        results[label] = {"launches": {k: v for k, v in n.items() if v}, "rel_l2_vs_plain": rel}
        if not bool(torch.isfinite(eps).all()) or rel > tol:
            raise AssertionError(f"{phase} UNet eps {label}: rel L2 {rel} vs the plain versions")
        calls = unet_flash_calls(cfg, b, backend) if backend != "xla" else []
        n_tav = sum(d < fa.TAV_MAX_HEAD_DIM for *_, d in calls) if tav else 0
        want = launch_counts(flash_fwd=len(calls) - n_tav, flash_fwd_tav=n_tav,
                             gn_silu=len(unet_norm_calls(cfg, b)) if fused else 0)
        if n != want:
            raise AssertionError(f"{phase} {label} launches {n}, expected {want}")
    emit({"phase": phase, "dtype": str(cfg.dtype).replace("torch.", ""), "unet_batch": b,
          "tolerance_rel_l2": tol, **results})
    return results


def phase_switches(model):
    """bf16, batch 4 * PAIRS (the CFG-doubled flagship batch): flash
    attention (K1), K2 for the d = 40 calls, the fused norm (K6), both, and
    attn_backend "flash" (K1 at every level, d = 160 included)."""
    return unet_switches(model, 4 * PAIRS, UNET_REL_L2, (
        ("flash", False, "auto", False), ("flash_tav", False, "auto", True),
        ("fused_gn", True, "xla", False), ("both", True, "auto", False),
        ("flash_all", False, "flash", False)), "switches")


def phase_fp32():
    """The default MobiConfig() (fp32) at full width: one UNet forward at
    batch 2 through K1, K2 and K6 in fp32 against the plain versions, then
    the trainable gradients of one training loss at SWITCH_PAIRS pair(s)
    through K1, K3, K4 and K5 in fp32 against the plain path."""
    import torch

    from mobi_tpu_torch import training as T
    from mobi_tpu_torch.models.diffusion import MobiConfig, MobiDiffusion

    # for_training: fp32 everywhere either way; the gradients below need it
    model = MobiDiffusion(MobiConfig(), device="cuda", seed=SEED, for_training=True)
    if model.config.dtype != torch.float32:
        raise AssertionError("MobiConfig() is expected to be fp32")
    unet_switches(model, 2, FP32_UNET_REL_L2, (
        ("flash", False, "auto", False), ("flash_tav", False, "auto", True),
        ("both", True, "auto", False)), "fp32")
    tx = T.make_optimizer(model, schedule=T.lambda_linear_schedule(TRAIN_LR, TRAIN_WARMUP))
    trainable_grads_vs_plain(model, tx, SWITCH_PAIRS, (("kernels", False, "auto", "pallas"),),
                             FP32_GRAD_REL_L2, "fp32_train_grads")
    del model, tx
    torch.cuda.empty_cache()


def request_samples(n: int):
    """n per-request samples (the batch schema without the batch dim) cut
    from make_batch(n)."""
    def pick(tree, i):
        return {k: pick(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    batch = make_batch(n)
    return [pick(batch, i) for i in range(n)]


def check_outputs(name, out, pairs=None):
    """Served (numpy) outputs: camera [512, 512, 3], lidar [512, 512, 2]
    per sample (with a leading `pairs` for a batch), finite."""
    import numpy as np

    for key, ch in (("camera", 3), ("lidar", 2)):
        t = out[key]
        shape = (512, 512, ch) if pairs is None else (pairs, 512, 512, ch)
        if tuple(t.shape) != shape or not np.isfinite(t).all():
            raise AssertionError(f"{name} {key}: shape {tuple(t.shape)} (want {shape}) or non-finite")


def phase_serve(smi: str):
    """The serving path at full width: the service built by the same
    function as `python -m mobi_tpu_torch.serve_http` (MobiConfig in bf16,
    seeded random weights), PLMS-50 CFG-5 at batch_pairs 2. In process: 5
    requests queued before the dispatcher starts make batches [2, 2, 1 + 1
    padded]; counters, launches, per-batch CUDA-event walls, the burst's
    per-request walls, its inpaints/hour and peak memory; the device time of
    one served batch (the service's pipeline and output copy on batch 0's
    inputs, under torch.profiler) and its share of the median batch wall;
    batch 0 and the real
    sample of batch 2 against direct pipeline calls with the generators of
    the service's seeding rule. Then 2 requests over HTTP from 2 threads
    (serve_loadgen's client). Returns (model, direct pipeline, samples,
    batch 0's direct output) for the K2 batch."""
    import threading

    import numpy as np
    import torch

    from mobi_tpu_torch import serve_http, serve_loadgen
    from mobi_tpu_torch.models.diffusion import MobiConfig
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline
    from mobi_tpu_torch.serve import InpaintService, batch_generator, outputs_to_numpy, stack_samples

    cfg = MobiConfig(dtype=torch.bfloat16)
    kw = dict(num_steps=STEPS, guidance_scale=GUIDANCE, sampler="plms")
    t0 = time.perf_counter()
    svc = serve_http.build_service(cfg, seed=SEED, device="cuda", batch_pairs=SERVE_PAIRS,
                                   max_wait_ms=50, autostart=False, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = svc.model
    samples = request_samples(SERVE_REQUESTS)
    walls, pipeline = [], svc.pipeline

    def timed(batch, generator):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = pipeline(batch, generator)
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end) / 1e3)
        return out

    svc.pipeline = timed
    futures = [svc.submit(x) for x in samples]
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    svc.start()
    results = [fut.result(timeout=600) for fut in futures]
    served_s = time.perf_counter() - t0
    svc.stop(timeout=60)
    counts = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = launch_counts(flash_fwd=3 * PLMS_EVALS * len(unet_flash_calls(cfg, 4 * SERVE_PAIRS)))
    if counts != want:
        raise AssertionError(f"served batches launched {counts}, expected {want}")
    want_stats = {"batches": 3, "samples": SERVE_REQUESTS, "padded": 1, "errors": 0, "rejected": 0}
    if svc.stats != want_stats:
        raise AssertionError(f"service counters {svc.stats}, expected {want_stats}")
    for i, out in enumerate(results):
        check_outputs(f"served request {i}", out)

    direct = make_inpaint_pipeline(model, **kw)
    diffs, ref0 = {}, None
    for idx, group, served in ((0, samples[0:2], results[0:2]), (2, [samples[4]] * 2, results[4:5])):
        ref = outputs_to_numpy(direct(stack_samples(group), batch_generator(model.device, SEED, idx)))
        ref0 = ref if idx == 0 else ref0
        for i, out in enumerate(served):
            for k in ref:
                diffs[f"batch{idx}_sample{i}_{k}"] = float(np.abs(out[k] - ref[k][i]).max())
    if any(diffs.values()):
        raise AssertionError(f"served outputs differ from the direct pipeline calls: {diffs}")
    lat = svc.latency_stats()
    gen0 = batch_generator(model.device, SEED, 0)
    classes, top = profile_classes(
        lambda: outputs_to_numpy(pipeline(stack_samples(samples[0:2]), gen0)))
    busy = sum(classes.values())
    med = statistics.median(walls)
    emit({"phase": "serve", "pairs_per_batch": SERVE_PAIRS, "requests": SERVE_REQUESTS,
          "sampler": "plms", "steps": STEPS, "guidance": GUIDANCE, "build_s": build_s,
          "stats": svc.stats, "launches": {k: v for k, v in counts.items() if v},
          "batch_s": walls, "median_batch_s": med, "served_s": served_s,
          "burst_inpaints_per_hour": SERVE_REQUESTS / served_s * 3600.0,
          "full_batch_inpaints_per_hour": SERVE_PAIRS / statistics.median(walls[:2]) * 3600.0,
          **{f"burst_request_{k}": v for k, v in lat.items()},
          "device_busy_s_per_batch": busy, "busy_share_of_median_batch": busy / med,
          "device_s_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
          "top_kernels_s_count": top[:8],
          "max_abs_diff_vs_direct": max(diffs.values()), "peak_mem_gib": peak, "card": smi})

    # ---- over HTTP: 2 requests from 2 threads, coalesced into one batch
    svc = InpaintService(model, batch_pairs=SERVE_PAIRS, max_wait_ms=2000, rng_seed=SEED, **kw)
    server = serve_http.make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(SEED)
    bodies = [serve_loadgen.encode(serve_loadgen.make_sample(rng, 512, 512)) for _ in range(2)]
    answers, errors = [None, None], []

    def client(i):
        try:
            answers[i] = serve_loadgen.post(f"{base}/inpaint", bodies[i], 600)
        except Exception as e:  # reported and raised below
            errors.append(f"{type(e).__name__}: {e}")

    try:
        health = serve_loadgen.get_json(f"{base}/healthz")
        clients = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        http_s = time.perf_counter() - t0
        stats = serve_loadgen.get_json(f"{base}/stats")
    finally:
        server.shutdown()
        server.server_close()
        svc.stop(timeout=60)
        thread.join(timeout=60)
    if errors or health != {"ok": True}:
        raise AssertionError(f"HTTP: errors {errors}, /healthz {health}")
    for i, (_, out) in enumerate(answers):
        check_outputs(f"HTTP response {i}", out)
    if stats["samples"] != 2 or stats["errors"] != 0:
        raise AssertionError(f"HTTP /stats {stats}")
    emit({"phase": "serve_http", "requests": 2, "clients": 2, "wall_s": http_s,
          "request_s": [a[0] for a in answers], "stats": stats})
    return model, direct, samples, ref0


def phase_plms_tav(model, direct, samples, ref0):
    """Served batch 0 again with the K2 switch on: K2 takes the 15 d = 40
    calls of each of the 51 UNet forwards, K1 the 15 d = 80 ones."""
    import numpy as np
    import torch

    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.ops import flash_attention as fa
    from mobi_tpu_torch.serve import batch_generator, outputs_to_numpy, stack_samples

    calls = unet_flash_calls(model.config, 4 * SERVE_PAIRS)
    n_tav = sum(d < fa.TAV_MAX_HEAD_DIM for *_, d in calls)
    fa.set_transposed_av(True)
    _build.reset_launches()
    try:
        out = outputs_to_numpy(direct(stack_samples(samples[0:2]), batch_generator(model.device, SEED, 0)))
        counts = dict(_build.launches)
    finally:
        fa.set_transposed_av(False)
    want = launch_counts(flash_fwd=PLMS_EVALS * (len(calls) - n_tav), flash_fwd_tav=PLMS_EVALS * n_tav)
    if counts != want:
        raise AssertionError(f"PLMS batch with K2 launched {counts}, expected {want}")
    check_outputs("PLMS batch with K2", out, SERVE_PAIRS)
    diff = {k: float(np.abs(out[k] - ref0[k]).max()) for k in out}
    emit({"phase": "plms_tav", "launches": {k: v for k, v in counts.items() if v},
          "max_abs_diff_vs_default_plms": diff})
    torch.cuda.empty_cache()
    return counts


def phase_train(cfg, smi: str):
    """The adapter training step at full width, through the port's entry
    points (training.create_train_state, make_train_step), counted, timed
    and checked: finite losses, grad_norm > 0, every trainable tensor
    changed and every frozen one bitwise unchanged."""
    import torch

    from mobi_tpu_torch import training as T
    from mobi_tpu_torch.models.diffusion import MobiDiffusion
    from mobi_tpu_torch.ops import _build

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = MobiDiffusion(cfg, device="cuda", seed=SEED, for_training=True)
    state, tx = T.create_train_state(model, schedule=T.lambda_linear_schedule(TRAIN_LR, TRAIN_WARMUP))
    train_step = T.make_train_step(model, tx)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = make_batch(TRAIN_PAIRS)
    gen = torch.Generator(device=model.device).manual_seed(SEED + 2)
    mask = model.trainable_mask()
    before = {name: p.detach().clone() for name, p in model.named_parameters()}
    unet_batch = 2 * TRAIN_PAIRS
    n_grad = len(train_flash_calls(cfg, unet_batch))
    want = launch_counts(flash_fwd=len(unet_flash_calls(cfg, unet_batch)) - n_grad,
                         flash_fwd_lse=n_grad, flash_bwd_dq=n_grad, flash_bwd_dkv=n_grad)
    steps = []

    def run(label, **inject):
        _build.reset_launches()
        _, metrics = train_step(state, batch, gen, **inject)
        torch.cuda.synchronize()
        row = {k: float(v) for k, v in metrics.items()}
        row["step"], row["launches"] = label, dict(_build.launches)
        steps.append(row)
        return row

    # the counted step keeps the conditioning; the first timed one drops it
    # (CFG dropout, u_cond_percent 0.2 of the steps), so bbox_uncond_vector
    # gets a gradient within the phase; the others draw as training does
    counted = run("counted", drop=False)
    if counted["launches"] != want:
        raise AssertionError(f"train step launches {counted['launches']}, expected {want}")
    walls = []
    for i in range(TRAIN_TIMED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(f"timed_{i}", drop=True if i == 0 else None)
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end) / 1e3)
    # device time by kernel class of one more step, CUDA activity only
    classes, top = profile_classes(lambda: run("profiled", drop=False))
    # bf16 K1 and K3 are one kernel (flash_fwd_sm90.cu): the profiled step
    # runs it for all of them, and no mma.sync forward
    fwd_kernels = {name: sum(c for _, c, key in top if name in key)
                   for name in ("flash_fwd_sm90_kernel<", "flash_fwd_kernel<")}
    if fwd_kernels != {"flash_fwd_sm90_kernel<": want["flash_fwd"] + want["flash_fwd_lse"],
                       "flash_fwd_kernel<": 0}:
        raise AssertionError(f"the profiled bf16 step ran the forward kernels {fwd_kernels}")
    model.unet.set_fused_gn(True)
    fused = run("fused_gn", drop=False)
    model.unet.set_fused_gn(False)
    want_fused = dict(want, gn_silu=len(unet_norm_calls(cfg, unet_batch)))
    if fused["launches"] != want_fused:
        raise AssertionError(f"fused train step launches {fused['launches']}, expected {want_fused}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for row in steps:
        if not all(math.isfinite(row[k]) for k in ("loss", "loss_camera", "loss_lidar")) \
                or not row["grad_norm"] > 0:
            raise AssertionError(f"train step {row['step']}: {row}")
    unchanged = [n for n, p in model.named_parameters() if mask[n] and torch.equal(p, before[n])]
    moved = [n for n, p in model.named_parameters() if not mask[n] and not torch.equal(p, before[n])]
    if unchanged or moved:
        raise AssertionError(f"trainable unchanged {unchanged[:5]} ({len(unchanged)}), "
                             f"frozen changed {moved[:5]} ({len(moved)})")
    del before

    # the launches of one whole-UNet backward: every flash call carries a gradient
    previous = os.environ.get("MOBI_TRAIN_UNET_FULL")
    os.environ["MOBI_TRAIN_UNET_FULL"] = "1"
    try:
        full = model.trainable_mask()
    finally:
        if previous is None:
            del os.environ["MOBI_TRAIN_UNET_FULL"]
        else:
            os.environ["MOBI_TRAIN_UNET_FULL"] = previous
    for name, p in model.named_parameters():
        p.requires_grad_(full[name])
    _build.reset_launches()
    loss, _ = model.training_loss(batch, gen, drop=False)
    loss.backward()
    torch.cuda.synchronize()
    full_counts = dict(_build.launches)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        p.grad = None
    n_all = len(unet_flash_calls(cfg, unet_batch))
    want_full = launch_counts(flash_fwd_lse=n_all, flash_bwd_dq=n_all, flash_bwd_dkv=n_all)
    if full_counts != want_full:
        raise AssertionError(f"whole-UNet backward launches {full_counts}, expected {want_full}")

    med = statistics.median(walls)
    busy = sum(classes.values())
    emit({"phase": "train_profile", "device_busy_s_per_step": busy,
          "busy_share_of_median_step": busy / med,
          "device_s_by_class": dict(sorted(classes.items(), key=lambda kv: -kv[1])),
          "forward_kernel_launches": fwd_kernels, "top_kernels_s_count": top[:12]})
    emit({"phase": "train", "pairs": TRAIN_PAIRS, "unet_batch": unet_batch,
          "lr_schedule": f"lambda_linear_schedule({TRAIN_LR}, {TRAIN_WARMUP})",
          "trainable_params": sum(p.numel() for n, p in model.named_parameters() if mask[n]),
          "parameters": sum(p.numel() for p in model.parameters()), "build_s": build_s,
          "steps": steps, "step_s": walls, "median_step_s": med,
          "pairs_per_s": TRAIN_PAIRS / med, "peak_mem_gib": peak,
          "launches_per_step": counted["launches"], "launches_fused_gn_step": fused["launches"],
          "launches_whole_unet_backward": full_counts, "card": smi})
    return model, tx, counted["launches"]


def trainable_grads_vs_plain(model, tx, pairs: int, variants, tol: float, phase: str):
    """The trainable gradients of one full-width training loss at `pairs`
    pair(s), fixed t, noise and drop, through each variant (label, fused
    GroupNorm + SiLU, attention backend, MOBI_FLASH_BWD) against the same
    through the plain versions (every attention by the plain formula under
    autograd, GroupNorm then SiLU): relative L2 within `tol`, and the
    launches each variant must make."""
    import torch

    from mobi_tpu_torch.models.unet import CrossAttention
    from mobi_tpu_torch.ops import _build
    from mobi_tpu_torch.ops import flash_attention as fa

    cfg, unet = model.config, model.unet
    b, s = 2 * pairs, cfg.latent_size
    g = torch.Generator(device=model.device).manual_seed(SEED + 3)
    t = torch.randint(0, cfg.timesteps, (b,), generator=g, device=model.device)
    noise = torch.randn(b, s, s, 4, generator=g, device=model.device).to(cfg.dtype)
    batch = make_batch(pairs)
    attns = [m for m in unet.modules() if isinstance(m, CrossAttention)]
    saved = [m.attn_backend for m in attns]

    def grads(fused: bool, backend: str, bwd_mode: str):
        unet.set_fused_gn(fused)
        for m in attention_targets(unet, backend):
            m.attn_backend = backend
        fa.BWD_MODE = bwd_mode
        g.manual_seed(SEED + 4)  # the same posterior draws in every variant
        tx.zero_grad()
        _build.reset_launches()
        try:
            loss, _ = model.training_loss(batch, g, t=t, noise=noise, drop=False)
            loss.backward()
            torch.cuda.synchronize()
        finally:
            unet.set_fused_gn(False)
            for m, was in zip(attns, saved):
                m.attn_backend = was
            fa.BWD_MODE = "pallas"
        flat = torch.cat([p.grad.float().flatten() for p in tx.params])
        tx.zero_grad()
        return flat, loss.item(), dict(_build.launches)

    ref, ref_loss, n_ref = grads(False, "xla", "pallas")
    results = {"plain": dict(n_ref, loss=ref_loss)}
    for label, fused, backend, mode in variants:
        got, loss, n = grads(fused, backend, mode)
        rel = float((got - ref).norm() / ref.norm())
        results[label] = dict(n, loss=loss, rel_l2_vs_plain=rel)
        if not bool(torch.isfinite(got).all()) or rel > tol:
            raise AssertionError(f"{phase} trainable gradients {label}: rel L2 {rel} vs the plain versions")
        del got
    n_calls, n_grad = len(unet_flash_calls(cfg, b)), len(train_flash_calls(cfg, b))
    n_all = len(train_flash_calls(cfg, b, "flash"))
    zero = launch_counts()
    kernels = dict(zero, flash_fwd=n_calls - n_grad, flash_fwd_lse=n_grad, flash_bwd_dq=n_grad,
                   flash_bwd_dkv=n_grad)
    want = {"plain": zero, "kernels": kernels,
            "kernels_fused_gn": dict(kernels, gn_silu=len(unet_norm_calls(cfg, b))),
            "flash_bwd_xla": dict(zero, flash_fwd=n_calls),
            "flash_all": dict(zero, flash_fwd=1, flash_fwd_lse=n_all, flash_bwd_dq=n_all, flash_bwd_dkv=n_all)}
    for label in results:
        got = {k: results[label][k] for k in want[label]}
        if got != want[label]:
            raise AssertionError(f"{phase} {label} launches {got}, expected {want[label]}")
    emit({"phase": phase, "dtype": str(cfg.dtype).replace("torch.", ""), "pairs": pairs, "t": t.tolist(),
          "trainable_grad_elements": int(ref.numel()), "tolerance_rel_l2": tol, **results})
    return results


def phase_train_switches(model, tx):
    """bf16: the kernels (K1, K3-K5), with the fused norm (K6), the
    MOBI_FLASH_BWD=xla backward, and attn_backend "flash" (K3-K5 at every
    level, d = 160 included), each against the plain versions."""
    return trainable_grads_vs_plain(model, tx, SWITCH_PAIRS, (
        ("kernels", False, "auto", "pallas"), ("kernels_fused_gn", True, "auto", "pallas"),
        ("flash_bwd_xla", False, "auto", "xla"), ("flash_all", False, "flash", "pallas")),
        GRAD_REL_L2, "train_switches")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs one", file=sys.stderr)
        return 2
    if not (ROOT / "mobi_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the mobi_tpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # fp32 matmuls and convs in full fp32 (cuDNN would default convs to TF32);
    # the flagship runs in bf16, where neither applies
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": {"matmul": False, "cudnn": False}})

    from mobi_tpu_torch.models.diffusion import MobiConfig, MobiDiffusion
    from mobi_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fresh = not _build.library_path().exists()
    lib_path = _build.build()
    _build.library()
    report = ptxas_report(lib_path.with_suffix(".log")) if fresh else []
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "library": lib_path.name,
          "nvcc_seconds": dict(_build.compile_seconds), "ptxas": report})

    cfg = MobiConfig(dtype=torch.bfloat16)
    k1, k2, k6 = phase_kernels(cfg, 4 * PAIRS)
    k3, k4, k5 = phase_train_kernels(cfg, 2 * TRAIN_PAIRS)
    fp32_rows = phase_train_kernels_fp32(cfg, 2 * TRAIN_PAIRS)
    train_calls = train_flash_calls(cfg, 2 * TRAIN_PAIRS)
    for kern in (k3, k4, k5):
        kern["fp32"] = fp32_rows[kern["name"]]
        by_shape = {tuple(r["shape_b_nq_nk_h_d"][i] for i in (0, 1, 3, 4)): r for r in kern["fp32"]}
        kern["fp32_per_step"] = {key: sum(by_shape[c][key] for c in train_calls)
                                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = MobiDiffusion(cfg, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    emit({"phase": "model", "seconds": time.perf_counter() - t0,
          "parameters": sum(p.numel() for p in model.parameters())})
    counts, counts_fused = phase_flagship(model, smi)
    phase_switches(model)
    del model
    torch.cuda.empty_cache()

    served = phase_serve(smi)
    tav_counts = phase_plms_tav(*served)
    del served
    torch.cuda.empty_cache()
    phase_fp32()

    model, tx, train_counts = phase_train(cfg, smi)
    phase_train_switches(model, tx)

    k1["launches"], k1["path"] = counts["flash_fwd"], "flagship DDIM batch, defaults"
    k2["launches"] = tav_counts["flash_fwd_tav"]
    k2["path"] = f"one PLMS-{STEPS} batch of the served model ({SERVE_PAIRS} pairs), K2 switch on"
    k6["launches"], k6["path"] = counts_fused["gn_silu"], "flagship batch, fused GroupNorm + SiLU switch on"
    for kern in (k3, k4, k5):
        kern["launches"] = train_counts[kern["name"]]
        kern["path"] = f"adapter training step, {TRAIN_PAIRS} pairs, the counted step"
    for kern in (k1, k2, k3, k4, k5):  # the off-main-path head dims' instantiations
        for row in kern["head_dims"] + [r for r in kern["fp32"] if r.get("case") == "head_dim"]:
            row.update(ptxas_for(report, kern["name"], row["dtype"], row["shape_b_nq_nk_h_d"][4]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "err_over_tol",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "per", "path")
    emit({"kernels": [{**{k: kern[k] for k in keys},
                       **{k: kern[k] for k in ("head_dims", "spans", "fp32", "fp32_per_step", "plain",
                                               "max_abs_diff_vs_flash_fwd", "host_us_per_call")
                          if k in kern}}
                      for kern in (k1, k2, k3, k4, k5, k6)]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
