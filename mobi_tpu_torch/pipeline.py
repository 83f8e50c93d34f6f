"""The end-to-end inpainting pipeline on one device (mobi_tpu pipeline.py):
conditioning encode -> both VAE encodes -> CFG-doubled PLMS / DDIM / DDPM
loop -> both VAE decodes.

`vae_chunk_pairs` runs the VAE encodes and decodes in chunks of that many
(camera, lidar) pairs, which bounds those stages' temporaries; the
per-sample math is unchanged, and the posterior draws come from the same
generator chunk after chunk, so only a stochastic encode's noise differs
from the unchunked call (`deterministic_encode=True` makes the two equal).
`sample_segments > 1` returns a `SegmentedInpaint`: the same pipeline as
prep / K sampling segments / decode calls, with the same output, and
`preflight` checks the memory of each of those calls against the card.

Not ported yet: the dp mesh and `replicate_outputs` (ROADMAP queue 1).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from mobi_tpu_torch.models import samplers as S
from mobi_tpu_torch.models.diffusion import MobiDiffusion, resolve_device
from mobi_tpu_torch.ops.schedules import SamplerTables

Batch = Dict[str, Any]
Outputs = Dict[str, torch.Tensor]


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _leading_dim(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def make_inpaint_pipeline(
    model: MobiDiffusion,
    num_steps: int = 50,
    guidance_scale: float = 5.0,
    sampler: str = "ddim",
    eta: float = 0.0,
    encoder_interval: int = 1,
    vae_chunk_pairs: int = 0,
    deterministic_encode: bool = False,
    sample_segments: int = 1,
    device=None,
):
    """Returns `pipeline(batch, generator=None, x_T=None)` -> {"camera":
    [B, H, W, 3], "lidar": [B, H, W, 2]} (NHWC, in [-1, 1]).

    The pipeline runs on `device` (CUDA unless the caller names another),
    which must be the model's. `deterministic_encode` encodes with the
    posterior mode; `x_T` ([2B, h, w, 4] NHWC) pins the initial noise.
    "ddim" is the default sampler here, as in the JAX pipeline."""
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"the model is on {model.device}, the pipeline asked for {dev}")
    if sampler not in MobiDiffusion.SAMPLERS:
        raise ValueError(f"unknown sampler {sampler}")
    if sample_segments > 1:
        if sampler not in ("ddim", "plms") or encoder_interval > 1:
            raise ValueError("sample_segments requires the exact ddim or plms path")
        if num_steps % sample_segments:
            raise ValueError(f"num_steps={num_steps} not divisible by sample_segments="
                             f"{sample_segments}")
    pairs_per_row = 2 if model.config.multimodal else 1

    def get_input(batch: Batch, generator) -> Dict[str, Any]:
        def run(part):
            return model.get_input(part, generator, encode_cond=True,
                                   deterministic=deterministic_encode)

        b = _leading_dim(batch)
        if not vae_chunk_pairs:
            return run(batch)
        if b % vae_chunk_pairs:
            raise ValueError(f"batch of {b} pairs not divisible by vae_chunk_pairs={vae_chunk_pairs}")
        parts = [run(_map_tree(lambda x, lo=lo: x[lo:lo + vae_chunk_pairs], batch))
                 for lo in range(0, b, vae_chunk_pairs)]
        data = {k: torch.cat([p[k] for p in parts]) for k in parts[0] if k != "lidar_geom"}
        if "lidar_geom" in parts[0]:
            data["lidar_geom"] = parts[0]["lidar_geom"]
        return data

    def decode(latents: torch.Tensor, z_lidar_full, geom) -> Outputs:
        if not vae_chunk_pairs:
            return model.decode_sample(latents, z_lidar_full, geom)
        rows = vae_chunk_pairs * pairs_per_row
        parts = [model.decode_sample(
            latents[lo:lo + rows], None if z_lidar_full is None else
            z_lidar_full[lo // pairs_per_row:(lo + rows) // pairs_per_row], geom)
            for lo in range(0, latents.shape[0], rows)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    if sample_segments > 1:
        return SegmentedInpaint(model, num_steps, guidance_scale, eta, sample_segments,
                                get_input, decode, sampler=sampler)

    @torch.inference_mode()
    def pipeline(batch: Batch, generator: Optional[torch.Generator] = None,
                 x_T: Optional[torch.Tensor] = None) -> Outputs:
        data = get_input(batch, generator)
        latents = model.sample(
            data, generator, num_steps=num_steps, guidance_scale=guidance_scale,
            sampler=sampler, eta=eta, encoder_interval=encoder_interval, x_T=x_T,
        )
        return decode(latents, data.get("z_lidar_full"), data.get("lidar_geom"))

    return pipeline


class SegmentedInpaint:
    """The inpaint pipeline as prep / K sampling segments / decode calls
    (mobi_tpu pipeline.py:189-414), callable like the pipeline, with the
    same output: prep draws from the generator in the order the single call
    does, and the segments run the same steps over slices of the step
    tables. DDIM segments carry x; PLMS carries (x, eps history) across the
    segment boundaries, and its step 0 (the double evaluation) runs in
    prep, so the first segment has one step fewer. `timed_call` gives each
    call's wall."""

    def __init__(self, model: MobiDiffusion, num_steps: int, guidance_scale: float, eta: float,
                 segments: int, get_input_fn: Callable, decode_fn: Callable,
                 sampler: str = "ddim"):
        self._model, self._guidance, self._sampler = model, guidance_scale, sampler
        self._get_input, self._decode = get_input_fn, decode_fn
        self._tables = tables = SamplerTables.create(model.schedule, num_steps, eta=eta)
        m = num_steps // segments
        if sampler == "plms":  # rows 1..S-1; row 0 runs in prep
            bounds = [(0, m - 1)] + [(m - 1 + i * m, m - 1 + (i + 1) * m)
                                     for i in range(segments - 1)]
        else:
            bounds = [(i * m, (i + 1) * m) for i in range(segments)]
        self._bounds = [(lo, hi) for lo, hi in bounds if hi > lo]
        self._per_step = (
            S.plms_per_step_tables(tables, model.device) if sampler == "plms"
            else (tables.timesteps, tables.per_step(model.device)))

    def _prep(self, batch: Batch, generator, x_T):
        data = self._get_input(batch, generator)
        x, cond, rest, uncond = self._model.sampling_inputs(data, generator, self._guidance, x_T)
        hist = None
        if self._sampler == "plms":
            x, hist = S.plms_prologue(self._model.apply_model, self._tables, x, cond, rest,
                                      uncond, self._guidance)
        return {"x": x, "hist": hist, "cond": cond, "rest": rest, "uncond": uncond,
                "z_lidar_full": data.get("z_lidar_full"), "lidar_geom": data.get("lidar_geom")}

    def _segment(self, st, lo: int, hi: int, generator) -> None:
        sl = tuple(a[lo:hi] for a in self._per_step)
        if self._sampler == "plms":
            st["x"], st["hist"] = S.plms_scan_segment(
                self._model.apply_model, st["x"], st["hist"], st["cond"], st["rest"], sl,
                st["uncond"], self._guidance)
        else:
            st["x"] = S.ddim_scan_segment(
                self._model.apply_model, st["x"], st["cond"], st["rest"], *sl, st["uncond"],
                self._guidance, self._tables.eta_is_zero, generator)

    def _finish(self, st) -> Outputs:
        return self._decode(st["x"].permute(0, 2, 3, 1), st["z_lidar_full"], st["lidar_geom"])

    @torch.inference_mode()
    def __call__(self, batch: Batch, generator: Optional[torch.Generator] = None,
                 x_T: Optional[torch.Tensor] = None) -> Outputs:
        st = self._prep(batch, generator, x_T)
        for lo, hi in self._bounds:
            self._segment(st, lo, hi, generator)
        return self._finish(st)

    @torch.inference_mode()
    def timed_call(self, batch: Batch, generator: Optional[torch.Generator] = None,
                   x_T: Optional[torch.Tensor] = None) -> Tuple[Outputs, List[Tuple[str, float]]]:
        """__call__ with the wall of each call (prep, each segment, decode),
        each ended by a device synchronise, as (name, seconds) pairs."""
        def sync():
            if self._model.device.type == "cuda":
                torch.cuda.synchronize(self._model.device)

        walls = []
        t = time.perf_counter()
        st = self._prep(batch, generator, x_T)
        sync()
        walls.append(("prep", time.perf_counter() - t))
        for i, (lo, hi) in enumerate(self._bounds):
            t = time.perf_counter()
            self._segment(st, lo, hi, generator)
            sync()
            walls.append((f"seg{i}[{hi - lo}]", time.perf_counter() - t))
        t = time.perf_counter()
        out = self._finish(st)
        sync()
        walls.append(("decode", time.perf_counter() - t))
        return out, walls

    @torch.inference_mode()
    def preflight(self, batch: Batch, generator: Optional[torch.Generator] = None,
                  x_T: Optional[torch.Tensor] = None, label: str = "inpaint",
                  limit_bytes: Optional[int] = None) -> bool:
        """Run each call once at this batch and check what it held on the
        card against the card's memory (or `limit_bytes`): prep, a segment
        for each distinct segment length, and decode (mobi_tpu
        pipeline.py:416-450, where XLA's compiled plans are checked). CUDA
        has no plan, so each call is measured (utils/hbm.py `measure`); a
        segment's probe runs one step, which holds what a longer one holds,
        since a step frees its temporaries before the next. Raises
        HbmOverBudgetError naming the call. Returns True when the checks
        ran, False on the CPU (no budget). The caller's generator and the
        global RNGs (which a call without a generator draws from) are left
        as they were, so the next call's output is unchanged."""
        from mobi_tpu_torch.utils import hbm

        dev = self._model.device
        if hbm.device_hbm_budget(dev) is None:
            return False
        saved = None if generator is None else generator.get_state()
        try:
            with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
                st, rec = hbm.measure(lambda: self._prep(batch, generator, x_T), dev)
                checks = [("prep", rec)]
                for n in sorted({hi - lo for lo, hi in self._bounds}):
                    lo = next(lo for lo, hi in self._bounds if hi - lo == n)
                    _, rec = hbm.measure(lambda: self._segment(dict(st), lo, lo + 1, generator), dev)
                    checks.append((f"sampling segment[{n} steps]", rec))
                _, rec = hbm.measure(lambda: self._finish(st), dev)
                checks.append(("decode", rec))
        finally:
            if saved is not None:
                generator.set_state(saved)
        return all(hbm.assert_fits(r, dev, f"{label} ({name})", limit_bytes) for name, r in checks)
