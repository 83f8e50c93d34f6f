"""The tiny oracle gate (tests/test_overfit_oracle.py) run many ways on the
CPU, to tell the draw from the code: which of its sampled thresholds the
JAX package meets, and whether the port lands where JAX does.

    JAX_PLATFORMS=cpu python -m tests.test_torch_oracle_witness jax 0
    JAX_PLATFORMS=cpu python -m tests.test_torch_oracle_witness port 0
    JAX_PLATFORMS=cpu python -m tests.test_torch_oracle_witness port_jaxinit 0

Each run trains the tiny config as tests/test_overfit_oracle.py's
`oracle_run` does (u_cond_percent 0, VAE 400 steps, whole-UNet diffusion
800 steps at lr 3e-4), then scores DDIM-10 inpaints from 13 noise draws
(seed 7, the JAX test's own, then seeds 0-11):

  jax N           the JAX package from jax.random.PRNGKey(N), scored by
                  its own sampler, then the same trained weights loaded
                  into the port and scored by the port's sampler;
  port N          the port from its own seeded weights (oracle_model,
                  seed N), plain attention (the CPU);
  port_jaxinit N  the port from the JAX package's initial weights for
                  PRNGKey(N).

Prints one JSON line per scoring: every draw's numbers, their means, and
for each of the JAX test's thresholds the draws that pass it. A run took
10-13 minutes with twelve of them sharing 8 CPU cores.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np

DRAWS = [7] + list(range(12))
STEPS = {"vae": 400, "diffusion": 800, "sample": 10}
# tests/test_overfit_oracle.py:89-114, on one draw against the untrained
# model's draw of the same seed
THRESHOLDS = {"camera_margin_db": 2.5, "camera_min_db": 13.5, "lidar_margin_db": 1.0, "lidar_min_db": 11.5,
              "camera_over_untrained_db": 4.0, "lidar_over_untrained_db": 2.0, "depth_mse_max": 0.3}


def checks(t, u):
    g = THRESHOLDS
    c, lid = t["camera_psnr"], t["lidar_psnr"]
    return {k: bool(v) for k, v in {
        "camera_margin": c > t["camera_psnr_baseline"] + g["camera_margin_db"],
        "camera_min": c > g["camera_min_db"],
        "lidar_margin": lid > t["lidar_psnr_baseline"] + g["lidar_margin_db"],
        "lidar_min": lid > g["lidar_min_db"],
        "camera_over_untrained": c > u["camera_psnr"] + g["camera_over_untrained_db"],
        "lidar_over_untrained": lid > u["lidar_psnr"] + g["lidar_over_untrained_db"],
        "depth_mse": t["lidar_depth_mse"] < g["depth_mse_max"]}.items()}


def report(label, trained, untrained, extra):
    per = [checks(t, u) for t, u in zip(trained, untrained)]
    keys = ("camera_psnr", "lidar_psnr", "lidar_depth_mse")
    row = {"run": label, **extra, "draw_seeds": DRAWS,
           "trained": [{k: float(t[k]) for k in keys} for t in trained],
           "untrained": [{k: float(u[k]) for k in keys} for u in untrained],
           "trained_mean_seeds_0_11": {k: float(np.mean([t[k] for t in trained[1:]])) for k in keys},
           "untrained_mean_seeds_0_11": {k: float(np.mean([u[k] for u in untrained[1:]])) for k in keys},
           "jax_test_draw_passes_all": all(per[0].values()),
           "draws_0_11_passing": {k: sum(p[k] for p in per[1:]) for k in per[0]},
           "draws_0_11_passing_all": sum(all(p.values()) for p in per[1:])}
    print(json.dumps(row), flush=True)


def port_model(seed, params_np=None):
    from mobi_tpu_torch import overfit_oracle as O
    from tests.test_diffusion import TINY
    from tests.test_torch_models import port_config, tiny_cond_stage

    model = O.oracle_model(port_config(dataclasses.replace(TINY, u_cond_percent=0.0)), device="cpu", seed=seed,
                           cond_stage_model=tiny_cond_stage())
    if params_np is not None:
        model.load_jax_params(params_np)
    return model


def port_draws(model, batch):
    from mobi_tpu_torch import overfit_oracle as O

    return [O.sample_and_score(model, batch, num_steps=STEPS["sample"], seed=s) for s in DRAWS]


def jax_model_and_init(seed):
    import jax

    from mobi_tpu.models.diffusion import MobiDiffusion
    from tests.test_diffusion import TINY, TinyCondStage

    model = MobiDiffusion(dataclasses.replace(TINY, u_cond_percent=0.0))
    model.cond_model = TinyCondStage(conditions=("ref_image", "ref_bbox"))
    return model, model.init_params(jax.random.PRNGKey(seed))


def main(mode: str, seed: int) -> None:
    import jax
    import torch

    jax.config.update("jax_default_matmul_precision", "highest")
    jax.config.update("jax_threefry_partitionable", True)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if mode == "jax":
        from mobi_tpu import overfit_oracle as J

        model, params = jax_model_and_init(seed)
        batch = J.make_object_set(4, 32, 32, seed=0)
        untrained = [J.sample_and_score(model, params, batch, num_steps=STEPS["sample"], seed=s) for s in DRAWS]
        params, vae = J.overfit_vaes(model, params, batch, steps=STEPS["vae"])
        params, diff = J.overfit_diffusion(model, jax.device_get(params), batch, steps=STEPS["diffusion"], lr=3e-4)
        params = jax.device_get(params)
        trained = [J.sample_and_score(model, params, batch, num_steps=STEPS["sample"], seed=s) for s in DRAWS]
        extra = {"vae_final_l1": {k: float(v) for k, v in vae.items()}, "final_loss": float(diff["final_loss"]),
                 "seconds": time.perf_counter() - t0}
        report(f"jax {seed}", trained, untrained, extra)
        port = port_model(0, jax.tree.map(np.asarray, params))
        for p in port.parameters():
            p.requires_grad_(False)
        report(f"jax {seed}, the port's sampler", port_draws(port, batch), untrained, {})
        return
    from mobi_tpu_torch import overfit_oracle as O

    if mode == "port":
        model = port_model(seed)
    elif mode == "port_jaxinit":
        model = port_model(seed, jax.tree.map(np.asarray, jax_model_and_init(seed)[1]))
    else:
        raise SystemExit(f"unknown mode {mode}")
    batch = O.make_object_set(4, 32, 32, seed=0)
    untrained = port_draws(model, batch)
    vae = O.overfit_vaes(model, batch, steps=STEPS["vae"])
    _, diff = O.overfit_diffusion(model, batch, steps=STEPS["diffusion"], lr=3e-4)
    for p in model.parameters():
        p.requires_grad_(False)
    trained = port_draws(model, batch)
    report(f"{mode} {seed}", trained, untrained,
           {"vae_final_l1": vae, "final_loss": diff["final_loss"], "seconds": time.perf_counter() - t0})


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
