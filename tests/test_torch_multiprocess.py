"""The port's scale-out on the CPU: gloo ranks as subprocesses, held against
the JAX package's single-process results and the port's own one-process
runs (the torch counterparts of tests/test_multihost.py,
tests/test_tp_mesh.py and tests/test_sharded_inference.py).

Run as a script, this file is the worker: it joins a localhost gloo group,
builds the port's tiny model from the exported parameters the test wrote,
runs its case and writes what rank 0 gathered. The worker imports torch and
the port, never jax; the test process computes the references.

Draws: the two frameworks' random draws never match, so the train steps
encode with the posterior mode and take t, noise and the CFG drop injected
at the global batch shape; every rank keeps its rows of them, as it keeps
its rows of every draw it makes itself (`ops.draws.batch_shard`).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 2
LR = 1e-3

# tests/test_diffusion.py's TINY, for the worker, which imports no jax
TINY_FIELDS = dict(
    timesteps=1000, latent_size=8, image_height=32, image_width=32, range_height=32, range_width=32,
    unet_channels=32, unet_channel_mult=(1, 2), unet_num_res_blocks=1, unet_attention_resolutions=(2, 1),
    unet_num_heads=4, context_dim=64, ref_image_size=32, vae_ch=16, vae_ch_mult=(1, 1, 2),
    vae_num_res_blocks=1, clip_width=96)


# ------------------------------------------------------------------ worker


def _tiny_model(remat=False, dtype="fp32"):
    import torch

    from mobi_tpu_torch.models import diffusion as tdiff
    from mobi_tpu_torch.models.encoders import CondStageModel

    torch.set_num_threads(1)
    cond = CondStageModel(clip_width=96, clip_image_size=32, clip_patch_size=16, clip_layers=2,
                          clip_heads=4, mapper_layers=2, bbox_proj_dims=(64, 48, 48, 64))
    cfg = tdiff.MobiConfig(**TINY_FIELDS, unet_use_checkpoint=remat, vae_use_checkpoint=remat,
                           dtype={"fp32": torch.float32, "bf16": torch.bfloat16}[dtype])
    return tdiff.MobiDiffusion(cfg, device="cpu", cond_stage_model=cond, for_training=True)


def _probe_blocks(sharding):
    """Record, at every block gather of a blockwise step (forward and
    backward), how many blocks other than the root have whole tensors alive
    (weak references to every tensor a gather makes and every tensor it
    installs in the block's modules, so whatever still holds one, the window
    or the autograd graph, counts) and their bytes; count the Dense and
    Conv2d forwards that record gradients on a weight not in their compute
    dtype (each would copy the whole weight, and the graph would keep the
    copy); and record the most bytes of pieces a checkpoint's host copy
    gathers at once."""
    import weakref

    import torch

    from mobi_tpu_torch.models.layers import Conv2d, Dense

    alive, gathered = [], []
    seen = {"max_blocks": 0, "max_bytes": 0, "forward": 0, "backward": 0, "names": set(), "copies": 0}
    gather, ensure = sharding._gather_block, sharding._ensure

    def track(name, tensors):
        alive.extend((name, weakref.ref(t), t.numel() * t.element_size()) for t in tensors)

    def recording_gather(blk):
        out = gather(blk)
        gathered.append({id(t) for t in out})
        if blk.name:
            track(blk.name, out)
        return out

    def recording_ensure(i):
        n = len(gathered)
        whole = ensure(i)
        if len(gathered) > n:
            name = sharding.blocks[i].name
            if name:  # the installed tensors that are not the gathered ones or views of them
                track(name, [t for t in whole.tensors if t._base is None and id(t) not in gathered[-1]])
            held = [(b, size) for b, ref, size in alive if ref() is not None]
            seen["max_blocks"] = max(seen["max_blocks"], len({b for b, _ in held}))
            seen["max_bytes"] = max(seen["max_bytes"], sum(size for _, size in held))
            seen[sharding._mode] += 1
            seen["names"].update(sharding.blocks[k].name for k in sharding._window if k)
        return whole

    def no_copy(m, args):
        if sharding._mode is not None and torch.is_grad_enabled() and m.weight.requires_grad \
                and m.weight.dtype != m.dtype:
            seen["copies"] += 1

    def recording_full(tensors, layouts):  # a checkpoint's gather (host_state), a run at a time
        seen["max_host_run_bytes"] = max(seen.get("max_host_run_bytes", 0),
                                         sum(t.numel() * t.element_size() for t in tensors))
        return full(tensors, layouts)

    full = sharding.full
    sharding._gather_block, sharding._ensure, sharding.full = recording_gather, recording_ensure, recording_full
    for blk in sharding.blocks:
        for sites in blk.sites:
            for m, pname in sites:
                if isinstance(m, (Dense, Conv2d)) and pname == "weight":
                    m.register_forward_pre_hook(no_copy)  # after the sharding's gather hook
    sizes = sorted((sum(p.numel() * p.element_size() for p in b.params) * sharding.axis_size("fsdp")
                    for b in sharding.blocks[1:]), reverse=True)
    seen["largest_piece_bytes"] = max(p.numel() * p.element_size() for _, p, _ in sharding.entries)
    return seen, sum(sizes[:2])


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _load_npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _train_case(case, rank):
    import torch

    from mobi_tpu_torch import training
    from mobi_tpu_torch.ops import distributions
    from mobi_tpu_torch.parallel import distributed as pdist
    from mobi_tpu_torch.parallel import mesh as pmesh

    # the JAX reference encodes with the posterior mode (deterministic=True)
    distributions.DiagonalGaussian.sample = lambda self, generator=None: self.mode()
    if case.get("gather_bucket_bytes"):
        pmesh.GATHER_BUCKET_BYTES = case["gather_bucket_bytes"]
    mesh = pmesh.create_mesh(dp=case["dp"], fsdp=case["fsdp"], tp=case["tp"])
    model = _tiny_model(case.get("remat", False), case.get("dtype", "fp32"))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _load_npz(case["params"]).items()},
                          strict=True)
    state, tx = training.create_train_state(
        model, device="cpu", schedule=training.lambda_linear_schedule(LR, 1, 0.5), mesh=mesh,
        optimizer=case.get("optimizer", "adamw"))
    probe = _probe_blocks(pmesh.model_sharding(model)) if case.get("probe") else None
    step = training.make_train_step(model, tx, device="cpu", mesh=mesh)
    data = _load_npz(case["data"])
    batch = pmesh.shard_batch(mesh, _unflatten(
        {k[len("batch/"):]: v for k, v in data.items() if k.startswith("batch/")}))
    losses, norms = [], []
    for i in range(N_STEPS):
        state, m = step(state, batch, None, t=torch.from_numpy(data[f"t{i}"]).long(),
                        noise=torch.from_numpy(data[f"noise{i}"]), drop=bool(data["drops"][i]))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        host = pdist.replicate_to_host(state)  # a checkpoint's gather mid-run changes nothing
    if rank == 0:
        np.savez(case["out"], **{k: v.float().numpy() for k, v in host["model"].items()})
    out = {"losses": losses, "grad_norms": norms, "mesh": mesh.shape,
           "resident_params": sum(p.numel() for p in model.parameters())}
    if probe is not None:
        seen, two_largest = probe
        out["probe"] = dict(seen, names=sorted(seen["names"]), two_largest_bytes=two_largest,
                            blocks=[b.name for b in pmesh.model_sharding(model).blocks[1:]])
    return out


def _inference_case(case, rank):
    import torch

    from mobi_tpu_torch.parallel import mesh as pmesh
    from mobi_tpu_torch.pipeline import inference_mesh, make_inpaint_pipeline, replicate_params

    mesh = inference_mesh()
    model = _tiny_model()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _load_npz(case["params"]).items()},
                          strict=True)
    replicate_params(mesh, model)
    data = _load_npz(case["data"])
    batch = pmesh.shard_batch(mesh, _unflatten(
        {k[len("batch/"):]: v for k, v in data.items() if k.startswith("batch/")}))
    fn = make_inpaint_pipeline(model, num_steps=3, guidance_scale=2.0, sampler=case["sampler"],
                               device="cpu", mesh=mesh, replicate_outputs=True,
                               sample_segments=case.get("segments", 1))
    out = fn(batch, torch.Generator().manual_seed(11))
    if rank == 0:
        np.savez(case["out"], **{k: v.numpy() for k, v in out.items()})
    return {"rows": {k: int(v.shape[0]) for k, v in out.items()}}


def _adafactor_case(case, rank):
    """Adafactor's factored second moment and block RMS on fsdp / tp pieces:
    a [256, 160] weight and its bias under the GEGLU name, so tp splits the
    weight's halves and fsdp its input dim; the update of every rank's
    piece, gathered, against the whole tensor's on one process."""
    import torch

    from mobi_tpu_torch import training
    from mobi_tpu_torch.models.layers import Dense
    from mobi_tpu_torch.parallel import mesh as pmesh

    def module():
        root = torch.nn.Module()
        root.ff = torch.nn.Module()
        root.ff.net = torch.nn.ModuleList([torch.nn.Module()])
        root.ff.net[0].proj = Dense(160, 256)
        return root

    g = torch.Generator().manual_seed(2)
    init = torch.randn(256, 160, generator=g)
    grads = [torch.randn(256, 160, generator=g) for _ in range(3)]
    whole, sharded = module(), module()
    for m in (whole, sharded):
        m.ff.net[0].proj.weight.data.copy_(init)
    mesh = pmesh.create_mesh(dp=case["dp"], fsdp=case["fsdp"], tp=case["tp"])
    sharding = pmesh.shard_params(mesh, sharded)
    assert list(sharding.layouts["ff.net.0.proj.weight"].spec) == case["spec"], sharding.layouts
    opts = [training.Adafactor([m.ff.net[0].proj.weight], lr=0.1) for m in (whole, sharded)]
    for grad in grads:
        whole.ff.net[0].proj.weight.grad = grad.clone()
        lay = sharded.ff.net[0].proj.weight._mobi_shard[1]
        sharded.ff.net[0].proj.weight.grad = sharding.local(grad, lay)
        for o in opts:
            o.step()
    p = sharded.ff.net[0].proj.weight
    got = sharding.full([p.data], [p._mobi_shard[1]])[0]
    want = whole.ff.net[0].proj.weight.data
    return {"max_abs_err": float((got - want).abs().max()), "max_abs": float(want.abs().max()),
            "factored": opts[1].factored_dims(p._mobi_shard[1].shape) is not None}


def _cli_case(case, rank):
    from mobi_tpu_torch import train
    from mobi_tpu_torch.models.encoders import CondStageModel

    # tests/test_torch_train_cli.py's cli_cond_stage
    cond = CondStageModel(clip_width=1024, clip_image_size=224, clip_patch_size=56, clip_layers=1, clip_heads=16,
                          mapper_layers=1, bbox_proj_dims=(64, 48, 48, 64))
    argv = case["argv"] + ["--coordinator", f"127.0.0.1:{case['port']}", "--num_processes", str(case["world"]),
                           "--process_id", str(rank)]
    stats = train.main(argv, cond_stage_model=cond)
    return {"losses": stats["losses"], "logdir": stats["logdir"], "ckpt_dir": stats["ckpt_dir"],
            "step": stats["step"], "world": stats["world"]}


def worker(case_path, rank):
    with open(case_path) as f:
        case = json.load(f)
    from mobi_tpu_torch.parallel import distributed as pdist

    if case["kind"] == "cli":  # the CLI joins the group itself
        result = _cli_case(case, rank)
    else:
        assert pdist.initialize(f"127.0.0.1:{case['port']}", case["world"], rank, backend="gloo", device="cpu")
        kinds = {"train": _train_case, "inference": _inference_case, "adafactor": _adafactor_case}
        result = kinds[case["kind"]](case, rank)
    assert "jax" not in sys.modules, "the worker imported jax"
    print("MP_RESULT " + json.dumps({"rank": rank, **result}), flush=True)
    pdist.barrier("worker_done")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    worker(sys.argv[1], int(sys.argv[2]))


# ------------------------------------------------------------- the tests


def numpy_batch(b, rng):
    """tests/test_diffusion.py's make_batch in numpy (the same draws)."""
    f32 = np.float32

    def u(lo, hi, shape):
        return rng.uniform(lo, hi, shape).astype(f32)

    def mask(shape):
        return (rng.uniform(0, 1, shape) > 0.3).astype(f32)

    return {
        "image": {"GT": u(-1, 1, (b, 32, 32, 3)), "inpaint_image": u(-1, 1, (b, 32, 32, 3)),
                  "inpaint_mask": mask((b, 32, 32, 1)),
                  "cond": {"ref_image": u(-1, 1, (b, 32, 32, 3)), "ref_bbox": u(0, 1, (b, 8, 3))}},
        "lidar": {"range_data": u(-1, 1, (b, 32, 32, 2)), "range_data_inpaint": u(-1, 1, (b, 32, 32, 2)),
                  "range_mask": mask((b, 32, 32, 1)), "cond": {"ref_bbox": u(0, 1, (b, 8, 3))}},
    }


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(tmp_path, name, case, world, timeout=240):
    """Run `case` on `world` gloo ranks; {rank: result}. Any rank failing
    fails the test, with its output."""
    case = dict(case, port=_free_port(), world=world)
    path = str(tmp_path / f"{name}.json")
    with open(path, "w") as f:
        json.dump(case, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
        for line in out.splitlines():
            if line.startswith("MP_RESULT "):
                res = json.loads(line[len("MP_RESULT "):])
                results[res["rank"]] = res
    assert set(results) == set(range(world)), outs
    return results


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """The exported tiny parameters, a batch of 4 pairs and the injected
    draws of N_STEPS steps (files the workers read), and JAX's
    single-process steps on them: make_train_step's loss and gradient with
    the draws injected, then optax's AdamW of make_optimizer."""
    import jax
    import jax.numpy as jnp
    import optax

    from mobi_tpu import training as jtraining
    from mobi_tpu.models.diffusion import MobiDiffusion as JaxMobi
    from mobi_tpu_torch import convert
    from tests.test_diffusion import TINY, TinyCondStage
    from tests.test_torch_models import port_config, random_params

    d = tmp_path_factory.mktemp("mp")
    jmodel = JaxMobi(TINY)
    jmodel.cond_model = TinyCondStage(conditions=("ref_image", "ref_bbox"))
    params_np = random_params(jmodel, seed=3)
    start = convert.state_dict_numpy(params_np, port_config(TINY))
    np.savez(d / "params.npz", **start)
    rng = np.random.default_rng(31)
    batch = numpy_batch(4, rng)
    data = {"batch/" + k: v for k, v in _flatten(batch).items()}
    for i in range(N_STEPS):
        data[f"t{i}"] = rng.integers(0, TINY.timesteps, 8).astype(np.int32)
        data[f"noise{i}"] = rng.standard_normal((8, TINY.latent_size, TINY.latent_size, 4)).astype(np.float32)
    data["drops"] = np.array([False, True])
    np.savez(d / "data.npz", **data)

    def loss_fn(params, batch, t, noise, drop):
        mask = jmodel.trainable_mask(params)
        p = jax.tree.map(lambda x, m: x if m else jax.lax.stop_gradient(x), params, mask)
        z_data = jmodel.get_input(p, batch, jax.random.PRNGKey(0), encode_cond=False, deterministic=True)
        z = z_data["z"]
        ctx = jmodel.get_learned_conditioning(p, z_data["cond_raw"])
        ctx = jnp.where(drop, jmodel.uncond_tokens(p, z.shape[0]), ctx)
        return jmodel.p_losses(p, z, ctx, t, jax.random.PRNGKey(1), noise=noise)

    params = jax.tree.map(jnp.asarray, params_np)
    tx = jtraining.make_optimizer(jmodel, params, schedule=jtraining.lambda_linear_schedule(LR, 1, 0.5))

    @jax.jit
    def step(params, opt_state, batch, t, noise, drop):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch, t, noise, drop)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    opt_state = tx.init(params)
    losses = []
    for i in range(N_STEPS):
        params, opt_state, loss = step(params, opt_state, batch, data[f"t{i}"], data[f"noise{i}"],
                                       bool(data["drops"][i]))
        losses.append(float(loss))
    final = convert.state_dict_numpy(jax.tree.map(np.asarray, params), port_config(TINY))
    return {"dir": d, "losses": losses, "start": start, "final": final}


def check_params(got, jax_steps):
    """The gathered parameters after the steps against JAX's: every frozen
    tensor bitwise unchanged; every trained one within rtol 2e-5 in L2; and
    what the steps changed (the updates, 2 AdamW steps of lr 1e-3) within
    1e-3 in L2 over the trained set. AdamW's first updates are near
    g / |g|, so a gradient near 0 flips an element's update by float
    rounding: the port's own one-process steps sit at 8.7e-5 of JAX's
    updates (5.9e-5 of the largest value of bbox_proj, the worst tensor,
    on 0.05% of its elements), dp = 2 at 1.2e-4, measured on this batch."""
    start, want = jax_steps["start"], jax_steps["final"]
    num = den = 0.0
    moved = 0
    for name, value in want.items():
        if np.array_equal(value, start[name]):
            np.testing.assert_array_equal(got[name], start[name], err_msg=name)
            continue
        moved += 1
        assert np.linalg.norm(got[name] - value) <= 2e-5 * np.linalg.norm(value), name
        num += float(np.sum((got[name] - value) ** 2))
        den += float(np.sum((value - start[name]) ** 2))
    assert moved > 50 and np.sqrt(num / den) <= 1e-3, (moved, np.sqrt(num / den))


def _train(jax_steps, tmp_path, name, dp, fsdp, tp, timeout=240, **extra):
    d = jax_steps["dir"]
    case = dict(kind="train", dp=dp, fsdp=fsdp, tp=tp, params=str(d / "params.npz"), data=str(d / "data.npz"),
                out=str(tmp_path / f"{name}.npz"), **extra)
    res = run_workers(tmp_path, name, case, dp * fsdp * tp, timeout)
    want_shape = {"dp": dp, "fsdp": fsdp, **({"tp": tp} if tp > 1 else {})}
    for r in res.values():  # the metrics are the global batch's on every rank
        assert r["losses"] == res[0]["losses"] and r["grad_norms"] == res[0]["grad_norms"]
        assert r["mesh"] == want_shape
    return res, _load_npz(case["out"])


@pytest.mark.parametrize("dp,fsdp", [(2, 1), (2, 2)])
def test_sharded_steps_match_jax(jax_steps, tmp_path, dp, fsdp):
    """dp = 2 and dp = 2 x fsdp = 2: two train steps (the second drops the
    conditioning, so the unconditional token is trained and the bbox path
    is not), each rank on its rows of 4 pairs, equal to JAX's
    single-process steps on the same parameters, batch and draws: the losses
    at rtol 2e-5 (tests/test_multihost.py:127-135), the gathered parameters
    as `check_params` holds them. fsdp halves what a rank holds at rest;
    its all-gathers run in 64 KiB buckets here, so a gather spans many."""
    res, got = _train(jax_steps, tmp_path, f"dp{dp}_fsdp{fsdp}", dp, fsdp, 1, gather_bucket_bytes=2**16)
    np.testing.assert_allclose(res[0]["losses"], jax_steps["losses"], rtol=2e-5)
    check_params(got, jax_steps)
    start = jax_steps["start"]
    total = sum(v.size for v in start.values())
    per_rank = res[0]["resident_params"]
    assert per_rank == total if fsdp == 1 else total / 2 <= per_rank < 0.52 * total


@pytest.mark.parametrize("remat,dtype", [pytest.param(False, "fp32", id="False"), pytest.param(True, "fp32", id="True"),
                                         pytest.param(False, "bf16", id="bf16")])
def test_fsdp_gathers_block_by_block(jax_steps, tmp_path, remat, dtype):
    """fsdp = 2 on two ranks, the UNet (and VAEs) with and without remat,
    in fp32 and in bf16 (the trainable weights fp32, their layers bf16): at
    every block's gather, in the forward and in the backward (remat's
    recompute included), whole tensors are alive for at most two blocks
    besides the root (the one running and the one before it), within the
    two largest blocks' bytes, no layer that records gradients copies its
    weight to its dtype, a checkpoint's host copy gathers one 64 KiB
    bucket of pieces at a time (or one larger tensor), and every UNet
    block, VAE level and CLIP layer is one of the blocks. In fp32 the steps equal JAX's as
    `test_sharded_steps_match_jax` holds them; in bf16 they equal the
    port's dp = 2 bf16 steps bitwise, losses and parameters (each rank
    computes the same rows with the same whole weights, and a sum of two
    ranks' gradients does not depend on their order)."""
    name = f"blockwise_remat{int(remat)}_{dtype}"
    res, got = _train(jax_steps, tmp_path, name, 1, 2, 1, probe=True, remat=remat, dtype=dtype,
                      gather_bucket_bytes=2**16)
    if dtype == "fp32":
        np.testing.assert_allclose(res[0]["losses"], jax_steps["losses"], rtol=2e-5)
        check_params(got, jax_steps)
    else:
        dp, ref = _train(jax_steps, tmp_path, "dp2_bf16", 2, 1, 1, dtype=dtype)
        assert res[0]["losses"] == dp[0]["losses"]
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    for r in res.values():
        probe = r["probe"]
        assert probe["max_blocks"] <= 2 and probe["max_bytes"] <= probe["two_largest_bytes"], probe
        assert probe["forward"] >= len(probe["blocks"]) and probe["backward"] > 0, probe
        assert probe["copies"] == 0, probe
        assert 0 < probe["max_host_run_bytes"] <= max(2**16, probe["largest_piece_bytes"]), probe
        blocks = set(probe["blocks"])
        for want in ("model.diffusion_model.input_blocks.1", "model.diffusion_model.middle_block",
                     "model.diffusion_model.output_blocks.2", "first_stage_model.encoder.down.1",
                     "lidar_stage_model.decoder.up.0", "first_stage_model.encoder.mid",
                     "cond_stage_model.transformer.vision_model.encoder.layers.1",
                     "cond_stage_model.mapper.resblocks.0", "cond_stage_model"):
            assert want in blocks, (want, sorted(blocks))
        assert {n for n in probe["names"] if ".input_blocks." in n or ".output_blocks." in n} \
            == {n for n in blocks if ".input_blocks." in n or ".output_blocks." in n}


@pytest.mark.parametrize("dp,fsdp,tp", [
    (1, 2, 2),
    pytest.param(2, 2, 2, marks=pytest.mark.slow),  # tests/test_tp_mesh.py:47's 8-device step
])
def test_tp_steps_match_the_unsharded_step(jax_steps, tmp_path, dp, fsdp, tp):
    """Megatron-style tp on the named projections with fsdp (and dp): the
    attention and MLP projections split over tp (the GEGLU halves alike),
    the losses equal JAX's unsharded steps at rtol 2e-3
    (tests/test_tp_mesh.py:73) and the gathered parameters as
    `check_params` holds them."""
    res, got = _train(jax_steps, tmp_path, f"tp{dp}{fsdp}{tp}", dp, fsdp, tp, timeout=400)
    np.testing.assert_allclose(res[0]["losses"], jax_steps["losses"], rtol=2e-3)
    check_params(got, jax_steps)


@pytest.mark.parametrize("sampler,segments", [("ddim", 1), ("plms", 3)])
def test_dp2_inference_matches_one_process(jax_steps, tmp_path, sampler, segments):
    """tests/test_sharded_inference.py:43-60: the pipeline on a dp = 2 mesh,
    each rank sampling its 2 of 4 pairs (stochastic encodes, CFG 2, 3 steps;
    PLMS as 3 segments), gathered in rank order, equals one process at atol
    1e-5: the ranks draw the posterior samples and x_T at the global shape
    and keep their rows."""
    import torch

    from mobi_tpu_torch.pipeline import make_inpaint_pipeline

    d = jax_steps["dir"]
    model = _tiny_model()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in jax_steps["start"].items()}, strict=True)
    data = _load_npz(d / "data.npz")
    batch = _unflatten({k[len("batch/"):]: v for k, v in data.items() if k.startswith("batch/")})
    fn = make_inpaint_pipeline(model, num_steps=3, guidance_scale=2.0, sampler=sampler, device="cpu",
                               sample_segments=segments)
    want = fn(batch, torch.Generator().manual_seed(11))
    case = dict(kind="inference", sampler=sampler, segments=segments, params=str(d / "params.npz"),
                data=str(d / "data.npz"), out=str(tmp_path / "inf.npz"))
    res = run_workers(tmp_path, "inf", case, 2)
    assert all(r["rows"] == {"camera": 4, "lidar": 4} for r in res.values())
    got = _load_npz(case["out"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("dp,fsdp,tp,spec", [(1, 2, 1, ["fsdp", None]), (1, 2, 2, ["tp", "fsdp"])])
def test_adafactor_on_pieces_matches_the_whole(tmp_path, dp, fsdp, tp, spec):
    """Adafactor on a factored weight held in fsdp (and tp) pieces: its row
    and column means and its block RMS span the ranks, so three updates of
    the pieces, gathered, equal those of the whole weight in one process."""
    res = run_workers(tmp_path, "adafactor", dict(kind="adafactor", dp=dp, fsdp=fsdp, tp=tp, spec=spec),
                      dp * fsdp * tp)
    for r in res.values():
        assert r["factored"]
        assert r["max_abs_err"] <= 1e-6 * r["max_abs"], r


def test_cli_on_two_processes_writes_one_checkpoint_that_restores_in_one(tmp_path):
    """python -m mobi_tpu_torch.train with --num_processes 2 --fsdp 2 on the
    tiny YAML: 2 steps, validation and a save at 2 on every rank, rank 0
    alone writing (one run directory, its metrics and checkpoint); the
    ranks log the same global losses; the checkpoint holds whole tensors and
    --resume in one process restores it and trains on."""
    import torch

    from mobi_tpu_torch import checkpoint as tckpt
    from mobi_tpu_torch import train
    from mobi_tpu_torch.data.synthetic import build_synthetic_database
    from tests.test_torch_train_cli import COMMON, cli_cond_stage, tiny_yaml

    db = build_synthetic_database(str(tmp_path / "db"), seed=0)
    path = tiny_yaml(tmp_path / "tiny.yaml", db)
    logs = tmp_path / "logs"
    argv = ["--base", path, "--logdir", str(logs), "--max_steps", "2", "--fsdp", "2"] + COMMON
    res = run_workers(tmp_path, "cli", dict(kind="cli", argv=argv), 2, timeout=400)
    assert res[0]["losses"] == res[1]["losses"] and len(res[0]["losses"]) == 2
    assert all(np.isfinite(res[0]["losses"])) and res[0]["world"] == 2
    assert res[0]["logdir"] == res[1]["logdir"] and os.listdir(logs) == [os.path.basename(res[0]["logdir"])]
    records = [json.loads(line) for line in open(os.path.join(res[0]["logdir"], "metrics.jsonl"))]
    assert [r["train/loss"] for r in records if "train/loss" in r] == res[0]["losses"]
    assert [r["step"] for r in records if "val/loss_simple" in r] == [2]
    ckpt_dir = res[0]["ckpt_dir"]
    assert tckpt.CheckpointManager(ckpt_dir).all_steps() == [2]
    saved = tckpt.read_step(os.path.join(ckpt_dir, "2"))
    restored = {}
    restore = tckpt.CheckpointManager.restore

    def spy(self, step=None, state=None):
        out = restore(self, step, state)
        restored.update(model={k: v.clone() for k, v in state.model.state_dict().items()},
                        ema={k: v.clone() for k, v in state.ema.shadow.items()},
                        inner={i: {k: v.clone() for k, v in st.items()}
                               for i, st in state.opt.inner.state_dict()["state"].items()}, step=state.step)
        return out

    tckpt.CheckpointManager.restore = spy
    try:
        stats = train.main(["--resume", res[0]["logdir"], "--max_steps", "3"] + COMMON,
                           cond_stage_model=cli_cond_stage())
    finally:
        tckpt.CheckpointManager.restore = restore
    assert stats["step"] == 3 and restored["step"] == 2
    for k, v in saved["model"].items():
        assert torch.equal(restored["model"][k], v), k
    for k, v in saved["ema"]["shadow"].items():
        assert torch.equal(restored["ema"][k], v), k
    for i, st in saved["optimizer"]["inner"]["state"].items():
        for key, v in st.items():
            assert torch.equal(restored["inner"][i][key], v), (i, key)


def test_loader_process_slices_reassemble():
    """tests/test_multihost.py:48-76 on the port's loader: the slices of two
    shards concatenate, in shard order, into the one-process batches, and a
    shard's order changes from epoch to epoch."""
    from mobi_tpu_torch.data.loader import PrefetchLoader

    data = [{"x": np.full((3,), i, np.float32)} for i in range(37)]
    ref = PrefetchLoader(data, 8, shuffle=True, seed=5, num_threads=1)
    shards = [PrefetchLoader(data, 4, shuffle=True, seed=5, num_threads=1, shard_index=i, num_shards=2)
              for i in range(2)]
    assert len(ref) == len(shards[0]) == len(shards[1]) == 4
    for ref_b, b0, b1 in zip(iter(ref), iter(shards[0]), iter(shards[1])):
        np.testing.assert_array_equal(np.concatenate([b0["x"], b1["x"]]), ref_b["x"])
    ld = PrefetchLoader([{"x": np.float32([i])} for i in range(16)], 4, shuffle=True, seed=1, num_threads=1,
                        shard_index=1, num_shards=2)
    e1 = np.concatenate([b["x"] for b in ld]).ravel()
    e2 = np.concatenate([b["x"] for b in ld]).ravel()
    assert not np.array_equal(e1, e2)
