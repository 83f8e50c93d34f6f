"""Training entry point of the port (train.py of the JAX package):

  python -m mobi_tpu_torch.train --base configs/mobi_nusc_512.yaml \\
      model.params.scheduler_config.target=ldm.lr_scheduler.LambdaLinearScheduler \\
      [--pretrained_model model.ckpt] [--resume LOGDIR] [--seed 23] [--scale_lr] \\
      [--max_steps N] [--logdir logs] [--platform cpu] [name.dotted.key=value ...]

The JAX CLI's flags and dotted overrides: CUDA unless `--platform cpu`. The
shipped configs name their LR schedule
`mobi_tpu.training.lambda_linear_schedule`, which neither package knows
(`training.schedule_from_config` raises, as the JAX package's does, before
the model is built); the override above names the reference's class.

A run writes under <logdir>/<time>_<name>/: configs/merged.yaml,
metrics.jsonl (and the config's `lightning.logger` backend),
checkpoints/<step>/ (checkpoint.CheckpointManager: top `--save_top_k` by
the config's `monitor`, lower is better) and images/ (PNG collages where
the JAX package writes JPEGs, under the same stems). `--resume LOGDIR`
reads the configs there and restores the latest checkpoint: the model, the
optimizer, the EMA shadow and the step.

MOBI_RANDOMIZE_ZERO_INIT=1 perturbs every all-zero >= 2-D parameter (the
reference zero-initialises each residual branch's output, which leaves a
model trained from scratch without a gradient); MOBI_TRAIN_BF16_FROZEN=0
keeps the frozen >= 2-D weights of a bf16 model in fp32.

Multi-process runs, one process a card (the reference's DDP): launch N
ranks with torchrun (`torchrun --nproc_per_node N -m mobi_tpu_torch.train
...`) or each with `--coordinator HOST:PORT --num_processes N --process_id
I`. `--fsdp K` shards the parameters, the moments and the EMA over K of
them (the rest is dp). Each rank loads its contiguous slice of the global
batch (`batch_size` a rank), rank 0 logs and writes the files, and
`--scale_lr` counts the world size. Ranks that share one card need gloo:
MOBI_DIST_BACKEND=gloo (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import threading
import time
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np
import torch

from mobi_tpu_torch import convert
from mobi_tpu_torch.checkpoint import CheckpointManager, install_crash_save, restore_partial
from mobi_tpu_torch.data.image_io import write_png
from mobi_tpu_torch.data.loader import PrefetchLoader
from mobi_tpu_torch.eval.lidar_metrics import lidar_sample_metrics
from mobi_tpu_torch.models.diffusion import MobiDiffusion, resolve_device
from mobi_tpu_torch.parallel import distributed as pdist
from mobi_tpu_torch.parallel.mesh import all_gather_rows, create_mesh, mean_over_batch, shard_batch
from mobi_tpu_torch.training import (blockwise, create_train_state, gathered, lambda_linear_schedule,
                                     make_train_step, params_with_ema, randomize_zero_init, schedule_from_config)
from mobi_tpu_torch.utils import hbm
from mobi_tpu_torch.utils.config import instantiate_from_config, load_config, mobi_config_from_yaml
from mobi_tpu_torch.utils.loggers import NullLogger, logger_from_config
from mobi_tpu_torch.viz import camera_log_collage, range_log_collage


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", nargs="*", default=[], help="base config yaml(s)")
    p.add_argument("--pretrained_model", default=None,
                   help="reference .ckpt / torch file, or a checkpoint directory of the port, to start from")
    p.add_argument("--resume", default=None, help="logdir to resume from")
    p.add_argument("--logdir", default="logs")
    p.add_argument("--name", default=None)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--scale_lr", action="store_true")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--val_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--image_log_every", type=int, default=400,
                   help="sampled image/range collage frequency (the reference ImageLogger's batch_frequency)")
    p.add_argument("--image_log_steps", type=int, default=20, help="sampler steps for logged images")
    p.add_argument("--image_log_max", type=int, default=2, help="max (camera, lidar) pairs per collage dump")
    p.add_argument("--save_top_k", type=int, default=5)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--loader_procs", type=int, default=0,
                   help="spawned process loader workers; 0 = thread workers")
    p.add_argument("--fsdp", type=int, default=1,
                   help="shard parameters, moments and the EMA over N ranks (the rest of the world is dp)")
    p.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"],
                   help="adamw = reference parity (AdamW); adafactor = factored second moment")
    p.add_argument("--platform", default=None, choices=["cpu"],
                   help="run on the CPU (the plain PyTorch path) instead of the CUDA device")
    p.add_argument("--coordinator", default=None,
                   help="multi-process rendezvous HOST:PORT (torchrun's MASTER_ADDR/MASTER_PORT when unset)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace of steps 10-15 into this directory "
                        "(tensorboard-compatible)")
    args, unknown = p.parse_known_args(argv)
    return args, unknown


def build_datasets(cfg, split_keys=("train", "validation")):
    data_params = cfg["data"]["params"]
    out = {}
    for k in split_keys:
        if k in data_params and data_params[k]:
            out[k] = instantiate_from_config(data_params[k])
    return out, data_params.get("batch_size", 2)


def strip_host_fields(batch):
    """The arrays of a collated batch that the training step reads."""
    keep_img = {"GT", "inpaint_image", "inpaint_mask", "cond"}
    keep_lid = {"range_data", "range_data_inpaint", "range_mask", "cond"}
    out = {
        "image": {k: v for k, v in batch["image"].items() if k in keep_img},
        "lidar": {k: v for k, v in batch["lidar"].items() if k in keep_lid},
    }
    out["image"]["cond"] = dict(batch["image"]["cond"])
    out["lidar"]["cond"] = {"ref_bbox": batch["lidar"]["cond"]["ref_bbox"]}
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _head(tree, n: int):
    return _map(lambda x: x[:n], tree)


def main(argv=None, cond_stage_model: Optional[torch.nn.Module] = None) -> Dict[str, Any]:
    """Train. `cond_stage_model` replaces the default ViT-L/14 conditioning
    stage (its weights seeded with the model's). Returns {"logdir",
    "ckpt_dir", "step", "step_s" (host seconds of each step call),
    "preflight" (the first step's memory record, or None), "profile"
    ({"dir", "wall_s"} of the traced steps, or None), "epochs", "losses"
    (each logged train/loss), "resident_bytes" (CUDA memory_allocated once
    the state is placed and after the first step), "world"}."""
    args, overrides = parse_args(argv)
    # join the process group before anything touches the card
    platform = "cpu" if args.platform == "cpu" else None
    pdist.initialize(args.coordinator, args.num_processes, args.process_id, device=platform)
    device = pdist.local_device() or resolve_device(platform)
    cuda = device.type == "cuda"
    rank0, nproc = pdist.is_main_process(), pdist.process_count()
    if args.fsdp > 1 and nproc == 1:
        raise ValueError(f"--fsdp {args.fsdp} shards over ranks: launch {args.fsdp} x dp processes "
                         "(torchrun, or --coordinator / --num_processes / --process_id)")
    if nproc > 1:
        print(f"multi-process run: process {pdist.process_index()}/{nproc}")

    if args.resume:
        logdir = args.resume
        cfg_dir = os.path.join(logdir, "configs")
        bases = sorted(os.path.join(cfg_dir, f) for f in os.listdir(cfg_dir) if f.endswith(".yaml"))
        cfg = load_config(bases, overrides)
    else:
        cfg = load_config(args.base, overrides)
        now = datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        if nproc > 1:  # rank 0's clock names the run for every rank
            box = [now]
            torch.distributed.broadcast_object_list(box, src=0)
            now = box[0]
        name = args.name or os.path.splitext(os.path.basename(args.base[0]))[0]
        logdir = os.path.join(args.logdir, f"{now}_{name}")
        if rank0:
            os.makedirs(os.path.join(logdir, "configs"), exist_ok=True)
            os.makedirs(os.path.join(logdir, "checkpoints"), exist_ok=True)
            import yaml

            with open(os.path.join(logdir, "configs", "merged.yaml"), "w") as f:
                yaml.safe_dump(cfg, f)
        pdist.barrier("logdir")

    mcfg = mobi_config_from_yaml(cfg)
    # the trainer section of the config (the reference Trainer's): the CLI overrides it
    if args.max_epochs is None:
        args.max_epochs = cfg.get("trainer", {}).get("max_epochs")
    if args.max_steps is None and cfg.get("trainer", {}).get("max_steps"):
        args.max_steps = int(cfg["trainer"]["max_steps"])

    mp = cfg["model"]["params"]
    base_lr = cfg["model"].get("base_learning_rate", 8.0e-5)
    datasets, batch_size = build_datasets(cfg)
    n_devices = nproc  # one card a rank
    if args.scale_lr:
        base_lr = args.accumulate_grad_batches * n_devices * batch_size * base_lr
        print(f"LR scaled to {base_lr} "
              f"(accum {args.accumulate_grad_batches} x dev {n_devices} x bs {batch_size})")
    # before the model: the shipped configs' target raises here, as in the JAX package
    sched_cfg = mp.get("scheduler_config")
    schedule = schedule_from_config(base_lr, sched_cfg) if sched_cfg else lambda_linear_schedule(base_lr)

    # the from-scratch model the JAX package's init gives: seeded weights
    # and the layers the reference zero-initialises at zero
    model = MobiDiffusion(mcfg, device=device, seed=args.seed, cond_stage_model=cond_stage_model,
                          for_training=True)
    model.zero_init_reference_layers_()
    use_ema = bool(mp.get("use_ema", False))
    # a multi-process run shards the state on a dp x fsdp mesh (JAX train.py:273-279)
    mesh = create_mesh(fsdp=args.fsdp) if nproc > 1 else None
    state, tx = create_train_state(model, base_lr, use_ema=use_ema, accumulate_steps=args.accumulate_grad_batches,
                                   optimizer=args.optimizer, schedule=schedule, device=device, mesh=mesh)

    ckpt_dir = os.path.join(logdir, "checkpoints")
    # best-checkpoint selection key (the reference ModelCheckpoint's monitor)
    monitor = mp.get("monitor", "val/loss_simple")
    mgr = CheckpointManager(ckpt_dir, max_to_keep=args.save_top_k, monitor=monitor)
    resumed = bool(args.resume) and mgr.latest_step() is not None
    if resumed:
        mgr.restore(state=state)
        print(f"Resumed from step {state.step}")
    # on a mesh the loads and knobs below see whole (gathered) parameters and
    # leave each rank its pieces
    with gathered(model):
        if not resumed:
            # lidar_stage_config.params.ckpt_path loads at construction in the
            # reference, before any --pretrained_model overlay
            convert.import_lidar_stage_from_config(cfg, model)
        if not resumed and args.pretrained_model:
            print(f"Loading pretrained weights from {args.pretrained_model}")
            if os.path.isdir(args.pretrained_model):
                convert.load_checkpoint(model, args.pretrained_model)
            else:
                restore_partial(model, convert.load_torch_checkpoint(args.pretrained_model))

        if os.environ.get("MOBI_RANDOMIZE_ZERO_INIT", "0") == "1":
            randomize_zero_init(model, args.seed)
            print("zero-init leaves randomized (MOBI_RANDOMIZE_ZERO_INIT)")
        if mcfg.dtype == torch.bfloat16 and os.environ.get("MOBI_TRAIN_BF16_FROZEN", "1") != "1":
            mask = model.trainable_mask()
            for name, p in model.named_parameters():
                if not mask[name] and p.dim() >= 2:
                    p.data = p.data.float()

    resident = {}
    if cuda:
        torch.cuda.synchronize(device)
        resident["placed"] = torch.cuda.memory_allocated(device)
        print(f"device mem after params+opt transfer: {resident['placed'] / 2**30:.2f} GiB "
              f"in use / {torch.cuda.mem_get_info(device)[1] / 2**30:.2f} GiB", flush=True)
    step_fn = make_train_step(model, tx, device=device, mesh=mesh)

    workers = max(1, min(args.num_workers, os.cpu_count() or 1))
    # each rank's contiguous slice of the shared seed-determined global batch
    shard_kw = dict(shard_index=mesh.batch_index, num_shards=mesh.batch_shards) if mesh is not None else {}
    n_shards = mesh.batch_shards if mesh is not None else 1
    train_loader = PrefetchLoader(datasets["train"], batch_size, shuffle=True, num_threads=workers,
                                  seed=args.seed, num_procs=args.loader_procs, **shard_kw)
    val_loader = (PrefetchLoader(datasets["validation"], batch_size, shuffle=False, num_threads=workers,
                                 num_procs=args.loader_procs, **shard_kw)
                  if "validation" in datasets else None)
    # rank 0 logs; the other ranks' stack swallows everything
    metrics_logger = logger_from_config(cfg, logdir) if rank0 else NullLogger()

    def save_state(step, metrics=None):
        mgr.save(step, state, metrics=metrics)  # every rank: the gather is a collective

    crash_saved = {"done": False}

    def crash_save():
        if not crash_saved["done"]:
            try:
                save_state(state.step)
                mgr.wait()
                print("crash checkpoint written")
            except Exception as e:
                print(f"crash-save skipped: {e}")
            crash_saved["done"] = True

    # signal handlers can only be set from the main thread; the previous ones
    # come back when main returns
    handlers = None
    if threading.current_thread() is threading.main_thread():
        handlers = install_crash_save(crash_save)

    image_logger = ImageLogger(model, mcfg, logdir, every=args.image_log_every, sample_steps=args.image_log_steps,
                               max_items=args.image_log_max, metrics_logger=metrics_logger, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    stats: Dict[str, Any] = {"logdir": logdir, "ckpt_dir": ckpt_dir, "step_s": [], "preflight": None,
                             "profile": None, "epochs": [], "losses": [], "resident_bytes": resident,
                             "world": nproc}
    prep = (lambda b: shard_batch(mesh, strip_host_fields(b), local=True)) if mesh is not None else strip_host_fields
    step = state.step
    max_steps = args.max_steps or (10**12)
    epoch = 0
    t_last = t_epoch = t_step = time.time()
    preflighted = False
    prof = None
    try:
        while step < max_steps and (args.max_epochs is None or epoch < args.max_epochs):
            for batch in train_loader:
                batch_dev = prep(batch)
                if args.profile_dir and step == 10 and rank0:
                    prof = _start_profile(device, args.profile_dir)
                    t_prof = time.perf_counter()
                if not preflighted and cuda:
                    # the memory pre-flight of the first step (the JAX
                    # package checks the compiled step before its first
                    # call; CUDA has no plan, so the step is measured)
                    preflighted = True
                    (state, m), record = hbm.measure(lambda: step_fn(state, batch_dev, gen), device)
                    stats["preflight"] = vars(record)
                    if hbm.assert_fits(record, device, label="train step"):
                        print("HBM pre-flight ok (train step)", flush=True)
                else:
                    state, m = step_fn(state, batch_dev, gen)
                if cuda and "after_first_step" not in resident:
                    torch.cuda.synchronize(device)
                    resident["after_first_step"] = torch.cuda.memory_allocated(device)
                if prof is not None and step == 15:
                    if cuda:
                        torch.cuda.synchronize(device)
                    stats["profile"] = {"dir": args.profile_dir, "wall_s": time.perf_counter() - t_prof}
                    prof.stop()
                    prof = None
                    print(f"profiler trace written to {args.profile_dir}")
                step += 1
                now = time.time()
                stats["step_s"].append(now - t_step)
                if step % args.image_log_every == 0:
                    image_logger.maybe_log(state, batch, strip_host_fields, step, gen)
                if step % args.log_every == 0:
                    m = {k: float(v) for k, v in m.items()}
                    dt = time.time() - t_last
                    t_last = time.time()
                    # the global batch: every rank's slice
                    m.update(step=step, epoch=epoch, imgs_per_sec=args.log_every * batch_size * n_shards / dt)
                    metrics_logger.log({f"train/{k}" if "/" not in k else k: v for k, v in m.items()})
                    stats["losses"].append(m["loss"])
                    if rank0:
                        print(f"step {step} loss {m.get('loss'):.4f} ({m['imgs_per_sec']:.2f} img/s)")
                if step % args.val_every == 0 and val_loader is not None:
                    vm = validate(model, state, val_loader, strip_host_fields, gen, mesh=mesh)
                    metrics_logger.log(vm, step=step)
                    save_state(step, metrics=vm)
                elif step % args.save_every == 0:
                    save_state(step, metrics={monitor: float(m.get("loss_simple", 0))})
                t_step = time.time()
                if step >= max_steps:
                    break
            epoch += 1
            # epoch wall and device memory (the reference's CUDACallback)
            epoch_rec = {"train/epoch": epoch, "train/epoch_time_s": time.time() - t_epoch, "step": step}
            if cuda:
                epoch_rec["train/peak_device_mem_mb"] = torch.cuda.max_memory_allocated(device) / 2**20
            metrics_logger.log(epoch_rec)
            stats["epochs"].append(epoch_rec)
            if rank0:
                print(f"epoch {epoch} done in {epoch_rec['train/epoch_time_s']:.1f}s")
            t_epoch = time.time()
    except Exception:
        crash_save()
        raise
    finally:
        if prof is not None:
            prof.stop()
        for sig, handler in (handlers or {}).items():
            signal.signal(sig, handler)
    try:
        save_state(step)
    except KeyError as e:
        # The JAX package's CheckpointManager hands orbax {} for a save
        # without metrics, and orbax's ranking then raises once more than
        # save_top_k checkpoints exist (ROADMAP queue 3): the step is written
        # and nothing is deleted. The port's manager keeps that; the CLI
        # warns where the JAX CLI ends in the traceback.
        print(f"WARNING: the final checkpoint of step {step} was written without metrics; ranking "
              f"the checkpoints by {e} raised KeyError, so none was deleted")
    mgr.wait()
    metrics_logger.close()
    pdist.barrier("train_done")
    if rank0:
        print(f"training done at step {step}; checkpoints in {ckpt_dir}")
    stats["step"] = step
    return stats


def _start_profile(device, profile_dir: str):
    """A torch.profiler trace of the device's activity, written as a
    TensorBoard trace file under `profile_dir` when stopped."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    prof = profile(activities=[activity], on_trace_ready=tensorboard_trace_handler(profile_dir))
    prof.start()
    return prof


@torch.no_grad()
def validate(model: MobiDiffusion, state, val_loader, strip, generator: torch.Generator, num_batches: int = 8,
             t_draws: int = 4, mesh=None) -> Dict[str, float]:
    """The validation loss averaged over `t_draws` draws of t, noise, the
    encode samples and the CFG drop a batch, over at most `num_batches`
    batches: `val/loss_simple` with the live weights and
    `val/loss_simple_ema` with the EMA weights on the same draws (equal to
    the live one without an EMA, which it does not recompute). On a mesh
    every rank runs its slice of each batch, the draws in lockstep, and the
    means are the global batch's."""
    batches, draws = [], []
    for i, batch in enumerate(val_loader):
        if i >= num_batches:
            break
        batches.append(strip(batch) if mesh is None else shard_batch(mesh, strip(batch), local=True))

    def multi_t_loss(m, b):
        with contextlib.nullcontext() if mesh is None else mesh.batch_shard():
            loss = torch.stack([m.training_loss(b, generator)[1]["loss_simple"] for _ in range(t_draws)]).mean()
        return float(loss if mesh is None else mean_over_batch(mesh, {"l": loss})["l"])

    # one EMA swap for all batches (a sharded model gathers block by block);
    # each batch's draws are the same for both weights
    losses, losses_ema = [], []
    with blockwise(model):
        for b in batches:
            draws.append(generator.get_state())
            losses.append(multi_t_loss(model, b))
    if state.ema is not None:
        end = generator.get_state()
        with params_with_ema(state) as ema_model:
            for b, start in zip(batches, draws):
                generator.set_state(start)
                losses_ema.append(multi_t_loss(ema_model, b))
        generator.set_state(end)
    live = float(np.mean(losses)) if losses else float("nan")
    ema = float(np.mean(losses_ema)) if losses_ema else live
    return {"val/loss_simple": live, "val/loss_simple_ema": ema}


class ImageLogger:
    """Sampled collages and the lidar metrics of the first `max_items` pairs
    of a training batch every `every` steps (the reference's ImageLogger and
    log_images): PLMS with `sample_steps` steps at guidance 1 under the EMA
    weights, written as PNGs under <logdir>/images."""

    def __init__(self, model: MobiDiffusion, mcfg, logdir: str, every: int = 400, sample_steps: int = 20,
                 max_items: int = 2, metrics_logger=None, mesh=None):
        self.model, self.mcfg, self.mesh = model, mcfg, mesh
        self.dir = os.path.join(logdir, "images")
        self.every = max(int(every), 1)
        self.steps, self.max_items = sample_steps, max_items
        self.metrics_logger = metrics_logger

    @torch.no_grad()
    def maybe_log(self, state, batch, strip, step: int, generator: torch.Generator):
        if step % self.every:
            return None
        n = self.max_items
        small = _head(strip(batch), n)
        mesh = self.mesh
        if mesh is not None:
            # every rank samples n rows (its first ones, tiled when it holds
            # fewer; the collectives need every rank), in lockstep; rank 0's
            # own rows come first in the gathered batch and are the ones shown
            n = min(n, len(batch["image"]["GT"]))
            small = shard_batch(mesh, _map(lambda x: x[np.arange(self.max_items) % x.shape[0]], small), local=True)
        with params_with_ema(state) as model, \
                contextlib.nullcontext() if mesh is None else mesh.batch_shard():
            data = model.get_input(small, generator, encode_cond=True)
            latents = model.sample(data, generator, num_steps=self.steps, guidance_scale=1.0, sampler="plms")
            out = model.decode_sample(latents, data.get("z_lidar_full"), data.get("lidar_geom"))
        if mesh is not None:
            out = {k: v[:n] for k, v in all_gather_rows(mesh, out).items()}
            if not pdist.is_main_process():
                return None
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        os.makedirs(self.dir, exist_ok=True)
        metrics = {}
        if "camera" in out:
            cam = out["camera"]
            for i in range(cam.shape[0]):
                rows = [np.asarray(batch["image"]["GT"][i]), np.asarray(batch["image"]["inpaint_image"][i]), cam[i]]
                write_png(os.path.join(self.dir, f"step{step:08d}_cam{i}.png"), camera_log_collage(rows))
        if "lidar" in out:
            lid = out["lidar"]
            lb = batch["lidar"]
            for i in range(lid.shape[0]):
                for ch, name in ((0, "depth"), (1, "intensity")):
                    collage = range_log_collage(np.asarray(lb["range_data"][i]), np.asarray(lb["range_data_inpaint"][i]),
                                                np.asarray(lb["range_mask"][i]), lid[i], channel=ch)
                    write_png(os.path.join(self.dir, f"step{step:08d}_range_{name}{i}.png"), collage)
            try:
                m = lidar_sample_metrics(
                    pred=lid, gt=np.asarray(lb["range_data"][:n]),
                    instance_mask=np.asarray(lb["range_instance_mask"][:n]),
                    edit_mask=np.asarray(lb["range_mask"][:n]), width_crop=np.asarray(lb["width_crop"][:n]),
                    min_depth_obj=np.asarray(lb["min_depth_obj"][:n]),
                    max_depth_obj=np.asarray(lb["max_depth_obj"][:n]),
                    range_object_norm=self.mcfg.range_object_norm,
                    range_object_norm_scale=self.mcfg.range_object_norm_scale,
                    range_int_norm=self.mcfg.range_int_norm)
                metrics = {f"imagelog/{k}": float(v) for k, v in m.items()}
            except KeyError:
                pass  # host-side fields absent (e.g. synthetic batches)
        if metrics and self.metrics_logger:
            self.metrics_logger.log(metrics, step=step)
        return metrics


if __name__ == "__main__":
    main()
