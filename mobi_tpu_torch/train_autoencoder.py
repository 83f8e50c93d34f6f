"""Range-VAE adapter finetuning with the GAN loss (scripts/train_autoencoder.py
of the JAX package; the reference's finetune path, autoencoder.py:96-147):

  python -m mobi_tpu_torch.train_autoencoder --base configs/range_autoencoder.yaml \\
      [--pretrained_model VAE.ckpt] [--max_steps N] [--log_every 50] [--save_every 1000] \\
      [--logdir logs] [--seed 23] [--platform cpu] [name.dotted.key=value ...]

Only the VAE parameters whose name holds "lidar" (the lidar adapter: the
encoder's conv_in_lidar and res_block_lidar{1,2}, the decoder's
res_block_lidar{1,2}, norm_out_lidar{1,2} and conv_out_lidar) train, with
Adam(0.5, 0.9) at base_learning_rate x batch_size; the rest of the VAE and
the loss's logvar stay as they are. The discriminator trains with its own
Adam. A step runs the generator first (its GAN term scored by the
discriminator before this step's update, weighted adaptively on the
decoder's last conv and gated off until `disc_start` steps), then the
discriminator on the generator's reconstruction, detached.

`--pretrained_model` takes a bare AutoencoderKL state dict, a whole model's
(`first_stage_model.` stripped, as the JAX script does), or a Lightning
.ckpt of either; a Stable Diffusion VAE lacks the adapter, which keeps its
seeded init. A run writes <logdir>/<time>_range_autoencoder/metrics.jsonl
(every --log_every steps) and checkpoints/<step>/{vae,loss}.pt
(checkpoint.CheckpointManager: the latest 5, every --save_every steps and at
the end). CUDA unless `--platform cpu`; `precision: fp32` turns TF32 off.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from datetime import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mobi_tpu_torch.checkpoint import CheckpointManager
from mobi_tpu_torch.convert import load_torch_checkpoint
from mobi_tpu_torch.data.loader import PrefetchLoader
from mobi_tpu_torch.models.diffusion import resolve_device
from mobi_tpu_torch.models.losses import LidarWithDiscriminator, LPIPSWithDiscriminator
from mobi_tpu_torch.models.vae import AutoencoderKL, autoencoder_from_config
from mobi_tpu_torch.utils.config import instantiate_from_config, load_config

# what a strict=False load of a VAE checkpoint may leave: the adapter (absent
# from a Stable Diffusion VAE) ...
ADAPTER_PREFIXES = ("encoder.conv_in_lidar.", "encoder.res_block_lidar1.", "encoder.res_block_lidar2.",
                    "decoder.res_block_lidar1.", "decoder.res_block_lidar2.", "decoder.norm_out_lidar1.",
                    "decoder.norm_out_lidar2.", "decoder.conv_out_lidar.")
# ... and what import_vae leaves unread in one: a reference checkpoint's
# loss, and the heads the adapter replaces
UNREAD_PREFIXES = ("loss.", "encoder.conv_in.", "decoder.norm_out.", "decoder.conv_out.")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--base", nargs="*", required=True)
    p.add_argument("--pretrained_model", default=None)
    p.add_argument("--logdir", default="logs")
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--save_every", type=int, default=1000)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--platform", default=None, choices=["cpu"],
                   help="run on the CPU (the plain PyTorch path) instead of the CUDA device")
    return p.parse_known_args(argv)


def build_loss(lossconfig: Dict[str, Any], in_channels: int, seed: int) -> LidarWithDiscriminator:
    """The loss class the target names: LPIPS in it picks the camera loss
    (contperceptual.py), else the range loss (lidarperceptual.py), the
    discriminator's input channels the VAE's."""
    cls = LPIPSWithDiscriminator if "LPIPS" in lossconfig.get("target", "") else LidarWithDiscriminator
    return cls(**{**dict(lossconfig.get("params") or {}), "disc_in_channels": in_channels, "seed": seed})


def load_pretrained(vae: AutoencoderKL, path: str) -> Dict[str, List[str]]:
    """A VAE checkpoint into `vae`, strict=False, its dtypes kept. The keys
    left missing must be none or exactly the adapter's, the unexpected ones
    only those import_vae leaves unread; anything else raises. Returns
    {"missing", "unexpected"}."""
    sd = load_torch_checkpoint(path)
    bare = "encoder.conv_in.weight" in sd or "encoder.conv_in_lidar.weight" in sd
    if not bare:
        sd = {k[len("first_stage_model."):]: v for k, v in sd.items() if k.startswith("first_stage_model.")}
    own = vae.state_dict()
    res = vae.load_state_dict({k: torch.as_tensor(v).to(own[k].dtype) if k in own else torch.as_tensor(v)
                               for k, v in sd.items()}, strict=False)
    adapter = {k for k in own if k.startswith(ADAPTER_PREFIXES)}
    missing, unexpected = set(res.missing_keys), set(res.unexpected_keys)
    if missing and missing != adapter:
        raise ValueError(f"{path}: missing {sorted(missing - adapter) or sorted(adapter - missing)[:8]}; "
                         "a VAE checkpoint may lack only the whole lidar adapter")
    stray = sorted(k for k in unexpected if not k.startswith(UNREAD_PREFIXES))
    if stray:
        raise ValueError(f"{path}: unexpected keys {stray[:8]}")
    return {"missing": sorted(missing), "unexpected": sorted(unexpected)}


def trainable_names(vae: AutoencoderKL) -> List[str]:
    """The adapter: every parameter whose name holds "lidar" (the JAX
    script's mask on its parameter paths)."""
    return [n for n, _ in vae.named_parameters() if "lidar" in n]


class GanStep:
    """One generator and one discriminator update (scripts/train_autoencoder
    .py:184-196 of the JAX package); `__call__(x, step, noise=None)` ->
    logs as device tensors. `noise` replaces the posterior's N(0, 1) draw."""

    def __init__(self, vae: AutoencoderKL, loss: LidarWithDiscriminator, lr: float,
                 generator: Optional[torch.Generator] = None):
        self.vae, self.loss, self.generator = vae, loss, generator
        names = set(trainable_names(vae))
        for n, p in vae.named_parameters():
            p.requires_grad_(n in names)
        # the adaptive weight differentiates the last kernel, trained or not
        vae.last_layer().requires_grad_(True)
        self.params = [p for n, p in vae.named_parameters() if n in names]
        self.opt_g = torch.optim.Adam(self.params, lr=lr, betas=(0.5, 0.9), eps=1e-8) if self.params else None
        self.opt_d = torch.optim.Adam(loss.discriminator.parameters(), lr=lr, betas=(0.5, 0.9), eps=1e-8)

    def __call__(self, x: torch.Tensor, step: int, noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        vae, loss = self.vae, self.loss
        posterior = vae.encode(x)
        z = posterior.sample(self.generator) if noise is None else posterior.mean + posterior.std * noise
        rec = vae.decode(z)
        total, log = loss.generator_loss(x, rec, posterior, step, last_layer=vae.last_layer())
        if self.opt_g is not None:
            for p, g in zip(self.params, torch.autograd.grad(total, self.params)):
                p.grad = g
            self.opt_g.step()
            self.opt_g.zero_grad(set_to_none=True)
        d_loss, dlog = loss.discriminator_loss(x, rec, step)
        self.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        self.opt_d.step()
        return {k: v.detach() for k, v in {**log, **dlog}.items()}


def range_batch(batch, device) -> torch.Tensor:
    """The range views of a collated batch, NHWC on the host -> NCHW."""
    return torch.as_tensor(np.asarray(batch["lidar"]["range_data"])).permute(0, 3, 1, 2).contiguous().to(device)


def main(argv=None) -> Dict[str, Any]:
    """Train. Returns {"logdir", "ckpt_dir", "step", "step_s" (the host wall
    of each step, synchronised), "history" (each step's logs as floats),
    "lr", "trainable", "pretrained" (load_pretrained's keys, or None)}."""
    args, overrides = parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    cfg = load_config(args.base, [s for s in overrides if "=" in s])
    mp = cfg["model"]["params"]
    dd = mp["ddconfig"]
    if device.type == "cuda" and cfg.get("precision", "fp32") == "fp32":
        # fp32 convs and matmuls in full fp32 (cuDNN defaults convs to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(args.seed)
    with torch.device(device):
        vae = autoencoder_from_config(**mp)
    vae.init_random_(args.seed)
    loss = build_loss(mp.get("lossconfig", {}), dd["in_channels"], args.seed).to(device)
    pretrained = None
    if args.pretrained_model:
        pretrained = load_pretrained(vae, args.pretrained_model)
        print(f"initialized VAE from {args.pretrained_model}")

    base_lr = cfg["model"].get("base_learning_rate", 4.5e-6)
    bs = cfg["data"]["params"].get("batch_size", 4)
    lr = base_lr * bs  # the reference scales the autoencoder's lr by the batch size
    gen = torch.Generator(device=device).manual_seed(args.seed)
    step_fn = GanStep(vae, loss, lr, gen)

    ds = instantiate_from_config(cfg["data"]["params"]["train"])
    loader = PrefetchLoader(ds, bs, num_threads=args.num_workers, seed=args.seed)
    now = datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
    logdir = os.path.join(args.logdir, f"{now}_range_autoencoder")
    ckpt_dir = os.path.join(logdir, "checkpoints")
    mgr = CheckpointManager(ckpt_dir)
    metrics_path = os.path.join(logdir, "metrics.jsonl")
    os.makedirs(logdir, exist_ok=True)

    def save(step):
        mgr.save(step, {"vae": vae.state_dict(), "loss": loss.state_dict()})

    step, step_s, history = 0, [], []
    max_steps = args.max_steps or 10**12
    while step < max_steps:
        for batch in loader:
            x = range_batch(batch, device)
            t0 = time.perf_counter()
            log = step_fn(x, step)
            rec = {k: float(v) for k, v in log.items()}  # waits for the step
            step_s.append(time.perf_counter() - t0)
            history.append(rec)
            step += 1
            if step % args.log_every == 0:
                with open(metrics_path, "a") as f:
                    f.write(json.dumps({**rec, "step": step}) + "\n")
                print(f"step {step} total {rec.get('train/total_loss'):.4f} rec {rec.get('train/rec_loss'):.4f}")
            if step % args.save_every == 0:
                save(step)
            if step >= max_steps:
                break
    save(step)
    mgr.wait()
    print(f"done; checkpoints in {logdir}")
    return {"logdir": logdir, "ckpt_dir": ckpt_dir, "step": step, "step_s": step_s, "history": history,
            "lr": lr, "trainable": trainable_names(vae), "pretrained": pretrained}


if __name__ == "__main__":
    main()
