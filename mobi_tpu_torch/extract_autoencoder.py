"""Extract one model's weights from a checkpoint (scripts/extract_autoencoder.py
of the JAX package; the reference's scripts/extract_autoencoder.py):

  python -m mobi_tpu_torch.extract_autoencoder --ckpt CKPT --out vae.pt [--subtree vae]

CKPT is a checkpoint directory of the port (a manager directory, its latest
step, or one step directory): the training CLI's, or train_autoencoder's,
whose `vae` part is the subtree `vae`; or a Lightning .ckpt; or a torch
state-dict file. `--subtree` vae | lidar_vae | unet picks the weights under
first_stage_model. | lidar_stage_model. | model.diffusion_model.; the output
is a torch file of them with the prefix stripped, which
`AutoencoderKL.load_state_dict(strict=True)` (or the UNet's) takes, and so
does `train_autoencoder --pretrained_model`.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

import torch

SUBTREES = {"vae": "first_stage_model.", "lidar_vae": "lidar_stage_model.", "unet": "model.diffusion_model."}


def read_subtree(path: str, subtree: str) -> Dict[str, torch.Tensor]:
    """The weights of `subtree` in the checkpoint at `path`, prefix stripped,
    in their saved dtypes."""
    from mobi_tpu_torch.checkpoint import CheckpointManager, is_step_dir, read_step

    if subtree not in SUBTREES:
        raise ValueError(f"--subtree {subtree!r}: one of {sorted(SUBTREES)}")
    if os.path.isdir(path):
        step_dir = os.path.normpath(path)
        if not is_step_dir(step_dir):
            latest = CheckpointManager(step_dir).latest_step()
            if latest is None:
                raise ValueError(f"{path} holds no checkpoint written by mobi_tpu_torch")
            step_dir = os.path.join(step_dir, str(latest))
        got = read_step(step_dir, parts=("model", "vae"))
        if got["vae"] is not None:  # train_autoencoder's: {vae, loss}
            if subtree != "vae":
                raise ValueError(f"{step_dir} is an autoencoder checkpoint: it holds only --subtree vae")
            return got["vae"]
        sd = got["model"]
    else:
        from mobi_tpu_torch.convert import torch_state_dict

        sd = torch_state_dict(path)
    prefix = SUBTREES[subtree]
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    if not out:
        raise ValueError(f"{path} holds no {prefix}* weights")
    return out


def main(argv=None) -> Dict[str, torch.Tensor]:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="checkpoint directory of the port, Lightning .ckpt or torch file")
    p.add_argument("--out", required=True)
    p.add_argument("--subtree", default="vae", help="vae | lidar_vae | unet")
    args = p.parse_args(argv)
    sd = read_subtree(args.ckpt, args.subtree)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(sd, args.out)
    n = sum(v.numel() for v in sd.values())
    print(f"wrote {args.out}: subtree '{args.subtree}', {n / 1e6:.1f}M params")
    return sd


if __name__ == "__main__":
    main()
