"""CLIP similarity score between reference and predicted object crops
(eval_tool/camera/clip_score.py of the JAX package): the cosine similarity
x 100 of the L2-normalised ViT-B/32 embeddings of paired images, paired by
sorted file name.

  python -m mobi_tpu_torch.eval_tool.camera.clip_score --path_ref DIR --path_pred DIR \
      [--weights clip_vit_b32.pth] [--batch-size 32] [--device cuda]

`--weights` (or CLIP_B32_WEIGHTS) is an HF `CLIPModel` state dict. The
network runs on the card unless `--device cpu`, in fp32 with TF32 off for
matmuls and cuDNN convolutions (`eval_tool.metric_scope`). Prints
`CLIP score: %.2f`.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from mobi_tpu_torch.eval_tool import metric_scope, network, to_device
from mobi_tpu_torch.eval_tool.camera.fid_score import clip_model, list_images, load_batch_clip


def embed(model, batch, device) -> torch.Tensor:
    feats = model(to_device(batch, device))
    return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path_ref", required=True)
    p.add_argument("--path_pred", required=True)
    p.add_argument("--weights", default=os.environ.get("CLIP_B32_WEIGHTS"))
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default="cuda", help="the device the network runs on (cpu for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    if not args.weights:
        sys.exit("CLIP score requires --weights (HF CLIP ViT-B/32 state dict).")
    rfiles = list_images(args.path_ref)
    pfiles = list_images(args.path_pred)
    assert len(rfiles) == len(pfiles)
    sims = []
    with metric_scope(args.device) as dev:
        model = network(clip_model, args.weights, dev)
        for i in range(0, len(rfiles), args.batch_size):
            a = embed(model, load_batch_clip(rfiles[i:i + args.batch_size]), dev)
            b = embed(model, load_batch_clip(pfiles[i:i + args.batch_size]), dev)
            sims.append((a * b).sum(-1).cpu().numpy())
    score = float(np.concatenate(sims).mean()) * 100
    print(f"CLIP score: {score:.2f}")
    return score


if __name__ == "__main__":
    main()
