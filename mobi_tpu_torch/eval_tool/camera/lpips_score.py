"""Mean LPIPS between paired image folders (eval_tool/camera/lpips_score.py
of the JAX package): files paired by sorted name, each image resized to 256
x 256 by cv2's INTER_LINEAR (`imgproc.resize_linear`), scaled to [-1, 1],
compared with AlexNet LPIPS. The realism bench also scores the gray range
PNGs with it (D-LPIPS, I-LPIPS): gray is replicated to RGB.

  python -m mobi_tpu_torch.eval_tool.camera.lpips_score --path_target DIR --path_pred DIR \
      [--lpips_weights lpips_alex.pth] [--alexnet_weights alexnet.pth] [--batch-size 32] [--device cuda]

`--lpips_weights` (or LPIPS_WEIGHTS) is the lpips package's "alex" state
dict, `--alexnet_weights` (or ALEXNET_WEIGHTS) torchvision's alexnet state
dict as published, `classifier.*` included (`eval.lpips.load_published`
reads its `features.*` and leaves the rest). The network runs on the card
unless `--device cpu`, in fp32 with TF32 off for matmuls and cuDNN
convolutions (`eval_tool.metric_scope`). Prints `LPIPS: %.4f`.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mobi_tpu_torch.convert import torch_state_dict
from mobi_tpu_torch.data.image_io import read_image
from mobi_tpu_torch.data.imgproc import resize_linear
from mobi_tpu_torch.eval.lpips import LPIPS, load_published
from mobi_tpu_torch.eval_tool import metric_scope, network, to_device
from mobi_tpu_torch.eval_tool.camera.fid_score import list_images


def load_batch(paths, size: int = 256) -> np.ndarray:
    return np.stack([resize_linear(read_image(p), size, size).astype(np.float32) / 127.5 - 1.0 for p in paths])


def lpips_model(lpips_weights: str, alexnet_weights: str, device) -> LPIPS:
    model = LPIPS()
    load_published(model, torch_state_dict(lpips_weights), torch_state_dict(alexnet_weights))
    return model.eval().to(device)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path_target", required=True)
    p.add_argument("--path_pred", required=True)
    p.add_argument("--lpips_weights", default=os.environ.get("LPIPS_WEIGHTS"))
    p.add_argument("--alexnet_weights", default=os.environ.get("ALEXNET_WEIGHTS"))
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default="cuda", help="the device the network runs on (cpu for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    if not args.lpips_weights or not args.alexnet_weights:
        sys.exit("LPIPS requires weights: --lpips_weights (lpips pkg 'alex' state "
                 "dict) and --alexnet_weights (torchvision alexnet state dict).")
    tfiles = list_images(args.path_target)
    pfiles = list_images(args.path_pred)
    assert len(tfiles) == len(pfiles), "folder sizes differ"
    dists = []
    with metric_scope(args.device) as dev:
        model = network(lpips_model, args.lpips_weights, args.alexnet_weights, dev)
        for i in range(0, len(tfiles), args.batch_size):
            a = to_device(load_batch(tfiles[i:i + args.batch_size]), dev)
            b = to_device(load_batch(pfiles[i:i + args.batch_size]), dev)
            dists.append(model(a, b).cpu().numpy())
    score = float(np.concatenate(dists).mean())
    print(f"LPIPS: {score:.4f}")
    return score


if __name__ == "__main__":
    main()
