"""Frechet Range Distance between saved range_{orig,pred} npy folders
(eval_tool/lidar/frd_score.py of the JAX package): RangeNet++ darknet53
features of each file at 64 x 1024, then the Frechet distance.

  python -m mobi_tpu_torch.eval_tool.lidar.frd_score --path_orig DIR --path_pred DIR \
      [--backbone-weights darknet53/backbone] [--decoder-weights darknet53/segmentation_decoder] \
      [--batch-size 16] [--device cuda]

The weights (or RANGENET_BACKBONE / RANGENET_DECODER) are the published
checkpoint's `backbone` and `segmentation_decoder` state dicts. The network
runs on the card unless `--device cpu`, in fp32 with TF32 off for matmuls
and cuDNN convolutions (`eval_tool.metric_scope`). Prints `FRD: %.4f`.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

from mobi_tpu_torch.convert import torch_state_dict
from mobi_tpu_torch.eval.frechet import frechet_from_features
from mobi_tpu_torch.eval.rangenet import RangeNetFRD, load_published, range_npy_to_input
from mobi_tpu_torch.eval_tool import metric_scope, network, to_device


def list_npys(path: str) -> List[str]:
    return sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".npy"))


def load_batch(paths) -> np.ndarray:
    return np.stack([range_npy_to_input(np.load(f)) for f in paths])


def rangenet_model(backbone_weights: str, decoder_weights: str, device) -> RangeNetFRD:
    model = RangeNetFRD()
    load_published(model, torch_state_dict(backbone_weights), torch_state_dict(decoder_weights))
    return model.eval().to(device)


def compute_features(files, model, device, batch_size: int = 16) -> np.ndarray:
    feats = []
    for i in range(0, len(files), batch_size):
        feats.append(model(to_device(load_batch(files[i:i + batch_size]), device)).cpu().numpy())
    return np.concatenate(feats)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path_orig", required=True)
    p.add_argument("--path_pred", required=True)
    p.add_argument("--backbone-weights", default=os.environ.get("RANGENET_BACKBONE"))
    p.add_argument("--decoder-weights", default=os.environ.get("RANGENET_DECODER"))
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default="cuda", help="the device the network runs on (cpu for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    for w in (args.backbone_weights, args.decoder_weights):
        if not w or not os.path.exists(w):
            sys.exit("FRD requires the RangeNet++ darknet53 weights: pass "
                     "--backbone-weights/--decoder-weights (the published "
                     "checkpoint's `backbone` and `segmentation_decoder` files) "
                     "or set RANGENET_BACKBONE/RANGENET_DECODER.")
    with metric_scope(args.device) as dev:
        model = network(rangenet_model, args.backbone_weights, args.decoder_weights, dev)
        f1 = compute_features(list_npys(args.path_orig), model, dev, args.batch_size)
        f2 = compute_features(list_npys(args.path_pred), model, dev, args.batch_size)
    frd = frechet_from_features(f1, f2)
    print(f"FRD: {frd:.4f}")
    return frd


if __name__ == "__main__":
    main()
