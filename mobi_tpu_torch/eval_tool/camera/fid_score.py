"""Camera "FID" between two image folders (eval_tool/camera/fid_score.py of
the JAX package):

  python -m mobi_tpu_torch.eval_tool.camera.fid_score --path_target DIR --path_pred DIR \
      [--backbone clip|inception] [--weights FILE] [--batch-size 64] [--device cuda]

`--backbone clip` (the default) is the reference's camera FID, a CLIP-FID:
the OpenAI `clip.load` preprocess, the ViT-B/32 image tower, the visual
projection (no L2 norm), then the Frechet distance of the 512-d features.
`--weights` (or CLIP_B32_WEIGHTS) is an HF `CLIPModel` state dict.
`--backbone inception` is the classic pool3 FID: each image resized to 299 x
299 by cv2's INTER_LINEAR (`imgproc.resize_linear`), scaled to [-1, 1];
`--weights` (or INCEPTION_WEIGHTS) is torchvision's `inception_v3` state
dict. `--batch-size` serves both, as in the JAX CLI.

Images are read by `data.image_io.read_image` (gray replicated to RGB). The
networks run on the card unless `--device cpu`, in fp32 with TF32 off for
matmuls and cuDNN convolutions (`eval_tool.metric_scope`). Prints `FID: %.4f`.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

from mobi_tpu_torch.convert import torch_state_dict
from mobi_tpu_torch.data.image_io import read_image
from mobi_tpu_torch.data.imgproc import resize_linear
from mobi_tpu_torch.eval.clip_embed import ClipImageEmbedder, clip_preprocess_image, load_clip_b32
from mobi_tpu_torch.eval.frechet import frechet_from_features
from mobi_tpu_torch.eval.inception import InceptionV3Features, load_published
from mobi_tpu_torch.eval_tool import metric_scope, network, to_device

IMAGE_EXTENSIONS = {"bmp", "jpg", "jpeg", "pgm", "png", "ppm", "tif", "tiff", "webp"}


def list_images(path: str) -> List[str]:
    return sorted(
        os.path.join(path, f)
        for f in os.listdir(path)
        if f.split(".")[-1].lower() in IMAGE_EXTENSIONS
    )


def load_batch_clip(paths) -> np.ndarray:
    """OpenAI CLIP preprocessing -> [B, 224, 224, 3] float32."""
    return np.stack([clip_preprocess_image(read_image(p)) for p in paths])


def load_batch_inception(paths, size: int = 299) -> np.ndarray:
    return np.stack([resize_linear(read_image(p), size, size).astype(np.float32) / 127.5 - 1.0 for p in paths])


def clip_model(weights: str, device) -> ClipImageEmbedder:
    model = ClipImageEmbedder()
    load_clip_b32(model, torch_state_dict(weights))
    return model.eval().to(device)


def inception_model(weights: str, device) -> InceptionV3Features:
    model = InceptionV3Features()
    load_published(model, torch_state_dict(weights))
    return model.eval().to(device)


def compute_features(files, model, load_batch, device, batch_size: int) -> np.ndarray:
    """[N, D] float32 features of `files`, a batch at a time on `device`."""
    feats = []
    for i in range(0, len(files), batch_size):
        x = to_device(load_batch(files[i:i + batch_size]), device)
        feats.append(model(x).cpu().numpy())
    return np.concatenate(feats)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path_target", required=True)
    p.add_argument("--path_pred", required=True)
    p.add_argument("--backbone", choices=("clip", "inception"), default="clip",
                   help="'clip' reproduces the reference exactly (its 'InceptionV3' is rewired to CLIP "
                        "encode_image); 'inception' is a classical pool3 FID")
    p.add_argument("--weights", default=None,
                   help="clip: HF CLIP ViT-B/32 state dict (.pth; or set CLIP_B32_WEIGHTS); inception: "
                        "torchvision inception_v3 state dict (or INCEPTION_WEIGHTS)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--device", default="cuda", help="the device the network runs on (cpu for the CPU)")
    return p.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    if args.backbone == "clip":
        weights = args.weights or os.environ.get("CLIP_B32_WEIGHTS")
        if not weights or not os.path.exists(weights):
            sys.exit("camera FID requires CLIP ViT-B/32 weights: pass --weights "
                     "(HF CLIPModel state dict) or set CLIP_B32_WEIGHTS.")
        build, load_batch = clip_model, load_batch_clip
    else:
        weights = args.weights or os.environ.get("INCEPTION_WEIGHTS")
        if not weights or not os.path.exists(weights):
            sys.exit("inception FID requires --weights (torchvision inception_v3 "
                     ".pth) or INCEPTION_WEIGHTS.")
        build, load_batch = inception_model, load_batch_inception
    with metric_scope(args.device) as dev:
        model = network(build, weights, dev)
        f1 = compute_features(list_images(args.path_target), model, load_batch, dev, args.batch_size)
        f2 = compute_features(list_images(args.path_pred), model, load_batch, dev, args.batch_size)
    fid = frechet_from_features(f1, f2)
    print(f"FID: {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
