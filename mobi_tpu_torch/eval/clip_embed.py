"""CLIP ViT-B/32 image embedder for the camera CLIP-FID and the CLIP score
(mobi_tpu eval/clip_embed.py).

`ClipImageEmbedder` is the port's CLIPVisionTower at B/32 (224 px, patch 32,
width 768, 12 layers, 12 heads) with HF's bias-free `visual_projection`
(768 -> 512) on the pooled CLS feature: `encode_image`, unnormalised. It
takes CLIP-normalised pixels NCHW and hands the tower an NHWC view.

`load_clip_b32` loads an HF `CLIPModel` state dict as it is published.
`clip_preprocess_image` is OpenAI's `clip.load` preprocess on the uint8 RGB
array `data.image_io.read_image` returns, with Pillow's bicubic resize
reproduced bit for bit (`data.imgproc.resize_bicubic_pil`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn

from mobi_tpu_torch.data.imgproc import resize_bicubic_pil
from mobi_tpu_torch.models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, CLIPVisionTower

PROJECTION_DIM = 512
# the keys of an HF CLIPModel that the image side does not use
_TEXT_PREFIXES = ("text_model.", "text_projection.")
_TEXT_KEYS = ("logit_scale",)
# a buffer (arange of the positions) that files written by older
# transformers versions carry; it holds no weight
_POSITION_IDS = "vision_model.embeddings.position_ids"


class ClipImageEmbedder(CLIPVisionTower):
    """[B, 3, 224, 224] CLIP-normalised pixels -> [B, 512] `encode_image`
    features (no L2 norm)."""

    def __init__(self, image_size: int = 224, patch_size: int = 32, width: int = 768, layers: int = 12,
                 heads: int = 12, projection_dim: int = PROJECTION_DIM):
        super().__init__(image_size, patch_size, width, layers, heads, dtype=torch.float32)
        self.visual_projection = nn.Linear(width, projection_dim, bias=False)

    def forward(self, pixels_nchw: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision_model(pixels_nchw.permute(0, 2, 3, 1)))


def load_clip_b32(model: ClipImageEmbedder, sd: Dict[str, torch.Tensor]) -> None:
    """An HF CLIPModel state dict into `model`, strict=True: the text
    tower's keys (`text_model.*`, `text_projection.*`, `logit_scale`) are
    dropped, and so is a `position_ids` buffer where it equals the positions;
    any other key the model lacks raises."""
    kept = {}
    for k, v in sd.items():
        if k.startswith(_TEXT_PREFIXES) or k in _TEXT_KEYS:
            continue
        if k == _POSITION_IDS:
            n_pos = model.vision_model.embeddings.position_embedding.num_embeddings
            if not torch.equal(torch.as_tensor(v).reshape(-1).long(), torch.arange(n_pos)):
                raise ValueError(f"{k} is not arange({n_pos})")
            continue
        kept[k] = torch.as_tensor(v)
    model.load_state_dict(kept, strict=True)


def clip_preprocess_image(img: np.ndarray, size: int = 224) -> np.ndarray:
    """OpenAI `clip.load`'s preprocess on uint8 [H, W, 3] (or [H, W]):

      Resize(224, BICUBIC)  the shorter side to 224, the other int(224 * long / short)
      CenterCrop(224)       torchvision's rounding of the offsets
      to RGB, / 255, CLIP mean and std

    -> [224, 224, 3] float32, channels last, as JAX's on the PIL image."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    # torchvision F.resize(int) semantics: shorter side -> size
    if w <= h:
        new_w, new_h = size, max(int(size * h / w), size)
    else:
        new_w, new_h = max(int(size * w / h), size), size
    img = resize_bicubic_pil(img, new_h, new_w)
    top = int(round((new_h - size) / 2.0))
    left = int(round((new_w - size) / 2.0))
    img = img[top:top + size, left:left + size]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - np.asarray(CLIP_IMAGE_MEAN, np.float32)) / np.asarray(CLIP_IMAGE_STD, np.float32)
    return arr.astype(np.float32)
