"""The legacy auxiliary datasets (mobi_tpu data/aux_datasets.py), host-side
numpy, HWC, on `image_io` and `imgproc` instead of cv2:

  * OpenImagesDataset: Paint-by-Example pretraining pairs from OpenImages
    bbox files (a reference crop, an extended-bbox or smooth-polygon inpaint
    mask, a bbox-aware square crop, resized to `image_size`);
  * COCOTestBenchDataset: the PbE COCO test bench's GT / Ref / Mask triplets;
  * ImageNetFolder / ImageNetSR: folder ImageNet and its super-resolution
    pairs;
  * LSUNBase and `lsun_split`: the txt-listed LSUN centre crops.

Each makes the JAX package's numpy draws, from the same seed, in the same
order, so the same index gives the same arrays. Images decode as cv2's
`imread` does (`image_io.read_image`, `read_gray`); resizes are cv2's
INTER_LINEAR (`augment.resize_image`), whose float path sits within 2 ulp
of cv2's (ROADMAP queue 3). The smooth polygon is filled by
`imgproc.fill_poly`, cv2's `fillPoly` with LINE_8.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from mobi_tpu_torch.data.augment import ref_augment, resize_image, to_clip_input, to_model_range
from mobi_tpu_torch.data.image_io import read_gray, read_image
from mobi_tpu_torch.data.imgproc import fill_poly


def _smooth_polygon_mask(h: int, w: int, bbox: Sequence[int], rng: np.random.Generator) -> np.ndarray:
    """A random smooth polygon around the bbox (the reference's bezier
    "arbitrary mask" as the JAX package rebuilds it: a jittered ring of
    quadratic-bezier points through the bbox's corners and its pushed-out
    edge midpoints). Returns float32 [h, w], 1 = inpaint region."""
    x0, y0, x1, y1 = bbox
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    anchors = np.array([
        [x0, y0], [cx, y0 - rng.uniform(0, 0.2) * (y1 - y0)], [x1, y0],
        [x1, cy], [x1 + rng.uniform(0, 0.2) * (x1 - x0), cy], [x1, y1],
        [x1, y1], [cx, y1 + rng.uniform(0, 0.2) * (y1 - y0)], [x0, y1],
        [x0, cy], [x0 - rng.uniform(0, 0.2) * (x1 - x0), cy], [x0, y0],
    ], np.float32)
    pts: List[List[float]] = []
    jitter = 5.0
    for e in range(4):
        p0, pc, p1 = anchors[3 * e], anchors[3 * e + 1], anchors[3 * e + 2]
        for t in np.linspace(0.05, 0.95, 18):
            p = (1 - t) ** 2 * p0 + 2 * (1 - t) * t * pc + t ** 2 * p1
            pts.append([p[0] + rng.uniform(-jitter, jitter), p[1] + rng.uniform(-jitter, jitter)])
    mask = np.zeros((h, w), np.uint8)
    fill_poly(mask, np.round(pts).astype(np.int32), 1)
    return mask.astype(np.float32)


class OpenImagesDataset:
    """PbE pretraining over OpenImages bbox files:
    dataset_dir/bbox/{train_0..train_f | validation | test}/<id>.txt (lines
    "x0 y0 x1 y1 ..." in pixels) and dataset_dir/images/<split_dir>/<id>.jpg.
    An item: GT and inpaint_image [-1, 1], inpaint_mask (1 = keep) at
    `image_size`, ref_img CLIP-normalized at 224."""

    BAD_LIST = frozenset({
        "1af17f3d912e9aac.txt", "1d5ef05c8da80e31.txt", "3095084b358d3f2d.txt",
        "3ad7415a11ac1f5e.txt", "42a30d8f8fba8b40.txt", "1366cde3b480a15c.txt",
        "03a53ed6ab408b9f.txt",
    })

    def __init__(self, state: str, dataset_dir: str, image_size: int = 512,
                 arbitrary_mask_percent: float = 0.0, seed: int = 0):
        self.dataset_dir = dataset_dir
        self.image_size = image_size
        self.arbitrary_mask_percent = arbitrary_mask_percent
        self._rng = np.random.default_rng(seed)
        if state == "train":
            dirs = [f"train_{c}" for c in "0123456789abcdef"]
        elif state == "validation":
            dirs = ["validation"]
        else:
            dirs = ["test"]
        self.bbox_paths: List[str] = []
        for d in dirs:
            bbox_dir = os.path.join(dataset_dir, "bbox", d)
            if os.path.isdir(bbox_dir):
                self.bbox_paths += [os.path.join(bbox_dir, n) for n in os.listdir(bbox_dir)
                                    if n not in self.BAD_LIST]
        self.bbox_paths.sort()

    def __len__(self) -> int:
        return len(self.bbox_paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = self._rng
        bbox_path = self.bbox_paths[index]
        stem = os.path.splitext(os.path.basename(bbox_path))[0]
        split_dir = os.path.basename(os.path.dirname(bbox_path))
        with open(bbox_path) as f:
            boxes = [[int(float(v)) for v in line.split()[:4]]
                     for line in f.read().splitlines() if line.strip()]
        bbox = boxes[int(rng.integers(len(boxes)))]
        img = read_image(os.path.join(self.dataset_dir, "images", split_dir, stem + ".jpg"))
        h, w = img.shape[:2]

        # reference crop: the bbox padded by up to 10 px, augmented to 224
        pad = [max(bbox[0] - 10, 0), max(bbox[1] - 10, 0), min(bbox[2] + 10, w), min(bbox[3] + 10, h)]
        ref = ref_augment(img[pad[1]:pad[3], pad[0]:pad[2]], rng, size=224)

        # the inpaint mask over a randomly extended bbox (up to 40% of the
        # free space on each side)
        ext = [
            bbox[0] - int(rng.integers(0, max(int(0.4 * bbox[0]), 1))),
            bbox[1] - int(rng.integers(0, max(int(0.4 * bbox[1]), 1))),
            bbox[2] + int(rng.integers(0, max(int(0.4 * (w - bbox[2])), 1))),
            bbox[3] + int(rng.integers(0, max(int(0.4 * (h - bbox[3])), 1))),
        ]
        if rng.uniform() < self.arbitrary_mask_percent:
            region = _smooth_polygon_mask(h, w, bbox, rng)
        else:
            region = np.zeros((h, w), np.float32)
            region[ext[1]:ext[3], ext[0]:ext[2]] = 1.0

        # bbox-aware square crop: the extended bbox inside a square window
        img_f = to_model_range(img)
        side = min(h, w)
        if w > h:
            lo, hi = max(ext[2] - side, 0), min(ext[0], w - side)
            x_off = int(rng.integers(lo, hi + 1)) if hi >= lo else 0
            sl = np.s_[0:side, x_off:x_off + side]
        elif h > w:
            lo, hi = max(ext[3] - side, 0), min(ext[1], h - side)
            y_off = int(rng.integers(lo, hi + 1)) if hi >= lo else 0
            sl = np.s_[y_off:y_off + side, 0:side]
        else:
            sl = np.s_[0:side, 0:side]

        s = self.image_size
        gt = resize_image(img_f[sl], s, s).astype(np.float32)
        keep = (1.0 - np.clip(resize_image(region[sl], s, s), 0.0, 1.0))[..., None].astype(np.float32)
        return {"GT": gt, "inpaint_image": gt * keep, "inpaint_mask": keep, "ref_img": to_clip_input(ref)}


class COCOTestBenchDataset:
    """The PbE COCO test bench: <dir>/GT_3500/<id>_GT.png,
    Ref_3500/<id>_ref.png and Mask_bbox_3500/<id>_mask.png for the ids of
    `id_list_path` (default <dir>/id_list.npy), ids zero-padded to 12."""

    def __init__(self, test_bench_dir: str, id_list_path: Optional[str] = None):
        self.dir = test_bench_dir
        path = id_list_path or os.path.join(test_bench_dir, "id_list.npy")
        self.ids = [int(i) for i in np.load(path).tolist()]

    def __len__(self) -> int:
        return len(self.ids)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        sid = str(self.ids[index]).zfill(12)
        gt = to_model_range(read_image(os.path.join(self.dir, "GT_3500", sid + "_GT.png")))
        ref = resize_image(read_image(os.path.join(self.dir, "Ref_3500", sid + "_ref.png")), 224, 224)
        mask_img = read_gray(os.path.join(self.dir, "Mask_bbox_3500", sid + "_mask.png"))
        keep = (1.0 - mask_img.astype(np.float32) / 255.0)[..., None]
        return {
            "GT": gt.astype(np.float32),
            "inpaint_image": (gt * keep).astype(np.float32),
            "inpaint_mask": keep.astype(np.float32),
            "ref_img": to_clip_input(ref),
            "id": sid,
        }


class ImageNetFolder:
    """Folder ImageNet: a file list (a txt of paths relative to `data_root`,
    else a sorted walk of its .jpg / .jpeg / .png) -> centre-cropped images
    resized to `size`, in [-1, 1], with the synset's index as the label."""

    def __init__(self, data_root: str, size: Optional[int] = 256, file_list: Optional[str] = None,
                 flip_p: float = 0.0, seed: int = 0):
        self.size = size
        self.flip_p = flip_p
        self._rng = np.random.default_rng(seed)
        if file_list:
            with open(file_list) as f:
                rels = f.read().splitlines()
        else:
            rels = []
            for dirpath, _, names in os.walk(data_root):
                rels += [os.path.relpath(os.path.join(dirpath, n), data_root) for n in sorted(names)
                         if n.lower().endswith((".jpg", ".jpeg", ".png"))]
            rels.sort()
        self.paths = [os.path.join(data_root, r) for r in rels]
        self.rel_paths = rels
        self.synset_to_idx = {s: i for i, s in enumerate(sorted({r.split(os.sep)[0] for r in rels}))}

    def __len__(self) -> int:
        return len(self.paths)

    def _load_square(self, i: int) -> np.ndarray:
        img = read_image(self.paths[i])
        h, w = img.shape[:2]
        crop = min(h, w)
        img = img[(h - crop) // 2:(h + crop) // 2, (w - crop) // 2:(w + crop) // 2]
        if self.size is not None:
            img = resize_image(img, self.size, self.size)
        if self.flip_p and self._rng.uniform() < self.flip_p:
            img = img[:, ::-1].copy()
        return img

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img = self._load_square(i)
        synset = self.rel_paths[i].split(os.sep)[0]
        return {"image": to_model_range(img), "class_label": np.int32(self.synset_to_idx.get(synset, -1)),
                "relative_file_path_": self.rel_paths[i]}


class ImageNetSR(ImageNetFolder):
    """ImageNetFolder's images with an LR copy `downscale_f` times smaller."""

    def __init__(self, *args, downscale_f: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.downscale_f = downscale_f

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img = self._load_square(i)
        lr = resize_image(img, self.size // self.downscale_f, self.size // self.downscale_f)
        return {"image": to_model_range(img), "LR_image": to_model_range(lr),
                "relative_file_path_": self.rel_paths[i]}


class LSUNBase:
    """A txt listing of paths under `data_root` -> centre crop, resize to
    `size`, a flip with probability `flip_p`, in [-1, 1]."""

    def __init__(self, txt_file: str, data_root: str, size: Optional[int] = None, flip_p: float = 0.5,
                 seed: int = 0):
        with open(txt_file) as f:
            self.rel_paths = f.read().splitlines()
        self.paths = [os.path.join(data_root, r) for r in self.rel_paths]
        self.size = size
        self.flip_p = flip_p
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        img = read_image(self.paths[i])
        h, w = img.shape[:2]
        crop = min(h, w)
        img = img[(h - crop) // 2:(h + crop) // 2, (w - crop) // 2:(w + crop) // 2]
        if self.size is not None:
            img = resize_image(img, self.size, self.size)
        if self._rng.uniform() < self.flip_p:
            img = img[:, ::-1].copy()
        return {"image": to_model_range(img), "relative_file_path_": self.rel_paths[i]}


_LSUN_LISTS = {
    ("churches", "train"): "church_outdoor_train.txt",
    ("churches", "validation"): "church_outdoor_val.txt",
    ("bedrooms", "train"): "bedrooms_train.txt",
    ("bedrooms", "validation"): "bedrooms_val.txt",
    ("cats", "train"): "cat_train.txt",
    ("cats", "validation"): "cat_val.txt",
}


def lsun_split(name: str, split: str, data_root: str = "data/lsun", **kw) -> LSUNBase:
    """The reference's LSUN{Churches,Bedrooms,Cats}{Train,Validation}: flip
    0.5 for train, 0 for validation, unless `flip_p` is given."""
    flip_p = kw.pop("flip_p", 0.5 if split == "train" else 0.0)
    return LSUNBase(os.path.join(data_root, _LSUN_LISTS[(name, split)]), os.path.join(data_root, name),
                    flip_p=flip_p, **kw)
