"""Per-sample data-sanity pictures from the MObI dataset (the JAX
package's scripts/visualise_data.py): for the first `--num` items of a
split, the camera GT and inpaint images, the mask, the reference crop, the
range view's collage and mask, and a BEV drawing of the object's box, as
PNGs under `<outdir>/<index>/`. The port's dataset, no cv2.

  python -m mobi_tpu_torch.visualise_data --config configs/mobi_nusc_512.yaml \\
      --split train --num 8 --outdir results/data_vis
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np

from mobi_tpu_torch.data.image_io import write_png
from mobi_tpu_torch.viz import range_log_collage, visualize_lidar_bev


def _save(path: str, img_pm1: np.ndarray) -> None:
    u8 = np.clip((np.asarray(img_pm1) + 1) * 127.5, 0, 255).astype(np.uint8)
    if u8.ndim == 2:
        u8 = u8[..., None].repeat(3, -1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, u8)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--outdir", default="results/data_vis")
    return p.parse_args(argv)


def main(argv=None, cfg: Optional[Dict] = None) -> int:
    """Write the pictures; returns how many items. `cfg` stands in for the
    loaded YAML (a test passes a tree with its database paths)."""
    from mobi_tpu_torch.utils.config import instantiate_from_config, load_config

    args = parse_args(argv)
    cfg = cfg if cfg is not None else load_config([args.config])
    ds = instantiate_from_config(cfg["data"]["params"][args.split])
    n = min(args.num, len(ds))
    print(f"writing {n} sample visualisations to {args.outdir}")
    for i in range(n):
        ex = ds[i]
        d = os.path.join(args.outdir, f"{i:03d}")
        img = ex["image"]
        _save(os.path.join(d, "gt.png"), img["GT"])
        _save(os.path.join(d, "inpaint.png"), img["inpaint_image"])
        _save(os.path.join(d, "mask.png"), img["inpaint_mask"][..., 0] * 2 - 1)
        if "cond" in img and "ref_image" in img["cond"]:
            ref = np.asarray(img["cond"]["ref_image"])
            ref = (ref - ref.min()) / max(ref.max() - ref.min(), 1e-6) * 2 - 1
            _save(os.path.join(d, "ref.png"), ref)
        if "lidar" in ex:
            lid = ex["lidar"]
            collage = range_log_collage(np.asarray(lid["range_data"]), np.asarray(lid["range_data_inpaint"]),
                                        np.asarray(lid["range_mask"]), np.asarray(lid["range_data"]))
            os.makedirs(d, exist_ok=True)
            # the JAX script writes collage[..., ::-1] (a BGR flip meant for
            # colour), which on this 2-D collage mirrors the width; kept, so
            # both write the same file (ROADMAP queue 3)
            write_png(os.path.join(d, "range.png"), collage[..., ::-1])
            _save(os.path.join(d, "range_mask.png"), lid["range_mask"][..., 0] * 2 - 1)
        if "bbox_3d" in ex:
            visualize_lidar_bev(bboxes=np.asarray(ex["bbox_3d"])[None, :, :2], fpath=os.path.join(d, "bev.png"),
                                xlim=(-54, 54), ylim=(-54, 54), dpi=5)
    print("done")
    return n


if __name__ == "__main__":
    main()
