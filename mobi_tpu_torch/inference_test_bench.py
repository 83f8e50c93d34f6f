"""Batched inference test bench of the port (scripts/inference_test_bench.py):

  python -m mobi_tpu_torch.inference_test_bench --config configs/mobi_nusc_512.yaml \
      --outdir build/itb --plms --ddim_steps 50 --scale 5 --n_samples 4 --seed 321 \
      --save_samples --save_visualisations [--rotation_test] [--ckpt model.ckpt] \
      [data.params.test.params.object_database_path=... overrides]

The JAX bench's arguments, defaults, environment switches (MOBI_ITB_PIPELINE,
MOBI_ITB_SEGMENTS, MOBI_ITB_TIMED_SEGMENTS, MOBI_ITB_BF16_PARAMS) and output
paths, plus `--device` (default cuda). Per batch: the port's inpaint
pipeline on the device, then on the host (on a worker thread, so batch N-1's
host work overlaps batch N's sampling): the camera crop resized and
Gaussian-blended back into the full frame, the lidar crop pasted back into
the native range view with the re-projected instance mask, the lidar
metrics, and the sample and visualisation files; `metrics.csv` at the end.

One deviation: the files the JAX bench writes as `.jpg` through cv2 (the
full-frame composite `samples_seed*/<frame>`, `camera/grid/*`, the range
collages) are PNGs under the same stem, since the port has no JPEG
encoder; they hold exactly the arrays the JAX bench encodes.

`--ckpt` takes a reference .ckpt / torch file or a checkpoint directory the
port's training CLI wrote (`convert.load_checkpoint`: a manager directory
gives its latest step, a step directory that step, with the EMA shadow when
the config sets use_ema); an orbax directory of the JAX package raises.

Not in this port yet: `--mesh-dp > 1` (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

import argparse
import copy
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mobi_tpu_torch import convert
from mobi_tpu_torch.data import imgproc
from mobi_tpu_torch.data import range_projection as rp
from mobi_tpu_torch.data.geometry import points_in_bbox_corners
from mobi_tpu_torch.data.image_io import write_png
from mobi_tpu_torch.data.loader import PrefetchLoader
from mobi_tpu_torch.data.table import write_csv
from mobi_tpu_torch.eval.lidar_metrics import lidar_sample_metrics
from mobi_tpu_torch.models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from mobi_tpu_torch.models.diffusion import MobiDiffusion
from mobi_tpu_torch.ops.ranges import inverse_depth_normalization, inverse_intensity_normalization
from mobi_tpu_torch.pipeline import make_inpaint_pipeline
from mobi_tpu_torch.utils.config import (instantiate_from_config, load_config, mobi_config_from_yaml,
                                         parse_override, set_dotted)
from mobi_tpu_torch.viz import overlay_lidar_on_image, range_log_collage


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", type=str, default="outputs/test_bench")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--n_samples", type=int, default=4, help="batch size")
    p.add_argument("--n_workers", type=int, default=4)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fixed_code", action="store_true")
    p.add_argument("--rotation_test", action="store_true")
    p.add_argument("--save_samples", action="store_true")
    p.add_argument("--save_visualisations", action="store_true")
    p.add_argument("--copy-paste", dest="copy_paste", action="store_true")
    p.add_argument(
        "--fixed-intensity-paste", dest="fixed_intensity_paste", action="store_true",
        help="convert predicted intensity to raw 0..255 units before paste-back (default: "
             "reference-faithful normalized-unit paste)",
    )
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument(
        "--sample-segments", dest="sample_segments", type=int,
        default=int(os.environ.get("MOBI_ITB_SEGMENTS", "1")),
        help="run the sampling loop as N segments (pipeline.SegmentedInpaint); exact ddim/plms",
    )
    p.add_argument(
        "--encoder-interval", dest="encoder_interval", type=int, default=1,
        help="encoder propagation: run the UNet encoder+middle every Nth DDIM step "
             "(approximate; 1 keeps exact DDIM)",
    )
    p.add_argument("--mesh-dp", dest="mesh_dp", type=int, default=1,
                   help="data-parallel inference over N devices (not ported yet)")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device the model and pipeline run on (cpu for the plain path)")
    p.add_argument("overrides", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _strip(batch) -> Dict[str, Any]:
    """The arrays of a collated batch that the pipeline reads."""
    img, lid = batch["image"], batch["lidar"]
    return {
        "image": {
            "GT": img["GT"], "inpaint_image": img["inpaint_image"], "inpaint_mask": img["inpaint_mask"],
            "cond": {"ref_image": img["cond"]["ref_image"], "ref_bbox": img["cond"]["ref_bbox"]},
        },
        "lidar": {
            "range_data": lid["range_data"], "range_data_inpaint": lid["range_data_inpaint"],
            "range_mask": lid["range_mask"], "cond": {"ref_bbox": lid["cond"]["ref_bbox"]},
        },
    }


def _weights_policy(model: MobiDiffusion) -> None:
    """With a bf16 model the >= 2-D weights are held in bf16, or in fp32 with
    MOBI_ITB_BF16_PARAMS=0 (the JAX bench's residency rule)."""
    if model.config.dtype != torch.bfloat16:
        return
    dtype = torch.bfloat16 if os.environ.get("MOBI_ITB_BF16_PARAMS", "1") == "1" else torch.float32
    for p in model.parameters():
        if p.dim() >= 2 and p.dtype in (torch.float32, torch.bfloat16):
            p.data = p.data.to(dtype)


def write_metrics_csv(path: str, metrics: Dict[str, Dict[str, float]]) -> None:
    """pandas' `DataFrame(metrics).to_csv(path)` for a dict of columns, each
    a dict of row -> value: rows in the first column's order, then the rows
    that are new in later columns."""
    rows: List[str] = []
    for col in metrics.values():
        rows += [r for r in col if r not in rows]
    write_csv(path, list(metrics), [(r, {c: v[r] for c, v in metrics.items() if r in v}) for r in rows])


def main(argv=None, model: Optional[MobiDiffusion] = None, cfg: Optional[Dict] = None) -> Dict[str, Any]:
    """Run the bench. `model` replaces the model built from the config (and
    its random weights; a --ckpt still loads into it); `cfg` replaces
    loading --config (an interpolated config tree, as `load_config` returns;
    the overrides still apply). Returns {"objects", "batches": [{"device_s",
    "host_s"}], "wall_s", "outdir"}."""
    opt = parse_args(argv)
    if opt.mesh_dp > 1:
        raise NotImplementedError("--mesh-dp > 1: data-parallel inference waits for the port's "
                                  "scale-out (ROADMAP queue 1 item 6)")
    overrides = [s for s in opt.overrides if "=" in s]
    if cfg is None:
        cfg = load_config([opt.config], overrides)
    else:
        cfg = copy.deepcopy(cfg)
        for s in overrides:
            set_dotted(cfg, *parse_override(s))
    mcfg = mobi_config_from_yaml(cfg)
    use_ema = bool(cfg["model"]["params"].get("use_ema", False))
    if model is None:
        model = MobiDiffusion(mcfg, device=opt.device, seed=opt.seed)
    _weights_policy(model)
    if opt.ckpt:
        print(f"loading checkpoint {opt.ckpt}")
        info = convert.load_checkpoint(model, opt.ckpt, use_ema=use_ema)
        if info.get("ema"):
            print("using EMA weights for sampling (ema_scope)")

    split = "rotation_test" if opt.rotation_test else "test"
    ds_cfg = dict(cfg["data"]["params"][split])
    ds_cfg["params"] = {**(ds_cfg.get("params") or {}), "return_original_image": True}
    dataset = instantiate_from_config(ds_cfg)
    loader = PrefetchLoader(dataset, opt.n_samples, shuffle=False, num_threads=opt.n_workers,
                            drop_last=False)

    outpath = opt.outdir
    camera_path = os.path.join(outpath, "camera")
    lidar_path = os.path.join(outpath, "lidar")
    sample_path = os.path.join(outpath, f"samples_seed{opt.seed}")
    for d in (camera_path, lidar_path, sample_path):
        os.makedirs(d, exist_ok=True)

    run_batch = make_inpaint_pipeline(
        model, num_steps=opt.ddim_steps, guidance_scale=opt.scale,
        sampler="plms" if opt.plms else "ddim", eta=opt.ddim_eta,
        sample_segments=opt.sample_segments, encoder_interval=opt.encoder_interval,
        device=opt.device,
    )
    cuda = model.device.type == "cuda"
    metrics_acc: Dict[str, list] = {}
    stats: Dict[str, Any] = {"objects": 0, "batches": [], "outdir": outpath}
    t0 = time.time()

    def finish_batch(bi, batch, out, events):
        """Host side of one batch: wait for the device and the outputs'
        copy, then lidar metrics, compositing and files."""
        if events is not None:
            events[1].synchronize()
        t_host = time.perf_counter()
        cam = out["camera"].float().numpy() if "camera" in out else None
        lid = out["lidar"].float().numpy() if "lidar" in out else None
        B = len(batch["id_name"])
        if lid is not None:
            m = lidar_sample_metrics(
                pred=lid, gt=batch["lidar"]["range_data"],
                instance_mask=batch["lidar"]["range_instance_mask"],
                edit_mask=batch["lidar"]["range_mask"], width_crop=batch["lidar"]["width_crop"],
                min_depth_obj=batch["lidar"]["min_depth_obj"],
                max_depth_obj=batch["lidar"]["max_depth_obj"],
                range_object_norm=mcfg.range_object_norm,
                range_object_norm_scale=mcfg.range_object_norm_scale,
                range_int_norm=mcfg.range_int_norm,
            )
            for k, v in m.items():
                metrics_acc.setdefault(k, []).append(v)
        for i in range(B):
            seg = batch["id_name"][i]
            image_recon = None
            if cam is not None and opt.save_samples:
                image_recon = composite_camera(cam[i], batch, i, camera_path, sample_path, seg, opt)
            if lid is not None and opt.save_samples:
                composite_lidar(lid[i], batch, i, lidar_path, sample_path, seg, opt, mcfg, image_recon)
            if cam is not None and opt.save_visualisations:
                save_camera_grid(cam[i], batch, i, camera_path, seg, opt)
            if lid is not None and opt.save_visualisations:
                save_lidar_visuals(lid[i], batch, i, lidar_path, seg, opt)
        stats["objects"] += B
        stats["batches"].append({
            "device_s": events[0].elapsed_time(events[1]) / 1e3 if events is not None else None,
            "host_s": time.perf_counter() - t_host,
        })
        print(f"batch {bi}: {stats['objects']} objects, "
              f"{stats['objects'] / (time.time() - t0):.3f} obj/s")

    pool = ThreadPoolExecutor(max_workers=1) if os.environ.get("MOBI_ITB_PIPELINE", "1") == "1" else None
    pending = None
    try:
        for bi, batch in enumerate(loader):
            if opt.max_batches is not None and bi >= opt.max_batches:
                break
            gen = torch.Generator(device=model.device).manual_seed(
                opt.seed if opt.fixed_code else opt.seed + bi)
            events = None
            if cuda:
                events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                events[0].record()
            if (bi == 0 and opt.sample_segments > 1
                    and os.environ.get("MOBI_ITB_TIMED_SEGMENTS", "0") == "1"):
                # one warm pass, then one timed pass of each segment
                run_batch.timed_call(_strip(batch), gen)
                gen.manual_seed(opt.seed)
                out, walls = run_batch.timed_call(_strip(batch), gen)
                print("segment walls (s): " + ", ".join(f"{n}={w:.2f}" for n, w in walls))
            else:
                out = run_batch(_strip(batch), gen)
            # copy the outputs in stream order now: a copy from the worker
            # thread would queue behind the next batch's kernels
            out = {k: v.to("cpu", non_blocking=cuda) for k, v in out.items()}
            if cuda:
                events[1].record()
            if pool is None:
                finish_batch(bi, batch, out, events)
            else:
                if pending is not None:
                    pending.result()  # at most two batches in flight
                pending = pool.submit(finish_batch, bi, batch, out, events)
        if pending is not None:
            pending.result()
    finally:
        if pool is not None:
            pool.shutdown(wait=True)

    table: Dict[str, Dict[str, float]] = {"mse": {}, "median_error": {}}
    for k, vals in metrics_acc.items():
        group, name = k.split("/")
        table[group][name] = float(np.mean(vals))
    write_metrics_csv(os.path.join(outpath, "metrics.csv"), table)
    stats["wall_s"] = time.time() - t0
    print(f"Samples written to {outpath}")
    return stats


def _ref_u8(batch, i) -> np.ndarray:
    ref = np.asarray(batch["image"]["cond"]["ref_image"][i])
    return np.clip((ref * np.asarray(CLIP_IMAGE_STD) + np.asarray(CLIP_IMAGE_MEAN)) * 255, 0, 255).astype(np.uint8)


def _png_name(name: str) -> str:
    return os.path.splitext(name)[0] + ".png"


def composite_camera(pred, batch, i, camera_path, sample_path, seg, opt):
    """Blend the predicted 512-crop back into the full frame (reference
    :478-527); writes the frame and the object/patch crops."""
    orig = batch["image"]["orig"]
    image = np.asarray(orig["image"][i])          # [-1,1] HWC full frame
    mask = np.asarray(orig["mask"][i])            # full-res edit mask
    left, top, crop_W, crop_H = [int(v) for v in orig["crop"][i]]
    file_name = orig["file_name"][i]

    patch_pred = imgproc.resize_linear(((pred + 1) / 2 * 255).astype(np.uint8), crop_H, crop_W)
    patch_gt = imgproc.resize_linear(
        ((np.asarray(batch["image"]["GT"][i]) + 1) / 2 * 255).astype(np.uint8), crop_H, crop_W)
    ys, xs = np.nonzero(1 - mask)
    y1, y2 = ys.min(), ys.max()
    x1, x2 = xs.min(), xs.max()

    image_u8 = ((image + 1) / 2 * 255).astype(np.uint8)
    image_pred = np.zeros_like(image_u8)
    image_pred[top:top + crop_H, left:left + crop_W] = patch_pred
    ref_u8 = _ref_u8(batch, i)

    if opt.copy_paste:
        image_pred[y1:y2, x1:x2] = imgproc.resize_linear(ref_u8, y2 - y1, x2 - x1)
        mask_conv = imgproc.dilate(mask, 5)
    else:
        mask_conv = imgproc.gaussian_blur(mask, 15, 7.0)

    image_recon = (mask_conv[..., None] * image_u8 + (1 - mask_conv[..., None]) * image_pred).astype(np.uint8)
    composited_patch = image_recon[top:top + crop_H, left:left + crop_W]
    object_pred = imgproc.resize_linear(image_pred[y1:y2, x1:x2], 224, 224)

    write_png(os.path.join(sample_path, _png_name(file_name)), image_recon)
    for sub, img in (("object_pred", object_pred), ("object_ref", ref_u8),
                     ("patch_gt", patch_gt), ("patch_pred", composited_patch)):
        os.makedirs(os.path.join(camera_path, sub), exist_ok=True)
        write_png(os.path.join(camera_path, sub, f"{seg}_{sub}_seed{opt.seed}.png"), img)
    return image_recon


def composite_lidar(pred, batch, i, lidar_path, sample_path, seg, opt, mcfg, image_recon=None):
    """Paste the predicted object back into the native range view and save
    the eval artifacts (reference :567-652)."""
    lid = batch["lidar"]
    depth_crop = np.asarray(pred[..., 0], np.float64)
    int_crop = np.asarray(pred[..., 1], np.float64)
    if mcfg.range_object_norm:
        depth_crop = inverse_depth_normalization(
            depth_crop, float(lid["min_depth_obj"][i]), float(lid["max_depth_obj"][i]),
            alpha=mcfg.range_object_norm_scale)
    if mcfg.range_int_norm:
        int_crop = inverse_intensity_normalization(int_crop)
    if opt.fixed_intensity_paste:
        int_crop = (int_crop + 1) / 2 * 255.0

    geom = rp.RangeCropGeom(crop_left=int(lid["range_shift_left"][i]), width_crop=int(lid["width_crop"][i]))
    depth_orig = np.asarray(lid["range_depth_orig"][i], np.float64)
    int_orig = np.asarray(lid["range_int_orig"][i], np.float64)
    pitch = np.asarray(lid["range_pitch"][i])
    yaw = np.asarray(lid["range_yaw"][i])
    depth_pasted, int_pasted = rp.undo_range_transforms(geom, depth_crop, depth_orig, int_crop, int_orig)

    # predicted-object instance mask via reprojection
    gt_inst = np.asarray(lid["range_instance_mask_orig"][i])
    label = np.arange(gt_inst.size).reshape(gt_inst.shape)
    pts, pts_label, _ = rp.range_to_pcd(depth_pasted, pitch, yaw, label)
    obj = points_in_bbox_corners(pts, np.asarray(batch["bbox_3d"][i])[None])
    pred_inst = np.zeros(gt_inst.size)
    pred_inst[pts_label[obj[:, 0]].astype(np.int64)] = 1
    inst = np.logical_or(pred_inst.reshape(gt_inst.shape), gt_inst > 0)
    depth_final = np.where(inst, depth_pasted, depth_orig)
    int_final = np.where(inst, int_pasted, int_orig)

    for sub, arr in (("range_pred", np.stack([depth_final, int_final, pitch, yaw])),
                     ("range_orig", np.stack([depth_orig, int_orig, pitch, yaw]))):
        os.makedirs(os.path.join(lidar_path, sub), exist_ok=True)
        np.save(os.path.join(lidar_path, sub, f"{seg}_{sub}_seed{opt.seed}.npy"), arr)

    pts_pred, pts_int, beam = rp.range_to_pcd(depth_final, pitch, yaw, int_final)
    pred_points = np.concatenate([pts_pred, pts_int[:, None], beam[:, None]], axis=1).astype(np.float32)
    np.save(os.path.join(sample_path, lid["file_name"][i]), pred_points)

    # lidar-on-image overlays (reference :633-652)
    if image_recon is not None and "orig" in batch.get("image", {}):
        lidar2image = np.asarray(batch["image"]["orig"]["lidar2image"][i])
        pts_orig, _, _ = rp.range_to_pcd(depth_orig, pitch, yaw)
        image_u8 = ((np.asarray(batch["image"]["orig"]["image"][i]) + 1) / 2 * 255).astype(np.uint8)
        overlay_lidar_on_image(pts_orig, lidar2image, image_u8,
                               os.path.join(lidar_path, "overlay_orig", f"{seg}.png"))
        overlay_lidar_on_image(pts_pred, lidar2image, image_recon,
                               os.path.join(lidar_path, "overlay_pred", f"{seg}.png"))


def save_lidar_visuals(pred, batch, i, lidar_path, seg, opt):
    """Range-view PNGs of the normalized 512-crops (the D-LPIPS / I-LPIPS
    inputs) and the per-channel collages (reference :536-565)."""
    lid = batch["lidar"]
    gt = np.asarray(lid["range_data"][i])
    inpaint = np.asarray(lid["range_data_inpaint"][i])
    mask = np.asarray(lid["range_mask"][i])

    def u8(x):
        return np.clip((np.asarray(x) + 1) / 2 * 255, 0, 255).astype(np.uint8)

    for ch, name in ((0, "depth"), (1, "intensity")):
        for sub, img in ((f"range_{name}_pred", u8(pred[..., ch])), (f"range_{name}_target", u8(gt[..., ch]))):
            os.makedirs(os.path.join(lidar_path, sub), exist_ok=True)
            write_png(os.path.join(lidar_path, sub, f"{seg}_seed{opt.seed}.png"), img)
        collage = range_log_collage(gt, inpaint, mask, np.asarray(pred), channel=ch)
        coldir = os.path.join(lidar_path, f"range_{name}_collage")
        os.makedirs(coldir, exist_ok=True)
        write_png(os.path.join(coldir, f"{seg}_grid_{name}_seed{opt.seed}.png"), collage)


def save_camera_grid(pred, batch, i, camera_path, seg, opt):
    """input | inpaint | reference | prediction collage (reference :470-477)."""
    gt = ((np.asarray(batch["image"]["GT"][i]) + 1) / 2 * 255).astype(np.uint8)
    inp = ((np.asarray(batch["image"]["inpaint_image"][i]) + 1) / 2 * 255).astype(np.uint8)
    ref = imgproc.resize_linear(_ref_u8(batch, i), gt.shape[0], gt.shape[1])
    pr = ((pred + 1) / 2 * 255).astype(np.uint8)
    grid = np.concatenate([gt, inp, ref, pr], axis=0)
    os.makedirs(os.path.join(camera_path, "grid"), exist_ok=True)
    write_png(os.path.join(camera_path, "grid", f"{seg}_grid_seed{opt.seed}.png"), grid)


if __name__ == "__main__":
    main()
