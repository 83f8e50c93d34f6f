"""BEVFusion detector training, the CLI of mobi_tpu's scripts/train_detector.py
with the same flags and defaults (the reference's bevfusion/tools/train.py
over the voxelnet and convfuser configs):

  python -m mobi_tpu_torch.train_detector --dataroot /data/nuscenes \\
      --version v1.0-mini --max-steps 1000 --logdir runs/det \\
      [--camera] [--gt-db path/to/gt_db_infos.pkl] [--device cpu]

DetectionSceneDataset and the det_pipeline augmentations feed the
TransFusion train step at the production grid (voxels 0.075 x 0.075 x 0.2
m, 200 proposals, 10 classes; camera views 256 x 704). Every 10 steps one
line of metrics goes to <logdir>/metrics.jsonl (the loss terms, num_pos,
matched_iou, grad_norm, step, wall_s); every --save-every steps and at the
last, the detector's state dict under the reference's mmdet3d names goes to
<logdir>/ckpt_<step>.pth, which `detection_eval --checkpoint` loads strict
(the JAX CLI pickles its param tree as ckpt_<step>.pkl). It runs on the
card unless --device cpu.

The weights start from torch's defaults under --seed (JAX's draws come from
detector.init). The data draws are JAX's: one generator seeded --seed, the
GT sampler's own seeded 0, and the draws of JAX's initialisation batch
(sample 0) made and dropped before the first step. The port plans the
rulebooks per cloud, unpadded, so --calibrate changes nothing (a line says
so), and --batch-size > 1 runs the batched step over that many samples.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

NUSC_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)
SAMPLE_GROUPS = {"car": 2, "truck": 3, "bus": 4, "trailer": 6, "construction_vehicle": 7, "traffic_cone": 2,
                 "barrier": 6, "motorcycle": 6, "bicycle": 6, "pedestrian": 2}
GRID = dict(voxel_size=(0.075, 0.075, 0.2), pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--logdir", default="runs/detector")
    p.add_argument("--max-steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--max-gt", type=int, default=128)
    p.add_argument("--max-voxels", type=int, default=120000)
    p.add_argument("--sweeps", type=int, default=9)
    p.add_argument("--camera", action="store_true", help="train the camera+lidar fusion variant")
    p.add_argument("--gt-db", default=None, help="gt_db_infos.pkl for paste augmentation")
    p.add_argument("--calibrate", type=int, default=8,
                   help="accepted for the JAX CLI's sake; the port plans rulebooks unpadded, so it changes nothing")
    p.add_argument("--batch-size", type=int, default=1,
                   help=">1 runs the batched step: the mean loss over that many samples, one update")
    p.add_argument("--image-aug", action="store_true",
                   help="random per-view ImageAug3D on the camera branch (affines folded into the projections)")
    p.add_argument("--grid-mask", type=float, default=0.0, help="GridMask occlusion probability on camera views")
    p.add_argument("--save-every", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="the training device (default cuda)")
    return p.parse_args(argv)


def main(argv=None, timings: Optional[List[Dict]] = None, overrides: Optional[Dict] = None) -> List[Dict]:
    """Parse `argv` and train; returns each step's metrics (floats). With
    `timings`, one dict a step is appended: the host seconds of the data
    pipeline and of planning its samples, and the step's card milliseconds
    (forward, loss, backward and update, CUDA events; on the CPU its wall).
    `overrides` swaps the production grid and detector for a small one:
    voxel_size, pc_range, num_proposals, image_size, lss_kwargs."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from mobi_tpu_torch.data.det_pipeline import GTDatabaseSampler, train_pipeline
    from mobi_tpu_torch.data.detection_dataset import DetectionSceneDataset
    from mobi_tpu_torch.models.bevfusion import BEVFusionDetector, prepare_lidar_inputs
    from mobi_tpu_torch.models.detector_training import (
        camera_batch_inputs, camera_model_inputs, gt_tensors, make_batched_detector_train_step,
        make_detector_optimizer, make_detector_train_step)
    from mobi_tpu_torch.models.transfusion_loss import TransFusionLossConfig

    ov = dict(overrides or {})
    voxel_size, pc_range = ov.get("voxel_size", GRID["voxel_size"]), ov.get("pc_range", GRID["pc_range"])
    num_proposals, image_size = ov.get("num_proposals", 200), tuple(ov.get("image_size", (256, 704)))

    os.makedirs(args.logdir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    dataset = DetectionSceneDataset(args.dataroot, args.version, load_images=args.camera,
                                    image_size=image_size if args.camera else None)
    sampler = GTDatabaseSampler(args.gt_db, sample_groups=SAMPLE_GROUPS) if args.gt_db else None

    torch.manual_seed(args.seed)
    lss_kwargs = ov.get("lss_kwargs") or (dict(image_size=image_size, feature_size=(image_size[0] // 8,
                                                                                    image_size[1] // 8))
                                         if args.camera else None)
    model = BEVFusionDetector(use_camera=args.camera, num_proposals=num_proposals, lss_kwargs=lss_kwargs,
                              head_kwargs=dict(voxel_size=tuple(voxel_size[:2]), pc_range=tuple(pc_range[:2])),
                              device=args.device)
    dev = model.device
    tx = make_detector_optimizer(model, args.lr, total_steps=args.max_steps)
    loss_cfg = TransFusionLossConfig(num_proposals=num_proposals, pc_range=tuple(pc_range),
                                     voxel_size=tuple(voxel_size[:2]))
    step_fn = (make_batched_detector_train_step(model, tx, loss_cfg) if args.batch_size > 1
               else make_detector_train_step(model, tx, loss_cfg))
    if args.calibrate > 0:
        print(f"--calibrate {args.calibrate}: accepted, changes nothing (the port plans each cloud's "
              "rulebooks unpadded; no static caps)", flush=True)

    def host_example(i):
        """The host draws of sample i: the augmented cloud, its boxes and
        the camera inputs, in JAX's make_batch order."""
        j = i % len(dataset)
        ex = train_pipeline(dataset.tables.sample_record(dataset._samples[j]), NUSC_CLASSES, rng,
                            pc_range=pc_range, sweeps_num=args.sweeps, sampler=sampler)
        cam = (camera_batch_inputs(ex["points"], ex["lidar_aug_matrix"], dataset[j], rng=rng,
                                   image_aug=args.image_aug, grid_mask_prob=args.grid_mask)
               if args.camera else None)
        return ex, cam

    def make_batch(i, clock):
        t0 = time.perf_counter()
        ex, cam = host_example(i)
        t1 = time.perf_counter()
        batch = {"lidar": prepare_lidar_inputs(ex["points"], voxel_size=voxel_size, pc_range=pc_range,
                                               max_voxels=args.max_voxels, device=dev),
                 **gt_tensors(ex["gt_bboxes_3d"], ex["gt_labels_3d"], args.max_gt, dev)}
        if cam is not None:
            batch["camera"] = camera_model_inputs(model, cam)
        clock["pipeline_s"] += t1 - t0
        clock["plan_s"] += time.perf_counter() - t1
        return batch

    print(f"detector: {sum(t.numel() for t in tx.tensors)} trained floats ({len(dataset)} samples)", flush=True)
    host_example(0)  # JAX draws its initialisation batch from the same generators
    metrics_path = os.path.join(args.logdir, "metrics.jsonl")
    history: List[Dict] = []
    t_start = time.time()
    for step in range(1, args.max_steps + 1):
        clock = {"pipeline_s": 0.0, "plan_s": 0.0}
        if args.batch_size > 1:
            batch = [make_batch(step * args.batch_size + j, clock) for j in range(args.batch_size)]
        else:
            batch = make_batch(step, clock)
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        m = step_fn(batch)
        if dev.type == "cuda":
            end.record()
            end.synchronize()
            step_ms = start.elapsed_time(end)
        else:
            step_ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in m.items()}
        history.append({**m, "step": step})
        if timings is not None:
            timings.append({**clock, "step_ms": step_ms, "voxels": int(
                sum(b["lidar"][0].shape[0] for b in (batch if isinstance(batch, list) else [batch])))})
        if step % 10 == 0:
            m.update(step=step, wall_s=time.time() - t_start)
            with open(metrics_path, "a") as f:
                f.write(json.dumps(m) + "\n")
            print(f"step {step} loss {m['loss']:.4f} (cls {m['loss_cls']:.3f} bbox {m['loss_bbox']:.3f} "
                  f"hm {m['loss_heatmap']:.3f} pos {m['num_pos']:.0f})", flush=True)
        if step % args.save_every == 0 or step == args.max_steps:
            torch.save({"state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
                       os.path.join(args.logdir, f"ckpt_{step}.pth"))
    print("done", flush=True)
    return history


if __name__ == "__main__":
    main()
