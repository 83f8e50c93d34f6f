"""Downstream detection evaluation on (edited) nuScenes scenes, the CLI of
mobi_tpu's scripts/detection_eval.py with the same flags (the reference's
`bevfusion/tools/test.py ... --eval bbox --eval-options
edited_samples_path=samples-edited edited_objects_restrict=1`).

  python -m mobi_tpu_torch.detection_eval --dataroot /data/nuscenes \\
      --version v1.0-mini --results results.json --out-dir results/det \\
      [--edited-samples-path samples-edited] [--edited-objects-restrict] \\
      [--checkpoint bevfusion-det.pth --sweeps-num 10 [--use-camera]]

With `--checkpoint` the inference stage runs first
(`detector_inference.run_detector`, at the production grid, on the card
unless `--device cpu`, a flag the JAX CLI lacks) and writes --results.
The evaluation reads GT through the port's table reader (with the
edited-samples swap), runs `eval.detection.DetectionEval` and writes
`metrics_summary.json` under --out-dir.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None, timings=None):
    """Parse `argv`, run inference (with --checkpoint) and the evaluation;
    returns the metrics. `timings` is handed to `run_detector`."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--results", required=True, help="nuScenes results.json")
    p.add_argument("--out-dir", default="results/detection_eval")
    p.add_argument("--edited-samples-path", default=None,
                   help="relative dir under dataroot with edited sensor files + objects.json")
    p.add_argument("--edited-objects-restrict", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="reference-format detector .pth: run inference and write --results before evaluating")
    p.add_argument("--sweeps-num", type=int, default=10,
                   help="previous lidar sweeps aggregated per keyframe during inference (reference eval uses 10)")
    p.add_argument("--use-camera", action="store_true",
                   help="run the camera+lidar fusion model (default lidar-only)")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--verbose-inference", action="store_true", help="print per-sample inference timing")
    p.add_argument("--device", default=None, help="the inference device (default cuda)")
    args = p.parse_args(argv)

    if args.checkpoint:
        from mobi_tpu_torch.detector_inference import run_detector

        run_detector(
            args.dataroot, args.checkpoint, args.results, version=args.version,
            edited_samples_path=args.edited_samples_path, sweeps_num=args.sweeps_num,
            use_camera=args.use_camera, max_samples=args.max_samples, verbose=args.verbose_inference,
            device=args.device, timings=timings,
        )

    from mobi_tpu_torch.data.nuscenes_tables import NuScenesTables
    from mobi_tpu_torch.eval.detection import DetectionConfig, DetectionEval, load_gt_from_tables, load_prediction

    tables = NuScenesTables(args.dataroot, args.version, edited_samples_path=args.edited_samples_path)
    gt_boxes, ego_positions = load_gt_from_tables(tables)
    pred_boxes = load_prediction(args.results)
    for token in set(gt_boxes) - set(pred_boxes):  # the devkit expects every sample
        pred_boxes[token] = []

    edited_dir = os.path.join(args.dataroot, args.edited_samples_path) if args.edited_samples_path else None
    ev = DetectionEval(gt_boxes, pred_boxes, DetectionConfig(), edited_samples_path=edited_dir,
                       edited_objects_restrict=args.edited_objects_restrict,
                       ego_positions=ego_positions, verbose=True)
    metrics = ev.evaluate()

    os.makedirs(args.out_dir, exist_ok=True)
    out_path = os.path.join(args.out_dir, "metrics_summary.json")
    with open(out_path, "w") as f:
        json.dump(metrics, f, indent=2, default=float)
    print(f"mAP: {metrics['mean_ap']:.4f}")
    for m, v in metrics["tp_errors"].items():
        print(f"{m}: {v:.4f}")
    print(f"NDS: {metrics['nd_score']:.4f}")
    print(f"written to {out_path}")
    return metrics


if __name__ == "__main__":
    main()
