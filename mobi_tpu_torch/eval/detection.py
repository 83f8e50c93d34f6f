"""nuScenes-style detection evaluation with the MObI edited-scenes patches.

The port's copy of mobi_tpu/eval/detection.py, numpy only: the devkit's
detection eval (nuscenes/eval/detection/{evaluate.py:63-180,
algo.py:13-230, data_classes.py} and eval/common/utils.py:15-169), with the
MObI additions:

  * `edited_samples_path` — a directory containing `objects.json`
    ({sample_token: [tracking_id, ...]}) listing the inserted/edited objects;
    evaluation is restricted to samples that were edited.
  * `edited_objects_restrict` — when true, only matches whose GT tracking_id
    is among the edited objects accumulate TP metrics; unmatched predictions
    are NOT counted as false positives and AP is reported as 0 (the
    reference's restricted mode skips PR interpolation entirely,
    algo.py:140-149).

Metrics: per-class AP over center-distance thresholds (0.5/1/2/4 m), TP
errors (ATE/ASE/AOE/AVE/AAE) at the 2 m threshold, mAP and NDS
(nd_score = (5*mAP + sum(max(0, 1-err))) / 10).

Design: boxes are plain dataclass records grouped per sample; the greedy
confidence-ordered matching is sequential by construction, but per-candidate
distances are vectorized per sample.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")

DETECTION_CLASSES = (
    "car", "truck", "bus", "trailer", "construction_vehicle",
    "pedestrian", "motorcycle", "bicycle", "traffic_cone", "barrier",
)

# devkit detection_cvpr_2019 configuration
DEFAULT_CLASS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}
N_ELEM = 101  # recall sampling points


@dataclasses.dataclass(frozen=True)
class DetectionConfig:
    class_names: Sequence[str] = DETECTION_CLASSES
    class_range: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_CLASS_RANGE)
    )
    dist_ths: Sequence[float] = (0.5, 1.0, 2.0, 4.0)
    dist_th_tp: float = 2.0
    min_recall: float = 0.1
    min_precision: float = 0.1
    max_boxes_per_sample: int = 500
    mean_ap_weight: float = 5.0


@dataclasses.dataclass
class DetBox:
    """One GT annotation or one predicted box (global or lidar frame —
    evaluation only needs a consistent frame)."""

    sample_token: str
    translation: Tuple[float, float, float]
    size: Tuple[float, float, float]          # w, l, h
    yaw: float
    velocity: Tuple[float, float] = (0.0, 0.0)
    detection_name: str = "car"
    detection_score: float = -1.0             # predictions only
    attribute_name: str = ""
    tracking_id: str = ""                     # GT only (ann token)
    num_pts: int = -1                          # GT only
    ego_dist: float = 0.0


Boxes = Dict[str, List[DetBox]]


# ---------------------------------------------------------------- box metrics
def center_distance(a: DetBox, b: DetBox) -> float:
    return float(np.hypot(a.translation[0] - b.translation[0],
                          a.translation[1] - b.translation[1]))


def velocity_l2(a: DetBox, b: DetBox) -> float:
    return float(np.hypot(a.velocity[0] - b.velocity[0],
                          a.velocity[1] - b.velocity[1]))


def yaw_diff(a: DetBox, b: DetBox, period: float = 2 * np.pi) -> float:
    d = (a.yaw - b.yaw + period / 2) % period - period / 2
    if d > np.pi:
        d -= 2 * np.pi
    return abs(d)


def scale_iou(a: DetBox, b: DetBox) -> float:
    sa, sb = np.asarray(a.size, float), np.asarray(b.size, float)
    inter = float(np.prod(np.minimum(sa, sb)))
    return inter / (float(np.prod(sa)) + float(np.prod(sb)) - inter)


def attr_acc(gt: DetBox, pred: DetBox) -> float:
    if gt.attribute_name == "":
        return np.nan
    return float(gt.attribute_name == pred.attribute_name)


def cummean(x: np.ndarray) -> np.ndarray:
    """NaN-aware cumulative mean (devkit common/utils.py:156-169)."""
    if np.isnan(x).all():
        return np.ones(len(x))
    s = np.nancumsum(x.astype(float))
    n = np.cumsum(~np.isnan(x))
    return np.divide(s, n, out=np.zeros_like(s), where=n != 0)


# ---------------------------------------------------------------- filtering
def filter_eval_boxes(
    boxes: Boxes, class_range: Dict[str, float], is_gt: bool
) -> Boxes:
    """Distance filter by ego range per class; GT additionally drops boxes
    without lidar/radar points (devkit loaders.filter_eval_boxes; the
    bike-rack map filter needs map layers and is intentionally omitted)."""
    out: Boxes = {}
    for token, blist in boxes.items():
        kept = [
            b for b in blist
            if b.detection_name in class_range
            and b.ego_dist < class_range[b.detection_name]
            and not (is_gt and b.num_pts == 0)
        ]
        out[token] = kept
    return out


def add_center_dist(boxes: Boxes, ego_positions: Dict[str, Sequence[float]]) -> Boxes:
    """ego_dist = planar distance from the ego pose of the sample."""
    for token, blist in boxes.items():
        ego = np.asarray(ego_positions.get(token, (0.0, 0.0, 0.0)), float)
        for b in blist:
            b.ego_dist = float(
                np.hypot(b.translation[0] - ego[0], b.translation[1] - ego[1])
            )
    return boxes


# ------------------------------------------------------------------ metric md
@dataclasses.dataclass
class MetricData:
    recall: np.ndarray
    precision: np.ndarray
    confidence: np.ndarray
    trans_err: np.ndarray
    vel_err: np.ndarray
    scale_err: np.ndarray
    orient_err: np.ndarray
    attr_err: np.ndarray

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.confidence)[0]
        return -1 if len(nz) == 0 else int(nz[-1])

    @classmethod
    def no_predictions(cls) -> "MetricData":
        z = np.zeros(N_ELEM)
        o = np.ones(N_ELEM)
        return cls(np.linspace(0, 1, N_ELEM), z, z, o, o, o, o, o)


def accumulate(
    gt_boxes: Boxes,
    pred_boxes: Boxes,
    class_name: str,
    dist_th: float,
    dist_fcn: Callable[[DetBox, DetBox], float] = center_distance,
    restricted: bool = False,
    inserted_boxes: Optional[Dict[str, Set[str]]] = None,
) -> MetricData:
    """Greedy confidence-ordered matching for one (class, threshold)
    (devkit algo.py:13-192 with the MObI restricted-mode patch)."""
    if inserted_boxes is not None:
        gt_boxes = {t: b for t, b in gt_boxes.items() if t in inserted_boxes}
        pred_boxes = {t: b for t, b in pred_boxes.items() if t in inserted_boxes}

    npos = sum(
        1 for bl in gt_boxes.values() for b in bl
        if b.detection_name == class_name
    )
    if npos == 0:
        return MetricData.no_predictions()

    preds = [
        b for bl in pred_boxes.values() for b in bl
        if b.detection_name == class_name
    ]
    preds.sort(key=lambda b: -b.detection_score)

    taken: Set[Tuple[str, int]] = set()
    tp: List[int] = []
    fp: List[int] = []
    conf: List[float] = []
    match_data: Dict[str, List[float]] = {k: [] for k in TP_METRICS}
    match_conf: List[float] = []

    for pred in preds:
        gts = gt_boxes.get(pred.sample_token, [])
        min_dist, match_idx = np.inf, None
        for gi, gt in enumerate(gts):
            if gt.detection_name != class_name or (pred.sample_token, gi) in taken:
                continue
            d = dist_fcn(gt, pred)
            if d < min_dist:
                min_dist, match_idx = d, gi

        if min_dist < dist_th:
            taken.add((pred.sample_token, match_idx))
            gt = gts[match_idx]
            if restricted and gt.tracking_id not in inserted_boxes[pred.sample_token]:
                continue
            tp.append(1)
            fp.append(0)
            conf.append(pred.detection_score)
            period = np.pi if class_name == "barrier" else 2 * np.pi
            match_data["trans_err"].append(center_distance(gt, pred))
            match_data["vel_err"].append(velocity_l2(gt, pred))
            match_data["scale_err"].append(1 - scale_iou(gt, pred))
            match_data["orient_err"].append(yaw_diff(gt, pred, period))
            match_data["attr_err"].append(1 - attr_acc(gt, pred))
            match_conf.append(pred.detection_score)
        elif not restricted:
            tp.append(0)
            fp.append(1)
            conf.append(pred.detection_score)

    if not match_data["trans_err"]:
        return MetricData.no_predictions()

    if restricted:
        # restricted mode: no PR interpolation — raw per-match errors, AP
        # reads as 0 from the zero precision curve (algo.py:140-149)
        rec = np.linspace(0, 1, N_ELEM)
        prec = np.zeros_like(rec)
        out_conf = np.asarray(conf)
        errs = {k: np.asarray(v) for k, v in match_data.items()}
        return MetricData(rec, prec, out_conf, errs["trans_err"],
                          errs["vel_err"], errs["scale_err"],
                          errs["orient_err"], errs["attr_err"])

    tp_c = np.cumsum(tp).astype(float)
    fp_c = np.cumsum(fp).astype(float)
    conf_a = np.asarray(conf)
    prec = tp_c / (tp_c + fp_c)
    rec = tp_c / float(npos)
    rec_interp = np.linspace(0, 1, N_ELEM)
    prec = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf_a, right=0)

    errs = {}
    mc = np.asarray(match_conf)
    for k in TP_METRICS:
        tmp = cummean(np.asarray(match_data[k]))
        errs[k] = np.interp(conf_i[::-1], mc[::-1], tmp[::-1])[::-1]

    return MetricData(rec_interp, prec, conf_i, errs["trans_err"],
                      errs["vel_err"], errs["scale_err"], errs["orient_err"],
                      errs["attr_err"])


def calc_ap(md: MetricData, min_recall: float, min_precision: float) -> float:
    prec = np.copy(md.precision)[round(100 * min_recall) + 1:]
    prec = np.clip(prec - min_precision, 0, None)
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md: MetricData, min_recall: float, metric_name: str) -> float:
    first = round(100 * min_recall) + 1
    last = md.max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(getattr(md, metric_name)[first:last + 1]))


# ------------------------------------------------------------------ evaluator
class DetectionEval:
    """Whole-split evaluation (devkit evaluate.py:63-180 + MObI patches)."""

    def __init__(
        self,
        gt_boxes: Boxes,
        pred_boxes: Boxes,
        config: Optional[DetectionConfig] = None,
        edited_samples_path: Optional[str] = None,
        edited_objects_restrict: bool = False,
        ego_positions: Optional[Dict[str, Sequence[float]]] = None,
        verbose: bool = False,
    ):
        self.cfg = config or DetectionConfig()
        self.verbose = verbose

        self.inserted_boxes: Optional[Dict[str, Set[str]]] = None
        if edited_samples_path is not None:
            with open(os.path.join(edited_samples_path, "objects.json")) as f:
                raw = json.load(f)
            assert isinstance(raw, dict), "objects.json must be a dict"
            self.inserted_boxes = {
                k: set(v if isinstance(v, (list, set, tuple)) else [v])
                for k, v in raw.items()
            }
        self.restrict_eval = edited_objects_restrict
        assert not (self.restrict_eval and self.inserted_boxes is None), (
            "edited_objects_restrict requires edited_samples_path"
        )

        if ego_positions:
            gt_boxes = add_center_dist(gt_boxes, ego_positions)
            pred_boxes = add_center_dist(pred_boxes, ego_positions)
        self.gt_boxes = filter_eval_boxes(gt_boxes, self.cfg.class_range, True)
        self.pred_boxes = filter_eval_boxes(
            pred_boxes, self.cfg.class_range, False
        )

    def evaluate(self) -> Dict[str, object]:
        cfg = self.cfg
        label_aps: Dict[str, Dict[float, float]] = {}
        label_tps: Dict[str, Dict[str, float]] = {}
        for cls in cfg.class_names:
            mds = {}
            for th in cfg.dist_ths:
                mds[th] = accumulate(
                    self.gt_boxes, self.pred_boxes, cls, th,
                    restricted=self.restrict_eval,
                    inserted_boxes=self.inserted_boxes,
                )
            label_aps[cls] = {
                th: calc_ap(mds[th], cfg.min_recall, cfg.min_precision)
                for th in cfg.dist_ths
            }
            md_tp = mds[cfg.dist_th_tp]
            tps = {}
            for m in TP_METRICS:
                if cls == "traffic_cone" and m in ("attr_err", "vel_err", "orient_err"):
                    tps[m] = np.nan
                elif cls == "barrier" and m in ("attr_err", "vel_err"):
                    tps[m] = np.nan
                elif self.restrict_eval:
                    # restricted mode averages the raw matched errors
                    vals = getattr(md_tp, m)
                    tps[m] = float(np.nanmean(vals)) if len(vals) else 1.0
                else:
                    tps[m] = calc_tp(md_tp, cfg.min_recall, m)
            label_tps[cls] = tps

        mean_ap = float(np.mean([
            ap for aps in label_aps.values() for ap in aps.values()
        ]))
        tp_errors = {
            m: float(np.nanmean([label_tps[c][m] for c in cfg.class_names]))
            for m in TP_METRICS
        }
        tp_scores = {
            m: max(0.0, 1.0 - e) if not np.isnan(e) else 0.0
            for m, e in tp_errors.items()
        }
        nd_score = (
            cfg.mean_ap_weight * mean_ap + sum(tp_scores.values())
        ) / (cfg.mean_ap_weight + len(TP_METRICS))

        return {
            "label_aps": label_aps,
            "label_tp_errors": label_tps,
            "mean_ap": mean_ap,
            "tp_errors": tp_errors,
            "tp_scores": tp_scores,
            "nd_score": float(nd_score),
        }


# ------------------------------------------------------------------- loaders
def load_prediction(result_path: str, max_boxes: int = 500) -> Boxes:
    """nuScenes submission-format results.json -> Boxes (devkit
    common/loaders.load_prediction)."""
    with open(result_path) as f:
        data = json.load(f)
    results = data["results"] if "results" in data else data
    out: Boxes = {}
    for token, dets in results.items():
        assert len(dets) <= max_boxes, (
            f"{len(dets)} boxes for {token} exceeds {max_boxes}"
        )
        out[token] = [
            DetBox(
                sample_token=token,
                translation=tuple(d["translation"]),
                size=tuple(d["size"]),
                yaw=_quat_yaw(d["rotation"]) if "rotation" in d else d.get("yaw", 0.0),
                velocity=tuple(d.get("velocity", (0.0, 0.0))[:2]),
                detection_name=d["detection_name"],
                detection_score=float(d.get("detection_score", -1.0)),
                attribute_name=d.get("attribute_name", ""),
            )
            for d in dets
        ]
    return out


def load_gt_from_tables(tables) -> Tuple[Boxes, Dict[str, Sequence[float]]]:
    """GT DetBoxes (GLOBAL frame, like devkit load_gt: annotation
    translation/rotation used directly) + per-sample ego positions from the
    LIDAR_TOP ego pose. `tables` is a `data.nuscenes_tables.NuScenesTables`.

    tracking_id = instance_token (devkit loaders.py:141-147 and
    nuscenes_converter.py:296 — the id space of MObI's objects.json).
    """
    from mobi_tpu_torch.data.nuscenes_tables import CLASS_MAP

    gt: Boxes = {}
    ego: Dict[str, Sequence[float]] = {}
    attr_index = tables.index.get("attribute", {})
    for sample in tables.samples_of_split():
        token = sample["token"]
        lidar_sd = tables._sample_sd[token]["LIDAR_TOP"]
        ego_pose = tables.index["ego_pose"][lidar_sd["ego_pose_token"]]
        ego[token] = tuple(ego_pose["translation"])
        blist: List[DetBox] = []
        for ann in tables._sample_anns.get(token, []):
            name = CLASS_MAP.get(tables.category_name(ann))
            if name is None:
                continue
            attr_tokens = ann.get("attribute_tokens") or []
            attr = (
                attr_index[attr_tokens[0]]["name"]
                if attr_tokens and attr_tokens[0] in attr_index else ""
            )
            blist.append(DetBox(
                sample_token=token,
                translation=tuple(ann["translation"]),
                size=tuple(ann["size"]),
                yaw=_quat_yaw(ann["rotation"]),
                detection_name=name,
                attribute_name=attr,
                tracking_id=ann["instance_token"],
                num_pts=int(ann.get("num_lidar_pts", 0))
                + int(ann.get("num_radar_pts", 0)),
            ))
        gt[token] = blist
    return gt, ego


def _quat_yaw(q: Sequence[float]) -> float:
    """Yaw about +z of a [w, x, y, z] quaternion (devkit quaternion_yaw:
    the angle of the rotated +x axis in the xy plane)."""
    w, x, y, z = q
    vx = 1 - 2 * (y * y + z * z)
    vy = 2 * (x * y + z * w)
    return float(np.arctan2(vy, vx))
