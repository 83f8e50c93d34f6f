"""TransFusion head training loss: Hungarian matching, then focal and L1
terms (mobi_tpu models/transfusion_loss.py; the reference's
heads/bbox/transfusion.py get_targets_single :408-586 and loss :588-714,
HungarianAssigner3D with its costs, core/bbox/assigners/
hungarian_assigner.py:14-142, and TransFusionBBoxCoder.encode,
coders/transfusion_bbox_coder.py:24-37). Weights default to the shipped
nuScenes config.

GT boxes arrive padded to a fixed count with a validity mask, as in JAX.
The costs are built on the predictions' device; the assignment is solved
on the host in numpy (`lapjv`, a line-for-line copy of JAX's `_lapjv_device`,
so the matching equals JAX's and not just some optimum): one copy of the
[B, P, G] cost matrix a step, where an eager loop on the device would be
~G^2 tiny launches. Heatmap targets are one [G, H, W] gaussian evaluation
and a max-scatter over classes.

Predictions are the port's head outputs: `heatmap`, `center`, `height`,
`dim`, `rot`, `vel` [B, P, *] and `dense_heatmap` NCHW [B, C, H, W].
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mobi_tpu_torch.ops.box3d import iou_3d

BIG = 1e6  # the cost of an invalid gt column: never chosen over a valid one


@dataclasses.dataclass(frozen=True)
class TransFusionLossConfig:
    num_classes: int = 10
    num_proposals: int = 200
    pc_range: Tuple[float, ...] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    voxel_size: Tuple[float, float] = (0.075, 0.075)
    out_size_factor: int = 8
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    code_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)
    cls_cost_weight: float = 0.15
    reg_cost_weight: float = 0.25
    iou_cost_weight: float = 0.25
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    loss_cls_weight: float = 1.0
    loss_bbox_weight: float = 0.25
    loss_heatmap_weight: float = 1.0


def gaussian_radius(dims_feat: torch.Tensor, min_overlap: float) -> torch.Tensor:
    """CenterNet's gaussian radius of [..., 2] (length, width) in feature
    cells (mmdet3d.core.utils.gaussian_radius)."""
    length, width = dims_feat[..., 0], dims_feat[..., 1]
    b1 = length + width
    c1 = width * length * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1**2 - 4 * 1.0 * c1, min=0.0))) / 2
    b2 = 2 * (length + width)
    c2 = (1 - min_overlap) * width * length
    r2 = (b2 + torch.sqrt(torch.clamp(b2**2 - 4 * 4.0 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (length + width)
    c3 = (min_overlap - 1) * width * length
    r3 = (b3 + torch.sqrt(torch.clamp(b3**2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_heatmap_targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                         cfg: TransFusionLossConfig, feat_h: int, feat_w: int) -> torch.Tensor:
    """[C, H, W] gaussian heatmap targets of [G, >=7] boxes (x, y, z_bottom,
    dx, dy, dz, yaw, ...) (get_targets_single :527-586)."""
    step_x = cfg.voxel_size[0] * cfg.out_size_factor
    step_y = cfg.voxel_size[1] * cfg.out_size_factor
    w_feat = gt_boxes[:, 3] / step_x
    l_feat = gt_boxes[:, 4] / step_y
    radius = gaussian_radius(torch.stack([l_feat, w_feat], -1), cfg.gaussian_overlap)
    radius = torch.clamp(torch.floor(radius), min=float(cfg.min_radius))
    valid = gt_mask & (w_feat > 0) & (l_feat > 0)
    # integer centres, as draw_heatmap_gaussian's int coordinates
    cx = torch.floor((gt_boxes[:, 0] - cfg.pc_range[0]) / step_x)
    cy = torch.floor((gt_boxes[:, 1] - cfg.pc_range[1]) / step_y)
    ys = torch.arange(feat_h, dtype=torch.float32, device=gt_boxes.device)
    xs = torch.arange(feat_w, dtype=torch.float32, device=gt_boxes.device)
    dy = ys[None, :, None] - cy[:, None, None]  # [G, H, 1]
    dx = xs[None, None, :] - cx[:, None, None]  # [G, 1, W]
    sigma = (2 * radius + 1) / 6.0
    gauss = torch.exp(-(dx**2 + dy**2) / (2 * sigma[:, None, None] ** 2))
    # only the [2r+1, 2r+1] window of each valid gt
    r = radius[:, None, None]
    inside = (torch.abs(dx) <= r) & (torch.abs(dy) <= r)
    gauss = torch.where(inside & valid[:, None, None], gauss, torch.zeros_like(gauss))
    heatmap = torch.zeros(cfg.num_classes, feat_h, feat_w, device=gt_boxes.device)
    labels = torch.clamp(gt_labels.long(), 0, cfg.num_classes - 1)
    return heatmap.scatter_reduce_(0, labels[:, None, None].expand_as(gauss), gauss, "amax", include_self=True)


def lapjv(cost: np.ndarray) -> np.ndarray:
    """Optimal rectangular assignment of cost [R, C], R <= C: every row a
    distinct column; returns col4row [R] int32. Jonker-Volgenant's
    shortest augmenting paths (scipy's linear_sum_assignment algorithm),
    step for step as JAX's `_lapjv_device` (transfusion_loss.py:138-217):
    rows in order, the next column the least unscanned path cost with ties
    to an unassigned column (scipy's `<= lowest && row4col[j] == -1`), then
    the lowest index; the same dual updates, in float32."""
    R, C = cost.shape
    cost = np.asarray(cost, np.float32)
    f32, inf = np.float32, np.float32(np.inf)
    u, v = np.zeros(R, f32), np.zeros(C, f32)
    row4col, col4row = np.full(C, -1, np.int32), np.full(R, -1, np.int32)
    rows = np.arange(R)
    for cur_row in range(R):
        i, minval = cur_row, f32(0.0)
        shortest, pred = np.full(C, inf, f32), np.full(C, cur_row, np.int32)
        SC, SR = np.zeros(C, bool), np.zeros(R, bool)
        sink = -1
        while sink == -1:
            SR[i] = True
            r = minval + cost[i] - u[i] - v  # [C] path costs through row i
            upd = (r < shortest) & ~SC
            shortest = np.where(upd, r, shortest)
            pred = np.where(upd, i, pred).astype(np.int32)
            masked = np.where(SC, inf, shortest)
            unassigned = (masked <= masked.min()) & (row4col == -1)
            j = int(np.argmax(unassigned)) if unassigned.any() else int(np.argmin(masked))
            SC[j] = True
            if row4col[j] == -1:
                sink = j
            else:
                i = int(row4col[j])
            minval = masked[j]
        # dual updates (scipy _lsap.c): scanned rows and columns move by the
        # slack between minval and their shortest path cost
        u[cur_row] = u[cur_row] + minval
        row_shift = minval - shortest[np.clip(col4row, 0, C - 1)]
        u = np.where(SR & (rows != cur_row), u + row_shift, u)
        v = np.where(SC, v - (minval - shortest), v)
        # augment: walk the predecessors back from the sink
        j = sink
        while True:
            i = int(pred[j])
            row4col[j] = i
            j_next = int(col4row[i])
            col4row[i] = j
            j = j_next
            if i == cur_row:
                break
    return col4row


def hungarian_assign(cost: np.ndarray) -> np.ndarray:
    """Optimal matching of cost [P, G] (P proposals >= G gt columns) on the
    host: [P] matched gt index or -1. Solves the transposed [G, P] problem
    (every gt a distinct proposal) with `lapjv`, as JAX's
    `hungarian_assign` (transfusion_loss.py:220-243) does."""
    P, G = cost.shape
    if G > P:
        raise ValueError(f"hungarian_assign needs proposals >= gt columns, got P={P} < G={G}; "
                         "raise num_proposals or lower max_gt")
    match = np.full(P, -1, np.int32)
    match[lapjv(np.asarray(cost).T)] = np.arange(G, dtype=np.int32)
    return match


def encode_gt_boxes(gt_boxes: torch.Tensor, cfg: TransFusionLossConfig) -> torch.Tensor:
    """[..., 9] metric boxes -> [..., 10] regression codes
    (transfusion_bbox_coder.py:24-37)."""
    step_x = cfg.voxel_size[0] * cfg.out_size_factor
    step_y = cfg.voxel_size[1] * cfg.out_size_factor
    return torch.cat([
        ((gt_boxes[..., 0] - cfg.pc_range[0]) / step_x)[..., None],
        ((gt_boxes[..., 1] - cfg.pc_range[1]) / step_y)[..., None],
        (gt_boxes[..., 2] + gt_boxes[..., 5] * 0.5)[..., None],  # bottom -> gravity centre
        torch.log(torch.clamp(gt_boxes[..., 3:6], min=1e-6)),
        torch.sin(gt_boxes[..., 6])[..., None],
        torch.cos(gt_boxes[..., 6])[..., None],
        gt_boxes[..., 7:9],
    ], dim=-1)


def _decode_pred_boxes(preds: Dict[str, torch.Tensor], cfg: TransFusionLossConfig) -> torch.Tensor:
    """Detached predictions -> metric [B, P, 9] boxes for the matching
    (get_targets_single :427-440)."""
    center, height = preds["center"].detach(), preds["height"].detach()
    dim, rot, vel = torch.exp(preds["dim"].detach()), preds["rot"].detach(), preds["vel"].detach()
    cx = center[..., 0] * cfg.out_size_factor * cfg.voxel_size[0] + cfg.pc_range[0]
    cy = center[..., 1] * cfg.out_size_factor * cfg.voxel_size[1] + cfg.pc_range[1]
    z = height[..., 0] - dim[..., 2] * 0.5
    yaw = torch.atan2(rot[..., 0], rot[..., 1])
    return torch.cat([torch.stack([cx, cy, z], -1), dim, yaw[..., None], vel], dim=-1)


def _focal_cls_cost(scores: torch.Tensor, gt_labels: torch.Tensor, cfg: TransFusionLossConfig) -> torch.Tensor:
    """mmdet's FocalLossCost: [P, C] sigmoid scores against [G] labels ->
    [P, G]."""
    eps = 1e-12
    p = scores
    pos = -torch.log(p + eps) * cfg.focal_alpha * (1 - p) ** cfg.focal_gamma
    neg = -torch.log(1 - p + eps) * (1 - cfg.focal_alpha) * p**cfg.focal_gamma
    return (pos - neg)[:, gt_labels.long()] * cfg.cls_cost_weight


def optax_sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy's formula."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def _sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, cfg: TransFusionLossConfig) -> torch.Tensor:
    """Elementwise sigmoid focal loss (mmdet FocalLoss, use_sigmoid)."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = cfg.focal_alpha * targets + (1 - cfg.focal_alpha) * (1 - targets)
    return alpha_t * ((1 - p_t) ** cfg.focal_gamma) * ce


def gaussian_focal_loss(pred_sig: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The penalty-reduced CenterNet focal loss (mmdet GaussianFocalLoss),
    summed."""
    eps = 1e-12
    pos_w = (target == 1.0).to(pred_sig.dtype)
    neg_w = (1 - target) ** 4
    pos = -torch.log(pred_sig + eps) * (1 - pred_sig) ** 2 * pos_w
    neg = -torch.log(1 - pred_sig + eps) * pred_sig**2 * neg_w * (1 - pos_w)
    return (pos + neg).sum()


def matching_costs(preds: Dict[str, torch.Tensor], gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_mask: torch.Tensor, cfg: TransFusionLossConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The assigner's [B, P, G] cost (hungarian_assigner.py:112-120: focal
    class cost, L1 of the normalised BEV centres, -IoU; invalid gt columns
    BIG) and the [B, P, G] 3D IoU, on the predictions' device, detached."""
    pred_boxes = _decode_pred_boxes(preds, cfg)
    scores = torch.sigmoid(preds["heatmap"]).detach()
    dev = pred_boxes.device
    pc_lo = torch.tensor(cfg.pc_range[0:2], dtype=torch.float32, device=dev)
    pc_span = torch.tensor(cfg.pc_range[3:5], dtype=torch.float32, device=dev) - pc_lo
    costs, ious = [], []
    for b in range(pred_boxes.shape[0]):
        cls_cost = _focal_cls_cost(scores[b], gt_labels[b], cfg)
        nb = (pred_boxes[b, :, :2] - pc_lo) / pc_span
        ng = (gt_boxes[b, :, :2] - pc_lo) / pc_span
        reg_cost = torch.abs(nb[:, None] - ng[None]).sum(-1) * cfg.reg_cost_weight
        iou = iou_3d(pred_boxes[b, :, :7], gt_boxes[b, :, :7])
        cost = cls_cost + reg_cost + -iou * cfg.iou_cost_weight
        costs.append(torch.where(gt_mask[b][None, :], cost, torch.full_like(cost, BIG)))
        ious.append(iou)
    return torch.stack(costs), torch.stack(ious)


def transfusion_loss(preds: Dict[str, torch.Tensor], gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_mask: torch.Tensor,
                     cfg: TransFusionLossConfig = TransFusionLossConfig(), return_match: bool = False):
    """The TransFusion training loss of one forward of the head (loss
    :588-714): gt_boxes [B, G, 9] (x, y, z_bottom, dx, dy, dz, yaw, vx, vy),
    gt_labels [B, G], gt_mask [B, G] bool. Returns (total, metrics), and
    with `return_match` the [B, P] matched gt index (-1 unmatched) too."""
    B, P, C = preds["heatmap"].shape
    G = gt_boxes.shape[1]
    feat_h, feat_w = preds["dense_heatmap"].shape[2:4]
    dev = preds["heatmap"].device

    cost, iou = matching_costs(preds, gt_boxes, gt_labels, gt_mask, cfg)
    cost_host = cost.cpu().numpy()
    match = torch.from_numpy(np.stack([hungarian_assign(c) for c in cost_host])).to(dev).long()  # [B, P]
    match_c = torch.clamp(match, 0, max(G - 1, 0))
    pos_mask = (match >= 0) & torch.gather(gt_mask, 1, match_c)

    # classification targets: the matched label, else background (= C)
    labels = torch.where(pos_mask, torch.gather(gt_labels.long(), 1, match_c), torch.full_like(match_c, C))
    one_hot = F.one_hot(labels, C + 1)[..., :C].to(preds["heatmap"].dtype)  # background -> all zeros
    num_pos = torch.clamp(pos_mask.sum(), min=1).to(torch.float32)
    loss_cls = (_sigmoid_focal_loss(preds["heatmap"], one_hot, cfg).sum() / num_pos) * cfg.loss_cls_weight

    # box regression on the matched proposals
    pred_code = torch.cat([preds["center"], preds["height"], preds["dim"], preds["rot"], preds["vel"]], dim=-1)
    gt_code = encode_gt_boxes(gt_boxes, cfg)
    tgt_code = torch.gather(gt_code, 1, match_c[..., None].expand(-1, -1, gt_code.shape[-1]))
    cw = torch.tensor(cfg.code_weights, dtype=pred_code.dtype, device=dev)
    l1 = torch.abs(pred_code - tgt_code) * cw
    l1 = torch.where(pos_mask[..., None], l1, torch.zeros_like(l1))
    loss_bbox = (l1.sum() / (num_pos * 10.0)) * cfg.loss_bbox_weight

    # dense heatmap
    with torch.no_grad():
        hm_target = torch.stack([draw_heatmap_targets(gt_boxes[b], gt_labels[b], gt_mask[b], cfg, feat_h, feat_w)
                                 for b in range(B)])
    hm_pred = torch.clamp(torch.sigmoid(preds["dense_heatmap"]), 1e-4, 1 - 1e-4)
    n_peaks = torch.clamp((hm_target == 1.0).sum(), min=1).to(torch.float32)
    loss_heatmap = (gaussian_focal_loss(hm_pred, hm_target) / n_peaks) * cfg.loss_heatmap_weight

    matched_iou = torch.where(pos_mask, torch.gather(iou, 2, match_c[..., None])[..., 0], torch.zeros_like(iou[..., 0]))
    total = loss_cls + loss_bbox + loss_heatmap
    metrics = {
        "loss": total,
        "loss_cls": loss_cls,
        "loss_bbox": loss_bbox,
        "loss_heatmap": loss_heatmap,
        "num_pos": pos_mask.sum().to(torch.float32),
        "matched_iou": matched_iou.sum() / num_pos,
    }
    return (total, metrics, match) if return_match else (total, metrics)
