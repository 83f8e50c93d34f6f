"""CenterPoint detection head (mobi_tpu models/centerpoint.py; the
reference's mmdet3d/models/heads/bbox/centerpoint.py, SeparateHead :20-128
and CenterHead :249-846): dense per-class heatmaps and per-cell regression
maps over a BEV feature map, decoded by top-K peak picking. One task over
all classes, as the shipped BEVFusion config groups them.

Maps are NCHW. Module names follow the reference's (`shared_conv.conv`,
`task_heads.0.<head>.<i>.conv`, `task_heads.0.<head>.<last>`), but every
conv is a plain conv with a bias and no BatchNorm, as in the JAX package:
a reference CenterHead checkpoint (ConvModules with BN) loads into neither
(ROADMAP queue 3). `convert.centerpoint_state_dict` maps JAX's tree here.

Training targets reuse the TransFusion loss's gaussian heatmap drawing and
its gaussian focal loss; the regression target is read at each GT's floored
centre cell, padded GTs carrying zero weight.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mobi_tpu_torch.models.transfusion_loss import (TransFusionLossConfig, draw_heatmap_targets,
                                                    gaussian_focal_loss)

# name -> (out_channels, num_convs) of each SeparateHead branch (JAX's order)
HEADS = (("heatmap", None, 2), ("reg", 2, 2), ("height", 1, 2), ("dim", 3, 2), ("rot", 2, 2), ("vel", 2, 2))
# the regression maps in the order of the loss's 10-wide target
REG_ORDER = ("reg", "height", "dim", "rot", "vel")


class _ConvReLU(nn.Module):
    """A 3x3 conv then ReLU, named as the reference's ConvModule."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x))


class SeparateHead(nn.Module):
    """Per-quantity conv branches over a shared BEV feature: each branch
    num_convs - 1 conv + ReLU layers of `head_conv` channels, then a 3x3
    output conv (the heatmap's bias at `init_bias`, the others' at 0)."""

    def __init__(self, heads: Dict[str, Tuple[int, int]], in_channels: int, head_conv: int = 64,
                 init_bias: float = -2.19):
        super().__init__()
        self.heads = dict(heads)
        for name, (out_ch, num_conv) in self.heads.items():
            layers, c = [], in_channels
            for _ in range(num_conv - 1):
                layers.append(_ConvReLU(c, head_conv))
                c = head_conv
            out = nn.Conv2d(c, out_ch, 3, padding=1)
            with torch.no_grad():
                out.bias.fill_(init_bias if name == "heatmap" else 0.0)
            layers.append(out)
            setattr(self, name, nn.Sequential(*layers))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name)(x) for name in self.heads}


class CenterHead(nn.Module):
    """Single-task CenterHead (mobi_tpu CenterHeadTPU): [B, in_channels, H,
    W] -> {heatmap, reg, height, dim, rot, vel} NCHW. Built on `device`
    (CUDA unless the caller names another)."""

    def __init__(self, num_classes: int = 10, in_channels: int = 512, share_conv_channel: int = 64,
                 max_detections: int = 500, out_size_factor: int = 8,
                 voxel_size: Tuple[float, float] = (0.075, 0.075),
                 pc_range: Tuple[float, float] = (-54.0, -54.0), device=None):
        from mobi_tpu_torch.models.diffusion import resolve_device

        super().__init__()
        self.num_classes, self.max_detections = num_classes, max_detections
        self.out_size_factor, self.voxel_size, self.pc_range = out_size_factor, tuple(voxel_size), tuple(pc_range)
        self.shared_conv = _ConvReLU(in_channels, share_conv_channel)
        heads = {name: (num_classes if ch is None else ch, n) for name, ch, n in HEADS}
        self.task_heads = nn.ModuleList([SeparateHead(heads, share_conv_channel)])
        self.device = resolve_device(device)
        self.to(self.device)

    def forward(self, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.task_heads[0](self.shared_conv(bev))

    def top_k(self, heatmap: torch.Tensor, nms_kernel: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
        """heatmap logits [B, C, H, W] -> (scores, flat indices over (class,
        cell)) [B, max_detections]: a `nms_kernel` local-max filter ("SAME",
        -inf padding) on the sigmoid heatmap, then the top K in descending
        order with ties by index (a stable sort, as jax.lax.top_k orders
        them; the zeros off the peaks tie)."""
        hm = torch.sigmoid(heatmap)
        B = hm.shape[0]
        lo = (nms_kernel - 1) // 2
        padded = F.pad(hm, (lo, nms_kernel - 1 - lo, lo, nms_kernel - 1 - lo), value=float("-inf"))
        flat = (hm * (hm == F.max_pool2d(padded, nms_kernel, stride=1))).reshape(B, -1)
        top = torch.sort(flat, dim=-1, descending=True, stable=True).indices[:, :self.max_detections]
        return torch.gather(flat, 1, top), top

    def decode(self, preds: Dict[str, torch.Tensor], score_threshold: float = 0.1,
               nms_kernel: int = 3) -> Dict[str, torch.Tensor]:
        """Peak-pick the top `max_detections` boxes (CenterHead.get_bboxes
        with its bbox coder; `top_k`), gather the per-cell regressions and
        decode them to metric boxes [B, K, 9] (x, y, z_bottom, dx, dy, dz,
        yaw, vx, vy)."""
        scores, top = self.top_k(preds["heatmap"], nms_kernel)
        B, _, H, W = preds["heatmap"].shape
        hw = H * W
        cls, idx = top // hw, top % hw
        ys, xs = (idx // W).float(), (idx % W).float()

        def gather(name):  # [B, ch, H, W] at idx -> [B, K, ch]
            t = preds[name].reshape(B, preds[name].shape[1], hw)
            return torch.gather(t, 2, idx[:, None, :].expand(-1, t.shape[1], -1)).transpose(1, 2)

        reg = gather("reg")
        xs = xs + reg[..., 0]
        ys = ys + reg[..., 1]
        cx = xs * self.out_size_factor * self.voxel_size[0] + self.pc_range[0]
        cy = ys * self.out_size_factor * self.voxel_size[1] + self.pc_range[1]
        dim = torch.exp(gather("dim"))
        rot = gather("rot")
        yaw = torch.atan2(rot[..., 0], rot[..., 1])
        z = gather("height")[..., 0] - dim[..., 2] * 0.5
        boxes = torch.cat([torch.stack([cx, cy, z], -1), dim, yaw[..., None], gather("vel")], dim=-1)
        return {"bboxes": boxes, "scores": scores, "labels": cls, "keep": scores > score_threshold}


def centerpoint_loss(preds: Dict[str, torch.Tensor], gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_mask: torch.Tensor, cfg: TransFusionLossConfig = TransFusionLossConfig(),
                     code_weights: Sequence[float] = (1.0,) * 8 + (0.2, 0.2)
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CenterHead.loss (centerpoint.py:585-636) on NCHW maps and padded GTs
    (gt_boxes [B, G, 9], gt_labels [B, G], gt_mask [B, G] bool): the
    gaussian focal heatmap loss over the peak count, plus the L1 of the
    regressions at each GT's floored (and clipped) centre cell, weighted by
    `code_weights`, over 10 x the GT count, times 0.25. Returns (total,
    metrics)."""
    B, C, H, W = preds["heatmap"].shape
    step_x = cfg.voxel_size[0] * cfg.out_size_factor
    step_y = cfg.voxel_size[1] * cfg.out_size_factor
    hm_target = torch.stack([draw_heatmap_targets(gt_boxes[b], gt_labels[b], gt_mask[b], cfg, H, W)
                             for b in range(B)])
    hm_pred = torch.clamp(torch.sigmoid(preds["heatmap"]), 1e-4, 1 - 1e-4)
    n_peaks = torch.clamp((hm_target == 1.0).sum(), min=1).float()
    loss_hm = gaussian_focal_loss(hm_pred, hm_target) / n_peaks

    fx = (gt_boxes[..., 0] - cfg.pc_range[0]) / step_x
    fy = (gt_boxes[..., 1] - cfg.pc_range[1]) / step_y
    ix = torch.clamp(torch.floor(fx), 0, W - 1)
    iy = torch.clamp(torch.floor(fy), 0, H - 1)
    cell = (iy * W + ix).long()  # [B, G]
    target = torch.cat([
        (fx - ix)[..., None], (fy - iy)[..., None],
        (gt_boxes[..., 2] + gt_boxes[..., 5] * 0.5)[..., None],
        torch.log(torch.clamp(gt_boxes[..., 3:6], min=1e-6)),
        torch.sin(gt_boxes[..., 6])[..., None], torch.cos(gt_boxes[..., 6])[..., None],
        gt_boxes[..., 7:9],
    ], dim=-1)  # [B, G, 10]
    maps = torch.cat([preds[name] for name in REG_ORDER], dim=1).reshape(B, 10, H * W)
    pred_at_gt = torch.gather(maps, 2, cell[:, None, :].expand(-1, 10, -1)).transpose(1, 2)
    cw = torch.tensor(code_weights, dtype=maps.dtype, device=maps.device)
    mask = gt_mask.to(maps.dtype)
    l1 = torch.abs(pred_at_gt - target) * cw * mask[..., None]
    num_pos = torch.clamp(mask.sum(), min=1.0)
    loss_bbox = l1.sum() / (num_pos * 10.0) * 0.25
    total = loss_hm + loss_bbox
    return total, {"loss": total, "loss_heatmap": loss_hm, "loss_bbox": loss_bbox, "num_pos": mask.sum()}
