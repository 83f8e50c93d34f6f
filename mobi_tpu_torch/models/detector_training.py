"""BEVFusion detector training: the optimizer, the camera branch's inputs, the
loss and the single-sample and batched steps over the TransFusion loss
(mobi_tpu models/detector_training.py; the reference's bevfusion/tools/
train.py and fusion_models/bevfusion.py:207-310, the training branch of
forward_single; configs/nuscenes/default.yaml: AdamW lr 2e-4, weight
decay 1e-2, gradient clip 35).

What trains is every parameter of the detector, BatchNorm's stored
statistics included (`bevfusion.StatsBatchNorm`), as JAX's step
differentiates its whole tree and its AdamW updates and decays every leaf.
The rulebooks are planned per cloud, unpadded (`prepare_lidar_inputs`):
eager PyTorch has no retrace to avoid, so the static caps JAX pads to have
no part here. The batched step runs the per-sample forwards in a loop and
differentiates the mean loss once; with BatchNorm on stored statistics the
loop equals JAX's vmap.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mobi_tpu_torch.models.transfusion_loss import TransFusionLossConfig, transfusion_loss
from mobi_tpu_torch.training import warmup_cosine_decay_schedule

f32 = np.float32


class DetectorOptimizer:
    """optax.chain(clip_by_global_norm(clip_norm), adamw(schedule,
    weight_decay)) over `tensors`, updated in place, in optax's formulas:
    the gradients scaled by clip_norm / norm (as (g / norm) * clip_norm)
    only when their global norm is clip_norm or more; Adam's moments
    (1 - b) * g + b * m, bias corrections 1 - b ** count in float32,
    m_hat / (sqrt(v_hat) + eps), plus weight_decay * param on every tensor,
    times -lr(count) with count the updates before this one. The schedule is
    `optax.warmup_cosine_decay_schedule(0, lr, warmup_steps, total_steps)`
    when total_steps > warmup_steps, else lr."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adamw's defaults

    def __init__(self, tensors: Sequence[torch.Tensor], lr: float = 2e-4, weight_decay: float = 0.01,
                 clip_norm: float = 35.0, total_steps: int = 0, warmup_steps: int = 500):
        self.tensors = list(tensors)
        self.schedule = (warmup_cosine_decay_schedule(0.0, lr, warmup_steps, total_steps, 0.0)
                         if total_steps > warmup_steps else (lambda count: f32(lr)))
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(t) for t in self.tensors]
        self.nu = [torch.zeros_like(t) for t in self.tensors]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """One update from `grads` (one a tensor, in order); returns their
        global norm before clipping (the step's `grad_norm`)."""
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        below = norm < self.clip_norm  # no host sync: both branches, selected
        grads = [torch.where(below, g, (g / norm) * self.clip_norm) for g in grads]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        count = self.count + 1
        bc1 = float(f32(1) - f32(b1) ** f32(count))
        bc2 = float(f32(1) - f32(b2) ** f32(count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, self.tensors, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -float(self.schedule(self.count)))
        torch._foreach_add_(self.tensors, upd)
        self.count = count
        return norm


def make_detector_optimizer(model: torch.nn.Module, lr: float = 2e-4, weight_decay: float = 0.01,
                            clip_norm: float = 35.0, total_steps: int = 0,
                            warmup_steps: int = 500) -> DetectorOptimizer:
    """The optimizer over every parameter of the detector, BatchNorm's
    statistics among them, in `model.parameters()` order."""
    return DetectorOptimizer(list(model.parameters()), lr, weight_decay, clip_norm, total_steps, warmup_steps)


def camera_batch_inputs(points_aug: np.ndarray, lidar_aug_matrix: np.ndarray, sample: Dict,
                        rng: Optional[np.random.Generator] = None, image_aug: bool = False,
                        grid_mask_prob: float = 0.0) -> Dict[str, np.ndarray]:
    """The camera branch's training inputs for one sample, as JAX's
    (detector_training.py:55-122): `images` [V, H, W, 3], `depth_map`
    [V, 1, H, W] (NCHW, where JAX's is NHWC), `cam2lidar` and `intrins`
    [V, 3, 3], numpy.

    points_aug is the lidar-augmented cloud (train_pipeline's), and
    lidar_aug_matrix its composed 4x4 augmentation; sample a
    DetectionSceneDataset item with resized views and folded matrices. The
    camera BEV must land in the augmented lidar frame (where the boxes
    are), so the augmentation composes into cam2lidar; the sparse depth map
    projects the un-augmented cloud (the reference passes the matrix to the
    view transform and inverts it, vtransforms/base.py:241-258). image_aug
    draws ImageAug3D's random resize, crop, flip and rotation per view and
    folds each affine into the projections; grid_mask_prob applies GridMask
    with that probability."""
    from mobi_tpu_torch.data.det_pipeline import fold_img_aug, grid_mask, image_aug_3d
    from mobi_tpu_torch.models.bevfusion import build_sparse_depth_map

    images = sample["images"].astype(np.float32)
    l2i = np.asarray(sample["lidar2image"], np.float32)
    intr = np.asarray(sample["camera_intrinsics"], np.float32)
    if image_aug and rng is not None:
        fH, fW = images.shape[1:3]
        images, mats = image_aug_3d(images, rng, final_dim=(fH, fW), resize_lim=(0.9, 1.1), is_train=True)
        l2i, intr = fold_img_aug(l2i, intr, mats)
    if grid_mask_prob > 0 and rng is not None:
        images = grid_mask(images, rng, prob=grid_mask_prob)

    aug = np.asarray(lidar_aug_matrix, np.float64)
    inv = np.linalg.inv(aug)
    p0 = points_aug[:, :3] @ inv[:3, :3].T + inv[:3, 3]
    iH, iW = images.shape[1:3]
    return dict(
        images=images.astype(np.float32),
        depth_map=build_sparse_depth_map(p0.astype(np.float32), l2i.astype(np.float32), (iH, iW)),
        cam2lidar=(aug[None] @ sample["camera2lidar"]).astype(np.float32),
        intrins=intr[:, :3, :3].astype(np.float32),
    )


def camera_model_inputs(model, cam: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """`camera_batch_inputs` -> the detector's camera arguments on its
    device: the views NCHW, the depth maps, and the LSS frustum's cells from
    cam2lidar and intrins, made on the host (`DepthLSSTransform.cells`)."""
    cells = model.encoders["camera"]["vtransform"].cells(cam["cam2lidar"], cam["intrins"])
    return dict(images=torch.from_numpy(np.ascontiguousarray(cam["images"].transpose(0, 3, 1, 2))).to(model.device),
                depth_map=torch.from_numpy(cam["depth_map"]).to(model.device), cells=cells.to(model.device))


def detector_loss_fn(model, batch: Dict, loss_cfg: TransFusionLossConfig, return_match: bool = False):
    """One sample's loss: the detector's forward, then the TransFusion loss.
    batch: "lidar" (prepare_lidar_inputs' four), "gt_boxes" [1, G, 9],
    "gt_labels" [1, G], "gt_mask" [1, G] on the model's device, and with the
    camera "camera" (`camera_model_inputs`)."""
    preds = model(*batch["lidar"], **batch.get("camera", {}))
    return transfusion_loss(preds, batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"], loss_cfg,
                            return_match=return_match)


def default_loss_config(model) -> TransFusionLossConfig:
    head = model.heads["object"]
    return TransFusionLossConfig(num_classes=head.num_classes, num_proposals=head.num_proposals)


def _finish_step(tx: DetectorOptimizer, loss: torch.Tensor, metrics: Dict) -> Dict[str, torch.Tensor]:
    grads = torch.autograd.grad(loss, tx.tensors)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = tx.step(grads)
    return metrics


def make_detector_train_step(model, tx: DetectorOptimizer,
                             loss_cfg: Optional[TransFusionLossConfig] = None) -> Callable:
    """step(batch) -> metrics: one sample's loss, its gradient over every
    trainable tensor, one optimizer update of the model in place; the
    metrics (tensors on the model's device) gain `grad_norm`, the gradients'
    global norm before clipping."""
    cfg = loss_cfg or default_loss_config(model)

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        loss, metrics = detector_loss_fn(model, batch, cfg)
        return _finish_step(tx, loss, metrics)

    return step


def make_batched_detector_train_step(model, tx: DetectorOptimizer,
                                     loss_cfg: Optional[TransFusionLossConfig] = None) -> Callable:
    """step(samples) -> metrics over a list of single-sample batches (JAX
    stacks static-cap plans along a batch axis; unpadded plans of different
    sizes stay apart): each sample's forward and loss in turn, the mean loss
    differentiated once, one update; each metric the mean over the samples,
    and `grad_norm`."""
    cfg = loss_cfg or default_loss_config(model)

    def step(samples: List[Dict]) -> Dict[str, torch.Tensor]:
        losses, per_sample = [], []
        for sample in samples:
            loss, metrics = detector_loss_fn(model, sample, cfg)
            losses.append(loss)
            per_sample.append(metrics)
        loss = torch.stack(losses).mean()
        metrics = {k: torch.stack([m[k] for m in per_sample]).mean() for k in per_sample[0]}
        return _finish_step(tx, loss, metrics)

    return step


def pad_gt(boxes: np.ndarray, labels: np.ndarray, max_gt: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-sample GT padded to [max_gt] (boxes to 9 columns, zero velocity),
    with its validity mask."""
    g = min(len(boxes), max_gt)
    out_b = np.zeros((max_gt, 9), np.float32)
    out_l = np.zeros((max_gt,), np.int32)
    out_m = np.zeros((max_gt,), bool)
    if g:
        b = boxes[:g]
        if b.shape[1] < 9:
            b = np.concatenate([b, np.zeros((g, 9 - b.shape[1]), np.float32)], 1)
        out_b[:g] = b[:, :9]
        out_l[:g] = labels[:g]
        out_m[:g] = True
    return out_b, out_l, out_m


def gt_tensors(boxes: np.ndarray, labels: np.ndarray, max_gt: int, device) -> Dict[str, torch.Tensor]:
    """`pad_gt` as the [1, G] tensors a step's batch carries."""
    b, l, m = pad_gt(boxes, labels, max_gt)
    return {"gt_boxes": torch.from_numpy(b[None]).to(device), "gt_labels": torch.from_numpy(l[None]).to(device),
            "gt_mask": torch.from_numpy(m[None]).to(device)}
