"""The camera branch of the port's detector training (mobi_tpu_torch.models.
detector_training camera_batch_inputs, camera_model_inputs, the camera +
lidar detector's step) against the JAX package's on the CPU: 2 views at
64 x 176 and the JAX tests' tiny LSS grid, as tests/test_torch_detector.py's
camera case.

Tolerances: camera_batch_inputs under one seed (ImageAug3D's draws,
GridMask) with the matrices and depth maps exactly and the views within
1e-5 (cv2's float resize and warp reproduced to a few ulp); one camera +
lidar step at converted weights with its loss terms within 1e-4 relative,
num_pos and the matching equal, the gradients within 1e-4 relative L2
overall and 1e-3 per tensor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu.models import bevfusion as JB
from mobi_tpu.models import detector_training as JT
from mobi_tpu.models import transfusion_loss as JL
from mobi_tpu_torch import convert
from mobi_tpu_torch.models import bevfusion as PB
from mobi_tpu_torch.models import detector_training as PT
from mobi_tpu_torch.models import transfusion_loss as PL
from test_torch_det_train import BOXES, CFG_KW, LABELS, MAX_GT, jax_match, np_tree
from test_torch_detector import GRID, HEAD, IH, IW, LSS, cameras, cloud, jax_params, rel_l2

torch.set_num_threads(1)


def camera_sample(seed=11):
    l2i, c2l, K = cameras()
    K4 = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    K4[:, :3, :3] = K
    images = np.random.default_rng(seed).uniform(-1, 1, size=(2, IH, IW, 3)).astype(np.float32)
    return dict(images=images, lidar2image=l2i.astype(np.float32), camera2lidar=c2l, camera_intrinsics=K4)


def aug_matrix():
    ang, s = 0.3, 1.04
    M = np.eye(4, dtype=np.float32)
    M[:2, :2] = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    M[2, 2] = s
    M[:3, 3] = [0.2, -0.1, 0.05]
    return M


@pytest.mark.parametrize("image_aug,grid_mask", [(False, 0.0), (True, 1.0), (True, 0.5)])
def test_camera_batch_inputs_equal_jax(image_aug, grid_mask):
    pts = cloud()
    M = aug_matrix()
    pts_aug = pts.copy()
    pts_aug[:, :3] = pts[:, :3] @ M[:3, :3].T + M[:3, 3]
    sample = camera_sample()
    got = PT.camera_batch_inputs(pts_aug, M, sample, rng=np.random.default_rng(3), image_aug=image_aug,
                                 grid_mask_prob=grid_mask)
    want = JT.camera_batch_inputs(pts_aug, M, sample, rng=np.random.default_rng(3), image_aug=image_aug,
                                  grid_mask_prob=grid_mask)
    assert sorted(got) == sorted(want)
    want["depth_map"] = want["depth_map"].transpose(0, 3, 1, 2)  # the port's maps are NCHW
    for k in ("depth_map", "cam2lidar", "intrins"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert np.abs(got["images"] - want["images"]).max() < 1e-5
    if image_aug:
        assert not np.array_equal(got["images"], sample["images"])


@pytest.fixture(scope="module")
def camera_step():
    pts = cloud()
    sample = camera_sample()
    M = np.eye(4, dtype=np.float32)
    jcam = JT.camera_batch_inputs(pts, M, sample)
    feats, plans, oc, osh = JB.prepare_lidar_inputs(pts, **GRID)
    b, l, m = JT.pad_gt(BOXES, LABELS, MAX_GT)
    batch = dict(voxel_feats=feats, plans=plans, out_coords=oc, gt_boxes=b[None], gt_labels=l[None],
                 gt_mask=m[None], **{k: jnp.asarray(v) for k, v in jcam.items()})
    det = JB.BEVFusionDetector(use_camera=True, num_proposals=16, head_kwargs=HEAD, lss_kwargs=LSS)
    cam_kw = {k: batch[k] for k in ("images", "depth_map", "cam2lidar", "intrins")}
    params = jax_params(det, np.random.default_rng(5), feats, plans, oc, osh, **cam_kw)
    jcfg = JL.TransFusionLossConfig(**CFG_KW)

    def loss_and_preds(p):  # JT.detector_loss_fn, with the predictions kept
        preds = det.apply({"params": p}, batch["voxel_feats"], plans, oc, osh, **cam_kw)
        total, metrics = JL.transfusion_loss(preds, batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"], jcfg)
        return total, (metrics, preds)

    (_, (metrics, preds)), grads = jax.jit(jax.value_and_grad(loss_and_preds, has_aux=True))(params)
    jmatch = np.asarray(jax.jit(lambda pr: jax_match(pr, *(jnp.asarray(batch[k]) for k in
                                                          ("gt_boxes", "gt_labels", "gt_mask")), jcfg)[0])(preds))

    port = PB.BEVFusionDetector(use_camera=True, num_proposals=16, head_kwargs=HEAD, lss_kwargs=LSS, device="cpu")
    port.load_state_dict(convert.bevfusion_state_dict(params, True), strict=True)
    pbatch = {"lidar": PB.prepare_lidar_inputs(pts, device="cpu", **GRID), **PT.gt_tensors(BOXES, LABELS, MAX_GT, "cpu"),
              "camera": PT.camera_model_inputs(port, PT.camera_batch_inputs(pts, M, sample))}
    ploss, pmetrics, pmatch = PT.detector_loss_fn(port, pbatch, PL.TransFusionLossConfig(**CFG_KW), return_match=True)
    names, params = zip(*port.named_parameters())
    pgrads = dict(zip(names, torch.autograd.grad(ploss, params)))
    return dict(metrics=np_tree(metrics), grads=np_tree(grads), jmatch=jmatch, pmetrics=pmetrics,
                pmatch=pmatch, pgrads=pgrads)


def test_camera_step_loss_and_matching_equal_jax(camera_step):
    s = camera_step
    assert float(s["pmetrics"]["num_pos"]) == float(s["metrics"]["num_pos"]) > 0
    assert np.array_equal(s["pmatch"][0].numpy(), s["jmatch"])
    for k in ("loss", "loss_cls", "loss_bbox", "loss_heatmap", "matched_iou"):
        assert float(s["pmetrics"][k].detach()) == pytest.approx(float(s["metrics"][k]), rel=1e-4), k


def test_camera_step_gradients_equal_jax(camera_step):
    s = camera_step
    want = convert.bevfusion_state_dict_numpy(s["grads"], use_camera=True)
    got = {k: v.numpy() for k, v in s["pgrads"].items()}
    assert sorted(got) == sorted(k for k in want if want[k].dtype.kind == "f")
    worst = {k: rel_l2(got[k], want[k]) for k in got}
    assert max(worst.values()) < 1e-3, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    flat = np.concatenate([got[k].ravel() for k in got]), np.concatenate([want[k].ravel() for k in got])
    assert rel_l2(*flat) < 1e-4
