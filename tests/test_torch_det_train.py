"""The port's detector training (mobi_tpu_torch.models.transfusion_loss,
models.detector_training, the training half of models.bevfusion) against the
JAX package's, on the CPU at the detector tests' tiny grid (voxels
0.15 x 0.15 x 0.2 over (-4.8, -4.8, -5, 4.8, 4.8, 3.2), 16 proposals, the
networks at full width; JAX's weights drawn by `fill` and converted with
convert.bevfusion_state_dict).

Tolerances: the host Hungarian's matching equal to JAX's `hungarian_assign`
on every cost (random, tied, padded gt columns) and its total equal to
scipy's optimum within 1e-4; each loss piece within 1e-5 absolute or 1e-4
relative; the whole lidar step's loss terms within 1e-4 relative, num_pos
and the matching equal, the gradients (BatchNorm's mean and var included)
within 1e-4 relative L2 overall and 1e-3 per tensor; the optimizer fed
optax's gradients within 1e-6 relative of optax's parameters after 3 steps;
the batched step is in tests/test_torch_det_train_batched.py, the camera
cases in tests/test_torch_det_train_camera.py (each file's JAX compile
keeps it inside its time).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mobi_tpu.models import bevfusion as JB
from mobi_tpu.models import detector_training as JT
from mobi_tpu.models import transfusion_loss as JL
from mobi_tpu.ops.box3d import iou_3d as jax_iou_3d
from mobi_tpu_torch import convert
from mobi_tpu_torch.models import bevfusion as PB
from mobi_tpu_torch.models import detector_training as PT
from mobi_tpu_torch.models import transfusion_loss as PL
from test_torch_detector import GRID, HEAD, cloud, jax_params, rel_l2

torch.set_num_threads(1)

CFG_KW = dict(num_classes=10, num_proposals=16, pc_range=GRID["pc_range"], voxel_size=GRID["voxel_size"][:2])
MAX_GT = 8
BOXES = np.array([[1.0, 0.5, -1.0, 3.9, 1.7, 1.5, 0.2, 0.5, -0.2],
                  [-2.5, -2.0, -1.2, 0.8, 0.7, 1.8, -0.6, 0.0, 0.0],
                  [2.8, -3.1, -1.0, 2.0, 1.0, 1.0, 1.3, 0.1, 0.3]], np.float32)
LABELS = np.array([0, 8, 5])


def np_tree(x):
    return jax.tree.map(np.asarray, x)


# ------------------------------------------------------------ the Hungarian


def hungarian_costs():
    """50 [P, G] costs: random, tied (a few integer levels) and with padded
    gt columns set to BIG, at three shapes (the last the production's)."""
    rng = np.random.default_rng(7)
    out = {}
    for (P, G), n in (((12, 5), 20), ((30, 16), 20), ((200, 128), 10)):
        cs = []
        for k in range(n):
            c = (rng.integers(0, 3, (P, G)) if k % 3 == 1 else rng.normal(size=(P, G))).astype(np.float32)
            if k % 3 == 2:
                c[:, rng.integers(1, G + 1):] = PL.BIG
            cs.append(c)
        out[(P, G)] = np.stack(cs)
    return out


def test_host_hungarian_equals_jax_and_is_optimal():
    from scipy.optimize import linear_sum_assignment

    n = 0
    for (P, G), costs in hungarian_costs().items():
        want = np.asarray(jax.jit(jax.vmap(JL.hungarian_assign))(jnp.asarray(costs)))
        for c, w in zip(costs, want):
            got = PL.hungarian_assign(c)
            assert np.array_equal(got, w), (P, G)
            sel = got >= 0
            assert sel.sum() == G and len(set(got[sel])) == G
            rows, cols = linear_sum_assignment(c)
            assert abs(c[np.nonzero(sel)[0], got[sel]].astype(np.float64).sum()
                       - c[rows, cols].astype(np.float64).sum()) <= 1e-4 * max(1.0, abs(c[rows, cols]).sum() / 1e6)
            n += 1
    assert n == 50
    # the scipy oracle the JAX package keeps, on a small case
    c = hungarian_costs()[(12, 5)][0]
    oracle = JL._host_hungarian(c)
    assert c[oracle >= 0, oracle[oracle >= 0]].sum() == pytest.approx(
        c[PL.hungarian_assign(c) >= 0, PL.hungarian_assign(c)[PL.hungarian_assign(c) >= 0]].sum(), abs=1e-5)


def test_hungarian_raises_with_more_gt_than_proposals():
    with pytest.raises(ValueError, match="proposals >= gt"):
        PL.hungarian_assign(np.zeros((4, 6), np.float32))
    with pytest.raises(ValueError, match="proposals >= gt"):
        JL.hungarian_assign(jnp.zeros((4, 6)))


# ------------------------------------------------------------- loss pieces


def fake_preds(seed=0, B=1, P=16, C=10, H=8, W=8):
    rng = np.random.default_rng(seed)
    return {
        "heatmap": rng.normal(size=(B, P, C)),
        "center": rng.uniform(0, H, (B, P, 2)),
        "height": rng.normal(size=(B, P, 1)) - 1.0,
        "dim": rng.normal(size=(B, P, 3)) * 0.1 + 0.5,
        "rot": rng.normal(size=(B, P, 2)),
        "vel": rng.normal(size=(B, P, 2)) * 0.1,
        "dense_heatmap": rng.normal(size=(B, H, W, C)),
    }


def as_jax(preds):
    return {k: jnp.asarray(v, jnp.float32) for k, v in preds.items()}


def as_port(preds, grad=False):
    out = {}
    for k, v in preds.items():
        a = np.asarray(v, np.float32)
        if k == "dense_heatmap":
            a = a.transpose(0, 3, 1, 2)
        out[k] = torch.tensor(np.ascontiguousarray(a), requires_grad=grad)
    return out


def gt_arrays(B=1):
    b, l, m = PT.pad_gt(BOXES, LABELS, MAX_GT)
    jb, jl, jm = JT.pad_gt(BOXES, LABELS, MAX_GT)
    assert np.array_equal(b, jb) and np.array_equal(l, jl) and np.array_equal(m, jm)
    return np.repeat(b[None], B, 0), np.repeat(l[None], B, 0), np.repeat(m[None], B, 0)


def jax_match(preds, boxes, labels, mask, cfg):
    """JAX's assignment for one sample (assign_one in transfusion_loss)."""
    pb = JL._decode_pred_boxes(preds, cfg)[0]
    scores = jax.nn.sigmoid(preds["heatmap"])[0]
    lo = jnp.asarray(cfg.pc_range[0:2])
    span = jnp.asarray(cfg.pc_range[3:5]) - lo
    cost = (JL._focal_cls_cost(scores, labels[0], cfg)
            + jnp.abs((pb[:, :2] - lo)[:, None] / span - ((boxes[0, :, :2] - lo) / span)[None]).sum(-1)
            * cfg.reg_cost_weight - jax_iou_3d(pb[:, :7], boxes[0, :, :7]) * cfg.iou_cost_weight)
    cost = jnp.where(mask[0][None, :], cost, 1e6)
    return JL.hungarian_assign(cost), cost


def test_loss_pieces_equal_jax():
    jcfg, pcfg = JL.TransFusionLossConfig(**CFG_KW), PL.TransFusionLossConfig(**CFG_KW)
    b, l, m = gt_arrays()
    dims = np.random.default_rng(1).uniform(0.5, 40, (20, 2)).astype(np.float32)
    assert rel_l2(PL.gaussian_radius(torch.from_numpy(dims), 0.1), JL.gaussian_radius(jnp.asarray(dims), 0.1)) < 1e-6
    for H, cfg_kw in ((8, CFG_KW), (180, {})):  # the tiny grid and the production one
        jc, pc = JL.TransFusionLossConfig(**cfg_kw), PL.TransFusionLossConfig(**cfg_kw)
        got = PL.draw_heatmap_targets(torch.from_numpy(b[0]), torch.from_numpy(l[0]), torch.from_numpy(m[0]), pc, H, H)
        want = JL.draw_heatmap_targets(jnp.asarray(b[0]), jnp.asarray(l[0]), jnp.asarray(m[0]), jc, H, H)
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6
    assert np.abs(PL.encode_gt_boxes(torch.from_numpy(b), pcfg).numpy()
                  - np.asarray(JL.encode_gt_boxes(jnp.asarray(b), jcfg))).max() < 1e-5
    preds = fake_preds()
    jp, pp = as_jax(preds), as_port(preds)
    assert np.abs(PL._decode_pred_boxes(pp, pcfg).numpy() - np.asarray(JL._decode_pred_boxes(jp, jcfg))).max() < 1e-5
    scores = np.random.default_rng(2).uniform(0.01, 0.99, (16, 10)).astype(np.float32)
    assert np.abs(PL._focal_cls_cost(torch.from_numpy(scores), torch.from_numpy(l[0]), pcfg).numpy()
                  - np.asarray(JL._focal_cls_cost(jnp.asarray(scores), jnp.asarray(l[0]), jcfg))).max() < 1e-5
    logits = pp["heatmap"]
    targets = torch.from_numpy((np.random.default_rng(3).uniform(size=(1, 16, 10)) > 0.8).astype(np.float32))
    for got, want in ((PL.optax_sigmoid_ce(logits, targets), JL.optax_sigmoid_ce(jp["heatmap"], jnp.asarray(targets))),
                      (optax.sigmoid_binary_cross_entropy(jp["heatmap"], jnp.asarray(targets)),
                       JL.optax_sigmoid_ce(jp["heatmap"], jnp.asarray(targets))),
                      (PL._sigmoid_focal_loss(logits, targets, pcfg),
                       JL._sigmoid_focal_loss(jp["heatmap"], jnp.asarray(targets), jcfg))):
        assert np.abs(np.asarray(got) - np.asarray(want)).max() < 1e-5
    hm_t = PL.draw_heatmap_targets(torch.from_numpy(b[0]), torch.from_numpy(l[0]), torch.from_numpy(m[0]), pcfg, 8, 8)
    sig = torch.sigmoid(pp["dense_heatmap"][0]).clamp(1e-4, 1 - 1e-4)
    got = float(PL.gaussian_focal_loss(sig, hm_t))
    want = float(JL.gaussian_focal_loss(jnp.asarray(sig.numpy()), jnp.asarray(hm_t.numpy())))
    assert got == pytest.approx(want, rel=1e-5)
    cost, _ = PL.matching_costs(pp, torch.from_numpy(b), torch.from_numpy(l), torch.from_numpy(m), pcfg)
    _, jcost = jax_match(jp, jnp.asarray(b), jnp.asarray(l), jnp.asarray(m), jcfg)
    assert np.abs(cost[0].numpy() - np.asarray(jcost)).max() < 1e-5


@pytest.mark.parametrize("B", [1, 2])
def test_transfusion_loss_and_its_gradients_equal_jax(B):
    """On given predictions: the total, every metric, the matching and the
    gradient of the total with respect to each prediction."""
    jcfg, pcfg = JL.TransFusionLossConfig(**CFG_KW), PL.TransFusionLossConfig(**CFG_KW)
    b, l, m = gt_arrays(B)
    preds = fake_preds(seed=4, B=B)
    jin = (jnp.asarray(b), jnp.asarray(l), jnp.asarray(m))
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(lambda p: JL.transfusion_loss(p, *jin, jcfg),
                                                            has_aux=True))(as_jax(preds))
    pp = as_port(preds, grad=True)
    total, metrics, match = PL.transfusion_loss(pp, *(torch.from_numpy(a) for a in (b, l, m)), pcfg,
                                                return_match=True)
    total.backward()
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in metrics.items():
        assert float(v.detach()) == pytest.approx(float(jmetrics[k]), rel=1e-4, abs=1e-6), k
    assert float(metrics["num_pos"]) == float(jmetrics["num_pos"]) == 3 * B
    for i in range(B):
        want, _ = jax_match(as_jax({k: v[i:i + 1] for k, v in preds.items()}), *(a[i:i + 1] for a in jin), jcfg)
        assert np.array_equal(match[i].numpy(), np.asarray(want))
    for k, g in jgrads.items():
        got = pp[k].grad.numpy()
        g = np.asarray(g)
        if k == "dense_heatmap":
            got = got.transpose(0, 2, 3, 1)
        assert rel_l2(got, g) < 1e-4, k


# ------------------------------------------------------- the whole lidar step


def lidar_batch(pts, device="cpu"):
    return {"lidar": PB.prepare_lidar_inputs(pts, device=device, **GRID),
            **PT.gt_tensors(BOXES, LABELS, MAX_GT, device)}


def jax_batch(pts, static_caps=None):
    feats, plans, oc, osh = JB.prepare_lidar_inputs(pts, static_caps=static_caps, **GRID)
    b, l, m = JT.pad_gt(BOXES, LABELS, MAX_GT)
    return dict(voxel_feats=feats, plans=plans, out_coords=oc, gt_boxes=b[None], gt_labels=l[None],
                gt_mask=m[None]), osh


@pytest.fixture(scope="module")
def lidar_step():
    pts = cloud()
    det = JB.BEVFusionDetector(use_camera=False, num_proposals=16, head_kwargs=HEAD)
    batch, osh = jax_batch(pts)
    params = jax_params(det, np.random.default_rng(5), batch["voxel_feats"], batch["plans"], batch["out_coords"], osh)
    jcfg = JL.TransFusionLossConfig(**CFG_KW)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JT.detector_loss_fn(det, p, batch, osh, jcfg), has_aux=True))(params)
    preds = jax.jit(lambda p: det.apply({"params": p}, batch["voxel_feats"], batch["plans"], batch["out_coords"],
                                        osh))(params)
    jmatch = np.asarray(jax.jit(lambda pr, b, l, m: jax_match(pr, b, l, m, jcfg))(
        preds, *(jnp.asarray(batch[k]) for k in ("gt_boxes", "gt_labels", "gt_mask")))[0])

    port = PB.BEVFusionDetector(use_camera=False, num_proposals=16, head_kwargs=HEAD, device="cpu")
    port.load_state_dict(convert.bevfusion_state_dict(params, False), strict=True)
    pbatch = lidar_batch(pts)
    ploss, pmetrics, pmatch = PT.detector_loss_fn(port, pbatch, PL.TransFusionLossConfig(**CFG_KW), return_match=True)
    names, params = zip(*port.named_parameters())
    pgrads = dict(zip(names, torch.autograd.grad(ploss, params)))
    return dict(pts=pts, det=det, params=params, osh=osh, jbatch=batch, loss=float(loss), metrics=np_tree(metrics),
                grads=np_tree(grads), jmatch=jmatch, port=port, pbatch=pbatch, ploss=ploss, pmetrics=pmetrics,
                pmatch=pmatch, pgrads=pgrads)


def test_lidar_step_loss_and_matching_equal_jax(lidar_step):
    s = lidar_step
    assert float(s["pmetrics"]["num_pos"]) == float(s["metrics"]["num_pos"]) > 0
    assert np.array_equal(s["pmatch"][0].numpy(), s["jmatch"])
    for k in ("loss", "loss_cls", "loss_bbox", "loss_heatmap", "matched_iou"):
        assert float(s["pmetrics"][k].detach()) == pytest.approx(float(s["metrics"][k]), rel=1e-4), k


def test_lidar_step_gradients_equal_jax(lidar_step):
    """Every trained tensor's gradient, by state-dict name (the JAX tree's
    gradients mapped through the same conversion as its weights), BatchNorm
    running_mean and running_var among them."""
    s = lidar_step
    want = convert.bevfusion_state_dict_numpy(s["grads"], use_camera=False)
    got = {k: v.numpy() for k, v in s["pgrads"].items()}
    assert sorted(got) == sorted(k for k in want if not k.endswith("num_batches_tracked"))
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 90 and all(np.abs(want[k]).max() > 0 for k in stats)
    worst = {k: rel_l2(got[k], want[k]) for k in got}
    assert max(worst.values()) < 1e-3, sorted(worst.items(), key=lambda kv: -kv[1])[:5]
    flat = np.concatenate([got[k].ravel() for k in got]), np.concatenate([want[k].ravel() for k in got])
    assert rel_l2(*flat) < 1e-4


def optax_tx(lr, total_steps, warmup_steps, clip_norm=35.0):
    sched = (optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps, total_steps)
             if total_steps > warmup_steps else lr)
    return optax.chain(optax.clip_by_global_norm(clip_norm), optax.adamw(sched, weight_decay=0.01))


@pytest.mark.parametrize("case", ["clipped_constant_lr", "unclipped_warmup"])
def test_optimizer_equals_optax(case):
    """Three updates from the same gradients: with the global norm above 35
    (clipped) at a constant lr, and below it through the warm-up cosine
    schedule; against JAX's make_detector_optimizer."""
    rng = np.random.default_rng(11)
    shapes = [(64, 32, 3, 3), (64,), (300,), (10, 128)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    gscale = 5.0 if case == "clipped_constant_lr" else 0.01
    grads = [[(rng.normal(size=s) * gscale).astype(np.float32) for s in shapes] for _ in range(3)]
    total, warm = (0, 500) if case == "clipped_constant_lr" else (10, 3)
    tx = JT.make_detector_optimizer(2e-4, total_steps=total, warmup_steps=warm)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    state = tx.init(jp)
    tensors = [torch.from_numpy(p.copy()) for p in params]
    opt = PT.DetectorOptimizer(tensors, 2e-4, total_steps=total, warmup_steps=warm)
    for g in grads:
        jg = {str(i): jnp.asarray(x) for i, x in enumerate(g)}
        norm = float(optax.global_norm(jg))
        assert (norm > 35) == (case == "clipped_constant_lr")
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        assert float(opt.step([torch.from_numpy(x) for x in g])) == pytest.approx(norm, rel=1e-6)
    for i, t in enumerate(tensors):
        assert rel_l2(t, jp[str(i)]) < 1e-6
        assert rel_l2(t - torch.from_numpy(params[i]), np.asarray(jp[str(i)]) - params[i]) < 1e-3
