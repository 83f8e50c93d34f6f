"""The port's detector (mobi_tpu_torch.models.bevfusion, ops.sparse_conv,
native, convert.bevfusion_state_dict) against the JAX package's, on the
CPU at the JAX tests' tiny grid: voxels
0.15 x 0.15 x 0.2 over (-4.8, -4.8, -5, 4.8, 4.8, 3.2), 16 proposals,
max_voxels 8000; the networks at their full widths.

Tolerances: rulebooks equal as sets of pairs; host ops exactly; each
network block and both whole detectors within 1e-4 relative L2 of JAX in
fp32 before decoding; decoded boxes equal as sets within 1e-4; the state
dict conversion bitwise, key for key, against mobi_tpu.export_bevfusion.
The camera + lidar detector's cases are in tests/test_torch_detector_camera.py
(its JAX compile is the larger part of either file's time). The JAX side
draws its weights from a numpy seed (eval_shape, then kernels
N(0, 1/fan_in), other leaves N(0, 0.05), norm scales 1 + N(0, 0.05), BN
variances |v| + 0.5, so no sigmoid saturates into ties) and runs jitted.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu import native as jax_native
from mobi_tpu.export_bevfusion import export_bevfusion
from mobi_tpu.models import bevfusion as JB
from mobi_tpu.ops import sparse_conv as JSC
from mobi_tpu_torch import convert, native
from mobi_tpu_torch.models import bevfusion as PB
from mobi_tpu_torch.ops import sparse_conv as PSC

torch.set_num_threads(1)

GRID = dict(voxel_size=(0.15, 0.15, 0.2), pc_range=(-4.8, -4.8, -5, 4.8, 4.8, 3.2), max_voxels=8000)
HEAD = dict(voxel_size=(0.15, 0.15), pc_range=(-4.8, -4.8))
IH, IW = 64, 176
LSS = dict(image_size=(IH, IW), feature_size=(IH // 8, IW // 8), xbound=(-4.8, 4.8, 0.3),
           ybound=(-4.8, 4.8, 0.3), zbound=(-5.0, 3.2, 8.2), dbound=(1.0, 9.0, 1.0))
REL = 1e-4


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def fill(tree, rng, key=""):
    """A JAX param tree of ShapeDtypeStructs -> seeded numpy leaves."""
    if hasattr(tree, "items"):
        return {k: fill(v, rng, k) for k, v in tree.items()}
    std = 0.05
    if key == "kernel" and len(tree.shape) > 1:  # unit gain: activations stay O(1)
        std = float(np.prod(tree.shape[:-1])) ** -0.5
    a = rng.normal(0, std, tree.shape).astype(np.float32)
    if key.endswith("_var"):
        return np.abs(a) + 0.5
    if key.endswith("scale"):
        return a + 1.0
    return a


def jax_params(module, rng, *args, **kwargs):
    shapes = jax.eval_shape(lambda r: module.init(r, *args, **kwargs), jax.random.PRNGKey(0))["params"]
    return fill(shapes, rng)


def cloud(seed=7, n=2000):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-4.8, 4.8, (n, 2)), rng.uniform(-4.9, 2.9, (n, 1)),
                           rng.uniform(0, 1, (n, 2))], axis=1).astype(np.float32)


def cameras():
    K = np.array([[100.0, 0, 88], [0, 100.0, 32], [0, 0, 1]])
    l2i, c2l = [], []
    for yaw in (0.0, np.pi / 2):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.stack([np.array([s, -c, 0.0]), np.array([0.0, 0.0, -1.0]), np.array([c, s, 0.0])])
        T, K4, C = np.eye(4), np.eye(4), np.eye(4)
        T[:3, :3], K4[:3, :3], C[:3, :3] = R, K, R.T
        l2i.append(K4 @ T)
        c2l.append(C)
    return np.stack(l2i), np.stack(c2l).astype(np.float32), np.stack([K, K]).astype(np.float32)


def jax_camera_kwargs(pts, images):
    l2i, c2l, K = cameras()
    return dict(images=jnp.asarray(images), depth_map=jnp.asarray(JB.build_sparse_depth_map(pts[:, :3], l2i, (IH, IW))),
                cam2lidar=jnp.asarray(c2l), intrins=jnp.asarray(K))


def port_camera_kwargs(port, pts, images):
    l2i, c2l, K = cameras()
    return dict(images=torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2))),
                depth_map=torch.from_numpy(PB.build_sparse_depth_map(pts[:, :3], l2i, (IH, IW))),
                cells=port.encoders["camera"]["vtransform"].cells(c2l, K))


def nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def build_case(use_camera: bool) -> dict:
    """One whole detector on both sides: JAX tree, jitted JAX preds, the
    port's detector loaded strict from convert.bevfusion_state_dict."""
    pts = cloud()
    feats, plans, oc, osh = JB.prepare_lidar_inputs(pts, **GRID)
    images = np.random.default_rng(11).normal(size=(2, IH, IW, 3)).astype(np.float32)
    jkw = jax_camera_kwargs(pts, images) if use_camera else {}
    det = JB.BEVFusionDetector(use_camera=use_camera, num_proposals=16, head_kwargs=HEAD,
                               lss_kwargs=LSS if use_camera else None)
    params = jax_params(det, np.random.default_rng(5), feats, plans, oc, osh, **jkw)
    fwd = jax.jit(lambda p, f, kw: det.apply({"params": p}, f, plans, oc, osh, **kw,
                                             capture_intermediates=True, mutable=["intermediates"]))
    preds, state = jax.tree.map(np.asarray, fwd(params, jnp.asarray(feats), jkw))
    blocks = {k: v["__call__"][0] for k, v in state["intermediates"].items() if k != "__call__"}
    decoded = jax.tree.map(np.asarray, det.decode(preds))

    port = PB.BEVFusionDetector(use_camera=use_camera, num_proposals=16, head_kwargs=HEAD,
                                lss_kwargs=LSS if use_camera else None, device="cpu")
    port.load_state_dict(convert.bevfusion_state_dict(params, use_camera), strict=True)
    pin = PB.prepare_lidar_inputs(pts, device="cpu", **GRID)
    pkw = port_camera_kwargs(port, pts, images) if use_camera else {}
    port_blocks = {}
    hooks = [module.register_forward_hook(lambda m, a, out, name=name: port_blocks.__setitem__(name, (a, out)))
             for name, module in port_modules(port).items()]
    with torch.no_grad():
        port_preds = port(*pin, **pkw)
    for h in hooks:
        h.remove()
    return dict(use_camera=use_camera, pts=pts, jin=(feats, plans, oc, osh), jkw=jkw, params=params,
                preds=preds, decoded=decoded, port=port, pin=pin, pkw=pkw, images=images, det=det,
                blocks=blocks, port_blocks=port_blocks, port_preds=port_preds, jax_forward=fwd)


def port_modules(port) -> dict:
    """The port's block of each JAX submodule name."""
    mods = {"lidar_encoder": port.encoders["lidar"]["backbone"], "fuser": port.fuser,
            "backbone": port.decoder["backbone"], "neck": port.decoder["neck"], "head": port.heads["object"]}
    if "camera" in port.encoders:
        cam = port.encoders["camera"]
        mods.update(camera_backbone=cam["backbone"], camera_neck=cam["neck"], vtransform=cam["vtransform"])
    return mods


@pytest.fixture(scope="module")
def lidar_case():
    return build_case(False)




# ------------------------------------------------------------- host ops


def test_hard_voxelize_binding_equal_jax_native():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-6, 6, (3000, 5)).astype(np.float32)
    vs, cr = (0.15, 0.15, 0.2), (-4.8, -4.8, -5, 4.8, 4.8, 3.2)
    for mp, mv in ((10, 8000), (3, 200)):
        got = native.hard_voxelize(pts, vs, cr, max_points=mp, max_voxels=mv)
        want = jax_native.hard_voxelize(pts, vs, cr, max_points=mp, max_voxels=mv)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert all(np.array_equal(a, b) for a, b in zip(
            got, native.hard_voxelize_numpy(pts, vs, cr, max_points=mp, max_voxels=mv)))
    assert np.array_equal(native.dynamic_voxelize(pts, vs, cr), jax_native.dynamic_voxelize(pts, vs, cr))
    boxes = np.concatenate([rng.uniform(-3, 3, (5, 3)), rng.uniform(1, 3, (5, 3)), rng.uniform(-3, 3, (5, 1))], 1)
    assert np.array_equal(native.points_in_boxes(pts, boxes), jax_native.points_in_boxes(pts, boxes))
    ref, q = pts[:400], pts[400:450]
    assert all(np.array_equal(a, b) for a, b in zip(native.knn(ref, q, 4), jax_native.knn(ref, q, 4)))
    assert np.array_equal(native.ball_query(ref, q, 1.5, 6), jax_native.ball_query(ref, q, 1.5, 6))
    assert np.array_equal(native.furthest_point_sample(ref, 32), jax_native.furthest_point_sample(ref, 32))
    assert all(np.array_equal(a, b) for a, b in zip(native.three_nn(q, ref), jax_native.three_nn(q, ref)))


def test_native_builds_under_build_dir():
    path = native.build()
    assert path.parent == native.ROOT / "build" / "native" and path.exists()


def _pairs(rb):
    return [set(zip(rb.in_idx[k, :c].tolist(), rb.out_idx[k, :c].tolist())) for k, c in enumerate(rb.counts)]


def random_sparse(grid=(10, 9, 7), n=150, c=6, seed=0):
    rng = np.random.default_rng(seed)
    all_coords = np.array(list(itertools.product(*[range(g) for g in grid])), np.int32)
    coords = all_coords[rng.choice(len(all_coords), size=n, replace=False)]
    return coords, rng.normal(size=(n, c)).astype(np.float32)


@pytest.mark.parametrize("kind", ["subm", "strided", "out"])
def test_rulebook_equal_jax_as_sets(kind):
    coords, _ = random_sparse()
    kw = dict(subm=dict(submanifold=True),
              strided=dict(stride=(2, 2, 2), padding=(1, 1, 1), spatial_shape=(10, 9, 7), submanifold=False),
              out=dict(kernel_size=(1, 1, 3), stride=(1, 1, 2), spatial_shape=(10, 9, 7), submanifold=False))[kind]
    kw.setdefault("kernel_size", (3, 3, 3))
    got, want = PSC.build_rulebook(coords, **kw), JSC.build_rulebook(coords, **kw)
    assert np.array_equal(got.out_coords, want.out_coords) and np.array_equal(got.counts, want.counts)
    assert _pairs(got) == _pairs(want) and (got.n_in, got.n_out) == (want.n_in, want.n_out)


def test_encoder_plan_equal_jax(lidar_case):
    _, got, goc, gsh = lidar_case["pin"]
    _, want, woc, wsh = lidar_case["jin"]
    assert sorted(got) == sorted(want) and gsh == wsh and np.array_equal(goc, woc)
    for name in want:
        assert _pairs(got[name]) == _pairs(want[name]), name
        assert np.array_equal(got[name].out_coords, want[name].out_coords), name


def test_sparse_conv_and_maxpool_equal_jax():
    coords, feats = random_sparse()
    rng = np.random.default_rng(4)
    for kw in (dict(submanifold=True), dict(stride=(2, 2, 2), padding=(1, 1, 1), spatial_shape=(10, 9, 7),
                                                submanifold=False)):
        w = rng.normal(size=(27, 6, 8)).astype(np.float32)
        bias = rng.normal(size=8).astype(np.float32)
        prb, jrb = PSC.build_rulebook(coords, **kw), JSC.build_rulebook(coords, **kw)
        got = PSC.sparse_conv_apply(torch.from_numpy(feats), torch.from_numpy(w), prb, torch.from_numpy(bias))
        want = JSC.sparse_conv_apply(jnp.asarray(feats), jnp.asarray(w), jrb, jnp.asarray(bias))
        assert rel_l2(got, want) < 1e-6
        padded = PSC.pad_rulebook(prb, prb.in_idx.shape[1] + 7, prb.n_out + 5)
        got_pad = PSC.sparse_conv_apply(torch.from_numpy(feats), torch.from_numpy(w), padded, torch.from_numpy(bias))
        assert torch.equal(got_pad[:prb.n_out], got) and torch.equal(got_pad[prb.n_out:], torch.from_numpy(bias).expand(5, 8))
        got = PSC.sparse_maxpool_apply(torch.from_numpy(feats), prb)
        assert np.array_equal(got.numpy(), np.asarray(JSC.sparse_maxpool_apply(jnp.asarray(feats), jrb)))


# --------------------------------------------------------- network blocks


def _as_port(name, x, lidar_shape=None):
    """A JAX block output (NHWC, z-major lidar BEV) in the port's layout."""
    if isinstance(x, (list, tuple)):
        return [_as_port(name, v) for v in x]
    if isinstance(x, dict):
        return {k: (nchw(v) if k == "dense_heatmap" else v) for k, v in x.items()}
    if name == "lidar_encoder":  # [1, X, Y, Z*C] -> [1, C*Z, X, Y], channel c*Z + z
        X, Y, Z = lidar_shape
        return x.reshape(1, X, Y, Z, -1).transpose(0, 4, 3, 1, 2).reshape(1, -1, X, Y)
    return nchw(x)


def check_blocks_equal_jax(case):
    """Each network block's output inside the whole forward: the sparse
    encoder (its dense BEV permuted from JAX's z-major to the reference's
    C-major flattening), the fuser, SECOND, SECONDFPN, the head; with the
    camera Swin-T, GeneralizedLSSFPN and DepthLSSTransform too."""
    want_names = {"lidar_encoder", "fuser", "backbone", "neck", "head"}
    if case["use_camera"]:
        want_names |= {"camera_backbone", "camera_neck", "vtransform"}
    assert set(case["blocks"]) == set(case["port_blocks"]) == want_names
    for name, jout in case["blocks"].items():
        want = _as_port(name, jout, case["jin"][3])
        got = case["port_blocks"][name][1]
        if name == "head":
            assert np.array_equal(got["query_labels"].numpy(), want["query_labels"])
            for k in want:
                if k != "query_labels":
                    assert rel_l2(got[k], want[k]) < REL, (name, k)
        elif isinstance(want, list):
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                assert g.shape == w.shape and rel_l2(g, w) < REL, name
        else:
            assert got.shape == want.shape and rel_l2(got, want) < REL, name


def test_fuser_block_on_given_input(lidar_case):
    """The fuser alone on one input: the conversion permutes its lidar
    input block to the reference's C-major layout."""
    x = np.random.default_rng(3).normal(size=(1, 8, 8, 256)).astype(np.float32)
    want = jax.jit(lambda p, a: JB.ConvFuser().apply({"params": p}, [a]))(lidar_case["params"]["fuser"], jnp.asarray(x))
    perm = (np.arange(256) % 2) * 128 + np.arange(256) // 2  # port channel c*2 + z <- JAX z*128 + c
    with torch.no_grad():
        got = lidar_case["port"].fuser(torch.from_numpy(nchw(x)[:, perm].copy()))
    assert rel_l2(got, nchw(want)) < REL


def check_whole_detector_equal_jax(case):
    preds = case["port_preds"]
    with torch.no_grad():
        dec = case["port"].decode(preds)
    want = case["preds"]
    assert sorted(preds) == sorted(want)
    assert np.array_equal(preds["query_labels"].numpy(), want["query_labels"])
    for k in want:
        if k == "query_labels":
            continue
        got = preds[k].numpy()
        if k == "dense_heatmap":
            got = got.transpose(0, 2, 3, 1)
        assert got.shape == want[k].shape and rel_l2(got, want[k]) < REL, k
    # decoded boxes as sets: every kept box of one side has a partner on the other
    jd = case["decoded"]
    for a, b in ((dec, jd), (jd, dec)):
        a = {k: np.asarray(v)[0] for k, v in a.items()}
        b = {k: np.asarray(v)[0] for k, v in b.items()}
        assert a["keep"].sum() == b["keep"].sum() > 0
        for i in np.nonzero(a["keep"])[0]:
            diff = np.abs(b["bboxes"] - a["bboxes"][i]).max(1) / (1 + np.abs(a["bboxes"][i]).max())
            j = int(np.argmin(diff))
            assert diff[j] < 1e-4 and b["labels"][j] == a["labels"][i] and b["keep"][j]
            assert abs(b["scores"][j] - a["scores"][i]) < 1e-4


def test_blocks_equal_jax(lidar_case):
    check_blocks_equal_jax(lidar_case)


def test_whole_detector_equal_jax(lidar_case):
    check_whole_detector_equal_jax(lidar_case)


def test_parameter_counts_match_jax(lidar_case):
    check_parameter_counts_match_jax(lidar_case)


def test_bevfusion_state_dict_bitwise_equal_export(lidar_case):
    check_bevfusion_state_dict_bitwise_equal_export(lidar_case)


def test_static_caps_give_the_same_detections(lidar_case):
    case = lidar_case
    caps = PB.calibrate_static_caps([case["pts"]], **GRID)
    assert caps == JB.calibrate_static_caps([case["pts"]], **GRID)
    feats, plans, _, out_shape = case["pin"]
    last = len(PB.ENCODER_STAGES) - 1
    levels = {f"subm{i}": (i, i) for i in range(last + 1)}
    levels.update({f"down{i}": (i, i + 1) for i in range(last)}, out=(last, last + 1))
    padded = {k: PSC.pad_rulebook(rb, pairs_to=caps[levels[k][0]], out_to=caps[levels[k][1]],
                                  n_in=caps[levels[k][0]]) for k, rb in plans.items()}
    assert sorted(padded) == sorted(levels)
    capped = (torch.cat([feats, feats.new_zeros(caps[0] - feats.shape[0], feats.shape[1])]), padded,
              padded["out"].out_coords, out_shape)
    assert capped[0].shape[0] == caps[0] > feats.shape[0]
    with torch.no_grad():
        a = case["port"].decode(case["port_preds"])
        b = case["port"].decode(case["port"](*capped, **case["pkw"]))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def check_parameter_counts_match_jax(case):
    n_jax = sum(v.size for v in jax.tree.leaves(case["params"]))
    sd = case["port"].state_dict()
    n_port = sum(v.numel() for k, v in sd.items() if v.is_floating_point())
    # JAX's tree holds the BN statistics as leaves too; the port's buffers
    # besides them: num_batches_tracked and Swin's relative_position_index
    assert n_port == n_jax == (39789424 if case["use_camera"] else 8907086)


def check_bevfusion_state_dict_bitwise_equal_export(case):
    use_camera = case["use_camera"]
    got = convert.bevfusion_state_dict_numpy(case["params"], use_camera)
    want = export_bevfusion(case["params"], use_camera)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == np.ascontiguousarray(want[k]).tobytes(), k
    assert sorted(case["port"].state_dict()) == sorted(want)


def test_strict_load_with_and_without_fuser(lidar_case, tmp_path):
    """A reference-layout state dict without `fuser.*` (the reference's
    lidar-only assembly) loads strict into a fuser-less detector; one with
    `fuser.*` into a detector with one; each refuses the other's keys.

    Without a fuser the reference's decoder reads the sparse encoder's
    C-major BEV as it is. JAX's importer inserts an identity fuser, which
    hands the decoder JAX's z-major BEV instead (a fault of the JAX
    import), so the JAX side here gets the fuser that permutes z-major to
    C-major, exactly, and must then equal the port."""
    from mobi_tpu.import_bevfusion import import_bevfusion

    case = lidar_case
    sd = convert.bevfusion_state_dict(case["params"], use_camera=False)
    bare = {k: v for k, v in sd.items() if not k.startswith("fuser.")}
    assert PB.has_fuser(sd) and not PB.has_fuser(bare)
    path = convert.save_reference_checkpoint(bare, str(tmp_path / "bare.pth"))
    from mobi_tpu_torch.detector_inference import build_detector, load_checkpoint_state_dict

    model = build_detector(load_checkpoint_state_dict(path), False, GRID["voxel_size"], GRID["pc_range"], device="cpu")
    model.heads["object"].num_proposals = 16
    assert not hasattr(model, "fuser")
    with pytest.raises(RuntimeError):
        model.load_state_dict(sd, strict=True)
    with pytest.raises(RuntimeError):
        case["port"].load_state_dict(bare, strict=True)
    jparams = import_bevfusion({k: v.numpy() for k, v in bare.items()}, use_camera=False)
    fuse = jparams["fuser"]["fuse"]
    assert np.array_equal(fuse["conv"]["kernel"][1, 1], np.eye(256, dtype=np.float32))  # the identity
    kernel = np.zeros((3, 3, 256, 256), np.float32)
    c_major = np.arange(256)
    kernel[1, 1, (c_major % 2) * 128 + c_major // 2, c_major] = 1.0  # in z*128 + c -> out c*2 + z
    fuse["conv"]["kernel"] = kernel
    want, _ = jax.tree.map(np.asarray, case["jax_forward"](jparams, jnp.asarray(case["jin"][0]), {}))
    with torch.no_grad():
        got = model(*case["pin"])
    assert np.array_equal(got["query_labels"].numpy(), want["query_labels"])
    for k in ("center", "height", "dim", "rot", "vel", "heatmap", "query_heatmap_score"):
        assert rel_l2(got[k], want[k]) < REL, k
