"""The port's CenterPoint head (mobi_tpu_torch/models/centerpoint.py) against
the JAX package's (mobi_tpu/models/centerpoint.py) on the CPU, on the cases
of tests/test_centerpoint.py.

Tolerances: the forward within 1e-5 (fp32 convs; the JAX suite runs at
"highest" precision); decode on the same maps: labels, indices and the keep
mask equal, scores within 1e-6 and boxes within 1e-5 absolute; the loss and
its terms within 1e-5 relative, the gradients of every map within 1e-5
relative L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu.models.centerpoint import CenterHeadTPU, centerpoint_loss as jax_loss
from mobi_tpu.models.transfusion_loss import TransFusionLossConfig as JaxLossCfg
from mobi_tpu_torch import convert
from mobi_tpu_torch.models.centerpoint import CenterHead, centerpoint_loss
from mobi_tpu_torch.models.transfusion_loss import TransFusionLossConfig

NAMES = ("heatmap", "reg", "height", "dim", "rot", "vel")
CHANNELS = {"heatmap": 3, "reg": 2, "height": 1, "dim": 3, "rot": 2, "vel": 2}


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def seeded_params(head, bev, seed=0):
    """JAX's parameter tree of `head` from a numpy seed (kernels N(0,
    1/fan_in), biases N(0, 0.1)), so no output sits at its init."""
    shapes = jax.eval_shape(head.init, jax.random.PRNGKey(0), bev)["params"]
    rng = np.random.default_rng(seed)

    def fill(s):
        std = np.prod(s.shape[:-1]) ** -0.5 if len(s.shape) > 1 else 0.1
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return jax.tree.map(fill, shapes)


def pair(num_classes=3, share=8, max_det=16, in_ch=12, **kw):
    jhead = CenterHeadTPU(num_classes=num_classes, in_channels=in_ch, share_conv_channel=share,
                          max_detections=max_det, **kw)
    thead = CenterHead(num_classes=num_classes, in_channels=in_ch, share_conv_channel=share,
                       max_detections=max_det, device="cpu", **kw)
    return jhead, thead


def test_forward_and_decode_shapes_match_jax():
    """tests/test_centerpoint.py:20 with seeded weights and a random BEV."""
    jhead, thead = pair()
    bev = np.random.default_rng(1).standard_normal((2, 16, 16, 12)).astype(np.float32)
    params = seeded_params(jhead, jnp.asarray(bev))
    thead.load_state_dict(convert.centerpoint_state_dict(params), strict=True)
    want = jhead.apply({"params": params}, jnp.asarray(bev))
    with torch.no_grad():
        got = thead(nchw(bev))
    assert set(got) == set(NAMES)
    for name in NAMES:
        assert tuple(got[name].shape) == (2, CHANNELS[name], 16, 16)
        np.testing.assert_allclose(got[name].numpy(), nchw(want[name]).numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    det = thead.decode(got)
    assert tuple(det["bboxes"].shape) == (2, 16, 9)
    assert tuple(det["scores"].shape) == tuple(det["labels"].shape) == (2, 16)


def test_decode_recovers_planted_peak():
    """tests/test_centerpoint.py:34, both packages on the same maps."""
    jhead, thead = pair()
    B, H, W = 1, 32, 32
    preds = {
        "heatmap": jnp.full((B, H, W, 3), -8.0).at[0, 10, 20, 1].set(8.0),
        "reg": jnp.zeros((B, H, W, 2)),
        "height": jnp.full((B, H, W, 1), 1.0),
        "dim": jnp.zeros((B, H, W, 3)),
        "rot": jnp.zeros((B, H, W, 2)).at[..., 1].set(1.0),
        "vel": jnp.zeros((B, H, W, 2)),
    }
    det = thead.decode({k: nchw(v) for k, v in preds.items()})
    assert int(det["labels"][0, 0]) == 1
    step = thead.out_size_factor * thead.voxel_size[0]
    np.testing.assert_allclose(float(det["bboxes"][0, 0, 0]), 20 * step + thead.pc_range[0], atol=1e-4)
    np.testing.assert_allclose(float(det["bboxes"][0, 0, 6]), 0.0, atol=1e-5)
    assert bool(det["keep"][0, 0])
    _decode_equal(thead.decode({k: nchw(v) for k, v in preds.items()}), jhead.decode(preds))


def _decode_equal(got, want):
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_array_equal(got["keep"].numpy(), want["keep"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["bboxes"].numpy(), want["bboxes"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("nms_kernel", [3, 4, 5])
@pytest.mark.parametrize("maps", ["quantized", "continuous"])
def test_decode_with_ties_matches_jax(maps, nms_kernel):
    """The production decode (10 classes, 180 x 180, 500 detections) on
    heatmap logits that take 3 values, so the 500 hold ties at every
    level; and on continuous logits at 16 x 16 (768 candidates), where
    most of the 500 are the zeros off the peaks. Both give the same
    (class, cell) order as jax.lax.top_k (ties by index), boxes, scores and
    labels. The even kernel checks the "SAME" pad's uneven split."""
    rng = np.random.default_rng(nms_kernel)
    if maps == "quantized":
        jhead, thead = pair(num_classes=10, max_det=500)
        B, H, W, C = 2, 180, 180, 10
        heat = rng.choice([-6.0, 1.0, 3.0], (B, H, W, C), p=[0.9985, 0.001, 0.0005])
    else:
        jhead, thead = pair(num_classes=3, max_det=500)
        B, H, W, C = 2, 16, 16, 3
        heat = rng.standard_normal((B, H, W, C))
    preds = {"heatmap": heat.astype(np.float32)}
    for name in NAMES[1:]:
        preds[name] = rng.normal(0, 0.3, (B, H, W, CHANNELS[name])).astype(np.float32)
    want = jhead.decode({k: jnp.asarray(v) for k, v in preds.items()}, nms_kernel=nms_kernel)
    got = thead.decode({k: nchw(v) for k, v in preds.items()}, nms_kernel=nms_kernel)
    scores = np.asarray(want["scores"])
    if maps == "quantized":
        assert len(np.unique(scores)) <= 3  # ties at every level
    else:
        assert (scores[:, -1] == 0).all()  # ties at 0
    _decode_equal(got, want)


def test_loss_and_gradients_match_jax():
    """tests/test_centerpoint.py:55's maps (180 x 180, 3 classes) and GTs
    with two valid boxes (one off the grid, clipped to its edge cell) and two
    padded ones that must carry no weight."""
    rng = np.random.default_rng(0)
    B, H, W = 1, 180, 180
    scale = {"heatmap": 1.0, "reg": 0.1, "height": 1.0, "dim": 0.1, "rot": 1.0, "vel": 0.1}
    preds = {k: (rng.standard_normal((B, H, W, CHANNELS[k])) * scale[k]).astype(np.float32) for k in NAMES}
    boxes = np.zeros((1, 4, 9), np.float32)
    boxes[0, 0] = [5.0, 3.0, -1.0, 4.0, 2.0, 1.5, 0.3, 1.0, 0.0]
    boxes[0, 1] = [60.0, -20.0, -0.5, 1.0, 0.8, 1.7, -1.2, 0.0, 0.5]
    boxes[0, 3] = [1.0, 1.0, 0.0, 2.0, 2.0, 2.0, 0.0, 3.0, 3.0]  # padded: a real-looking box, masked out
    labels = np.array([[0, 2, 0, 1]], np.int32)
    mask = np.array([[True, True, False, False]])
    jcfg, tcfg = JaxLossCfg(num_classes=3), TransFusionLossConfig(num_classes=3)

    def jloss(p):
        return jax_loss(p, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask), jcfg)

    (jtotal, jmetrics), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tpreds = {k: nchw(v).requires_grad_(True) for k, v in preds.items()}
    total, metrics = centerpoint_loss(tpreds, torch.from_numpy(boxes), torch.from_numpy(labels),
                                      torch.from_numpy(mask), tcfg)
    total.backward()
    assert int(metrics["num_pos"]) == int(jmetrics["num_pos"]) == 2
    for k in ("loss", "loss_heatmap", "loss_bbox"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    for k in NAMES:
        want = nchw(jgrads[k]).numpy()
        got = tpreds[k].grad.numpy()
        assert np.abs(want).sum() > 0, k
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-5, (k, rel)
    # the padded GT's cell gets no regression gradient
    cx, cy = int((1.0 + 54.0) / 0.6), int((1.0 + 54.0) / 0.6)
    assert float(tpreds["vel"].grad[0, :, cy, cx].abs().sum()) == 0.0
