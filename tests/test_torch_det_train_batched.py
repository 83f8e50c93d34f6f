"""The port's batched detector step (mobi_tpu_torch.models.detector_training
make_batched_detector_train_step) against the JAX package's vmapped step at
batch 2, on the CPU at the detector tests' tiny grid; the port plans each
cloud unpadded and loops, JAX pads both plans to the static caps of the
port's `calibrate_static_caps` (equal to JAX's) and vmaps.

Tolerances: the loss, every metric and the gradient norm within 1e-4
relative; the update (a first Adam step, lr times about the gradient's
sign) within 1e-3 lr on all but 0.05% of the entries (where a gradient
entry sits at rounding noise its sign picks +-lr), within 2 lr on all, and
within 5e-3 relative L2.
"""
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
from test_torch_det_train import CFG_KW, jax_batch, lidar_batch, np_tree
from test_torch_detector import GRID, HEAD, cloud, jax_params, rel_l2

torch.set_num_threads(1)


def test_batched_step_equals_jax_vmapped_step():
    """Two clouds, the port's unpadded plans in a loop against JAX's vmapped
    step over static-cap plans (the port's calibrate_static_caps, JAX's
    padding): loss, metrics, gradient norm and the update."""
    clouds = [cloud(seed=7), cloud(seed=8, n=1500)]
    caps = PB.calibrate_static_caps(clouds, **GRID)
    assert caps == JB.calibrate_static_caps(clouds, **GRID)
    jsamples = [jax_batch(p, static_caps=caps) for p in clouds]
    osh = jsamples[0][1]
    det = JB.BEVFusionDetector(use_camera=False, num_proposals=16, head_kwargs=HEAD)
    j0 = jsamples[0][0]
    params = jax_params(det, np.random.default_rng(6), j0["voxel_feats"], j0["plans"], j0["out_coords"], osh)
    tx = JT.make_detector_optimizer(2e-4)
    step = JT.make_batched_detector_train_step(det, tx, JL.TransFusionLossConfig(**CFG_KW))
    new_params, _, jmetrics = step(params, tx.init(params), JT.stack_detector_batches([s for s, _ in jsamples]), osh)
    jmetrics = np_tree(jmetrics)

    port = PB.BEVFusionDetector(use_camera=False, num_proposals=16, head_kwargs=HEAD, device="cpu")
    port.load_state_dict(convert.bevfusion_state_dict(params, False), strict=True)
    before = {k: v.detach().clone() for k, v in port.named_parameters()}
    pstep = PT.make_batched_detector_train_step(port, PT.make_detector_optimizer(port, 2e-4),
                                                PL.TransFusionLossConfig(**CFG_KW))
    metrics = pstep([lidar_batch(p) for p in clouds])
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in metrics.items():
        assert float(v) == pytest.approx(float(jmetrics[k]), rel=1e-4), k
    after = convert.bevfusion_state_dict_numpy(np_tree(new_params), use_camera=False)
    want = np.concatenate([after[k].ravel() - before[k].numpy().ravel() for k in before])
    got = np.concatenate([(v.detach() - before[k]).numpy().ravel() for k, v in port.named_parameters()])
    # a first Adam update is lr * g / (|g| + eps) (+ decay): where a gradient
    # entry sits at rounding noise, its sign picks +-lr on either side
    off = np.abs(got - want) > 1e-3 * 2e-4
    assert off.mean() < 5e-4 and np.abs(got - want).max() <= 2 * 2e-4 * (1 + 1e-3)
    assert rel_l2(got, want) < 5e-3
