"""The port's pipeline options on the tiny config on the CPU:
`SegmentedInpaint` (K calls give one call's output) and `vae_chunk_pairs`
(chunked VAE stages give the unchunked output). Both hold the port against
itself; the single call is held against JAX in tests/test_torch_models.py.
"""
import numpy as np
import pytest
import torch

from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.pipeline import SegmentedInpaint, make_inpaint_pipeline
from tests.test_diffusion import TINY, make_batch
from tests.test_torch_models import few_torch_threads, numpy_batch, port_config, tiny_cond_stage  # noqa: F401


@pytest.fixture(scope="module")
def model():
    return tdiff.MobiDiffusion(port_config(TINY), device="cpu", seed=3,
                               cond_stage_model=tiny_cond_stage())


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


def run(pipeline, batch, seed=11):
    return pipeline(batch, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("sampler,eta", [("ddim", 0.0), ("plms", 0.0), ("ddim", 0.5)])
def test_segmented_inpaint_equals_one_call(model, sampler, eta):
    """5 steps in 5 segments: prep draws the posterior samples and x_T from
    the generator in the single call's order, and the segments run the same
    steps (PLMS carries its eps history; its step 0 runs in prep, so its
    first segment is empty and dropped; DDIM at eta 0.5 draws its step noise
    in order), so the outputs are bitwise equal."""
    batch = numpy_batch(make_batch(b=2))
    kw = dict(num_steps=5, guidance_scale=5.0, sampler=sampler, eta=eta, device="cpu")
    seg = make_inpaint_pipeline(model, sample_segments=5, **kw)
    assert isinstance(seg, SegmentedInpaint)
    one, got = run(make_inpaint_pipeline(model, **kw), batch), run(seg, batch)
    assert set(got) == {"camera", "lidar"}
    for k in one:
        torch.testing.assert_close(got[k], one[k], atol=0, rtol=0)
    out, walls = seg.timed_call(batch, torch.Generator().manual_seed(11))
    names = [n for n, _ in walls]
    assert names[0] == "prep" and names[-1] == "decode"
    assert len(names) == 2 + (4 if sampler == "plms" else 5)
    torch.testing.assert_close(out["camera"], one["camera"], atol=0, rtol=0)


def test_segmented_inpaint_checks_and_preflight(model):
    with pytest.raises(ValueError, match="divisible"):
        make_inpaint_pipeline(model, num_steps=5, sample_segments=2, device="cpu")
    with pytest.raises(ValueError, match="exact ddim or plms"):
        make_inpaint_pipeline(model, sampler="ddpm", sample_segments=2, device="cpu")
    with pytest.raises(ValueError, match="exact ddim or plms"):
        make_inpaint_pipeline(model, num_steps=4, sample_segments=2, encoder_interval=2,
                              device="cpu")
    seg = make_inpaint_pipeline(model, num_steps=4, sample_segments=2, device="cpu")
    # the preflight is ported (utils/hbm.py); on the CPU there is no budget
    # to check against, so it runs nothing and says so, as JAX's assert_fits
    # does without a memory analysis (tests/test_torch_oracle.py holds it
    # with a budget)
    assert seg.preflight(numpy_batch(make_batch(b=1, rng=np.random.default_rng(2)))) is False


@pytest.mark.parametrize("chunk", [1, 2])
def test_vae_chunk_pairs_equals_unchunked(model, chunk):
    """Posterior-mode encodes and decodes in chunks of 1 or 2 pairs of a
    4-pair batch (the UNet loop sees the same batch): the same output within
    1e-5, the fp32 rounding of convolutions the CPU runs with other kernels
    at another batch size."""
    batch = numpy_batch(make_batch(b=4, rng=np.random.default_rng(5)))
    kw = dict(num_steps=2, guidance_scale=5.0, sampler="plms", deterministic_encode=True,
              device="cpu")
    one = run(make_inpaint_pipeline(model, **kw), batch)
    got = run(make_inpaint_pipeline(model, vae_chunk_pairs=chunk, **kw), batch)
    for k in one:
        assert got[k].shape == one[k].shape
        torch.testing.assert_close(got[k], one[k], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible by vae_chunk_pairs"):
        run(make_inpaint_pipeline(model, vae_chunk_pairs=3, **kw), batch)
