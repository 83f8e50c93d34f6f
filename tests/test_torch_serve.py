"""The port's InpaintService and HTTP front (mobi_tpu_torch.serve,
serve_http, serve_loadgen) on the tiny config on the CPU: the port's
counterparts of tests/test_serve.py's eight tests, each holding the service
against the port's own pipeline, and the server's `main` path from a tiny
reference-schema YAML and a checkpoint exported from the JAX package.

The contract: a request's output depends only on its sample, the batch it
was served in and that batch's generator (seeded by `batch_seed(rng_seed,
batch index)`); padding the tail with repeats must not leak into the real
samples.
"""
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mobi_tpu_torch import serve_http, serve_loadgen
from mobi_tpu_torch.models import diffusion as tdiff
from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.pipeline import make_inpaint_pipeline
from mobi_tpu_torch.serve import (InpaintService, OverloadedError, batch_generator, batch_seed,
                                  outputs_to_numpy, stack_samples)
from tests.test_diffusion import TINY, make_batch
from tests.test_torch_models import few_torch_threads, port_config, tiny_cond_stage  # noqa: F401

PIPE_KW = dict(num_steps=2, guidance_scale=2.0, sampler="plms")


@pytest.fixture(scope="module")
def model():
    return tdiff.MobiDiffusion(port_config(TINY), device="cpu", seed=4,
                               cond_stage_model=tiny_cond_stage())


@pytest.fixture(autouse=True)
def launches_stay_zero():
    _build.reset_launches()
    yield
    assert not any(_build.launches.values()), "a CPU tensor launched a kernel"


def samples(n, seed=0):
    """n per-sample trees (numpy, no batch dim)."""
    batch = make_batch(b=n, rng=np.random.default_rng(seed))

    def pick(tree, i):
        return {k: pick(v, i) for k, v in tree.items()} if isinstance(tree, dict) \
            else np.asarray(tree)[i]

    return [pick(batch, i) for i in range(n)]


def direct(model, batch_samples, batch_idx=0, rng_seed=0):
    """The port's pipeline on the stacked batch with the generator of the
    service's seeding rule."""
    fn = make_inpaint_pipeline(model, device="cpu", **PIPE_KW)
    return outputs_to_numpy(fn(stack_samples(batch_samples),
                               batch_generator("cpu", rng_seed, batch_idx)))


def test_coalesced_batch_matches_direct(model):
    reqs = samples(2)
    svc = InpaintService(model, batch_pairs=2, max_wait_ms=5000, autostart=False, **PIPE_KW)
    futs = [svc.submit(s) for s in reqs]
    svc.start()
    results = [f.result(timeout=300) for f in futs]
    svc.stop(timeout=60)
    assert svc.stats == {"batches": 1, "samples": 2, "padded": 0, "errors": 0, "rejected": 0}
    ref = direct(model, reqs)
    for i, res in enumerate(results):
        assert set(res) == {"camera", "lidar"} and res["camera"].dtype == np.float32
        for k, v in res.items():
            np.testing.assert_array_equal(v, ref[k][i], err_msg=f"sample {i} key {k}")


def test_tail_padding_does_not_leak(model):
    """3 requests into batches of 4: the pad slot repeats the last sample,
    and every real output equals the direct run of exactly that batch."""
    reqs = samples(3, seed=1)
    svc = InpaintService(model, batch_pairs=4, max_wait_ms=5000, autostart=False, **PIPE_KW)
    futs = [svc.submit(s) for s in reqs]
    svc.start()
    results = [f.result(timeout=300) for f in futs]
    svc.stop(timeout=60)
    assert svc.stats["padded"] == 1 and svc.stats["samples"] == 3
    ref = direct(model, reqs + [reqs[-1]])
    for i, res in enumerate(results):
        for k, v in res.items():
            np.testing.assert_array_equal(v, ref[k][i])
    assert batch_seed(0, 0) != batch_seed(0, 1) != batch_seed(1, 0)


def test_concurrent_submitters(model):
    reqs = samples(6, seed=2)
    svc = InpaintService(model, batch_pairs=2, max_wait_ms=50, **PIPE_KW)
    results = [None] * 6

    def worker(i):
        results[i] = svc.submit(reqs[i]).result(timeout=300)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    svc.stop(timeout=60)
    assert svc.stats["samples"] == 6 and svc.stats["errors"] == 0
    for res in results:
        assert res is not None
        assert all(np.isfinite(v).all() for v in res.values())


def test_error_fans_out_and_service_survives(model):
    svc = InpaintService(model, batch_pairs=1, max_wait_ms=10, **PIPE_KW)
    good = samples(1)[0]
    bad = {k: ({kk: vv[..., :1] for kk, vv in v.items()} if isinstance(v, dict) else v[..., :1])
           for k, v in good["image"].items()}
    with pytest.raises(Exception):
        svc.submit({**good, "image": bad}).result(timeout=300)
    served = svc.submit(good).result(timeout=300)  # a good request afterwards still serves
    svc.stop(timeout=60)
    assert svc.stats["errors"] == 1
    assert all(np.isfinite(v).all() for v in served.values())


def test_bounded_queue_rejects_cleanly(model):
    """max_queue bounds the backlog: submits against a full queue raise
    OverloadedError at once (counted as rejected), the accepted requests
    all complete once the dispatcher drains, and a stopped service rejects."""
    reqs = samples(4, seed=4)
    svc = InpaintService(model, batch_pairs=2, max_wait_ms=10, autostart=False, max_queue=2,
                         **PIPE_KW)
    accepted = [svc.submit(s) for s in reqs[:2]]  # fills the queue
    for s in reqs[2:]:
        with pytest.raises(OverloadedError):
            svc.submit(s)
    assert svc.stats["rejected"] == 2
    svc.start()
    results = [f.result(timeout=300) for f in accepted]
    svc.stop(timeout=60)
    assert svc.stats["samples"] == 2
    for res in results:
        assert all(np.isfinite(v).all() for v in res.values())
    with pytest.raises(OverloadedError, match="stopping"):
        svc.submit(reqs[0])


def test_submit_timeout_waits_for_space(model):
    """submit(timeout > 0) waits for queue space instead of rejecting: with
    the dispatcher draining, the wait succeeds."""
    reqs = samples(3, seed=5)
    svc = InpaintService(model, batch_pairs=1, max_wait_ms=5, autostart=False, max_queue=1,
                         **PIPE_KW)
    first = svc.submit(reqs[0])
    svc.start()
    futs = [svc.submit(s, timeout=300) for s in reqs[1:]]
    results = [f.result(timeout=300) for f in [first] + futs]
    svc.stop(timeout=60)
    assert svc.stats["rejected"] == 0 and svc.stats["samples"] == 3
    for res in results:
        assert all(np.isfinite(v).all() for v in res.values())


def test_latency_stats(model):
    svc = InpaintService(model, batch_pairs=2, max_wait_ms=10, **PIPE_KW)
    assert svc.latency_stats() == {"latency_count": 0}
    for f in [svc.submit(s) for s in samples(4, seed=6)]:
        f.result(timeout=300)
    svc.stop(timeout=60)
    ls = svc.latency_stats()
    assert ls["latency_count"] == 4
    assert 0 < ls["latency_p50_s"] <= ls["latency_p95_s"] <= ls["latency_p99_s"]


def serve_in_thread(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def test_http_roundtrip(model):
    """/healthz, one /inpaint through the loadgen's client (the served
    output equals the direct pipeline's), /stats, and a 404."""
    svc = InpaintService(model, batch_pairs=1, max_wait_ms=10, **PIPE_KW)
    server = serve_http.make_server(svc, port=0)
    base = serve_in_thread(server)
    try:
        assert serve_loadgen.get_json(f"{base}/healthz", 30) == {"ok": True}
        sample = samples(1, seed=3)[0]
        body = serve_http.encode_npz(serve_http.flatten_tree(sample))
        _, out = serve_loadgen.post(f"{base}/inpaint", body, 600)
        ref = direct(model, [sample])
        assert set(out) == set(ref)
        for k, v in out.items():
            np.testing.assert_array_equal(v, ref[k][0])
        stats = serve_loadgen.get_json(f"{base}/stats", 30)
        assert stats["samples"] == 1 and stats["errors"] == 0 and stats["latency_count"] == 1
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(f"{base}/nowhere", timeout=30)
    finally:
        server.shutdown()
        server.server_close()
        svc.stop(timeout=60)


TINY_YAML = """\
use_camera: True
use_lidar: True
image_height: 32
range_height: 32
precision: fp32
conditions: [ref_image, ref_bbox]
model:
  params:
    linear_start: 0.00085
    linear_end: 0.0120
    timesteps: 1000
    cond_stage_key: ${conditions}
    image_size: 8
    channels: 4
    scale_factor: 0.18215
    lidar_scale_factor: 0.18215
    use_ema: True
    use_camera: ${use_camera}
    use_lidar: ${use_lidar}
    unet_config:
      params:
        model_channels: 32
        attention_resolutions: [2, 1]
        num_res_blocks: 1
        channel_mult: [1, 2]
        num_heads: 4
        context_dim: 64
    first_stage_config:
      params:
        embed_dim: 4
        ddconfig: {ch: 16, ch_mult: [1, 1, 2], num_res_blocks: 1}
"""


def test_main_path_from_yaml_and_ckpt(tmp_path, monkeypatch):
    """`server_from_args` (what `main` runs before serving): a tiny
    reference-schema YAML, a torch-saved checkpoint exported from the JAX
    tiny model with a LitEma shadow of its UNet, `use_ema: True`; the served
    model holds the EMA UNet and the live rest, and answers one request over
    HTTP as the direct pipeline on it does. The tiny CLIP tower stands in for
    the YAML path's ViT-L/14, which the tiny checkpoint does not fit."""
    from mobi_tpu.export_torch import export_from_config
    from mobi_tpu.models.diffusion import MobiDiffusion as JaxMobi
    from tests.test_diffusion import TinyCondStage
    from tests.test_torch_models import random_params

    jmodel = JaxMobi(TINY)
    jmodel.cond_model = TinyCondStage(conditions=("ref_image", "ref_bbox"))
    params = random_params(jmodel, seed=8)
    ema_unet = random_params(jmodel, seed=9)["unet"]
    sd = export_from_config(TINY, params, ema_unet=ema_unet, ema_num_updates=7)
    ema_only = export_from_config(TINY, {"unet": ema_unet})
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}},
               tmp_path / "tiny.ckpt")
    (tmp_path / "tiny.yaml").write_text(TINY_YAML)

    def tiny_model(config, device=None, seed=0):
        want = port_config(TINY)
        for name in ("latent_size", "image_height", "range_height", "unet_channels",
                     "unet_channel_mult", "unet_num_res_blocks", "unet_attention_resolutions",
                     "unet_num_heads", "context_dim", "vae_ch", "vae_ch_mult",
                     "vae_num_res_blocks", "use_camera", "use_lidar", "cond_stage_key", "dtype"):
            assert getattr(config, name) == getattr(want, name), name  # the YAML reached MobiConfig
        return tdiff.MobiDiffusion(want, device=device, seed=seed, cond_stage_model=tiny_cond_stage())

    monkeypatch.setattr(serve_http, "MobiDiffusion", tiny_model)
    server, svc, _ = serve_http.server_from_args(
        ["--config", str(tmp_path / "tiny.yaml"), "--ckpt", str(tmp_path / "tiny.ckpt"),
         "--port", "0", "--batch-pairs", "1", "--ddim_steps", "2", "--scale", "2.0", "--plms",
         "--max-wait-ms", "10", "--device", "cpu"])
    for k, v in svc.model.state_dict().items():
        src = ema_only if k.startswith("model.diffusion_model.") else sd
        np.testing.assert_array_equal(v.numpy(), src[k], err_msg=k)
    base = serve_in_thread(server)
    try:
        sample = samples(1, seed=7)[0]
        _, out = serve_loadgen.post(
            f"{base}/inpaint", serve_http.encode_npz(serve_http.flatten_tree(sample)), 600)
        ref = outputs_to_numpy(make_inpaint_pipeline(
            svc.model, num_steps=2, guidance_scale=2.0, sampler="plms", device="cpu")(
            stack_samples([sample]), batch_generator("cpu", 0, 0)))
        for k, v in out.items():
            np.testing.assert_array_equal(v, ref[k][0])
    finally:
        server.shutdown()
        server.server_close()
        svc.stop(timeout=60)
    with pytest.raises(NotImplementedError, match="convert.state_dict_from_jax"):
        serve_http.build_service(port_config(TINY), ckpt=str(tmp_path), device="cpu")
