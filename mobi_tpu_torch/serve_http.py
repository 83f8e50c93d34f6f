"""HTTP inference server for the port's inpainting (stdlib only), the port's
counterpart of scripts/serve.py.

A thin network front over `mobi_tpu_torch.serve.InpaintService`, which owns
the dynamic batching and the one thread that launches on the card. Handler
threads block on their request's Future, so concurrent HTTP clients
coalesce into full batches.

Protocol (binary bodies are npz):
  POST /inpaint   body = npz whose keys are '/'-joined sample-tree paths
                  (e.g. 'image/GT', 'lidar/range_data', 'image/cond/ref_image'),
                  each without a leading batch dim. Response: npz with the
                  decoded outputs ('camera', 'lidar'), float32.
  GET  /healthz   -> {"ok": true}
  GET  /stats     -> the service's counters (batches, samples, padded,
                  errors, rejected) and rolling latency percentiles

Overload: with --max-queue set, a request against a full queue gets HTTP 503
with Retry-After.

Usage (PyYAML reads the config):
  python -m mobi_tpu_torch.serve_http --config configs/mobi_nusc_512.yaml
      [--ckpt model.ckpt] [--port 8476] [--batch-pairs 20] [--ddim_steps 50]
      [--scale 5.0] [--plms] [--max-wait-ms 200] [--sample-segments 5]
      [--max-queue 64] [--submit-timeout-s 0] [--seed 0] [--device cuda]
      [key=value overrides]
"""
from __future__ import annotations

import argparse
import io
import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence, Tuple

import numpy as np

from mobi_tpu_torch.convert import load_checkpoint
from mobi_tpu_torch.models.diffusion import MobiConfig, MobiDiffusion
from mobi_tpu_torch.serve import InpaintService, OverloadedError


def flatten_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat):
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def encode_npz(flat: dict) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **flat)
    return buf.getvalue()


def decode_npz(body: bytes) -> dict:
    with np.load(io.BytesIO(body)) as z:
        return {k: z[k] for k in z.files}


def make_server(service: InpaintService, port: int = 0) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server around a service, on 127.0.0.1;
    port 0 takes a free one."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; the counters are on /stats
            pass

        def _send(self, code, body: bytes, ctype: str, extra=()):
            self.send_response(code)
            for k, v in extra:
                self.send_header(k, v)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200, extra=()):
            self._send(code, json.dumps(obj).encode(), "application/json", extra)

        def do_GET(self):
            if self.path == "/healthz":
                self._json({"ok": True})
            elif self.path == "/stats":
                self._json({**service.stats, **service.latency_stats()})
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            if self.path != "/inpaint":
                self._json({"error": "not found"}, 404)
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                sample = unflatten_tree(decode_npz(self.rfile.read(n)))
                out = service.submit(sample).result()
                self._send(200, encode_npz(out), "application/npz")
            except OverloadedError as e:
                self._json({"error": f"overloaded: {e}"}, 503, [("Retry-After", "1")])
            except Exception as e:
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def build_service(config: MobiConfig, *, ckpt: str = "", use_ema: bool = False, seed: int = 0,
                  device=None, batch_pairs: int = 20, max_wait_ms: float = 200.0,
                  max_queue: int = 0, submit_timeout_s: float = 0.0, num_steps: int = 50,
                  guidance_scale: float = 5.0, sampler: str = "ddim", sample_segments: int = 1,
                  autostart: bool = True) -> InpaintService:
    """The model (seeded random weights, then the checkpoint over them) and
    its service: what `main` runs after parsing its flags."""
    model = MobiDiffusion(config, device=device, seed=seed)
    if ckpt:
        report = load_checkpoint(model, ckpt, use_ema)
        print(f"loaded {report['loaded']} tensors from {ckpt}"
              + (" with the EMA overlay" if report["ema"] else "")
              + (f"; {len(report['missing'])} kept their random values" if report["missing"] else ""),
              flush=True)
    else:
        print("WARNING: no --ckpt, serving random weights (smoke mode)", flush=True)
    return InpaintService(
        model, batch_pairs=batch_pairs, max_wait_ms=max_wait_ms, rng_seed=seed,
        autostart=autostart, max_queue=max_queue, submit_timeout_s=submit_timeout_s,
        num_steps=num_steps, guidance_scale=guidance_scale, sampler=sampler,
        sample_segments=sample_segments)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default="")
    p.add_argument("--port", type=int, default=8476)
    p.add_argument("--batch-pairs", dest="batch_pairs", type=int, default=20)
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--max-wait-ms", dest="max_wait_ms", type=float, default=200.0)
    p.add_argument("--sample-segments", dest="sample_segments", type=int,
                   default=int(os.environ.get("MOBI_ITB_SEGMENTS", "1")))
    p.add_argument("--max-queue", dest="max_queue", type=int, default=0,
                   help="bound the request queue; 0 = unbounded. Full queue -> HTTP 503")
    p.add_argument("--submit-timeout-s", dest="submit_timeout_s", type=float, default=0.0,
                   help="how long a submit may wait for queue space before 503 (0 = reject at once)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    return p.parse_args(argv)


def server_from_args(argv: Optional[Sequence[str]] = None
                     ) -> Tuple[ThreadingHTTPServer, InpaintService, argparse.Namespace]:
    """Parse, read the YAML config, build the service and its (unstarted)
    server."""
    from mobi_tpu_torch.utils.config import load_config, mobi_config_from_yaml

    opt = parse_args(argv)
    cfg = load_config([opt.config], [s for s in opt.overrides if "=" in s])
    service = build_service(
        mobi_config_from_yaml(cfg), ckpt=opt.ckpt,
        use_ema=bool(cfg["model"]["params"].get("use_ema", False)), seed=opt.seed,
        device=opt.device, batch_pairs=opt.batch_pairs, max_wait_ms=opt.max_wait_ms,
        max_queue=opt.max_queue, submit_timeout_s=opt.submit_timeout_s,
        num_steps=opt.ddim_steps, guidance_scale=opt.scale,
        sampler="plms" if opt.plms else "ddim", sample_segments=opt.sample_segments)
    return make_server(service, opt.port), service, opt


def main(argv: Optional[Sequence[str]] = None) -> None:
    server, service, opt = server_from_args(argv)
    print(f"serving on http://127.0.0.1:{server.server_address[1]} "
          f"(batch_pairs={opt.batch_pairs}, steps={opt.ddim_steps})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.stop(timeout=60)


if __name__ == "__main__":
    main()
