"""Load generator for the port's HTTP server (mobi_tpu_torch.serve_http),
the port's counterpart of scripts/serve_loadgen.py: concurrent clients,
served throughput and latency percentiles.

Fires `--warmup` sequential requests, then `--n` requests from `--clients`
threads, and prints wall time, inpaints/hour served and per-request latency
percentiles as one JSON line. Payloads are random arrays of the flagship's
shapes (numpy and urllib only).

Usage:
  python -m mobi_tpu_torch.serve_loadgen --port 8476
      [--n 40] [--clients 40] [--warmup 1] [--h 512] [--w 512]
"""
from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, Tuple

import numpy as np


def make_sample(rng: np.random.Generator, h: int, w: int) -> Dict[str, np.ndarray]:
    """One request's flat sample ('/'-joined keys, no batch dim); the
    reference crop is 224 x 224 from h = 224 up, else h x w."""
    f32 = np.float32

    def u(*s):
        return rng.uniform(-1, 1, s).astype(f32)

    return {
        "image/GT": u(h, w, 3),
        "image/inpaint_image": u(h, w, 3),
        "image/inpaint_mask": np.ones((h, w, 1), f32),
        "image/cond/ref_image": u(224, 224, 3) if h >= 224 else u(h, w, 3),
        "image/cond/ref_bbox": rng.uniform(0, 1, (8, 3)).astype(f32),
        "lidar/range_data": u(h, w, 2),
        "lidar/range_data_inpaint": u(h, w, 2),
        "lidar/range_mask": np.ones((h, w, 1), f32),
        "lidar/cond/ref_bbox": rng.uniform(0, 1, (8, 3)).astype(f32),
    }


def encode(flat: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **flat)
    return buf.getvalue()


def post(url: str, body: bytes, timeout: float) -> Tuple[float, Dict[str, np.ndarray]]:
    """POST a pre-encoded npz body; returns (seconds, decoded outputs), and
    raises on a non-finite output."""
    req = urllib.request.Request(url, data=body, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        resp = r.read()
    dt = time.perf_counter() - t0
    with np.load(io.BytesIO(resp)) as z:
        out = {k: z[k] for k in z.files}
    if not all(np.isfinite(v).all() for v in out.values()):
        raise AssertionError("non-finite output")
    return dt, out


def get_json(url: str, timeout: float = 60.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--h", type=int, default=512)
    ap.add_argument("--w", type=int, default=512)
    ap.add_argument("--timeout", type=float, default=3600.0)
    args = ap.parse_args(argv)
    base = f"http://{args.host}:{args.port}"
    body = encode(make_sample(np.random.default_rng(0), args.h, args.w))

    for i in range(args.warmup):
        dt, _ = post(f"{base}/inpaint", body, args.timeout)
        print(f"# warmup {i}: {dt:.1f}s", file=sys.stderr, flush=True)

    lat = [None] * args.n
    errors, rejected = [], []

    def worker(i):
        try:
            lat[i] = post(f"{base}/inpaint", body, args.timeout)[0]
        except urllib.error.HTTPError as e:
            if e.code == 503:  # a clean overload rejection (--max-queue full)
                rejected.append(i)
            else:
                errors.append(f"HTTPError {e.code}: {e}")
        except Exception as e:
            errors.append(f"{type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(args.n)]
    for group in range(0, args.n, args.clients):
        chunk = threads[group:group + args.clients]
        for t in chunk:
            t.start()
        for t in chunk:
            t.join()
    wall = time.perf_counter() - t0

    if errors:
        print(json.dumps({"errors": errors[:5], "n_errors": len(errors)}))
        sys.exit(1)
    lat_s = sorted(t for t in lat if t is not None)
    n_served = len(lat_s)
    print(json.dumps({
        "n": args.n, "clients": args.clients, "wall_s": wall, "served": n_served,
        "rejected_503": len(rejected), "served_per_hour": n_served / wall * 3600,
        "latency_p50_s": lat_s[n_served // 2] if n_served else None,
        "latency_p95_s": lat_s[max(0, int(n_served * 0.95) - 1)] if n_served else None,
        "server_stats": get_json(f"{base}/stats"),
    }))


if __name__ == "__main__":
    main()
