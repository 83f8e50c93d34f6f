"""Dynamic-batching inference service over the inpaint pipeline (mobi_tpu
serve.py).

A compiled TPU program has one batch shape; here the batch shape is a
choice of the card's memory and of latency, and the service's job is the
same: coalesce concurrent single-sample requests into batches of
`batch_pairs`. `submit()` enqueues one (camera, lidar) request and returns a
Future; one dispatcher thread drains the queue, waits up to `max_wait_ms`
for the batch to fill, pads a short tail batch by repeating its last sample
(padding changes nothing for the real samples), runs the pipeline and fans
the per-sample outputs back to the futures. That thread owns every CUDA
launch, which also makes batch assembly deterministic.

Request samples use the per-sample dict schema of the dataset (leaves
without a batch dim, numpy); outputs come back as float32 numpy arrays.
Sampling noise is deterministic per batch: batch `i` draws from a
`torch.Generator` seeded with `batch_seed(rng_seed, i)`, the first 64 bits of
numpy's `SeedSequence((rng_seed, i))` (where the JAX service folds `i` into
its base key).

Overload: `max_queue > 0` bounds the queue; a `submit` against a full queue
waits up to `submit_timeout_s`, then raises `OverloadedError` (the HTTP front
answers 503). `stop()` stops accepting first, then drains everything already
accepted. End-to-end latency (submit -> future resolved) is kept in a
fixed-size window; `latency_stats()` reports p50/p95/p99.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mobi_tpu_torch.pipeline import make_inpaint_pipeline

_STOP = object()


class OverloadedError(RuntimeError):
    """The request queue is full (or the service stopped accepting)."""


@dataclass
class _Request:
    sample: Dict[str, Any]
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)


def stack_samples(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-sample trees (no batch dim) -> one batched tree of numpy arrays."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: stack_samples([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])


def batch_seed(rng_seed: int, batch_index: int) -> int:
    """The seed of batch `batch_index`'s generator."""
    return int(np.random.SeedSequence((rng_seed, batch_index)).generate_state(1, np.uint64)[0])


def batch_generator(device, rng_seed: int, batch_index: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(batch_seed(rng_seed, batch_index))


def outputs_to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Pipeline outputs -> float32 numpy on the host (bf16 has no numpy type)."""
    return {k: v.float().cpu().numpy() for k, v in out.items()}


class InpaintService:
    """Batched inpainting with dynamic request coalescing.

    `pipeline_kwargs` go to `make_inpaint_pipeline` (num_steps,
    guidance_scale, sampler, sample_segments, ...); the pipeline runs on the
    model's device. `batch_pairs` is the batch size; `max_wait_ms` bounds the
    wait of a lone request for the batch to fill. `max_queue > 0` bounds the
    queued requests; a submit against a full queue blocks up to
    `submit_timeout_s` (default: reject at once), then raises
    OverloadedError. 0 keeps the queue unbounded. `latency_window` sizes the
    rolling latency sample of `latency_stats()`.
    """

    def __init__(self, model, batch_pairs: int = 4, max_wait_ms: float = 50.0,
                 rng_seed: int = 0, autostart: bool = True, max_queue: int = 0,
                 submit_timeout_s: float = 0.0, latency_window: int = 1024,
                 **pipeline_kwargs):
        self.model, self._device = model, model.device
        # what the dispatcher runs on each batch: pipeline(batch, generator)
        self.pipeline = make_inpaint_pipeline(model, **{"device": model.device, **pipeline_kwargs})
        self._batch_pairs = int(batch_pairs)
        self._max_wait = float(max_wait_ms) / 1e3
        self._rng_seed = int(rng_seed)
        self.max_queue = int(max_queue)
        self._submit_timeout = float(submit_timeout_s)
        self._queue: queue.Queue = queue.Queue(maxsize=self.max_queue)
        self._lock = threading.Lock()
        self.stats = {"batches": 0, "samples": 0, "padded": 0, "errors": 0, "rejected": 0}
        self._latencies: collections.deque = collections.deque(maxlen=int(latency_window))
        self._accepting = True
        self._thread = threading.Thread(target=self._dispatch_loop, name="inpaint-dispatcher",
                                        daemon=True)
        self._started = False
        if autostart:
            self.start()

    # ------------------------------------------------------------- public
    def start(self) -> "InpaintService":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def submit(self, sample: Dict[str, Any], timeout: Optional[float] = None) -> Future:
        """Enqueue one sample (per-sample dict schema, no batch dim). The
        Future resolves to {"camera": [H, W, 3], "lidar": [H, W, 2]} float32
        numpy arrays. Raises OverloadedError when the bounded queue stays
        full past `timeout` (default: the service's submit_timeout_s), or
        after stop()."""
        if not self._accepting:
            raise OverloadedError("service is stopping; submit rejected")
        req = _Request(sample)
        timeout = self._submit_timeout if timeout is None else float(timeout)
        try:
            if timeout > 0:
                self._queue.put(req, timeout=timeout)
            else:
                self._queue.put_nowait(req)
        except queue.Full:
            with self._lock:
                self.stats["rejected"] += 1
            raise OverloadedError(f"request queue full ({self.max_queue}); retry later") from None
        return req.future

    def latency_stats(self) -> Dict[str, float]:
        """p50/p95/p99 end-to-end (submit -> result) latency in seconds over
        the rolling window, and the window's sample count."""
        with self._lock:
            lats = sorted(self._latencies)
        if not lats:
            return {"latency_count": 0}
        n = len(lats)

        def pct(p: float) -> float:
            return lats[min(n - 1, int(round(p / 100.0 * (n - 1))))]

        return {"latency_count": n, "latency_p50_s": pct(50), "latency_p95_s": pct(95),
                "latency_p99_s": pct(99)}

    def stop(self, timeout: Optional[float] = None) -> None:
        """Stop accepting, finish everything already accepted, then stop the
        dispatcher (accepted requests are never dropped)."""
        self._accepting = False
        if self._started:
            self._queue.put(_STOP)  # the dispatcher is draining: this lands
            self._thread.join(timeout)
        else:
            try:
                self._queue.put_nowait(_STOP)
            except queue.Full:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # --------------------------------------------------------- dispatcher
    def _collect(self):
        """Block for the first request, then fill the batch for up to
        max_wait_ms. Returns (requests, saw_stop)."""
        first = self._queue.get()
        if first is _STOP:
            return [], True
        reqs = [first]
        deadline = time.monotonic() + self._max_wait
        while len(reqs) < self._batch_pairs:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _STOP:
                return reqs, True
            reqs.append(nxt)
        return reqs, False

    def _run_batch(self, reqs) -> None:
        n_pad = self._batch_pairs - len(reqs)
        samples = [r.sample for r in reqs] + [reqs[-1].sample] * n_pad
        with self._lock:
            idx = self.stats["batches"]
            self.stats["batches"] += 1
            self.stats["samples"] += len(reqs)
            self.stats["padded"] += n_pad
        try:
            out = self.pipeline(stack_samples(samples),
                                 batch_generator(self._device, self._rng_seed, idx))
            out = outputs_to_numpy(out)
            now = time.monotonic()
            with self._lock:
                self._latencies.extend(now - r.t_submit for r in reqs)
            for i, r in enumerate(reqs):
                r.future.set_result({k: v[i] for k, v in out.items()})
        except Exception as e:  # fan the failure out, keep serving
            with self._lock:
                self.stats["errors"] += 1
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)

    def _dispatch_loop(self) -> None:
        while True:
            reqs, saw_stop = self._collect()
            if reqs:
                self._run_batch(reqs)
            if saw_stop:
                leftovers = []  # anything that raced in behind the sentinel
                while True:
                    try:
                        r = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if r is not _STOP:
                        leftovers.append(r)
                while leftovers:
                    chunk, leftovers = leftovers[:self._batch_pairs], leftovers[self._batch_pairs:]
                    self._run_batch(chunk)
                return
