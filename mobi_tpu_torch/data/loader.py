"""Host input pipeline (mobi_tpu data/loader.py): a prefetching loader with
thread or process workers, feeding fixed-shape numpy batches; the caller
moves them to the device.

Two worker modes:
  * threads (default) — zero startup cost; right when `__getitem__` is
    dominated by GIL-releasing work (large numpy ops) or the host has one
    core.
  * processes (`num_procs > 0`, spawn) — the torch num_workers analogue
    for multi-core hosts where the GIL caps the Python-heavy
    `__getitem__` (the JPEG entropy decoder is a Python loop); the dataset is pickled once per worker
    (NuScenesDataset state is plain numpy).

Both modes yield batches in the SAME seed-deterministic index order (a
reorder buffer sequences worker completions), which the multi-host
contract requires: every process must consume batch i of the same global
epoch order at step i or the collective shards mix samples from different
batches.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np

from mobi_tpu_torch.data.nuscenes import collate


def _proc_worker(dataset, assigned, q, stop):
    """Worker-process body: materialize assigned (index, batch-indices)
    pairs in order. Module-level for spawn picklability."""
    try:
        for idx, idxs in assigned:
            if stop.is_set():
                return
            samples = [dataset[int(i)] for i in idxs]
            q.put(("ok", idx, collate(samples)))
    except Exception as e:  # re-raised (typed) in the consumer
        q.put(("err", -1, f"{type(e).__name__}: {e}"))


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_threads: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        shard_index: int = 0,
        num_shards: int = 1,
        num_procs: int = 0,
        mp_context: str = "spawn",
    ):
        """`batch_size` is per-process. With num_shards > 1 (multi-host:
        shard_index = this process's rank, num_shards = the world size)
        every process computes the SAME seed-deterministic global epoch
        order over global batches of batch_size * num_shards samples and
        materializes only its contiguous slice (the torch
        DistributedSampler analogue), so the slices concatenate in process
        order.

        num_procs > 0 switches from threads to that many spawned worker
        processes (configs/mobi_nusc_512.yaml num_workers_per_gpu); the
        dataset must pickle. Either way batches arrive in deterministic
        index order.
        """
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        assert 0 <= shard_index < num_shards
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.num_procs = int(num_procs)
        self.mp_context = mp_context
        self._epoch = 0

    @property
    def global_batch_size(self) -> int:
        return self.batch_size * self.num_shards

    def __len__(self) -> int:
        n = len(self.dataset) // self.global_batch_size
        if (not self.drop_last and self.num_shards == 1
                and len(self.dataset) % self.global_batch_size):
            n += 1
        return n

    def _epoch_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1

        gbs = self.global_batch_size
        batches = [order[i : i + gbs] for i in range(0, len(order), gbs)]
        if self.drop_last or self.num_shards > 1:
            # multi-host never yields a ragged tail: every process must
            # dispatch the same global shapes or the collectives deadlock
            batches = [b for b in batches if len(b) == gbs]
        if self.num_shards > 1:
            lo = self.shard_index * self.batch_size
            batches = [b[lo : lo + self.batch_size] for b in batches]
        return batches

    def __iter__(self) -> Iterator[Any]:
        batches = self._epoch_batches()
        if self.num_procs > 0:
            yield from self._iter_procs(batches)
        else:
            yield from self._iter_threads(batches)

    # ------------------------------------------------------------- threads
    def _iter_threads(self, batches) -> Iterator[Any]:
        q: "queue.Queue" = queue.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def worker(idx_batches):
            for idx, idxs in idx_batches:
                if stop.is_set():
                    return
                try:
                    samples = [self.dataset[int(i)] for i in idxs]
                    q.put(("ok", idx, collate(samples)))
                except Exception as e:  # surfaces in the consumer
                    q.put(("err", -1, e))
                    return

        indexed = list(enumerate(batches))
        chunks = [indexed[t :: self.num_threads]
                  for t in range(self.num_threads)]
        threads = [
            threading.Thread(target=worker, args=(c,), daemon=True)
            for c in chunks
            if c
        ]
        for t in threads:
            t.start()

        # reorder buffer: yield strictly in batch-index order so every
        # host of a multi-host run sees the identical sequence regardless
        # of worker scheduling
        buf = {}
        try:
            for i in range(len(batches)):
                while i not in buf:
                    kind, idx, item = q.get()
                    if kind == "err":
                        raise item
                    buf[idx] = item
                yield buf.pop(i)
        finally:
            stop.set()
            while True:  # unblock producers stuck on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    # ------------------------------------------------------------ processes
    def _iter_procs(self, batches) -> Iterator[Any]:
        import multiprocessing as mp

        ctx = mp.get_context(self.mp_context)
        q = ctx.Queue(maxsize=max(1, self.prefetch))
        stop = ctx.Event()
        nw = min(self.num_procs, max(1, len(batches)))
        indexed = list(enumerate(batches))
        procs = []
        for w in range(nw):
            assigned = indexed[w::nw]
            if not assigned:
                continue
            p = ctx.Process(
                target=_proc_worker, args=(self.dataset, assigned, q, stop),
                daemon=True,
            )
            p.start()
            procs.append(p)

        buf = {}
        try:
            for i in range(len(batches)):
                while i not in buf:
                    kind, idx, item = q.get()
                    if kind == "err":
                        raise RuntimeError(f"loader worker failed: {item}")
                    buf[idx] = item
                yield buf.pop(i)
        finally:
            stop.set()
            while True:  # unblock producers stuck on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
            q.close()
            q.cancel_join_thread()
