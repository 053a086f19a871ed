"""Batched, prefetching input pipeline (`tripled_tpu/data/pipeline.py`).

- `BatchLoader`: an epoch-seeded shuffle, one RandomState per sample from
  (seed, epoch, index), whole batches only, and a thread pool that assembles the
  next two batches while the current one trains;
- `prefetch_to_device`: a producer thread pins each host batch and copies
  it to the card on a stream of its own, so that the copy overlaps the
  step; the consumer's stream waits for it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


class BatchLoader:
    """Batches of `batch_size` samples of shard `shard_index` of
    `num_shards` (a rank of `parallel.dist`; the global batch is
    batch_size * num_shards). Each epoch's order is cut to whole global
    batches (`drop_last`) or padded to them from its start, then split into
    contiguous per-shard slices, as the JAX loader and the reference's
    DistributedGroupSampler do."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 1024,
                 num_workers: int = 4, num_shards: int = 1, shard_index: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        g = np.random.RandomState(self.seed + self.epoch)
        idx = g.permutation(n) if self.shuffle else np.arange(n)
        global_batch = self.batch_size * self.num_shards
        if self.drop_last:
            idx = idx[:(n // global_batch) * global_batch]
        else:
            idx = np.concatenate([idx, idx[:(-n) % global_batch]])
        per = len(idx) // self.num_shards
        return idx[self.shard_index * per:(self.shard_index + 1) * per]

    def __len__(self):
        return len(self._epoch_indices()) // self.batch_size

    def _sample(self, ds_index) -> dict:
        rng = np.random.RandomState((self.seed + self.epoch * 1_000_003 + int(ds_index)) % (2**31))
        return self.dataset.sample(int(ds_index), rng)

    def __iter__(self) -> Iterator[dict]:
        indices = self._epoch_indices()
        bs = self.batch_size
        batches = [indices[i:i + bs] for i in range(0, len(indices) - bs + 1, bs)]
        if self.num_workers <= 1:
            for batch_idx in batches:
                yield _collate([self._sample(j) for j in batch_idx])
            return
        # assemble batches k+1 and k+2 while batch k trains
        with ThreadPoolExecutor(self.num_workers) as pool:
            it = iter(batches)
            pending = [pool.map(self._sample, b) for b in (next(it, None), next(it, None))
                       if b is not None]
            while pending:
                samples = list(pending.pop(0))
                b = next(it, None)
                if b is not None:
                    pending.append(pool.map(self._sample, b))
                yield _collate(samples)


def _collate(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        # gt_depth has each image's own size: it stays a host-side list
        out[k] = vals if k == "gt_depth" else np.stack(vals)
    return out


_END = object()


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_to_device(iterator, device, size: int = 2) -> Iterator[dict]:
    """Batches of `iterator` (dicts of numpy arrays) as tensors on `device`,
    `size` batches ahead. On a CUDA device a producer thread pins each
    array and copies it with non_blocking=True on its own stream, then
    records an event; the consumer makes its current stream wait on that
    event and marks each tensor used there, so that the caching allocator
    does not hand the memory out while the consumer's stream still reads
    it. An exception in the producer is raised again in the consumer. On
    the CPU the arrays are only converted. `gt_depth` stays a host list."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: v if k == "gt_depth" else torch.from_numpy(v) for k, v in batch.items()}
        return

    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        last = _END
        try:
            with torch.cuda.device(device):
                stream = torch.cuda.Stream(device)
                for batch in iterator:
                    with torch.cuda.stream(stream):
                        dev = {k: v if k == "gt_depth" else
                               torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
                               for k, v in batch.items()}
                        ready = torch.cuda.Event()
                        ready.record(stream)
                    if not put((dev, ready)):
                        return
        except Exception as e:  # handed to the consumer, which raises it
            last = _Raised(e)
        finally:
            put(last)
            close = getattr(iterator, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Raised):
                raise item.exc
            dev, ready = item
            stream = torch.cuda.current_stream(device)
            stream.wait_event(ready)
            for v in dev.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(stream)
            yield dev
    finally:
        stop.set()
        thread.join()
