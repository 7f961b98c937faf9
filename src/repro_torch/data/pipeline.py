"""Host-side data pipeline (port of ``repro/data/pipeline.py``): synthetic
batch sources, device placement with the plan's shardings, and a
background prefetcher that overlaps host data prep and the host-to-device
copies with device compute.

:func:`place_batch` turns a dict of numpy arrays into tensors on the
device; given a tree of :class:`repro_torch.core.sharding.NamedSharding`,
each leaf becomes this rank's block, as ``jax.device_put`` with a sharding
gives each device its block.  :class:`Prefetcher` places batches from a
background thread.  On a CUDA device its copies run on a side stream of
its own from pinned host memory; the consumer's stream waits on an event
recorded after each batch's copies before the batch is handed out, and
every tensor of the batch is marked as used by the consumer's stream, so
the caching allocator does not hand its memory to the side stream while
the consumer still reads it.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import tree_leaves, tree_map


def synthetic_lm_batches(vocab: int, batch: int, seq: int, steps: int,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic synthetic LM stream (zipf-ish token distribution)."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        ranks = rng.zipf(1.3, size=(batch, seq + 1))
        tokens = np.minimum(ranks - 1, vocab - 1).astype(np.int32)
        yield {"tokens": tokens[:, :-1],
               "targets": tokens[:, 1:],
               "mask": np.ones((batch, seq), np.float32)}


def place_batch(batch: Dict[str, np.ndarray], shardings: Optional[Any] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """Host numpy -> tensors on ``resolve_device(device)`` (``cuda``
    unless the caller asks for another), each cut to this rank's block by
    its ``NamedSharding`` in ``shardings`` (a tree like ``batch``) when one
    is given.  The block is cut on the host, so only it crosses to the
    device; a CUDA copy goes from pinned memory without blocking the host,
    ordered on the current stream."""
    dev = resolve_device(device)

    def put(v, s=None):
        t = torch.as_tensor(np.asarray(v))
        if s is not None:
            t = s.shard(t)
        if dev.type != "cuda":
            return t.to(dev)
        return t.pin_memory().to(dev, non_blocking=True)

    if shardings is None:
        return {k: put(v) for k, v in batch.items()}
    return tree_map(put, batch, shardings)


class Prefetcher:
    """Background-thread prefetch of ``size`` batches (host->device
    overlap): ``place(item, shardings, device)`` runs on the worker thread
    for each item of ``it``; iterating yields the placed batches in order.
    An exception of the source or of ``place`` is raised in the consumer
    after the batches placed before it, so a worker that dies cannot pass
    as a shorter stream.  :meth:`close` stops the worker early."""

    def __init__(self, it: Iterator, size: int = 2,
                 place: Callable = place_batch, shardings=None, device=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=size)
        self._done = object()
        self._stop = threading.Event()
        self._dev = dev = resolve_device(device)
        # the side stream the worker copies on (a CUDA device only)
        self._stream = (torch.cuda.Stream(device=dev) if dev.type == "cuda"
                        else None)

        def produce(item):
            if self._stream is None:
                return place(item, shardings, dev), None
            with torch.cuda.stream(self._stream):
                out = place(item, shardings, dev)
                ready = torch.cuda.Event()
                ready.record(self._stream)
            return out, ready

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(produce(item))
            except Exception as e:         # handed to the consumer
                self._q.put((e, None))
            finally:
                self._q.put((self._done, None))

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        while True:
            item, ready = self._q.get()
            if item is self._done:
                return
            if isinstance(item, Exception):
                raise item
            if ready is not None:
                stream = torch.cuda.current_stream(self._dev)
                stream.wait_event(ready)
                for t in tree_leaves(item):
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        t.record_stream(stream)
            yield item

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker after the item it is placing, dropping what it
        queued; waits at most ``timeout`` seconds for it to end."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._t.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
