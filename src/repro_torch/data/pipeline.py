"""Host data pipeline, a numpy copy of ``repro.data.pipeline``: synthetic LM
token streams, PHV packet batching, and a background prefetcher.

``lm_batches`` yields {tokens, labels} batches (Zipf-distributed synthetic
corpus with local n-gram structure so losses actually decrease), equal to
the JAX package's bit for bit for the same seed.  ``phv_batches`` chunks a
packet trace into fixed-size batches for the feature pipeline (the
switch->server record channel).  ``Prefetcher`` overlaps host generation
with device compute via a worker thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


def lm_batches(vocab: int, batch: int, seq: int, n_batches: int,
               seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Zipf unigrams + a deterministic bigram mixer: predictable structure."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.3, size=(n_batches, batch, seq + 1)).astype(np.int64)
    base = base % (vocab - 1) + 1
    for i in range(n_batches):
        toks = base[i]
        # bigram structure: every even position partly determines the next
        toks[:, 1::2] = (toks[:, 0:-1:2] * 31 + 7) % (vocab - 1) + 1
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def phv_batches(trace: Dict[str, np.ndarray], batch: int
                ) -> Iterator[Dict[str, np.ndarray]]:
    n = len(trace["ts"])
    for i in range(0, n, batch):
        yield {k: v[i:i + batch] for k, v in trace.items()}


class Prefetcher:
    """Wrap an iterator; a worker thread keeps ``depth`` items ready."""

    _END = object()

    def __init__(self, it: Iterator, depth: int = 2, transform=None):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.transform = transform

        def work():
            try:
                for item in it:
                    self.q.put(self.transform(item) if self.transform else item)
            finally:
                self.q.put(self._END)

        self.thread = threading.Thread(target=work, daemon=True)
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._END:
            raise StopIteration
        return item
