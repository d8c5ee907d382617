"""Host data pipeline: the port of ``repro.data.pipeline`` — synthetic
generators per family and the prefetching feeder.

Every generator is numpy and a deterministic function of (seed, step), so
the port's arrays are byte for byte the reference's and a restarted job
regenerates the exact stream from its checkpointed cursor.  The caller (or
the ``Trainer``) moves them to the card (``torch.as_tensor(x, device=...)``).
``ShardedFeeder`` prepares batches ahead on a worker thread.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


def synthetic_embeddings(seed: int, n: int, dim: int, n_clusters: int = 64,
                         dtype=np.float32) -> np.ndarray:
    """Clustered unit-norm embeddings (CLIP-like geometry, paper §5.1)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, dim)).astype(dtype)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    a = rng.integers(0, n_clusters, n)
    x = centers[a] + 0.3 * rng.standard_normal((n, dim)).astype(dtype)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x


def synthetic_attributes(seed: int, n: int, m: int,
                         cardinalities: Optional[list] = None) -> np.ndarray:
    """int16 attribute rows: uniform over the int16 range (stress tests),
    or low-cardinality columns when ``cardinalities`` is given (cycled over
    the ``m`` columns)."""
    rng = np.random.default_rng(seed + 1)
    if cardinalities is None:
        return rng.integers(-32768, 32768, (n, m)).astype(np.int16)
    cols = [
        rng.integers(0, c, n).astype(np.int16)
        for c in (cardinalities * m)[:m]
    ]
    return np.stack(cols, axis=1)


# ----------------------------------------------------------------- LM ------
def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int
             ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((seed, step))
    tokens = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


# -------------------------------------------------------------- recsys -----
def recsys_batch(seed: int, step: int, batch: int, seq_len: int,
                 n_dense: int, n_sparse: int, vocab_items: int,
                 vocab_sparse: int) -> Dict[str, np.ndarray]:
    """One recsys batch (``models.recsys.RecsysBatch``'s fields); 15% of the
    history is ``-1`` padding."""
    rng = np.random.default_rng((seed, step))
    L = max(seq_len, 1)
    hist = rng.integers(0, vocab_items, (batch, L)).astype(np.int32)
    hist[rng.random((batch, L)) < 0.15] = -1
    return {
        "dense": rng.standard_normal((batch, n_dense)).astype(np.float32),
        "sparse": rng.integers(
            0, vocab_sparse, (batch, max(n_sparse, 1))
        ).astype(np.int32),
        "hist": hist,
        "target": rng.integers(0, vocab_items, batch).astype(np.int32),
        "label": (rng.random(batch) > 0.5).astype(np.float32),
    }


# ------------------------------------------------------------- feeder ------
@dataclasses.dataclass
class ShardedFeeder:
    """Prefetching iterator over a (seed, step) generator.

    ``generator(seed, step)`` returns a dict of host arrays for the GLOBAL
    batch; ``next()`` gives ``(step, batch)`` in step order from
    ``start_step``, with up to ``prefetch`` batches made ahead on a daemon
    thread.  ``close()`` stops the worker.
    """

    generator: Callable[[int, int], Dict[str, np.ndarray]]
    seed: int
    start_step: int = 0
    prefetch: int = 2

    def __post_init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._step = self.start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self.start_step
        while not self._stop.is_set():
            batch = self.generator(self.seed, step)
            self._q.put((step, batch))
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:  # unblock the worker
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
