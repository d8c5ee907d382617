"""Synthetic data for the index build: the port of ``repro.data.pipeline``'s
ANN generators.

Both are numpy and deterministic functions of ``seed``, so the port's
arrays are byte for byte the reference's; the caller moves them to the card
(``torch.as_tensor(x, device=...)``).  The LM and recsys batch generators
and the prefetching feeder belong to the training substrate, which is not
ported yet (ROADMAP A.10).
"""

from __future__ import annotations

from typing import Optional

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
