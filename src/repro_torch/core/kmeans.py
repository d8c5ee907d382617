"""K-Means / MiniBatchKMeans for the index build (paper §4.2 steps 1-2):
the port of ``repro.core.kmeans``.

The assignment step is an argmax over ``2 x·C^T - ||C||²`` (one f32
``torch.matmul``; PyTorch keeps f32 products out of TF32 unless told
otherwise, and nothing here tells it), the update step an ``index_add_``
of the assigned rows and a ``bincount`` of the assignments.  On the card
``index_add_`` sums in no fixed order, so two runs may differ in the last
bit of a centroid.

``jax.random`` keys become a ``torch.Generator`` on the data's device.  The
loops are split from their randomness: :func:`run_minibatch` and
:func:`run_lloyd` start from a given :class:`KMeansState`, and the public
:func:`minibatch_kmeans` / :func:`kmeans_lloyd` draw the initial state and
the batch indices and call them.

No f32 copy of the whole data set is made: the reference casts all of ``x``
(30.7 GB at 10M x 768) where the port casts each batch and each assignment
chunk, which gives the same values.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

# Rows per assignment chunk: bounds the [chunk, K] score intermediate and
# the chunk's f32 copy.
ASSIGN_CHUNK = 65536


@dataclasses.dataclass
class KMeansState:
    centroids: torch.Tensor  # [K, D] f32
    counts: torch.Tensor  # [K] f32 — per-centroid sample counts (minibatch lr)
    step: int = 0


def init_from_sample(gen: torch.Generator, x: torch.Tensor,
                     n_clusters: int) -> KMeansState:
    """Random-subset init (the sklearn default for MiniBatchKMeans at
    scale): distinct rows when ``n >= n_clusters``, drawn with replacement
    otherwise.  ``gen`` lives on ``x``'s device."""
    n = x.shape[0]
    dev = x.device
    if n < n_clusters:
        idx = torch.randint(0, n, (n_clusters,), generator=gen, device=dev)
    else:
        idx = torch.randperm(n, generator=gen, device=dev)[:n_clusters]
    return KMeansState(
        centroids=x[idx].float(),
        counts=torch.zeros((n_clusters,), dtype=torch.float32, device=dev),
    )


def pairwise_neg_dist2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``-(||x - c||^2)`` up to a per-row constant: ``2 x·c - ||c||^2``,
    [B, K] f32."""
    x = x.float()
    c = c.float()
    return 2.0 * (x @ c.T) - torch.sum(c * c, dim=-1)[None, :]


def assign(x: torch.Tensor, centroids: torch.Tensor, *,
           chunk: Optional[int] = None) -> torch.Tensor:
    """Nearest-centroid assignment, int32 [N]; ties go to the lower
    centroid id (``argmax`` returns the first maximum).

    ``chunk`` bounds the ``[chunk, K]`` score intermediate for large N·K.
    """
    if chunk is None or x.shape[0] <= chunk:
        return torch.argmax(pairwise_neg_dist2(x, centroids), dim=-1).int()
    return torch.cat([
        torch.argmax(pairwise_neg_dist2(x[i:i + chunk], centroids), dim=-1)
        for i in range(0, x.shape[0], chunk)
    ]).int()


def lloyd_step(state: KMeansState, x: torch.Tensor, *,
               chunk: int = ASSIGN_CHUNK
               ) -> Tuple[KMeansState, torch.Tensor]:
    """One full-batch Lloyd iteration over ``x`` in chunks of ``chunk``
    rows. Returns (state, inertia), the inertia an f32 scalar tensor."""
    k, d = state.centroids.shape
    dev = state.centroids.device
    sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
    cnts = torch.zeros((k,), dtype=torch.float32, device=dev)
    inertia = torch.zeros((), dtype=torch.float64, device=dev)
    for r0 in range(0, x.shape[0], chunk):
        xb = x[r0:r0 + chunk].float()
        scores = pairwise_neg_dist2(xb, state.centroids)
        a = torch.argmax(scores, dim=-1)
        best = scores.amax(dim=-1)
        sums.index_add_(0, a, xb)
        cnts += torch.bincount(a, minlength=k)
        # ||x-c||^2 = ||x||^2 - (2x·c - ||c||^2)
        inertia += torch.sum(torch.sum(xb * xb, dim=-1) - best)
    new_c = torch.where(cnts[:, None] > 0,
                        sums / torch.clamp(cnts, min=1.0)[:, None],
                        state.centroids)
    return (KMeansState(new_c, state.counts + cnts, state.step + 1),
            inertia.float())


def minibatch_step(state: KMeansState, batch: torch.Tensor) -> KMeansState:
    """One MiniBatchKMeans step (Sculley 2010, as in sklearn).

    Per-center learning rate 1/count: ``c ← c + (1/cnt) Σ (x - c)`` over the
    batch members assigned to c.
    """
    k = state.centroids.shape[0]
    a = assign(batch, state.centroids).long()
    b32 = batch.float()
    sums = torch.zeros_like(state.centroids).index_add_(0, a, b32)
    cnts = torch.bincount(a, minlength=k).float()
    new_counts = state.counts + cnts
    lr = torch.where(new_counts > 0,
                     1.0 / torch.clamp(new_counts, min=1.0), 0.0)
    # c_new = c + lr * (sum_x - cnt * c)
    delta = sums - cnts[:, None] * state.centroids
    new_c = state.centroids + lr[:, None] * delta
    return KMeansState(new_c, new_counts, state.step + 1)


def run_minibatch(state: KMeansState, x: torch.Tensor,
                  index_batches: Iterable[torch.Tensor]) -> KMeansState:
    """Minibatch steps from ``state``, one over ``x[idx]`` for each index
    tensor of ``index_batches``."""
    for idx in index_batches:
        state = minibatch_step(state, x[idx])
    return state


def run_lloyd(state: KMeansState, x: torch.Tensor, n_iters: int, *,
              chunk: int = ASSIGN_CHUNK
              ) -> Tuple[KMeansState, torch.Tensor]:
    """``n_iters`` Lloyd iterations from ``state``; returns (state, inertia
    trace [n_iters] f32)."""
    trace = []
    for _ in range(n_iters):
        state, inertia = lloyd_step(state, x, chunk=chunk)
        trace.append(inertia)
    if not trace:
        return state, torch.zeros((0,), dtype=torch.float32,
                                  device=state.centroids.device)
    return state, torch.stack(trace)


def minibatch_kmeans(gen: torch.Generator, x: torch.Tensor, *,
                     n_clusters: int, n_steps: int,
                     batch_size: int) -> KMeansState:
    """MiniBatchKMeans over random batches of ``x``: a sampled init, then
    ``n_steps`` batches of ``batch_size`` rows drawn with replacement, all
    from ``gen`` (on ``x``'s device)."""
    state = init_from_sample(gen, x, n_clusters)
    n = x.shape[0]
    batches = (torch.randint(0, n, (batch_size,), generator=gen,
                             device=x.device) for _ in range(n_steps))
    return run_minibatch(state, x, batches)


def kmeans_lloyd(gen: torch.Generator, x: torch.Tensor, *, n_clusters: int,
                 n_iters: int) -> Tuple[KMeansState, torch.Tensor]:
    """Full Lloyd K-Means from a sampled init; returns (state, inertia
    trace [n_iters])."""
    return run_lloyd(init_from_sample(gen, x, n_clusters), x, n_iters)
