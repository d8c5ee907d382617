"""Hybrid IVF-Flat index structure and construction (paper §4.2): the port
of ``repro.core.ivf``.

Storage layout (the reference's, unchanged):

  centroids : [K, D]        f32
  vectors   : [K, Vpad, D]  bf16/f32 (int8 under SQ8) — padded flat lists
  attrs     : [K, Vpad, M]  int16
  ids       : [K, Vpad]     int32 — original ids; -1 marks an empty or
                                    tombstoned slot
  norms     : [K, Vpad]     f32   — ||v||², only for metric="l2"
  scales    : [K, Vpad]     f32   — SQ8 per-row scale
  counts    : [K]           int32 — live-slot high-water mark per list

``build_ivf`` runs the whole build (k-means, assignment, scatter) from a
``torch.Generator``; its random streams are not the reference's, so tests
hold it against ``build_from_assignments`` over its own centroids.
``index_from_arrays`` carries a reference index's state across as numpy
arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import kmeans as kmeans_lib
from repro_torch.core import summaries as summaries_lib
from repro_torch.core.hybrid import HybridSpec, make_hybrid
from repro_torch.core.summaries import ClusterSummaries
from repro_torch.device import resolve_device


@dataclasses.dataclass
class IVFFlatIndex:
    spec: HybridSpec
    centroids: torch.Tensor
    vectors: torch.Tensor
    attrs: torch.Tensor
    ids: torch.Tensor
    counts: torch.Tensor
    norms: Optional[torch.Tensor] = None
    scales: Optional[torch.Tensor] = None  # [K, Vpad] f32 under SQ8
    summaries: Optional[ClusterSummaries] = None

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @property
    def store_dtype(self) -> torch.dtype:
        """Storage dtype of the flat lists (int8 under SQ8)."""
        return self.vectors.dtype

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def vpad(self) -> int:
        return self.vectors.shape[1]

    def nbytes(self) -> int:
        total = 0
        for f in (self.centroids, self.vectors, self.attrs, self.ids,
                  self.counts, self.norms, self.scales):
            if f is not None:
                total += f.numel() * f.element_size()
        if self.summaries is not None:
            total += self.summaries.nbytes()
        return total


@dataclasses.dataclass(frozen=True)
class BuildStats:
    n_vectors: int
    n_dropped: int  # capacity overflow drops (0 unless vpad was forced too low)
    max_list_len: int
    mean_list_len: float
    vpad: int
    kmeans_steps: int


def default_n_clusters(n: int) -> int:
    """Paper §4.2/§4.3 heuristic: N/1000 small, sqrt(N) at scale."""
    if n <= 1_000_000:
        return max(1, n // 1000) or 1
    return int(np.sqrt(n))


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Rows (scatter) or clusters (per-list passes) per step: bounds the
# temporaries of a full-size build to a slice of the index.
_ROW_CHUNK = 1 << 20
_CLUSTER_CHUNK = 64


def scatter_to_lists(values: torch.Tensor, assignments: torch.Tensor,
                     n_clusters: int, vpad: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Sorts rows by cluster (stably) and scatters them into padded lists.

    Returns (lists [K, vpad, ...], slot_of_row [N] int32, n_dropped).  Rows
    beyond a list's capacity are dropped, as the reference's
    ``mode="drop"`` scatter does.
    """
    n = assignments.shape[0]
    dev = values.device
    a = assignments.long()
    order = torch.argsort(a, stable=True)
    a_sorted = a[order]
    starts = torch.searchsorted(a_sorted, torch.arange(n_clusters, device=dev))
    pos = torch.arange(n, device=dev) - starts[a_sorted]
    lists = torch.zeros((n_clusters, vpad) + tuple(values.shape[1:]),
                        dtype=values.dtype, device=dev)
    for r0 in range(0, n, _ROW_CHUNK):
        p = pos[r0:r0 + _ROW_CHUNK]
        keep = p < vpad
        lists[a_sorted[r0:r0 + _ROW_CHUNK][keep], p[keep]] = (
            values[order[r0:r0 + _ROW_CHUNK][keep]]
        )
    dropped = int((pos >= vpad).sum())
    slot_of_row = torch.zeros((n,), dtype=torch.int32, device=dev)
    slot_of_row[order] = pos.int()
    return lists, slot_of_row, dropped


def build_from_assignments(
    spec: HybridSpec,
    centroids,
    core,
    attrs,
    assignments,
    *,
    vpad: Optional[int] = None,
    ids=None,
    with_summaries: bool = True,
    summary_bins: int = summaries_lib.DEFAULT_N_BINS,
    device="cuda",
) -> Tuple[IVFFlatIndex, BuildStats]:
    """Builds the padded index given precomputed assignments (§4.2 steps 2-4)."""
    dev = resolve_device(device)
    core, attrs = make_hybrid(spec, core, attrs, device=dev)
    assignments = torch.as_tensor(assignments, device=dev).long()
    centroids = torch.as_tensor(centroids, device=dev)
    n = core.shape[0]
    k = centroids.shape[0]
    counts = torch.bincount(assignments, minlength=k)
    max_len = int(counts.max())
    if vpad is None:
        vpad = max(round_up(max_len, 128), 128)
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=dev)
    ids = torch.as_tensor(ids, device=dev).int()

    vec_lists, _, dropped = scatter_to_lists(core, assignments, k, vpad)
    attr_lists, _, _ = scatter_to_lists(attrs, assignments, k, vpad)
    id_lists, _, _ = scatter_to_lists(ids, assignments, k, vpad)
    # scatter_to_lists zero-fills; repaint empty slots with the -1 sentinel
    live = (torch.arange(vpad, device=dev)[None, :]
            < torch.clamp(counts, max=vpad)[:, None])
    id_lists = torch.where(live, id_lists, -1)

    norms = None
    if spec.metric == "l2":
        norms = torch.empty((k, vpad), dtype=torch.float32, device=dev)
        for c0 in range(0, k, _CLUSTER_CHUNK):
            v = vec_lists[c0:c0 + _CLUSTER_CHUNK].float()
            norms[c0:c0 + _CLUSTER_CHUNK] = torch.sum(v ** 2, dim=-1)

    summ = (
        summaries_lib.build_summaries(attr_lists, id_lists, n_bins=summary_bins)
        if with_summaries and spec.n_attrs > 0 else None
    )
    index = IVFFlatIndex(
        spec=spec,
        centroids=centroids.float(),
        vectors=vec_lists,
        attrs=attr_lists,
        ids=id_lists,
        counts=torch.clamp(counts, max=vpad).int(),
        norms=norms,
        summaries=summ,
    )
    stats = BuildStats(
        n_vectors=n,
        n_dropped=dropped,
        max_list_len=max_len,
        mean_list_len=float(counts.float().mean()),
        vpad=vpad,
        kmeans_steps=0,
    )
    return index, stats


def build_ivf(
    gen: torch.Generator,
    spec: HybridSpec,
    core,
    attrs,
    *,
    n_clusters: Optional[int] = None,
    vpad: Optional[int] = None,
    kmeans_mode: str = "minibatch",
    kmeans_steps: int = 100,
    kmeans_batch: int = 4096,
    assign_chunk: int = 65536,
    ids=None,
    with_summaries: bool = True,
    summary_bins: int = summaries_lib.DEFAULT_N_BINS,
    device="cuda",
) -> Tuple[IVFFlatIndex, BuildStats]:
    """End-to-end index build (paper §4.2): centroids → assign → scatter.

    ``kmeans_mode``: ``"minibatch"`` (the paper's scalable path) or
    ``"lloyd"`` (its quality path); anything else raises.  ``gen`` draws
    the k-means init and batches and lives on ``device``.  K-means and the
    assignment read ``core`` as given (each batch and chunk cast to f32);
    the lists store it in ``spec.core_dtype``.
    """
    dev = resolve_device(device)
    core = torch.as_tensor(core, device=dev)
    n = core.shape[0]
    k = n_clusters or default_n_clusters(n)
    if kmeans_mode == "minibatch":
        state = kmeans_lib.minibatch_kmeans(
            gen, core, n_clusters=k, n_steps=kmeans_steps,
            batch_size=min(kmeans_batch, n))
    elif kmeans_mode == "lloyd":
        state, _ = kmeans_lib.kmeans_lloyd(gen, core, n_clusters=k,
                                           n_iters=kmeans_steps)
    else:
        raise ValueError(f"unknown kmeans_mode {kmeans_mode!r}")
    assignments = kmeans_lib.assign(core, state.centroids, chunk=assign_chunk)
    index, stats = build_from_assignments(
        spec, state.centroids, core, attrs, assignments, vpad=vpad, ids=ids,
        with_summaries=with_summaries, summary_bins=summary_bins, device=dev)
    return index, dataclasses.replace(stats, kmeans_steps=kmeans_steps)


def _to_tensor(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """numpy → tensor, taking ml_dtypes' bfloat16 (which ``from_numpy``
    refuses) through an exact int16 view."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # torch tensors may be written in place
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def index_from_arrays(arrays: Dict[str, np.ndarray], spec: HybridSpec, *,
                      device="cuda") -> IVFFlatIndex:
    """The port's index from a reference index's fields as numpy arrays.

    Keys: ``centroids, vectors, attrs, ids, counts`` (required), ``norms,
    scales`` (optional, None or absent when unused) and the summaries'
    ``amin, amax, hist, edges_lo, edges_hi`` (all or none).
    """
    dev = resolve_device(device)

    def get(name):
        a = arrays.get(name)
        return None if a is None else _to_tensor(np.asarray(a), dev)

    summ = None
    if arrays.get("amin") is not None:
        summ = ClusterSummaries(
            amin=get("amin"), amax=get("amax"), hist=get("hist"),
            edges_lo=get("edges_lo"), edges_hi=get("edges_hi"),
        )
    return IVFFlatIndex(
        spec=spec, centroids=get("centroids"), vectors=get("vectors"),
        attrs=get("attrs"), ids=get("ids"), counts=get("counts"),
        norms=get("norms"), scales=get("scales"), summaries=summ,
    )


def validity_mask(index: IVFFlatIndex) -> torch.Tensor:
    """[K, Vpad] bool — live slots (within count and not tombstoned)."""
    slot = torch.arange(index.vpad, device=index.ids.device)[None, :]
    return (slot < index.counts[:, None]) & (index.ids >= 0)


def quantize_index(index: IVFFlatIndex) -> IVFFlatIndex:
    """SQ8: per-vector symmetric int8 quantization of the flat lists.

    score(q, v̂) = (q · v_int8) · scale; centroids stay f32.
    """
    if index.quantized:
        return index
    k, vpad, d = index.vectors.shape
    dev = index.vectors.device
    q = torch.empty((k, vpad, d), dtype=torch.int8, device=dev)
    scale = torch.empty((k, vpad), dtype=torch.float32, device=dev)
    for c0 in range(0, k, _CLUSTER_CHUNK):
        v32 = index.vectors[c0:c0 + _CLUSTER_CHUNK].float()
        # a tensor divisor: the card divides too (by a Python scalar it
        # would multiply by the reciprocal and round otherwise)
        s = torch.clamp(v32.abs().amax(-1), min=1e-12)
        s = s / torch.full_like(s, 127.0)
        q[c0:c0 + _CLUSTER_CHUNK] = torch.clamp(
            torch.round(v32 / s[..., None]), -127, 127).to(torch.int8)
        scale[c0:c0 + _CLUSTER_CHUNK] = s
    return dataclasses.replace(index, vectors=q, scales=scale)


def dequantize_rows(vectors: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[..., Vpad, D] int8 + [..., Vpad] scale → f32 rows."""
    return vectors.float() * scales[..., None]
