"""Online index updates (paper §4.5) plus deletion and compaction: the
port of ``repro.core.update``.

The paper's add path assigns each new hybrid vector to its nearest
centroid and appends it to that centroid's flat list.  The append has
capacity semantics: rows that would overflow a full list are dropped and
counted (``n_dropped``), so the caller can split or rebuild.  A delete
tombstones the slot (its id becomes -1); the slot is reclaimed by
:func:`compact_cluster`.

The functions return a new index and leave their input as it was, as the
reference's do; a mutated field is copied whole (a full-size RAM index
copies its ``[K, Vpad, D]`` vectors on every add).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import kmeans as kmeans_lib
from repro_torch.core import summaries as summaries_lib
from repro_torch.core.hybrid import make_hybrid
from repro_torch.core.ivf import IVFFlatIndex


def quantize_rows(core: torch.Tensor, *, reciprocal: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SQ8 codes and scales of new rows: ``scale = max(|x|, 1e-12) / 127``,
    ``codes = clip(round(x / scale))`` (codes as f32 values in [-127,
    127]).  ``reciprocal`` takes the scale as ``max(|x|, 1e-12) ·
    f32(1/127)``, which is what the reference's jitted ``add_vectors``
    computes (XLA folds a division by a constant into that product, which
    rounds differently in about one row in twenty); its delta tier runs
    eagerly and divides.  The divisor is a tensor: PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which would give the
    card other scales than the CPU."""
    c32 = core.float()
    amax = torch.clamp(c32.abs().amax(-1), min=1e-12)
    scale = (amax * (1.0 / 127.0) if reciprocal
             else amax / torch.full_like(amax, 127.0))
    codes = torch.clamp(torch.round(c32 / scale[:, None]), -127, 127)
    return codes, scale


def add_vectors(index: IVFFlatIndex, core, attrs, new_ids
                ) -> Tuple[IVFFlatIndex, int]:
    """Appends a batch of vectors (paper §4.5 steps 1-4, batched).

    Returns ``(index', n_dropped)``.  Assignment uses the core part only;
    each row lands at its cluster's count plus its rank among the batch's
    rows of that cluster (stable in batch order).
    """
    dev = index.vectors.device
    core, attrs = make_hybrid(index.spec, core, attrs, device=dev)
    b = core.shape[0]
    a = kmeans_lib.assign(core.float(), index.centroids).long()  # [B]
    order = torch.argsort(a, stable=True)
    a_sorted = a[order]
    starts = torch.searchsorted(a_sorted, torch.arange(index.n_clusters,
                                                       device=dev))
    rank = torch.empty((b,), dtype=torch.long, device=dev)
    rank[order] = torch.arange(b, device=dev) - starts[a_sorted]
    slot = index.counts.long()[a] + rank  # [B]
    ok = slot < index.vpad
    ka, ks = a[ok], slot[ok]

    if index.quantized:
        codes, new_scale = quantize_rows(core, reciprocal=True)
        core_store = codes
    else:
        core_store = core
    vectors = index.vectors.clone()
    vectors[ka, ks] = core_store[ok].to(vectors.dtype)
    attrs_out = index.attrs.clone()
    attrs_out[ka, ks] = attrs[ok].to(attrs_out.dtype)
    ids = index.ids.clone()
    ids[ka, ks] = torch.as_tensor(new_ids, device=dev).int()[ok]
    norms = index.norms
    if norms is not None:
        norms = norms.clone()
        norms[ka, ks] = torch.sum(core.float() ** 2, -1)[ok]
    scales = index.scales
    if scales is not None:
        scales = scales.clone()
        scales[ka, ks] = new_scale[ok]
    added = torch.bincount(ka, minlength=index.n_clusters).int()
    n_dropped = b - int(added.sum())
    summ = index.summaries
    if summ is not None:
        summ = summaries_lib.widen_for_add(summ, a, attrs.short(), ok)
    return dataclasses.replace(
        index, vectors=vectors, attrs=attrs_out, ids=ids,
        counts=index.counts + added, norms=norms, scales=scales,
        summaries=summ,
    ), n_dropped


def tombstone(index: IVFFlatIndex, cluster, slot) -> IVFFlatIndex:
    """Marks (cluster, slot) pairs deleted: ids become -1, counts stay (the
    high-water mark still bounds the scan), pairs out of range are ignored.

    Summaries are left stale-wide, which is the sound direction (they
    never prune a cluster with a live passing row); :func:`stale_counts`
    tracks the debt and :func:`compact_stale` pays it down.
    """
    dev = index.ids.device
    c = torch.as_tensor(cluster, device=dev).long().reshape(-1)
    s = torch.as_tensor(slot, device=dev).long().reshape(-1)
    inside = (c >= 0) & (c < index.n_clusters) & (s >= 0) & (s < index.vpad)
    ids = index.ids.clone()
    ids[c[inside], s[inside]] = -1
    return dataclasses.replace(index, ids=ids)


def stale_counts(index: IVFFlatIndex) -> torch.Tensor:
    """[K] int32 — tombstoned rows still under each cluster's count."""
    within = (torch.arange(index.vpad, device=index.ids.device)[None, :]
              < index.counts[:, None])
    return (within & (index.ids < 0)).sum(1, dtype=torch.int32)


def compact_stale(index: IVFFlatIndex, threshold: int = 1
                  ) -> Tuple[IVFFlatIndex, int]:
    """Compacts every cluster holding ``>= threshold`` tombstoned rows;
    returns ``(index', n_compacted)``.  Each touched cluster's summary row
    is rebuilt exactly."""
    stale = stale_counts(index)
    touched = torch.nonzero(stale >= max(threshold, 1))[:, 0].tolist()
    for c in touched:
        index = compact_cluster(index, int(c))
    return index, len(touched)


def resync_partitions(index) -> IVFFlatIndex:
    """Rebuilds an attached RAM index's sub-partition rows from their parents.

    The update functions mutate base cluster rows only; the attached sub
    copies go stale until this pass re-selects each sub's rows with the
    build's rule (``partitions.select_sub_rows``), refreshes the catalog's
    per-sub counts and intervals, and recomputes the entry-row estimates
    the router ranks by.  Returns the resynced index (an index without
    sub-partitions is returned as it is).
    """
    import numpy as np

    cat = getattr(index, "partitions", None)
    if cat is None or cat.n_subs == 0:
        return index
    from repro_torch.core import partitions as partitions_lib

    k = cat.n_base
    attrs_h = index.attrs.cpu().numpy()
    ids_h = index.ids.cpu().numpy()
    counts_h = index.counts.cpu().numpy()
    vectors, attrs, ids = (index.vectors.clone(), index.attrs.clone(),
                           index.ids.clone())
    counts = index.counts.clone()
    norms = None if index.norms is None else index.norms.clone()
    scales = None if index.scales is None else index.scales.clone()
    sub_counts = np.asarray(cat.sub_counts, np.int32).copy()
    sub_amin = np.asarray(cat.sub_amin, np.int16).copy()
    sub_amax = np.asarray(cat.sub_amax, np.int16).copy()
    dev = vectors.device
    for p in range(cat.n_subs):
        c = int(cat.parent[p])
        rows = partitions_lib.select_sub_rows(
            attrs_h[c], ids_h[c], int(counts_h[c]),
            np.asarray(cat.sub_lo[p]), np.asarray(cat.sub_hi[p]))
        n = int(rows.size)
        g = k + p
        rows_t = torch.from_numpy(rows.astype(np.int64)).to(dev)
        for arr, fill in ((vectors, 0), (attrs, 0), (ids, -1), (norms, 0),
                          (scales, 0)):
            if arr is None:
                continue
            arr[g] = fill
            if n:
                arr[g, :n] = arr[c, rows_t]
        counts[g] = n
        sub_counts[p] = n
        if n:
            sub_amin[p] = attrs_h[c, rows].min(axis=0)
            sub_amax[p] = attrs_h[c, rows].max(axis=0)
        else:
            sub_amin[p] = summaries_lib.ATTR_MAX
            sub_amax[p] = summaries_lib.ATTR_MIN
    out = dataclasses.replace(index, vectors=vectors, attrs=attrs, ids=ids,
                              counts=counts, norms=norms, scales=scales)
    out.partitions = cat.resynced(counts_h, sub_counts, sub_amin, sub_amax)
    return out


def compact_cluster(index: IVFFlatIndex, cluster: int) -> IVFFlatIndex:
    """Reclaims one cluster's tombstoned slots: live rows move to the front
    in slot order, the dead rows' data follows them (ids -1), the count
    becomes the live count and the summary row is rebuilt exactly."""
    dev = index.ids.device
    vpad = index.vpad
    live = index.ids[cluster] >= 0  # [Vpad]
    pos = torch.arange(vpad, device=dev)
    perm = torch.argsort(torch.where(live, pos, vpad + pos))
    n_live = int(live.sum())

    def moved(field):
        if field is None:
            return None
        out = field.clone()
        out[cluster] = field[cluster][perm]
        return out

    ids = moved(index.ids)
    ids[cluster] = torch.where(pos < n_live, ids[cluster], -1)
    attrs = moved(index.attrs)
    counts = index.counts.clone()
    counts[cluster] = n_live
    summ = index.summaries
    if summ is not None:
        summ = summaries_lib.rebuild_cluster(summ, attrs[cluster],
                                             ids[cluster], cluster)
    return dataclasses.replace(
        index, vectors=moved(index.vectors), attrs=attrs, ids=ids,
        counts=counts, norms=moved(index.norms), scales=moved(index.scales),
        summaries=summ,
    )
