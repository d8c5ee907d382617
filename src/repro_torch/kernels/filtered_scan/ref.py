"""Plain PyTorch versions of the filtered scans (the kernels' contracts).

The CPU paths of :func:`repro_torch.kernels.filtered_scan.filtered_scan.
filtered_scan_tiled` and :func:`~repro_torch.kernels.filtered_scan.
filtered_scan.filtered_scan`, and what the CUDA kernels are held against on
the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.topk import NEG_INF, top_k


def _dnf_mask(attrs: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
              ) -> torch.Tensor:
    """attrs [..., V, M] against bounds [..., F, M] (int32, broadcast over
    the leading axes) → [..., V] bool: OR over F terms of AND over M."""
    fmask = None
    for f in range(lo.shape[-2]):
        term = None
        for m in range(lo.shape[-1]):
            am = attrs[..., m]
            inside = (am >= lo[..., f, m, None]) & (am <= hi[..., f, m, None])
            term = inside if term is None else term & inside
        fmask = term if fmask is None else fmask | term
    return fmask


def filtered_scan_ref(
    slot_cluster: torch.Tensor,  # [P] int32
    slot_query: torch.Tensor,  # [P] int32
    queries: torch.Tensor,  # [Q, D]
    lo: torch.Tensor,  # [Q, F, M] int16
    hi: torch.Tensor,  # [Q, F, M] int16
    vectors: torch.Tensor,  # [K, Vpad, D]
    attrs: torch.Tensor,  # [K, Vpad, M] int16
    ids: torch.Tensor,  # [K, Vpad] int32
    norms: Optional[torch.Tensor] = None,  # [K, Vpad] f32
    scales: Optional[torch.Tensor] = None,  # [K, Vpad] f32 (SQ8)
    *,
    metric: str = "dot",
    chunk: int = 64,
) -> torch.Tensor:
    """Returns masked scores [P, Vpad] f32: slot p's query against every
    row of its cluster (dot; SQ8 dot times the row scale; l2 as
    ``2·dot − ‖v‖²``), NEG_INF where the filter or liveness fails.

    Works ``chunk`` slots at a time, so it never holds more than one
    chunk's ``[chunk, Vpad, D]`` f32 gather.
    """
    p = slot_cluster.shape[0]
    vpad = vectors.shape[1]
    out = torch.empty((p, vpad), dtype=torch.float32, device=vectors.device)
    for c0 in range(0, p, chunk):
        sc = slot_cluster[c0:c0 + chunk].long()
        sq = slot_query[c0:c0 + chunk].long()
        v = vectors[sc].float()  # [c, V, D]
        q = queries[sq].float()  # [c, D]
        dots = torch.bmm(v, q[:, :, None])[..., 0]  # [c, V]
        if scales is not None:
            dots = dots * scales[sc]
        score = dots if metric == "dot" else 2.0 * dots - norms[sc]
        mask = _dnf_mask(attrs[sc].int(), lo[sq].int(), hi[sq].int())
        mask &= ids[sc] >= 0
        out[c0:c0 + chunk] = torch.where(mask, score, NEG_INF)
    return out


def live_slots(slot_tile: torch.Tensor, n_unique: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """[S] bool — slots that are not dedup pads.

    The slot table is tile-major with ``u_cap = S / n_tiles`` slots per
    tile; a slot at position ``>= n_unique[tile]`` within its tile repeats
    the tile's last unique cluster and is skipped.  ``n_unique=None``
    treats every slot as live.
    """
    s = slot_tile.shape[0]
    if n_unique is None:
        return torch.ones((s,), dtype=torch.bool, device=slot_tile.device)
    u_cap = s // n_unique.shape[0]
    tile = slot_tile.long()
    pos = torch.arange(s, device=slot_tile.device) - tile * u_cap
    return pos < n_unique.long()[tile]


def filtered_scan_tiled_ref(
    slot_cluster: torch.Tensor,  # [S] int32
    slot_tile: torch.Tensor,  # [S] int32
    n_unique: Optional[torch.Tensor],  # [n_tiles] int32, or None: all live
    queries: torch.Tensor,  # [Qpad, D], Qpad a multiple of q_block
    lo: torch.Tensor,  # [Qpad, F, M] int16
    hi: torch.Tensor,  # [Qpad, F, M] int16
    vectors: torch.Tensor,  # [K, Vpad, D]
    attrs: torch.Tensor,  # [K, Vpad, M] int16
    ids: torch.Tensor,  # [K, Vpad] int32
    norms: Optional[torch.Tensor] = None,  # [K, Vpad] f32
    scales: Optional[torch.Tensor] = None,  # [K, Vpad] f32 (SQ8)
    *,
    metric: str = "dot",
    k: int = 10,
    q_block: int = 64,
    chunk: int = 16,
):
    """Returns (vals [S, QB, k] f32, ids [S, QB, k] int32, npass [S, QB]
    int32); pad slots hold (NEG_INF, -1, 0).  A slot whose cluster lies
    outside ``[0, K)`` is a pad too, as in the kernel.  Lists longer than
    the block's Vpad rows end in (NEG_INF, -1).

    Works ``chunk`` live slots at a time, so it never holds more than one
    chunk's ``[chunk, Vpad, D]`` gather.
    """
    s = slot_cluster.shape[0]
    d = queries.shape[-1]
    dev = queries.device
    kk = min(k, vectors.shape[1])
    qt = queries.reshape(-1, q_block, d)
    lot = lo.reshape(-1, q_block, *lo.shape[1:]).int()
    hit = hi.reshape(-1, q_block, *hi.shape[1:]).int()
    out_v = torch.full((s, q_block, k), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((s, q_block, k), -1, dtype=torch.int32, device=dev)
    out_n = torch.zeros((s, q_block), dtype=torch.int32, device=dev)
    live = (live_slots(slot_tile, n_unique) & (slot_cluster >= 0)
            & (slot_cluster < vectors.shape[0]))
    live = torch.nonzero(live).reshape(-1)
    for c0 in range(0, live.shape[0], chunk):
        sl = live[c0:c0 + chunk]
        sc = slot_cluster[sl].long()
        st = slot_tile[sl].long()
        v = vectors[sc].float()  # [c, V, D]
        q = qt[st].float()  # [c, QB, D]
        scores = torch.bmm(q, v.transpose(1, 2))  # [c, QB, V]
        if scales is not None:
            scores = scores * scales[sc][:, None, :]
        if metric == "l2":
            scores = 2.0 * scores - norms[sc][:, None, :]
        # attrs [c, 1, V, M] against each tile row's bounds [c, QB, F, M]
        fmask = _dnf_mask(attrs[sc].int()[:, None], lot[st], hit[st])
        mask = fmask & (ids[sc] >= 0)[:, None, :]
        scores = torch.where(mask, scores, NEG_INF)
        vals, idx = top_k(scores, kk)  # earliest row wins ties
        row_ids = torch.gather(ids[sc][:, None, :].expand(scores.shape), -1, idx)
        out_v[sl, :, :kk] = vals
        out_i[sl, :, :kk] = torch.where(vals > NEG_INF / 2, row_ids, -1).int()
        out_n[sl] = mask.sum(-1).int()
    return out_v, out_i, out_n
