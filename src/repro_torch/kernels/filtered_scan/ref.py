"""Plain PyTorch versions of the filtered scans (the kernels' contracts).

The CPU paths of :func:`repro_torch.kernels.filtered_scan.filtered_scan.
filtered_scan_tiled` and :func:`~repro_torch.kernels.filtered_scan.
filtered_scan.filtered_scan`, and what the CUDA kernels are held against on
the card; and, which only the tests call, :func:`split_scan_ref`, the
tiled tensor-core body's split arithmetic in plain PyTorch, and
:func:`tiled_select_ref`, the CUDA kernel's streaming selection step by step.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.topk import NEG_INF, top_k
from repro_torch.device import ieee_f32


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
        with ieee_f32():
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
    return _tiled(_f32_dots, slot_cluster, slot_tile, n_unique, queries, lo,
                  hi, vectors, attrs, ids, norms, scales, metric, k, q_block,
                  chunk)


def _f32_dots(q, v):
    with ieee_f32():
        return torch.bmm(q.float(), v.float().transpose(1, 2))


# The CUDA kernel's selection (csrc/filtered_scan_tiled.cu), for k <= 256.
SELECT_CHUNK = 128  # candidates a chunk: the tensor-core body's VT
PAD_POS = 0x7FFFFFFF  # a pad entry's position: after every row


def _before(va, pa, vb, pb):
    """(va, pa) before (vb, pb): value descending, then position ascending."""
    return (va > vb) | ((va == vb) & (pa < pb))


def _exchange(v, p, j, first):
    """One compare-exchange step over the last axis: entry e against entry
    e ^ j, keeping the earlier of the two where ``first`` [..., E] holds,
    else the later (the kernel's ``cx_lane`` and ``cx_slot``)."""
    e = torch.arange(v.shape[-1], device=v.device)
    ov, op = v[..., e ^ j], p[..., e ^ j]
    take = first == _before(ov, op, v, p)
    return torch.where(take, ov, v), torch.where(take, op, p)


def _sort_best_first(v, p):
    """The kernel's ``warp_sort``: a bitonic network over the last axis (a
    power of two), best first."""
    n = v.shape[-1]
    e = torch.arange(n, device=v.device)
    kk = 2
    while kk <= n:
        j = kk >> 1
        while j > 0:
            v, p = _exchange(v, p, j, ((e & j) == 0) == ((e & kk) == 0))
            j >>= 1
        kk <<= 1
    return v, p


def _sort_tail_worst_first(b, bp, nbp):
    """``merge_batch``'s batch sort: the top ``nbp`` of 32 lanes sorted
    worst first (a bitonic network of ``nbp`` entries; pads below)."""
    lane = torch.arange(32, device=b.device)
    kk = 2
    while kk <= nbp:
        j = kk >> 1
        while j > 0:
            worst_first = (kk == nbp) | ((lane & kk) == 0)
            b, bp = _exchange(b, bp, j, ((lane & j) == 0) != worst_first)
            j >>= 1
        kk <<= 1
    return b, bp


def _merge_batch(lv, lp, b, bp, nbp):
    """``merge_batch``: a sorted batch (32 lanes) into lists [N, R, 32]
    (slot, lane) kept best first; the slots no exchange touched skip their
    lane steps, row by row."""
    b, bp = _sort_tail_worst_first(b, bp, nbp)
    r = lv.shape[1]
    take = _before(b, bp, lv[:, -1], lp[:, -1])
    lv, lp = lv.clone(), lp.clone()
    lv[:, -1] = torch.where(take, b, lv[:, -1])
    lp[:, -1] = torch.where(take, bp, lp[:, -1])
    dirty = torch.zeros(lv.shape[:2], dtype=torch.bool, device=lv.device)
    dirty[:, -1] = True
    js = r // 2
    while js > 0:
        for s in range(r):
            if s & js:
                continue
            t = s + js
            act = dirty[:, s] | dirty[:, t]
            sw = _before(lv[:, t], lp[:, t], lv[:, s], lp[:, s]) & act[:, None]
            a_v, a_p = lv[:, s].clone(), lp[:, s].clone()
            lv[:, s] = torch.where(sw, lv[:, t], lv[:, s])
            lp[:, s] = torch.where(sw, lp[:, t], lp[:, s])
            lv[:, t] = torch.where(sw, a_v, lv[:, t])
            lp[:, t] = torch.where(sw, a_p, lp[:, t])
            any_sw = sw.any(-1)
            dirty[:, s] |= any_sw
            dirty[:, t] |= any_sw
        js >>= 1
    lane = torch.arange(32, device=lv.device)
    for s in range(r):
        d = dirty[:, s, None]
        v, p = lv[:, s], lp[:, s]
        j = 16
        while j > 0:
            nv, np_ = _exchange(v, p, j, (lane & j) == 0)
            v, p = torch.where(d, nv, v), torch.where(d, np_, p)
            j >>= 1
        lv[:, s], lp[:, s] = v, p
    return lv, lp


def chunked_topk(scores: torch.Tensor, k: int):
    """The CUDA kernel's streaming top-k of ``scores`` [..., V] (masked,
    NEG_INF where the filter or liveness fails), step by step: 128-row
    chunks in position order; with two or more slots a lane (R = 2, 4 or
    8; k > 32) the first chunk sorted whole into each row's list (32·R
    entries) where more than 32 of its candidates pass; with one (k <= 32)
    only the first chunk's passing candidates at or above the k-th largest
    of its 32 lanes' maxima (lane j holds columns j, j + 32, j + 64, j + 96)
    go on; from the next chunk on (and in a first chunk not sorted whole),
    the candidates strictly above the row's k-th compacted in position
    order and merged 32 at a time (sorted worst first, the best 32 of them
    and the list's last slot kept, a bitonic merge).  Returns (values [...,
    k], positions [..., k] int64), best first by (value descending,
    position ascending): :func:`~repro_torch.core.topk.top_k`'s order.
    k <= min(256, V)."""
    v_len = scores.shape[-1]
    if not 1 <= k <= min(256, v_len):
        raise ValueError(f"k={k}: the streaming selection takes 1..256, <= V")
    r = 1 if k <= 32 else 2 if k <= 64 else 4 if k <= 128 else 8
    lead = scores.shape[:-1]
    x = scores.reshape(-1, v_len).float()
    n, dev = x.shape[0], x.device
    nch = -(-v_len // SELECT_CHUNK)
    x = torch.cat([x, torch.full((n, nch * SELECT_CHUNK - v_len), NEG_INF,
                                 device=dev)], -1)
    cols = torch.arange(SELECT_CHUNK, device=dev)
    # a first chunk with more than 32 candidates passing is sorted whole;
    # one with fewer is folded as any other chunk (into the pads); at one
    # slot, only its candidates at or above the lanes' maxima's k-th
    whole = (x[:, :SELECT_CHUNK] > NEG_INF).sum(-1) > 32
    if r == 1:
        whole = torch.zeros_like(whole)
        lane_max = x[:, :SELECT_CHUNK].reshape(n, -1, 32).amax(1)
        floor = torch.sort(lane_max, -1, descending=True).values[:, k - 1]
    v0, p0 = _sort_best_first(x[:, :SELECT_CHUNK],
                              cols.expand(n, SELECT_CHUNK).clone())
    lv = torch.full((n, 32 * r), NEG_INF, device=dev)
    lp = torch.full((n, 32 * r), PAD_POS, dtype=torch.int64, device=dev)
    keep = min(32 * r, SELECT_CHUNK)
    lv[:, :keep] = torch.where(whole[:, None], v0[:, :keep], NEG_INF)
    lp[:, :keep] = torch.where(whole[:, None], p0[:, :keep], PAD_POS)
    lv, lp = lv.reshape(n, r, 32), lp.reshape(n, r, 32)
    lane = torch.arange(32, device=dev)
    for ch in range(nch):
        cand = x[:, ch * SELECT_CHUNK:(ch + 1) * SELECT_CHUNK]
        kth = lv.reshape(n, -1)[:, k - 1]
        sel = cand > kth[:, None]
        if ch == 0:
            sel &= ~whole[:, None]
            if r == 1:
                sel &= cand >= floor[:, None]
        cnt = sel.sum(-1)
        # the survivors' columns in column order, then the rest
        order = torch.sort(torch.where(sel, cols, SELECT_CHUNK + cols), -1
                           ).values.clamp(max=SELECT_CHUNK - 1)
        for b0 in range(0, int(cnt.max()), 32):
            nb = (cnt - b0).clamp(0, 32)
            in_b = lane >= 32 - nb[:, None]  # the batch in the top lanes
            c = torch.gather(order, 1, (b0 + 31 - lane).clamp(
                max=SELECT_CHUNK - 1).expand(n, 32))
            b = torch.where(in_b, torch.gather(cand, 1, c), NEG_INF)
            bp = torch.where(in_b, ch * SELECT_CHUNK + c, PAD_POS)
            nbp = 1
            while nbp < int(nb.max()):
                nbp <<= 1
            lv, lp = _merge_batch(lv, lp, b, bp, nbp)
    lv, lp = lv.reshape(n, -1)[:, :k], lp.reshape(n, -1)[:, :k]
    return lv.reshape(*lead, k), lp.reshape(*lead, k)


def tiled_select_ref(slot_cluster, slot_tile, n_unique, queries, lo, hi,
                     vectors, attrs, ids, norms=None, scales=None, *,
                     metric="dot", k=10, q_block=64, chunk=16):
    """:func:`filtered_scan_tiled_ref` with the CUDA kernel's selection
    (:func:`chunked_topk`) in place of a sort: the same arguments and
    results, k <= 256.  Only the tests call it."""
    return _tiled(_f32_dots, slot_cluster, slot_tile, n_unique, queries, lo,
                  hi, vectors, attrs, ids, norms, scales, metric, k, q_block,
                  chunk, select=chunked_topk)


def bf16_terms(x: torch.Tensor, n: int) -> list:
    """``x`` as ``n`` bf16 terms rounded to nearest, each held in f32: h =
    bf16(x), m = bf16(x - h), l = bf16(x - h - m).  Each difference is
    exact; three terms hold all 24 significant bits of an f32 value."""
    terms, r = [], x.float()
    for _ in range(n):
        t = r.to(torch.bfloat16).float()
        terms.append(t)
        r = r - t
    return terms


def split_scan_ref(
    slot_cluster: torch.Tensor,
    slot_tile: torch.Tensor,
    n_unique: Optional[torch.Tensor],
    queries: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    vectors: torch.Tensor,
    attrs: torch.Tensor,
    ids: torch.Tensor,
    norms: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    *,
    metric: str = "dot",
    k: int = 10,
    q_block: int = 64,
    max_order: int = 2,
    chunk: int = 16,
):
    """:func:`filtered_scan_tiled_ref` with the tensor-core body's
    arithmetic: f32 queries split into three bf16 terms (:func:`bf16_terms`),
    f32 vectors too, bf16 and int8 vectors taken whole (both exact in
    bf16); the products of a query term of order i (h 0, m 1, l 2) and a
    vector term of order j with ``i + j <= max_order`` (2: hh, hm, hl, mh,
    mm, lh for f32 x f32; 1: hh, hm, mh), each exact in f32, summed in
    f32.  Then the same row constants, mask and top-k.  What the CUDA body
    computes, up to the order of its sums; nothing on the search path
    calls it."""

    def dots(q, v):
        qt = bf16_terms(q, 3) if q.dtype == torch.float32 else [q.float()]
        vt = bf16_terms(v, 3) if v.dtype == torch.float32 else [v.float()]
        out = None
        for i, a in enumerate(qt):
            for j, b in enumerate(vt):
                if i + j <= max_order:
                    with ieee_f32():
                        p = torch.bmm(a, b.transpose(1, 2))
                    out = p if out is None else out + p
        return out

    return _tiled(dots, slot_cluster, slot_tile, n_unique, queries, lo, hi,
                  vectors, attrs, ids, norms, scales, metric, k, q_block,
                  chunk)


def _tiled(dots, slot_cluster, slot_tile, n_unique, queries, lo, hi, vectors,
           attrs, ids, norms, scales, metric, k, q_block, chunk, select=top_k):
    """The tiled scan's contract around ``dots(q [c, QB, D], v [c, Vpad,
    D]) -> [c, QB, Vpad]`` f32 and ``select(scores, k) -> (values,
    positions)``."""
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
        scores = dots(qt[st], vectors[sc])  # [c, QB, V]
        if scales is not None:
            scores = scores * scales[sc][:, None, :]
        if metric == "l2":
            scores = 2.0 * scores - norms[sc][:, None, :]
        # attrs [c, 1, V, M] against each tile row's bounds [c, QB, F, M]
        fmask = _dnf_mask(attrs[sc].int()[:, None], lot[st], hit[st])
        mask = fmask & (ids[sc] >= 0)[:, None, :]
        scores = torch.where(mask, scores, NEG_INF)
        vals, idx = select(scores, kk)  # earliest row wins ties
        row_ids = torch.gather(ids[sc][:, None, :].expand(scores.shape), -1,
                               idx.clamp(max=scores.shape[-1] - 1))
        out_v[sl, :, :kk] = vals
        out_i[sl, :, :kk] = torch.where(vals > NEG_INF / 2, row_ids, -1).int()
        out_n[sl] = mask.sum(-1).int()
    return out_v, out_i, out_n
