"""Plain PyTorch version of the tiled filtered scan (the kernel's contract).

The CPU path of :func:`repro_torch.kernels.filtered_scan.filtered_scan.
filtered_scan_tiled`, and what the CUDA kernel is held against on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.topk import NEG_INF, top_k


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
    int32); pad slots hold (NEG_INF, -1, 0).

    Works ``chunk`` live slots at a time, so it never holds more than one
    chunk's ``[chunk, Vpad, D]`` gather.
    """
    s = slot_cluster.shape[0]
    d = queries.shape[-1]
    dev = queries.device
    qt = queries.reshape(-1, q_block, d)
    lot = lo.reshape(-1, q_block, *lo.shape[1:]).int()
    hit = hi.reshape(-1, q_block, *hi.shape[1:]).int()
    out_v = torch.full((s, q_block, k), NEG_INF, dtype=torch.float32, device=dev)
    out_i = torch.full((s, q_block, k), -1, dtype=torch.int32, device=dev)
    out_n = torch.zeros((s, q_block), dtype=torch.int32, device=dev)
    live = torch.nonzero(live_slots(slot_tile, n_unique)).reshape(-1)
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
        a = attrs[sc].int()[:, None]  # [c, 1, V, M]
        qlo = lot[st][:, :, None]  # [c, QB, 1, F, M]
        qhi = hit[st][:, :, None]
        fmask = None
        for f in range(qlo.shape[-2]):
            term = torch.ones(scores.shape, dtype=torch.bool, device=dev)
            for m in range(qlo.shape[-1]):
                am = a[..., m]
                term &= (am >= qlo[..., f, m]) & (am <= qhi[..., f, m])
            fmask = term if fmask is None else fmask | term
        mask = fmask & (ids[sc] >= 0)[:, None, :]
        scores = torch.where(mask, scores, NEG_INF)
        vals, idx = top_k(scores, k)  # earliest row wins ties
        row_ids = torch.gather(ids[sc][:, None, :].expand(scores.shape), -1, idx)
        out_v[sl] = vals
        out_i[sl] = torch.where(vals > NEG_INF / 2, row_ids, -1).int()
        out_n[sl] = mask.sum(-1).int()
    return out_v, out_i, out_n
