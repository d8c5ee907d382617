"""The comparison that decides ``correct``.

It holds the answers that the timed path returned for the checked batches
(every repeat of each in the window) against the reference's candidates
(``bench/reference.py``), query by query.  A served entry is *valid* when its
id is a row of one of the query's probed clusters, passes the query's
filter, and appears once in the list.  The numbers, each with a limit of its
own (``bench/limits/<cell>.json``):

- ``bad_ids``: entries that are not valid where the reference has a row at
  that rank, or not -1 where it has none (exact, limit 0);
- ``count_err``: queries whose ``n_passed`` differs from the reference's
  or whose ``n_scanned`` lies outside what pruning may leave (all rows of
  the probed clusters, less those of clusters with no passing row)
  (exact, limit 0);
- ``order_gap``: the most by which a served score rises along its list
  (exact, limit 0);
- ``score_err``: the widest gap between a served score and the reference's
  score of the same row;
- ``kth_gap``: the most by which a served row's reference score lies below
  the reference's k-th best.

Where a query's probe set is tied (``reference.TIE``), each right set is
tried and the one the answer fits best (fewest bad ids, then counts, then
gaps) is the one judged.
"""

from __future__ import annotations

import torch

from bench import reference

NAMES = ("bad_ids", "count_err", "order_gap", "score_err", "kth_gap")
COUNTS = ("bad_ids", "count_err")  # summed; the others are maxima


def _judge_batch(cands, alt_rows, alt_local, alt_mask, table, ids, scores,
                 n_scanned, n_passed, k):
    """Readings of ``R`` repeats of one batch's answers (``ids`` / ``scores``
    ``[R, Q, k]``, counters ``[R, Q]``) against each right probe set ``a``
    of its queries (``alt_rows [A]`` the query's row in ``cands``,
    ``alt_local [A]`` its row in the batch, ``alt_mask [A, W]`` the set),
    then each query's best set (``table [Q, m]``, alternatives or -1): a
    dict of ``[R, Q]`` tensors."""
    dev = ids.device
    ref_vals, _, ref_pass, scan_lo, scan_hi = reference.top_k(
        cands, alt_mask, k, rows=alt_rows)
    n_ref = (ref_vals > reference.NEG_INF).sum(1)  # [A]
    sid = ids[:, alt_local].long()  # [R, A, k]
    sval = scores[:, alt_local].float()
    starts = cands.starts
    inside = (sid >= 0) & (sid < cands.n_rows)
    topic = torch.searchsorted(starts, sid.clamp(min=0), right=True) - 1
    pos = sid.clamp(min=0) - starts[topic]
    cl = cands.probes.clusters[alt_rows]  # [A, W]
    hit = (cl[None, :, None, :] == topic[..., None]) & alt_mask[None, :, None]
    slot = hit.int().argmax(-1)  # [R, A, k]
    true = cands.scores[alt_rows[None, :, None], slot,
                        pos.clamp(max=cands.scores.shape[2] - 1)]
    srt = torch.sort(torch.where(inside, sid, -1), dim=-1).values
    dups = ((srt[..., 1:] == srt[..., :-1]) & (srt[..., 1:] >= 0)).sum(-1)
    valid = inside & hit.any(-1) & (true > reference.NEG_INF)
    due = torch.arange(k, device=dev)[None, None, :] < n_ref[None, :, None]
    bad = ((due & ~valid) | (~due & (sid != -1))).sum(-1) + dups
    inf = torch.tensor(float("inf"), device=dev)
    gaps = torch.where(valid, (sval - true).abs(), 0.0)
    score_err = torch.where(gaps.isnan(), inf, gaps).amax(-1)
    kth = torch.gather(ref_vals, 1, (n_ref - 1).clamp(min=0)[:, None])[:, 0]
    low = torch.where(valid, true, inf).amin(-1)
    kth_gap = torch.where(n_ref[None] > 0, (kth[None] - low).clamp(min=0),
                          0.0)
    both = due[..., 1:] & due[..., :-1]
    rise = torch.where(both, sval[..., 1:] - sval[..., :-1], 0.0)
    order_gap = rise.clamp(min=0).amax(-1) if k > 1 else torch.zeros_like(
        score_err)
    count_err = ((n_passed[:, alt_local] != ref_pass[None])
                 | (n_scanned[:, alt_local] < scan_lo[None])
                 | (n_scanned[:, alt_local] > scan_hi[None])).long()
    # each query's best probe set: fewest bad ids, then counts, then gaps
    key = (bad.double() * 4 + count_err.double() * 2
           + torch.tanh((kth_gap + score_err).double()))
    t = table.clamp(min=0)
    kt = torch.where(table[None] >= 0, key[:, t], float("inf"))  # [R, Q, m]
    best = torch.gather(t[None].expand_as(kt), 2,
                        kt.argmin(-1, keepdim=True))[..., 0]  # [R, Q]
    read = dict(bad_ids=bad, count_err=count_err, order_gap=order_gap,
                score_err=score_err, kth_gap=kth_gap)
    return {n: torch.gather(v, 1, best) for n, v in read.items()}


def correct(readings: dict, limits: dict) -> bool:
    """``correct``: some answers judged, and every number within its
    limit."""
    return readings["answers"] > 0 and all(readings[n] <= limits[n]
                                           for n in limits)


def judge(cands, answers, k: int) -> dict:
    """``answers``: ``[(rows, ids, scores, n_scanned, n_passed), ...]``, one
    entry a checked batch: ``rows [Q]`` its queries' rows in ``cands``,
    ``ids``/``scores [R, Q, k]`` and counters ``[R, Q]`` its R repeats, on
    the candidates' device.  Returns each number over all of them (counts
    summed, gaps maximal), and ``answers``: the (repeat, query) pairs
    judged."""
    alt_q, alt_mask, table = reference.alternatives(cands.probes)
    out = {n: 0.0 for n in NAMES}
    judged = 0
    for rows, ids, scores, n_scanned, n_passed in answers:
        sub = table[rows]  # [Q, m] this batch's alternatives
        used = sub[sub >= 0]  # query-major
        renum = torch.full_like(alt_q, -1)
        renum[used] = torch.arange(used.shape[0], device=used.device)
        alt_local = torch.repeat_interleave(
            torch.arange(sub.shape[0], device=sub.device), (sub >= 0).sum(1))
        r = _judge_batch(cands, alt_q[used], alt_local, alt_mask[used],
                         torch.where(sub >= 0, renum[sub.clamp(min=0)], -1),
                         ids, scores, n_scanned, n_passed, k)
        for n in NAMES:
            if n in COUNTS:
                out[n] += float(r[n].sum())
            else:
                out[n] = max(out[n], float(r[n].max()))
        judged += ids.shape[0] * ids.shape[1]
    out["answers"] = judged
    return out
