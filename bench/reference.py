"""The plain reference: exact filtered top-k over each query's probe set.

Straight PyTorch on whatever device it is given, and nothing of the
program: it works out again, from the generator and the seed, what the
program derived (probe sets from the centres in f32 with TF32 off; every
probed cluster's rows, regenerated alone; under SQ8 the int8 rows and
scales by the frozen rule), and scores every (query, row of its probes)
pair in f32.

Probe near-ties.  Two sound f32 evaluations of a 768-term dot product
differ by ~1e-7; where a query's ``n_probes``-th and next centre scores lie
within :data:`TIE` of each other, either probe set is right.  Such a query
keeps every centre in the band as a candidate cluster, and the comparison
(``bench/judge.py``) takes the choice of ``n_probes`` that the program's
answer fits best.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools

import torch

from bench import gen, sq8

TIE = 5e-6  # probe near-tie band, against ~1e-7 between sound f32 orders
EXTRA = 8  # centres scored past n_probes to find the band's end
MAX_ALTS = 64
NEG_INF = float("-inf")
# how rows and queries meet, by configuration store and role: the reference
# of a store, and the control one precision below it
MODES = {("bf16", "reference"): "bf16", ("bf16", "control"): "fp8",
         ("sq8", "reference"): "sq8", ("sq8", "control"): "int4"}


@contextlib.contextmanager
def ieee_f32():
    """f32 matmuls in full f32 (no TF32) inside the block."""
    cuda = torch.backends.cuda.matmul
    old = (cuda.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    cuda.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def centre_scores(cfg: dict, cen: torch.Tensor, queries: torch.Tensor
                  ) -> torch.Tensor:
    """[Q, K] f32 dot products, empty clusters at -inf."""
    with ieee_f32():
        s = queries.float() @ cen.T
    sizes = torch.diff(gen.topic_starts(cfg, cen.device))
    return torch.where(sizes[None, :] > 0, s, NEG_INF)


@dataclasses.dataclass
class ProbeSets:
    clusters: torch.Tensor  # [Q, W] int64 by descending score, -1 pad
    n_sure: torch.Tensor  # [Q]: the leading clusters every right set holds
    n_cand: torch.Tensor  # [Q]: clusters in the sure set and the tie band
    n_probes: int

    def default(self) -> torch.Tensor:
        """[Q, n_probes]: the probe set with ties broken by rank."""
        return self.clusters[:, :self.n_probes]


def probe_sets(cfg: dict, cen: torch.Tensor, queries: torch.Tensor,
               n_probes: int) -> ProbeSets:
    s = centre_scores(cfg, cen, queries)
    w = min(n_probes + EXTRA, s.shape[1])
    vals, idx = torch.topk(s, w, dim=1)  # descending
    t = vals[:, n_probes - 1:n_probes]
    n_sure = (vals > t + TIE).sum(1)
    n_cand = (vals >= t - TIE).sum(1)
    if w < s.shape[1] and bool((n_cand >= w).any()):
        raise RuntimeError("a probe tie band outruns the scored centres")
    width = int(n_cand.max())
    cl = torch.where(torch.arange(width, device=s.device)[None, :]
                     < n_cand[:, None], idx[:, :width], -1)
    return ProbeSets(cl, n_sure, n_cand, n_probes)


def row_scores(q: torch.Tensor, rows: torch.Tensor, mode: str
               ) -> torch.Tensor:
    """[nq, n] scores of f32 queries against bf16 rows, in ``mode``:
    ``bf16`` the rows as stored; ``sq8`` / ``int4`` the rows quantized to
    127 / 7 levels with a per-row scale; ``fp8`` rows and queries rounded
    to float8 e4m3.  Products accumulate in f32."""
    with ieee_f32():
        if mode == "bf16":
            return q @ rows.float().T
        if mode in ("sq8", "int4"):
            codes, scale = sq8.quantize(rows, 127 if mode == "sq8" else 7)
            return (q @ codes.T) * scale[None, :]
        if mode == "fp8":
            f8 = torch.float8_e4m3fn
            return q.to(f8).float() @ rows.to(f8).float().T
    raise ValueError(f"unknown mode {mode!r}")


def passes(attrs: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
           ) -> torch.Tensor:
    """[nq, n] bool: row passes query's filter (any term, every attribute
    in its interval).  ``attrs [n, M]``, ``lo``/``hi`` ``[nq, F, M]``."""
    a = attrs[None, None]
    ok = (a >= lo[:, :, None, :]) & (a <= hi[:, :, None, :])
    return ok.all(-1).any(1)


def _by_cluster(clusters: torch.Tensor):
    """Yields ``(cluster, query rows, slots)`` for every cluster named in
    ``clusters [Q, W]`` (-1 skipped), cluster by cluster."""
    q_idx, w_idx = torch.nonzero(clusters >= 0, as_tuple=True)
    c = clusters[q_idx, w_idx]
    order = torch.argsort(c, stable=True)
    c, q_idx, w_idx = c[order], q_idx[order], w_idx[order]
    uniq, counts = torch.unique_consecutive(c, return_counts=True)
    s = 0
    for cl, n in zip(uniq.tolist(), counts.tolist()):
        yield cl, q_idx[s:s + n], w_idx[s:s + n]
        s += n


@dataclasses.dataclass
class Candidates:
    """Every candidate row of every checked query: the rows of its sure
    clusters and of its tie band, scored."""
    probes: ProbeSets
    scores: torch.Tensor  # [Q, W, V] f32, -inf past a cluster's rows or
    # where the row fails the query's filter
    sizes: torch.Tensor  # [Q, W] live rows of each candidate cluster
    passing: torch.Tensor  # [Q, W] of them passing the filter
    starts: torch.Tensor  # [K + 1] first row of every topic
    n_rows: int


def candidates(cfg: dict, seed: int, cen: torch.Tensor, queries, lo, hi,
               n_probes: int, mode: str) -> Candidates:
    """Scores every row of every candidate cluster of ``queries [Q, D]``
    (filters ``lo``/``hi [Q, F, M]``) in ``mode`` (:func:`row_scores`)."""
    dev = cen.device
    ps = probe_sets(cfg, cen, queries, n_probes)
    starts = gen.topic_starts(cfg, dev)
    sizes_k = torch.diff(starts)
    v = int(sizes_k.max())
    q, w = ps.clusters.shape
    scores = torch.full((q, w, v), NEG_INF, device=dev)
    sizes = torch.where(ps.clusters >= 0, sizes_k[ps.clusters.clamp(min=0)], 0)
    passing = torch.zeros((q, w), dtype=torch.int64, device=dev)
    for c, qi, wi in _by_cluster(ps.clusters):
        rows = gen.topic_vectors(cfg, seed, c, cen[c])
        ok = passes(gen.topic_attrs(cfg, seed, c, dev), lo[qi], hi[qi])
        sc = row_scores(queries[qi].float(), rows, mode)
        scores[qi, wi, :rows.shape[0]] = torch.where(ok, sc, NEG_INF)
        passing[qi, wi] = ok.sum(1)
    return Candidates(ps, scores, sizes, passing, starts, cfg["n_rows"])


def alternatives(ps: ProbeSets):
    """Every right probe set of every query: ``(alt_query [A], alt_mask
    [A, W] bool, table [Q, m] alt index or -1)``.  A query without a tie
    has one; one with ``b`` centres in its band, ``n`` of them to keep, has
    ``C(b, n)``."""
    q, w = ps.clusters.shape
    n_sure, n_cand = ps.n_sure.tolist(), ps.n_cand.tolist()
    aq, masks, table = [], [], []
    for i in range(q):
        band = range(n_sure[i], n_cand[i])
        need = ps.n_probes - n_sure[i]
        picks = [tuple(range(n_sure[i], ps.n_probes))]
        if n_cand[i] > ps.n_probes:
            picks = list(itertools.combinations(band, need))
        if len(picks) > MAX_ALTS:
            raise RuntimeError(f"query {i}: {len(picks)} probe sets tie")
        row = []
        for pick in picks:
            m = [False] * w
            for j in (*range(n_sure[i]), *pick):
                m[j] = True
            row.append(len(aq))
            aq.append(i)
            masks.append(m)
        table.append(row)
    width = max(len(r) for r in table)
    dev = ps.clusters.device
    return (torch.tensor(aq, device=dev), torch.tensor(masks, device=dev),
            torch.tensor([r + [-1] * (width - len(r)) for r in table],
                         device=dev))


def top_k(cands: Candidates, mask: torch.Tensor, k: int, rows=None):
    """The exact top-k over the clusters ``mask [A, W]`` selects, of the
    queries ``rows [A]`` (default: all, one mask a query): ``(vals [A, k]
    descending, ids [A, k] int64, n_passed [A], scan_lo [A], scan_hi [A])``
    with (-inf, -1) past the candidates.  ``scan_hi`` counts the selected
    clusters' rows, ``scan_lo`` those of them that hold a passing row."""
    rows = torch.arange(mask.shape[0], device=mask.device) if rows is None \
        else rows
    sc = torch.where(mask[..., None], cands.scores[rows], NEG_INF)
    a, w, v = sc.shape
    flat = sc.reshape(a, w * v)
    kk = min(k, w * v)
    vals, pos = torch.topk(flat, kk, dim=1)
    cl = cands.probes.clusters[rows]
    slot, off = pos // v, pos % v
    ids = cands.starts[torch.gather(cl, 1, slot).clamp(min=0)] + off
    ids = torch.where(vals > NEG_INF, ids, -1)
    if kk < k:
        pad = k - kk
        vals = torch.cat([vals, vals.new_full((a, pad), NEG_INF)], 1)
        ids = torch.cat([ids, ids.new_full((a, pad), -1)], 1)
    sizes, passing = cands.sizes[rows] * mask, cands.passing[rows] * mask
    return (vals, ids, passing.sum(1), (sizes * (passing > 0)).sum(1),
            sizes.sum(1))


def answer(cands: Candidates, k: int):
    """The reference's (or, from control-mode candidates, the control's)
    answers with ties broken by rank: ``(scores [Q, k], ids [Q, k],
    n_scanned [Q], n_passed [Q])``."""
    ps = cands.probes
    mask = (torch.arange(ps.clusters.shape[1], device=ps.clusters.device)
            [None, :] < ps.n_probes)
    vals, ids, n_pass, _, scan_hi = top_k(
        cands, mask.expand(ps.clusters.shape), k)
    return vals, ids, scan_hi, n_pass


def probed_passing(cfg: dict, seed: int, probes: torch.Tensor, lo, hi
                   ) -> torch.Tensor:
    """[Q, T] bool: probed cluster ``probes [Q, T]`` holds a row passing
    its query's filter.  Where every filter is the whole range, that is
    every non-empty cluster, and no attribute is regenerated."""
    dev = probes.device
    sizes = torch.diff(gen.topic_starts(cfg, dev))[probes]
    if bool(((lo == gen.ATTR_MIN) & (hi == gen.ATTR_MAX)).all()):
        return sizes > 0
    out = torch.zeros(probes.shape, dtype=torch.bool, device=dev)
    for c, qi, ti in _by_cluster(probes):
        ok = passes(gen.topic_attrs(cfg, seed, c, dev), lo[qi], hi[qi])
        out[qi, ti] = ok.any(1)
    return out
