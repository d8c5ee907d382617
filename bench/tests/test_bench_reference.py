"""The reference against an exhaustive filtered top-k on tiny data."""

import pytest
import torch

from bench import gen, reference, sq8
from bench.tests import tiny


def exhaustive(cfg, seed, queries, lo, hi, k, store):
    """Every row scored, rows outside the query's probed topics or failing
    its filter dropped, the best k kept."""
    core, attrs, topic, cen = gen.dataset(cfg, seed, "cpu")
    if store == "sq8":
        codes, scale = sq8.quantize(core)
        scores = (queries @ codes.T) * scale[None]
    else:
        scores = queries @ core.float().T
    probes = torch.topk(queries @ cen.T, cfg["n_probes"], dim=1).indices
    probed = (topic[None, :, None] == probes[:, None, :]).any(-1)
    ok = probed & reference.passes(attrs, lo, hi)
    vals, ids = torch.topk(torch.where(ok, scores, float("-inf")), k, dim=1)
    ids = torch.where(vals > float("-inf"), ids, -1)
    sizes = torch.diff(gen.topic_starts(cfg, "cpu"))
    return vals, ids, sizes[probes].sum(1), ok.sum(1)


@pytest.mark.parametrize("store,k,window", [("bf16", 10, 0), ("bf16", 100, 0),
                                            ("sq8", 10, 0), ("sq8", 7, 0.05),
                                            ("bf16", 5, 0.05)])
def test_reference_is_the_exhaustive_top_k(store, k, window):
    _check_exhaustive(store, k, tiny.traffic(k=k, window=window))


@pytest.mark.parametrize("store,k", [("bf16", 100), ("sq8", 10)])
def test_reference_is_the_exhaustive_top_k_under_filter_terms(store, k):
    _check_exhaustive(store, k, tiny.traffic(k=k, terms=True))


def _check_exhaustive(store, k, tr):
    cfg = tiny.config(store)
    filtered = tr["time_window"] or tr.get("filter_terms", 0)
    cen = gen.centres(cfg, tiny.SEED, "cpu")
    q, lo, hi = (x[0] for x in gen.query_pool(cfg, tr, tiny.SEED, cen))
    cands = reference.candidates(cfg, tiny.SEED, cen, q, lo, hi,
                                 cfg["n_probes"], store)
    vals, ids, n_scanned, n_passed = reference.answer(cands, k)
    want = exhaustive(cfg, tiny.SEED, q, lo, hi, k, store)
    torch.testing.assert_close(vals, want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(ids, want[1])
    assert torch.equal(n_scanned, want[2]) and torch.equal(n_passed, want[3])
    if filtered:
        assert int(n_passed.sum()) < int(n_scanned.sum())


def test_a_tied_probe_set_offers_every_choice():
    ps = reference.ProbeSets(
        clusters=torch.tensor([[4, 1, 2, 3], [7, 8, -1, -1]]),
        n_sure=torch.tensor([1, 2]), n_cand=torch.tensor([4, 2]), n_probes=2)
    alt_q, mask, table = reference.alternatives(ps)
    assert alt_q.tolist() == [0, 0, 0, 1]
    assert mask.tolist() == [[True, True, False, False],
                             [True, False, True, False],
                             [True, False, False, True],
                             [True, True, False, False]]
    assert table.tolist() == [[0, 1, 2], [3, -1, -1]]


def test_the_band_holds_near_ties_only():
    cfg = tiny.config()
    cen = gen.centres(cfg, tiny.SEED, "cpu")
    q = gen.query_pool(cfg, tiny.traffic(), tiny.SEED, cen)[0][0]
    s = q @ cen.T
    ps = reference.probe_sets(cfg, cen, q, cfg["n_probes"])
    assert torch.equal(ps.default(), torch.topk(s, cfg["n_probes"]).indices)
    # a copy of a probed centre, nudged by less than the band, ties
    i = int(ps.default()[0, -1])
    cen2 = torch.cat([cen, cen[i:i + 1] + 1e-7])
    cfg2 = dict(cfg, n_clusters=cfg["n_clusters"] + 1)
    ps2 = reference.probe_sets(cfg2, cen2, q[:1], cfg["n_probes"])
    assert int(ps2.n_cand[0]) > cfg["n_probes"]
