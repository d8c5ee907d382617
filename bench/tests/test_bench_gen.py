"""The generator: determinism, per-cluster regeneration, the traffic laws."""

import torch

from bench import gen
from bench.tests import tiny


def test_same_seed_same_data_other_seed_other_data():
    cfg = tiny.config()
    a = gen.dataset(cfg, tiny.SEED, "cpu")
    b = gen.dataset(cfg, tiny.SEED, "cpu")
    c = gen.dataset(cfg, tiny.SEED + 1, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])


def test_a_cluster_regenerates_alone():
    cfg = tiny.config()
    core, attrs, topic, cen = gen.dataset(cfg, tiny.SEED, "cpu")
    starts = gen.topic_starts(cfg, "cpu")
    assert int(starts[-1]) == cfg["n_rows"]
    for t in (0, 5, cfg["n_clusters"] - 1):
        r0, r1 = int(starts[t]), int(starts[t + 1])
        assert bool((topic[r0:r1] == t).all())
        assert torch.equal(gen.topic_vectors(cfg, tiny.SEED, t, cen[t]),
                           core[r0:r1])
        assert torch.equal(gen.topic_attrs(cfg, tiny.SEED, t, "cpu"),
                           attrs[r0:r1])


def test_topics_are_equal_sized_and_banded():
    cfg = tiny.config()
    cfg.update(n_rows=6007)
    sizes = torch.diff(gen.topic_starts(cfg, "cpu"))
    assert int(sizes.sum()) == 6007 and int(sizes.max() - sizes.min()) <= 1
    _, attrs, topic, _ = gen.dataset(cfg, 3, "cpu")
    band = cfg["assumed"]["ts_range"] // cfg["n_clusters"]
    ts = attrs[:, 0].long()
    assert bool((ts // band == topic).all())
    assert int(attrs[:, 1:].min()) >= 0
    assert int(attrs[:, 1:].max()) < cfg["assumed"]["attr_values"]


def test_query_pool_laws():
    cfg = tiny.config()
    cen = gen.centres(cfg, tiny.SEED, "cpu")
    q, lo, hi = gen.query_pool(cfg, tiny.traffic(hot=2), tiny.SEED, cen)
    assert q.shape == (4, 32, 64) and lo.shape == (4, 32, 1, 10)
    assert torch.equal(q, q.bfloat16().float())
    assert torch.allclose(q.norm(dim=-1), torch.ones(4, 32), atol=1e-2)
    # two hot topics a batch: each query's best centre is one of two
    best = (q @ cen.T).argmax(-1)
    assert all(len(set(b.tolist())) <= 2 for b in best)
    assert bool((lo == gen.ATTR_MIN).all() and (hi == gen.ATTR_MAX).all())
    _, lo, hi = gen.query_pool(cfg, tiny.traffic(window=0.05), tiny.SEED, cen)
    assert bool((hi[..., 0, 0].long() - lo[..., 0, 0].long() == 499).all())
    again = gen.query_pool(cfg, tiny.traffic(window=0.05), tiny.SEED, cen)
    assert torch.equal(again[1], lo)


def test_filter_terms_hold_attributes_past_the_timestamp():
    cfg = tiny.config()
    cen = gen.centres(cfg, tiny.SEED, "cpu")
    tr = tiny.traffic(terms=True)
    _, lo, hi = gen.query_pool(cfg, tr, tiny.SEED, cen)
    f, n_a, w = tr["filter_terms"], tr["filter_attrs"], tr["filter_values"]
    assert lo.shape == (4, 32, f, 10) and hi.shape == lo.shape
    held = (lo != gen.ATTR_MIN) | (hi != gen.ATTR_MAX)
    assert not bool(held[..., 0].any())  # the timestamp is never held
    assert bool((held.sum(-1) == n_a).all())
    span = hi.long() - lo.long()
    assert bool((span[held] == w - 1).all())
    assert int(lo[held].min()) >= 0
    assert int(hi[held].max()) < cfg["assumed"]["attr_values"]
    again = gen.query_pool(cfg, tr, tiny.SEED, cen)
    assert torch.equal(again[1], lo) and torch.equal(again[2], hi)
    other = gen.query_pool(cfg, tr, tiny.SEED + 1, cen)
    assert not torch.equal(other[1], lo)


def test_seeds_past_32_bits():
    assert gen.sub_seed(2**33 + 5, 1, 2) != gen.sub_seed(5, 1, 2)
    assert 0 <= gen.sub_seed(2**64 - 1, 4) < 2**63
