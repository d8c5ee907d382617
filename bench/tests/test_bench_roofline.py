"""The roofline's arithmetic, by hand from shapes."""

import torch

from bench import roofline
from bench.tests import tiny


def test_least_time_counts_distinct_passing_clusters_once():
    cfg = dict(tiny.config(), dim=768, n_attrs=10)
    sizes = torch.tensor([100, 200, 300, 0])
    probes = torch.tensor([[0, 1], [1, 2], [1, 3]])
    passing = torch.tensor([[True, True], [True, False], [True, False]])
    got = roofline.least_seconds(cfg, 10, probes, sizes, passing)
    row = 768 * 2 + 10 * 2
    small = 3 * 768 * 2 + 2 * 3 * 10 * 2 + 3 * 10 * 8
    assert got["bytes"] == (100 + 200) * row + small  # cluster 2 reaches none
    assert got["ops"] == 2 * 768 * (300 + 500 + 200)
    assert got["seconds"] == got["bytes"] / 3.35e12
    assert got["bound_by"] == "bytes"


def test_sq8_rows_and_f32_queries():
    cfg = dict(tiny.config("sq8"), dim=768, n_attrs=10)
    assert roofline.row_bytes(cfg) == 768 + 4 + 20
    sizes = torch.tensor([1000])
    got = roofline.least_seconds(cfg, 100, torch.tensor([[0]]), sizes,
                                 torch.tensor([[True]]))
    assert got["bytes"] == 1000 * 792 + 768 * 4 + 40 + 800


def test_operations_bound_many_queries_on_one_cluster():
    cfg = dict(tiny.config(), dim=4096, n_attrs=0)
    sizes = torch.tensor([10000])
    probes = torch.zeros((1000, 1), dtype=torch.long)
    got = roofline.least_seconds(cfg, 1, probes, sizes,
                                 torch.ones_like(probes, dtype=torch.bool))
    assert got["bound_by"] == "operations"
    assert got["seconds"] == 2 * 4096 * 10000 * 1000 / 989e12
