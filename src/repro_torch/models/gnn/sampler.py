"""Layered fanout neighbor sampler (GraphSAGE-style) for ``minibatch_lg``:
the port of ``repro.models.gnn.sampler``, byte for byte the reference's
outputs (numpy only).

Host-side numpy: samples a K-hop neighborhood with per-hop fanouts from a CSR
adjacency, remaps to compact local ids, pads to static shapes, and emits the
triplet lists DimeNet's directional aggregation needs.  The train step
only ever sees fixed-shape GraphBatch arrays — the sampler is the ragged→
static boundary of the system.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E]
    node_feat: np.ndarray  # [N, d]
    positions: np.ndarray  # [N, 3]
    labels: np.ndarray  # [N]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1


def random_graph(rng: np.random.Generator, n_nodes: int, avg_degree: int,
                 d_feat: int, n_classes: int = 8) -> CSRGraph:
    """Synthetic power-law-ish graph for tests/benchmarks."""
    deg = np.minimum(
        rng.zipf(1.7, n_nodes) + avg_degree // 2, avg_degree * 8
    )
    deg = np.minimum(deg, n_nodes - 1)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n_nodes, indptr[-1]).astype(np.int32)
    return CSRGraph(
        indptr=indptr,
        indices=indices,
        node_feat=rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
        positions=rng.standard_normal((n_nodes, 3)).astype(np.float32),
        labels=rng.integers(0, n_classes, n_nodes).astype(np.int32),
    )


def sample_subgraph(
    rng: np.random.Generator,
    g: CSRGraph,
    seed_nodes: np.ndarray,
    fanouts: Sequence[int],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (nodes [M], edge_src, edge_dst) in LOCAL ids; nodes[0:len(seed)]
    are the seeds.  Edges point hop-(h+1) → hop-h (message flow to seeds)."""
    local = {int(v): i for i, v in enumerate(seed_nodes)}
    nodes = list(int(v) for v in seed_nodes)
    frontier = list(int(v) for v in seed_nodes)
    esrc, edst = [], []
    for f in fanouts:
        nxt = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            if hi <= lo:
                continue
            nbrs = g.indices[lo:hi]
            take = min(f, len(nbrs))
            chosen = rng.choice(nbrs, take, replace=False)
            for u in chosen:
                u = int(u)
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                esrc.append(local[u])
                edst.append(local[v])
        frontier = nxt
    return (
        np.asarray(nodes, np.int32),
        np.asarray(esrc, np.int32),
        np.asarray(edst, np.int32),
    )


def build_triplets(
    edge_src: np.ndarray, edge_dst: np.ndarray, n_nodes: int,
    max_per_edge: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """(trip_in, trip_out): for each edge e=(j→i), up to ``max_per_edge``
    incoming edges (k→j), k≠i."""
    in_edges = [[] for _ in range(n_nodes)]
    for eid, dst in enumerate(edge_dst):
        in_edges[int(dst)].append(eid)
    t_in, t_out = [], []
    for eid in range(len(edge_src)):
        j, i = int(edge_src[eid]), int(edge_dst[eid])
        cnt = 0
        for kj in in_edges[j]:
            if int(edge_src[kj]) == i:
                continue  # exclude the back-edge k == i
            t_in.append(kj)
            t_out.append(eid)
            cnt += 1
            if cnt >= max_per_edge:
                break
    return np.asarray(t_in, np.int32), np.asarray(t_out, np.int32)


def pad_to(x: np.ndarray, n: int, fill=0) -> np.ndarray:
    if len(x) >= n:
        return x[:n]
    pad = np.full((n - len(x),) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad], 0)


def make_graph_batch_arrays(
    g: CSRGraph,
    nodes: np.ndarray,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    *,
    n_pad: int,
    e_pad: int,
    t_pad: int,
    max_trip_per_edge: int = 16,
):
    """Pads a sampled subgraph into the static GraphBatch arrays (numpy)."""
    t_in, t_out = build_triplets(
        edge_src, edge_dst, len(nodes), max_trip_per_edge
    )
    ne, nt = len(edge_src), len(t_in)
    return dict(
        node_feat=pad_to(g.node_feat[nodes], n_pad),
        positions=pad_to(g.positions[nodes], n_pad),
        edge_src=pad_to(edge_src, e_pad),
        edge_dst=pad_to(edge_dst, e_pad),
        edge_mask=pad_to(np.ones(ne, bool), e_pad, False),
        trip_in=pad_to(t_in, t_pad),
        trip_out=pad_to(t_out, t_pad),
        trip_mask=pad_to(np.ones(nt, bool), t_pad, False),
        labels=pad_to(g.labels[nodes], n_pad, -1),
        graph_id=np.zeros(n_pad, np.int32),
    )
