"""The port's cell registry (``repro_torch.launch.specs``) against the
reference's (``repro.launch.specs``): the same rows, and for every runnable
cell on both production meshes the same abstract arguments leaf for leaf
(global shape, dtype, the rank's shard shape), so the same per-rank
argument bytes, and the same ``meta`` numbers.

The reference builds its cells with ``eval_shape`` only (no compile) over
512 fake XLA host devices in a subprocess (this file run as a script with
``--reference OUT``); the port builds its own from the mesh's axis names
and sizes (``MeshSpec``), which needs no process group.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT_S = 600
META_KEYS = ("model_flops", "tokens", "p_cap", "k_local")
GIB = 1 << 30

# the reference's per-rank argument GiB (sum of shard_shape bytes) of eight
# cells, pod256 and multipod512
ARG_GIB = {
    ("paper-ivf", "search_1b"): (6.952, 3.524),
    ("paper-ivf", "search_1b_sq8"): (3.595, 1.846),
    ("deepseek-v3-671b", "train_4k"): (5.061, 5.061),
    ("gemma3-12b", "decode_32k"): (2.527, 1.949),
    ("gemma3-27b", "long_500k"): (3.304, 3.226),
    ("dimenet", "ogb_products"): (0.991, 0.982),
    ("wide-deep", "train_batch"): (0.085, 0.054),
    ("sasrec", "retrieval_cand"): (0.002, 0.001),
}


def _reference(out: str) -> None:
    import jax
    import numpy as np

    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import build_cell, list_cells

    rows = list_cells()
    res = {"rows": [[a, s, skip] for a, s, skip in rows], "cells": {}}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for a, s, skip in rows:
            if skip:
                continue
            cell = build_cell(a, s, mesh, "exec")
            leaves, multi = [], []
            for i, leaf in enumerate(jax.tree.leaves(cell.args)):
                shape = tuple(leaf.shape)
                local = (shape if leaf.sharding is None
                         else tuple(leaf.sharding.shard_shape(shape)))
                leaves.append([list(shape), str(leaf.dtype), list(local)])
                dims = [d for d, e in enumerate(
                    getattr(leaf.sharding, "spec", None) or ())
                    if isinstance(e, tuple) and len(e) > 1]
                if dims:  # split by several axes: each rank's chunk
                    idx = leaf.sharding.devices_indices_map(shape)
                    multi.append([i, dims, [
                        [idx[mesh.devices[c]][d].start or 0 for d in dims]
                        for c in np.ndindex(mesh.devices.shape)]])
            res["cells"][f"{a}|{s}|{int(mp)}"] = dict(
                leaves=leaves, multi=multi,
                meta={k: cell.meta.get(k) for k in META_KEYS})
    with open(out, "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "reference.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__)), "--reference", str(out)],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=env)
    if proc.returncode:
        raise AssertionError(f"the reference's cells failed\nSTDOUT:\n"
                             f"{proc.stdout}\nSTDERR:\n{proc.stderr}")
    with open(out) as f:
        return json.load(f)


def _port_cells():
    from repro_torch.launch import specs

    out = {}
    for mp in (False, True):
        mesh = specs.production_mesh_spec(mp)
        for a, s, skip in specs.list_cells():
            if not skip:
                out[(a, s, mp)] = specs.build_cell(a, s, mesh, "exec")
    return out


@pytest.fixture(scope="module")
def port():
    return _port_cells()


def test_list_cells_equal_row_for_row(reference):
    from repro_torch.launch.specs import list_cells

    assert [list(r) for r in list_cells()] == reference["rows"]
    assert len(reference["rows"]) == 46
    assert sum(1 for r in reference["rows"] if r[2]) == 3


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod256", "multipod512"])
def test_argument_leaves_equal(reference, port, multi_pod):
    from repro_torch.launch.specs import arg_leaves

    n = 0
    for (a, s, mp), cell in port.items():
        if mp != multi_pod:
            continue
        want = reference["cells"][f"{a}|{s}|{int(mp)}"]["leaves"]
        got = [[list(x.shape), _dtype(x.dtype), list(x.local_shape())]
               for x in arg_leaves(cell.args)]
        assert got == want, (a, s, mp)
        n += 1
    assert n == 43


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod256", "multipod512"])
def test_argument_bytes_equal(reference, port, multi_pod):
    import math

    from repro_torch.launch.specs import argument_bytes

    itemsize = {"bfloat16": 2, "float32": 4, "int32": 4, "int16": 2,
                "int8": 1, "bool": 1}
    for (a, s, mp), cell in port.items():
        if mp != multi_pod:
            continue
        want = sum(math.prod(local) * itemsize[dt]
                   for _, dt, local in reference["cells"][
                       f"{a}|{s}|{int(mp)}"]["leaves"])
        got = argument_bytes(cell.args)
        assert got == want, (a, s, mp)
        if (a, s) in ARG_GIB:
            assert round(got / GIB, 3) == ARG_GIB[(a, s)][int(mp)]


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod256", "multipod512"])
def test_meta_equal(reference, port, multi_pod):
    for (a, s, mp), cell in port.items():
        if mp != multi_pod:
            continue
        want = reference["cells"][f"{a}|{s}|{int(mp)}"]["meta"]
        got = {k: cell.meta.get(k) for k in META_KEYS}
        for k in META_KEYS:
            if want[k] is None:
                assert got[k] is None, (a, s, k)
            else:
                assert got[k] == pytest.approx(want[k], rel=1e-12), (a, s, k)


class _MeshAt:
    """A mesh coordinate as ``models.moe.ep_rank`` reads a ``DeviceMesh``."""

    def __init__(self, names, shape, coord):
        self.mesh_dim_names, self.shape, self.coord = names, shape, coord

    def get_local_rank(self, name):
        return self.coord[self.mesh_dim_names.index(name)]


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod256", "multipod512"])
def test_multi_axis_shards_equal(reference, port, multi_pod):
    """Every argument that several mesh axes split along one dimension:
    the chunk each rank holds (its start along that dimension at every
    mesh coordinate, row-major) is the reference's ``NamedSharding``
    shard.  The 256-expert decode cells split their experts over
    ``("model", "data")``, ``model`` major: there the placements are
    ``OrderedShard`` and ``moe.ep_rank``'s expert range is the same."""
    import itertools

    from repro_torch.launch.specs import arg_leaves, mesh_spec, production_mesh_spec
    from repro_torch.models.moe import ep_rank
    from repro_torch.train.optimizer import OrderedShard, shard_index

    m = mesh_spec(production_mesh_spec(multi_pod))
    coords = list(itertools.product(*(range(n) for n in m.shape)))
    n_leaves = n_experts = 0
    for (a, s, mp), cell in port.items():
        if mp != multi_pod:
            continue
        leaves = arg_leaves(cell.args)
        for i, dims, want in reference["cells"][f"{a}|{s}|{int(mp)}"][
                "multi"]:
            x = leaves[i]
            got = []
            for c in coords:
                row = []
                for d in dims:
                    idx, n = shard_index(x.placements, x.mesh_shape, c, d)
                    row.append(idx * -(-x.shape[d] // n))
                got.append(row)
            assert got == want, (a, s, mp, i)
            n_leaves += 1
            ordered = [p for p in x.placements if isinstance(p, OrderedShard)]
            if ordered:  # the routed experts [L, E, ...] over ("model", "data")
                assert dims == [1] and {p.dim for p in ordered} == {1}
                e_local = x.local_shape()[1]
                for c, w in zip(coords, want):
                    mesh = _MeshAt(m.mesh_dim_names, m.shape, c)
                    assert ep_rank(mesh, ("model", "data")) * e_local == w[0]
                n_experts += 1
    assert n_leaves > 0 and n_experts > 0


@pytest.mark.parametrize("entry", [("model", "data"), ("data", "model")],
                         ids=["model-major", "mesh-order"])
def test_gather_lands_chunks_in_reference_order(monkeypatch, entry):
    """``layouts._gather`` of a dimension that ``("model", "data")``
    (``OrderedShard``s) or ``("data", "model")`` (plain ``Shard``s) splits
    on a ``("data", "model")`` mesh, six ranks gathering in step: each
    starts from the chunk ``shard_index`` gives it and ends with the whole
    dimension in order.  ``OrderedShard`` compares unequal to ``Shard``
    both ways."""
    import itertools
    import threading

    import torch
    from torch.distributed.tensor import Shard

    from repro_torch.launch import layouts
    from repro_torch.launch.specs import ArgSpec
    from repro_torch.train.optimizer import (OrderedShard, shard_index,
                                             to_placements)

    names, shape = ("data", "model"), (2, 3)
    coords = list(itertools.product(*(range(n) for n in shape)))
    pl = to_placements((None, entry), names)
    assert all(isinstance(p, OrderedShard) == (entry[0] == "model")
               for p in pl)
    assert Shard(1) != OrderedShard(1, 0) and OrderedShard(1, 0) != Shard(1)
    assert OrderedShard(1, 0) == OrderedShard(1, 0) != OrderedShard(1, 1)
    spec = ArgSpec((4, 12), torch.float32, pl, shape)
    full = torch.arange(48.0).view(4, 12)
    barrier, box, out = threading.Barrier(len(coords)), {}, {}

    class Mesh:  # one rank's view: a group is (axis, this rank's coord)
        mesh_dim_names = names

        def __init__(self, c):
            self.c = c

        def get_group(self, name):
            return name, self.c

    def all_gather_dim(x, group, dim):
        name, c = group
        ax = names.index(name)
        box[c] = x
        barrier.wait()
        got = torch.cat([box[c[:ax] + (j,) + c[ax + 1:]]
                         for j in range(shape[ax])], dim)
        barrier.wait()
        return got

    def rank(c):
        idx, n = shard_index(pl, shape, c, 1)
        w = full.shape[1] // n
        out[c] = layouts._gather(full[:, idx * w:(idx + 1) * w], spec,
                                 Mesh(c), ())

    monkeypatch.setattr(layouts, "all_gather_dim", all_gather_dim)
    threads = [threading.Thread(target=rank, args=(c,)) for c in coords]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert sorted(out) == coords
    for c in coords:
        assert torch.equal(out[c], full), c


def test_local_shape_rounds_up_like_shard_shape():
    """A dimension that does not divide: every mesh axis splitting it
    divides the rest, rounding up (rank 0's shard, the largest)."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.specs import ArgSpec

    a = ArgSpec((10, 7), torch.float32, (Shard(0), Replicate()), (4, 2))
    assert a.local_shape() == (3, 7)
    b = ArgSpec((64, 8), torch.bfloat16, (Shard(0), Shard(1)), (2, 4))
    assert b.local_shape() == (32, 2)
    assert b.local_nbytes() == 32 * 2 * 2


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference(sys.argv[2])
