"""The port's DimeNet (``models/gnn/``) and its config against the
reference on the same numpy inputs: the sampler's outputs byte for byte;
the bases, ``forward`` (node and graph readout) and ``loss_fn`` within
rtol 1e-5, atol 1e-6 from carried parameters; gradients against
``jax.grad`` within rtol 1e-4, atol 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet as jdimenet_cfg
from repro.models.gnn import dimenet as jdn
from repro.models.gnn import sampler as jsampler
from repro_torch.configs import dimenet as tdimenet_cfg
from repro_torch.models.gnn import dimenet as tdn
from repro_torch.models.gnn import sampler as tsampler
from repro_torch.train.checkpoint import params_from_numpy
from repro_torch.train.tree import leaves, leaves_with_paths, unflatten_like

VALUES = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)
BATCH_FIELDS = ("node_feat", "positions", "edge_src", "edge_dst",
                "edge_mask", "trip_in", "trip_out", "trip_mask", "graph_id")


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _same(got[k], want[k])
    elif isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def _sample(mod, seed=0, n_nodes=300, degree=6, d_feat=16, pads=(256, 512,
                                                                   2048)):
    rng = np.random.default_rng(seed)
    g = mod.random_graph(rng, n_nodes, degree, d_feat, 4)
    seeds = rng.choice(g.n_nodes, 16, replace=False).astype(np.int32)
    nodes, es, ed = mod.sample_subgraph(rng, g, seeds, [5, 3])
    t_in, t_out = mod.build_triplets(es, ed, len(nodes), 4)
    arrays = mod.make_graph_batch_arrays(g, nodes, es, ed, n_pad=pads[0],
                                         e_pad=pads[1], t_pad=pads[2])
    return g, (nodes, es, ed), (t_in, t_out), arrays


def test_sampler_is_byte_for_byte_the_references():
    for seed in (0, 1):
        jg, jsub, jtrip, jarr = _sample(jsampler, seed)
        tg, tsub, ttrip, tarr = _sample(tsampler, seed)
        _same(dataclasses.astuple(tg), dataclasses.astuple(jg))
        assert tg.n_nodes == jg.n_nodes
        _same(tsub, jsub)
        _same(ttrip, jtrip)
        _same(tarr, jarr)
    # pads that cut (pad_to truncates) and that fill
    x = np.arange(10, dtype=np.int32)
    for n, fill in ((4, 0), (13, -1)):
        _same(tsampler.pad_to(x, n, fill), jsampler.pad_to(x, n, fill))


def test_config_fields_and_n_params_match():
    for make in ("config", "smoke_config"):
        jc, tc = getattr(jdimenet_cfg, make)(), getattr(tdimenet_cfg, make)()
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert jd.pop("dtype") == jnp.float32
        assert td.pop("dtype") == torch.float32
        assert td == jd
        assert tc.n_params() == jc.n_params()
    full = tdimenet_cfg.config(d_feat=602, d_out=47, readout="graph")
    assert (full.d_feat, full.d_out, full.readout) == (602, 47, "graph")
    assert (tdimenet_cfg.ARCH_ID, tdimenet_cfg.FAMILY) == (
        jdimenet_cfg.ARCH_ID, jdimenet_cfg.FAMILY)


def test_bases_match_reference():
    rng = np.random.default_rng(2)
    d = np.concatenate([rng.uniform(0, 6, 50), [0.0, 5.0, 1e-7]]
                       ).astype(np.float32)
    cos = np.clip(rng.uniform(-1.1, 1.1, 53), -1, 1).astype(np.float32)
    td_, tcos = torch.from_numpy(d), torch.from_numpy(cos)
    np.testing.assert_allclose(tdn.envelope(td_, 5.0, 6).numpy(),
                               np.asarray(jdn.envelope(d, 5.0, 6)), **VALUES)
    np.testing.assert_allclose(tdn.radial_basis(td_, 6, 5.0, 6).numpy(),
                               np.asarray(jdn.radial_basis(d, 6, 5.0, 6)),
                               **VALUES)
    np.testing.assert_allclose(tdn._legendre(tcos, 7).numpy(),
                               np.asarray(jdn._legendre(cos, 7)), **VALUES)
    got = tdn.spherical_basis(td_, tcos, 7, 6, 5.0, 6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdn.spherical_basis(d, cos, 7, 6, 5.0, 6)),
        **VALUES)
    assert tuple(got.shape) == (53, 42)


@functools.lru_cache(maxsize=None)
def _ref_params(readout):
    cfg = dataclasses.replace(jdimenet_cfg.smoke_config(), readout=readout)
    return jax.tree.map(np.asarray, jdn.init_params(jax.random.key(0), cfg))


def _pair(readout, n_graphs=3):
    jcfg = dataclasses.replace(jdimenet_cfg.smoke_config(), readout=readout)
    tcfg = dataclasses.replace(tdimenet_cfg.smoke_config(), readout=readout)
    _, _, _, arrays = _sample(jsampler, 5)
    arrays["graph_id"] = (np.arange(len(arrays["graph_id"])) % n_graphs
                          ).astype(np.int32)
    jb = jdn.GraphBatch(**{k: jnp.asarray(arrays[k]) for k in BATCH_FIELDS},
                        n_graphs=n_graphs)
    tb = tdn.GraphBatch(**{k: torch.from_numpy(arrays[k])
                           for k in BATCH_FIELDS}, n_graphs=n_graphs)
    if readout == "node":
        labels = arrays["labels"]
    else:
        labels = np.random.default_rng(6).standard_normal(n_graphs).astype(
            np.float32)
    host = _ref_params(readout)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, host),
            params_from_numpy(host, "cpu"), jb, tb, labels)


@pytest.mark.parametrize("readout", ["node", "graph"])
def test_forward_and_loss_match_reference(readout):
    jcfg, tcfg, jp, tp, jb, tb, labels = _pair(readout)
    want = jax.jit(lambda p: jdn.forward(p, jcfg, jb))(jp)
    got = tdn.forward(tp, tcfg, tb)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUES)
    mask = None
    if readout == "node":
        mask = (np.arange(len(labels)) % 3 != 0)
    jl, jm = jdn.loss_fn(jp, jcfg, jb, jnp.asarray(labels),
                         None if mask is None else jnp.asarray(mask))
    tl, tm = tdn.loss_fn(tp, tcfg, tb, torch.from_numpy(labels),
                         None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(tl), float(jl), **VALUES)
    assert sorted(tm) == sorted(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **VALUES)


@pytest.mark.parametrize("readout", ["node", "graph"])
@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax_grad(readout, remat):
    """``remat=True`` recomputes each block in the backward: the same
    gradients."""
    jcfg, tcfg, jp, tp, jb, tb, labels = _pair(readout)
    jgrads = jax.jit(jax.grad(lambda p: jdn.loss_fn(
        p, jcfg, jb, jnp.asarray(labels))[0]))(jp)
    flat = [x.clone().requires_grad_(True) for x in leaves(tp)]
    loss, _ = tdn.loss_fn(unflatten_like(tp, flat), tcfg, tb,
                          torch.from_numpy(labels), remat=remat)
    grads = torch.autograd.grad(loss, flat)
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    for (path, _), g in zip(leaves_with_paths(tp), grads):
        np.testing.assert_allclose(g.numpy(), want[path], **GRADS,
                                   err_msg="/".join(path))


def test_init_params_tree_matches_reference():
    want = dict(leaves_with_paths(_ref_params("node")))
    got = dict(leaves_with_paths(tdn.init_params(
        torch.Generator("cpu").manual_seed(0), tdimenet_cfg.smoke_config(),
        device="cpu")))
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        assert tuple(x.shape) == want[path].shape, path
        assert x.dtype == torch.float32
        # glorot_normal (and w_bil's normal(0.02)) at the reference's scale
        ratio = float(x.std()) / float(np.std(want[path]))
        assert 0.7 < ratio < 1.4, path


def test_init_params_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdn.init_params(torch.Generator("cpu"), tdimenet_cfg.smoke_config())
