"""The recsys models, the embedding substrate and the recsys configs of the
port against the reference on the same inputs.

The reference's parameters (``init_params(jax.random.key(...))``) carry
across as numpy (``train.checkpoint.params_from_numpy``); batches come
from ``recsys_batch`` (byte for byte in both packages) with a history row
made all padding.  Values agree within rtol 1e-5, atol 1e-6; gradients
against ``jax.grad`` within rtol 1e-4, atol 1e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bst as jbst
from repro.configs import din as jdin
from repro.configs import sasrec as jsasrec
from repro.configs import wide_deep as jwide
from repro.data import recsys_batch as j_recsys_batch
from repro.models import recsys as jrec
from repro_torch.configs import bst, din, sasrec, wide_deep
from repro_torch.data import recsys_batch
from repro_torch.models import recsys as trec
from repro_torch.models.layers import rms_norm
from repro_torch.train.checkpoint import params_from_numpy
from repro_torch.train.tree import leaves_with_paths

ARCHS = {"din": (jdin, din), "sasrec": (jsasrec, sasrec), "bst": (jbst, bst),
         "wide_deep": (jwide, wide_deep)}
B = 12
VALUES = dict(rtol=1e-5, atol=1e-6)
GRADS = dict(rtol=1e-4, atol=1e-6)


def _batch_arrays(cfg, seed=3, step=0):
    arrays = recsys_batch(seed, step, B, cfg.seq_len, cfg.n_dense,
                          cfg.n_sparse, cfg.vocab_items, cfg.vocab_sparse)
    arrays["hist"][1] = -1  # a history that is all padding
    arrays["sparse"][2, 0] = -1  # a missing field
    return arrays


@functools.lru_cache(maxsize=None)
def _ref_params(arch, seed):
    """The reference's parameters (jitted: its eager init takes seconds),
    as numpy, once per (arch, seed)."""
    cfg = ARCHS[arch][0].smoke_config()
    params = jax.jit(jrec.init_params, static_argnums=1)(
        jax.random.key(seed), cfg)
    return jax.tree.map(np.asarray, params)


def _pair(arch, seed=0):
    jmod, tmod = ARCHS[arch]
    jcfg, tcfg = jmod.smoke_config(), tmod.smoke_config()
    host = _ref_params(arch, seed)
    jparams = jax.tree.map(jnp.asarray, host)
    tparams = params_from_numpy(host, "cpu")
    arrays = _batch_arrays(tcfg)
    jb = jrec.RecsysBatch(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tb = trec.RecsysBatch(**{k: torch.from_numpy(v) for k, v in
                             arrays.items()})
    return jcfg, tcfg, jparams, tparams, jb, tb


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_fields_and_n_params_match(arch):
    jmod, tmod = ARCHS[arch]
    assert (tmod.ARCH_ID, tmod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY)
    for make in ("config", "smoke_config"):
        jc, tc = getattr(jmod, make)(), getattr(tmod, make)()
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        assert jd.pop("dtype") == jnp.float32
        assert td.pop("dtype") == torch.float32
        assert td == jd, make
        assert tc.n_params() == jc.n_params()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_shapes_match_reference(arch):
    jmod, tmod = ARCHS[arch]
    jp = _ref_params(arch, 0)
    tp = trec.init_params(torch.Generator().manual_seed(0),
                          tmod.smoke_config(), device="cpu")
    want = {"/".join(p): np.asarray(x) for p, x in leaves_with_paths(
        jax.tree.map(np.asarray, jp))}
    got = {"/".join(p): x for p, x in leaves_with_paths(tp)}
    assert sorted(got) == sorted(want)
    for key, x in got.items():
        assert tuple(x.shape) == want[key].shape, key
        assert x.dtype == torch.float32
        # the same initializers: zeros stay zeros, tables ~0.02
        if not want[key].any():
            assert not x.any(), key
    table = got["item_table"]
    assert 0.015 < float(table.std()) < 0.025
    assert float(table.abs().max()) <= 2 * 0.02 / 0.8796 + 1e-6


def test_init_params_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trec.init_params(torch.Generator(), din.smoke_config())


@pytest.mark.parametrize("fn", ["forward", "user_embedding", "loss"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_reference(arch, fn):
    jcfg, tcfg, jp, tp, jb, tb = _pair(arch)
    if fn == "loss":
        jl, jm = jax.jit(jrec.loss_fn, static_argnums=1)(jp, jcfg, jb)
        tl, tm = trec.loss_fn(tp, tcfg, tb)
        np.testing.assert_allclose(tl.item(), float(jl), **VALUES)
        np.testing.assert_allclose(tm["acc"].item(), float(jm["acc"]), **VALUES)
        return
    want = np.asarray(jax.jit(getattr(jrec, fn), static_argnums=1)(
        jp, jcfg, jb))
    got = getattr(trec, fn)(tp, tcfg, tb)
    assert tuple(got.shape) == want.shape
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), want, **VALUES)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_gradients_match_jax_grad(arch):
    jcfg, tcfg, jp, tp, jb, tb = _pair(arch, seed=1)
    jg = jax.jit(jax.grad(lambda p: jrec.loss_fn(p, jcfg, jb)[0]))(jp)
    flat = [(p, x.requires_grad_(True)) for p, x in leaves_with_paths(tp)]
    loss, _ = trec.loss_fn(tp, tcfg, tb)
    grads = torch.autograd.grad(loss, [x for _, x in flat],
                                allow_unused=True)
    want = {"/".join(p): np.asarray(x) for p, x in leaves_with_paths(
        jax.tree.map(np.asarray, jg))}
    assert len(want) == len(flat)
    for (path, x), g in zip(flat, grads):
        key = "/".join(path)
        got = np.zeros(x.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(got, want[key], err_msg=key, **GRADS)


@pytest.mark.parametrize("arch", ["sasrec", "bst"])
def test_all_padding_history_is_finite_and_uniform(arch):
    """A history of padding only: every attention row is uniform over the
    keys (-1e30 logits, not -inf), so the outputs stay finite."""
    jcfg, tcfg, jp, tp, jb, tb = _pair(arch)
    tb.hist[:] = -1
    jb = dataclasses.replace(jb, hist=jnp.asarray(tb.hist.numpy()))
    for fn in ("forward", "user_embedding"):
        got = getattr(trec, fn)(tp, tcfg, tb)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(
            got.detach().numpy(),
            np.asarray(jax.jit(getattr(jrec, fn), static_argnums=1)(
                jp, jcfg, jb)), **VALUES)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_retrieval_scores_match_reference(arch):
    jcfg, tcfg, jp, tp, jb, tb = _pair(arch)
    cands = np.random.default_rng(5).standard_normal(
        (300, tcfg.embed_dim)).astype(np.float32)
    cands[7] = cands[3]  # a tie: the lower row wins in both
    jv, ji = jrec.retrieval_scores(jp, jcfg, jb, jnp.asarray(cands), k=20)
    tv, ti = trec.retrieval_scores(tp, tcfg, tb, torch.from_numpy(cands),
                                   k=20)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), **VALUES)
    assert ti.dtype == torch.int32
    # ids exact away from near-ties
    gaps = np.abs(np.diff(np.asarray(jv), axis=1))
    clear = np.ones_like(np.asarray(ji), bool)
    clear[:, :-1] &= gaps > 1e-5
    clear[:, 1:] &= gaps > 1e-5
    np.testing.assert_array_equal(ti.numpy()[clear], np.asarray(ji)[clear])


def test_rms_norm_matches_reference():
    from repro.models.layers import rms_norm as j_rms_norm

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 7, 50)).astype(np.float32) * 3
    scale = rng.standard_normal(50).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)


# ---- the embedding substrate ----

def _table_ids(seed=0, v=40, d=6):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(0, v, (5, 3, 7)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[0, 0] = -1  # an empty bag
    weights = rng.random(ids.shape).astype(np.float32)
    return table, ids, weights


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_modes(mode, weighted):
    table, ids, weights = _table_ids()
    w = weights if weighted else None
    want = np.asarray(jrec.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), mode=mode,
        weights=None if w is None else jnp.asarray(w)))
    got = trec.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids), mode=mode,
        weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_ragged(mode, weighted):
    table, _, _ = _table_ids(1)
    rng = np.random.default_rng(2)
    nnz, n_bags = 50, 9
    flat = rng.integers(-1, table.shape[0], nnz).astype(np.int32)
    bags = np.sort(rng.integers(0, n_bags - 1, nnz)).astype(np.int32)
    w = rng.random(nnz).astype(np.float32) if weighted else None
    want = np.asarray(jrec.embedding_bag_ragged(
        jnp.asarray(table), jnp.asarray(flat), jnp.asarray(bags), n_bags,
        mode=mode, weights=None if w is None else jnp.asarray(w)))
    got = trec.embedding_bag_ragged(
        torch.from_numpy(table), torch.from_numpy(flat),
        torch.from_numpy(bags), n_bags, mode=mode,
        weights=None if w is None else torch.from_numpy(w))
    assert not got[-1].any()  # the last bag is empty
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_embedding_bag_rejects_unknown_modes():
    table, ids, _ = _table_ids()
    with pytest.raises(ValueError):
        trec.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           mode="median")
    with pytest.raises(ValueError):
        trec.embedding_bag_ragged(torch.from_numpy(table),
                                  torch.from_numpy(ids[0, 0]),
                                  torch.zeros(7, dtype=torch.int32), 1,
                                  mode="max")


def test_recsys_batch_and_lm_batch_are_byte_for_byte():
    from repro.data import lm_batch as j_lm_batch
    from repro_torch.data import lm_batch

    for step in (0, 5):
        a = recsys_batch(1, step, 16, 20, 13, 6, 1000, 500)
        b = j_recsys_batch(1, step, 16, 20, 13, 6, 1000, 500)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes(), key
        x, y = lm_batch(2, step, 4, 32, 777), j_lm_batch(2, step, 4, 32, 777)
        for key in ("tokens", "labels"):
            assert x[key].tobytes() == y[key].tobytes()
