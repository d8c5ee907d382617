"""The port's LM family (``models/{config,layers,moe,transformer}.py`` and
the five LM configs) against the reference on the same numpy inputs.

The reference's parameters (``init_params(jax.random.key(...))``, jitted)
carry across as numpy (``train.checkpoint.params_from_numpy``).
Tolerances: the layers (RoPE, attention, norms) rtol 1e-5, atol 1e-6;
``forward``, ``logits_from_hidden`` and ``lm_loss`` of the smoke configs
rtol 1e-4, atol 1e-5; their gradients against ``jax.grad`` rtol 1e-4,
atol 1e-6; the MoE dispatch tables and drop counts exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import chatglm3_6b as jchatglm
from repro.configs import deepseek_moe_16b as jdsmoe
from repro.configs import deepseek_v3_671b as jdsv3
from repro.configs import gemma3_12b as jgemma12
from repro.configs import gemma3_27b as jgemma27
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro_torch.configs import (
    chatglm3_6b,
    deepseek_moe_16b,
    deepseek_v3_671b,
    gemma3_12b,
    gemma3_27b,
)
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.train.checkpoint import params_from_numpy
from repro_torch.train.optimizer import to_placements
from repro_torch.train.tree import leaves, leaves_with_paths, unflatten_like

ARCHS = {
    "chatglm3-6b": (jchatglm, chatglm3_6b),
    "deepseek-moe-16b": (jdsmoe, deepseek_moe_16b),
    "deepseek-v3-671b": (jdsv3, deepseek_v3_671b),
    "gemma3-12b": (jgemma12, gemma3_12b),
    "gemma3-27b": (jgemma27, gemma3_27b),
}
LAYER = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)
GRADS = dict(rtol=1e-4, atol=1e-6)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@functools.lru_cache(maxsize=None)
def ref_params(arch, seed=0):
    """The reference's smoke parameters as numpy, once per (arch, seed)."""
    cfg = ARCHS[arch][0].smoke_config()
    params = jax.jit(jtr.init_params, static_argnums=1)(jax.random.key(seed),
                                                        cfg)
    return jax.tree.map(np.asarray, params)


def lm_inputs(vocab, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1
    labels[0, 3] = -1  # an ignored label inside the sequence
    return tokens, labels


# ---- configs ----

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_config_fields_and_counts_match(arch):
    jmod, tmod = ARCHS[arch]
    assert (tmod.ARCH_ID, tmod.FAMILY) == (jmod.ARCH_ID, jmod.FAMILY)
    for make in ("config", "smoke_config"):
        jc, tc = getattr(jmod, make)(), getattr(tmod, make)()
        jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
        jdt, tdt = jd.pop("dtype"), td.pop("dtype")
        assert (jdt, tdt) in ((jnp.bfloat16, torch.bfloat16),
                              (jnp.float32, torch.float32)), make
        assert td == jd, make
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()
        assert (tc.n_dense_layers, tc.n_moe_layers, tc.sub_quadratic) == (
            jc.n_dense_layers, jc.n_moe_layers, jc.sub_quadratic)
        np.testing.assert_array_equal(tc.window_pattern(), jc.window_pattern())
        assert tc.window_pattern().dtype == np.int32
    assert tmod.config().dtype == torch.bfloat16


# ---- layers ----

def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 24)).astype(np.float32) * 3 + 1
    s, b = (rng.standard_normal((2, 24)).astype(np.float32) * 0.1)
    np.testing.assert_allclose(
        _np(tlayers.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                               torch.from_numpy(b))),
        np.asarray(jlayers.layer_norm(x, s, b)), **LAYER)
    np.testing.assert_allclose(
        _np(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(s))),
        np.asarray(jlayers.rms_norm(x, s)), **LAYER)


@pytest.mark.parametrize("rotary", [32, 16])
def test_rope_tables_and_apply_rope_match_reference(rotary):
    """Full and partial (chatglm's half) rotary, theta 1e4 and 1e6, at
    positions up to 1039 (the card check's longest sequence)."""
    rng = np.random.default_rng(1)
    pos = np.concatenate([np.arange(8), [511, 1024, 1039]]).astype(np.int32)
    x = rng.standard_normal((2, len(pos), 3, 32)).astype(np.float32)
    for theta in (1e4, 1e6):
        js, jc = jlayers.rope_tables(jnp.asarray(pos), rotary, theta)
        ts, tc = tlayers.rope_tables(torch.from_numpy(pos), rotary, theta)
        np.testing.assert_allclose(_np(ts), np.asarray(js), **LAYER)
        np.testing.assert_allclose(_np(tc), np.asarray(jc), **LAYER)
        np.testing.assert_allclose(
            _np(tlayers.apply_rope(torch.from_numpy(x), ts, tc, rotary)),
            np.asarray(jlayers.apply_rope(x, js, jc, rotary)), **LAYER)


FLASH_CASES = {
    # name: (B, Sq, Sk, H, Hkv, dh, dhv, window, q_offset, block_k, causal)
    "causal-gqa": (2, 32, 32, 4, 2, 16, 16, 0, 0, 8, True),
    "windowed": (1, 40, 40, 4, 4, 8, 8, 6, 0, 8, True),
    "q_offset": (2, 8, 40, 4, 1, 8, 12, 0, 32, 10, True),
    "window-offset": (1, 8, 48, 2, 2, 8, 8, 5, 40, 16, True),
    "bidirectional": (1, 12, 24, 2, 1, 8, 8, 0, 0, 24, False),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_attention_matches_reference(name):
    b, sq, sk, h, hkv, dh, dhv, w, off, blk, causal = FLASH_CASES[name]
    rng = np.random.default_rng(2)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dhv)).astype(np.float32)
    kw = dict(window=w, q_offset=off, block_k=blk, causal=causal)
    want = jlayers.flash_attention(q, k, v, **kw)
    got = tlayers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER)


def test_flash_attention_rejects_a_ragged_block():
    x = torch.zeros((1, 10, 2, 8))
    with pytest.raises(ValueError, match="divisible"):
        tlayers.flash_attention(x, x, x, block_k=4)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    kc = rng.standard_normal((3, 20, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((3, 20, 2, 6)).astype(np.float32)
    pos = np.array([0, 7, 19], np.int32)
    want = jlayers.decode_attention(q, kc, vc, position=jnp.asarray(pos),
                                    window=window)
    got = tlayers.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        position=torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_gated_mlp_matches_reference(act):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    wg, wu = rng.standard_normal((2, 16, 24)).astype(np.float32) * 0.3
    wd = rng.standard_normal((24, 16)).astype(np.float32) * 0.3
    want = jlayers.gated_mlp(x, wg, wu, wd, act)
    got = tlayers.gated_mlp(*map(torch.from_numpy, (x, wg, wu, wd)), act)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER)


# ---- MoE ----

DISPATCH_CASES = {
    # name: (N, k, E, e_lo, e_local, capacity)
    "all-local": (24, 2, 8, 0, 8, 8),
    "drops": (40, 3, 4, 0, 4, 8),
    "second-half": (30, 2, 8, 4, 4, 8),
    "middle-with-drops": (64, 4, 16, 4, 8, 8),
}


@pytest.mark.parametrize("name", sorted(DISPATCH_CASES))
def test_dispatch_table_matches_reference_exactly(name):
    """Tables and drop counts equal, drops and foreign experts included."""
    n, k, e, e_lo, e_local, cap = DISPATCH_CASES[name]
    rng = np.random.default_rng(5)
    # k distinct experts a token, skewed so some experts overflow
    ids = np.stack([rng.choice(e, k, replace=False,
                               p=np.linspace(3, 1, e) / np.linspace(3, 1, e)
                               .sum()) for _ in range(n)]).astype(np.int32)
    w = rng.random((n, k)).astype(np.float32)
    want = jmoe._dispatch_table(jnp.asarray(ids), jnp.asarray(w),
                                e_lo=jnp.int32(e_lo), e_local=e_local,
                                capacity=cap)
    got = tmoe._dispatch_table(torch.from_numpy(ids), torch.from_numpy(w),
                               e_lo=e_lo, e_local=e_local, capacity=cap)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(wnt))
    if "drops" in name:
        assert int(got[3]) > 0


@pytest.mark.parametrize("score", ["softmax", "sigmoid_norm"])
def test_router_scores_and_aux_loss_match_reference(score):
    """Top-k ids exactly (ties to the lower expert: duplicated router
    columns make exact ties), weights and probabilities rtol 1e-5."""
    rng = np.random.default_rng(6)
    cfg_kw = dict(n_routed=8, top_k=3, n_shared=0, d_ff_expert=4,
                  router_score=score, use_routing_bias=score != "softmax")
    jcfg = jmoe.MoEConfig(**cfg_kw)
    tcfg = tmoe.MoEConfig(**cfg_kw)
    x = rng.standard_normal((20, 16)).astype(np.float32)
    router = rng.standard_normal((16, 8)).astype(np.float32) * 0.5
    router[:, 5] = router[:, 2]  # experts 2 and 5 tie on every token
    bias = np.zeros(8, np.float32) if score == "softmax" else \
        (rng.standard_normal(8) * 0.1).astype(np.float32)
    bias[5] = bias[2]
    jw, jids, jprobs = jmoe.router_scores(x, router, bias, jcfg)
    tw, tids, tprobs = tmoe.router_scores(*map(torch.from_numpy,
                                               (x, router, bias)), tcfg)
    np.testing.assert_array_equal(_np(tids), np.asarray(jids))
    assert tids.dtype == torch.int32
    np.testing.assert_allclose(_np(tw), np.asarray(jw), **LAYER)
    np.testing.assert_allclose(_np(tprobs), np.asarray(jprobs), **LAYER)
    np.testing.assert_allclose(
        float(tmoe.aux_load_balance_loss(tprobs, tids, 8)),
        float(jmoe.aux_load_balance_loss(jprobs, jids, 8)), **LAYER)


def test_moe_ffn_local_matches_reference_with_drops():
    cfg_kw = dict(n_routed=8, top_k=2, n_shared=1, d_ff_expert=12)
    jcfg, tcfg = jmoe.MoEConfig(**cfg_kw), tmoe.MoEConfig(**cfg_kw)
    params = jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.key(3), 16, jcfg, jnp.float32))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 16)).astype(np.float32)
    jout, jm = jmoe.moe_ffn_local(jnp.asarray(x), params, jcfg, capacity=8)
    tout, tm = tmoe.moe_ffn_local(torch.from_numpy(x),
                                  params_from_numpy(params, "cpu"), tcfg,
                                  capacity=8)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **LAYER)
    assert int(tm["n_dropped"]) == int(jm["n_dropped"]) > 0
    np.testing.assert_allclose(float(tm["aux_loss"]), float(jm["aux_loss"]),
                               **LAYER)
    np.testing.assert_allclose(
        _np(tmoe.shared_expert_ffn(torch.from_numpy(x),
                                   params_from_numpy(params, "cpu"))),
        np.asarray(jmoe.shared_expert_ffn(x, params)), **LAYER)


# ---- the model ----

def _pair(arch):
    jmod, tmod = ARCHS[arch]
    host = ref_params(arch)
    return (jmod.smoke_config(), tmod.smoke_config(),
            jax.tree.map(jnp.asarray, host), params_from_numpy(host, "cpu"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_logits_and_loss_match_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    tokens, labels = lm_inputs(jcfg.vocab_size)
    jh, jaux = jax.jit(lambda p, t: jtr.forward(p, jcfg, t))(jp, tokens)
    th, taux = ttr.forward(tp, tcfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(th), np.asarray(jh), **MODEL)
    np.testing.assert_allclose(
        _np(ttr.logits_from_hidden(tp, tcfg, th)),
        np.asarray(jtr.logits_from_hidden(jp, jcfg, jh)), **MODEL)
    assert int(taux["moe_dropped"]) == int(jaux["moe_dropped"])
    np.testing.assert_allclose(float(taux["moe_aux_loss"]),
                               float(jaux["moe_aux_loss"]), **MODEL)
    jl, jm = jax.jit(lambda p: jtr.lm_loss(p, jcfg, tokens, labels))(jp)
    tl, tm = ttr.lm_loss(tp, tcfg, torch.from_numpy(tokens),
                         torch.from_numpy(labels))
    np.testing.assert_allclose(float(tl), float(jl), **MODEL)
    assert sorted(tm) == sorted(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **MODEL,
                                   err_msg=key)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_gradients_match_jax_grad(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    tokens, labels = lm_inputs(jcfg.vocab_size, seed=1)
    jgrads = jax.jit(jax.grad(
        lambda p: jtr.lm_loss(p, jcfg, tokens, labels)[0]))(jp)
    flat = [x.clone().requires_grad_(True) for x in leaves(tp)]
    loss, _ = ttr.lm_loss(unflatten_like(tp, flat), tcfg,
                          torch.from_numpy(tokens), torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    for (path, p), g in zip(leaves_with_paths(tp), grads):
        got = np.zeros(tuple(p.shape), np.float32) if g is None else _np(g)
        np.testing.assert_allclose(got, want[path], **GRADS,
                                   err_msg="/".join(path))


def test_remat_changes_no_value():
    """``remat=True`` (``torch.utils.checkpoint`` a layer) gives the same
    loss and gradients bit for bit."""
    _, tcfg, _, tp = _pair("deepseek-moe-16b")
    tokens, labels = lm_inputs(tcfg.vocab_size, seed=2)
    out = []
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        flat = [x.clone().requires_grad_(True) for x in leaves(tp)]
        loss, _ = ttr.lm_loss(unflatten_like(tp, flat), cfg,
                              torch.from_numpy(tokens),
                              torch.from_numpy(labels))
        out.append((loss, torch.autograd.grad(loss, flat, allow_unused=True)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_tree_matches_reference(arch):
    """The port's own draw: the reference's keys, shapes and dtypes; the
    truncated normals at the reference's scale; norms and biases zero."""
    jmod, tmod = ARCHS[arch]
    want = {path: x for path, x in leaves_with_paths(ref_params(arch))}
    got = ttr.init_params(torch.Generator("cpu").manual_seed(0),
                          tmod.smoke_config(), device="cpu")
    got = dict(leaves_with_paths(got))
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        w = want[path]
        assert tuple(x.shape) == w.shape, path
        assert x.dtype == torch.float32 and w.dtype == np.float32, path
        if not np.any(w):
            assert not bool(x.any()), path
        else:
            assert abs(float(x.std()) / float(np.std(w)) - 1) < 0.1, path
            assert float(x.abs().max()) <= 0.04 + 1e-6, path


def test_init_params_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttr.init_params(torch.Generator("cpu"), chatglm3_6b.smoke_config())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_pspecs_are_the_references(arch):
    """Each leaf's placements are the reference's PartitionSpec converted
    by ``to_placements``, over (data, model) and (pod, data, model)."""
    jmod, tmod = ARCHS[arch]

    def walk(tree, out, path=()):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], out, path + (k,))
        else:
            out[path] = tree
        return out

    for axes in (("data", "model"), ("pod", "data", "model")):
        want = {path: to_placements(tuple(spec), axes) for path, spec in
                walk(jtr.param_pspecs(jmod.config()), {}).items()}
        got = walk(ttr.param_pspecs(tmod.config(), axes), {})
        assert sorted(got) == sorted(want)
        for path in got:
            assert got[path] == want[path], path
    specs = ttr.param_pspecs(tmod.config())
    assert specs["embed"] == (Shard(1), Shard(0))
    if "moe_blocks" in specs:
        assert specs["moe_blocks"]["moe"]["wg"] == (Shard(2), Shard(1))
        assert specs["moe_blocks"]["moe"]["router_bias"] == (Replicate(),
                                                             Replicate())
