"""The port's serving paths (``models/decoding.py``) against the reference
on the same numpy inputs and carried parameters: cache shapes, ``prefill``
(logits and every cache tensor), each teacher-forced ``decode_step``'s
logits (the gemma ring wrapping past its window included), and
``greedy_generate``'s tokens, for the four archs of
``tests/test_decoding.py``.  Tolerances: rtol 1e-4, atol 1e-5; tokens
exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import chatglm3_6b as jchatglm
from repro.configs import deepseek_moe_16b as jdsmoe
from repro.configs import deepseek_v3_671b as jdsv3
from repro.configs import gemma3_12b as jgemma12
from repro.models import decoding as jdec
from repro.models import transformer as jtr
from repro_torch.configs import (
    chatglm3_6b,
    deepseek_moe_16b,
    deepseek_v3_671b,
    gemma3_12b,
)
from repro_torch.models import decoding as tdec
from repro_torch.models import transformer as ttr
from repro_torch.train.checkpoint import params_from_numpy

ARCHS = {
    "deepseek-v3-671b": (jdsv3, deepseek_v3_671b),  # MLA absorbed decode
    "deepseek-moe-16b": (jdsmoe, deepseek_moe_16b),  # MoE decode
    "gemma3-12b": (jgemma12, gemma3_12b),  # ring buffers + dual theta
    "chatglm3-6b": (jchatglm, chatglm3_6b),  # partial rotary + qkv bias
}
TOL = dict(rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def ref_params(arch, seed=0):
    cfg = ARCHS[arch][0].smoke_config()
    params = jax.jit(jtr.init_params, static_argnums=1)(jax.random.key(seed),
                                                        cfg)
    return jax.tree.map(np.asarray, params)


def _tokens(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, s)).astype(np.int32)


def _run_both(arch, b, s_prompt, s_total, seed=0):
    """Prefill on s_prompt tokens, then teacher-forced decode to s_total in
    both packages: returns the pairs (prefill logits, caches, step logits)."""
    jmod, tmod = ARCHS[arch]
    jcfg, tcfg = jmod.smoke_config(), tmod.smoke_config()
    host = ref_params(arch, seed)
    jp = jax.tree.map(jnp.asarray, host)
    tp = params_from_numpy(host, "cpu")
    tokens = _tokens(jcfg.vocab_size, b, s_total, seed)
    jpre, jcache = jax.jit(functools.partial(jdec.prefill, cfg=jcfg,
                                             s_max=s_total))(
        jp, tokens=tokens[:, :s_prompt])
    tpre, tcache = tdec.prefill(tp, tcfg, torch.from_numpy(
        tokens[:, :s_prompt]), s_total)
    pre = (np.asarray(jpre), tpre.numpy())
    caches = (jax.tree.map(np.asarray, jcache),
              {k: tuple(x.clone().numpy() for x in v)
               for k, v in tcache.items()})
    jstep = jax.jit(functools.partial(jdec.decode_step, cfg=jcfg))
    jdp, tdp = jdec.decode_layout(jp, jcfg), tdec.decode_layout(tp, tcfg)
    steps = []
    for j in range(s_prompt, s_total):
        jl, jcache = jstep(jdp, cache=jcache, tokens=tokens[:, j],
                           pos=jnp.int32(j))
        tl, tcache = tdec.decode_step(tdp, tcfg, tcache,
                                      torch.from_numpy(tokens[:, j]), j)
        steps.append((np.asarray(jl), tl.numpy()))
    return pre, caches, steps


@pytest.mark.parametrize("arch", sorted(ARCHS) + ["gemma3-27b"])
def test_cache_spec_matches_reference(arch):
    from repro.configs import gemma3_27b as jg27
    from repro_torch.configs import gemma3_27b as tg27

    jmod, tmod = ARCHS.get(arch, (jg27, tg27))
    for make in ("config", "smoke_config"):
        jcfg, tcfg = getattr(jmod, make)(), getattr(tmod, make)()
        for b, s_max in ((4, 2048), (2, 8)):
            want = jdec.cache_spec(jcfg, b, s_max)
            got = tdec.cache_spec(tcfg, b, s_max)
            assert sorted(got) == sorted(want)
            for key in want:
                for g, w in zip(got[key], want[key]):
                    assert g.shape == w.shape, (make, key)
                    assert str(g.dtype).split(".")[-1] == str(w.dtype)
    cache = tdec.init_cache(tmod.smoke_config(), 2, 24, device="cpu")
    for key, spec in tdec.cache_spec(tmod.smoke_config(), 2, 24).items():
        assert [tuple(x.shape) for x in cache[key]] == [s.shape for s in spec]
        assert not any(bool(x.any()) for x in cache[key])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_prefill_and_decode_steps_match_reference(arch):
    """B=2, a 16-token prompt, 8 decode steps (s_max 24)."""
    pre, (jcache, tcache), steps = _run_both(arch, 2, 16, 24)
    np.testing.assert_allclose(pre[1], pre[0], **TOL)
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        for g, w in zip(tcache[key], jcache[key]):
            assert g.shape == w.shape, key
            np.testing.assert_allclose(g, w, **TOL, err_msg=key)
    for i, (want, got) in enumerate(steps):
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"step {i}")


def test_ring_cache_wraps_like_reference():
    """gemma3-12b's smoke window is 16: a 20-token prompt (the ring holds
    its last 16 positions at slot p % 16) decoded to 40, well past one
    window."""
    pre, (jcache, tcache), steps = _run_both("gemma3-12b", 1, 20, 40, seed=1)
    np.testing.assert_allclose(pre[1], pre[0], **TOL)
    for key in ("local", "global"):
        for g, w in zip(tcache[key], jcache[key]):
            np.testing.assert_allclose(g, w, **TOL, err_msg=key)
    assert tcache["local"][0].shape[2] == 16
    for i, (want, got) in enumerate(steps):
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_matches_forward(arch):
    """The port alone: each decode step's logits equal forward's at that
    position (causality), as the reference's own test holds its decode."""
    tcfg = ARCHS[arch][1].smoke_config()
    tp = params_from_numpy(ref_params(arch, 2), "cpu")
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, 2, 24, 2))
    h, _ = ttr.forward(tp, tcfg, tokens)
    want = ttr.logits_from_hidden(tp, tcfg, h)
    dp = tdec.decode_layout(tp, tcfg)
    pre, cache = tdec.prefill(tp, tcfg, tokens[:, :16], 24)
    torch.testing.assert_close(pre, want[:, :16], **TOL)
    for j in range(16, 24):
        logits, cache = tdec.decode_step(dp, tcfg, cache, tokens[:, j], j)
        torch.testing.assert_close(logits, want[:, j], **TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_greedy_generate_tokens_equal_reference(arch):
    jmod, tmod = ARCHS[arch]
    jcfg, tcfg = jmod.smoke_config(), tmod.smoke_config()
    host = ref_params(arch, 3)
    prompt = _tokens(jcfg.vocab_size, 2, 12, 3)
    want = jdec.greedy_generate(jax.tree.map(jnp.asarray, host), jcfg,
                                jnp.asarray(prompt), 6, 20)
    got = tdec.greedy_generate(params_from_numpy(host, "cpu"), tcfg, prompt,
                               6, 20, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_write_past_the_cache_end_clamps_like_reference():
    """A write position past s_max lands on the last slot (the reference's
    ``dynamic_update_slice`` clamps its start index)."""
    arch = "chatglm3-6b"
    jmod, tmod = ARCHS[arch]
    jcfg, tcfg = jmod.smoke_config(), tmod.smoke_config()
    host = ref_params(arch)
    tokens = _tokens(jcfg.vocab_size, 1, 8, 4)
    jp = jax.tree.map(jnp.asarray, host)
    tp = params_from_numpy(host, "cpu")
    _, jcache = jdec.prefill(jp, jcfg, jnp.asarray(tokens), 8)
    _, tcache = tdec.prefill(tp, tcfg, torch.from_numpy(tokens), 8)
    jl, jcache = jdec.decode_step(jp, jcfg, jcache, jnp.asarray(tokens[:, 0]),
                                  jnp.int32(11))
    tl, tcache = tdec.decode_step(tp, tcfg, tcache,
                                  torch.from_numpy(tokens[:, 0]), 11)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for g, w in zip(tcache["dense"], jcache["dense"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_greedy_generate_needs_cuda_unless_cpu_is_asked(monkeypatch):
    tcfg = chatglm3_6b.smoke_config()
    tp = params_from_numpy(ref_params("chatglm3-6b"), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdec.greedy_generate(tp, tcfg, np.zeros((1, 4), np.int32), 2, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdec.init_cache(tcfg, 1, 8)
