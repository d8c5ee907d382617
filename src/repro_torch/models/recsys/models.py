"""The four recsys architectures over the shared embedding substrate: the
port of ``repro.models.recsys.models``.

  din        [arXiv:1706.06978] — target-attention over user history
  sasrec     [arXiv:1808.09781] — causal self-attention next-item model
  bst        [arXiv:1905.06874] — transformer over [history ‖ target]
  wide-deep  [arXiv:1606.07792] — linear wide path + deep MLP on embeddings

Plain functions over a parameter dict with the reference's keys and
nesting (``item_table``, ``field_tables``, ``attn_mlp`` / ``head`` as lists
of ``{"w", "b"}``, ``pos_embed``, ``blocks`` as lists of ``{"wqkv", "wo",
"ln1", "ln2", "ff1", "ff2"}``, ``wide``, ``wide_bias``), so the reference's
parameters carry across leaf for leaf (``train.checkpoint.
params_from_numpy``).  ``user_embedding`` is each model's retrieval vector:
``retrieval_scores`` scores it against a candidate table, and
``examples/torch/recsys_retrieval.py`` queries the hybrid IVF index with it.

Batch contract (RecsysBatch):
  dense [B, n_dense] f32 · sparse [B, n_sparse] int32 · hist [B, L] int32
  (-1 pad) · target [B] int32 · label [B] f32
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import topk as topk_lib
from repro_torch.device import resolve_device
from repro_torch.models.layers import rms_norm
from repro_torch.models.recsys.embedding import (
    embedding_bag,
    glorot_normal,
    init_table,
)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    arch: str  # "din" | "sasrec" | "bst" | "wide_deep"
    embed_dim: int
    seq_len: int = 0
    n_dense: int = 13
    n_sparse: int = 0
    vocab_items: int = 1_000_000
    vocab_sparse: int = 100_000
    mlp_dims: Tuple[int, ...] = (200, 80)
    attn_mlp_dims: Tuple[int, ...] = (80, 40)  # DIN attention MLP
    n_blocks: int = 0
    n_heads: int = 1
    dtype: Any = torch.float32

    def n_params(self) -> int:
        total = self.vocab_items * self.embed_dim
        total += self.n_sparse * self.vocab_sparse * self.embed_dim
        prev = self.embed_dim * 4 + self.n_dense  # rough head input
        for h in self.mlp_dims:
            total += prev * h
            prev = h
        return total


@dataclasses.dataclass
class RecsysBatch:
    dense: torch.Tensor
    sparse: torch.Tensor
    hist: torch.Tensor
    target: torch.Tensor
    label: torch.Tensor


def _mlp(gen, dims, dtype):
    return [{"w": glorot_normal(gen, (dims[i], dims[i + 1]), dtype),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=gen.device)}
            for i in range(len(dims) - 1)]


def _apply_mlp(layers, x, act=torch.relu, final_act=False):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if final_act or i < len(layers) - 1:
            x = act(x)
    return x


def _tiny_attn_params(gen, d, dtype):
    def zeros():
        return torch.zeros((d,), dtype=dtype, device=gen.device)

    return {
        "wqkv": glorot_normal(gen, (d, 3 * d), dtype),
        "wo": glorot_normal(gen, (d, d), dtype),
        "ln1": zeros(),
        "ln2": zeros(),
        "ff1": glorot_normal(gen, (d, 4 * d), dtype),
        "ff2": glorot_normal(gen, (4 * d, d), dtype),
    }


def _tiny_block(p, x, n_heads, causal, mask=None):
    """Minimal pre-LN transformer block for sasrec/bst.  Masked logits are
    -1e30, not -inf, so a row with no valid key is uniform, never NaN."""
    b, s, d = x.shape
    dh = d // n_heads
    h = rms_norm(x, p["ln1"])
    q, k, v = torch.split(h @ p["wqkv"], d, dim=-1)
    q = q.reshape(b, s, n_heads, dh)
    k = k.reshape(b, s, n_heads, dh)
    v = v.reshape(b, s, n_heads, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (dh ** -0.5)
    if causal:
        cm = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=x.device))
        logits = torch.where(cm[None, None], logits, -1e30)
    if mask is not None:  # [B, S] key validity
        logits = torch.where(mask[:, None, None, :], logits, -1e30)
    a = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, s, d)
    x = x + o @ p["wo"]
    h = rms_norm(x, p["ln2"])
    return x + torch.relu(h @ p["ff1"]) @ p["ff2"]


# ------------------------------------------------------------------ init ---
def init_params(gen: torch.Generator, cfg: RecsysConfig, *, device="cuda"
                ) -> Dict[str, Any]:
    """Random parameters with the reference's keys, shapes and
    distributions, drawn from ``gen`` (a generator on ``device``; the
    reference's ``jax.random`` stream cannot be reproduced: carry its
    parameters across to hold the two packages against each other)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params asked for {dev}")
    d, dt = cfg.embed_dim, cfg.dtype
    p: Dict[str, Any] = {"item_table": init_table(gen, cfg.vocab_items, d,
                                                  dt)}
    if cfg.n_sparse:
        # one fused [F·V, D] table (quotient indexing): a single big gather
        p["field_tables"] = init_table(gen, cfg.n_sparse * cfg.vocab_sparse,
                                       d, dt)
    if cfg.arch == "din":
        p["attn_mlp"] = _mlp(gen, (4 * d,) + tuple(cfg.attn_mlp_dims) + (1,),
                             dt)
        head_in = 3 * d + cfg.n_dense
        p["head"] = _mlp(gen, (head_in,) + tuple(cfg.mlp_dims) + (1,), dt)
    elif cfg.arch == "sasrec":
        p["pos_embed"] = init_table(gen, cfg.seq_len, d, dt)
        p["blocks"] = [_tiny_attn_params(gen, d, dt)
                       for _ in range(cfg.n_blocks)]
    elif cfg.arch == "bst":
        p["pos_embed"] = init_table(gen, cfg.seq_len + 1, d, dt)
        p["blocks"] = [_tiny_attn_params(gen, d, dt)
                       for _ in range(cfg.n_blocks)]
        head_in = (cfg.seq_len + 1) * d + cfg.n_dense
        p["head"] = _mlp(gen, (head_in,) + tuple(cfg.mlp_dims) + (1,), dt)
    elif cfg.arch == "wide_deep":
        head_in = cfg.n_sparse * d + cfg.n_dense
        p["head"] = _mlp(gen, (head_in,) + tuple(cfg.mlp_dims) + (1,), dt)
        p["wide"] = init_table(gen, cfg.n_sparse * cfg.vocab_sparse, 1, dt)
        p["wide_bias"] = torch.zeros((), dtype=dt, device=dev)
    else:
        raise ValueError(cfg.arch)
    return p


# ------------------------------------------------------------- forwards ---
def _field_offsets(cfg, sparse_ids):
    """[B, F] ids → ids into the fused field table (id + F·offset), -1
    kept."""
    offs = torch.arange(cfg.n_sparse, dtype=torch.int32,
                        device=sparse_ids.device) * cfg.vocab_sparse
    return torch.where(sparse_ids >= 0, sparse_ids + offs[None, :], -1)


def _last_valid(h, hist):
    """``h`` [B, L, D] at each row's last valid history position."""
    last = torch.clamp(torch.sum((hist >= 0).int(), -1) - 1, min=0)
    idx = last.long()[:, None, None].expand(-1, 1, h.shape[-1])
    return torch.gather(h, 1, idx)[:, 0]


def user_embedding(params, cfg: RecsysConfig, batch: RecsysBatch
                   ) -> torch.Tensor:
    """The retrieval vector (for `retrieval_cand` / IVF candidate gen)."""
    if cfg.arch in ("din", "wide_deep"):
        return embedding_bag(params["item_table"], batch.hist, mode="mean")
    # sequence models: hidden state at the last valid position
    return _last_valid(_seq_hidden(params, cfg, batch), batch.hist)


def _seq_hidden(params, cfg, batch) -> torch.Tensor:
    e = embedding_bag(params["item_table"], batch.hist[..., None])  # [B,L,D]
    s = e.shape[1]
    e = e + params["pos_embed"][None, :s]
    mask = batch.hist >= 0
    for blk in params["blocks"]:
        e = _tiny_block(blk, e, cfg.n_heads, causal=True, mask=mask)
    return e


def forward(params, cfg: RecsysConfig, batch: RecsysBatch) -> torch.Tensor:
    """Pointwise CTR logit [B] (din/bst/wide_deep) or next-item score [B]
    against the batch target (sasrec)."""
    b = batch.target.shape[0]
    tgt = embedding_bag(params["item_table"], batch.target[:, None])  # [B,D]

    if cfg.arch == "din":
        hist = embedding_bag(params["item_table"], batch.hist[..., None])
        mask = (batch.hist >= 0)[..., None]  # [B, L, 1]
        tq = torch.broadcast_to(tgt[:, None], hist.shape)
        a_in = torch.cat([hist, tq, hist - tq, hist * tq], dim=-1)  # [B,L,4D]
        w = _apply_mlp(params["attn_mlp"], a_in, act=torch.sigmoid)  # [B,L,1]
        w = torch.where(mask, w, 0.0)
        interest = torch.sum(hist * w, dim=1)  # [B, D] (no softmax, per paper)
        x = torch.cat([interest, tgt, interest * tgt,
                       batch.dense.to(tgt.dtype)], -1)
        return _apply_mlp(params["head"], x)[:, 0]

    if cfg.arch == "sasrec":
        u = _last_valid(_seq_hidden(params, cfg, batch), batch.hist)
        return torch.sum(u * tgt, -1)  # dot score

    if cfg.arch == "bst":
        e = embedding_bag(params["item_table"], batch.hist[..., None])
        seq = torch.cat([e, tgt[:, None]], dim=1)  # [B, L+1, D]
        s = seq.shape[1]
        seq = seq + params["pos_embed"][None, :s]
        mask = torch.cat([batch.hist >= 0,
                          torch.ones((b, 1), dtype=torch.bool,
                                     device=seq.device)], dim=1)
        for blk in params["blocks"]:
            seq = _tiny_block(blk, seq, cfg.n_heads, causal=False, mask=mask)
        x = torch.cat([seq.reshape(b, -1), batch.dense.to(seq.dtype)], -1)
        return _apply_mlp(params["head"], x)[:, 0]

    if cfg.arch == "wide_deep":
        fused = _field_offsets(cfg, batch.sparse)
        fields = embedding_bag(params["field_tables"], fused[..., None],
                               mode="sum")  # [B, F, D]
        deep_in = torch.cat([fields.reshape(b, -1),
                             batch.dense.to(fields.dtype)], -1)
        deep = _apply_mlp(params["head"], deep_in)[:, 0]
        wide = embedding_bag(params["wide"], fused, mode="sum")[:, 0]
        return deep + wide + params["wide_bias"]

    raise ValueError(cfg.arch)


def loss_fn(params, cfg: RecsysConfig, batch: RecsysBatch
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logit = forward(params, cfg, batch).float()
    y = batch.label.float()
    loss = torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))
    acc = torch.mean(((logit > 0) == (y > 0.5)).float())
    return loss, {"bce": loss, "acc": acc}


def retrieval_scores(params, cfg: RecsysConfig, batch: RecsysBatch,
                     candidates: torch.Tensor, k: int = 100
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`retrieval_cand`: score users against [N_cand, D] item rows — one
    batched matmul + top-k (ties to the lower row, as ``lax.top_k``).  The
    IVF-index path for the same operation is
    ``examples/torch/recsys_retrieval.py``."""
    u = user_embedding(params, cfg, batch)  # [B, D]
    scores = u.float() @ candidates.float().T
    vals, ids = topk_lib.top_k(scores, k)
    return vals, ids.int()
