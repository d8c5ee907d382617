"""Train a small two-tower embedder, then build the hybrid index from its
embeddings and serve filtered queries — the paper's full pipeline (encoder
→ index → filtered search) end to end, with checkpoint/restart built in;
on the card through the port, the counterpart of
``examples/train_embedder.py``.

    PYTHONPATH=src python examples/torch/train_embedder.py
    PYTHONPATH=src python examples/torch/train_embedder.py --device cpu \\
        --steps 40 --corpus 2000

It runs on the CUDA card unless ``--device cpu`` is given, and raises where
CUDA is absent.  ``main`` returns the loss history, recall@10 and hit@1.
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.core import HybridSpec, brute_force, build_ivf, match_all, \
    recall_at_k
from repro_torch.core.search import search_reference
from repro_torch.data import ShardedFeeder
from repro_torch.device import resolve_device
from repro_torch.models.recsys.embedding import glorot_normal
from repro_torch.train.train_loop import Trainer, TrainLoopConfig


def init_tower(gen, d_in, d_out=32):
    """The reference's tower shapes; glorot-normal weights from ``gen``."""
    def glorot(shape):
        return glorot_normal(gen, shape)

    dev = gen.device
    return {"w1": glorot((d_in, 128)), "b1": torch.zeros(128, device=dev),
            "w2": glorot((128, d_out)), "b2": torch.zeros(d_out, device=dev)}


def tower(p, x):
    h = torch.relu(x @ p["w1"] + p["b1"])
    z = h @ p["w2"] + p["b2"]
    return z / torch.clamp(torch.linalg.vector_norm(z, dim=-1, keepdim=True),
                           min=1e-6)


def loss_fn(params, batch):
    """In-batch-softmax contrastive loss (two-tower retrieval standard)."""
    za = tower(params["a"], batch["x"])
    zb = tower(params["b"], batch["y"])
    logits = za @ zb.T * 10.0
    labels = torch.arange(logits.shape[0], device=logits.device)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    loss = torch.mean(lse - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"acc": acc}


def gen(seed, step, d_in=48, batch=256):
    """Byte for byte the reference example's batches."""
    rng = np.random.default_rng((seed, step))
    base = rng.standard_normal((batch, d_in)).astype(np.float32)
    return {
        "x": base + 0.1 * rng.standard_normal((batch, d_in)).astype(np.float32),
        "y": base + 0.1 * rng.standard_normal((batch, d_in)).astype(np.float32),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--corpus", type=int, default=20_000)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary one)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    d_in, d_emb, m = 48, 32, 4
    params = {"a": init_tower(torch.Generator(dev).manual_seed(0), d_in),
              "b": init_tower(torch.Generator(dev).manual_seed(1), d_in)}
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="embedder_ckpt_")
    steps = args.steps
    cfg = TrainLoopConfig(total_steps=steps, ckpt_every=max(steps // 3, 1),
                          ckpt_dir=ckpt_dir, log_every=max(steps // 6, 1),
                          lr=3e-3, warmup=max(steps // 15, 1))
    trainer = Trainer(loss_fn, params, cfg, device=dev)
    feeder = ShardedFeeder(lambda s, i: gen(s, i), seed=0)
    print(f"training two-tower embedder for {steps} steps on {dev} ...")
    try:
        hist = trainer.run(feeder)
    finally:
        feeder.close()
    print(f"loss {hist['loss'][0]:.3f} → {hist['loss'][-1]:.3f} "
          f"(checkpoints in {ckpt_dir})")

    # --- embed a corpus and build the paper's index over it ---
    rng = np.random.default_rng(42)
    corpus = rng.standard_normal((args.corpus, d_in)).astype(np.float32)
    with torch.no_grad():
        emb = tower(trainer.params["b"], torch.as_tensor(corpus, device=dev))
    attrs = torch.as_tensor(
        rng.integers(0, 8, (len(corpus), m)).astype(np.int16), device=dev)
    spec = HybridSpec(dim=d_emb, n_attrs=m, core_dtype=torch.float32)
    index, stats = build_ivf(
        torch.Generator(dev).manual_seed(2), spec, emb, attrs,
        n_clusters=32, kmeans_steps=30, device=dev,
    )
    print(f"index built: K={index.n_clusters}, "
          f"mean list {stats.mean_list_len:.0f}")

    # --- query with the query tower ---
    q_raw = corpus[:16] + 0.05 * rng.standard_normal((16, d_in)).astype(
        np.float32)
    with torch.no_grad():
        queries = tower(trainer.params["a"], torch.as_tensor(q_raw,
                                                             device=dev))
    fspec = match_all(16, m, device=dev)
    res = search_reference(index, queries, fspec, k=10, n_probes=5)
    oracle = brute_force(emb, attrs, queries, fspec, k=10)
    recall = recall_at_k(res, oracle)
    print(f"retrieval recall@10 (T=5): {recall:.3f}")
    hit1 = float(np.mean(res.ids[:, 0].cpu().numpy() == np.arange(16)))
    print(f"self-retrieval hit@1: {hit1:.2f}")
    return dict(losses=hist["loss"], steps=hist["step"], recall=recall,
                hit1=hit1, ckpt_dir=ckpt_dir, trainer=trainer)


if __name__ == "__main__":
    main()
