"""Training launcher: the port of ``repro.launch.train``.  ``--arch <id>``
selects any assigned architecture at its smoke scale (default) or at full
scale (``--full``), on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch dimenet --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch din --device cpu

The arch tables are ``launch/specs.py``'s, as in the reference: the five
LMs, ``dimenet`` and the four recsys configs, under the reference's names.
Each runner may take its initial parameters (``params``, a tree of
tensors or numpy arrays) in place of its own draw, so that a run can be
held against the reference's from the same start.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.specs import LM_ARCHS, RECSYS_ARCHS

GNN_PADS = (2048, 4096, 16384)  # n_pad, e_pad, t_pad of the smoke batches


def _config(mod, smoke: bool):
    return mod.smoke_config() if smoke else mod.config()


def _run(loss_fn, params, tl, gen, args):
    from repro_torch.data import ShardedFeeder
    from repro_torch.train.train_loop import Trainer

    trainer = Trainer(loss_fn, params, tl, device=args.device)
    feeder = ShardedFeeder(gen, seed=args.seed)
    try:
        return trainer.run(feeder)
    finally:
        feeder.close()


def lm_runner(arch: str, args, params=None):
    from repro_torch.data import lm_batch
    from repro_torch.models.transformer import init_params, lm_loss
    from repro_torch.train.train_loop import TrainLoopConfig

    cfg = _config(LM_ARCHS[arch], args.smoke)
    if params is None:
        dev = resolve_device(args.device)
        params = init_params(torch.Generator(dev).manual_seed(args.seed), cfg,
                             device=dev)

    def loss_fn(p, batch):
        return lm_loss(p, cfg, batch["tokens"], batch["labels"])

    tl = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, lr=args.lr,
                         warmup=max(2, args.steps // 10),
                         log_every=max(1, args.steps // 10))
    return _run(loss_fn, params, tl,
                lambda s, i: lm_batch(s, i, args.batch, args.seq,
                                      cfg.vocab_size), args)


def gnn_runner(arch: str, args, params=None):
    from repro_torch.models.gnn import GraphBatch, init_params, loss_fn
    from repro_torch.models.gnn.sampler import (
        make_graph_batch_arrays, random_graph, sample_subgraph,
    )
    from repro_torch.train.train_loop import TrainLoopConfig

    from repro_torch.configs import dimenet

    cfg = _config(dimenet, True)
    rng = np.random.default_rng(args.seed)
    g = random_graph(rng, 2000, 8, cfg.d_feat, cfg.d_out)
    if params is None:
        dev = resolve_device(args.device)
        params = init_params(torch.Generator(dev).manual_seed(args.seed), cfg,
                             device=dev)
    n_pad, e_pad, t_pad = GNN_PADS

    def gen(seed, step):
        r = np.random.default_rng((seed, step))
        seeds = r.choice(g.n_nodes, 64, replace=False).astype(np.int32)
        nodes, esrc, edst = sample_subgraph(r, g, seeds, [6, 4])
        return make_graph_batch_arrays(
            g, nodes, esrc, edst, n_pad=n_pad, e_pad=e_pad, t_pad=t_pad,
        )

    def loss_wrap(p, arrs):
        batch = GraphBatch(
            node_feat=arrs["node_feat"], positions=arrs["positions"],
            edge_src=arrs["edge_src"], edge_dst=arrs["edge_dst"],
            edge_mask=arrs["edge_mask"], trip_in=arrs["trip_in"],
            trip_out=arrs["trip_out"], trip_mask=arrs["trip_mask"],
            graph_id=arrs["graph_id"], n_graphs=1,
        )
        return loss_fn(p, cfg, batch, arrs["labels"])

    tl = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, lr=args.lr,
                         log_every=max(1, args.steps // 10))
    return _run(loss_wrap, params, tl, gen, args)


def recsys_runner(arch: str, args, params=None):
    from repro_torch.data import recsys_batch
    from repro_torch.models.recsys import RecsysBatch, init_params, loss_fn
    from repro_torch.train.train_loop import TrainLoopConfig

    cfg = _config(RECSYS_ARCHS[arch], args.smoke)
    if params is None:
        dev = resolve_device(args.device)
        params = init_params(torch.Generator(dev).manual_seed(args.seed), cfg,
                             device=dev)

    def gen(seed, step):
        return recsys_batch(seed, step, args.batch, cfg.seq_len,
                            cfg.n_dense, cfg.n_sparse, cfg.vocab_items,
                            cfg.vocab_sparse)

    def loss_wrap(p, b):
        batch = RecsysBatch(
            dense=b["dense"], sparse=b["sparse"], hist=b["hist"],
            target=b["target"], label=b["label"],
        )
        return loss_fn(p, cfg, batch)

    tl = TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, lr=args.lr,
                         log_every=max(1, args.steps // 10))
    return _run(loss_wrap, params, tl, gen, args)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, params=None) -> dict:
    """Runs ``--arch`` and returns the trainer's history (``loss`` and
    ``step`` a step); ``params`` replaces the runner's own draw."""
    args = parse_args(argv)
    resolve_device(args.device)
    if args.arch in LM_ARCHS:
        hist = lm_runner(args.arch, args, params)
    elif args.arch == "dimenet":
        hist = gnn_runner(args.arch, args, params)
    elif args.arch in RECSYS_ARCHS:
        hist = recsys_runner(args.arch, args, params)
    else:
        raise SystemExit(f"unknown arch {args.arch}")
    print(f"final loss {hist['loss'][-1]:.4f} after {len(hist['loss'])} steps")
    return hist


if __name__ == "__main__":
    main()
