"""Quickstart: build a hybrid IVF-Flat index, run filtered searches,
compare against the exact oracle, add new vectors online — on the card
through the port (``repro_torch``); the counterpart of
``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu --n 5000

It runs on the CUDA card unless ``--device cpu`` is given, and raises where
CUDA is absent.  ``main`` returns what it printed as numbers.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    FilterBuilder,
    HybridSpec,
    add_vectors,
    brute_force,
    build_ivf,
    from_builders,
    match_all,
    recall_at_k,
    search_reference,
)
from repro_torch.data import synthetic_attributes, synthetic_embeddings
from repro_torch.device import resolve_device
from repro_torch.kernels.filtered_scan import search_fused


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, d, m = args.n, 64, 10
    print(f"building hybrid IVF-Flat over N={n}, D={d}, M={m} on {dev} ...")
    core = torch.as_tensor(synthetic_embeddings(0, n, d), device=dev)
    attrs = torch.as_tensor(
        synthetic_attributes(0, n, m, cardinalities=[16]), device=dev)
    spec = HybridSpec(dim=d, n_attrs=m, core_dtype=torch.float32)
    index, stats = build_ivf(
        torch.Generator(dev).manual_seed(0), spec, core, attrs,
        n_clusters=64, kmeans_steps=40, device=dev,
    )
    print(f"  K={index.n_clusters}, mean list {stats.mean_list_len:.0f}, "
          f"Vpad={stats.vpad}, {index.nbytes()/1e6:.1f} MB")

    # --- unfiltered search (paper §4.4, wildcard F) ---
    q = 16
    rng = np.random.default_rng(1)
    queries = core[torch.as_tensor(rng.integers(0, n, q), device=dev)]
    fspec = match_all(q, m, device=dev)
    res = search_reference(index, queries, fspec, k=10, n_probes=7)
    oracle = brute_force(core, attrs, queries, fspec, k=10)
    recall = recall_at_k(res, oracle)
    print(f"unfiltered recall@10 at T=7: {recall:.3f}")

    # --- SQL-like filtered search ---
    #   WHERE attr0 == 3 AND 2 <= attr1 <= 9 AND attr2 IN (1, 5)
    builders = [
        FilterBuilder(m).eq(0, 3).between(1, 2, 9).isin(2, [1, 5])
        for _ in range(q)
    ]
    fs = from_builders(builders, device=dev)
    res_f = search_reference(index, queries, fs, k=10, n_probes=7)
    oracle_f = brute_force(core, attrs, queries, fs, k=10)
    recall_f = recall_at_k(res_f, oracle_f)
    selectivity = float(oracle_f.n_passed.float().mean()) / n
    print(f"filtered recall@10 at T=7:   {recall_f:.3f} "
          f"(selectivity {selectivity:.4f})")

    # --- fused path: the per-probe filtered_scan kernel (same contract) ---
    res_k = search_fused(index, queries, fs, k=10, n_probes=7, device=dev)
    same = bool(torch.equal(res_k.ids, res_f.ids))
    print(f"fused filtered_scan path identical to reference: {same}")

    # --- online updates (paper §4.5) ---
    new = torch.as_tensor(synthetic_embeddings(7, 5, d), device=dev)
    new_attrs = torch.as_tensor(
        synthetic_attributes(7, 5, m, cardinalities=[16]), device=dev)
    index2, dropped = add_vectors(
        index, new, new_attrs,
        torch.arange(5, dtype=torch.int32, device=dev) + n)
    found = search_reference(index2, new, match_all(5, m, device=dev), k=1,
                             n_probes=index.n_clusters)
    self_ids = found.ids[:, 0].cpu().tolist()
    print(f"added 5 vectors (dropped={int(dropped)}); "
          f"self-retrieval ids: {self_ids}")
    return dict(recall=recall, filtered_recall=recall_f,
                selectivity=selectivity, fused_identical=same,
                dropped=int(dropped), self_ids=self_ids, n=n)


if __name__ == "__main__":
    main()
