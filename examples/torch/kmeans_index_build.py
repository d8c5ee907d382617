"""Index build: MiniBatchKMeans against Lloyd, the quality/time trade-off
(paper §5.2/§5.4), then a sharded save and an elastic restore — on the
card through the port; the counterpart of ``examples/kmeans_index_build.py``.

    PYTHONPATH=src python examples/torch/kmeans_index_build.py
    PYTHONPATH=src python examples/torch/kmeans_index_build.py --device cpu \\
        --n 8000

It runs on the CUDA card unless ``--device cpu`` is given, and raises where
CUDA is absent.  ``main`` returns each mode's recall and build seconds and
the recall after the restore.
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import (
    HybridSpec,
    brute_force,
    build_ivf,
    match_all,
    recall_at_k,
    storage,
)
from repro_torch.core.search import search_reference
from repro_torch.data import synthetic_attributes, synthetic_embeddings
from repro_torch.device import resolve_device


def eval_recall(index, core, attrs, q=32, k=10, t=7):
    rng = np.random.default_rng(9)
    queries = core[torch.as_tensor(rng.integers(0, len(core), q),
                                   device=core.device)]
    fspec = match_all(q, index.spec.n_attrs, device=core.device)
    res = search_reference(index, queries, fspec, k=k, n_probes=t)
    oracle = brute_force(core, attrs, queries, fspec, k=k)
    return recall_at_k(res, oracle)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=80_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n, d, m = args.n, 64, 6
    core = torch.as_tensor(synthetic_embeddings(0, n, d), device=dev)
    attrs = torch.as_tensor(synthetic_attributes(0, n, m, cardinalities=[8]),
                            device=dev)
    spec = HybridSpec(dim=d, n_attrs=m, core_dtype=torch.float32)

    print("paper §5.4: MiniBatchKMeans is faster to build, Lloyd recalls "
          "better at equal T —")
    out = {}
    for mode, steps in (("minibatch", 60), ("lloyd", 12)):
        t0 = time.time()
        index, stats = build_ivf(
            torch.Generator(dev).manual_seed(0), spec, core, attrs,
            n_clusters=80, kmeans_mode=mode, kmeans_steps=steps, device=dev,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.time() - t0
        rec = eval_recall(index, core, attrs)
        out[mode] = dict(recall=rec, build_s=dt,
                         max_list=stats.max_list_len)
        print(f"  {mode:10s}: build {dt:6.1f}s  recall@10(T=7) {rec:.3f}  "
              f"max list {stats.max_list_len}")

    # --- durability + elastic restore (DESIGN §4 fault tolerance) ---
    with tempfile.TemporaryDirectory() as tmp:
        storage.save_index(index, tmp, n_shards=4)
        man = storage.load_manifest(tmp)
        print(f"saved {man['n_shards']} shards, {man['n_live']} vectors")
        restored = storage.load_index(tmp, target_shards=8, device=dev)
        rec2 = eval_recall(restored, core, attrs)
        print(f"restored for 8 shards (K padded to "
              f"{restored.n_clusters}): recall unchanged {rec2:.3f}")
    out.update(restored_recall=rec2, restored_k=restored.n_clusters,
               n_live=int(man["n_live"]))
    return out


if __name__ == "__main__":
    main()
