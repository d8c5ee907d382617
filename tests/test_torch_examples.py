"""The port's examples (``examples/torch/``) at a tiny size on the CPU, each
with the claims it prints held, and each refusing to start without CUDA
unless ``--device cpu`` is given.

``examples/torch`` is a directory named ``torch``: the examples are loaded
by file path, never through ``sys.path``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ("quickstart", "kmeans_index_build", "filtered_search_serving",
            "train_embedder", "recsys_retrieval")


def _load(name: str):
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_cuda_unless_cpu_is_asked(name, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main([])


def test_quickstart():
    out = _load("quickstart").main(["--device", "cpu", "--n", "5000"])
    assert out["fused_identical"]
    assert out["dropped"] == 0
    assert out["self_ids"] == list(range(5000, 5005))
    assert out["recall"] > 0.3 and 0 < out["selectivity"] < 0.05


def test_kmeans_index_build():
    out = _load("kmeans_index_build").main(["--device", "cpu", "--n", "8000"])
    assert out["lloyd"]["recall"] >= out["minibatch"]["recall"]
    assert out["restored_recall"] == out["lloyd"]["recall"]
    assert out["restored_k"] == 80 and out["n_live"] == 8000


def test_filtered_search_serving():
    """Every part's own checks run inside ``main`` (a failed one raises):
    responses equal to the engine's, disk / device cache / ring / routed
    ids equal to the RAM tier's or the flat plan's, ``exact`` termination
    equal to the untruncated search, live adds and deletes served."""
    out = _load("filtered_search_serving").main(
        ["--device", "cpu", "--n", "8000", "--requests", "48",
         "--term-n", "4000", "--part-n", "6000"])
    assert out["responses_equal"] and out["batches"] >= 2
    assert out["n_pruned"] > 0 and out["device_hits"] > 0
    assert out["failovers"] >= 1 and out["fallback_blocks"] > 0
    assert out["clusters_rewritten"] > 0
    assert out["routed_rows"] < out["flat_rows"]
    sweep = {label: recall for label, _, recall, _, _ in out["termination"]}
    assert sweep["exact"] == 1.0


def test_train_embedder(tmp_path):
    out = _load("train_embedder").main(
        ["--device", "cpu", "--steps", "60", "--corpus", "3000",
         "--ckpt-dir", str(tmp_path)])
    losses = out["losses"]
    assert out["steps"] == list(range(1, 61))
    assert losses[-1] < losses[0] / 10
    assert out["recall"] >= 0.6 and out["hit1"] >= 0.85
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_20", "step_40", "step_60"]


def test_recsys_retrieval():
    out = _load("recsys_retrieval").main(["--device", "cpu",
                                          "--items", "20000"])
    assert out["filters_ok"] and out["n_cand"] == 100
    assert 0 < out["recall"] <= 1
    assert (np.asarray(out["ids"]) >= 0).all()
