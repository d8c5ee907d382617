"""The port's serving launcher (``python -m repro_torch.launch.serve``) end to
end on the CPU, at a tiny size, on both tiers.

``main`` builds with ``build_ivf`` over the synthetic data, saves and loads
checkpoints, runs the live-update demo with republishes, the device cache,
sub-partitions and the metrics endpoint, and returns what it served.  On a
checkpoint written by the JAX package's ``save_index``, its responses for
the launcher's own queries are held against the reference's
``SearchServer`` over the reference's ``make_fused_search_fn`` on the same
checkpoint: ids exact, scores rtol 1e-5.  With ``--cache-shards`` the disk
tier fetches through the sharded ring and answers as a single store does.
Without ``--device cpu`` and without CUDA it raises.
"""

import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import serving as jsrv
from repro.core import storage as js
from repro_torch.launch import serve

SMALL = ["--device", "cpu", "--n", "3000", "--dim", "16", "--clusters", "8",
         "--requests", "48", "--batch", "16"]
N, D, M, KC = 1024, 16, 4, 8


def _check(out, capsys, requests=48, batch=16):
    text = capsys.readouterr().out
    assert "QPS" in text and "p99" in text
    assert len(out["responses"]) == requests
    assert out["stats"]["requests"] == requests
    assert out["stats"]["batches"] >= -(-requests // batch)
    assert out["metrics"]["engine.batches"] >= out["stats"]["batches"]
    assert out["queries"].shape == (requests, out["queries"].shape[1])
    for r in out["responses"]:
        assert np.isfinite(r.scores[r.ids >= 0]).all()
    return text


def test_build_path_ram(capsys):
    out = serve.main(SMALL)
    text = _check(out, capsys)
    assert "built index: K=8" in text
    # every response: a database row's own neighbours, self first
    assert all(r.ids[0] >= 0 for r in out["responses"])


def test_disk_tier_save_load_live_updates(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    out = serve.main(SMALL + [
        "--tier", "disk", "--save", ck, "--delta-budget-mb", "1",
        "--compact-every", "16", "--device-cache-mb", "4",
        "--partition-attrs", "0", "--metrics-port", "0"])
    text = _check(out, capsys)
    assert "partitioned checkpoint" in text and "republished (manual)" in text
    assert out["metrics_url"].startswith("http://127.0.0.1:")
    assert out["delta"]["adds"] == 48 and out["delta"]["tombstoned"] == 12
    assert out["delta"]["commits"] >= 2
    assert out["metrics"]["partitions.subs"] > 0
    assert out["metrics"]["device_cache.puts"] > 0
    # the republished checkpoint loads back on both tiers
    for tier in ("ram", "disk"):
        out = serve.main(["--device", "cpu", "--load", ck, "--tier", tier,
                          "--requests", "32", "--batch", "8",
                          "--partitions", "off"])
        _check(out, capsys, requests=32, batch=8)


def test_disk_tier_auto_checkpoint_and_knobs(capsys):
    out = serve.main(SMALL + ["--tier", "disk", "--pipeline", "on",
                              "--resident-budget-mb", "1", "--termination",
                              "exact", "--t-max", "auto", "--prune", "on"])
    text = _check(out, capsys)
    assert "wrote disk-tier checkpoint" in text
    assert out["metrics"]["engine.pipeline"] == "on"


def test_metrics_endpoint_serves_text():
    httpd = serve._start_metrics(lambda: "repro_engine_batches 3\n", 0)
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            assert resp.status == 200
            assert resp.read().decode() == "repro_engine_batches 3\n"
    finally:
        httpd.shutdown()
        httpd.server_close()


@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    """A checkpoint of the JAX package (layout 3, lists without pad rows,
    so the RAM pool holds no all-zero query)."""
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = (np.arange(N) * KC) // N
    core = centers[topic] + 0.1 * rng.standard_normal((N, D)).astype(
        np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    attrs = rng.integers(0, 8, (N, M)).astype(np.int16)
    spec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jnp.float32)
    index, stats = jivf.build_from_assignments(
        spec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic))
    assert stats.vpad == stats.max_list_len == N // KC
    ck = str(tmp_path_factory.mktemp("launch") / "ref")
    js.save_index(index, ck, n_shards=2)
    return ck


@pytest.mark.parametrize("tier", ["ram", "disk"])
def test_load_reference_checkpoint_matches_reference_server(
        reference_ckpt, tier, capsys):
    out = serve.main(["--device", "cpu", "--load", reference_ckpt, "--tier",
                      tier, "--requests", "40", "--batch", "16", "--k", "5",
                      "--probes", "3"])
    _check(out, capsys, requests=40)
    fn = jsrv.make_fused_search_fn(reference_ckpt, k=5, n_probes=3,
                                   q_block=16)
    server = jsrv.SearchServer(fn, batch_size=16, dim=D, n_attrs=M,
                               n_terms=1, n_shards=8)
    server.start()
    try:
        want = [server.submit(q).get(timeout=60) for q in out["queries"]]
    finally:
        server.stop()
        fn.close()
    for got, ref in zip(out["responses"], want):
        np.testing.assert_array_equal(got.ids, ref.ids)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=1e-5)


def test_needs_cuda_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--n", "500", "--dim", "8", "--clusters", "2"])


RING_FLAGS = {  # transport: launcher flags
    "loopback": ["--cache-transport", "loopback"],
    "socket": ["--cache-transport", "socket", "--peer-timeout-s", "5",
               "--cache-fallback", "off", "--probe-interval-s", "1"],
}


@pytest.mark.parametrize("transport", sorted(RING_FLAGS))
def test_cache_shards_serves_single_store_results(reference_ckpt, transport,
                                                  capsys):
    """``--tier disk --cache-shards 2`` fetches through the sharded ring,
    prints the reference's ring line, and answers every request as the
    single-store run does."""
    base = ["--device", "cpu", "--load", reference_ckpt, "--tier", "disk",
            "--requests", "40", "--batch", "16", "--k", "5", "--probes", "3"]
    single = serve.main(base)
    capsys.readouterr()
    out = serve.main(base + ["--cache-shards", "2"] + RING_FLAGS[transport])
    text = _check(out, capsys, requests=40)
    assert (f"sharded cluster cache: 2 nodes ({transport} transport), ring "
            "HashRing") in text
    np.testing.assert_array_equal(out["queries"], single["queries"])
    for got, want in zip(out["responses"], single["responses"]):
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.scores, want.scores)
        assert not got.degraded
    assert out["metrics"]["store.kind"] == "sharded"
    assert out["metrics"]["store.remote_blocks"] > 0
    assert out["metrics"]["store.has_fallback"] == (transport == "loopback")
    assert out["metrics"]["engine.degraded_batches"] == 0
    with pytest.raises(SystemExit):
        serve.main(SMALL + ["--cache-shards", "2"])  # needs --tier disk
