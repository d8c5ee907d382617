"""``sharded_embedding_bag`` on 2 gloo CPU ranks against the reference's
``shard_map`` + ``psum`` on 2 fake JAX devices, rtol 1e-6.

The reference's side runs in a subprocess (this file as a script with
``--reference DIR``, 2 fake CPU devices as a (data=1, model=2) mesh); the
port's side is one spawn group of 2 ranks (a file rendezvous in the test's
temporary directory) on a (data=1, model=2) ``DeviceMesh``, each holding
its half of the table's vocabulary.  Both end in their own timeouts.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
WORLD, MESH_SHAPE, AXES = 2, (1, 2), ("data", "model")
V, D = 40, 6
TIMEOUT_S = 240
MODES = ("sum", "mean")


def make_data(seed=0):
    """A table and bags of ids over both halves of the vocabulary, with
    padding and an all-padding bag."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, (6, 5)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.25] = -1
    ids[2] = -1
    ids[3] = rng.integers(0, V // 2, 5)  # one shard's range only
    return table, ids


def _reference(work: Path):
    import jax
    import jax.numpy as jnp

    from repro.models.recsys import sharded_embedding_bag

    assert len(jax.devices()) == WORLD, jax.devices()
    mesh = jax.make_mesh(MESH_SHAPE, AXES)
    jax.set_mesh(mesh)  # jax.grad of the shard_map needs the mesh context
    table, ids = make_data()
    out = {}
    for mode in MODES:
        def fn(t):
            return sharded_embedding_bag(t, jnp.asarray(ids), mesh,
                                         mode=mode)
        out[mode] = np.asarray(fn(jnp.asarray(table)))
        out[f"{mode}/grad"] = np.asarray(jax.grad(
            lambda t: fn(t).sum())(jnp.asarray(table)))
    np.savez(work / "reference.npz", **out)


def _rank_main(rank: int, work: str):
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.recsys import sharded_embedding_bag

    torch.set_num_threads(1)
    work = Path(work)
    tmesh.init_process_group(rank, WORLD,
                             init_method=f"file://{work / 'store'}",
                             device="cpu", timeout_s=TIMEOUT_S)
    try:
        mesh = tmesh.make_mesh(MESH_SHAPE, AXES, device_type="cpu")
        table, ids = make_data()
        v_local = V // WORLD
        shard = torch.from_numpy(table[rank * v_local:(rank + 1) * v_local])
        out = {}
        for mode in MODES:
            local = shard.clone().requires_grad_(True)
            got = sharded_embedding_bag(local, torch.from_numpy(ids), mesh,
                                        mode=mode, device="cpu")
            out[mode] = got.detach().numpy()
            (grad,) = torch.autograd.grad(got.sum(), local)
            out[f"{mode}/grad"] = grad.numpy()
        np.savez(work / f"port_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    work = tmp_path_factory.mktemp("recsys_sharded")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__)), "--reference", str(work)],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=env)
    if proc.returncode:
        raise AssertionError(f"reference failed\n{proc.stdout}\n{proc.stderr}")
    ctx = mp.start_processes(_rank_main, args=(str(work),), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):  # re-raises a rank's exception
            if time.monotonic() > deadline:
                raise AssertionError(f"the ranks ran past {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    ref = dict(np.load(work / "reference.npz"))
    port = [dict(np.load(work / f"port_{r}.npz")) for r in range(WORLD)]
    return ref, port


@pytest.mark.parametrize("mode", MODES)
def test_sharded_embedding_bag_matches_reference_shard_map(runs, mode):
    ref, port = runs
    for got in port:
        assert got[mode].shape == ref[mode].shape == (6, D)
        np.testing.assert_allclose(got[mode], ref[mode], rtol=1e-6,
                                   atol=1e-7)
    assert not ref[mode][2].any()  # the all-padding bag


@pytest.mark.parametrize("mode", MODES)
def test_sharded_embedding_bag_gradient_is_the_shards_rows(runs, mode):
    """The gradient of the (replicated) sum on each rank is its vocabulary
    range of the reference's ``jax.grad`` through the ``shard_map``, which
    equals the unsharded bag's gradient."""
    ref, port = runs
    v_local = V // WORLD
    for rank, got in enumerate(port):
        np.testing.assert_allclose(
            got[f"{mode}/grad"],
            ref[f"{mode}/grad"][rank * v_local:(rank + 1) * v_local],
            rtol=1e-6, atol=1e-7)


def test_sharded_embedding_bag_needs_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.models.recsys import sharded_embedding_bag

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table, ids = make_data()
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded_embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                              mesh=None)
    with pytest.raises(ValueError, match="max"):
        sharded_embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                              mesh=None, mode="max", device="cpu")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--reference":
        _reference(Path(sys.argv[2]))
    else:
        sys.exit(f"usage: {sys.argv[0]} --reference DIR")
