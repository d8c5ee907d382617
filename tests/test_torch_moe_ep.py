"""Expert parallelism over ``torch.distributed`` (the ``mesh`` branch of
``transformer._moe_ffn``) against the reference's ``forward(mesh=...)``.

The port's side: 4 gloo ranks on the CPU as a (data=2, model=2) mesh (a
file rendezvous in the test's temporary directory), each holding its
experts (``local_params``: its half of the experts over ``model`` and its
FSDP half of ``d_model`` over ``data``) and its data shard of the batch.
The reference's side: ``forward(params, cfg, tokens, mesh=...)`` on a
(2, 2) mesh of 4 fake CPU devices in a subprocess (this file run as a
script with ``--reference``), which also runs the mesh-less forward on
each data shard.  deepseek-moe-16b's smoke config with
``fsdp_axis="data"``, both combines (``"psum"`` and ``"scatter"``), and a
capacity factor that drops (token, choice) pairs.

Hidden states within rtol 1e-5, atol 1e-5 of the reference's mesh
forward; each rank's ``n_dropped`` equal to the reference's for its data
shard.  Both multi-process runs end in their own timeouts.
"""

from __future__ import annotations

import dataclasses
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

WORLD, MESH_SHAPE, AXES = 4, (2, 2), ("data", "model")
B, S = 4, 16
TIMEOUT_S = 300  # each of the reference's subprocess and the rank group
PG_TIMEOUT_S = 120
# name: (moe_combine, capacity_factor)
CASES = {"psum": ("psum", 8.0), "scatter": ("scatter", 8.0),
         "psum-drops": ("psum", 0.5), "scatter-drops": ("scatter", 0.5)}
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(mod, name):
    combine, cf = CASES[name]
    cfg = mod.smoke_config()
    return dataclasses.replace(
        cfg, fsdp_axis="data", moe_ep_axes=("model",), moe_combine=combine,
        moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _tokens():
    rng = np.random.default_rng(0)
    return rng.integers(0, 512, (B, S)).astype(np.int32)


def _unflatten(flat):
    tree = {}
    for key, x in flat.items():
        node = tree
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = x
    return tree


# ---- the reference's side (run as a script) ----

def _reference(work: Path):
    import jax

    from repro.configs import deepseek_moe_16b
    from repro.models import transformer as jtr

    assert len(jax.devices()) == WORLD, jax.devices()
    # Auto axes: the reference's sharding constraints are hints, not asserts
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(MESH_SHAPE),
                             AXES)
    tokens = _tokens()
    out = {}
    for name in CASES:
        cfg = _cfg(deepseek_moe_16b, name)
        params = jax.jit(jtr.init_params, static_argnums=1)(
            jax.random.key(0), cfg)
        if name == "psum":
            for path, x in jax.tree_util.tree_flatten_with_path(params)[0]:
                out["params/" + "/".join(p.key for p in path)] = np.asarray(x)
        with jax.set_mesh(mesh):
            h, aux = jax.jit(lambda p, t: jtr.forward(p, cfg, t, mesh=mesh))(
                params, tokens)
        out[f"{name}/h"] = np.asarray(h)
        for d in range(MESH_SHAPE[0]):
            rows = tokens[d * B // 2:(d + 1) * B // 2]
            h1, aux1 = jax.jit(lambda p, t: jtr.forward(p, cfg, t))(params,
                                                                   rows)
            out[f"{name}/h_meshless_{d}"] = np.asarray(h1)
            out[f"{name}/dropped_{d}"] = np.asarray(aux1["moe_dropped"])
    np.savez(work / "reference.npz", **out)


# ---- the port's side: one rank of the spawn group ----

def _rank_main(rank: int, work: str):
    import torch.distributed as dist

    from repro_torch.configs import deepseek_moe_16b
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import transformer as ttr
    from repro_torch.train.checkpoint import params_from_numpy

    torch.set_num_threads(1)
    work = Path(work)
    tmesh.init_process_group(rank, WORLD,
                             init_method=f"file://{work / 'store'}",
                             device="cpu", timeout_s=PG_TIMEOUT_S)
    try:
        mesh = tmesh.make_mesh(MESH_SHAPE, AXES, device_type="cpu")
        ref = np.load(work / "reference.npz")
        params = params_from_numpy(_unflatten(
            {k[len("params/"):]: ref[k] for k in ref.files
             if k.startswith("params/")}), "cpu")
        d = mesh.get_local_rank("data")
        rows = torch.from_numpy(_tokens()[d * B // 2:(d + 1) * B // 2])
        out = {}
        for name in CASES:
            cfg = _cfg(deepseek_moe_16b, name)
            local = ttr.local_params(params, cfg, mesh)
            e_local = local["moe_blocks"]["moe"]["wg"].shape
            with torch.no_grad():
                h, aux = ttr.forward(local, cfg, rows, mesh=mesh)
            out[f"{name}/h"] = h.numpy()
            out[f"{name}/dropped"] = aux["moe_dropped"].numpy()
            out[f"{name}/wg_shape"] = np.asarray(e_local)
        np.savez(work / f"port_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---- the tests ----

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import torch.multiprocessing as mp

    work = tmp_path_factory.mktemp("moe_ep")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__)), "--reference", str(work)],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=env)
    if proc.returncode:
        raise AssertionError(f"the reference failed\nSTDOUT:\n{proc.stdout}"
                             f"\nSTDERR:\n{proc.stderr}")
    ctx = mp.start_processes(_rank_main, args=(str(work),), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):  # re-raises a rank's exception
            if time.monotonic() > deadline:
                raise AssertionError(f"the rank group ran past {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    ref = dict(np.load(work / "reference.npz"))
    port = [dict(np.load(work / f"port_{r}.npz")) for r in range(WORLD)]
    return ref, port


@pytest.mark.parametrize("name", list(CASES))
def test_expert_parallel_forward_matches_reference_mesh_forward(runs, name):
    ref, port = runs
    for rank, got in enumerate(port):
        d = rank // MESH_SHAPE[1]
        want = ref[f"{name}/h"][d * B // 2:(d + 1) * B // 2]
        np.testing.assert_allclose(got[f"{name}/h"], want, **TOL,
                                   err_msg=f"rank {rank}")
        # the mesh forward is the mesh-less forward of the data shard
        np.testing.assert_allclose(got[f"{name}/h"],
                                   ref[f"{name}/h_meshless_{d}"], **TOL)
        assert int(got[f"{name}/dropped"]) == int(ref[f"{name}/dropped_{d}"])
        # 8 experts over model=2, d_model 128 over data=2: [L, 4, 64, 64]
        assert tuple(got[f"{name}/wg_shape"]) == (3, 4, 64, 64)
    if "drops" in name:
        assert int(ref[f"{name}/dropped_0"]) > 0
    else:
        assert all(int(ref[f"{name}/dropped_{d}"]) == 0 for d in range(2))


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference(Path(sys.argv[2]))
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]}")
