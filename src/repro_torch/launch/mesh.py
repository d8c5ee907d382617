"""Meshes and process groups: the port of ``repro.launch.mesh``.

Single pod: 256 chips as (data=16, model=16).
Multi-pod:  2 pods × 256 chips as (pod=2, data=16, model=16) — the "pod"
axis carries data parallelism across the slower inter-pod links; "model"
carries the cluster shards' first merge stage over the fast intra-pod links.

A mesh here is a ``torch.distributed`` :class:`DeviceMesh` over the ranks of
the default process group, laid out row-major (rank ``r`` sits at the mesh
coordinate whose row-major index is ``r``).  JAX's single controller needs
no start-up; here every rank calls :func:`init_process_group` first:

    backend = init_process_group(rank, world_size,
                                 init_method="tcp://localhost:29500")
    mesh = make_mesh((2, 3), ("data", "model"))

Functions, not module constants: importing this module touches no device
and no process group.
"""

from __future__ import annotations

import datetime
import logging
import math
import os
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device

log = logging.getLogger(__name__)


def choose_backend(world_size: int, device_type: str) -> str:
    """NCCL where every rank has a card of its own, else gloo.

    NCCL refuses two ranks on one device, so ranks that share a card (or
    run on the CPU) take gloo; gloo moves CUDA tensors through the host.
    """
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_process_group(rank: int, world_size: int, *, init_method: str,
                       device="cuda", timeout_s: float = 300.0) -> str:
    """Starts this rank's default process group and returns its backend.

    ``init_method`` is the rendezvous (``tcp://host:port`` or
    ``file:///path``); ``timeout_s`` bounds every collective, so a rank that
    hangs ends the run with an error instead of holding the others.  On
    CUDA the rank's card is its local rank (``LOCAL_RANK``, as a launcher
    such as ``torchrun`` sets it, else ``rank``) modulo the cards present.
    The backend follows :func:`choose_backend`.
    """
    dev = resolve_device(device)
    backend = choose_backend(world_size, dev.type)
    if dev.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    log.info("rank %d of %d: %s backend on %s (%d cards)", rank, world_size,
             backend, dev.type,
             torch.cuda.device_count() if dev.type == "cuda" else 0)
    return backend


def make_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A row-major mesh of ``shape`` over the first ``prod(shape)`` ranks;
    raises when the world has fewer."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, have {world}: start the process "
            "group with that many ranks first")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def dp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The data-parallel axes of a production mesh."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def n_chips(mesh: DeviceMesh) -> int:
    return mesh.mesh.numel()
