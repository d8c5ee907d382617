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


def axis_size(mesh: DeviceMesh, name: str) -> int:
    """The number of ranks along the mesh axis ``name``."""
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def _on_host_for_gloo(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` where ``group``'s backend can take it: gloo's tensor
    collectives run on host tensors."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.cpu()
    return x


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over a process group whose backward is the
    identity: every rank of the group computes the same loss from the
    reduced value, so a rank's share of the gradient is the incoming one
    (the reference's ``psum`` under ``shard_map`` differentiates so).
    ``torch.distributed.nn``'s all-reduce would sum the replicated
    gradients again, scaling them by the group's size."""

    @staticmethod
    def forward(ctx, x, group):
        y = _on_host_for_gloo(x, group).clone()
        dist.all_reduce(y, group=group)
        return y.to(x.device)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the gradient passes through unchanged."""
    return _SumOverGroup.apply(x, group)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        y = _on_host_for_gloo(x, group).contiguous()
        parts = [torch.empty_like(y)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        rank = dist.get_rank(ctx.group)
        return torch.chunk(grad, n, dim=ctx.dim)[rank], None, None


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        y = _on_host_for_gloo(x, group)
        chunks = [c.contiguous() for c in torch.chunk(y, n, dim=dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=group)
        return out.to(x.device)

    @staticmethod
    def backward(ctx, grad):
        return _GatherDim.apply(grad, ctx.group, ctx.dim), None, None


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x``s concatenated along ``dim`` in group-rank order
    (the reference's ``all_gather(..., tiled=True)``).  Its backward takes
    this rank's chunk of the gradient, the convention of
    :func:`all_reduce_sum` (what follows is replicated over the group)."""
    return _GatherDim.apply(x, group, dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``x`` summed over ``group`` (the
    reference's ``psum_scatter(..., tiled=True)``); its backward
    all-gathers the gradient."""
    return _ScatterDim.apply(x, group, dim)
