"""Streaming centroid top-T (paper §4.4 step 2): the wrapper of the CUDA
kernel ``csrc/centroid_topk.cu``.

The port of ``repro.kernels.centroid_topk.centroid_topk.centroid_topk``.
The wrapper checks the operands and calls the custom op
``repro_torch::centroid_topk`` (``torch.ops.repro_torch.centroid_topk``)
on either device; the tensors' device alone picks the op's
implementation: on CUDA tensors it builds and launches the kernel and
counts the launch (or raises), on CPU tensors it is the plain PyTorch
version (:func:`~repro_torch.kernels.centroid_topk.ref.
centroid_topk_ref`), and under ``FakeTensorMode`` (``launch.dryrun``) its
fake implementation gives the output shapes alone, on either device, with
no card, no build and no count.  The TPU
kernel's ``q_block``/``k_block`` were its tiling and have no counterpart:
the CUDA kernel takes any Q and K, and any T up to K.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.centroid_topk.ref import centroid_topk_ref

SOURCE = build.KERNELS_DIR / "centroid_topk" / "csrc" / "centroid_topk.cu"

# Kernel launches in this process; the wrapper adds one per launch.
LAUNCHES = 0

_METRICS = {"dot": 0, "l2": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.load(SOURCE)
    fn = lib.centroid_topk_launch
    chunks, list_len = lib.centroid_topk_chunks, lib.centroid_topk_list_len
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
        for g in (chunks, list_len):
            g.argtypes = [ci]
            g.restype = ci
    return fn, chunks, list_len


def centroid_topk(queries: torch.Tensor, centroids: torch.Tensor, *, t: int,
                  metric: str = "dot"):
    """Each query's T best centroids without the ``[Q, K]`` score matrix.

    queries [Q, D] and centroids [K, D], f32 or bf16, scored in f32 as
    ``q·c`` (dot) or ``2·q·c − ‖c‖²`` (l2).  Returns (values [Q, T] f32,
    ids [Q, T] int32); ties go to the lower centroid id.
    """
    if metric not in _METRICS:
        raise ValueError(metric)
    q, d = queries.shape
    k = centroids.shape[0]
    if not 1 <= t <= k:
        raise ValueError(f"t={t} must lie in [1, K={k}]")
    if centroids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {centroids.device}")
    dev = centroids.device
    for name, x, shape in (("queries", queries, (q, d)),
                           ("centroids", centroids, (k, d))):
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name}: f32 or bf16 expected, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name}: on {x.device}, expected {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")

    return torch.ops.repro_torch.centroid_topk(queries, centroids, t, metric)


@torch.library.custom_op("repro_torch::centroid_topk", mutates_args=(),
                         device_types="cuda")
def _centroid_topk_op(queries: torch.Tensor, centroids: torch.Tensor, t: int,
                      metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    return launch(queries, centroids, t, metric)


def launch(queries, centroids, t: int, metric: str):
    """The op's CUDA implementation, callable without the dispatcher (so
    that the op's call overhead can be timed beside it): one build
    (cached) and one launch, counted."""
    global LAUNCHES
    q, d = queries.shape
    k = centroids.shape[0]
    dev = centroids.device
    vals = torch.empty((q, t), dtype=torch.float32, device=dev)
    ids = torch.empty((q, t), dtype=torch.int32, device=dev)
    if q == 0:
        return vals, ids
    fn, chunks, list_len = _lib()
    # each K chunk's top-min(T, 128), merged by the kernel's second pass
    part = (q, chunks(k), list_len(t))
    part_vals = torch.empty(part, dtype=torch.float32, device=dev)
    part_ids = torch.empty(part, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q, k, d, t, queries.data_ptr(), centroids.data_ptr(),
                 part_vals.data_ptr(), part_ids.data_ptr(), vals.data_ptr(),
                 ids.data_ptr(), _METRICS[metric],
                 _DTYPES[queries.dtype], _DTYPES[centroids.dtype], stream)
    if err != 0:
        raise RuntimeError(f"centroid_topk launch failed: cudaError {err}")
    LAUNCHES += 1
    return vals, ids


@_centroid_topk_op.register_kernel("cpu")
def _centroid_topk_cpu(queries, centroids, t, metric):
    vals, ids = centroid_topk_ref(queries, centroids, t=t, metric=metric)
    return vals.contiguous(), ids.contiguous()


@_centroid_topk_op.register_fake
def _centroid_topk_fake(queries, centroids, t, metric):
    shape = (queries.shape[0], t)
    return (queries.new_empty(shape, dtype=torch.float32),
            queries.new_empty(shape, dtype=torch.int32))


@register_flop_formula(torch.ops.repro_torch.centroid_topk)
def _centroid_topk_flops(queries_shape, centroids_shape, *args, **kwargs):
    """The scores' multiply-adds, as the plain version's ``[Q, K]`` product
    counts them (``torch.utils.flop_counter``)."""
    return 2 * queries_shape[0] * centroids_shape[0] * queries_shape[1]
