"""Streaming centroid top-T (paper §4.4 step 2): the wrapper of the CUDA
kernel ``csrc/centroid_topk.cu``.

The port of ``repro.kernels.centroid_topk.centroid_topk.centroid_topk``.
The path is chosen by the tensors' device alone: CPU tensors take the plain
PyTorch version (:func:`~repro_torch.kernels.centroid_topk.ref.
centroid_topk_ref`), CUDA tensors launch the kernel or raise.  The TPU
kernel's ``q_block``/``k_block`` were its tiling and have no counterpart:
the CUDA kernel takes any Q and K, and any T up to K.
"""

from __future__ import annotations

import ctypes

import torch

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
    global LAUNCHES
    if metric not in _METRICS:
        raise ValueError(metric)
    q, d = queries.shape
    k = centroids.shape[0]
    if not 1 <= t <= k:
        raise ValueError(f"t={t} must lie in [1, K={k}]")
    if centroids.device.type == "cpu":
        return centroid_topk_ref(queries, centroids, t=t, metric=metric)
    if centroids.device.type != "cuda":
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
