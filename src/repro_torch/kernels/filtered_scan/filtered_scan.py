"""Fused tiled filtered IVF scan (paper §4.4 steps 3+4): the wrapper of the
CUDA kernel ``csrc/filtered_scan_tiled.cu``.

The port of ``repro.kernels.filtered_scan.filtered_scan.filtered_scan_tiled``.
The path is chosen by the tensors' device alone: CPU tensors take the plain
PyTorch version (:func:`~repro_torch.kernels.filtered_scan.ref.
filtered_scan_tiled_ref`), CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.filtered_scan.ref import filtered_scan_tiled_ref

SOURCE = build.KERNELS_DIR / "filtered_scan" / "csrc" / "filtered_scan_tiled.cu"

# Kernel launches in this process; the wrapper adds one per launch.
LAUNCHES = 0

MAX_K = 32
_MODES = {"dot": 0, "l2": 1, "sq8": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _lib():
    lib = build.load(SOURCE)
    fn = lib.filtered_scan_tiled_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ci, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, vp,
                       vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def filtered_scan_tiled(
    slot_cluster: torch.Tensor,
    slot_tile: torch.Tensor,
    n_unique: Optional[torch.Tensor],
    queries: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    vectors: torch.Tensor,
    attrs: torch.Tensor,
    ids: torch.Tensor,
    norms: Optional[torch.Tensor] = None,
    scales: Optional[torch.Tensor] = None,
    *,
    metric: str = "dot",
    k: int = 10,
    q_block: int = 64,
):
    """Tiled fused scan with a streaming per-slot top-k.

    Operands:
      slot_cluster [S] int32 — cluster each slot scans
      slot_tile    [S] int32 — query tile each slot serves
      n_unique     [n_tiles] int32 — live slots per tile of a tile-major
                   table (``S = n_tiles·u_cap``); later slots of a tile are
                   dedup pads and are skipped.  None: every slot is live.
      queries  [Qpad, D] — bf16/f32 (f32 under SQ8), Qpad a multiple of
                           q_block; tile t is rows ``[t·QB, (t+1)·QB)``
      lo, hi   [Qpad, F, M] int16 — DNF interval bounds per query
      vectors  [K, Vpad, D] (queries' dtype, or int8 with ``scales``),
      attrs [K, Vpad, M] int16, ids [K, Vpad] int32
      norms / scales [K, Vpad] f32 — l2 / SQ8 row constants

    Returns vals [S, QB, k] f32 (NEG_INF pads), ids [S, QB, k] int32 (-1
    pads), npass [S, QB] int32; pad slots hold (NEG_INF, -1, 0).
    """
    global LAUNCHES
    if metric not in ("dot", "l2"):
        raise ValueError(metric)
    if metric == "l2":
        if norms is None:
            raise ValueError("metric='l2' requires norms")
        if scales is not None:
            raise NotImplementedError("SQ8 + l2 not wired (norms suffice)")
    qpad, d = queries.shape
    if qpad % q_block:
        raise ValueError(f"Qpad={qpad} not a multiple of q_block={q_block}")
    if vectors.device.type == "cpu":
        return filtered_scan_tiled_ref(
            slot_cluster, slot_tile, n_unique, queries, lo, hi, vectors,
            attrs, ids, norms, scales, metric=metric, k=k, q_block=q_block)
    if vectors.device.type != "cuda":
        raise ValueError(f"unsupported device {vectors.device}")
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(f"the CUDA kernel keeps k <= {MAX_K}, got {k}")

    dev = vectors.device
    s = slot_cluster.shape[0]
    kc, vpad, _ = vectors.shape
    f, m = lo.shape[1], lo.shape[2]
    quantized = scales is not None
    i32 = torch.int32
    _check("slot_cluster", slot_cluster, i32, (s,), dev)
    _check("slot_tile", slot_tile, i32, (s,), dev)
    if n_unique is not None:
        _check("n_unique", n_unique, i32, (n_unique.shape[0],), dev)
        if n_unique.shape[0] == 0 or s % n_unique.shape[0]:
            raise ValueError(f"S={s} is not n_tiles={n_unique.shape[0]} "
                             "whole tiles")
    q_dtype = torch.float32 if quantized else vectors.dtype
    _check("queries", queries, q_dtype, (qpad, d), dev)
    _check("lo", lo, torch.int16, (qpad, f, m), dev)
    _check("hi", hi, torch.int16, (qpad, f, m), dev)
    _check("vectors", vectors, torch.int8 if quantized else vectors.dtype,
           (kc, vpad, d), dev)
    if not quantized and vectors.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"vectors: bf16 or f32 expected, got {vectors.dtype}")
    _check("attrs", attrs, torch.int16, (kc, vpad, m), dev)
    _check("ids", ids, i32, (kc, vpad), dev)
    aux = norms if metric == "l2" else scales
    if aux is not None:
        _check("norms" if metric == "l2" else "scales", aux, torch.float32,
               (kc, vpad), dev)

    vals = torch.empty((s, q_block, k), dtype=torch.float32, device=dev)
    out_ids = torch.empty((s, q_block, k), dtype=i32, device=dev)
    npass = torch.empty((s, q_block), dtype=i32, device=dev)
    if s == 0:
        return vals, out_ids, npass
    fn = _lib()
    u_cap = s // n_unique.shape[0] if n_unique is not None else s
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            s, slot_cluster.data_ptr(), slot_tile.data_ptr(),
            None if n_unique is None else n_unique.data_ptr(), u_cap, kc,
            queries.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            vectors.data_ptr(), attrs.data_ptr(), ids.data_ptr(),
            None if aux is None else aux.data_ptr(),
            vals.data_ptr(), out_ids.data_ptr(), npass.data_ptr(),
            q_block, d, vpad, m, f, k,
            _MODES["sq8" if quantized else metric], _DTYPES[q_dtype],
            _DTYPES[vectors.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"filtered_scan_tiled launch failed: cudaError {err}")
    LAUNCHES += 1
    return vals, out_ids, npass
