"""Fused filtered IVF scans (paper §4.4 steps 3+4): the wrappers of the
CUDA kernels ``csrc/filtered_scan_tiled.cu`` and ``csrc/filtered_scan.cu``.

The port of ``repro.kernels.filtered_scan.filtered_scan``'s two kernels:
:func:`filtered_scan_tiled` (query tiles against deduplicated probe slots,
with a streaming top-k) and :func:`filtered_scan` (one query against one
cluster per slot, emitting the masked ``[P, Vpad]`` scores), plus
:func:`fold_running_topk`, the bound-driven executor's fold of a scanned
slot segment into the per-query running top-k (plain torch ops, as the
reference's is plain XLA).  The path is
chosen by the tensors' device alone: CPU tensors take the plain PyTorch
versions in :mod:`~repro_torch.kernels.filtered_scan.ref`, CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.topk import NEG_INF, top_k
from repro_torch.kernels import build
from repro_torch.kernels.filtered_scan.ref import (
    filtered_scan_ref,
    filtered_scan_tiled_ref,
)

SOURCE = build.KERNELS_DIR / "filtered_scan" / "csrc" / "filtered_scan_tiled.cu"
PER_PROBE_SOURCE = build.KERNELS_DIR / "filtered_scan" / "csrc" / "filtered_scan.cu"

# Kernel launches in this process; each wrapper adds one per launch of its
# kernel: LAUNCHES for filtered_scan_tiled, PER_PROBE_LAUNCHES for
# filtered_scan.
LAUNCHES = 0
PER_PROBE_LAUNCHES = 0

_MODES = {"dot": 0, "l2": 1, "sq8": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _bind(src, name, argtypes):
    fn = getattr(build.load(src), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_VP, _CI = ctypes.c_void_p, ctypes.c_int


def _lib():
    return _bind(SOURCE, "filtered_scan_tiled_launch",
                 [_CI, _VP, _VP, _VP, _CI, _CI, _VP, _VP, _VP, _VP, _VP, _VP,
                  _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _CI, _CI, _CI, _CI,
                  _CI, _VP])


def tiled_body(d: int, m: int, f: int, metric: str, q_dtype: torch.dtype,
               v_dtype: torch.dtype) -> str:
    """Which body of the CUDA ``filtered_scan_tiled`` serves these operands:
    "tensor_cores" (bf16 vectors: mma.sync, f32 queries split into three
    bf16 terms) or "fma" (f32 x f32, SQ8, and bf16 shapes whose resident
    query tile does not fit in shared memory).  Builds the kernel."""
    fn = _bind(SOURCE, "filtered_scan_tiled_body", [_CI] * 6)
    mode = "sq8" if v_dtype == torch.int8 else metric
    body = fn(d, m, f, _MODES[mode], _DTYPES[q_dtype], _DTYPES[v_dtype])
    if body < 0:
        raise TypeError(f"{q_dtype} x {v_dtype} ({mode}) is not a pair the "
                        "kernel takes")
    return "tensor_cores" if body else "fma"


def _per_probe_lib():
    """(launch, scratch bytes) of the per-probe kernel."""
    scratch = build.load(PER_PROBE_SOURCE).filtered_scan_scratch_bytes
    if scratch.argtypes is None:
        scratch.argtypes = [_CI]
        scratch.restype = ctypes.c_longlong
    return _bind(PER_PROBE_SOURCE, "filtered_scan_launch",
                 [_CI, _VP, _VP, _CI, _CI, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                  _VP, _CI, _CI, _CI, _CI, _CI, _CI, _CI, _VP, _VP]), scratch


def _check_metric(metric, norms, scales):
    if metric not in ("dot", "l2"):
        raise ValueError(metric)
    if metric == "l2":
        if norms is None:
            raise ValueError("metric='l2' requires norms")
        if scales is not None:
            raise NotImplementedError("SQ8 + l2 not wired (norms suffice)")


def _check_dtypes(queries, vectors, quantized):
    """The (query, vector) dtype pairs the kernels take: equal f32 or bf16,
    f32 queries against bf16 vectors, or f32 queries against SQ8 int8."""
    if quantized:
        ok = queries.dtype == torch.float32 and vectors.dtype == torch.int8
    else:
        ok = (vectors.dtype in (torch.float32, torch.bfloat16)
              and queries.dtype in (vectors.dtype, torch.float32))
    if not ok:
        raise TypeError(f"queries {queries.dtype} against vectors "
                        f"{vectors.dtype}{' (SQ8)' if quantized else ''} "
                        "is not a pair the kernel takes")


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
      slot_cluster [S] int32 — cluster each slot scans; a cluster outside
                   ``[0, K)`` marks a pad slot, which is skipped
      slot_tile    [S] int32 — query tile each slot serves
      n_unique     [n_tiles] int32 — live slots per tile of a tile-major
                   table (``S = n_tiles·u_cap``); later slots of a tile are
                   dedup pads and are skipped.  None: every slot is live.
      queries  [Qpad, D] — the vectors' dtype or f32 (f32 under SQ8), Qpad
                           a multiple of q_block; tile t is rows
                           ``[t·QB, (t+1)·QB)``
      lo, hi   [Qpad, F, M] int16 — DNF interval bounds per query
      vectors  [K, Vpad, D] f32/bf16, or int8 with ``scales``,
      attrs [K, Vpad, M] int16, ids [K, Vpad] int32
      norms / scales [K, Vpad] f32 — l2 / SQ8 row constants

    Returns vals [S, QB, k] f32 (NEG_INF pads), ids [S, QB, k] int32 (-1
    pads), npass [S, QB] int32; pad slots hold (NEG_INF, -1, 0).  Any
    k >= 1: where k exceeds the block's height (a routed tile of short
    sub-partition records) the list past Vpad holds (NEG_INF, -1), as the
    reference kernel's running fold leaves it.
    """
    global LAUNCHES
    _check_metric(metric, norms, scales)
    _check_dtypes(queries, vectors, scales is not None)
    qpad, d = queries.shape
    if qpad % q_block:
        raise ValueError(f"Qpad={qpad} not a multiple of q_block={q_block}")
    if vectors.device.type == "cpu":
        return filtered_scan_tiled_ref(
            slot_cluster, slot_tile, n_unique, queries, lo, hi, vectors,
            attrs, ids, norms, scales, metric=metric, k=k, q_block=q_block)
    if vectors.device.type != "cuda":
        raise ValueError(f"unsupported device {vectors.device}")
    dev = vectors.device
    s = slot_cluster.shape[0]
    kc, vpad, _ = vectors.shape
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    k_out, k = k, min(k, vpad)  # the kernel selects at most Vpad rows
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
    _check("queries", queries, queries.dtype, (qpad, d), dev)
    _check("lo", lo, torch.int16, (qpad, f, m), dev)
    _check("hi", hi, torch.int16, (qpad, f, m), dev)
    _check("vectors", vectors, vectors.dtype, (kc, vpad, d), dev)
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
            _MODES["sq8" if quantized else metric], _DTYPES[queries.dtype],
            _DTYPES[vectors.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"filtered_scan_tiled launch failed: cudaError {err}")
    LAUNCHES += 1
    if k_out > k:
        vals, out_ids = _pad_lists(vals, out_ids, k_out)
    return vals, out_ids, npass


def _pad_lists(vals, ids, k):
    """Widens [..., k'] lists to k entries of (NEG_INF, -1)."""
    shape = tuple(vals.shape[:-1]) + (k - vals.shape[-1],)
    return (torch.cat([vals, vals.new_full(shape, NEG_INF)], -1),
            torch.cat([ids, ids.new_full(shape, -1)], -1))


def fold_running_topk(run_vals: torch.Tensor, run_ids: torch.Tensor,
                      svals: torch.Tensor, sids: torch.Tensor,
                      alive: torch.Tensor, *, k: int):
    """Folds one scanned slot segment into the per-query running top-k.

    ``run_vals/run_ids [QB, k]`` the running lists, ``svals/sids [S, QB,
    k]`` the segment's per-slot fragments, ``alive [QB, S]`` bool the
    (query, slot) pairs still scheduled: dropped pairs are masked, so the
    running kth reflects only the surviving probes.  One selection over
    ``[QB, k + S·k]`` with the earliest position winning ties (the
    reference's ``lax.top_k`` order).  Stays on the tensors' device: only
    the kth column crosses to the host at a segment boundary.
    """
    qb = svals.shape[1]
    live = alive.T[:, :, None]  # [S, QB, 1]
    vals = torch.where(live, svals, NEG_INF).movedim(0, 1).reshape(qb, -1)
    ids = torch.where(live, sids, -1).movedim(0, 1).reshape(qb, -1)
    vals = torch.cat([run_vals, vals], dim=1)
    ids = torch.cat([run_ids, ids], dim=1)
    new_vals, idx = top_k(vals, k)
    return new_vals, torch.gather(ids, 1, idx)


def filtered_scan(
    slot_cluster: torch.Tensor,
    slot_query: torch.Tensor,
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
) -> torch.Tensor:
    """Per-(query, probe) fused scan.  Returns masked scores [P, Vpad] f32.

    Operands:
      slot_cluster [P] int32 — cluster each slot scans
      slot_query   [P] int32 — query row each slot serves
      queries  [Q, D] — the vectors' dtype or f32 (f32 under SQ8)
      lo, hi   [Q, F, M] int16 — DNF interval bounds per query
      vectors  [K, Vpad, D] f32/bf16, or int8 with ``scales``,
      attrs [K, Vpad, M] int16, ids [K, Vpad] int32
      norms / scales [K, Vpad] f32 — l2 / SQ8 row constants

    Row v of slot p holds ``score(queries[slot_query[p]], vectors[
    slot_cluster[p], v])`` (dot; SQ8 dot times the row scale; l2 as
    ``2·dot − ‖v‖²``, the per-query ``−‖q‖²`` left to the caller), or
    NEG_INF where the row fails the filter or is dead; a slot whose cluster
    or query is out of range gets a row of NEG_INF.  Every slot's row is
    written, pads included, and each distinct (cluster, query) pair is
    computed once: the CUDA kernel plans on the card which slots share a
    pair and reads each distinct cluster's rows once.
    """
    global PER_PROBE_LAUNCHES
    _check_metric(metric, norms, scales)
    _check_dtypes(queries, vectors, scales is not None)
    if vectors.device.type == "cpu":
        return filtered_scan_ref(
            slot_cluster, slot_query, queries, lo, hi, vectors, attrs, ids,
            norms, scales, metric=metric)
    if vectors.device.type != "cuda":
        raise ValueError(f"unsupported device {vectors.device}")

    dev = vectors.device
    p = slot_cluster.shape[0]
    kc, vpad, d = vectors.shape
    nq = queries.shape[0]
    f, m = lo.shape[1], lo.shape[2]
    quantized = scales is not None
    i32 = torch.int32
    _check("slot_cluster", slot_cluster, i32, (p,), dev)
    _check("slot_query", slot_query, i32, (p,), dev)
    _check("queries", queries, queries.dtype, (nq, d), dev)
    _check("lo", lo, torch.int16, (nq, f, m), dev)
    _check("hi", hi, torch.int16, (nq, f, m), dev)
    _check("vectors", vectors, vectors.dtype, (kc, vpad, d), dev)
    _check("attrs", attrs, torch.int16, (kc, vpad, m), dev)
    _check("ids", ids, i32, (kc, vpad), dev)
    aux = norms if metric == "l2" else scales
    if aux is not None:
        _check("norms" if metric == "l2" else "scales", aux, torch.float32,
               (kc, vpad), dev)

    out = torch.empty((p, vpad), dtype=torch.float32, device=dev)
    if p == 0:
        return out
    fn, scratch_bytes = _per_probe_lib()
    # the kernel's schedule: slots grouped by cluster, pairs, chunks
    scratch = torch.empty((scratch_bytes(p) // 4,), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            p, slot_cluster.data_ptr(), slot_query.data_ptr(), kc, nq,
            queries.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            vectors.data_ptr(), attrs.data_ptr(), ids.data_ptr(),
            None if aux is None else aux.data_ptr(), out.data_ptr(),
            d, vpad, m, f, _MODES["sq8" if quantized else metric],
            _DTYPES[queries.dtype], _DTYPES[vectors.dtype],
            scratch.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"filtered_scan launch failed: cudaError {err}")
    PER_PROBE_LAUNCHES += 1
    return out
