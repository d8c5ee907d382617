"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback (1-bit-Adam-style residual correction);
the port of ``repro.distributed.compression``.

Compressing the cross-pod gradient all-reduce 4× (f32 → int8 with a
per-tensor scale) trades a little optimizer noise for 4× less traffic on
the slow links.  Error feedback keeps the quantization bias out of the
trajectory: the residual ``g − Q(g)`` is carried into the next step, so the
accumulated applied gradient is unbiased.

    g_mean, err = compressed_psum_tree(grads, err, group, n_replicas)

The all-reduce runs on the dequantized values, as the reference's ``psum``
does; the traffic accounting (:func:`compression_ratio`) uses the int8
width.  A tree is a tensor or nested dicts, lists and tuples of tensors.
No kernel stands behind this module: it is plain tensor arithmetic.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q int8, scale f32 scalar)."""
    x32 = x.float()
    amax = x32.abs().max()
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, which would not round as the reference does
    scale = torch.clamp(amax, min=1e-12) / torch.tensor(127.0,
                                                        device=x.device)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_feedback(params) -> Any:
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def compressed_psum_tree(grads: Any, err: Any, group, n_replicas: int
                         ) -> Tuple[Any, Any]:
    """Quantizes ``grad + residual``, all-reduces (SUM) over ``group``,
    divides by ``n_replicas``; returns (mean grad, residual').

    With ``group=None`` (one replica) this is the identity-plus-quantization
    path, so tests can check the error-feedback algebra exactly.
    """
    g_leaves, spec = pytree.tree_flatten(grads)
    e_leaves = pytree.tree_leaves(err)
    g_out, e_out = [], []
    for g, e in zip(g_leaves, e_leaves, strict=True):
        corrected = g.float() + e
        q, scale = quantize_int8(corrected)
        deq = dequantize_int8(q, scale)
        e_out.append(corrected - deq)
        if group is not None:
            dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
            deq = deq / torch.tensor(float(n_replicas), device=deq.device)
        g_out.append(deq.to(g.dtype))
    return (pytree.tree_unflatten(g_out, spec),
            pytree.tree_unflatten(e_out, spec))


def compression_ratio(params) -> float:
    """Wire-bytes ratio of int8 + scale against f32 for the tree."""
    leaves = pytree.tree_leaves(params)
    f32 = sum(p.numel() * 4 for p in leaves)
    i8 = sum(p.numel() * 1 + 4 for p in leaves)
    return f32 / i8
