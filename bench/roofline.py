"""The least time a batch's tiled scan needs on one H100, from its inputs.

A frozen rework of ``chip_smoke.py::tiled_bound``: that counted from the
program's own plan (its live slots, its padded ``QB x Vpad`` tiles, the
bf16 products its body keeps), so a change to the program moved it.  This
counts what the inputs need, from the reference's probe sets:

- bytes, each read once: the live rows of the distinct clusters that the
  batch's probe sets reach and that hold a row passing some probing query's
  filter (a row: its vector, its scale under SQ8 and ``M`` int16
  attributes; its id is looked up only for the answers), the queries (in
  the width the rows are scored in: bf16 against bf16 rows, f32 against
  int8 rows), the filter bounds, and the ``[Q, k]`` f32 scores and int32
  ids written;
- operations: ``2 * D`` for each (query, live row of its probes) pair.

The least time is max(bytes / HBM peak, operations / bf16 tensor-core
peak): the published dense peaks of one H100 SXM at its 700 W limit.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
VALUE_BYTES = {"bf16": 2, "sq8": 1}
SCALE_BYTES = {"bf16": 0, "sq8": 4}
QUERY_BYTES = {"bf16": 2, "sq8": 4}


def row_bytes(cfg: dict) -> int:
    return (cfg["dim"] * VALUE_BYTES[cfg["store"]] + SCALE_BYTES[cfg["store"]]
            + cfg["n_attrs"] * 2)


def least_seconds(cfg: dict, k: int, probes: torch.Tensor,
                  sizes: torch.Tensor, passing: torch.Tensor,
                  n_terms: int = 1) -> dict:
    """One batch: ``probes [Q, T]`` its queries' probe sets, ``sizes [K]``
    every cluster's live rows, ``passing [Q, T]`` whether a probed cluster
    holds a row passing the query's filter.  Returns the bytes, the
    operations, the least seconds and what bounds them."""
    q = probes.shape[0]
    d, m = cfg["dim"], cfg["n_attrs"]
    reached = torch.unique(probes[passing])
    data = int(sizes[reached].sum()) * row_bytes(cfg)
    small = (q * d * QUERY_BYTES[cfg["store"]] + 2 * q * n_terms * m * 2
             + q * k * (4 + 4))
    nbytes = data + small
    ops = 2 * d * int(sizes[probes].sum())
    byte_s, op_s = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return dict(bytes=nbytes, ops=ops, seconds=max(byte_s, op_s),
                bound_by="bytes" if byte_s >= op_s else "operations")
