"""The filtered scans, the per-probe fused search, and the query-tiled
fused search (``search_fused_tiled``, owned by :mod:`repro_torch.core.engine`
and re-exported here as the reference's package does).

The per-probe kernel's wrapper is
``repro_torch.kernels.filtered_scan.filtered_scan.filtered_scan``; it is not
re-exported here, so that name keeps naming the module (which also holds
the launch counters).
"""

from repro_torch.kernels.filtered_scan.filtered_scan import filtered_scan_tiled
from repro_torch.kernels.filtered_scan.ops import search_fused
from repro_torch.kernels.filtered_scan.ref import (
    filtered_scan_ref,
    filtered_scan_tiled_ref,
)

__all__ = ["filtered_scan_ref", "filtered_scan_tiled",
           "filtered_scan_tiled_ref", "search_fused", "search_fused_tiled"]


def __getattr__(name):
    # imported on first use: the engine imports this package's kernels
    if name == "search_fused_tiled":
        from repro_torch.core.engine import search_fused_tiled

        return search_fused_tiled
    raise AttributeError(name)
