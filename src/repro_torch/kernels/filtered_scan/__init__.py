"""The filtered scans and the per-probe fused search.

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
           "filtered_scan_tiled_ref", "search_fused"]
