from repro_torch.kernels.filtered_scan.filtered_scan import filtered_scan_tiled
from repro_torch.kernels.filtered_scan.ref import filtered_scan_tiled_ref

__all__ = ["filtered_scan_tiled", "filtered_scan_tiled_ref"]
