"""The streaming centroid top-T and probe selection.

The kernel's wrapper is
``repro_torch.kernels.centroid_topk.centroid_topk.centroid_topk``; it is not
re-exported here, so that name keeps naming the module (which also holds
the launch counter).
"""

from repro_torch.kernels.centroid_topk.ops import probe_centroids
from repro_torch.kernels.centroid_topk.ref import centroid_topk_ref

__all__ = ["centroid_topk_ref", "probe_centroids"]
