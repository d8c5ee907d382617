"""The port's hybrid IVF-Flat filtered similarity search (RAM and disk
tiers).

  HybridSpec, make_hybrid, l2_normalize              — hybrid vector layout
  FilterBuilder, FilterSpec, match_all, filter_mask  — DNF filters
  build_from_assignments, index_from_arrays          — index construction
  ClusterSummaries, build_summaries, can_match       — filter-aware pruning
  search_reference, brute_force, recall_at_k         — reference paths
  SearchEngine, search_fused_tiled                   — the fused tiled path
  make_sharded_search, ShardedSearchConfig           — the sharded search
                                                       (one shard)
  RangeOwnership                                     — cluster ownership map
  BlockSpec, LocalBlockStore, ResidentBlockStore     — cluster block stores
  ClusterCache, DiskIVFIndex                         — the disk tier
  GenerationMismatchError                            — checkpoint skew
"""

from repro_torch.core.hybrid import (
    ATTR_MAX,
    ATTR_MIN,
    HybridSpec,
    l2_normalize,
    make_hybrid,
)
from repro_torch.core.filters import (
    FilterBuilder,
    FilterSpec,
    filter_mask,
    from_builders,
    match_all,
)
from repro_torch.core.ivf import (
    BuildStats,
    IVFFlatIndex,
    build_from_assignments,
    default_n_clusters,
    index_from_arrays,
    quantize_index,
    validity_mask,
)
from repro_torch.core.summaries import (
    ClusterSummaries,
    build_summaries,
    can_match,
)
from repro_torch.core.search import (
    SearchResult,
    brute_force,
    centroid_scores,
    recall_at_k,
    search_centroids,
    search_reference,
)
from repro_torch.core.engine import SearchEngine, search_fused_tiled
from repro_torch.core.blockstore import (
    BlockSpec,
    LocalBlockStore,
    RangeOwnership,
    ResidentBlockStore,
)
from repro_torch.core.distributed import ShardedSearchConfig, make_sharded_search
from repro_torch.core.disk import ClusterCache, DiskIVFIndex
from repro_torch.core.storage import GenerationMismatchError

__all__ = [
    "ATTR_MAX", "ATTR_MIN", "BlockSpec", "BuildStats", "ClusterCache",
    "ClusterSummaries", "DiskIVFIndex", "FilterBuilder", "FilterSpec",
    "GenerationMismatchError", "HybridSpec", "IVFFlatIndex",
    "LocalBlockStore", "RangeOwnership", "ResidentBlockStore",
    "SearchEngine", "SearchResult", "ShardedSearchConfig", "brute_force",
    "build_from_assignments", "build_summaries", "can_match",
    "centroid_scores", "default_n_clusters", "filter_mask", "from_builders",
    "index_from_arrays", "l2_normalize", "make_hybrid", "make_sharded_search",
    "match_all", "quantize_index", "recall_at_k", "search_centroids",
    "search_fused_tiled", "search_reference", "validity_mask",
]
