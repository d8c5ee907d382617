"""The port's hybrid IVF-Flat filtered similarity search (RAM and disk
tiers).

  HybridSpec, make_hybrid, l2_normalize,
  concat_hybrid, split_hybrid, encode_numeric_attr,
  encode_categorical_attr                            — hybrid vector layout
  FilterBuilder, FilterSpec, match_all, filter_mask,
  selectivity                                        — DNF filters
  build_ivf, build_from_assignments,
  index_from_arrays                                  — index construction
  ClusterSummaries, build_summaries, can_match,
  expected_passing                                   — filter-aware pruning
  search_reference, brute_force, recall_at_k         — reference paths
  SearchEngine, search_fused_tiled, SearchPlan,
  TileWork, u_cap_buckets, scan_compile_count        — the fused tiled path
  plan_probe_tiles, dedup_rows, fetch_order          — probe planning
  masked_topk, merge_topk, merge_topk_many,
  merge_topk_axis, topk_tree_merge                   — top-k monoid and
                                                       its merge tree
  add_vectors, tombstone, stale_counts,
  compact_stale, compact_cluster                     — online updates
  DeltaTier, compact_deltas, RepublishStats          — live hot/cold serving
  PartitionCatalog, PartitionBuild, build_partitions,
  choose_attrs, FilterTrafficRecorder                — filter-specialized
                                                       sub-partitions
  make_sharded_search, ShardedSearchConfig           — the sharded search
                                                       over a mesh
  RangeOwnership, HashRing                           — cluster ownership maps
  BlockSpec, LocalBlockStore, ResidentBlockStore     — cluster block stores
  ShardedBlockStore, StoreStats, open_sharded        — the sharded ring
  LoopbackTransport, SocketTransport,
  BlockStoreServer, TransportError, TransportTimeout — its transports
  CircuitBreaker, PeerHealth                         — peer health
  FaultRule, FaultSchedule, FaultyBlockStore,
  FaultyTransport                                    — fault injection
  ClusterCache, DiskIVFIndex                         — the disk tier
  GenerationMismatchError                            — checkpoint skew
"""

from repro_torch.core.hybrid import (
    ATTR_MAX,
    ATTR_MIN,
    HybridSpec,
    concat_hybrid,
    encode_categorical_attr,
    encode_numeric_attr,
    l2_normalize,
    make_hybrid,
    split_hybrid,
)
from repro_torch.core.filters import (
    FilterBuilder,
    FilterSpec,
    filter_mask,
    from_builders,
    match_all,
    selectivity,
)
from repro_torch.core.ivf import (
    BuildStats,
    IVFFlatIndex,
    build_from_assignments,
    build_ivf,
    default_n_clusters,
    index_from_arrays,
    quantize_index,
    validity_mask,
)
from repro_torch.core.summaries import (
    ClusterSummaries,
    build_summaries,
    can_match,
    expected_passing,
)
from repro_torch.core.search import (
    SearchResult,
    brute_force,
    centroid_scores,
    recall_at_k,
    search_centroids,
    search_reference,
)
from repro_torch.core.engine import (
    SearchEngine,
    SearchPlan,
    TileWork,
    scan_compile_count,
    search_fused_tiled,
    u_cap_buckets,
)
from repro_torch.core.probes import dedup_rows, fetch_order, plan_probe_tiles
from repro_torch.core.topk import (
    masked_topk,
    merge_topk,
    merge_topk_axis,
    merge_topk_many,
    topk_tree_merge,
)
from repro_torch.core import partitions
from repro_torch.core.partitions import (
    FilterTrafficRecorder,
    PartitionBuild,
    PartitionCatalog,
    build_partitions,
    choose_attrs,
)
from repro_torch.core.update import (
    add_vectors,
    compact_cluster,
    compact_stale,
    resync_partitions,
    stale_counts,
    tombstone,
)
from repro_torch.core.delta import (
    DeltaOverflowError,
    DeltaTier,
    RepublishStats,
    compact_deltas,
)
from repro_torch.core.blockstore import (
    BlockSpec,
    BlockStoreServer,
    HashRing,
    LocalBlockStore,
    LoopbackTransport,
    RangeOwnership,
    ResidentBlockStore,
    ShardedBlockStore,
    SocketTransport,
    StoreStats,
    open_sharded,
)
from repro_torch.core.transport import TransportError, TransportTimeout
from repro_torch.core.health import CircuitBreaker, PeerHealth
from repro_torch.core.faults import (
    FaultRule,
    FaultSchedule,
    FaultyBlockStore,
    FaultyTransport,
)
from repro_torch.core import faults, health, transport
from repro_torch.core.distributed import ShardedSearchConfig, make_sharded_search
from repro_torch.core.disk import ClusterCache, DiskIVFIndex
from repro_torch.core.storage import GenerationMismatchError

__all__ = [
    "ATTR_MAX", "ATTR_MIN", "BlockSpec", "BlockStoreServer", "BuildStats",
    "CircuitBreaker", "ClusterCache", "ClusterSummaries",
    "DeltaOverflowError", "DeltaTier", "DiskIVFIndex", "FaultRule",
    "FaultSchedule", "FaultyBlockStore", "FaultyTransport", "FilterBuilder",
    "FilterSpec", "FilterTrafficRecorder", "GenerationMismatchError",
    "HashRing", "HybridSpec", "IVFFlatIndex", "LocalBlockStore",
    "LoopbackTransport", "PartitionBuild", "PartitionCatalog", "PeerHealth",
    "RangeOwnership", "RepublishStats", "ResidentBlockStore",
    "SearchEngine", "SearchPlan", "SearchResult", "ShardedBlockStore",
    "ShardedSearchConfig", "SocketTransport", "StoreStats", "TileWork",
    "TransportError", "TransportTimeout", "add_vectors", "brute_force",
    "build_from_assignments", "build_ivf", "build_partitions",
    "build_summaries", "can_match", "centroid_scores", "choose_attrs",
    "compact_cluster", "compact_deltas", "compact_stale", "concat_hybrid",
    "dedup_rows", "default_n_clusters", "encode_categorical_attr",
    "encode_numeric_attr", "expected_passing", "faults", "fetch_order",
    "filter_mask", "from_builders", "health", "index_from_arrays",
    "l2_normalize",
    "make_hybrid", "make_sharded_search", "masked_topk", "match_all",
    "merge_topk", "merge_topk_axis", "merge_topk_many", "open_sharded",
    "partitions",
    "plan_probe_tiles",
    "quantize_index",
    "recall_at_k", "resync_partitions", "scan_compile_count",
    "search_centroids", "search_fused_tiled", "search_reference",
    "selectivity", "split_hybrid", "stale_counts", "tombstone",
    "topk_tree_merge", "transport",
    "u_cap_buckets", "validity_mask",
]
