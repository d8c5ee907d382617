"""Synthetic data generators and the prefetching feeder of the port (the
port of ``repro.data``)."""

from repro_torch.data.pipeline import (
    ShardedFeeder,
    lm_batch,
    recsys_batch,
    synthetic_attributes,
    synthetic_embeddings,
)

__all__ = [
    "ShardedFeeder", "lm_batch", "recsys_batch", "synthetic_attributes",
    "synthetic_embeddings",
]
