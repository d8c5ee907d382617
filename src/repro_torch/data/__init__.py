"""Synthetic data generators of the port (``repro.data``'s ANN half)."""

from repro_torch.data.pipeline import (
    synthetic_attributes,
    synthetic_embeddings,
)

__all__ = ["synthetic_attributes", "synthetic_embeddings"]
