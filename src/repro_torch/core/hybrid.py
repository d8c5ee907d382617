"""Hybrid vectors (paper §3.5, §4.1): the port of ``repro.core.hybrid``.

A hybrid vector ``h_i = [x_i || a_i]`` is a dense core embedding in
``R^D`` plus a discrete attribute row in ``Z^M``.  The two halves keep their
natural dtypes (core: bf16/f32, attributes: int16) and travel together
through the index.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

ATTR_MIN = -32768
ATTR_MAX = 32767


@dataclasses.dataclass(frozen=True)
class HybridSpec:
    """Logical layout of a hybrid vector.

    Attributes:
      dim: D, dimensionality of the dense core embedding.
      n_attrs: M, number of discrete filter attributes.
      core_dtype: storage dtype of the core half.
      attr_dtype: storage dtype of the attribute half (int16 per the paper).
      metric: "dot" (maximized inner product) or "l2" (Euclidean, scored
        as ``-||q - v||²``).
    """

    dim: int
    n_attrs: int
    core_dtype: torch.dtype = torch.bfloat16
    attr_dtype: torch.dtype = torch.int16
    metric: str = "dot"

    def __post_init__(self):
        if self.dim <= 0:
            raise ValueError(f"dim must be positive, got {self.dim}")
        if self.n_attrs < 0:
            raise ValueError(f"n_attrs must be >= 0, got {self.n_attrs}")
        if self.metric not in ("dot", "l2"):
            raise ValueError(f"metric must be 'dot' or 'l2', got {self.metric!r}")

    @property
    def hybrid_dim(self) -> int:
        """D + M, the paper's hybrid dimensionality (778 in the case study)."""
        return self.dim + self.n_attrs


def make_hybrid(spec: HybridSpec, core, attrs, *, device="cuda"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validates and casts a batch of (core, attrs) to the storage dtypes."""
    dev = resolve_device(device)
    core = torch.as_tensor(core, device=dev)
    attrs = torch.as_tensor(attrs, device=dev)
    if core.ndim != 2 or core.shape[-1] != spec.dim:
        raise ValueError(f"core must be [N, {spec.dim}], got {tuple(core.shape)}")
    if attrs.ndim != 2 or attrs.shape[-1] != spec.n_attrs:
        raise ValueError(
            f"attrs must be [N, {spec.n_attrs}], got {tuple(attrs.shape)}"
        )
    if core.shape[0] != attrs.shape[0]:
        raise ValueError(
            f"core and attrs disagree on N: {core.shape[0]} vs {attrs.shape[0]}"
        )
    return core.to(spec.core_dtype), attrs.to(spec.attr_dtype)


def concat_hybrid(spec: HybridSpec, core, attrs, *, device="cuda"
                  ) -> torch.Tensor:
    """Literal ``[x || a]`` concatenation (paper §4.1), for interop/debug.

    Returns a float tensor [N, D+M]; the attribute half is cast to the core
    dtype exactly as the paper stores it (float16 in §5.1).
    """
    core, attrs = make_hybrid(spec, core, attrs, device=device)
    return torch.cat([core, attrs.to(spec.core_dtype)], dim=-1)


def split_hybrid(spec: HybridSpec, hybrid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`concat_hybrid`, on the tensor's device."""
    if hybrid.shape[-1] != spec.hybrid_dim:
        raise ValueError(f"hybrid must have trailing dim {spec.hybrid_dim}, "
                         f"got {tuple(hybrid.shape)}")
    core = hybrid[..., :spec.dim].to(spec.core_dtype)
    attrs = torch.round(hybrid[..., spec.dim:].float()).to(spec.attr_dtype)
    return core, attrs


def encode_numeric_attr(values: np.ndarray, lo: float, hi: float
                        ) -> np.ndarray:
    """Adaptive-binning helper (paper §3.4): rescale a numeric column into
    int16.

    Linearly maps [lo, hi] onto [ATTR_MIN, ATTR_MAX]; out-of-range values
    are clipped.  The same (lo, hi) must be used to encode query ranges.
    """
    if hi <= lo:
        raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
    x = (np.asarray(values, dtype=np.float64) - lo) / (hi - lo)
    x = np.clip(x, 0.0, 1.0)
    return np.round(x * (ATTR_MAX - ATTR_MIN) + ATTR_MIN).astype(np.int16)


def encode_categorical_attr(values: np.ndarray, vocabulary: dict
                            ) -> np.ndarray:
    """Dictionary-encode a categorical column into int16 codes; a value
    outside ``vocabulary`` raises ``KeyError``."""
    if len(vocabulary) > (ATTR_MAX - ATTR_MIN + 1):
        raise ValueError("categorical vocabulary exceeds int16 code space")
    out = np.empty(len(values), dtype=np.int16)
    for i, v in enumerate(values):
        out[i] = vocabulary[v] + ATTR_MIN
    return out


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalizes rows so dot == cosine."""
    n = torch.sqrt(torch.sum(torch.square(x.float()), -1, keepdim=True))
    return (x / torch.clamp(n, min=eps)).to(x.dtype)
