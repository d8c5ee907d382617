"""Filter conditions F over attribute vectors (paper §3.4): the port of
``repro.core.filters``.

Every predicate compiles to a closed int16 interval per attribute, and a
query's filter is a DNF: OR over ``n_terms`` rows of AND over ``M``
attributes of ``lo <= a <= hi``.  A batch is two int16 tensors
``lo, hi [Q, n_terms, M]``; spare terms are voided (``lo > hi``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hybrid import ATTR_MAX, ATTR_MIN
from repro_torch.device import resolve_device


@dataclasses.dataclass
class FilterBuilder:
    """Imperative builder for one query's filter condition F (host-side).

    Example::

        f = (FilterBuilder(n_attrs=10).eq(0, 5).between(2, -10, 90)
             .ge(3, 0).isin(4, [1, 7, 9]))
        lo, hi = f.intervals()    # [n_terms, M] each
    """

    n_attrs: int

    def __post_init__(self):
        # One DNF term = one (lo, hi) row.  isin() multiplies terms.
        self._terms: List[Tuple[np.ndarray, np.ndarray]] = [
            (
                np.full(self.n_attrs, ATTR_MIN, np.int16),
                np.full(self.n_attrs, ATTR_MAX, np.int16),
            )
        ]

    def _clamp(self, v: int) -> int:
        return int(np.clip(v, ATTR_MIN, ATTR_MAX))

    def _narrow(self, attr: int, lo: int, hi: int) -> "FilterBuilder":
        if not 0 <= attr < self.n_attrs:
            raise ValueError(f"attribute index {attr} out of range [0,{self.n_attrs})")
        for tlo, thi in self._terms:
            tlo[attr] = max(tlo[attr], self._clamp(lo))
            thi[attr] = min(thi[attr], self._clamp(hi))
        return self

    def eq(self, attr: int, value: int) -> "FilterBuilder":
        return self._narrow(attr, value, value)

    def between(self, attr: int, lo: int, hi: int) -> "FilterBuilder":
        return self._narrow(attr, lo, hi)

    def ge(self, attr: int, value: int) -> "FilterBuilder":
        return self._narrow(attr, value, ATTR_MAX)

    def le(self, attr: int, value: int) -> "FilterBuilder":
        return self._narrow(attr, ATTR_MIN, value)

    def isin(self, attr: int, values: Sequence[int]) -> "FilterBuilder":
        """OR over values of one attribute: splits every term per value."""
        if not values:
            raise ValueError("isin() needs at least one value")
        new_terms: List[Tuple[np.ndarray, np.ndarray]] = []
        for tlo, thi in self._terms:
            for v in values:
                nlo, nhi = tlo.copy(), thi.copy()
                v = self._clamp(v)
                nlo[attr] = max(nlo[attr], v)
                nhi[attr] = min(nhi[attr], v)
                new_terms.append((nlo, nhi))
        self._terms = new_terms
        return self

    def intervals(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.stack([t[0] for t in self._terms])
        hi = np.stack([t[1] for t in self._terms])
        return lo, hi


@dataclasses.dataclass
class FilterSpec:
    """A batch of compiled filters, one per query.

    lo, hi: [Q, n_terms, M] int16 — conjunctive interval bounds per DNF term.
    A row passes if it is inside EVERY attribute interval of ANY term.
    """

    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def n_terms(self) -> int:
        return self.lo.shape[-2]

    @property
    def n_attrs(self) -> int:
        return self.lo.shape[-1]

    def __len__(self) -> int:
        return self.lo.shape[0]

    def to(self, device) -> "FilterSpec":
        return FilterSpec(lo=self.lo.to(device), hi=self.hi.to(device))


def match_all(n_queries: int, n_attrs: int, n_terms: int = 1, *,
              device="cuda") -> FilterSpec:
    """The no-filter (wildcard) spec: every vector passes."""
    lo = np.full((n_queries, n_terms, n_attrs), ATTR_MIN, np.int16)
    hi = np.full((n_queries, n_terms, n_attrs), ATTR_MAX, np.int16)
    if n_terms > 1:  # void the spare terms so counts stay exact
        lo[:, 1:, :] = ATTR_MAX
        hi[:, 1:, :] = ATTR_MIN
    dev = resolve_device(device)
    return FilterSpec(lo=torch.from_numpy(lo).to(dev),
                      hi=torch.from_numpy(hi).to(dev))


def from_builders(builders: Sequence[FilterBuilder],
                  n_terms: Optional[int] = None, *,
                  device="cuda") -> FilterSpec:
    """Pads a batch of per-query builders to a common static term count."""
    per_query = [b.intervals() for b in builders]
    max_terms = max(lo.shape[0] for lo, _ in per_query)
    n_terms = max_terms if n_terms is None else n_terms
    if n_terms < max_terms:
        raise ValueError(f"n_terms={n_terms} < required {max_terms}")
    m = builders[0].n_attrs
    q = len(builders)
    lo = np.full((q, n_terms, m), ATTR_MAX, np.int16)  # void by default
    hi = np.full((q, n_terms, m), ATTR_MIN, np.int16)
    for qi, (tlo, thi) in enumerate(per_query):
        lo[qi, : tlo.shape[0]] = tlo
        hi[qi, : thi.shape[0]] = thi
    dev = resolve_device(device)
    return FilterSpec(lo=torch.from_numpy(lo).to(dev),
                      hi=torch.from_numpy(hi).to(dev))


def filter_mask(spec: FilterSpec, attrs: torch.Tensor,
                query_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Evaluates the filter against attribute rows.

    Args:
      spec: FilterSpec with lo/hi [Q, n_terms, M].
      attrs: [..., M] int16 attribute rows.
      query_idx: if given, an int tensor broadcastable to ``attrs.shape[:-1]``
        selecting which query's filter applies to each row.  If None,
        ``attrs`` must be [Q, ..., M] with the leading axis aligned to queries.

    Returns a bool mask of shape ``attrs.shape[:-1]``.  Terms and attributes
    are folded one at a time, so no ``[..., n_terms, M]`` intermediate exists.
    """
    lo, hi = spec.lo.int(), spec.hi.int()
    if query_idx is not None:
        lo = lo[query_idx.long()]  # [..., n_terms, M]
        hi = hi[query_idx.long()]
    else:
        extra = attrs.ndim - 2  # broadcast over middle axes
        lo = lo.reshape(lo.shape[0], *([1] * extra), *lo.shape[1:])
        hi = hi.reshape(hi.shape[0], *([1] * extra), *hi.shape[1:])
    a = attrs.int()
    out = None
    for f in range(lo.shape[-2]):
        term = None
        for m in range(lo.shape[-1]):
            am = a[..., m]
            inside = (am >= lo[..., f, m]) & (am <= hi[..., f, m])
            term = inside if term is None else term & inside
        if term is None:  # M == 0: every row is inside the empty conjunction
            term = torch.ones(attrs.shape[:-1], dtype=torch.bool,
                              device=attrs.device)
        out = term if out is None else out | term
    if out is None:  # no terms: nothing passes
        out = torch.zeros(attrs.shape[:-1], dtype=torch.bool,
                          device=attrs.device)
    return out


def sample_rows(n: int, sample_size: int, seed: int = 0,
                device="cpu") -> torch.Tensor:
    """The rows :func:`selectivity` samples: ``sample_size`` distinct row
    indices of ``[0, n)``, drawn from an explicit ``torch.Generator``
    seeded with ``seed`` (int64, in draw order)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen)[:sample_size].to(device)


def selectivity(spec: FilterSpec, attrs: torch.Tensor, *,
                sample_size: Optional[int] = None, seed: int = 0,
                chunk: int = 4096) -> torch.Tensor:
    """Fraction of rows passing each query's filter (paper §4.3 "filter
    selectivity").

    Rows are optionally subsampled (``sample_size`` rows, drawn by
    :func:`sample_rows` from ``seed``; None = exact over every row) and
    evaluated ``chunk`` rows at a time, so the only intermediate is a
    ``[Q, chunk]`` mask, whatever N.

    Args:
      spec: FilterSpec with lo/hi [Q, n_terms, M].
      attrs: [N, M] attribute rows.

    Returns [Q] f32 passing fractions (estimates under sampling).
    """
    attrs = torch.as_tensor(attrs, device=spec.lo.device)
    n = attrs.shape[0]
    if sample_size is not None and sample_size < n:
        attrs = attrs[sample_rows(n, sample_size, seed, device=attrs.device)]
        n = sample_size
    q = spec.lo.shape[0]
    passed = torch.zeros((q,), dtype=torch.int32, device=attrs.device)
    for start in range(0, n, chunk):
        block = attrs[start:start + chunk]
        mask = filter_mask(spec, block.expand((q,) + tuple(block.shape)))
        passed += mask.sum(-1, dtype=torch.int32)
    passed = passed.float()
    # a tensor divisor: IEEE division on the card too
    return passed / torch.full_like(passed, max(n, 1))
