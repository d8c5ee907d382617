"""Cluster ownership maps: the port of ``repro.core.blockstore``'s
``RangeOwnership``.

The block stores themselves (resident, local, sharded) are not ported yet
(ROADMAP A.4, A.8).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RangeOwnership:
    """Contiguous range sharding: node ``s`` owns ``[s·k_local, (s+1)·k_local)``.

    The ownership map of the sharded dispatch
    (:func:`repro_torch.core.distributed.dispatch_probes`).  ``owner_of`` /
    ``local_of`` are plain integer arithmetic, so they take ints and integer
    tensors alike.
    """

    n_nodes: int
    k_local: int

    @property
    def nodes(self) -> Tuple[int, ...]:
        return tuple(range(self.n_nodes))

    def owner_of(self, cluster_ids):
        return cluster_ids // self.k_local

    def local_of(self, cluster_ids):
        return cluster_ids % self.k_local
