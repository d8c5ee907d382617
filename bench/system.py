"""The system under test: the port's ``SearchEngine`` on the RAM tier.

The only module of the benchmark that imports the program.  It hands the
generated rows to the program's own build (``build_from_assignments`` with
the topics as assignments, then ``quantize_index`` under SQ8) and drives
the sync executor through ``submit`` / ``result``.
"""

from __future__ import annotations

import torch

from repro_torch.core import FilterSpec, HybridSpec, build_from_assignments
from repro_torch.core.engine import SearchEngine
from repro_torch.core.ivf import quantize_index


class System:
    def __init__(self, cfg: dict, k: int, core, attrs, topic, centres,
                 device):
        spec = HybridSpec(dim=cfg["dim"], n_attrs=cfg["n_attrs"],
                          core_dtype=torch.bfloat16, metric=cfg["metric"])
        index, self.build = build_from_assignments(
            spec, centres, core, attrs, topic, device=device)
        if cfg["store"] == "sq8":
            index = quantize_index(index)
        self.index_bytes = index.nbytes()
        self.engine = SearchEngine(
            index, k=k, n_probes=cfg["n_probes"], pipeline="off",
            prune="auto", device=device)

    def submit(self, queries, lo, hi):
        return self.engine.submit(queries, FilterSpec(lo=lo, hi=hi))

    def result(self, pending):
        """The batch's ``(scores, ids, n_scanned, n_passed)`` on the card."""
        r = self.engine.result(pending)
        return r.scores, r.ids, r.n_scanned, r.n_passed

    def close(self):
        self.engine.close()
        self.engine = None
