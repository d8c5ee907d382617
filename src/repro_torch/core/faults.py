"""Deterministic fault injection for the fetch path; the port of
``repro.core.faults``.

Chaos that cannot be replayed cannot gate a test, so the harness is a
*schedule*, not a dice roll: every wrapper consults a shared
:class:`FaultSchedule` that decides, purely from a per-target operation
counter and the rule list, whether this fetch fails, stalls, or passes
through.  The same schedule produces the same fault sequence on every run,
and tests can assert exact failover counts.

Fault classes (the ways a real peer dies, as seen from the client):

  ``refuse``      connection refused / peer process gone: the fetch fails
                  at once with a :class:`TransportError`.
  ``disconnect``  peer closed mid-payload: short read, typed error.
  ``truncate``    full-length but corrupt payload: decode-level error.
  ``latency``     the fetch completes, ``latency_s`` late: a spike when
                  ``count`` bounds it, a slow-peer brownout when not.

:class:`FaultyTransport` wraps any transport (loopback or socket), as
``inject`` installs it on one peer of a ``ShardedBlockStore``;
:class:`FaultyBlockStore` wraps any store (e.g. behind a
``BlockStoreServer``, to make the *server* slow or crashy and drive real
wire-level timeouts at the client).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.transport import TransportError

FAULT_KINDS = ("refuse", "disconnect", "truncate", "latency")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One line of the chaos schedule.

    The rule arms after ``after`` operations on a target (each wrapper's
    fetch/ping is one operation), fires on at most ``count`` operations
    (``None`` = forever — a killed peer stays dead, a brownout persists),
    and for latency faults sleeps ``latency_s`` before passing through.
    """

    kind: str
    after: int = 0
    count: Optional[int] = None
    latency_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")


class FaultSchedule:
    """Deterministic per-target fault sequencing.

    One schedule can drive many wrappers: each wrapper names a ``target``
    (e.g. the peer's node id) and the schedule keeps an independent
    operation counter per target, so "node 1 dies at its 3rd fetch" means
    exactly that regardless of how other peers interleave.  ``seed`` is
    recorded for provenance (the schedule itself is counter-driven and
    needs no randomness; benches stamp it into their output).
    """

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules: Tuple[FaultRule, ...] = tuple(rules)
        self.seed = seed
        self._lock = threading.Lock()
        self._ops: Dict = collections.defaultdict(int)
        self._fired: collections.Counter = collections.Counter()
        self.injected: collections.Counter = collections.Counter()

    def next(self, target) -> Optional[FaultRule]:
        """Advances ``target``'s operation counter and returns the fault to
        inject on this operation (first matching rule), if any."""
        with self._lock:
            op = self._ops[target]
            self._ops[target] = op + 1
            for i, rule in enumerate(self.rules):
                if op < rule.after:
                    continue
                if rule.count is not None and self._fired[(target, i)] >= rule.count:
                    continue
                self._fired[(target, i)] += 1
                self.injected[rule.kind] += 1
                return rule
        return None

    def injected_total(self) -> int:
        with self._lock:
            return sum(self.injected.values())


def kill_peer(after: int = 0) -> Tuple[FaultRule, ...]:
    """A peer that dies at its ``after``-th operation and never comes
    back."""
    return (FaultRule("refuse", after=after),)


def brownout_peer(latency_s: float = 0.2, after: int = 0,
                  count: Optional[int] = None) -> Tuple[FaultRule, ...]:
    """A peer that still answers, ``latency_s`` late — forever or for
    ``count`` operations."""
    return (FaultRule("latency", after=after, count=count,
                      latency_s=latency_s),)


_FAULT_MSG = {
    "refuse": "connection refused",
    "disconnect": "peer closed mid-frame",
    "truncate": "corrupt response payload",
}


class FaultyTransport:
    """Chaos wrapper around any transport.  Error faults raise before the
    wire is touched; latency faults sleep and pass through.  Drop-in for
    ``ShardedBlockStore.transports[node]``."""

    def __init__(self, inner, schedule: FaultSchedule, target="peer"):
        self.inner = inner
        self.schedule = schedule
        self.target = target

    def _maybe_fault(self):
        rule = self.schedule.next(self.target)
        if rule is None:
            return
        if rule.kind == "latency":
            time.sleep(rule.latency_s)
            return
        raise TransportError(
            f"injected {rule.kind} on {self.target}: {_FAULT_MSG[rule.kind]}"
        )

    def fetch(self, cluster_ids, gens=None):
        self._maybe_fault()
        if gens is None:
            return self.inner.fetch(cluster_ids)
        return self.inner.fetch(cluster_ids, gens=gens)

    def ping(self):
        self._maybe_fault()
        ping = getattr(self.inner, "ping", None)
        if ping is not None:
            ping()
        else:
            self.inner.fetch(np.asarray([], np.int64))

    def stats(self) -> dict:
        s = dict(self.inner.stats()) if hasattr(self.inner, "stats") else {}
        s["injected"] = dict(self.schedule.injected)
        return s

    def close(self):
        self.inner.close()


class FaultyBlockStore:
    """Chaos wrapper around any BlockStore — e.g. behind a
    :class:`~repro_torch.core.transport.BlockStoreServer` so the *server* is the
    slow/crashy party and the client's deadline + typed-error paths are
    exercised over a real socket.  ``submit``/``wait`` delegate to the
    inner store's pool so pipelined callers work unchanged."""

    def __init__(self, inner, schedule: FaultSchedule, target="store"):
        self.inner = inner
        self.schedule = schedule
        self.target = target

    @property
    def spec(self):
        return self.inner.spec

    def get(self, cluster_ids, gens=None):
        rule = self.schedule.next(self.target)
        if rule is not None:
            if rule.kind == "latency":
                time.sleep(rule.latency_s)
            else:
                raise ConnectionError(
                    f"injected {rule.kind} on {self.target}: "
                    f"{_FAULT_MSG[rule.kind]}"
                )
        if gens is None:
            return self.inner.get(cluster_ids)
        return self.inner.get(cluster_ids, gens=gens)

    def submit(self, cluster_ids, gens=None):
        if gens is None:
            return self.inner._ensure_pool().submit(self.get, cluster_ids)
        return self.inner._ensure_pool().submit(self.get, cluster_ids,
                                                gens=gens)

    def wait(self, handle):
        return handle.result()

    def stats(self) -> dict:
        s = dict(self.inner.stats())
        s["injected"] = dict(self.schedule.injected)
        return s

    def close(self):
        self.inner.close()


def inject(store, node, rules: Iterable[FaultRule],
           seed: int = 0) -> FaultSchedule:
    """Wraps one peer of a :class:`ShardedBlockStore` in a
    :class:`FaultyTransport` driven by a fresh schedule; returns the
    schedule (for ``injected`` accounting).  The wrapper is installed
    in-place — the store's next fetch routed to ``node`` sees the faults."""
    schedule = FaultSchedule(tuple(rules), seed=seed)
    store.transports[node] = FaultyTransport(
        store.transports[node], schedule, target=node
    )
    return schedule
