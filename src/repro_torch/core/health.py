"""Per-peer circuit breakers: the ring is an optimization, never a
dependency; the port of ``repro.core.health`` (host Python, no tensors).

Every pod holds a full index copy on disk; the consistent-hash ring only
decides whose *cache* is warm for each cluster, so a peer failure is a
performance event, not an availability event, provided the fetch path
notices quickly and routes around the dead peer:

  * :class:`CircuitBreaker`: closed -> open -> half-open per peer, driven
    by the transport's passive signals (typed
    :class:`~repro_torch.core.transport.TransportError` failures, per-request
    latency fed into an EWMA for brownout detection) plus the owner's
    active probe (``ShardedBlockStore.probe_peers``).
  * :class:`PeerHealth`: the registry a ``ShardedBlockStore`` consults per
    fetch: ``allow(node)`` gates traffic (and hands out the single
    half-open probe token), ``on_success`` / ``on_failure`` feed the
    breakers.

State machine (all transitions under the breaker's lock):

  closed      normal traffic.  ``failure_threshold`` consecutive failures,
              or a latency EWMA above ``brownout_latency_s``, trip to open.
  open        no traffic; the owner serves this peer's clusters from the
              local full copy.  After ``cooldown_s`` the next ``allow``
              hands out one probe token (-> half-open).
  half-open   one request (or active ping) in flight at a time.
              ``half_open_successes`` consecutive successes close the
              circuit; any failure (or a slow answer) re-opens it with the
              cooldown escalated x``cooldown_factor`` up to
              ``cooldown_max_s``.

``clock`` is injectable, so the state machine's tests run on a fake clock.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """One peer's health state machine.  Thread-safe; cheap enough to
    consult on every fetch."""

    def __init__(self, *, failure_threshold: int = 3,
                 cooldown_s: float = 1.0, cooldown_factor: float = 2.0,
                 cooldown_max_s: float = 30.0, half_open_successes: int = 2,
                 latency_alpha: float = 0.2,
                 brownout_latency_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = failure_threshold
        self.base_cooldown_s = cooldown_s
        self.cooldown_factor = cooldown_factor
        self.cooldown_max_s = cooldown_max_s
        self.half_open_successes = max(int(half_open_successes), 1)
        self.latency_alpha = latency_alpha
        self.brownout_latency_s = brownout_latency_s
        self._clock = clock
        self._lock = threading.Lock()
        self.state = CLOSED
        self.ewma_latency_s: Optional[float] = None
        self._consec_failures = 0
        self._half_open_ok = 0
        self._probe_inflight = False
        self._cooldown_s = cooldown_s
        self._opened_at = 0.0
        # lifetime counters (snapshot/observability)
        self.trips = 0
        self.failures = 0
        self.successes = 0

    # ---- gating ----
    def allow(self) -> bool:
        """May a request go to this peer right now?  In half-open, a True
        return IS the probe token — the caller must report the outcome via
        ``record_success``/``record_failure`` or the token leaks."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self._clock() - self._opened_at >= self._cooldown_s:
                    self.state = HALF_OPEN
                    self._half_open_ok = 0
                    self._probe_inflight = True
                    return True
                return False
            # HALF_OPEN: one probe in flight at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    # ---- passive signals ----
    def record_success(self, latency_s: Optional[float] = None):
        with self._lock:
            self.successes += 1
            if latency_s is not None:
                a = self.latency_alpha
                prev = self.ewma_latency_s
                self.ewma_latency_s = (
                    latency_s if prev is None else a * latency_s + (1 - a) * prev
                )
            if self.state == HALF_OPEN:
                self._probe_inflight = False
                slow = (self.brownout_latency_s is not None
                        and latency_s is not None
                        and latency_s >= self.brownout_latency_s)
                if slow:  # answered, but still browned out — not recovered
                    self._trip_locked(escalate=True)
                    return
                self._half_open_ok += 1
                if self._half_open_ok >= self.half_open_successes:
                    self.state = CLOSED
                    self._consec_failures = 0
                    self._cooldown_s = self.base_cooldown_s
                    self.ewma_latency_s = None  # rebuild from healthy traffic
                return
            self._consec_failures = 0
            if (self.state == CLOSED
                    and self.brownout_latency_s is not None
                    and self.ewma_latency_s is not None
                    and self.ewma_latency_s >= self.brownout_latency_s):
                self._trip_locked()

    def record_failure(self):
        with self._lock:
            self.failures += 1
            if self.state == HALF_OPEN:
                self._probe_inflight = False
                self._trip_locked(escalate=True)
                return
            if self.state == OPEN:
                return
            self._consec_failures += 1
            if self._consec_failures >= self.failure_threshold:
                self._trip_locked()

    def _trip_locked(self, escalate: bool = False):
        if escalate:
            self._cooldown_s = min(self._cooldown_s * self.cooldown_factor,
                                   self.cooldown_max_s)
        self.state = OPEN
        self.trips += 1
        self._opened_at = self._clock()
        self._consec_failures = 0
        self._half_open_ok = 0
        self._probe_inflight = False
        self.ewma_latency_s = None  # stale latency must not re-trip recovery

    def snapshot(self) -> dict:
        with self._lock:
            return dict(
                state=self.state, trips=self.trips, failures=self.failures,
                successes=self.successes,
                ewma_latency_ms=(None if self.ewma_latency_s is None
                                 else round(self.ewma_latency_s * 1e3, 3)),
                cooldown_s=self._cooldown_s,
            )


class PeerHealth:
    """Breaker registry for a set of peers (the sharded store's view).

    ``breaker_kwargs`` configure every breaker identically (thresholds are
    a fleet policy, not a per-peer one); ``clock`` is forwarded for
    deterministic tests.
    """

    def __init__(self, nodes: Iterable = (), *,
                 breaker_kwargs: Optional[dict] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._kwargs = dict(breaker_kwargs or {})
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: Dict = {}
        for n in nodes:
            self.breaker(n)

    def breaker(self, node) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(node)
            if br is None:
                br = self._breakers[node] = CircuitBreaker(
                    clock=self._clock, **self._kwargs
                )
            return br

    def drop(self, node):
        with self._lock:
            self._breakers.pop(node, None)

    def allow(self, node) -> bool:
        return self.breaker(node).allow()

    def on_success(self, node, latency_s: Optional[float] = None):
        self.breaker(node).record_success(latency_s)

    def on_failure(self, node):
        self.breaker(node).record_failure()

    def state(self, node) -> str:
        return self.breaker(node).state

    @property
    def degraded(self) -> bool:
        """True while any peer's circuit is not closed."""
        with self._lock:
            breakers = list(self._breakers.values())
        return any(br.state != CLOSED for br in breakers)

    def snapshot(self) -> Dict:
        with self._lock:
            items = list(self._breakers.items())
        return {node: br.snapshot() for node, br in items}

    def probe(self, node, probe_fn: Callable[[], None]) -> bool:
        """Runs one active probe against a non-closed peer if the breaker
        grants a token; feeds the outcome back.  Returns True iff the probe
        ran and succeeded."""
        br = self.breaker(node)
        if br.state == CLOSED or not br.allow():
            return False
        t0 = self._clock()
        try:
            probe_fn()
        except Exception:
            br.record_failure()
            return False
        br.record_success(self._clock() - t0)
        return True
