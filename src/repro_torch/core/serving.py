"""Serving loop: request batching, deadlines, straggler policy (paper §5.4):
the port of ``repro.core.serving``.

  * requests (query vector + FilterSpec row) accumulate in a queue;
  * a micro-batcher drains up to ``batch_size`` requests or waits at most
    ``max_wait_s`` from the oldest request's arrival, and pads the tail
    batch to ``batch_size`` rows so every batch has one shape;
  * each batch goes to the card as one query tensor and one ``FilterSpec``
    on the server's device, and its scores and ids come back to the host
    once;
  * a refresh asked for from any thread is taken strictly between batches
    (the hot/cold tier's no-drain generation flip);
  * shard health is an EWMA-on-failure tracker with probation;
  * with ``cache_shards > 1`` the disk tier fetches through a
    ``ShardedBlockStore`` ring of peer caches (loopback or socket peers,
    per-peer circuit breakers, the index's own store as the fallback), and
    a response says whether its batch was served degraded.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.filters import FilterSpec, match_all
from repro_torch.core.spans import StageHistogram, render_stage_histograms
from repro_torch.device import resolve_device


def make_fused_search_fn(index, *, k: int, n_probes: int, q_block: int = 64,
                         v_block: int = 256, backend: Optional[str] = None,
                         resident_budget_bytes: Optional[int] = None,
                         prune: str = "auto",
                         t_max=None,
                         pipeline: str = "auto",
                         pipeline_depth: int = 2,
                         adaptive_u_cap: Optional[bool] = None,
                         operand_cache: str = "auto",
                         u_cap_ladder: str = "pow2",
                         cache_shards: int = 1,
                         cache_transport: str = "loopback",
                         cache_l1_records: int = 64,
                         cache_fallback: bool = True,
                         peer_timeout_s: float = 30.0,
                         peer_retries: int = 1,
                         breaker_kwargs: Optional[dict] = None,
                         probe_interval_s: Optional[float] = None,
                         delta_budget_mb: Optional[float] = None,
                         delta_quantize: str = "auto",
                         device_cache_mb: Optional[float] = None,
                         termination: Optional[str] = None,
                         epsilon: float = 0.0,
                         partitions: str = "auto",
                         device="cuda",
                         ) -> Callable:
    """The batched server's default search step: one long-lived
    :class:`~repro_torch.core.engine.SearchEngine`.

    Returns ``search_fn(queries, fspec, shard_ok) -> (scores, ids)``
    (tensors on ``device``); ``shard_ok`` is accepted and ignored, as in the
    reference.  ``index`` selects the tier: an in-RAM ``IVFFlatIndex`` on
    ``device``, an open ``DiskIVFIndex``, or a checkpoint directory (opened
    disk-resident on ``device`` under ``resident_budget_bytes``).  The open
    index is ``search_fn.index`` and the engine ``search_fn.engine``.

    The engine knobs (``prune``, ``t_max``, ``pipeline``,
    ``pipeline_depth``, ``adaptive_u_cap``, ``operand_cache``,
    ``u_cap_ladder``, ``termination``, ``epsilon``, ``partitions``) go to
    the engine as they are; ``backend`` is not ported (the tensors' device
    picks the kernel) and raises unless None.  ``delta_budget_mb``
    attaches a ``DeltaTier`` to a disk-tier index (layout >= 3) as
    ``search_fn.delta``; ``search_fn.refresh()`` adopts a republish between
    batches.  ``device_cache_mb`` attaches a ``DeviceBlockCache`` to a
    disk-tier index as ``search_fn.device_cache``.

    ``cache_shards > 1`` builds a consistent-hash ``ShardedBlockStore``
    over that many peer caches of the disk index's checkpoint, each holding
    ``index.cache.capacity_records // cache_shards`` records, and routes
    the engine's fetch stage through it (``search_fn.blockstore``; torn
    down by ``search_fn.close()``).  ``cache_transport`` picks the peers'
    transport (``"loopback"`` in process, ``"socket"`` the wire protocol
    behind a local server per peer), ``cache_l1_records`` the ring's L1,
    ``cache_fallback`` wires the index's own store in as the availability
    floor, ``peer_timeout_s`` / ``peer_retries`` bound each socket fetch,
    ``breaker_kwargs`` tune the per-peer circuit breakers and
    ``probe_interval_s`` starts the active health probe.
    ``search_fn.degraded()`` says whether a peer circuit is open.
    """
    from repro_torch.core import blockstore as blockstore_lib
    from repro_torch.core.disk import DiskIVFIndex
    from repro_torch.core.engine import SearchEngine

    dev = resolve_device(device)
    owns_index = isinstance(index, str)
    if owns_index:
        index = DiskIVFIndex.open(
            index, resident_budget_bytes=resident_budget_bytes, device=dev)
    delta = None
    if delta_budget_mb is not None:
        from repro_torch.core import delta as delta_lib
        from repro_torch.core import storage

        if not isinstance(index, DiskIVFIndex):
            raise ValueError(
                "delta_budget_mb needs a disk-tier index (a checkpoint "
                "path or an open DiskIVFIndex) — the RAM tier mutates in "
                "place via core.update instead")
        if index.man["layout"] < 3:
            raise storage.GenerationMismatchError(
                f"delta_budget_mb needs a layout-v3 checkpoint "
                f"(generation-tagged cluster records); this one is layout "
                f"v{index.man['layout']} — re-save it with "
                f"storage.save_index(index, dir)")
        delta = delta_lib.DeltaTier.for_index(index, delta_budget_mb,
                                              quantize=delta_quantize)
        index.delta = delta
    store = None
    if cache_shards > 1:
        if not isinstance(index, DiskIVFIndex):
            raise ValueError(
                "cache_shards > 1 needs a disk-tier index (a checkpoint "
                "path or an open DiskIVFIndex) — the RAM tier has no fetch "
                "stage to shard")
        # per-node capacity: N peers together hold what the index's own
        # cache would; the index's own store (otherwise idle) is the
        # availability floor, at no extra memory
        cap = max(index.cache.capacity_records // cache_shards, 1)
        store = blockstore_lib.open_sharded(
            index.directory, n_nodes=cache_shards,
            transport=cache_transport, capacity_records=cap,
            l1_records=cache_l1_records,
            fallback=index.blockstore if cache_fallback else None,
            timeout_s=peer_timeout_s, retries=peer_retries,
            breaker_kwargs=breaker_kwargs,
            probe_interval_s=probe_interval_s, device=dev)
    device_cache = None
    if device_cache_mb is not None:
        from repro_torch.core.devicecache import DeviceBlockCache

        if not isinstance(index, DiskIVFIndex):
            raise ValueError(
                "device_cache_mb needs a disk-tier index (a checkpoint "
                "path or an open DiskIVFIndex) — the RAM tier's operands "
                "are already resident")
        device_cache = DeviceBlockCache(
            blockstore_lib.BlockSpec.from_manifest(index.man),
            int(device_cache_mb * 2**20),
            heat_fn=index.cache.probe_heat, device=dev)
        index.device_cache = device_cache
    engine = SearchEngine(
        index, k=k, n_probes=n_probes, q_block=q_block, v_block=v_block,
        backend=backend, prune=prune, t_max=t_max, pipeline=pipeline,
        pipeline_depth=pipeline_depth, adaptive_u_cap=adaptive_u_cap,
        blockstore=store, operand_cache=operand_cache,
        u_cap_ladder=u_cap_ladder, device_cache=device_cache,
        termination=termination, epsilon=epsilon, partitions=partitions,
        device=dev)

    def search_fn(queries, fspec, shard_ok=None):
        del shard_ok  # single host
        res = engine.search(queries, fspec)
        return res.scores, res.ids

    def close():
        engine.close()
        if store is not None:
            store.close()
        # only tear down an index this factory opened (str path) — a
        # caller-provided DiskIVFIndex may back other search_fns
        if owns_index:
            index.close()

    search_fn.index = index
    search_fn.engine = engine
    search_fn.blockstore = engine.blockstore
    search_fn.degraded = (
        lambda: bool(getattr(engine.blockstore, "degraded", False)))
    search_fn.delta = delta
    search_fn.device_cache = device_cache
    search_fn.refresh = engine.refresh
    search_fn.metrics = engine.metrics
    search_fn.metrics_text = engine.metrics_text
    search_fn.close = close
    return search_fn


@dataclasses.dataclass
class Request:
    query: np.ndarray  # [D]
    lo: np.ndarray  # [F, M] int16
    hi: np.ndarray  # [F, M]
    future: "queue.Queue"  # delivery channel (size 1)
    t_enqueue: float = 0.0


@dataclasses.dataclass
class Response:
    scores: np.ndarray  # [k]
    ids: np.ndarray  # [k]
    latency_s: float
    batched_with: int
    degraded: bool  # a shard was dropped from the merge, or the fetch
    #                 layer served around an open peer circuit


class ShardHealth:
    """EWMA failure tracker per shard; drops a shard from merges while its
    failure score exceeds the threshold, then lets it back in (probation)."""

    def __init__(self, n_shards: int, threshold: float = 0.5,
                 decay: float = 0.8):
        self.n = n_shards
        self.threshold = threshold
        self.decay = decay
        self.score = np.zeros(n_shards)

    def report(self, shard: int, failed: bool):
        self.score[shard] = self.decay * self.score[shard] + (
            (1 - self.decay) if failed else 0.0)

    def ok_mask(self) -> np.ndarray:
        return self.score <= self.threshold

    @property
    def degraded(self) -> bool:
        return bool((~self.ok_mask()).any())


class SearchServer:
    """Micro-batching server around a ``search_fn``.

    ``search_fn(queries [Q, D], fspec, shard_ok [S]) -> (scores [Q, k],
    ids [Q, k])`` with Q = ``batch_size``: the server pads tail batches.
    Queries, the filter bounds and ``shard_ok`` go to ``device`` (the
    search function's); the results come back to the host once a batch.
    """

    def __init__(
        self,
        search_fn: Callable,
        *,
        batch_size: int,
        dim: int,
        n_attrs: int,
        n_terms: int,
        n_shards: int,
        max_wait_s: float = 0.005,
        device="cuda",
    ):
        self.search_fn = search_fn
        self.batch_size = batch_size
        self.dim = dim
        self.n_attrs = n_attrs
        self.n_terms = n_terms
        self.max_wait_s = max_wait_s
        self.device = resolve_device(device)
        self.health = ShardHealth(n_shards)
        wild = match_all(1, n_attrs, n_terms, device="cpu")
        self._wild = (wild.lo[0].numpy(), wild.hi[0].numpy())
        self._q: "queue.Queue[Request]" = queue.Queue()
        self._stop = threading.Event()
        self._refresh = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self.stats = dict(batches=0, requests=0, degraded_batches=0,
                          total_latency_s=0.0, refreshes=0)
        # each request's wait from its enqueue to its batch's search start
        self.stages = {"queue_wait": StageHistogram()}

    # ---- client side ----
    def submit(self, query: np.ndarray, fspec_row: Optional[Tuple] = None
               ) -> "queue.Queue":
        lo, hi = self._wild if fspec_row is None else fspec_row
        fut: "queue.Queue" = queue.Queue(maxsize=1)
        self._q.put(Request(np.asarray(query), np.asarray(lo),
                            np.asarray(hi), fut, time.monotonic()))
        return fut

    def search_blocking(self, query, fspec_row=None, timeout=60.0) -> Response:
        return self.submit(query, fspec_row).get(timeout=timeout)

    # ---- server side ----
    def start(self):
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stop(self):
        self._stop.set()
        if self._worker:
            self._worker.join(timeout=30)

    def _drain(self) -> List[Request]:
        """Assembles the next micro-batch.

        The batch deadline is anchored at the *oldest request's enqueue
        time* (``t_enqueue + max_wait_s``), not at drain start: a request
        that aged in the queue while the previous batch was served, or a
        slow trickle of arrivals, cannot stretch batch assembly.  Once the
        deadline passes, only requests already queued are swept in (they
        cost no extra latency) and the batch is served.
        """
        batch: List[Request] = []
        deadline = None
        while len(batch) < self.batch_size and not self._stop.is_set():
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                break
            timeout = self.max_wait_s if deadline is None else deadline - now
            try:
                req = self._q.get(timeout=max(timeout, 1e-4))
            except queue.Empty:
                if batch:
                    break
                continue
            batch.append(req)
            if deadline is None:
                deadline = req.t_enqueue + self.max_wait_s
        # deadline hit or batch full: take whatever is already queued
        while batch and len(batch) < self.batch_size:
            try:
                batch.append(self._q.get_nowait())
            except queue.Empty:
                break
        return batch

    def metrics_text(self) -> str:
        """The server's stage histograms (``queue_wait``) in Prometheus text
        exposition format, a family of their own
        (``repro_server_stage_latency_seconds``)."""
        return render_stage_histograms(self.stages, prefix="repro_server")

    def request_refresh(self):
        """Asks the serving loop to adopt a republished checkpoint.

        Safe from any thread: the flag is drained *between* batches, so the
        generation flip never races a batch mid-flight.  A no-op for
        search_fns without a ``refresh`` attribute.
        """
        self._refresh.set()

    def _maybe_refresh(self):
        if not self._refresh.is_set():
            return
        self._refresh.clear()
        refresh = getattr(self.search_fn, "refresh", None)
        if callable(refresh):
            refresh()
            self.stats["refreshes"] += 1

    def _run(self):
        while not self._stop.is_set():
            self._maybe_refresh()
            batch = self._drain()
            if not batch:
                continue
            self._serve(batch)

    def _serve(self, batch: List[Request]):
        b = len(batch)
        qsz = self.batch_size
        queries = np.zeros((qsz, self.dim), np.float32)
        lo = np.zeros((qsz, self.n_terms, self.n_attrs), np.int16)
        hi = np.zeros((qsz, self.n_terms, self.n_attrs), np.int16)
        for i, r in enumerate(batch):
            queries[i] = r.query
            lo[i] = r.lo
            hi[i] = r.hi
        dev = self.device
        ok = torch.from_numpy(self.health.ok_mask()).to(dev)
        fspec = FilterSpec(lo=torch.from_numpy(lo).to(dev),
                           hi=torch.from_numpy(hi).to(dev))
        t0 = time.monotonic()
        wait = self.stages["queue_wait"]
        for r in batch:
            wait.observe(t0 - r.t_enqueue)
        scores, ids = self.search_fn(torch.from_numpy(queries).to(dev),
                                     fspec, ok)
        scores = scores.cpu().numpy()
        ids = ids.cpu().numpy()
        t1 = time.monotonic()
        # degraded = a shard dropped from the merge OR the fetch layer
        # routing around an open peer circuit
        store_degraded = getattr(self.search_fn, "degraded", None)
        degraded = self.health.degraded or bool(
            store_degraded() if callable(store_degraded) else False)
        self.stats["batches"] += 1
        self.stats["requests"] += b
        self.stats["degraded_batches"] += int(degraded)
        self.stats["total_latency_s"] += t1 - t0
        for i, r in enumerate(batch):
            r.future.put(Response(
                scores=scores[i], ids=ids[i], latency_s=t1 - r.t_enqueue,
                batched_with=b, degraded=degraded))
