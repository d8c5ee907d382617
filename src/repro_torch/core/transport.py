"""Deadline-bounded block transport: the wire half of the fetch layer; the
port of ``repro.core.transport``.

  * every request carries its own deadline (``timeout_s``): a peer that
    stalls costs one bounded wait, never a hung batch;
  * failures are typed: any short read, reset, refusal or corrupt payload
    raises :class:`TransportError` (a ``ConnectionError``), and the
    connection is discarded, never reused mid-stream;
  * reconnect-on-broken-pipe with capped exponential backoff and jitter
    (``retries`` / ``backoff_s`` / ``backoff_cap_s``, jitter drawn from a
    ``random.Random(seed)``);
  * a small connection pool bounds the requests in flight per peer
    (``max_inflight``);
  * request coalescing: concurrent fetches through one transport issue one
    wire fetch per ``(cluster id, minimum generation)``; followers wait on
    the leader's holder;
  * ``ping()``, a zero-id round trip, is the health layer's active probe.

Wire format (both directions), byte for byte the reference's, so a port
peer and a reference peer talk to each other: ``[u64 big-endian
length][payload]``.  A request is raw little-endian int64 cluster ids
(empty = ping); a first value of ``-2`` marks the gen-stamped request
``[-2, cid0, gen0, cid1, gen1, ...]``.  A response is an npz of
``{cid}:{field}`` arrays, never pickled.

A record here is a dict of CPU tensors.  On the wire each field is the
numpy array the reference would hold: numpy has no bfloat16, and the
reference's bf16 fields travel as 2-byte void words (npz header
``'descr': '<V2'``), so the port writes those exact bytes and reads ``V2``
words (or the int16 words of a field its :class:`BlockSpec` says is bf16)
back as ``torch.bfloat16``.  No thread here touches a CUDA device.
"""

from __future__ import annotations

import io
import random
import socket
import struct
import threading
import time
import zipfile
from typing import Dict, List, Optional

import numpy as np
import torch

Record = Dict[str, torch.Tensor]


class TransportError(ConnectionError):
    """A fetch failed at the transport layer (connect refused, peer closed
    mid-frame, deadline exceeded, corrupt payload).  The health layer
    treats every instance as a passive failure signal."""


class TransportTimeout(TransportError):
    """The per-request deadline expired (connect, send, or receive)."""


_FRAME = struct.Struct(">Q")  # 8-byte big-endian payload length

# Frames beyond this are a protocol violation (a desynced stream decoding
# garbage as a length): fail fast instead of trying to receive it.
_MAX_FRAME = 1 << 40


def _send_frame(sock: socket.socket, payload: bytes):
    # the header and the payload go out as one stream, without a copy of
    # the (possibly GB-sized) payload to prepend the header
    sock.sendall(_FRAME.pack(len(payload)))
    sock.sendall(payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise TransportError(f"peer closed mid-frame ({got}/{n} bytes)")
        got += k
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _FRAME.unpack(_recv_exact(sock, _FRAME.size))
    if n > _MAX_FRAME:
        raise TransportError(f"frame length {n} exceeds protocol maximum "
                             f"(desynced stream?)")
    return _recv_exact(sock, n)


def _write_npy(fid, field) -> None:
    """One npz member, as ``np.savez`` writes the reference's array: a
    bf16 tensor as its 16-bit words under the ``'<V2'`` descr the
    reference's bfloat16 dtype writes, anything else through numpy."""
    if isinstance(field, torch.Tensor):
        t = field.detach().contiguous()
        if t.dtype == torch.bfloat16:
            words = t.view(torch.int16).numpy()
            np.lib.format.write_array_header_1_0(fid, {
                "descr": "<V2", "fortran_order": False,
                "shape": tuple(words.shape)})
            fid.write(words.tobytes("C"))
            return
        field = t.numpy()
    np.lib.format.write_array(fid, np.asanyarray(field), allow_pickle=False)


def _encode_records(recs: Dict[int, Record]) -> bytes:
    """npz-encodes records as ``{cid}:{field}`` arrays, byte for byte the
    reference's ``np.savez`` output: dtype and shape travel in each npy
    header, and decoding never unpickles objects."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for cid, rec in recs.items():
            for field, arr in rec.items():
                with zf.open(f"{cid}:{field}.npy", "w",
                             force_zip64=True) as fid:
                    _write_npy(fid, arr)
    return buf.getvalue()


def _to_tensor(arr: np.ndarray, field: str, spec=None) -> torch.Tensor:
    """A decoded npz array as a CPU tensor: ``V2`` words (and the int16
    words of a field ``spec`` says is bf16) as ``torch.bfloat16``."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(arr)
    if (spec is not None and field == "vectors"
            and spec.store_dtype == torch.bfloat16
            and t.dtype == torch.int16):
        return t.view(torch.bfloat16)
    return t


def _decode_records(payload: bytes, spec=None) -> Dict[int, Record]:
    """Inverse of :func:`_encode_records` (``allow_pickle=False``)."""
    out: Dict[int, Record] = {}
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        for key in z.files:
            cid_s, field = key.split(":", 1)
            out.setdefault(int(cid_s), {})[field] = _to_tensor(
                z[key], field, spec)
    return out


class LoopbackTransport:
    """In-process peer: requests go straight to the peer store (the test
    and bench transport, and a pod talking to its own co-located store)."""

    def __init__(self, store):
        self.store = store

    def fetch(self, cluster_ids, gens=None) -> Dict[int, Record]:
        if gens is None:
            return self.store.get(cluster_ids)
        return self.store.get(cluster_ids, gens=gens)

    def ping(self):
        """Active probe: a zero-id fetch (fails iff the store does)."""
        self.store.get(np.asarray([], np.int64))

    def stats(self) -> dict:
        return self.store.stats()

    def close(self):
        pass


class BlockStoreServer:
    """Serves a store's blocks over the length-prefixed socket protocol.

    One thread per connection; ``port=0`` binds an ephemeral port (read it
    back from ``.port``).  ``close()`` is idempotent and unblocks the
    accepter: besides closing the listening socket it pokes a throwaway
    connection at it, so a blocked ``accept()`` returns and sees the stop
    flag.
    """

    def __init__(self, store, host: str = "127.0.0.1", port: int = 0):
        self.store = store
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()
        self._stopped = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._accepter = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._accepter.start()

    def _accept_loop(self):
        while not self._stopped.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listening socket closed by close()
            if self._stopped.is_set():
                conn.close()
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while not self._stopped.is_set():
                try:
                    req = _recv_frame(conn)
                    raw = np.frombuffer(req, dtype="<i8")
                    if raw.size and raw[0] == -2:
                        # gen-stamped request: [-2, cid0, gen0, ...]
                        body = raw[1:]
                        recs = self.store.get(body[0::2], gens=body[1::2])
                    else:
                        recs = self.store.get(raw)
                    _send_frame(conn, _encode_records(recs))
                except (ConnectionError, OSError):
                    # the client went away, or close() took the socket
                    # from under a handler mid-request: drop the conn
                    return
        finally:
            conn.close()
            with self._conns_lock:
                self._conns.discard(conn)

    def close(self):
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stopped.set()
        # wake a blocked accept() even where closing the listener does not
        try:
            poke = socket.create_connection((self.host, self.port),
                                            timeout=0.5)
            poke.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        self._accepter.join(timeout=5)


class SocketTransport:
    """Pooled, deadline-bounded client half of the block protocol.

    Per-request deadline (``timeout``), reconnect with capped exponential
    backoff and jitter, at most ``max_inflight`` wire requests in flight,
    and request coalescing.  Every failure raises :class:`TransportError`
    (deadlines :class:`TransportTimeout`), and the connection involved is
    discarded.  ``spec`` (a :class:`~repro_torch.core.blockstore.
    BlockSpec`), when given, lets the decoder read a bf16 field that a
    peer sent as int16 words.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0, *,
                 connect_timeout: Optional[float] = None,
                 max_inflight: int = 4, retries: int = 1,
                 backoff_s: float = 0.05, backoff_cap_s: float = 2.0,
                 jitter: float = 0.5, coalesce: bool = True, seed: int = 0,
                 spec=None):
        self.host, self.port, self.timeout = host, port, timeout
        self.connect_timeout = connect_timeout or timeout
        self.max_inflight = max(int(max_inflight), 1)
        self.retries = max(int(retries), 0)
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.jitter = jitter
        self.coalesce = coalesce
        self.spec = spec
        self._rng = random.Random(seed)
        self._sem = threading.BoundedSemaphore(self.max_inflight)
        self._idle: List[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False
        # coalescing: (cid, min_gen) -> [Event, record | exception | None];
        # keyed on the expected generation too, so a follower that needs a
        # republished block never adopts a pre-republish leader's answer
        self._pending: Dict[tuple, list] = {}
        self._co_lock = threading.Lock()
        self.requests = 0
        self.blocks = 0
        self.connects = 0
        self.reconnects = 0
        self.retried = 0
        self.timeouts = 0
        self.errors = 0
        self.coalesced = 0

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    # ---- connection pool ----
    def _checkout(self) -> socket.socket:
        with self._lock:
            if self._closed:
                raise TransportError(f"transport to {self.addr} is closed")
            if self._idle:
                return self._idle.pop()
            first = self.connects == 0
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=self.connect_timeout)
        except OSError as e:
            with self._lock:
                self.errors += 1
            if isinstance(e, (socket.timeout, TimeoutError)):
                raise TransportTimeout(
                    f"connect to {self.addr} timed out") from e
            raise TransportError(f"connect to {self.addr} failed: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._lock:
            self.connects += 1
            if not first:
                self.reconnects += 1
        return sock

    def _checkin(self, sock: socket.socket):
        with self._lock:
            if not self._closed and len(self._idle) < self.max_inflight:
                self._idle.append(sock)
                return
        sock.close()

    @staticmethod
    def _discard(sock: socket.socket):
        try:
            sock.close()
        except OSError:
            pass

    # ---- one wire round trip ----
    def _wire_once(self, payload_req: bytes, n_blocks: int
                   ) -> Dict[int, Record]:
        if not self._sem.acquire(timeout=self.timeout):
            with self._lock:
                self.timeouts += 1
            raise TransportTimeout(
                f"{self.addr}: {self.max_inflight} requests already in "
                f"flight for {self.timeout}s")
        try:
            sock = self._checkout()
            try:
                sock.settimeout(self.timeout)
                _send_frame(sock, payload_req)
                payload = _recv_frame(sock)
                recs = _decode_records(payload, self.spec) if payload else {}
            except BaseException as e:
                # mid-stream state is unknowable: never reuse this socket
                self._discard(sock)
                with self._lock:
                    self.errors += 1
                if isinstance(e, (socket.timeout, TimeoutError)):
                    with self._lock:
                        self.timeouts += 1
                    raise TransportTimeout(
                        f"{self.addr}: no response within "
                        f"{self.timeout}s") from e
                if isinstance(e, TransportError):
                    raise
                if isinstance(e, (ConnectionError, OSError, struct.error,
                                  ValueError, KeyError, EOFError)):
                    # short read / reset / corrupt npz: one typed error
                    raise TransportError(
                        f"{self.addr}: fetch failed: {e}") from e
                raise
            self._checkin(sock)
            with self._lock:
                self.requests += 1
                self.blocks += n_blocks
            return recs
        finally:
            self._sem.release()

    def _fetch_retry(self, cids: List[int],
                     gens: Optional[List[int]] = None) -> Dict[int, Record]:
        if gens is None:
            payload_req = np.asarray(cids, "<i8").tobytes()
        else:
            inter = np.empty(1 + 2 * len(cids), "<i8")
            inter[0] = -2  # gen-stamped request sentinel
            inter[1::2] = cids
            inter[2::2] = gens
            payload_req = inter.tobytes()
        delay = self.backoff_s
        last: Optional[TransportError] = None
        for attempt in range(self.retries + 1):
            if attempt:
                with self._lock:
                    self.retried += 1
                time.sleep(delay * (1.0 + self.jitter * self._rng.random()))
                delay = min(delay * 2.0, self.backoff_cap_s)
            try:
                return self._wire_once(payload_req, len(cids))
            except TransportError as e:
                last = e
        assert last is not None
        raise last

    # ---- public ----
    def fetch(self, cluster_ids, gens=None) -> Dict[int, Record]:
        flat = np.asarray(cluster_ids, np.int64).reshape(-1)
        cids = [int(c) for c in flat]
        if not cids:
            return {}
        exp: Optional[Dict[int, int]] = None
        if gens is not None:
            exp = {int(c): int(g)
                   for c, g in zip(flat, np.asarray(gens).reshape(-1))}

        def want(cid: int) -> int:
            return 0 if exp is None else exp.get(cid, 0)

        def sub_gens(sub: List[int]) -> Optional[List[int]]:
            return None if exp is None else [want(c) for c in sub]

        if not self.coalesce:
            return self._fetch_retry(cids, sub_gens(cids))
        mine: List[int] = []
        follow: Dict[int, list] = {}
        with self._co_lock:
            for cid in dict.fromkeys(cids):  # unique, first-need order
                key = (cid, want(cid))
                holder = self._pending.get(key)
                if holder is None:
                    self._pending[key] = holder = [threading.Event(), None]
                    mine.append(cid)
                else:
                    follow[cid] = holder
        out: Dict[int, Record] = {}
        if mine:
            try:
                recs = self._fetch_retry(mine, sub_gens(mine))
            except BaseException as e:
                with self._co_lock:
                    for cid in mine:
                        holder = self._pending.pop((cid, want(cid)), None)
                        if holder is not None:
                            holder[1] = e
                            holder[0].set()
                raise
            with self._co_lock:
                for cid in mine:
                    holder = self._pending.pop((cid, want(cid)), None)
                    if holder is not None:
                        holder[1] = recs.get(cid)
                        holder[0].set()
            out.update(recs)
        # the leader's own deadline and backoff budget bound this wait; the
        # slack keeps a racing leader's bookkeeping from tripping it early
        budget = (self.retries + 1) * self.timeout + 2 * self.backoff_cap_s
        for cid, holder in follow.items():
            got = holder[0].wait(timeout=budget + 5.0)
            rec = holder[1] if got else None
            if rec is None or isinstance(rec, BaseException):
                # the leader failed or stalled: fetch this id directly, so
                # one bad leader does not fail every coalesced follower
                out.update(self._fetch_retry([cid], sub_gens([cid])))
            else:
                with self._lock:
                    self.coalesced += 1
                out[cid] = rec
        return out

    def ping(self):
        """Active probe: one empty request/response round trip (no retries:
        the health layer decides how often to knock)."""
        self._wire_once(b"", 0)

    def stats(self) -> dict:
        with self._lock:
            return dict(
                kind="socket", addr=self.addr, requests=self.requests,
                blocks=self.blocks, connects=self.connects,
                reconnects=self.reconnects, retries=self.retried,
                timeouts=self.timeouts, errors=self.errors,
                coalesced=self.coalesced)

    def close(self):
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for sock in idle:
            self._discard(sock)
