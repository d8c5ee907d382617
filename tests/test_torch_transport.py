"""The port's block transport against the JAX package's, on the same
checkpoints.

The wire is byte for byte the reference's: frames, requests and the npz
response bodies (f32, bf16 and SQ8 records alike; a bf16 field travels as
the 2-byte words the reference writes under ``'descr': '<V2'``).  The
port's client reads the reference's server and the reference's client
reads the port's server, both ways with the records equal.  The typed
errors, the deadline, coalescing, ``ping`` and the server's close are the
reference's cases on the port.  Every socket test binds port 0, uses
deadlines of at most 5 s and joins every thread it starts with a timeout.
"""

import socket
import struct
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import blockstore as jbs
from repro.core import faults as jfaults
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import storage as js
from repro.core import transport as jtr
from repro_torch.core import blockstore as tbs
from repro_torch.core import faults as tfaults
from repro_torch.core import transport as ttr

N, D, M, KC = 512, 16, 4, 6
CIDS = [0, 5, 3]
VARIANTS = ("f32", "bf16", "sq8")


def _index(variant):
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = (np.arange(N) * KC) // N
    core = centers[topic] + 0.1 * rng.standard_normal((N, D)).astype(
        np.float32)
    attrs = rng.integers(0, 100, (N, M)).astype(np.int16)
    dtype = jnp.bfloat16 if variant == "bf16" else jnp.float32
    spec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=dtype)
    index, _ = jivf.build_from_assignments(
        spec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic))
    return jivf.quantize_index(index) if variant == "sq8" else index


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{variant: checkpoint the JAX package wrote}."""
    out = {}
    for v in VARIANTS:
        out[v] = str(tmp_path_factory.mktemp(f"wire_{v}"))
        js.save_index(_index(v), out[v], n_shards=2)
    return out


def _assert_records_equal(want, got):
    """A reference record (numpy; bf16 as ml_dtypes or V2 words) against a
    port record (tensors), bytes and shapes exact."""
    assert set(want) == set(got)
    for cid in want:
        assert set(want[cid]) == set(got[cid]), cid
        for field, arr in want[cid].items():
            t = got[cid][field]
            arr = np.asarray(arr)
            if arr.dtype.kind == "V" or arr.dtype == ml_dtypes.bfloat16:
                assert t.dtype == torch.bfloat16, field
                t = t.view(torch.int16)
                arr = arr.view(np.int16)
            assert t.shape == arr.shape, field
            np.testing.assert_array_equal(t.numpy(), arr, err_msg=field)


# ---- framing and encoding ----


def test_frames_byte_identical():
    for payload in (b"", b"x", np.arange(7, dtype="<i8").tobytes()):
        a, b = socket.socketpair()
        c, d = socket.socketpair()
        try:
            jtr._send_frame(a, payload)
            ttr._send_frame(c, payload)
            assert b.recv(1 << 16) == d.recv(1 << 16)
            ttr._send_frame(a, payload)
            assert jtr._recv_frame(b) == payload
            jtr._send_frame(c, payload)
            assert ttr._recv_frame(d) == payload
        finally:
            for s in (a, b, c, d):
                s.close()
    assert ttr._MAX_FRAME == jtr._MAX_FRAME


def test_oversized_frame_length_raises_typed_error():
    a, b = socket.socketpair()
    try:
        a.sendall(ttr._FRAME.pack(ttr._MAX_FRAME + 1))
        with pytest.raises(ttr.TransportError, match="protocol maximum"):
            ttr._recv_frame(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("variant", VARIANTS)
def test_encode_records_byte_equal_to_reference(ckpts, variant):
    """The same clusters read by each package's store encode to the same
    bytes, and each package decodes the other's payload to its records."""
    jstore = jbs.LocalBlockStore.open(ckpts[variant])
    tstore = tbs.LocalBlockStore.open(ckpts[variant], device="cpu")
    try:
        jrecs, trecs = jstore.get(CIDS), tstore.get(CIDS)
        jpay, tpay = jtr._encode_records(jrecs), ttr._encode_records(trecs)
        assert jpay == tpay
        if variant == "bf16":
            assert b"'descr': '<V2'" in tpay
        _assert_records_equal(jrecs, ttr._decode_records(jpay))
        _assert_records_equal(jtr._decode_records(tpay), trecs)
        assert ttr._encode_records({}) == jtr._encode_records({})
    finally:
        jstore.close()
        tstore.close()


def test_decode_reads_int16_words_of_a_bf16_field_by_spec(ckpts):
    """A peer that sends a bf16 field as int16 words: with the record's
    BlockSpec the decoder reads them as bf16; attrs stay int16."""
    tstore = tbs.LocalBlockStore.open(ckpts["bf16"], device="cpu")
    try:
        rec = tstore.get([2])[2]
        words = {2: {f: (t.view(torch.int16) if t.dtype == torch.bfloat16
                         else t) for f, t in rec.items()}}
        pay = ttr._encode_records(words)
        plain = ttr._decode_records(pay)[2]
        assert plain["vectors"].dtype == torch.int16
        got = ttr._decode_records(pay, tstore.spec)[2]
        assert got["vectors"].dtype == torch.bfloat16
        assert torch.equal(got["vectors"], rec["vectors"])
        assert got["attrs"].dtype == torch.int16
    finally:
        tstore.close()


def test_decode_never_unpickles():
    import io

    buf = io.BytesIO()
    np.savez(buf, **{"0:obj": np.asarray([{"a": 1}], dtype=object)})
    with pytest.raises(ValueError):
        ttr._decode_records(buf.getvalue())


# ---- interop, both ways ----


@pytest.mark.parametrize("variant", VARIANTS)
def test_port_client_against_reference_server(ckpts, variant):
    jstore = jbs.LocalBlockStore.open(ckpts[variant])
    srv = jtr.BlockStoreServer(jstore)
    client = ttr.SocketTransport(srv.host, srv.port, timeout=5.0)
    try:
        _assert_records_equal(jstore.get(CIDS), client.fetch(CIDS))
        gens = np.zeros(len(CIDS), np.int64)
        _assert_records_equal(jstore.get(CIDS),
                              client.fetch(CIDS, gens=gens))
        assert client.fetch([]) == {}
        client.ping()
        s = client.stats()
        assert s["blocks"] == 2 * len(CIDS) and s["requests"] == 3
    finally:
        client.close()
        srv.close()
        jstore.close()


@pytest.mark.parametrize("variant", VARIANTS)
def test_reference_client_against_port_server(ckpts, variant):
    tstore = tbs.LocalBlockStore.open(ckpts[variant], device="cpu")
    jstore = jbs.LocalBlockStore.open(ckpts[variant])
    srv = ttr.BlockStoreServer(tstore)
    client = jtr.SocketTransport(srv.host, srv.port, timeout=5.0)
    try:
        got = client.fetch(CIDS)
        _assert_records_equal(got, tstore.get(CIDS))
        # the reference client's records are the reference store's words
        want = jstore.get(CIDS)
        for cid in CIDS:
            for field, arr in want[cid].items():
                assert np.asarray(arr).tobytes() == got[cid][field].tobytes()
        got_g = client.fetch(CIDS, gens=np.zeros(len(CIDS), np.int64))
        assert set(got_g) == set(CIDS)
        client.ping()
    finally:
        client.close()
        srv.close()
        tstore.close()
        jstore.close()


def test_socket_transport_roundtrip(ckpts):
    """The reference's test_socket_transport_roundtrip on the port."""
    local = tbs.LocalBlockStore.open(ckpts["f32"], device="cpu")
    server = ttr.BlockStoreServer(local)
    client = ttr.SocketTransport(server.host, server.port, timeout=5.0)
    try:
        want = local.get(CIDS)
        got = client.fetch(CIDS)
        assert set(got) == set(CIDS)
        for cid in got:
            for field, t in want[cid].items():
                assert torch.equal(got[cid][field], t), field
        assert client.fetch([]) == {}
        assert client.stats()["blocks"] == 3
    finally:
        client.close()
        server.close()
        local.close()


# ---- typed errors and the deadline ----


def _rogue_server(behavior):
    """One-shot server: accepts one connection, reads the request frame,
    then misbehaves per ``behavior(conn)``.  Returns (host, port, thread)."""
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    lsock.settimeout(5.0)
    host, port = lsock.getsockname()

    def run():
        try:
            conn, _ = lsock.accept()
        except OSError:
            lsock.close()
            return
        try:
            conn.settimeout(5.0)
            ttr._recv_frame(conn)
            behavior(conn)
        except OSError:
            pass
        finally:
            conn.close()
            lsock.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return host, port, t


def test_short_read_raises_typed_error_not_decode_garbage():
    def close_mid_payload(conn):
        conn.sendall(ttr._FRAME.pack(1000) + b"xy")  # promise 1000, send 2

    host, port, t = _rogue_server(close_mid_payload)
    tr = ttr.SocketTransport(host, port, timeout=5.0, retries=0)
    try:
        with pytest.raises(ttr.TransportError) as ei:
            tr.fetch([0, 1])
        assert isinstance(ei.value, ConnectionError)
        assert not isinstance(ei.value, struct.error)
        assert tr.stats()["errors"] == 1
    finally:
        tr.close()
        t.join(timeout=5)
    assert not t.is_alive()


def test_corrupt_payload_raises_typed_error():
    def garbage_payload(conn):
        ttr._send_frame(conn, b"this is not an npz archive")

    host, port, t = _rogue_server(garbage_payload)
    tr = ttr.SocketTransport(host, port, timeout=5.0, retries=0)
    try:
        with pytest.raises(ttr.TransportError):
            tr.fetch([0])
    finally:
        tr.close()
        t.join(timeout=5)
    assert not t.is_alive()


def test_connection_refused_raises_typed_error():
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    host, port = lsock.getsockname()
    lsock.close()  # nothing listens here
    tr = ttr.SocketTransport(host, port, timeout=1.0, retries=1,
                             backoff_s=0.01)
    try:
        with pytest.raises(ttr.TransportError):
            tr.fetch([0])
        s = tr.stats()
        assert s["retries"] == 1  # the backoff and retry ran
        assert s["errors"] == 2 and s["connects"] == 0
    finally:
        tr.close()


def test_closed_transport_raises_typed_error():
    tr = ttr.SocketTransport("127.0.0.1", 9, timeout=1.0, retries=0)
    tr.close()
    with pytest.raises(ttr.TransportError, match="closed"):
        tr.fetch([0])


def test_deadline_bounded_fetch(ckpts):
    """A server stalled past the client deadline costs one bounded wait
    and a TransportTimeout."""
    lstore = tbs.LocalBlockStore.open(ckpts["f32"], device="cpu")
    sched = tfaults.FaultSchedule((tfaults.FaultRule("latency",
                                                     latency_s=2.0),))
    srv = ttr.BlockStoreServer(tfaults.FaultyBlockStore(lstore, sched))
    tr = ttr.SocketTransport(srv.host, srv.port, timeout=0.3, retries=0)
    t0 = time.monotonic()
    try:
        with pytest.raises(ttr.TransportTimeout):
            tr.fetch([0])
        assert time.monotonic() - t0 < 2.0
        assert tr.stats()["timeouts"] >= 1
    finally:
        tr.close()
        srv.close()
        # the stalled handler reads the store when its sleep ends
        time.sleep(max(2.3 - (time.monotonic() - t0), 0.0))
        lstore.close()


def test_backoff_jitter_follows_the_reference_stream(monkeypatch):
    """Retries sleep base·2^i·(1 + jitter·u) with u from random.Random(seed),
    capped: the same sleeps as the reference's client."""
    def sleeps(mod):
        got = []
        monkeypatch.setattr(mod.time, "sleep", got.append)
        lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lsock.bind(("127.0.0.1", 0))
        host, port = lsock.getsockname()
        lsock.close()
        tr = mod.SocketTransport(host, port, timeout=1.0, retries=4,
                                 backoff_s=0.05, backoff_cap_s=0.15, seed=7)
        with pytest.raises(mod.TransportError):
            tr.fetch([1])
        tr.close()
        monkeypatch.undo()
        return got

    want, got = sleeps(jtr), sleeps(ttr)
    assert len(got) == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


# ---- coalescing, ping, server close ----


def test_coalescing_one_wire_fetch_per_cluster(ckpts):
    lstore = tbs.LocalBlockStore.open(ckpts["f32"], device="cpu")
    sched = tfaults.FaultSchedule((tfaults.FaultRule("latency",
                                                     latency_s=0.3),))
    srv = ttr.BlockStoreServer(tfaults.FaultyBlockStore(lstore, sched))
    tr = ttr.SocketTransport(srv.host, srv.port, timeout=5.0)
    try:
        res = [None, None]

        def go(i):
            res[i] = tr.fetch([0, 1, 2])

        ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        ts[0].start()
        time.sleep(0.1)  # the leader is mid-flight (0.3 s server stall)
        ts[1].start()
        for t in ts:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in ts)
        assert res[0].keys() == res[1].keys() == {0, 1, 2}
        for cid in (0, 1, 2):
            assert torch.equal(res[0][cid]["ids"], res[1][cid]["ids"])
        s = tr.stats()
        assert s["coalesced"] == 3 and s["requests"] == 1
    finally:
        tr.close()
        srv.close()
        lstore.close()


class _GenStore:
    """A store that answers each cluster at the generation asked for, the
    first request 0.3 s late."""

    def __init__(self):
        self.calls = 0

    def get(self, cids, gens=None):
        self.calls += 1
        if self.calls == 1:
            time.sleep(0.3)
        gens = np.zeros(len(cids), np.int64) if gens is None else gens
        return {int(c): {"ids": torch.arange(2, dtype=torch.int32),
                         "gen": torch.tensor([int(g)])}
                for c, g in zip(np.asarray(cids), np.asarray(gens))}


@pytest.mark.parametrize("follower_gen", [0, 5])
def test_coalescing_is_keyed_on_the_generation(follower_gen):
    """A follower asking for the leader's generation adopts its answer; one
    asking for a newer generation goes to the wire itself."""
    srv = ttr.BlockStoreServer(_GenStore())
    tr = ttr.SocketTransport(srv.host, srv.port, timeout=5.0)
    try:
        t = threading.Thread(target=tr.fetch, args=([1],),
                             kwargs=dict(gens=[0]))
        t.start()
        time.sleep(0.1)  # the leader is mid-flight
        got = tr.fetch([1], gens=[follower_gen])
        t.join(timeout=10)
        assert not t.is_alive()
        assert int(got[1]["gen"][0]) == follower_gen
        s = tr.stats()
        same = follower_gen == 0
        assert s["coalesced"] == int(same)
        assert s["requests"] == 1 + int(not same)
    finally:
        tr.close()
        srv.close()


def test_ping_round_trip(ckpts):
    lstore = tbs.LocalBlockStore.open(ckpts["f32"], device="cpu")
    srv = ttr.BlockStoreServer(lstore)
    tr = ttr.SocketTransport(srv.host, srv.port, timeout=5.0)
    try:
        tr.ping()  # a real empty-request wire exchange
        assert tr.stats()["requests"] == 1
        srv.close()
        with pytest.raises(ttr.TransportError):
            tr.ping()  # dead server: the probe's failure signal
    finally:
        tr.close()
        lstore.close()


def test_loopback_transport():
    peer = jbs.LoopbackTransport  # the reference's, for the surface
    assert set(dir(peer)) - set(dir(object)) <= set(dir(ttr.LoopbackTransport))

    class Store:
        def __init__(self):
            self.calls = []

        def get(self, cids, gens=None):
            self.calls.append((list(np.asarray(cids)), gens))
            return {}

        def stats(self):
            return {"kind": "fake"}

    st = Store()
    tr = ttr.LoopbackTransport(st)
    tr.fetch([1, 2])
    tr.fetch([3], gens=[4])
    tr.ping()
    assert st.calls == [([1, 2], None), ([3], [4]), ([], None)]
    assert tr.stats() == {"kind": "fake"}
    tr.close()


def test_server_close_is_idempotent_and_unblocks_accepter(ckpts):
    lstore = tbs.LocalBlockStore.open(ckpts["f32"], device="cpu")
    srv = ttr.BlockStoreServer(lstore)
    assert srv._accepter.is_alive()
    srv.close()
    assert not srv._accepter.is_alive()
    srv.close()  # double close: no-op
    assert not srv._accepter.is_alive()
    lstore.close()


def test_server_close_with_request_in_flight(ckpts):
    """close() while a handler is mid-request returns promptly, the client
    gets a typed error, and the accepter is gone."""
    lstore = tbs.LocalBlockStore.open(ckpts["f32"], device="cpu")
    sched = tfaults.FaultSchedule((tfaults.FaultRule("latency",
                                                     latency_s=1.0),))
    srv = ttr.BlockStoreServer(tfaults.FaultyBlockStore(lstore, sched))
    tr = ttr.SocketTransport(srv.host, srv.port, timeout=5.0, retries=0)
    errs = []

    def go():
        try:
            tr.fetch([0, 1])
        except ttr.TransportError as e:
            errs.append(e)

    t = threading.Thread(target=go)
    t.start()
    time.sleep(0.2)  # the request is in flight, its handler in the store
    t0 = time.monotonic()
    srv.close()
    assert time.monotonic() - t0 < 5.0
    t.join(timeout=5)
    assert not t.is_alive()
    assert not srv._accepter.is_alive()
    assert len(errs) == 1
    tr.close()
    time.sleep(1.0)  # the handler reads the store when its sleep ends
    lstore.close()


def test_reference_faulty_store_behind_port_server(ckpts):
    """The reference's chaos store behind the port's server: a refused
    request surfaces at the port's client as a typed error."""
    jstore = jbs.LocalBlockStore.open(ckpts["f32"])
    sched = jfaults.FaultSchedule((jfaults.FaultRule("refuse", count=1),))
    srv = ttr.BlockStoreServer(jfaults.FaultyBlockStore(jstore, sched))
    tr = ttr.SocketTransport(srv.host, srv.port, timeout=5.0, retries=0)
    try:
        with pytest.raises(ttr.TransportError):
            tr.fetch([0])
        assert set(tr.fetch([0, 1])) == {0, 1}  # the next op passes
    finally:
        tr.close()
        srv.close()
        jstore.close()
