"""The port's peer health (circuit breakers) and fault injection against the
JAX package's.

Both packages' breakers and registries are driven through the same call,
latency and clock sequence, one fake clock injected into both, and every
answer (``allow``, ``probe``, ``degraded``) and every snapshot must be
equal after each step.  The reference's own breaker cases run on the port.
``FaultSchedule`` decisions are compared call by call; the chaos wrappers
raise the port's typed transport error and pass latency faults through.
"""

import numpy as np
import pytest

from repro.core import faults as jfaults
from repro.core import health as jhealth
from repro_torch.core import faults as tfaults
from repro_torch.core import health as thealth
from repro_torch.core.health import (CLOSED, HALF_OPEN, OPEN,
                                     CircuitBreaker, PeerHealth)
from repro_torch.core.transport import TransportError


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _breaker(clock, **kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("cooldown_s", 1.0)
    kw.setdefault("half_open_successes", 2)
    return CircuitBreaker(clock=clock, **kw)


# ---- the reference's breaker cases on the port ----


def test_breaker_opens_on_threshold():
    clk = FakeClock()
    br = _breaker(clk)
    for _ in range(2):
        br.record_failure()
    assert br.state == CLOSED
    br.record_failure()
    assert br.state == OPEN
    assert not br.allow()


def test_breaker_no_flapping_on_intermittent_faults():
    clk = FakeClock()
    br = _breaker(clk)
    for _ in range(20):
        br.record_failure()
        br.record_failure()
        br.record_success(0.001)
    assert br.state == CLOSED
    assert br.trips == 0


def test_breaker_half_open_probe_and_close():
    clk = FakeClock()
    br = _breaker(clk)
    for _ in range(3):
        br.record_failure()
    clk.advance(1.1)
    assert br.allow()
    assert br.state == HALF_OPEN
    assert not br.allow()
    br.record_success(0.001)
    assert br.state == HALF_OPEN
    assert br.allow()
    br.record_success(0.001)
    assert br.state == CLOSED


def test_breaker_half_open_failure_escalates_cooldown():
    clk = FakeClock()
    br = _breaker(clk, cooldown_s=1.0, cooldown_factor=2.0,
                  cooldown_max_s=3.0)
    for _ in range(3):
        br.record_failure()
    clk.advance(1.1)
    assert br.allow()
    br.record_failure()
    assert br.state == OPEN
    clk.advance(1.1)
    assert not br.allow()
    clk.advance(1.0)
    assert br.allow()
    br.record_failure()
    clk.advance(2.9)
    assert not br.allow()
    clk.advance(0.2)
    assert br.allow()


def test_breaker_brownout_trips_on_latency_ewma():
    clk = FakeClock()
    br = _breaker(clk, brownout_latency_s=0.05, latency_alpha=0.5)
    br.record_success(0.001)
    for _ in range(8):
        br.record_success(0.2)
        if br.state == OPEN:
            break
    assert br.state == OPEN
    clk.advance(1.1)
    assert br.allow()
    br.record_success(0.001)
    assert br.allow()
    br.record_success(0.001)
    assert br.state == CLOSED


def test_breaker_half_open_slow_answer_is_not_recovery():
    clk = FakeClock()
    br = _breaker(clk, brownout_latency_s=0.05, latency_alpha=1.0)
    br.record_success(0.2)
    assert br.state == OPEN
    clk.advance(1.1)
    assert br.allow()
    br.record_success(0.2)
    assert br.state == OPEN


def test_breaker_rejects_zero_threshold():
    with pytest.raises(ValueError, match="failure_threshold"):
        CircuitBreaker(failure_threshold=0)


def test_peer_health_registry():
    clk = FakeClock()
    ph = PeerHealth([0, 1, 2], breaker_kwargs=dict(failure_threshold=1),
                    clock=clk)
    assert not ph.degraded
    ph.on_failure(1)
    assert ph.state(1) == OPEN and ph.state(0) == CLOSED
    assert ph.degraded
    assert not ph.allow(1)
    clk.advance(1.1)
    calls = []
    assert ph.probe(1, lambda: calls.append(1))
    assert ph.probe(1, lambda: calls.append(1))
    assert calls == [1, 1]
    assert ph.state(1) == CLOSED
    assert not ph.probe(1, lambda: calls.append(1))


# ---- the same sequences through both packages ----

BREAKER_KW = [
    dict(),
    dict(failure_threshold=1, cooldown_s=0.5, half_open_successes=1),
    dict(failure_threshold=2, cooldown_s=1.0, cooldown_factor=3.0,
         cooldown_max_s=5.0, brownout_latency_s=0.05, latency_alpha=0.3),
    dict(failure_threshold=4, brownout_latency_s=0.02, latency_alpha=1.0,
         half_open_successes=3),
]


def _ops(seed, n=300):
    rng = np.random.default_rng(seed)
    kinds = rng.choice(["fail", "ok", "allow", "advance", "snap"], n,
                       p=[0.25, 0.3, 0.2, 0.15, 0.1])
    lat = rng.exponential(0.03, n)
    dt = rng.uniform(0.0, 2.0, n)
    return [(k, float(a), float(b)) for k, a, b in zip(kinds, lat, dt)]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kw", range(len(BREAKER_KW)))
def test_breaker_sequence_matches_reference(kw, seed):
    clk = FakeClock()
    jb = jhealth.CircuitBreaker(clock=clk, **BREAKER_KW[kw])
    tb = thealth.CircuitBreaker(clock=clk, **BREAKER_KW[kw])
    for step, (op, lat, dt) in enumerate(_ops(seed)):
        if op == "fail":
            jb.record_failure()
            tb.record_failure()
        elif op == "ok":
            jb.record_success(lat)
            tb.record_success(lat)
        elif op == "allow":
            assert jb.allow() == tb.allow(), step
        elif op == "advance":
            clk.advance(dt)
        assert tb.snapshot() == jb.snapshot(), (step, op)
    assert tb.trips == jb.trips and tb.trips > 0


@pytest.mark.parametrize("seed", range(3))
def test_peer_health_sequence_matches_reference(seed):
    clk = FakeClock()
    kw = dict(failure_threshold=2, cooldown_s=0.5, half_open_successes=2,
              brownout_latency_s=0.05, latency_alpha=0.5)
    jh = jhealth.PeerHealth([0, 1, 2], breaker_kwargs=kw, clock=clk)
    th = thealth.PeerHealth([0, 1, 2], breaker_kwargs=kw, clock=clk)
    rng = np.random.default_rng(seed)
    for step in range(400):
        node = int(rng.integers(0, 4))  # node 3 joins on first use
        op = rng.choice(["fail", "ok", "allow", "probe", "advance", "drop"],
                        p=[0.25, 0.25, 0.2, 0.15, 0.13, 0.02])
        if op == "fail":
            jh.on_failure(node)
            th.on_failure(node)
        elif op == "ok":
            lat = float(rng.exponential(0.04))
            jh.on_success(node, lat)
            th.on_success(node, lat)
        elif op == "allow":
            assert jh.allow(node) == th.allow(node), step
        elif op == "probe":
            fails = bool(rng.random() < 0.4)

            def ping():
                clk.advance(0.01)
                if fails:
                    raise TransportError("down")

            assert jh.probe(node, ping) == th.probe(node, ping), step
        elif op == "advance":
            clk.advance(float(rng.uniform(0.0, 1.0)))
        else:
            jh.drop(node)
            th.drop(node)
        assert th.snapshot() == jh.snapshot(), step
        assert th.degraded == jh.degraded, step


# ---- fault schedules and wrappers ----


def _rules(mod, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(1, 4))):
        kind = str(rng.choice(mod.FAULT_KINDS))
        count = None if rng.random() < 0.3 else int(rng.integers(1, 4))
        out.append(mod.FaultRule(kind, after=int(rng.integers(0, 5)),
                                 count=count, latency_s=0.0))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fault_schedule_decisions_match_reference(seed):
    js = jfaults.FaultSchedule(_rules(jfaults, seed), seed=seed)
    ts = tfaults.FaultSchedule(_rules(tfaults, seed), seed=seed)
    rng = np.random.default_rng(100 + seed)
    for _ in range(200):
        target = int(rng.integers(0, 3))
        a, b = js.next(target), ts.next(target)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.kind, a.after, a.count, a.latency_s) == (
                b.kind, b.after, b.count, b.latency_s)
    assert dict(ts.injected) == dict(js.injected)
    assert ts.injected_total() == js.injected_total()


def test_fault_rule_and_presets():
    with pytest.raises(ValueError, match="kind"):
        tfaults.FaultRule("explode")
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    for t, j in ((tfaults.kill_peer(3), jfaults.kill_peer(3)),
                 (tfaults.brownout_peer(0.1, 2, 5),
                  jfaults.brownout_peer(0.1, 2, 5))):
        assert [(r.kind, r.after, r.count, r.latency_s) for r in t] == \
            [(r.kind, r.after, r.count, r.latency_s) for r in j]


class _Inner:
    def __init__(self):
        self.fetches = 0

    def fetch(self, cids, gens=None):
        self.fetches += 1
        return {int(c): {} for c in np.asarray(cids)}

    def get(self, cids, gens=None):
        return self.fetch(cids, gens)

    def stats(self):
        return {"kind": "inner"}

    def close(self):
        pass


def test_faulty_transport_and_store():
    sched = tfaults.FaultSchedule(
        (tfaults.FaultRule("refuse", after=1, count=1),
         tfaults.FaultRule("latency", after=2, count=1, latency_s=0.01)))
    inner = _Inner()
    tr = tfaults.FaultyTransport(inner, sched, target=7)
    assert set(tr.fetch([1, 2])) == {1, 2}
    with pytest.raises(TransportError, match="refuse on 7"):
        tr.fetch([1])
    tr.ping()  # the latency fault passes through; _Inner has no ping
    assert inner.fetches == 2
    assert tr.stats()["injected"] == {"refuse": 1, "latency": 1}
    store_sched = tfaults.FaultSchedule((tfaults.FaultRule("truncate",
                                                           count=1),))
    st = tfaults.FaultyBlockStore(inner, store_sched)
    with pytest.raises(ConnectionError, match="truncate"):
        st.get([0])
    assert set(st.get([0], gens=[0])) == {0}


def test_inject_wraps_one_peer_of_a_store():
    class Store:
        transports = {0: _Inner(), 1: _Inner()}

    st = Store()
    sched = tfaults.inject(st, 1, tfaults.kill_peer())
    assert isinstance(st.transports[1], tfaults.FaultyTransport)
    assert not isinstance(st.transports[0], tfaults.FaultyTransport)
    with pytest.raises(TransportError):
        st.transports[1].fetch([0])
    assert sched.injected_total() == 1
