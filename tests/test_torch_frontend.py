"""The port's serving tier (iwae_replication_project_tpu_torch/serving/
frontend/, telemetry/tracing.py, telemetry/slo.py): the router's policy on
fake engines and a fake clock, quotas, retry, the protocol framing, the
TCP front end over real localhost sockets, RemoteEngine composition, the
tier's fault sites, and the port's own invariants on tiny real engines on
the CPU -- a 2-replica tier bitwise one direct engine, a replica killed
mid-burst losing nothing, traced results bitwise the untraced ones, the
sharded replica behind the large-k route, a bulk job's bitwise resume and
the CLI's tier and client modes. Cross-package parity with the JAX tier is
in test_torch_tier_parity.py.

Every socket read and every ``Future.result()`` has a timeout: a broken
tier fails its test, it never hangs the suite.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu_torch.models.iwae import (
    ModelConfig,
    init_params,
)
from iwae_replication_project_tpu_torch.parallel import eval as peval
from iwae_replication_project_tpu_torch.serving import cli
from iwae_replication_project_tpu_torch.serving.batcher import (
    EngineOverloaded,
    RequestTimeout,
)
from iwae_replication_project_tpu_torch.serving.buckets import BucketLadder
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine
from iwae_replication_project_tpu_torch.serving.faults import (
    SITE_REMOTE_SEND,
    SITE_ROUTER_DISPATCH,
    SITE_TIER_WRITE,
    crash_replica,
    drop_tier_connection,
    garble_tier_connection,
    sever_remote,
)
from iwae_replication_project_tpu_torch.serving.frontend import (
    ClientQuotas,
    QuotaExceeded,
    QuotaPolicy,
    RemoteEngine,
    ReplicaRouter,
    ReplicaUnavailable,
    RetryPolicy,
    ServingTier,
    TierClient,
    TierOverloaded,
    protocol,
)
from iwae_replication_project_tpu_torch.serving.frontend.client import (
    TierError,
)
from iwae_replication_project_tpu_torch.serving.sharded import (
    ShardedScoreEngine,
)
from iwae_replication_project_tpu_torch.telemetry.slo import (
    SLOMonitor,
    SLOObjective,
    peak_burns,
    window_requests,
)
from iwae_replication_project_tpu_torch.telemetry.tracing import (
    FlightRecorder,
    chrome_trace_events,
    emit_span,
    parse_wire_trace,
    start_span,
)
from iwae_replication_project_tpu_torch.utils import faults

REPO = Path(__file__).resolve().parent.parent
#: the bound of every wait in this file (seconds)
WAIT = 30.0


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeEngine:
    """The engine surface with scripted behaviour (the JAX package's
    tests/test_frontend.py pattern).

    ``mode``: "auto" completes at once with ``seed * 1000 + sum(row)``;
    "manual" holds futures until :meth:`finish`; "shed" raises
    :class:`EngineOverloaded`; "raise" raises RuntimeError at submit.
    """

    def __init__(self, mode="auto", dims=4, k_max=None, sharded=False,
                 ops=("score", "encode", "decode")):
        self.mode = mode
        self.row_dims = {op: dims for op in ops}
        self.k = 5
        if k_max is not None:
            self.k_max = k_max
        if sharded:
            self.sharded = True
        self.lock = threading.Lock()
        self.held = []
        self.submitted = 0
        self.calls = []           # (op, k, seed) per accepted submit
        self.stopped = False

    @staticmethod
    def value(row, seed):
        return float(seed) * 1000.0 + float(sum(row))

    def submit(self, op, row, k=None, *, seed=None, target_se=None,
               ess_floor=None):
        with self.lock:
            if self.mode == "shed":
                raise EngineOverloaded("queue full")
            if self.mode == "raise":
                raise RuntimeError("device on fire")
            self.submitted += 1
            self.calls.append((op, k, seed))
            f = Future()
            if self.mode == "manual":
                self.held.append((list(row), seed, f))
            elif op == "score_adaptive":
                f.set_result([self.value(row, seed), 0.1, float(k) / 2])
            else:
                f.set_result(self.value(row, seed))
            return f

    def finish(self, n=None, exc=None):
        with self.lock:
            batch, self.held = (self.held[:n], self.held[n:]) if n else \
                (self.held, [])
        for row, seed, f in batch:
            try:
                if exc is not None:
                    f.set_exception(exc)
                else:
                    f.set_result(self.value(row, seed))
            except Exception:
                pass
        return len(batch)

    def start(self):
        pass

    def stop(self, timeout_s=None):
        self.stopped = True
        self.finish()

    def warmup(self, ops=()):
        return {"programs": float(len(ops))}


def wait_until(pred, timeout=WAIT, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.002)


def client(tier, **kw):
    kw.setdefault("timeout_s", WAIT)
    return TierClient("127.0.0.1", tier.port, **kw)


@pytest.fixture
def fake_tier():
    engines = [FakeEngine("auto"), FakeEngine("auto")]
    tier = ServingTier(engines, monitor_interval_s=0.05,
                       recorder=FlightRecorder(sample_every=1))
    tier.start()
    yield tier, engines
    tier.stop(timeout_s=10)


@pytest.fixture
def no_faults():
    yield
    faults.clear()


# --------------------------------------------------------------------------
# the router's policy (fake engines, no sockets)
# --------------------------------------------------------------------------

def test_least_inflight_tie_break_lowest_index():
    engines = [FakeEngine("manual") for _ in range(3)]
    r = ReplicaRouter(engines, affinity_slack=0)
    for k in (1, 2, 3, 4):
        r.submit("score", [1, 1, 1, 1], k=k)
    assert [e.submitted for e in engines] == [2, 1, 1]
    for e in engines:
        e.finish()
    r.drain(timeout_s=5)


def test_bucket_affinity_sticky_within_slack():
    engines = [FakeEngine("manual"), FakeEngine("manual")]
    r = ReplicaRouter(engines, affinity_slack=2)
    for _ in range(3):
        r.submit("score", [0, 0, 0, 0], k=7)
    # 3-0 is within the slack of 2 beyond the least-loaded? 2 <= 0 + 2
    # holds for the second and third submits, so the group stays put
    assert [e.submitted for e in engines] == [3, 0]
    r.submit("score", [0, 0, 0, 0], k=7)
    assert [e.submitted for e in engines] == [3, 1]     # past the slack
    assert r.registry.counter("router/affinity_hits").value == 2
    for e in engines:
        e.finish()
    r.drain(timeout_s=5)


def test_seed_minting_admission_order_and_explicit_seed():
    eng = FakeEngine("auto")
    r = ReplicaRouter([eng])
    got = [r.submit("score", [1, 0, 0, 0]).result(timeout=WAIT)
           for _ in range(3)]
    assert got == [1.0, 1001.0, 2001.0]
    assert r.submit("score", [1, 0, 0, 0], seed=77).result(
        timeout=WAIT) == 77001.0
    # an explicit seed does not advance the counter
    assert r.submit("score", [0, 0, 0, 0]).result(timeout=WAIT) == 3000.0


def test_tier_ceiling_sheds_typed():
    eng = FakeEngine("manual")
    r = ReplicaRouter([eng], max_outstanding=2)
    r.submit("score", [0, 0, 0, 0])
    r.submit("score", [0, 0, 0, 0])
    with pytest.raises(TierOverloaded):
        r.submit("score", [0, 0, 0, 0])
    eng.finish()
    wait_until(lambda: r.outstanding == 0, msg="outstanding drained")
    assert r.submit("score", [0, 0, 0, 0]) is not None
    eng.finish()


def test_every_replica_shedding_is_engine_overloaded():
    r = ReplicaRouter([FakeEngine("shed"), FakeEngine("shed")])
    with pytest.raises(EngineOverloaded):
        r.submit("score", [0, 0, 0, 0])
    assert r.outstanding == 0
    assert r.registry.counter("router/sheds").value == 1


def test_replica_failure_reroutes_zero_lost_futures():
    bad, good = FakeEngine("manual"), FakeEngine("manual")
    r = ReplicaRouter([bad, good], affinity_slack=0)
    futs = [r.submit("score", [float(i), 0, 0, 0], k=i + 1)
            for i in range(6)]
    assert bad.submitted == 3 and good.submitted == 3
    bad.finish(exc=RuntimeError("replica died"))
    good.finish()
    good.finish()   # the rerouted ones
    got = [f.result(timeout=WAIT) for f in futs]
    assert got == [i * 1000.0 + i for i in range(6)]  # original seeds
    assert r.registry.counter("router/reroutes").value == 3
    assert r.registry.counter("router/replica_failures").value == 1
    assert [s["healthy"] for s in r.replica_states()] == [False, True]


def test_async_shed_reroutes_without_marking_dead():
    full, peer = FakeEngine("manual"), FakeEngine("auto")
    r = ReplicaRouter([full, peer], affinity_slack=0)
    f = r.submit("score", [1, 0, 0, 0])
    full.finish(exc=EngineOverloaded("async shed"))
    assert f.result(timeout=WAIT) == 1.0
    assert all(s["healthy"] for s in r.replica_states())


def test_request_timeout_is_terminal_no_reroute():
    slow, peer = FakeEngine("manual"), FakeEngine("auto")
    r = ReplicaRouter([slow, peer], affinity_slack=0)
    f = r.submit("score", [0, 0, 0, 0])
    slow.finish(exc=RequestTimeout("expired in queue"))
    with pytest.raises(RequestTimeout):
        f.result(timeout=WAIT)
    assert peer.submitted == 0
    assert all(s["healthy"] for s in r.replica_states())


def test_stall_detection_and_probe_readmission():
    clock = FakeClock()
    wedged, peer = FakeEngine("manual"), FakeEngine("auto")
    r = ReplicaRouter([wedged, peer], stall_deadline_s=1.0, clock=clock,
                      affinity_slack=0)
    f = r.submit("score", [2, 0, 0, 0])
    assert wedged.submitted == 1
    clock.t = 0.5
    assert r.check_stalls() == 0
    clock.t = 2.0
    assert r.check_stalls() == 1
    assert f.result(timeout=WAIT) == 2.0          # rerouted to the peer
    assert r.replica_states()[0]["healthy"] is False
    wedged.mode = "auto"
    assert r.probe_unhealthy() == 1
    assert r.replica_states()[0]["healthy"] is True
    assert r.registry.counter("router/probe_readmits").value == 1


def test_drain_completes_everything_and_leftovers_error():
    held, dead = FakeEngine("manual"), FakeEngine("manual")
    dead.stop = lambda timeout_s=None: None       # a replica that never ends
    r = ReplicaRouter([held, dead], affinity_slack=0)
    a = r.submit("score", [1, 0, 0, 0], k=1)
    b = r.submit("score", [1, 0, 0, 0], k=2)
    r.drain(timeout_s=0.5)
    assert a.result(timeout=WAIT) == 1.0
    with pytest.raises(ReplicaUnavailable):
        b.result(timeout=WAIT)
    with pytest.raises(ReplicaUnavailable):
        r.submit("score", [0, 0, 0, 0])


@pytest.mark.parametrize("op,k,sharded", [
    ("score", None, False), ("score", 16, False), ("score", 17, True),
    ("score", 64, True), ("encode", 16, False), ("decode", None, False),
    ("score_adaptive", 64, True), ("score_adaptive", 8, True)])
def test_large_k_classification(op, k, sharded):
    """score above the threshold goes to the sharded replica, the rest to
    the fast ones; score_adaptive exists only on the sharded replica."""
    fast = FakeEngine("auto", k_max=16)
    big = FakeEngine("auto", k_max=64, sharded=True,
                     ops=("score", "score_adaptive"))
    r = ReplicaRouter([fast, big])
    assert (r.large_k_threshold, r.k_max) == (16, 64)
    kw = {"target_se": 0.5} if op == "score_adaptive" else {}
    r.submit(op, [0, 0, 0, 0], k=k, **kw).result(timeout=WAIT)
    assert (big.submitted, fast.submitted) == ((1, 0) if sharded else (0, 1))
    with pytest.raises(ValueError, match="out of range"):
        r.submit("score", [0, 0, 0, 0], k=65)


def test_adaptive_work_estimate_learns_k_used():
    big = FakeEngine("auto", k_max=64, sharded=True,
                     ops=("score", "score_adaptive"))
    r = ReplicaRouter([big])
    # the fake's k_used is k/2: the EWMA starts at it and moves by 0.3
    r.submit("score_adaptive", [0, 0, 0, 0], k=40,
             target_se=0.5).result(timeout=WAIT)
    r.submit("score_adaptive", [0, 0, 0, 0], k=60,
             target_se=0.5).result(timeout=WAIT)
    est = r.work_estimates()
    assert est == {"score_adaptive/se:e-1": 20.0 + 0.3 * (30.0 - 20.0)}
    # the cap defaults to the fleet's k_max
    r.submit("score_adaptive", [0, 0, 0, 0],
             target_se=0.5).result(timeout=WAIT)
    assert big.calls[-1][1] == 64
    with pytest.raises(ValueError, match="only apply"):
        r.submit("score", [0, 0, 0, 0], target_se=0.5)


def test_fleet_grow_then_shrink_capability_refresh():
    fast = FakeEngine("auto", k_max=64)
    r = ReplicaRouter([fast])
    assert (r.k_max, r.large_k_threshold) == (64, None)
    big = r.add_replica(FakeEngine("auto", k_max=4096, sharded=True))
    assert (r.k_max, r.large_k_threshold) == (4096, 64)
    got = [r.submit("score", [1, 0, 0, 0], k=k).result(timeout=WAIT)
           for k in (8, 1000)]
    assert got == [1.0, 1001.0]
    r.remove_replica(big)
    assert (r.k_max, r.large_k_threshold) == (64, None)
    with pytest.raises(ValueError):
        r.remove_replica(big)
    with pytest.raises(ValueError):
        r.remove_replica(0)
    assert r.profilers() == ()
    r.drain(timeout_s=5)


# --------------------------------------------------------------------------
# quotas, retry, protocol framing
# --------------------------------------------------------------------------

def test_quota_refill_reject_refund_and_isolation():
    clock = FakeClock()
    q = ClientQuotas(QuotaPolicy(rate=2.0, burst=4.0), clock=clock)
    q.admit("a", 4)
    with pytest.raises(QuotaExceeded) as ei:
        q.admit("a", 1)
    assert ei.value.retry_after_s == pytest.approx(0.5)
    q.admit("b", 4)                   # another principal's bucket
    q.admit("a", 1, model="m")        # another model lane
    clock.t = 0.5
    q.admit("a", 1)
    q.refund("a", 10)
    assert q.tokens("a") == 4.0       # clamped at burst
    with pytest.raises(QuotaExceeded) as ei:
        q.admit("a", 5)               # above burst: no wait helps
    assert ei.value.retry_after_s is None
    assert q.clients() == ["a", "b"]
    off = ClientQuotas(None)
    off.admit("a", 1e9)
    assert off.tokens("a") is None and not off.enabled


def test_retry_policy_is_seeded_and_validated():
    p = RetryPolicy(seed=3, base_delay_s=0.01, max_delay_s=0.5)
    a, b = p.backoff(1), p.backoff(1)
    seq = [a.next_delay() for _ in range(8)]
    assert seq == [b.next_delay() for _ in range(8)]
    assert seq != [p.backoff(2).next_delay() for _ in range(8)]
    assert all(0.01 <= d <= 0.5 for d in seq)
    assert p.backoff(1).next_delay(retry_after_s=3.0) == 3.0
    assert not p.retryable("bad_request") and p.retryable("overloaded")
    for bad in (dict(max_attempts=0), dict(base_delay_s=1.0,
                                           max_delay_s=0.5),
                dict(retry_codes=frozenset({"nope"}))):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)


class ChunkSock:
    def __init__(self, data, chunk=3):
        self.data = data
        self.chunk = chunk

    def recv(self, n):
        out, self.data = self.data[:self.chunk], self.data[self.chunk:]
        return out


def test_line_reader_and_error_taxonomy():
    r = protocol.LineReader(ChunkSock(b'{"a":1}\n{"b":2}\n'))
    assert json.loads(r.next_line()) == {"a": 1}
    assert json.loads(r.next_line()) == {"b": 2}
    assert r.next_line() is None
    with pytest.raises(protocol.ProtocolError):
        protocol.LineReader(ChunkSock(b'{"a":')).next_line()
    with pytest.raises(protocol.ProtocolError):
        protocol.LineReader(ChunkSock(b"x" * 100, chunk=50),
                            max_line_bytes=10).next_line()
    code = protocol.error_code_for
    assert code(QuotaExceeded("x")) == "quota_exceeded"
    assert code(TierOverloaded("x")) == code(EngineOverloaded("x")) == \
        "overloaded"
    assert code(RequestTimeout("x")) == "timeout"
    assert code(ReplicaUnavailable("x")) == "unavailable"
    assert code(ValueError("x")) == "bad_request"
    assert code(RuntimeError("x")) == "internal"
    assert protocol.error_response(1, "nope", "m")["error"] == "internal"
    with pytest.raises(protocol.ProtocolError):
        protocol.decode_line(b"[1, 2]")


# --------------------------------------------------------------------------
# tracing and SLO units
# --------------------------------------------------------------------------

def test_wire_trace_parse_and_recorder_tree():
    assert parse_wire_trace("abc") == ("abc", None)
    assert parse_wire_trace("abc/d-1") == ("abc", "d-1")
    for bad in (5, "a/b/c", "x" * 130, "a b", ""):
        with pytest.raises(ValueError):
            parse_wire_trace(bad)
    rec = FlightRecorder(sample_every=1)
    root = start_span("tier/request", recorder=rec)
    child = root.child("router/attempt-1")
    emit_span(child.ctx(), "engine/queue", 0.0, 1.0)
    child.finish()
    assert rec.stats()["open"] == 1 and rec.traces() == []
    root.finish()
    (doc,) = rec.traces()
    assert doc["root"] == "tier/request" and len(doc["spans"]) == 3
    ev = chrome_trace_events([doc])["traceEvents"]
    assert [e["ph"] for e in ev] == ["M", "X", "X", "X"]


def test_slo_burn_rates_on_a_fake_clock():
    clock = FakeClock(100.0)
    mon = SLOMonitor(default=SLOObjective(latency_s=0.1,
                                          latency_target=0.9,
                                          availability_target=0.99),
                     clock=clock)
    for lat, code in ((0.05, None), (0.5, None), (0.05, "internal"),
                      (0.05, None)):
        mon.observe("score", lat, error_code=code)
    snap = mon.snapshot()
    win = snap["score"]["windows"]["5m"]
    assert win["requests"] == 4
    assert win["latency_burn"] == pytest.approx(0.5 / 0.1)
    assert win["availability_burn"] == pytest.approx(0.25 / 0.01)
    assert peak_burns(snap) == {"5m": pytest.approx(25.0),
                                "1h": pytest.approx(25.0)}
    assert window_requests(snap) == {"5m": 4, "1h": 4}
    clock.t = 50.0                                # a clock step back
    mon.observe("score", 0.01)
    assert mon.registry.counter("slo/clock_regressions").value == 1


# --------------------------------------------------------------------------
# the TCP front end over real sockets (fake engines)
# --------------------------------------------------------------------------

def test_tier_end_to_end_out_of_order_ids_and_control_ops(fake_tier):
    tier, _ = fake_tier
    with client(tier) as c:
        ids = [c.submit("score", [[float(i), 0, 0, 0]]) for i in range(5)]
        got = c.drain(ids)
        assert [got[rid]["result"][0] for rid in ids] == \
            [i * 1000.0 + float(i) for i in range(5)]
        info = c.info()
        assert info["replicas"] == 2 and info["ops"] == \
            ["decode", "encode", "score"]
        stats = c.stats()
        assert stats["router"]["router/routed"] == 5
        assert set(stats["store"]) >= {"hits", "misses", "evictions",
                                       "demotions", "readmits",
                                       "resident_bytes", "budget_bytes"}
        assert len(stats["engines"]) == 2
        # a request's span and SLO sample close after its response write
        wait_until(lambda: tier.recorder.stats()["finalized"] == 5,
                   msg="the five traces finalized")
        slo = c.slo()
        assert slo["enabled"] and slo["slo"]["score"]["windows"]["5m"][
            "requests"] == 5
        traces = c.traces(limit=2)
        assert len(traces["traces"]) == 2 and traces["stats"]["finalized"]
        assert "traceEvents" in c.traces(fmt="chrome")


def test_tier_typed_errors_keep_connection_alive(fake_tier):
    tier, engines = fake_tier
    with client(tier) as c:
        c._sock.sendall(b"this is not json\n")
        assert c._read_one()["error"] == "bad_request"
        for bad in (dict(op="score", x=[]), dict(op="nope", x=[[0] * 4]),
                    dict(op="score", x=[[0] * 4], k=0),
                    dict(op="score", x=[[0] * 4], trace="a/b/c"),
                    dict(op="score", x=[[0] * 4], precision="int8"),
                    dict(op="score", x=[[0] * 4, [1] * 4], seed=3),
                    dict(op="score", x=[[0] * 4], seed=2 ** 31),
                    dict(op="score", x=[[0] * 4], target_se=0.5),
                    dict(op="score", x=[[0] * 4], client=5)):
            c._sock.sendall(protocol.encode_line(dict(bad, id="q")))
            resp = c._read_one()
            assert resp["id"] == "q" and resp["error"] == "bad_request", bad
        for e in engines:
            e.mode = "shed"
        with pytest.raises(TierError) as ei:
            c.score([[0, 0, 0, 0]])
        assert ei.value.code == "overloaded"
        assert ei.value.retry_after_s == tier.shed_retry_after_s
        for e in engines:
            e.mode = "auto"
        assert c.score([[1, 0, 0, 0]])       # the same connection serves


def test_quota_rejection_is_typed_then_a_retrying_client_gets_through():
    tier = ServingTier([FakeEngine("auto")],
                       quota=QuotaPolicy(rate=20.0, burst=2))
    tier.start()
    try:
        with client(tier, client_id="t1") as c:
            assert c.score([[0, 0, 0, 0], [0, 0, 0, 0]])
            with pytest.raises(TierError) as ei:
                c.score([[0, 0, 0, 0]])
            assert ei.value.code == "quota_exceeded"
            assert 0 < ei.value.retry_after_s <= 0.05 + 1e-9
        with client(tier, client_id="t1",
                    retry=RetryPolicy(seed=1, deadline_s=10.0)) as c:
            for _ in range(3):
                assert c.score([[1, 0, 0, 0]])
            assert c.retry_stats["retries"] >= 1
        with client(tier, client_id="t1") as c:
            with pytest.raises(TierError) as ei:
                c.score([[0, 0, 0, 0]] * 3)     # above burst: no hint
            assert ei.value.code == "quota_exceeded"
            assert ei.value.retry_after_s is None
        assert tier.registry.counter("router/quota_rejections").value >= 2
    finally:
        tier.stop(timeout_s=10)


def test_quota_refunded_when_routing_rejects():
    eng = FakeEngine("shed")
    tier = ServingTier([eng], quota=QuotaPolicy(rate=0.001, burst=2))
    tier.start()
    try:
        with client(tier, client_id="t1") as c:
            for _ in range(4):
                with pytest.raises(TierError) as ei:
                    c.score([[0, 0, 0, 0]])
                assert ei.value.code == "overloaded"
            eng.mode = "auto"
            assert c.score([[1, 0, 0, 0]])
        assert tier.quotas.tokens("t1") == pytest.approx(1.0, abs=0.01)
    finally:
        tier.stop(timeout_s=10)


def test_tier_mid_burst_replica_kill_loses_nothing():
    bad, good = FakeEngine("manual"), FakeEngine("manual")
    tier = ServingTier([bad, good], monitor_interval_s=0.05,
                       probe_timeout_s=0.2)
    tier.start()
    try:
        with client(tier) as c:
            ids = [c.submit("score", [[float(i), 0, 0, 0]], k=(i % 2) + 1)
                   for i in range(12)]
            wait_until(lambda: bad.submitted + good.submitted == 12,
                       msg="burst routed")
            assert bad.submitted and good.submitted
            bad.finish(exc=RuntimeError("replica killed mid-burst"))
            done = {}
            t = threading.Thread(target=lambda: done.update(c.drain(ids)),
                                 daemon=True)
            t.start()
            deadline = time.monotonic() + WAIT
            while t.is_alive() and time.monotonic() < deadline:
                good.finish()
                time.sleep(0.01)
            t.join(timeout=1)
            assert not t.is_alive(), "burst responses never drained"
            assert [done[rid]["result"][0] for rid in ids] == \
                [i * 1000.0 + float(i) for i in range(12)]
        st = tier.stats()
        assert st["router"]["router/reroutes"] >= 1
        assert st["router"]["router/replica_failures"] == 1
    finally:
        tier.stop(timeout_s=10)


def test_tier_stop_answers_pending_requests():
    eng = FakeEngine("manual")
    tier = ServingTier([eng], monitor_interval_s=0.05)
    tier.start()
    c = client(tier)
    try:
        ids = [c.submit("score", [[1, 0, 0, 0]]) for _ in range(4)]
        wait_until(lambda: eng.submitted == 4, msg="requests routed")
        stopper = threading.Thread(target=tier.stop, daemon=True)
        stopper.start()
        got = c.drain(ids)
        stopper.join(timeout=WAIT)
        assert not stopper.is_alive()
        assert len(got) == 4 and all(got[rid]["ok"] for rid in ids)
    finally:
        c.close()
        tier.stop(timeout_s=5)


def test_client_hedges_a_slow_primary():
    eng = FakeEngine("manual")
    tier = ServingTier([eng], monitor_interval_s=0.05)
    tier.start()
    try:
        with client(tier, retry=RetryPolicy(hedge_after_s=0.05,
                                            deadline_s=10.0)) as c:
            out = {}
            t = threading.Thread(target=lambda: out.update(
                v=c.score([[3, 0, 0, 0]], seed=4)), daemon=True)
            t.start()
            wait_until(lambda: eng.submitted == 2, msg="the hedge sent")
            eng.finish()
            t.join(timeout=WAIT)
            assert out["v"] == [4003.0] and c.retry_stats["hedges"] == 1
    finally:
        tier.stop(timeout_s=10)


# --------------------------------------------------------------------------
# RemoteEngine composition
# --------------------------------------------------------------------------

def test_remote_engine_engine_surface(fake_tier):
    tier, _ = fake_tier
    with RemoteEngine("127.0.0.1", tier.port) as rem:
        assert rem.row_dims == {"score": 4, "encode": 4, "decode": 4}
        assert rem.k == 5 and rem.traces
        assert rem.submit("score", [2.0, 0, 0, 0],
                          seed=9).result(timeout=WAIT) == 9002.0
        with pytest.raises(ValueError):
            rem.submit("nope", [0, 0, 0, 0])
        with pytest.raises(ValueError):
            rem.submit("score", [0, 0])
        with pytest.raises(ValueError):
            rem.submit("score", [0, 0, 0, 0], seed=2 ** 31)
        assert rem.slo(timeout_s=WAIT)["enabled"]


def test_remote_engine_connection_loss_fails_outstanding():
    eng = FakeEngine("manual")
    tier = ServingTier([eng], monitor_interval_s=0.05)
    tier.start()
    rem = RemoteEngine("127.0.0.1", tier.port)
    f = rem.submit("score", [0, 0, 0, 0], seed=1)
    wait_until(lambda: eng.submitted == 1, msg="request routed")
    tier.stop(timeout_s=5)
    wait_until(f.done, msg="future resolution on connection loss")
    if f.exception() is None:
        assert f.result() == 1000.0
    else:
        assert isinstance(f.exception(), ReplicaUnavailable)
    wait_until(lambda: rem._dead is not None, msg="proxy poisoning")
    with pytest.raises(ReplicaUnavailable):
        rem.submit("score", [0, 0, 0, 0])
    rem.close()


def test_parent_router_over_remote_tiers_reroutes_a_dead_child():
    """A parent router over two RemoteEngine hops, each fronting a child
    tier whose engine holds its work: closing one hop reroutes what it held
    to the other child with the parent's original seeds."""
    held_a, held_b = FakeEngine("manual"), FakeEngine("manual")
    child_a = ServingTier([held_a], monitor_interval_s=0.05)
    child_b = ServingTier([held_b], monitor_interval_s=0.05)
    child_a.start(), child_b.start()
    try:
        rem_a = RemoteEngine("127.0.0.1", child_a.port)
        rem_b = RemoteEngine("127.0.0.1", child_b.port)
        parent = ReplicaRouter([rem_a, rem_b], affinity_slack=0)
        futs = [parent.submit("score", [1.0, 0, 0, 0], k=(i % 2) + 1)
                for i in range(6)]
        wait_until(lambda: (held_a.submitted, held_b.submitted) == (3, 3),
                   msg="each child holds three requests")
        rem_b.close()      # the hop dies: its work reroutes to child a
        deadline = time.monotonic() + WAIT
        while not all(f.done() for f in futs) and \
                time.monotonic() < deadline:
            held_a.finish()
            time.sleep(0.01)
        got = [f.result(timeout=WAIT) for f in futs]
        assert got == [i * 1000.0 + 1.0 for i in range(6)]
        assert held_a.submitted == 6
        assert parent.registry.counter("router/reroutes").value == 3
        parent.drain(timeout_s=5)
    finally:
        held_a.finish(), held_b.finish()
        child_a.stop(timeout_s=5), child_b.stop(timeout_s=5)


# --------------------------------------------------------------------------
# the tier's fault sites fire where the JAX package fires them
# --------------------------------------------------------------------------

def test_router_dispatch_site_reroutes(no_faults):
    a, b = FakeEngine("auto"), FakeEngine("auto")
    r = ReplicaRouter([a, b], affinity_slack=0)
    sched = faults.install(faults.FaultSchedule([faults.FaultRule(
        site=SITE_ROUTER_DISPATCH, match=lambda ctx: ctx["replica"] == 0,
        action=faults.raise_fault("dispatch fault"))]))
    assert r.submit("score", [1, 0, 0, 0]).result(timeout=WAIT) == 1.0
    assert (a.submitted, b.submitted) == (0, 1)
    assert sched.log == [(SITE_ROUTER_DISPATCH, SITE_ROUTER_DISPATCH, 1)]
    assert r.registry.counter("router/replica_failures").value == 1


@pytest.mark.parametrize("rule", [drop_tier_connection,
                                  garble_tier_connection])
def test_tier_write_site_and_client_recovery(fake_tier, no_faults, rule):
    tier, _ = fake_tier
    sched = faults.install(faults.FaultSchedule([rule(after=1)]))
    with client(tier, retry=RetryPolicy(seed=2, deadline_s=10.0)) as c:
        assert c.score([[1, 0, 0, 0]], seed=5) == [5001.0]
        # the second response write is dropped or garbled: the client
        # reconnects and retries with the same seed
        assert c.score([[2, 0, 0, 0]], seed=6) == [6002.0]
        assert c.retry_stats["reconnects"] == 1
    assert [entry[1] for entry in sched.log] == [SITE_TIER_WRITE]


def test_remote_send_site_poisons_then_reconnects(fake_tier, no_faults):
    tier, _ = fake_tier
    rem = RemoteEngine("127.0.0.1", tier.port,
                       retry=RetryPolicy(base_delay_s=0.0, max_delay_s=0.0))
    try:
        sched = faults.install(faults.FaultSchedule([sever_remote()]))
        with pytest.raises(ReplicaUnavailable):
            rem.submit("score", [0, 0, 0, 0], seed=1)
        assert [entry[1] for entry in sched.log] == [SITE_REMOTE_SEND]
        assert rem.submit("score", [1, 0, 0, 0],
                          seed=2).result(timeout=WAIT) == 2001.0
        assert rem.reconnects == 1
    finally:
        rem.close()


# --------------------------------------------------------------------------
# tiny real engines on the CPU: the port's own invariants
# --------------------------------------------------------------------------

D = 20
CFG = ModelConfig(x_dim=D, n_hidden_enc=(16, 12), n_latent_enc=(8, 5),
                  n_hidden_dec=(12, 16), n_latent_dec=(8, D),
                  likelihood="logits")
K = 4
KC = 4


@pytest.fixture(scope="module")
def tiny():
    params = init_params(torch.Generator().manual_seed(3), CFG)
    x = (np.random.RandomState(1).rand(40, D) > 0.5).astype(np.float32)
    return {"params": params, "x": x}


def engine(tiny, **kw):
    kw.setdefault("k", K)
    kw.setdefault("max_batch", 8)
    kw.setdefault("timeout_s", WAIT)
    return ServingEngine(params=tiny["params"], model_config=CFG,
                         device="cpu", **kw)


def sharded(tiny, **kw):
    return ShardedScoreEngine(params=tiny["params"], model_config=CFG,
                              device="cpu", k=K, k_chunk=KC, k_max=64,
                              max_batch=8, timeout_s=WAIT, **kw)


def test_two_replica_tier_is_bitwise_one_direct_engine(tiny):
    """Seeds are minted in admission order, so two replicas over TCP return
    bitwise what one direct engine returns for the same rows in the same
    order: routing, padding and the wire are invisible."""
    x = tiny["x"][:17]
    direct = engine(tiny)
    ref = [direct.score(x), direct.encode(x[:5])]
    tier = ServingTier([engine(tiny), engine(tiny)],
                       monitor_interval_s=0.05)
    tier.warmup(ops=("score",))
    tier.start()
    try:
        with client(tier) as c:
            got, i = [], 0
            for n in (1, 3, 7, 2, 4):
                got.extend(c.score(x[i:i + n].tolist()))
                i += n
            enc = c.encode(x[:5].tolist())
        assert np.array_equal(np.asarray(got, np.float32), ref[0])
        assert np.array_equal(np.asarray(enc, np.float32), ref[1])
    finally:
        tier.stop(timeout_s=10)


def test_crashed_real_replica_mid_burst_loses_nothing(tiny, no_faults):
    """crash_replica on one of two real engines mid-burst: every accepted
    request is answered, rerouted rows are bitwise what the direct engine
    returns for their seeds."""
    x = tiny["x"][:24]
    want = engine(tiny).score(x)
    a, b = engine(tiny, max_wait_us=5e4), engine(tiny, max_wait_us=5e4)
    tier = ServingTier([a, b], monitor_interval_s=0.05)
    tier.start()
    faults.install(faults.FaultSchedule([crash_replica(b)]))
    try:
        with client(tier) as c:
            ids = [c.submit("score", [row.tolist()]) for row in x]
            got = c.drain(ids)
        assert all(got[rid]["ok"] for rid in ids)
        assert np.array_equal(
            np.array([got[rid]["result"][0] for rid in ids], np.float32),
            want)
        st = tier.stats()
        assert st["router"]["router/reroutes"] > 0
        assert st["router"]["router/replica_failures"] == 1
    finally:
        faults.clear()
        tier.stop(timeout_s=10)


def _tree(doc):
    by_id = {s["span_id"]: s for s in doc["spans"]}
    return {s["name"]: (by_id[s["parent_id"]]["name"]
                        if s["parent_id"] in by_id else None)
            for s in doc["spans"]}


def test_traced_results_are_bitwise_untraced_and_trees_nest(tiny):
    x = tiny["x"][:6]
    outs = {}
    for tracing in (False, True):
        rec = FlightRecorder(sample_every=1)
        tier = ServingTier([engine(tiny), sharded(tiny)], tracing=tracing,
                           recorder=rec, large_k_threshold=K,
                           monitor_interval_s=0.05)
        tier.start()
        try:
            with client(tier) as c:
                outs[tracing] = (c.score(x.tolist()),
                                 c.score(x[:2].tolist(), k=9))
                # the request span closes after the response write
                wait_until(lambda: rec.stats()["finalized"] == 2 * tracing,
                           msg="both traces finalized")
                docs = c.traces()["traces"]
        finally:
            tier.stop(timeout_s=10)
    assert outs[False] == outs[True]
    assert docs and all(d["root"] == "tier/request" for d in docs)
    fast = _tree(docs[0])
    assert fast["tier/admit"] == "tier/request"
    assert fast["router/attempt-1"] == "tier/request"
    for stage in ("engine/queue", "engine/pad", "engine/dispatch",
                  "engine/device", "engine/fetch"):
        assert fast[stage] == "router/attempt-1", stage
    assert fast["engine/noise"] == fast["engine/launch"] == \
        "engine/dispatch"
    big = next(d for d in docs
               if "engine/args" in {s["name"] for s in d["spans"]})
    attrs = next(s["attrs"] for s in big["spans"]
                 if s["name"] == "engine/dispatch")
    assert attrs["sharded"] and attrs["k"] == 9 and attrs["k_chunk"] == KC
    assert attrs["blocks"] == 3 and attrs["path"] == "reference"


def test_large_k_route_is_bitwise_the_offline_twin(tiny):
    x = tiny["x"][:3]
    big = sharded(tiny)
    tier = ServingTier([engine(tiny, k_max=K), big], large_k_threshold=K,
                       monitor_interval_s=0.05)
    tier.start()
    try:
        with client(tier) as c:
            got = [c.score([row.tolist()], seed=10 + i, k=23)[0]
                   for i, row in enumerate(x)]
            ada = c.score_adaptive([x[0].tolist()], seed=20, k=40,
                                   target_se=0.3)[0]
            with pytest.raises(TierError) as ei:
                c.score([x[0].tolist()], k=65)
            assert ei.value.code == "bad_request"
    finally:
        tier.stop(timeout_s=10)
    # read after the drain: an engine counts a completion after the
    # future's callbacks (the response write among them) ran
    st = tier.stats()
    assert st["replicas"][1]["healthy"] and \
        st["engines"][1]["completed"] == 4
    for i, row in enumerate(x):
        want = peval.sharded_score_offline(
            big._params, big.cfg, big.mesh, 0, [10 + i],
            torch.from_numpy(row[None]), 23, KC)
        assert np.float32(got[i]) == want.numpy()[0]
    want = peval.sharded_score_adaptive_offline(
        big._params, big.cfg, big.mesh, 0, [20],
        torch.from_numpy(x[:1]), k_cap=40, target_se=0.3, k_chunk=KC)
    assert np.array_equal(np.asarray(ada, np.float32), want.numpy()[0])


def test_bulk_job_checkpoints_and_resumes_bitwise(tiny, tmp_path):
    rows = tiny["x"][:12].tolist()
    ck = str(tmp_path / "job")

    def run(tier, **kw):
        with client(tier) as c:
            doc = c.submit_job(rows, k=K, seed=7, checkpoint_dir=ck,
                               checkpoint_every=4, **kw)
            wait_until(lambda: c.job_status(doc["job"])["checkpointed"]
                       == len(rows), msg="job done and checkpointed")
            return c.job_status(doc["job"], results=True)

    tier = ServingTier([engine(tiny)], monitor_interval_s=0.05)
    tier.start()
    try:
        full = run(tier)
    finally:
        tier.stop(timeout_s=10)
    assert full["state"] == "done" and full["checkpointed"] == 12
    want = engine(tiny).score(np.asarray(rows, np.float32))
    # row i runs under seed 7 + i; a direct engine's seeds 0..11 differ,
    # so replay the job's seeds
    direct = engine(tiny)
    fs = [direct.submit("score", r, seed=7 + i) for i, r in
          enumerate(np.asarray(rows, np.float32))]
    direct.flush()
    assert np.array_equal(np.asarray(full["results"], np.float32),
                          np.array([f.result() for f in fs]))
    assert not np.array_equal(want, np.asarray(full["results"], np.float32))
    # retention keeps the newest step and its predecessor (8 and 12 rows):
    # drop the newest, so the resume restores 8 rows and serves 4
    assert sorted(int(d) for d in os.listdir(ck) if d.isdigit()) == [8, 12]
    shutil.rmtree(os.path.join(ck, "12"))
    tier = ServingTier([engine(tiny)], monitor_interval_s=0.05)
    tier.start()
    try:
        again = run(tier, resume=True)
    finally:
        tier.stop(timeout_s=10)
    st = tier.stats()
    assert again["results"] == full["results"]
    assert st["engines"][0]["completed"] == 4
    with pytest.raises(TierError):
        tier2 = ServingTier([engine(tiny)], monitor_interval_s=0.05)
        tier2.start()
        try:
            with client(tier2) as c:
                c.submit_job(rows[:3], k=K, seed=7, checkpoint_dir=ck,
                             resume=True)      # another job's checkpoint
        finally:
            tier2.stop(timeout_s=10)


# --------------------------------------------------------------------------
# the CLI's tier and client modes
# --------------------------------------------------------------------------

def _read_json_line(stream, deadline):
    while time.monotonic() < deadline:
        line = stream.readline()
        if not line:
            return None
        if line.startswith("{"):
            return json.loads(line)
    return None


def test_cli_tier_mode_answers_the_client_mode(tmp_path):
    """The tier mode in a subprocess (stdin held open) and the client mode
    against it: a synthetic load and a score_adaptive k sweep, both exit 0;
    closing stdin drains the tier, which prints its final counters."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    tier = subprocess.Popen(
        [sys.executable, "-m", "iwae_replication_project_tpu_torch.serving",
         "--preset", "digits-vae-1l-k1", "--device", "cpu", "--replicas",
         "2", "--sharded-replicas", "1", "--k-chunk", "8", "--k-max", "64",
         "--k-threshold", "16", "--max-batch", "4", "--port", "0"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
    try:
        ready = _read_json_line(tier.stdout, time.monotonic() + 120)
        assert ready is not None, tier.stderr.read()
        assert ready["tier"]["sharded_replicas"] == 1
        assert ready["tier"]["large_k_threshold"] == 16
        addr = f"127.0.0.1:{ready['tier']['port']}"
        base = [sys.executable, "-m",
                "iwae_replication_project_tpu_torch.serving", "--client",
                addr, "--sizes", "1,3"]
        load = subprocess.run(base + ["--requests", "8"], capture_output=True,
                              text=True, cwd=REPO, env=env, timeout=120)
        sweep = subprocess.run(base + ["--requests", "4", "--k-sweep",
                                       "8,40", "--target-se", "0.5"],
                               capture_output=True, text=True, cwd=REPO,
                               env=env, timeout=120)
        assert load.returncode == 0, load.stderr
        assert sweep.returncode == 0, sweep.stderr
        doc = json.loads(load.stdout.strip().splitlines()[-1])
        assert doc["ok_rows"] == 16 and doc["errors"] == {}
        sw = json.loads(sweep.stdout.strip().splitlines()[-1])
        assert sw["op"] == "score_adaptive" and sw["ok_rows"] == 8
        assert sw["per_k"]["40"]["k_used_max"] <= 40
        tier.stdin.close()
        assert tier.wait(timeout=60) == 0
        final = json.loads(tier.stdout.read().strip().splitlines()[-1])
        assert final["router"]["router/completed"] == 24
    finally:
        if tier.poll() is None:
            tier.kill()
            tier.wait(timeout=10)


def test_cli_client_interactive_forwards_job_ops(tiny):
    tier = ServingTier([engine(tiny)], monitor_interval_s=0.05)
    tier.start()
    lines = [json.dumps({"op": "score", "x": [tiny["x"][0].tolist()],
                         "id": "a"}),
             json.dumps({"op": "submit_job", "x": tiny["x"][:2].tolist(),
                         "k": K, "id": "j"}),
             "not json"]
    try:
        args = cli.build_argparser().parse_args(
            ["--client", f"127.0.0.1:{tier.port}", "--interactive"])
        c = TierClient("127.0.0.1", tier.port, timeout_s=WAIT)
        import io
        import contextlib
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli._client_interactive(c, lines)
        c.close()
        out = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        assert out[0]["id"] == "a" and out[0]["ok"]
        assert out[1]["id"] == "j" and out[1]["result"]["job"] == "job-1"
        assert "error" in out[2] and args.interactive
    finally:
        tier.stop(timeout_s=10)


@pytest.mark.parametrize("argv,match", [
    (["--models", "a,b"], None),
    (["--replicas", "2", "--autoscale"], None),
    (["--autoscale-min", "1"], None),
    (["--metrics-port", "0"], "A10"),
    (["--store-budget-mb", "1"], None),
    (["--pin-core", "0"], "pinned"),
])
def test_cli_refusals_name_their_roadmap_item(argv, match, capsys):
    """A flag still refused names its ROADMAP item; the multi-model
    tier's and the fleet's flags (match None) are ported and parse."""
    if match is None:
        args = cli.build_argparser().parse_args(argv)
        assert args.models == "a,b" or args.autoscale or \
            args.autoscale_min == 1 or args.store_budget_mb == 1
        return
    with pytest.raises(SystemExit) as e:
        cli.build_argparser().parse_args(argv)
    assert e.value.code == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--mesh-dp", "2"], ["--mesh-sp", "2"]])
def test_cli_mesh_larger_than_the_world_is_an_argparse_error(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--replicas", "1"] + argv)
    assert e.value.code == 2
    assert "world of one process" in capsys.readouterr().err


def test_cli_k_split_tiles_the_k_range():
    ap = cli.build_argparser()
    args = ap.parse_args(["--sharded-replicas", "1", "--k-max", "5000"])
    assert cli._k_split(args) == (1024, 1024)
    args = ap.parse_args(["--sharded-replicas", "1", "--k-max", "600"])
    assert cli._k_split(args) == (300, 300)
    with pytest.raises(SystemExit):
        cli._k_split(ap.parse_args(["--sharded-replicas", "1", "--k-max",
                                    "100", "--k-threshold", "100"]))
