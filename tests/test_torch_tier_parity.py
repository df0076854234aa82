"""The port's serving tier against the JAX package's: the wire bytes of
every request and response form, the policies (retry, quotas, the router's
decisions, tracing's wire field, SLO burn rates) on the same scripts, the
two packages' clients and tiers talking to each other over TCP in both
directions, a port router over remote tiers of both packages, and the
results of a port tier against a JAX tier of the same weights on the same
requests, the port's noise replayed from JAX's per-row ``fold_in`` draws
(fast route) and per-(row, block) draws (the large-k route and
``score_adaptive``).

Tolerances: per-request scores (atol 1e-3, rtol 1e-5), latent means
(1e-5, 1e-5) and pixel probabilities (1e-6, 1e-5) as
test_torch_serving.py holds the same programs; the adaptive rows' log p_hat
as a score, their achieved SE to rtol 1e-3 and k_used exactly, at a target
kept 1% away from every row's round-boundary SE, as
test_torch_sharded_serving.py does.
"""

import json
import math
import random
import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.parallel.mesh import make_mesh as jmesh
from iwae_replication_project_tpu.serving import batcher as jbatcher
from iwae_replication_project_tpu.serving import frontend as jfront
from iwae_replication_project_tpu.serving.buckets import (
    BucketLadder as JLadder,
)
from iwae_replication_project_tpu.serving.engine import (
    ServingEngine as JEngine,
)
from iwae_replication_project_tpu.serving.frontend import (
    protocol as jprotocol,
)
from iwae_replication_project_tpu.serving.frontend import retry as jretry
from iwae_replication_project_tpu.serving.sharded import (
    ShardedScoreEngine as JSharded,
)
from iwae_replication_project_tpu.telemetry import slo as jslo
from iwae_replication_project_tpu.telemetry import tracing as jtracing
from iwae_replication_project_tpu_torch.models import iwae as tmodel
from iwae_replication_project_tpu_torch.serving import batcher as tbatcher
from iwae_replication_project_tpu_torch.serving import frontend as tfront
from iwae_replication_project_tpu_torch.serving.buckets import (
    BucketLadder as TLadder,
)
from iwae_replication_project_tpu_torch.serving.engine import (
    ServingEngine as TEngine,
)
from iwae_replication_project_tpu_torch.serving.frontend import (
    protocol as tprotocol,
)
from iwae_replication_project_tpu_torch.serving.frontend import (
    retry as tretry,
)
from iwae_replication_project_tpu_torch.serving.sharded import (
    ShardedScoreEngine as TSharded,
)
from iwae_replication_project_tpu_torch.telemetry import slo as tslo
from iwae_replication_project_tpu_torch.telemetry import tracing as ttracing
from torch_parity import (
    binary_rows,
    block_noise,
    configs,
    params,
    row_decode_noise,
    row_encode_noise,
)

WAIT = 60.0
PKG = {"jax": (jfront, jprotocol, jbatcher), "port": (tfront, tprotocol,
                                                       tbatcher)}


# --------------------------------------------------------------------------
# the wire: every request and response form, byte for byte
# --------------------------------------------------------------------------

ODD_IDS = [None, 0, -1, 7, 2 ** 63, 1.5, "abc", "ünï/cödé", [1, "x"],
           {"nested": [None, True]}, True, ""]
ROW = [0.0, 1.0, 0.5, -2.25]


def _requests():
    out = []
    for op in ("score", "encode", "decode", "score_adaptive"):
        out.append({"op": op, "x": ROW})
        out.append({"op": op, "x": [ROW, ROW]})
    full = {"op": "score", "x": [ROW], "k": 50, "id": 3, "client": "t-a",
            "model": "table1-iwae-1l-k50", "trace": "abc/d-1", "seed": 17,
            "precision": "bf16"}
    out.append(full)
    out.append({"op": "score_adaptive", "x": [ROW], "k": 5000,
                "target_se": 0.1, "ess_floor": 64, "seed": 0})
    for key in ("trace", "seed", "model", "client", "k"):
        out.append({kk: v for kk, v in full.items() if kk != key})
    out += [{"op": "info"}, {"op": "stats", "id": "s"},
            {"op": "traces", "limit": 5, "trace_id": "abc",
             "format": "chrome"}, {"op": "traces"}, {"op": "slo"},
            {"op": "submit_job", "job_op": "score_adaptive",
             "x": [ROW, ROW], "k": 5000, "target_se": 0.1, "seed": 7,
             "client": "t-a", "checkpoint_dir": "/p", "checkpoint_every":
             256, "resume": False},
            {"op": "job_status", "job": "job-1", "results": True}]
    out += [dict(out[0], id=i) for i in ODD_IDS]
    return out


def _responses(proto):
    out = [proto.ok_response(i, r) for i in ODD_IDS[:4]
           for r in ([1.5], [[0.1, 0.2]], [[-3.0, 0.01, 250.0]], {"a": 1})]
    for code in proto.ERROR_CODES + ("no_such_code",):
        for hint in (None, 0.0, 0.25, -1.0, 3):
            out.append(proto.error_response(5, code, f"{code}: msg",
                                            retry_after_s=hint))
    return out


def test_wire_bytes_equal_over_the_corpus():
    reqs = _requests()
    for obj in reqs:
        a, b = jprotocol.encode_line(obj), tprotocol.encode_line(obj)
        assert a == b, obj
        assert jprotocol.decode_line(a[:-1]) == \
            tprotocol.decode_line(a[:-1]) == obj
    ja, ta = _responses(jprotocol), _responses(tprotocol)
    assert len(ja) == len(ta) == 16 + 7 * 5
    for x, y in zip(ja, ta):
        assert jprotocol.encode_line(x) == tprotocol.encode_line(y)
    assert jprotocol.ERROR_CODES == tprotocol.ERROR_CODES
    assert jprotocol.CONTROL_OPS == tprotocol.CONTROL_OPS
    assert jprotocol.JOB_OPS == tprotocol.JOB_OPS
    assert jprotocol.MAX_LINE_BYTES == tprotocol.MAX_LINE_BYTES


@pytest.mark.parametrize("bad", [b"[1, 2]", b"{nope", b"\xff\xfe{", b"3",
                                 b'"s"', b""])
def test_decode_errors_agree(bad):
    for proto in (jprotocol, tprotocol):
        with pytest.raises(proto.ProtocolError):
            proto.decode_line(bad)


class ChunkSock:
    def __init__(self, data, chunk):
        self.data = data
        self.chunk = chunk

    def recv(self, n):
        out, self.data = self.data[:self.chunk], self.data[self.chunk:]
        return out


def _read_all(proto, data, chunk, bound):
    r = proto.LineReader(ChunkSock(data, chunk), max_line_bytes=bound)
    lines = []
    try:
        while True:
            line = r.next_line()
            if line is None:
                return lines, None
            lines.append(line)
    except proto.ProtocolError as e:
        return lines, type(e).__name__


@pytest.mark.parametrize("chunk", [1, 3, 7, 64, 65536])
def test_line_reader_agrees_on_chunked_input(chunk):
    body = b"".join(tprotocol.encode_line(o) for o in _requests())
    for data, bound in ((body, 1 << 20), (body + b'{"tail":', 1 << 20),
                        (body, 40), (b"\n\n{}\n", 8)):
        assert _read_all(jprotocol, data, chunk, bound) == \
            _read_all(tprotocol, data, chunk, bound)


def test_error_codes_of_matching_exceptions():
    pairs = [(jfront.QuotaExceeded("x"), tfront.QuotaExceeded("x")),
             (jfront.TierOverloaded("x"), tfront.TierOverloaded("x")),
             (jbatcher.EngineOverloaded("x"), tbatcher.EngineOverloaded("x")),
             (jbatcher.RequestTimeout("x"), tbatcher.RequestTimeout("x")),
             (jfront.ReplicaUnavailable("x"), tfront.ReplicaUnavailable("x")),
             (jprotocol.ProtocolError("x"), tprotocol.ProtocolError("x")),
             (ValueError("x"), ValueError("x")),
             (RuntimeError("x"), RuntimeError("x"))]
    got = [(jprotocol.error_code_for(a), tprotocol.error_code_for(b))
           for a, b in pairs]
    assert [a for a, _ in got] == [b for _, b in got]
    assert [a for a, _ in got] == ["quota_exceeded", "overloaded",
                                   "overloaded", "timeout", "unavailable",
                                   "bad_request", "bad_request", "internal"]


# --------------------------------------------------------------------------
# the policies on the same scripts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_retry_sleep_sequences_equal(seed):
    kw = dict(seed=seed, base_delay_s=0.01, max_delay_s=0.7)
    jp, tp = jretry.RetryPolicy(**kw), tretry.RetryPolicy(**kw)
    hints = [None, 0.3, None, 2.0, None, None, 0.0, None]
    for stream in range(4):
        jb, tb = jp.backoff(stream), tp.backoff(stream)
        assert [jb.next_delay(h) for h in hints] == \
            [tb.next_delay(h) for h in hints]
    for code in tprotocol.ERROR_CODES:
        assert jp.retryable(code) == tp.retryable(code)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _quota_script(front):
    clock = FakeClock()
    q = front.ClientQuotas(front.QuotaPolicy(rate=3.0, burst=5.0),
                           clock=clock)
    rng = random.Random(4)
    log = []
    for _ in range(200):
        clock.t += rng.choice([0.0, 0.05, 0.3, 1.0])
        who = rng.choice(["a", "b", None])
        model = rng.choice([None, "m"])
        cost = rng.choice([1, 2, 4, 6])
        if rng.random() < 0.2:
            q.refund(who, cost, model=model)
            log.append(("refund", q.tokens(who, model)))
            continue
        try:
            q.admit(who, cost, model=model)
            log.append(("ok", q.tokens(who, model)))
        except front.QuotaExceeded as e:
            log.append(("rejected", e.retry_after_s, str(e)))
    return log, q.clients()


def test_quota_scripts_equal():
    assert _quota_script(jfront) == _quota_script(tfront)


class FakeEngine:
    """One fake engine class for both routers: ``overloaded`` is the
    package's EngineOverloaded."""

    def __init__(self, overloaded, mode="manual", k_max=None, sharded=False,
                 ops=("score", "encode", "decode")):
        self.overloaded = overloaded
        self.mode = mode
        self.row_dims = {op: 4 for op in ops}
        self.k = 5
        if k_max is not None:
            self.k_max = k_max
        if sharded:
            self.sharded = True
        self.held = []
        self.calls = []
        self.lock = threading.Lock()

    def submit(self, op, row, k=None, *, seed=None, target_se=None,
               ess_floor=None):
        with self.lock:
            if self.mode == "shed":
                raise self.overloaded("full")
            self.calls.append((op, k, seed))
            f = Future()
            if self.mode == "auto":
                f.set_result(float(seed) * 1000.0 + float(sum(row)))
            else:
                self.held.append((row, seed, f))
            return f

    def finish(self, exc=None):
        with self.lock:
            batch, self.held = self.held, []
        for row, seed, f in batch:
            if exc is not None:
                f.set_exception(exc)
            else:
                f.set_result(float(seed) * 1000.0 + float(sum(row)))
        return len(batch)

    def start(self):
        pass

    def stop(self, timeout_s=None):
        self.finish()

    def warmup(self, ops=(), ks=None):
        return {}


def _router_script(name):
    front, _, batcher = PKG[name]
    over = batcher.EngineOverloaded
    engines = [FakeEngine(over, k_max=16), FakeEngine(over, k_max=16),
               FakeEngine(over, k_max=64, sharded=True,
                          ops=("score", "score_adaptive"))]
    r = front.ReplicaRouter(engines, affinity_slack=1)
    rng = random.Random(11)
    futs = []
    events = []
    failed = None
    for i in range(40):
        op = rng.choice(["score", "score", "encode", "decode",
                         "score_adaptive"])
        k = rng.choice([None, 1, 4, 16, 17, 40, 64])
        kw = {"target_se": 0.5} if op == "score_adaptive" else {}
        seed = 1000 + i if rng.random() < 0.2 else None
        try:
            futs.append(r.submit(op, [i, 0, 0, 0], k=k, seed=seed, **kw))
            events.append(("routed", i))
        except Exception as e:
            events.append((type(e).__name__, i))
        if i >= 15 and engines[1].held and not failed:
            failed = engines[1].finish(exc=RuntimeError("replica died"))
        if i % 7 == 6:
            for e in engines:
                e.finish()
        if i == 30:
            engines[0].mode = "shed"
    for e in engines:
        e.finish()
    for e in engines:
        e.finish()
    results = []
    for f in futs:
        try:
            results.append(f.result(timeout=WAIT))
        except Exception as e:
            results.append(type(e).__name__)
    snap = r.registry.snapshot()["counters"]
    return ([e.calls for e in engines], events, results,
            {k: v for k, v in snap.items() if k.startswith("router/")},
            r.large_k_threshold, r.k_max, r.work_estimates())


def test_router_decisions_equal_on_one_script():
    """Chosen replica, minted seed, reroutes and the fast/sharded
    classification of each (op, k): the same on the same script."""
    j, t = _router_script("jax"), _router_script("port")
    assert j == t
    calls = t[0]
    assert calls[2] and all(op != "encode" for op, _, _ in calls[2])
    assert t[3]["router/reroutes"] > 0


def test_tracing_wire_field_and_slo_snapshots_equal():
    corpus = ["abc", "abc/d-1", "a" * 64, "a" * 65, "a/b/c", "", 5, None,
              "x y", "a:b.c_d-e/f", "/x", "x/"]
    for v in corpus:
        outs = []
        for mod in (jtracing, ttracing):
            try:
                outs.append(mod.parse_wire_trace(v))
            except ValueError as e:
                outs.append(str(e))
        assert outs[0] == outs[1], v
    snaps = []
    for mod in (jslo, tslo):
        clock = FakeClock()
        mon = mod.SLOMonitor(clock=clock, objectives={
            ("m", "score"): mod.SLOObjective(latency_s=0.05)})
        rng = random.Random(2)
        for _ in range(300):
            clock.t += rng.choice([0.1, 5.0, 40.0])
            mon.observe(rng.choice(["score", "encode"]),
                        rng.choice([0.01, 0.2, 0.9]),
                        model=rng.choice([None, "m"]),
                        error_code=rng.choice([None, None, "internal",
                                               "quota_exceeded"]))
        snaps.append((mon.snapshot(), mon.registry.snapshot()["gauges"]))
    assert snaps[0] == snaps[1]
    assert jslo.peak_burns(snaps[0][0]) == tslo.peak_burns(snaps[1][0])


# --------------------------------------------------------------------------
# the two packages over TCP, both directions
# --------------------------------------------------------------------------

def _fake_tier(name, engines=None, **kw):
    front, _, batcher = PKG[name]
    engines = engines or [FakeEngine(batcher.EngineOverloaded, mode="auto")
                          for _ in range(2)]
    tier = front.ServingTier(engines, monitor_interval_s=0.05, **kw)
    tier.start()
    return tier


BAD = [b"not json\n",
       b'{"op":"score","x":[],"id":1}\n',
       b'{"op":"nope","x":[[0,0,0,0]],"id":2}\n',
       b'{"op":"score","x":[[0,0,0,0]],"k":0,"id":3}\n',
       b'{"op":"score","x":[[0,0,0,0]],"trace":"a/b/c","id":4}\n',
       b'{"op":"score","x":[[0,0,0,0],[1,1,1,1]],"seed":3,"id":5}\n',
       b'{"op":"score","x":[[0,0,0,0]],"seed":-1,"id":6}\n',
       b'{"op":"score","x":[[0,0,0,0]],"target_se":0.5,"id":7}\n',
       b'{"op":"score","x":[[0,0,0,0]],"model":"m","id":8}\n',
       b'{"op":"score","x":[[0,0,0,0]],"precision":"fp64","id":9}\n']


@pytest.mark.parametrize("client_pkg,tier_pkg", [("jax", "port"),
                                                 ("port", "jax")])
def test_client_and_tier_of_the_other_package(client_pkg, tier_pkg):
    """A JAX TierClient drives a port ServingTier and the other way round:
    a ragged pipelined stream, the same info document and the same typed
    errors (the connection surviving each) as against its own package."""
    cfront = PKG[client_pkg][0]
    docs = {}
    for name in (tier_pkg, client_pkg):
        tier = _fake_tier(name)
        try:
            with cfront.TierClient("127.0.0.1", tier.port,
                                   timeout_s=WAIT) as c:
                ids = [c.submit("score", [[float(i), 0, 0, 0]] * (i % 3 + 1))
                       for i in range(9)]
                got = c.drain(ids)
                codes = []
                for raw in BAD:
                    c._sock.sendall(raw)
                    resp = c._read_one()
                    codes.append((resp["id"], resp["ok"], resp["error"]))
                docs[name] = ([got[rid]["result"] for rid in ids],
                              c.info(), codes, c.score([[1, 0, 0, 0]]),
                              sorted(c.stats()), sorted(c.slo()))
        finally:
            tier.stop(timeout_s=10)
    assert docs[tier_pkg] == docs[client_pkg]
    assert all(code[2] == "bad_request" for code in docs[tier_pkg][2])


def test_port_router_over_a_jax_and_a_port_remote_tier():
    """A port ReplicaRouter with two RemoteEngine replicas, one over a JAX
    tier and one over a port tier: a ragged stream with a child lost
    mid-stream loses nothing, each result bitwise the seed's."""
    j_eng = FakeEngine(jbatcher.EngineOverloaded, mode="auto")
    t_eng = FakeEngine(tbatcher.EngineOverloaded, mode="auto")
    jt = _fake_tier("jax", [j_eng])
    tt = _fake_tier("port", [t_eng])
    try:
        rem_j = tfront.RemoteEngine("127.0.0.1", jt.port)
        rem_t = tfront.RemoteEngine("127.0.0.1", tt.port)
        parent = tfront.ReplicaRouter([rem_j, rem_t], affinity_slack=0)
        rng = random.Random(3)
        futs = []
        for i in range(40):
            if i == 20:
                tt.stop(timeout_s=10)      # the port child goes away
            futs.append(parent.submit("score", [float(i), 0, 0, 0],
                                      k=rng.choice([None, 2, 5])))
        got = [f.result(timeout=WAIT) for f in futs]
        assert got == [i * 1000.0 + float(i) for i in range(40)]
        assert j_eng.calls and t_eng.calls
        assert parent.registry.counter("router/replica_failures").value == 1
        parent.drain(timeout_s=10)
    finally:
        jt.stop(timeout_s=10)
        tt.stop(timeout_s=10)


# --------------------------------------------------------------------------
# results of a port tier against a JAX tier, on replayed draws
# --------------------------------------------------------------------------

K, KC, K_MAX = 4, 4, 40
BASE_KEY = jax.random.PRNGKey(0)      # the JAX engines' seed=0 base key
SCORE_TOL = (1e-3, 1e-5)
SE_RTOL = 1e-3
TARGET_MARGIN = 0.01


class ReplayEngine(TEngine):
    """The port engine with JAX's per-row ``fold_in`` draws injected
    through the dispatch hook."""

    jcfg = None

    def _dispatch_args(self, op, k, bucket, payload, seeds, targets=None,
                       n_real=None):
        args, kwargs = super()._dispatch_args(op, k, bucket, payload, seeds,
                                              targets, n_real)
        noise = row_decode_noise(self.jcfg, BASE_KEY, seeds) \
            if op == "decode" else row_encode_noise(self.jcfg, BASE_KEY,
                                                    seeds, k)
        kwargs["noise"] = [t.to(self.device) for t in noise]
        return args, kwargs


def _block_noise_fn(jcfg):
    cache = {}

    def noise_fn(g, seeds):
        cols = []
        for s in seeds:
            if (s, g) not in cache:
                cache[(s, g)] = block_noise(jcfg, BASE_KEY, [s], g, KC)
            cols.append(cache[(s, g)])
        return [torch.cat([c[i] for c in cols], dim=1)
                for i in range(len(cols[0]))]
    return noise_fn


class ReplaySharded(TSharded):
    """The port's sharded engine with JAX's per-(row, block) draws."""

    noise_fn = None

    def _dispatch_args(self, op, k, bucket, payload, seeds, targets=None,
                       n_real=None):
        args, kwargs = super()._dispatch_args(op, k, bucket, payload, seeds,
                                              targets, n_real)
        kwargs["noise_fn"] = type(self).noise_fn
        return args, kwargs


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = configs(2, "logits")
    jp, tp = params(jcfg, seed=6)
    ReplayEngine.jcfg = jcfg
    ReplaySharded.noise_fn = staticmethod(_block_noise_fn(jcfg))
    return jcfg, tcfg, jp, tp


def _tiers(weights, sharded):
    jcfg, tcfg, jp, tp = weights
    knobs = dict(k=K, max_batch=8, timeout_s=WAIT)
    j = [JEngine(params=jp, model_config=jcfg, ladder=JLadder((8,)),
                 k_max=K if sharded else None, **knobs)]
    t = [ReplayEngine(params=tp, model_config=tcfg, ladder=TLadder((8,)),
                      device="cpu", k_max=K if sharded else None, **knobs)]
    if sharded:
        j.append(JSharded(params=jp, model_config=jcfg, mesh=jmesh(1, 1),
                          k_chunk=KC, k_max=K_MAX, ladder=JLadder((8,)),
                          **knobs))
        t.append(ReplaySharded(params=tp, model_config=tcfg, k_chunk=KC,
                               k_max=K_MAX, ladder=TLadder((8,)),
                               device="cpu", **knobs))
    kw = dict(monitor_interval_s=0.05,
              large_k_threshold=K if sharded else None)
    jt = jfront.ServingTier(j, **kw).start()
    tt = tfront.ServingTier(t, **kw).start()
    return jt, tt


def _drive(front, tier, script):
    with front.TierClient("127.0.0.1", tier.port, timeout_s=WAIT) as c:
        return [c.request(op, x, k=k, seed=seed, **kw)
                for op, x, k, seed, kw in script]


def test_port_tier_matches_jax_tier_on_the_fast_route(weights):
    jcfg = weights[0]
    x = binary_rows(12, seed=8)
    h = np.random.RandomState(9).randn(3, jcfg.n_latent_enc[-1]) \
        .astype(np.float32)
    script = [("score", x[0:1].tolist(), None, None, {}),
              ("score", x[1:4].tolist(), None, None, {}),
              ("encode", x[4:6].tolist(), None, None, {}),
              ("score", x[6:8].tolist(), K, None, {}),
              ("decode", h.tolist(), None, None, {}),
              ("score", [x[8].tolist()], 2, 123, {}),
              ("encode", [x[9].tolist()], None, 5, {})]
    jt, tt = _tiers(weights, sharded=False)
    try:
        want = _drive(jfront, jt, script)
        got = _drive(tfront, tt, script)
    finally:
        jt.stop(timeout_s=30)
        tt.stop(timeout_s=30)
    tol = {"score": SCORE_TOL, "encode": (1e-5, 1e-5),
           "decode": (1e-6, 1e-5)}
    for (op, *_), g, w in zip(script, got, want):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(w, np.float32), *tol[op])


def _se_stream(lw, n):
    v = lw[:n].astype(np.float64)
    w = np.exp(v - v.max())
    s, s2 = w.sum(), (w * w).sum()
    if n <= 1:
        return 0.0
    return float(np.sqrt(max(s2 / (s * s) - 1.0 / n, 0.0) * n / (n - 1)))


def _target(ses):
    pos = sorted(set(v for v in ses if v > 0))
    i = max(range(len(pos) - 1), key=lambda j: pos[j + 1] / pos[j])
    t = math.sqrt(pos[i] * pos[i + 1])
    assert min(abs(v - t) / t for v in ses) >= TARGET_MARGIN, (ses, t)
    return t


def test_port_tier_matches_jax_tier_on_the_large_k_route(weights):
    """score above the threshold and score_adaptive, served by each
    package's sharded replica behind its own tier."""
    jcfg, tcfg, _, tp = weights
    x = binary_rows(6, seed=10)
    seeds = [31, 32, 33, 34, 35, 36]
    noise_fn = ReplaySharded.noise_fn
    # a target between the rows' round-boundary SEs (a world of one: a
    # boundary every KC samples up to the cap)
    ses = []
    for s, row in zip(seeds[3:], x[3:]):
        lw = torch.cat([tmodel.log_weights(
            tp, tcfg, torch.from_numpy(row[None]), KC,
            eps=noise_fn(g, [s]))[:, 0] for g in range(K_MAX // KC)]).numpy()
        ses += [_se_stream(lw, (r + 1) * KC) for r in range(K_MAX // KC)]
    target = _target(ses)
    script = [("score", [x[i].tolist()], k, seeds[i], {})
              for i, k in ((0, 5), (1, 17), (2, K_MAX))]
    script += [("score_adaptive", [x[i].tolist()], K_MAX, seeds[i],
                {"target_se": target}) for i in (3, 4, 5)]
    jt, tt = _tiers(weights, sharded=True)
    try:
        want = _drive(jfront, jt, script)
        got = _drive(tfront, tt, script)
    finally:
        jt.stop(timeout_s=30)
        tt.stop(timeout_s=30)
    # after the drain: an engine counts a completion after its callbacks
    routed = [e["completed"] for e in tt.stats()["engines"]]
    assert routed == [0, 6]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, *SCORE_TOL)
    ga = np.asarray([r[0] for r in got[3:]], np.float64)
    wa = np.asarray([r[0] for r in want[3:]], np.float64)
    assert np.array_equal(ga[:, 2], wa[:, 2]), (ga[:, 2], wa[:, 2])
    np.testing.assert_allclose(ga[:, 0], wa[:, 0], *SCORE_TOL)
    np.testing.assert_allclose(ga[:, 1], wa[:, 1], rtol=SE_RTOL, atol=1e-7)
    assert (ga[:, 2] < K_MAX).any()     # the stopping rule engaged


def test_info_documents_of_real_tiers_agree(weights):
    jt, tt = _tiers(weights, sharded=True)
    try:
        docs = [json.loads(json.dumps(t.info())) for t in (jt, tt)]
    finally:
        jt.stop(timeout_s=30)
        tt.stop(timeout_s=30)
    assert docs[0] == docs[1]
    assert docs[1]["sharded"] == {"buckets": [8], "k_chunk": KC,
                                  "k_max": K_MAX, "k": K}
