"""The port's executable store and multi-model tier (port of
tests/test_multi_model.py), held against the JAX package where both can
run.

Four layers, as in the JAX file:

* **store** (``utils/compile_cache.ExecutableStore``): LRU eviction order
  under a byte budget, pins during a dispatch, the residency adding up to
  the entries' bills, evict -> re-request -> a *readmit* with no kernel
  build, an oversized entry still served, the counters in ``cache_stats``,
  the budget from ``IWAE_STORE_BUDGET_BYTES`` and the isolated store;
* **engine**: the ``model`` label keys store entries per tenant
  (``store_label``, ``@precision``-suffixed), an unknown model at
  ``submit`` is the typed bad request, and ``crash_aot_dispatch`` fails
  exactly the batch whose dispatch it hits;
* **router and wire**: model routing over fakes, per-(client, model)
  quotas, unknown models rejected over a live socket, a multi-model child
  tier behind ``RemoteEngine``;
* **against JAX**: a JAX ``TierClient`` served by the port's multi-model
  tier (the serving CLI's ``--models``) gets the ``info`` a JAX tier of the
  same presets declares, and the scores a JAX tier of the same weights
  returns (the port's noise replayed from JAX's per-row draws; atol 1e-3,
  rtol 1e-5, as test_torch_tier_parity.py holds them).

CPU only; the card's graphs are tests/test_torch_fleet_cuda.py.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import Future
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu import zoo as jzoo
from iwae_replication_project_tpu.serving import frontend as jfront
from iwae_replication_project_tpu.serving.engine import (
    ServingEngine as JEngine,
)
from iwae_replication_project_tpu_torch import zoo
from iwae_replication_project_tpu_torch.models.iwae import (
    ModelConfig,
    init_params,
)
from iwae_replication_project_tpu_torch.serving import frontend as tfront
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine
from iwae_replication_project_tpu_torch.serving.faults import (
    crash_aot_dispatch,
)
from iwae_replication_project_tpu_torch.utils import compile_cache as cc
from iwae_replication_project_tpu_torch.utils import faults
from iwae_replication_project_tpu_torch.utils.compile_cache import (
    ExecutableStore,
)
from torch_parity import binary_rows, configs, params, row_encode_noise

REPO = Path(__file__).resolve().parent.parent
WAIT = 60.0


def _program(scale):
    """One distinct program per scale."""
    def f(x):
        return torch.tanh(x * float(scale)).sum()
    return f


def _fill(store_models, x=None):
    """Admit one program per (name, model) through the module-level API
    (the store under test is the process default, isolated by the
    caller); each is billed its argument's bytes."""
    x = x if x is not None else torch.ones((16, 16))
    for i, (name, model) in enumerate(store_models):
        cc.aot_call(name, _program(i + 1), (x,), model=model)


# ---------------------------------------------------------------------------
# store: LRU, pins, budget, readmits
# ---------------------------------------------------------------------------

class TestExecutableStore:
    def test_lru_eviction_order(self):
        """Under budget pressure the least recently used entry goes first;
        a hit refreshes recency."""
        with cc.isolated_aot_registry(budget_bytes=None):
            s0 = cc.cache_stats()
            _fill([("p0", "a"), ("p1", "b"), ("p2", "c")])
            store = cc.executable_store()
            b0 = store.stats()["per_model"].get("b", {}).get("evictions", 0)
            per = store.stats()["resident_bytes"] // 3
            cc.aot_call("p0", _program(1), (torch.ones((16, 16)),),
                        model="a")
            store.set_budget(2 * per + per // 2)     # fits two of three
            assert [k[1] for k in store.keys()] == ["p2", "p0"]
            d = cc.stats_delta(s0)
            assert d["store_evictions"] == 1 and d["store_hits"] == 1
            assert store.stats()["per_model"]["b"]["evictions"] == b0 + 1

    def test_pinned_entry_never_evicted_mid_dispatch(self):
        with cc.isolated_aot_registry(budget_bytes=None):
            store = cc.executable_store()
            _fill([("p0", "a")])
            pin = store.pin_prefix("a", "p0", ())
            _fill([("p1", "b")])
            per = store.stats()["resident_bytes"] // 2
            store.set_budget(per // 2)       # fits nothing unpinned
            assert [k[1] for k in store.keys()] == ["p0"]
            pin.release()                    # release evicts the deferred
            assert store.keys() == []

    def test_residency_is_the_sum_of_the_bills(self):
        """Every entry is billed what its caller reckoned (here the
        arguments' bytes), and the resident bytes add up, overall and per
        model."""
        with cc.isolated_aot_registry(budget_bytes=None):
            _fill([("p0", "a"), ("p1", "a")])
            cc.aot_call("p2", _program(3), (torch.ones((4, 4)),), model="b",
                        nbytes=12345)
            st = cc.store_stats()
            assert st["resident_bytes"] == 2 * 16 * 16 * 4 + 12345
            resident = {m: d["resident_bytes"]
                        for m, d in st["per_model"].items()
                        if d["entries"] > 0}
            assert resident == {"a": 2 * 1024, "b": 12345}
            assert cc.executable_store().model_costs() == resident

    def test_evict_readmit_zero_kernel_builds(self):
        """evict -> re-request -> a counted readmit, with no kernel build,
        computing the same bits."""
        with cc.isolated_aot_registry(budget_bytes=None):
            store = cc.executable_store()
            x = torch.ones((16, 16))
            s_pre = cc.cache_stats()
            _fill([("p0", "a"), ("p1", "b")], x=x)
            ref = float(cc.aot_call("p0", _program(1), (x,), model="a"))
            per = store.stats()["resident_bytes"] // 2
            store.set_budget(per + per // 2)         # fits one of the two
            d_evict = cc.stats_delta(s_pre)
            assert d_evict["store_evictions"] == 1
            assert d_evict["store_demotions"] == 1
            assert [k[1] for k in store.keys()] == ["p0"]
            s0 = cc.cache_stats()
            out = float(cc.aot_call("p1", _program(2), (x,), model="b"))
            d = cc.stats_delta(s0)
            assert d["kernel_builds"] == 0
            assert d["store_readmits"] == 1 and d["store_misses"] == 1
            assert out == float(_program(2)(x))
            assert ref == float(_program(1)(x))

    def test_oversized_entry_still_admitted(self):
        with cc.isolated_aot_registry(budget_bytes=1):
            _fill([("p0", "a")])
            assert cc.store_stats()["entries"] in (0, 1)
            out = cc.aot_call("p0", _program(1), (torch.ones((16, 16)),),
                              model="a")
            assert np.isfinite(float(out))

    def test_store_counters_exported_in_cache_stats(self):
        with cc.isolated_aot_registry(budget_bytes=None):
            s0 = cc.cache_stats()
            for key in ("store_hits", "store_misses", "store_evictions",
                        "store_demotions", "store_readmits",
                        "store_resident_bytes", "store_budget_bytes",
                        "kernel_builds", "aot_captures"):
                assert key in s0, key
            _fill([("p0", "a")])
            cc.aot_call("p0", _program(1), (torch.ones((16, 16)),),
                        model="a")
            d = cc.stats_delta(s0)
            assert d["store_misses"] == 1 and d["store_hits"] == 1
            assert d["aot_captures"] == 0     # eager entries on the CPU

    def test_counters_mirror_into_the_registry(self):
        from iwae_replication_project_tpu_torch.telemetry.registry import (
            get_registry)

        reg = get_registry()
        with cc.isolated_aot_registry(budget_bytes=None):
            before = reg.counter("store/misses").value
            _fill([("p0", "a")])
            assert reg.counter("store/misses").value == before + 1
            assert reg.gauge("store/entries").value == 1

    def test_counters_follow_a_swapped_registry(self, monkeypatch):
        # a count made while another process registry was installed does
        # not keep later counts away from the one restored after it
        from iwae_replication_project_tpu_torch.telemetry import registry

        reg = registry.get_registry()
        with cc.isolated_aot_registry(budget_bytes=None):
            with monkeypatch.context() as m:
                m.setattr(registry, "_DEFAULT", registry.MetricRegistry())
                _fill([("p0", "a")])
            before = reg.counter("store/misses").value
            _fill([("p1", "a")])
            assert reg.counter("store/misses").value == before + 1

    def test_isolated_registry_budget_restored(self):
        before = cc.executable_store().budget_bytes
        with cc.isolated_aot_registry(budget_bytes=12345):
            assert cc.executable_store().budget_bytes == 12345
        assert cc.executable_store().budget_bytes == before

    def test_negative_budget_is_an_error(self):
        with pytest.raises(ValueError, match=">= 0"):
            ExecutableStore().set_budget(-1)

    @pytest.mark.parametrize("raw,want,warns", [
        ("", None, False), ("off", None, False), ("1048576", 1048576, False),
        ("2.5e3", 2500, False), ("lots", None, True), ("-5", None, True)])
    def test_budget_from_env(self, monkeypatch, raw, want, warns):
        monkeypatch.setenv("IWAE_STORE_BUDGET_BYTES", raw)
        if warns:
            with pytest.warns(UserWarning, match="UNBOUNDED"):
                assert cc._budget_from_env() is None
        else:
            assert cc._budget_from_env() == want

    def test_env_budget_reaches_a_fresh_process(self):
        code = ("from iwae_replication_project_tpu_torch.utils import "
                "compile_cache as cc; "
                "print(cc.executable_store().budget_bytes)")
        out = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True,
            text=True, timeout=120,
            env={**__import__("os").environ,
                 "IWAE_STORE_BUDGET_BYTES": "4096"})
        assert out.stdout.strip() == "4096", out.stderr

    def test_racing_admission_keeps_the_first_entry(self):
        store = ExecutableStore()
        made = []

        def build(readmit):
            prog = cc.EagerProgram(lambda: len(made))
            made.append(prog)
            if len(made) == 1:
                # another thread admits the same key meanwhile
                store.get_or_build("p", lambda r: cc.EagerProgram(
                    lambda: "theirs"), (), (), 10)
            return prog

        exe, hit = store.get_or_build("p", build, (), (), 10)
        assert not hit and exe() == "theirs" and len(store) == 1
        assert made[0].fn is None            # ours was released


# ---------------------------------------------------------------------------
# engine boundary
# ---------------------------------------------------------------------------

D = 16
CFG = ModelConfig(x_dim=D, n_hidden_enc=(8,), n_latent_enc=(4,),
                  n_hidden_dec=(8,), n_latent_dec=(D,))


def _tiny_engine(model=None, **kw):
    p = init_params(torch.Generator().manual_seed(0), CFG)
    return ServingEngine(params=p, model_config=CFG, k=3, max_batch=4,
                         model=model, device="cpu", **kw)


class TestEngineModelBoundary:
    def test_unknown_model_typed_bad_request(self):
        eng = _tiny_engine(model="m-a")
        with pytest.raises(ValueError, match="unknown model"):
            eng.submit("score", [0.0] * D, model="m-b")
        assert eng.metrics.snapshot()["counters"]["submitted"] == 0

    def test_unlabeled_engine_rejects_named_model(self):
        eng = _tiny_engine(model=None)
        with pytest.raises(ValueError, match="no named models"):
            eng.submit("score", [0.0] * D, model="m-a")

    def test_own_model_accepted_and_store_entries_labeled(self):
        with cc.isolated_aot_registry():
            eng = _tiny_engine(model="m-a")
            out = eng.score(np.zeros((2, D), np.float32))
            assert out.shape == (2,)
            entries = cc.executable_store().entries()
            assert {e["model"] for e in entries} == {"m-a"}
            assert {e["name"] for e in entries} == {"serve_score"}
            fs = [eng.submit("score", [v] * D, model="m-a")
                  for v in (0.0, 1.0)]       # the same bucket: a hit
            eng.flush()
            assert all(np.isfinite(f.result()) for f in fs)
            counters = eng.metrics.counters()
            assert counters["aot_misses"] == 1 and \
                counters["aot_hits"] == 1 and counters["recompiles"] == 0

    def test_store_label_carries_the_precision(self):
        assert _tiny_engine(model="m").store_label == "m"
        assert _tiny_engine(model="m", precision="bf16").store_label == \
            "m@bf16"
        assert _tiny_engine(precision="fp32").store_label == "default@fp32"
        assert _tiny_engine().store_label is None

    def test_replicas_share_entries_other_weights_do_not(self):
        with cc.isolated_aot_registry():
            a = _tiny_engine(model="m")
            b = ServingEngine(params=a._params, model_config=CFG, k=3,
                              max_batch=4, model="m", device="cpu")
            c = _tiny_engine(model="m")       # equal values, other tensors
            wa, wb = a.warmup(ops=("score",)), b.warmup(ops=("score",))
            assert wa["captures"] == len(a.ladder.buckets)
            assert wb["captures"] == 0 and wb["builds"] == 0
            assert c.warmup(ops=("score",))["captures"] == \
                len(c.ladder.buckets)

    def test_sharded_engine_model_boundary(self):
        from iwae_replication_project_tpu_torch.parallel.mesh import (
            make_mesh)
        from iwae_replication_project_tpu_torch.serving.sharded import (
            ShardedScoreEngine)

        p = init_params(torch.Generator().manual_seed(0), CFG)
        with cc.isolated_aot_registry():
            eng = ShardedScoreEngine(params=p, model_config=CFG,
                                     mesh=make_mesh(dp=1, sp=1,
                                                    device="cpu"),
                                     k=2, k_chunk=2, k_max=8, max_batch=2,
                                     model="m-sharded")
            assert eng.model == "m-sharded"
            assert eng.models == frozenset({"m-sharded"})
            with pytest.raises(ValueError, match="unknown model"):
                eng.submit("score", [0.0] * D, model="m-other")
            out = eng.score(np.zeros((2, D), np.float32), k=5)
            out2 = eng.score(np.zeros((2, D), np.float32), k=7)
            assert out.shape == (2,) and out2.shape == (2,)
            entries = cc.executable_store().entries()
            # one program per bucket serves every k
            assert len(entries) == 1
            assert {e["model"] for e in entries} == {"m-sharded"}

    def test_per_model_latency_labels(self):
        eng = _tiny_engine(model="m-a")
        eng.score(np.zeros((2, D), np.float32))
        snap = eng.metrics.snapshot()
        assert snap["model"] == "m-a"
        assert any("score" in key for key in snap["latency"])


# ---------------------------------------------------------------------------
# crash_aot_dispatch: one batch fails, typed, and the engine serves on
# ---------------------------------------------------------------------------

class TestCrashAotDispatch:
    def test_exactly_one_batch_fails_and_the_dispatcher_lives(self):
        eng = _tiny_engine(model="m").start()
        try:
            rows = np.zeros((3, D), np.float32)
            with faults.installed(faults.FaultSchedule(
                    [crash_aot_dispatch(after=1, times=1)])):
                got = []
                for i in range(3):
                    fs = [eng.submit("score", r, seed=10 * i + j)
                          for j, r in enumerate(rows)]
                    got.append([f.exception(timeout=WAIT) for f in fs])
            assert all(e is None for e in got[0] + got[2])
            assert all(isinstance(e, faults.FaultInjected)
                       for e in got[1])
            assert "AOT dispatch failure" in str(got[1][0])
            assert eng.metrics.counters()["errors"] == 3
            # the dispatcher thread still serves
            f = eng.submit("score", rows[0], seed=99)
            assert np.isfinite(f.result(timeout=WAIT))
            # the failed batch released its pin
            assert cc.executable_store()._prefix_pins == {}
        finally:
            eng.stop()

    def test_prefix_matches_the_program_name(self):
        eng = _tiny_engine()
        with faults.installed(faults.FaultSchedule(
                [crash_aot_dispatch(program_prefix="serve_decode")])):
            assert eng.score(np.zeros((1, D), np.float32)).shape == (1,)
            with pytest.raises(faults.FaultInjected):
                eng.decode(np.zeros((1, 4), np.float32))

    def test_over_the_wire_one_replica_fails_the_tier_serves_on(self):
        """Two replicas: the failed batch reroutes to the other one with
        its original seeds (ok, and bitwise the unfaulted answer); one
        replica alone: a typed ``unavailable`` until the monitor's probe
        readmits it."""
        rows = [[1.0] * D]
        for n in (2, 1):
            tier = tfront.ServingTier(
                [_tiny_engine(model="m") for _ in range(n)],
                monitor_interval_s=0.05).start()
            try:
                with tfront.TierClient("127.0.0.1", tier.port,
                                       timeout_s=WAIT) as c:
                    want = c.score(rows, seed=7)
                    with faults.installed(faults.FaultSchedule(
                            [crash_aot_dispatch(times=1)])):
                        rid = c.submit("score", rows, seed=7)
                        resp = c.drain([rid])[rid]
                    if n == 2:
                        assert resp["ok"] and resp["result"] == want
                        assert tier.stats()["router"][
                            "router/reroutes"] >= 1
                    else:
                        assert resp["ok"] is False and \
                            resp["error"] == "unavailable"
                    deadline = time.monotonic() + WAIT
                    while True:
                        rid = c.submit("score", rows, seed=7)
                        resp = c.drain([rid])[rid]
                        if resp["ok"] or time.monotonic() > deadline:
                            break
                        time.sleep(0.05)
                    assert resp["ok"] and resp["result"] == want
            finally:
                tier.stop(timeout_s=10)


# ---------------------------------------------------------------------------
# router: model routing (fakes, no device)
# ---------------------------------------------------------------------------

class ModelFakeEngine:
    """A model-labeled engine whose results encode which model served."""

    def __init__(self, model, tag, dims=4):
        self.model = model
        self.models = frozenset({model})
        self.row_dims = {"score": dims}
        self.k = 5
        self.tag = tag
        self.submitted = []

    def submit(self, op, row, k=None, *, seed=None, model=None, trace=None):
        if model is not None and model != self.model:
            raise ValueError(f"unknown model {model!r}")
        self.submitted.append((op, list(row), k, seed, model))
        f = Future()
        f.set_result(float(seed or 0) * 1000.0 + float(sum(row))
                     + self.tag)
        return f

    def start(self):
        pass

    def stop(self, timeout_s=None):
        pass

    def warmup(self, ops=(), ks=None):
        return {"programs": 0.0}


class TestRouterModelRouting:
    def _router(self):
        ea = ModelFakeEngine("m-a", tag=0.25)
        eb = ModelFakeEngine("m-b", tag=0.5)
        return tfront.ReplicaRouter([ea, eb]), ea, eb

    def test_model_routes_to_declaring_replica(self):
        router, ea, eb = self._router()
        fa = router.submit("score", [1.0] * 4, model="m-a")
        fb = router.submit("score", [1.0] * 4, model="m-b")
        assert fa.result(timeout=5) != fb.result(timeout=5)
        assert len(ea.submitted) == 1 and len(eb.submitted) == 1
        assert ea.submitted[0][4] == "m-a"

    def test_unknown_model_synchronous_bad_request(self):
        router, ea, eb = self._router()
        with pytest.raises(ValueError, match="unknown model"):
            router.submit("score", [1.0] * 4, model="nope")
        assert router.outstanding == 0
        assert not ea.submitted and not eb.submitted

    def test_default_model_resolution_is_deterministic(self):
        router, ea, eb = self._router()
        assert router.default_model == "m-a"
        for _ in range(4):
            router.submit("score", [1.0] * 4).result(timeout=5)
        assert len(ea.submitted) == 4 and not eb.submitted

    def test_affinity_keyed_per_model(self):
        router, ea, eb = self._router()
        for _ in range(3):
            router.submit("score", [1.0] * 4, k=5, model="m-a")
            router.submit("score", [1.0] * 4, k=5, model="m-b")
        assert len(ea.submitted) == 3 and len(eb.submitted) == 3


class TestPerClientModelQuotas:
    def test_model_lanes_are_isolated(self):
        clk = type("C", (), {"t": 0.0, "__call__": lambda s: s.t})()
        q = tfront.ClientQuotas(tfront.QuotaPolicy(rate=1.0, burst=2.0),
                                clock=clk)
        q.admit("alice", 2, model="m-a")
        with pytest.raises(tfront.QuotaExceeded):
            q.admit("alice", 1, model="m-a")
        q.admit("alice", 2, model="m-b")
        q.admit("alice", 2)
        assert q.tokens("alice", model="m-a") == 0.0
        q.refund("alice", 1, model="m-b")
        q.admit("alice", 1, model="m-b")
        assert sorted(q.clients()) == ["alice"]


class TestWireAndRemote:
    def _tier(self, **kw):
        ea = ModelFakeEngine("m-a", tag=0.25)
        eb = ModelFakeEngine("m-b", tag=0.5)
        tier = tfront.ServingTier([ea, eb], port=0, **kw).start()
        return tier, ea, eb

    def test_unknown_model_typed_response_connection_survives(self):
        from iwae_replication_project_tpu_torch.serving.frontend.client \
            import TierError

        tier, ea, eb = self._tier()
        try:
            with tfront.TierClient("127.0.0.1", tier.port) as cli:
                with pytest.raises(TierError) as ei:
                    cli.score([1.0] * 4, model="not-a-model")
                assert ei.value.code == "bad_request"
                rid = cli.submit("score", [1.0] * 4, model=123)
                resp = cli.drain([rid])[rid]
                assert resp["ok"] is False and resp["error"] == "bad_request"
                assert cli.score([1.0] * 4, model="m-b")[0] == \
                    pytest.approx(4.5)
        finally:
            tier.stop(timeout_s=10)

    def test_info_declares_models_and_stats_the_store(self):
        tier, _, _ = self._tier()
        try:
            info = tier.info()
            assert sorted(info["models"]) == ["m-a", "m-b"]
            assert info["default_model"] == "m-a"
            assert info["models"]["m-b"]["ops"] == ["score"]
            assert set(tier.stats()["store"]) >= {"hits", "per_model"}
        finally:
            tier.stop(timeout_s=10)

    def test_remote_engine_forwards_model_capabilities(self):
        tier, ea, eb = self._tier()
        try:
            proxy = tfront.RemoteEngine("127.0.0.1", tier.port)
            assert proxy.models == frozenset({"m-a", "m-b"})
            assert proxy.model == "m-a"
            parent = tfront.ReplicaRouter([proxy])
            out = parent.submit("score", [1.0] * 4,
                                model="m-b").result(timeout=5)
            assert out == pytest.approx(0 * 1000.0 + 4.0 + 0.5)
            with pytest.raises(ValueError, match="unknown model"):
                proxy.submit("score", [1.0] * 4, model="nope")
            proxy.close()
        finally:
            tier.stop(timeout_s=10)


# ---------------------------------------------------------------------------
# a JAX client against the port's multi-model tier
# ---------------------------------------------------------------------------

PRESETS = ["digits-iwae-1l-k50", "digits-vae-1l-k1"]


def test_zoo_serving_engines_label_share_and_refuse():
    engines = zoo.serving_engines(PRESETS, replicas_per_model=2,
                                  device="cpu", max_batch=2)
    assert [e.model for e in engines] == [PRESETS[0]] * 2 + [PRESETS[1]] * 2
    assert engines[0]._params["out"]["out"]["w"] is \
        engines[1]._params["out"]["out"]["w"]
    assert engines[0]._weights_key == engines[1]._weights_key
    assert engines[1].k == 50 and engines[2].k == 1
    with pytest.raises(KeyError, match="unknown preset"):
        zoo.serving_engines(["nope"], device="cpu")
    with pytest.raises(ValueError, match="precision"):
        zoo.serving_engines(PRESETS, precisions="int4", device="cpu")
    with pytest.raises(ValueError, match="not in this manifest"):
        zoo.serving_engines(PRESETS, precisions={"x": "bf16"}, device="cpu")


def test_jax_client_reads_the_info_a_jax_tier_declares():
    """The same presets through both packages' ``zoo.serving_engines``
    behind both packages' tiers: a JAX client reads the same ``models``
    document and default model from each."""
    jt = jfront.ServingTier(jzoo.serving_engines(PRESETS, max_batch=2),
                            monitor_interval_s=0.05).start()
    tt = tfront.ServingTier(zoo.serving_engines(PRESETS, max_batch=2,
                                                device="cpu"),
                            monitor_interval_s=0.05).start()
    try:
        docs = []
        for tier in (jt, tt):
            with jfront.TierClient("127.0.0.1", tier.port,
                                   timeout_s=WAIT) as c:
                docs.append(json.loads(json.dumps(c.info())))
        for key in ("models", "default_model", "ops", "row_dims"):
            assert docs[0][key] == docs[1][key], key
        assert sorted(docs[1]["models"]) == sorted(PRESETS)
    finally:
        jt.stop(timeout_s=30)
        tt.stop(timeout_s=30)


class _Replay(ServingEngine):
    """The port engine with JAX's per-row draws (engine seed 0)."""

    def __init__(self, *a, jcfg, **kw):
        super().__init__(*a, **kw)
        self.jcfg = jcfg

    def _dispatch_args(self, op, k, bucket, payload, seeds, targets=None,
                       n_real=None):
        args, kwargs = super()._dispatch_args(op, k, bucket, payload, seeds,
                                              targets, n_real)
        kwargs["noise"] = row_encode_noise(self.jcfg, jax.random.PRNGKey(0),
                                           seeds, k)
        return args, kwargs


def test_jax_client_gets_a_jax_tiers_scores_from_the_port(tmp_path):
    """Two models of other architectures and weights: a JAX client sends
    the same model-tagged script to a JAX tier and to the port's, and the
    scores agree within atol 1e-3, rtol 1e-5."""
    models = {}
    for name, layers, seed in (("one", 1, 3), ("two", 2, 4)):
        jcfg, tcfg = configs(layers, "logits")
        jp, tp = params(jcfg, seed=seed)
        models[name] = (jcfg, tcfg, jp, tp)
    knobs = dict(k=4, max_batch=4, timeout_s=WAIT)
    jt = jfront.ServingTier(
        [JEngine(params=m[2], model_config=m[0], model=n, **knobs)
         for n, m in models.items()], monitor_interval_s=0.05).start()
    tt = tfront.ServingTier(
        [_Replay(params=m[3], model_config=m[1], model=n, device="cpu",
                 jcfg=m[0], **knobs) for n, m in models.items()],
        monitor_interval_s=0.05).start()
    x = binary_rows(8, seed=5)
    script = [("one", x[0:1]), ("two", x[1:4]), ("one", x[4:6]),
              ("two", x[6:7]), (None, x[7:8])]
    try:
        got = []
        for tier in (jt, tt):
            with jfront.TierClient("127.0.0.1", tier.port,
                                   timeout_s=WAIT) as c:
                got.append([c.score(rows.tolist(), model=m)
                            for m, rows in script])
        for g, w in zip(got[1], got[0]):
            np.testing.assert_allclose(np.asarray(g, np.float32),
                                       np.asarray(w, np.float32),
                                       atol=1e-3, rtol=1e-5)
    finally:
        jt.stop(timeout_s=30)
        tt.stop(timeout_s=30)


def test_cli_models_tier_on_the_cpu():
    """``--models A,B --store-budget-mb X --autoscale`` serves over TCP on
    the CPU: the ready line names both models, a client burst through
    ``--client`` is all ok, and the final snapshot carries the fleet's
    decision log and the store's evictions under the small budget."""
    env = {**__import__("os").environ}
    tier = subprocess.Popen(
        [sys.executable, "-m", "iwae_replication_project_tpu_torch.serving",
         "--models", ",".join(PRESETS), "--device", "cpu", "--max-batch",
         "4", "--store-budget-mb", "0.05", "--autoscale",
         "--autoscale-max", "2", "--autoscale-interval-s", "0.2",
         "--port", "0"], cwd=REPO, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        ready = json.loads(tier.stdout.readline())
        assert ready["tier"]["models"] == sorted(PRESETS)
        assert ready["tier"]["default_model"] == PRESETS[0]
        assert ready["tier"]["autoscale"]["max_replicas"] == 2
        port = ready["tier"]["port"]
        for model in PRESETS:
            cli = subprocess.run(
                [sys.executable, "-m",
                 "iwae_replication_project_tpu_torch.serving", "--client",
                 f"127.0.0.1:{port}", "--requests", "12", "--sizes", "1,3",
                 "--model", model], cwd=REPO, capture_output=True,
                text=True, timeout=120, env=env)
            out = json.loads(cli.stdout.strip().splitlines()[-1])
            assert cli.returncode == 0 and out["errors"] == {}, cli.stderr
        time.sleep(0.5)
        tier.stdin.close()
        assert tier.wait(timeout=120) == 0
        final = json.loads(tier.stdout.read().strip().splitlines()[-1])
        assert final["router"]["router/errors"] == 0
        assert final["fleet"]["decisions"]
        assert final["store"]["evictions"] > 0
    finally:
        if tier.poll() is None:
            tier.kill()
            tier.wait(timeout=30)
