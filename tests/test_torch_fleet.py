"""The port's elastic fleet (iwae_replication_project_tpu_torch/serving/
fleet/) against the JAX package's: the same snapshot sequences through both
controllers give identical decision records, both planners the same plans
on seeded random inputs, and a JAX tier's ``slo`` wire document reduces to
what the port's local monitor reads for the same traffic. Then JAX's
tests/test_fleet.py ported to the port's router: the decision function
(hysteresis, cooldowns, bounds, dry run), the planner, signal snapshots,
store model pins, the FleetManager over fake engines (scale-up joins,
drain-based scale-down, a replica killed mid-scale-event), and the
guarantee that a fleet which changed shape returns bitwise what a static
fleet returns for the same admission order, with fake engines, with real
engines on the CPU (small widths) and over real sockets.

CPU only; the card's warm join is tests/test_torch_fleet_cuda.py.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.serving import fleet as jfleet
from iwae_replication_project_tpu.telemetry import slo as jslo
from iwae_replication_project_tpu_torch.serving.batcher import EngineOverloaded
from iwae_replication_project_tpu_torch.serving.fleet import (
    AutoscaleConfig,
    AutoscaleController,
    FleetManager,
    PlacementPlan,
    SignalSnapshot,
    choose_victim,
    local_signals,
    plan_placement,
    wire_signals,
)
from iwae_replication_project_tpu_torch.serving.frontend import (
    ReplicaRouter,
    ServingTier,
)
from iwae_replication_project_tpu_torch.telemetry.slo import (
    SLOMonitor,
    SLOObjective,
    peak_burns,
    window_requests,
)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeEngine:
    """Minimal engine surface (see tests/test_frontend.py): seed-dependent
    values make reroute/parity checks exact."""

    def __init__(self, mode="auto", dims=4, model=None, k_max=None,
                 sharded=False):
        self.mode = mode
        self.row_dims = {"score": dims, "encode": dims, "decode": dims}
        self.k = 5
        self.lock = threading.Lock()
        self.held = []
        self.submitted = 0
        self.stopped = False
        if model is not None:
            self.model = model
            self.models = (model,)
        if k_max is not None:
            self.k_max = k_max
        if sharded:
            self.sharded = True

    @staticmethod
    def value(row, seed):
        return float(seed) * 1000.0 + float(sum(row))

    def submit(self, op, row, k=None, *, seed=None, model=None):
        with self.lock:
            if self.mode == "shed":
                raise EngineOverloaded("queue full")
            if self.mode == "raise":
                raise RuntimeError("device on fire")
            self.submitted += 1
            f = Future()
            if self.mode == "manual":
                self.held.append((op, list(row), k, seed, f))
            else:
                f.set_result(self.value(row, seed))
            return f

    def finish(self, n=None, exc=None):
        with self.lock:
            batch, self.held = (self.held[:n], self.held[n:]) if n else \
                (self.held, [])
        for _, row, _, seed, f in batch:
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

    def warmup(self, ops=(), ks=None):
        return {"programs": 0.0}


class CrashOnStopEngine(FakeEngine):
    """A replica that dies exactly when the drain asks it to flush — the
    mid-scale-event kill."""

    def stop(self, timeout_s=None):
        self.stopped = True
        raise RuntimeError("replica killed mid-scale-event")


def wait_until(pred, timeout=5.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(0.002)


def snap(t=0.0, replicas=2, fast=0.0, slow=0.0, outstanding=0,
         indices=None, inflight=None, requests=0):
    idx = tuple(range(replicas)) if indices is None else tuple(indices)
    return SignalSnapshot(
        t=t, replicas=replicas, draining=0, unhealthy=0,
        outstanding=outstanding, burns={"5m": fast, "1h": slow},
        requests={"5m": requests}, store={}, live_indices=idx,
        inflight=tuple([0] * len(idx)) if inflight is None
        else tuple(inflight))


# ---------------------------------------------------------------------------
# controller: rules, hysteresis, cooldowns, determinism
# ---------------------------------------------------------------------------

def test_scale_up_on_confirmed_burn_breach():
    c = AutoscaleController(AutoscaleConfig(max_replicas=4,
                                            confirm_burn=0.5))
    d = c.decide(snap(t=0, replicas=2, fast=2.0, slow=1.0))
    assert d.action == "up" and d.target == 3 and d.rule == "burn-breach"


def test_scale_up_needs_slow_window_confirmation():
    c = AutoscaleController(AutoscaleConfig(confirm_burn=0.5))
    # a 5m spike the 1h window does not confirm holds (multi-window guard)
    d = c.decide(snap(t=0, replicas=2, fast=5.0, slow=0.1))
    assert d.action == "hold" and d.rule == "in-band"


def test_scale_up_bounded_and_cooled_down():
    c = AutoscaleController(AutoscaleConfig(max_replicas=4,
                                            up_cooldown_s=30.0))
    assert c.decide(snap(t=0, replicas=2, fast=2.0, slow=2.0)).action == "up"
    # breach persists inside the cooldown: hold, with the rule named
    d = c.decide(snap(t=10, replicas=3, fast=2.0, slow=2.0))
    assert d.action == "hold" and d.rule == "up-cooldown"
    # cooldown passed: grow again — then the bound caps further growth
    # (at-max outranks cooldown in the rule order)
    assert c.decide(snap(t=50, replicas=3, fast=2.0, slow=2.0)).action == "up"
    d = c.decide(snap(t=60, replicas=4, fast=2.0, slow=2.0))
    assert d.action == "hold" and d.rule == "at-max"


def test_scale_down_when_idle_after_cooldown():
    c = AutoscaleController(AutoscaleConfig(min_replicas=1,
                                            down_cooldown_s=60.0))
    d = c.decide(snap(t=0, replicas=3, fast=0.0, outstanding=0,
                      indices=(0, 1, 5), inflight=(0, 0, 0)))
    # no prior scale event: idle shrinks immediately, draining the
    # youngest (highest stable index) among the equally-loaded
    assert d.action == "down" and d.target == 2 and d.victim == 5
    # within down-cooldown of that event: hold
    d2 = c.decide(snap(t=30, replicas=2, fast=0.0))
    assert d2.action == "hold" and d2.rule == "down-cooldown"
    # past it: shrink again, to the floor
    d3 = c.decide(snap(t=100, replicas=2, fast=0.0))
    assert d3.action == "down" and d3.target == 1
    d4 = c.decide(snap(t=300, replicas=1, fast=0.0))
    assert d4.action == "hold" and d4.rule == "at-min"


def test_no_scale_down_with_work_in_flight():
    c = AutoscaleController(AutoscaleConfig())
    d = c.decide(snap(t=0, replicas=3, fast=0.0, outstanding=4))
    assert d.action == "hold"


def test_hysteresis_band_holds():
    cfg = AutoscaleConfig(scale_up_burn=1.0, scale_down_burn=0.25)
    c = AutoscaleController(cfg)
    d = c.decide(snap(t=0, replicas=2, fast=0.6))
    assert d.action == "hold" and d.rule == "in-band"


def test_down_cooldown_measured_from_scale_up_too():
    """A fresh scale-up is never immediately unwound by an idle tick."""
    c = AutoscaleController(AutoscaleConfig(down_cooldown_s=60.0))
    assert c.decide(snap(t=0, replicas=2, fast=2.0, slow=2.0)).action == "up"
    d = c.decide(snap(t=10, replicas=3, fast=0.0))
    assert d.action == "hold" and d.rule == "down-cooldown"


def test_dry_run_decides_but_never_arms_cooldowns():
    c = AutoscaleController(AutoscaleConfig(dry_run=True,
                                            up_cooldown_s=1e9))
    d1 = c.decide(snap(t=0, replicas=2, fast=2.0, slow=2.0))
    assert d1.action == "up" and d1.dry_run
    # nothing was actuated, so the (huge) cooldown must not have started:
    # the identical breach still reads as an "up" decision
    d2 = c.decide(snap(t=1, replicas=2, fast=2.0, slow=2.0))
    assert d2.action == "up" and d2.dry_run


def test_decision_sequence_is_deterministic():
    snaps = [snap(t=float(i * 10), replicas=2 + (i % 2),
                  fast=(2.0 if i % 3 == 0 else 0.0),
                  slow=(2.0 if i % 3 == 0 else 0.0)) for i in range(12)]
    logs = []
    for _ in range(2):
        c = AutoscaleController(AutoscaleConfig(seed=7))
        for s in snaps:
            c.decide(s)
        logs.append(c.log)
    assert logs[0] == logs[1]
    # every record carries the inputs it was a function of
    assert all("inputs" in rec and "rule" in rec for rec in logs[0])


def test_decision_log_and_fleet_metrics_published():
    c = AutoscaleController(AutoscaleConfig())
    c.decide(snap(t=0, replicas=2, fast=2.0, slow=2.0))
    c.decide(snap(t=100, replicas=3, fast=0.5))
    assert [r["action"] for r in c.log] == ["up", "hold"]
    assert c.registry.counter("fleet/decisions").value == 2
    assert c.registry.counter("fleet/scale_ups").value == 1
    assert c.registry.gauge("fleet/burn_fast").value == 0.5


def test_zero_live_replicas_holds():
    c = AutoscaleController(AutoscaleConfig())
    d = c.decide(snap(t=0, replicas=0, fast=9.0, slow=9.0, indices=()))
    assert d.action == "hold" and d.rule == "no-live-replicas"


def test_config_validation():
    with pytest.raises(ValueError):
        AutoscaleConfig(min_replicas=0)
    with pytest.raises(ValueError):
        AutoscaleConfig(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        AutoscaleConfig(scale_up_burn=0.5, scale_down_burn=1.0)
    with pytest.raises(ValueError):
        AutoscaleConfig(up_cooldown_s=-1)


def test_choose_victim_least_loaded_youngest_seeded():
    assert choose_victim([0, 1, 2], [3, 1, 2]) == 1
    # tie on load: youngest (highest index) first
    assert choose_victim([0, 1, 2], [1, 0, 0]) == 2
    # the seed rotates only among tied candidates, deterministically
    assert choose_victim([0, 1, 2], [1, 0, 0], seed=1) == 1
    assert choose_victim([0, 1, 2], [1, 0, 0], seed=2) == 2
    assert choose_victim([], []) is None


# ---------------------------------------------------------------------------
# planner: deterministic first-fit-decreasing placement
# ---------------------------------------------------------------------------

def test_plan_placement_first_fit_decreasing():
    plan = plan_placement({"a": 100, "b": 50, "c": 300},
                          {0: 200, 1: 320})
    # c (largest) lands first; with seed 0 replicas are visited 0, 1 —
    # c overflows 0's budget onto 1; a then b fill 0
    assert plan.assignments == ((0, ("a", "b")), (1, ("c",)))
    assert plan.overflow == ()
    assert plan.home_of("c") == 1 and plan.home_of("a") == 0


def test_plan_placement_is_deterministic_and_seed_rotates():
    args = ({"a": 100, "b": 100}, {3: 1000, 7: 1000})
    assert plan_placement(*args) == plan_placement(*args)
    p0 = plan_placement(*args, seed=0)
    p1 = plan_placement(*args, seed=1)
    # same models placed; the seed only rotates which replica is first-fit
    assert p0.placed() == p1.placed() == ("a", "b")
    assert p0.models_for(3) == ("a", "b") and p1.models_for(7) == ("a", "b")


def test_plan_placement_overflow_and_unbounded():
    plan = plan_placement({"big": 10_000, "small": 10}, {0: 100})
    assert plan.overflow == ("big",) and plan.models_for(0) == ("small",)
    # an unbounded budget (None) takes everything
    plan = plan_placement({"big": 10_000, "small": 10}, {0: None})
    assert plan.overflow == () and plan.models_for(0) == ("big", "small")


def test_plan_placement_respects_replica_capabilities():
    plan = plan_placement(
        {"a": 10, "b": 10}, {0: 1000, 1: 1000},
        replica_models={0: frozenset({"a"}), 1: frozenset({"b"})})
    assert plan.models_for(0) == ("a",) and plan.models_for(1) == ("b",)
    # a model NO replica may host overflows rather than landing wrong
    plan = plan_placement({"c": 10}, {0: 1000},
                          replica_models={0: frozenset({"a"})})
    assert plan.overflow == ("c",)


def test_plan_record_shape():
    rec = plan_placement({"a": 5}, {0: 10}).record()
    assert rec == {"assignments": [[0, ["a"]]], "overflow": [],
                   "costs": {"a": 5}}


# ---------------------------------------------------------------------------
# signals: one snapshot schema, local and wire
# ---------------------------------------------------------------------------

def _burn_doc(fast_burn, requests=10):
    return {"m/score": {"objective": {}, "windows": {
        "5m": {"requests": requests, "latency_burn": fast_burn,
               "availability_burn": 0.0},
        "1h": {"requests": requests, "latency_burn": fast_burn / 2,
               "availability_burn": 0.0}}}}


def test_peak_burns_and_window_requests_reductions():
    doc = dict(_burn_doc(2.0), **{"n/score": {"windows": {
        "5m": {"requests": 3, "latency_burn": 0.1,
               "availability_burn": 4.0}}}})
    assert peak_burns(doc) == {"5m": 4.0, "1h": 1.0}
    assert window_requests(doc) == {"5m": 13, "1h": 10}
    assert peak_burns({}) == {} and window_requests({}) == {}


def test_local_signals_snapshot():
    clock = FakeClock(100.0)
    engines = [FakeEngine("manual"), FakeEngine("auto")]
    router = ReplicaRouter(engines, clock=clock)
    slo = SLOMonitor(registry=router.registry, clock=clock,
                     default=SLOObjective(latency_s=0.01))

    class StubTier:
        pass

    tier = StubTier()
    tier.router, tier.slo, tier.clock = router, slo, clock
    router.submit("score", [0, 0, 0, 0])          # held on the manual fake
    slo.observe("score", 5.0, model="m")          # a latency violation
    s = local_signals(tier)
    assert s.t == 100.0 and s.replicas == 2 and s.outstanding == 1
    assert s.live_indices == (0, 1) and s.inflight == (1, 0)
    assert s.burn("5m") > 1.0                     # 100% violations burn hot
    assert s.requests_in("5m") == 1
    engines[0].finish()
    router.drain(timeout_s=5)


def test_wire_signals_matches_local_reduction():
    """The fleet-of-fleets contract: the `slo` wire doc reduces to the
    same snapshot numbers a local monitor would."""
    states = [{"index": 0, "healthy": True, "draining": False,
               "inflight": 0}]
    doc = {"enabled": True, "slo": _burn_doc(3.0)}
    s = wire_signals(doc, replica_states=states, t=5.0)
    assert s.burn("5m") == 3.0 and s.burn("1h") == 1.5
    assert s.replicas == 1 and s.t == 5.0
    # the raw snapshot shape (no envelope) is accepted too
    s2 = wire_signals(_burn_doc(3.0), replica_states=states, t=5.0)
    assert s2.burns == s.burns
    # disabled child: zero burns, not a crash
    s3 = wire_signals({"enabled": False, "slo": {}},
                      replica_states=states, t=5.0)
    assert s3.burns == {}


# ---------------------------------------------------------------------------
# store: model-level placement pins
# ---------------------------------------------------------------------------

def test_store_model_pins_block_eviction_until_release():
    from iwae_replication_project_tpu_torch.utils.compile_cache import (
        EagerProgram, ExecutableStore, signature)

    store = ExecutableStore(budget_bytes=None)
    for i, model in enumerate(("hot", "cold")):
        x = torch.arange(4 + i, dtype=torch.float32)
        store.get_or_build(f"prog{i}", lambda readmit: EagerProgram(
            lambda t: t + 1), ("bk",), signature((x,)), 4 * x.numel(),
            model=model)
    costs = store.model_costs()
    assert set(costs) == {"hot", "cold"} and all(
        c > 0 for c in costs.values())
    pin = store.pin_model("hot")
    assert store.model_pins() == {"hot": 1}
    store.set_budget(0)          # evict everything unpinned
    assert [e["model"] for e in store.entries()] == ["hot"]
    assert store.stats()["model_pins"] == {"hot": 1}
    pin.release()
    assert store.model_pins() == {}
    store.set_budget(0)
    assert store.entries() == []
    pin.release()                # double release is a no-op


# ---------------------------------------------------------------------------
# lifecycle: FleetManager over fakes
# ---------------------------------------------------------------------------

class StubStore:
    """The store surface FleetManager's planner path consumes."""

    def __init__(self, costs=None, budget=None):
        self.costs = dict(costs or {})
        self.budget_bytes = budget
        self.pins = []

    def model_costs(self):
        return dict(self.costs)

    def pin_model(self, model):
        class Pin:
            def __init__(p, s, m):
                p.s, p.model = s, m
                s.pins.append(p)

            def release(p):
                p.s.pins.remove(p)
        return Pin(self, model)


def make_manager(n=2, config=None, factory_engines=None, costs=None,
                 clock=None, model=None):
    clock = clock if clock is not None else FakeClock()
    engines = [FakeEngine("auto", model=model) for _ in range(n)]
    router = ReplicaRouter(engines, clock=clock)
    slo = SLOMonitor(registry=router.registry, clock=clock,
                     default=SLOObjective(latency_s=0.01))

    class StubTier:
        pass

    tier = StubTier()
    tier.router, tier.slo, tier.clock = router, slo, clock
    made = list(factory_engines or [])

    def factory():
        return made.pop(0) if made else FakeEngine("auto", model=model)

    mgr = FleetManager(
        tier, factory,
        config or AutoscaleConfig(min_replicas=1, max_replicas=4,
                                  up_cooldown_s=0.0, down_cooldown_s=0.0),
        store=StubStore(costs), warm_join=True, clock=clock)
    return mgr, engines, slo, clock


def test_manager_scales_up_on_breach_and_down_when_idle():
    mgr, engines, slo, clock = make_manager(n=2)
    # burn the budget: slow requests against a 10ms objective
    for _ in range(5):
        slo.observe("score", 1.0)
    clock.t = 10.0
    d = mgr.step()
    assert d.action == "up"
    assert len(mgr.router.engines) == 3
    assert mgr.decision_log[-1]["action"] == "up"
    # placement ran on the shape change
    assert mgr.placement_log and \
        mgr.placement_log[-1]["cause"] == "scale-up"
    # idle: the burn-rate windows rotate past the violations
    clock.t = 5000.0
    d = mgr.step()
    assert d.action == "down"
    assert len(mgr.router.engines) == 2
    # the drained engine was stopped and retained for teardown
    assert len(mgr.retired) == 1 and mgr.retired[0].stopped


def test_manager_dry_run_never_actuates():
    cfg = AutoscaleConfig(dry_run=True, up_cooldown_s=0.0,
                          down_cooldown_s=0.0)
    mgr, engines, slo, clock = make_manager(n=2, config=cfg)
    for _ in range(5):
        slo.observe("score", 1.0)
    clock.t = 10.0
    d = mgr.step()
    assert d.action == "up" and d.dry_run
    assert len(mgr.router.engines) == 2          # untouched
    assert mgr.decision_log[-1]["dry_run"]


def test_manager_warm_join_warms_before_exposure():
    warmed = []

    class WarmupProbe(FakeEngine):
        def warmup(self, ops=(), ks=None):
            warmed.append(len(self.held))
            return {}

    mgr, _, slo, clock = make_manager(factory_engines=[WarmupProbe("auto")])
    mgr.scale_up()
    # warmup ran exactly once, before any routed traffic reached it
    assert warmed == [0]


def test_manager_survives_replica_killed_mid_scale_event():
    """The chaos pin: the scale-down victim dies during its drain flush;
    its in-flight work reroutes with original seeds and the removal
    completes — no lost requests, no stuck manager."""
    victim = CrashOnStopEngine("manual")
    peer = FakeEngine("auto")
    clock = FakeClock()
    router = ReplicaRouter([victim, peer], clock=clock)
    slo = SLOMonitor(registry=router.registry, clock=clock)

    class StubTier:
        pass

    tier = StubTier()
    tier.router, tier.slo, tier.clock = router, slo, clock
    mgr = FleetManager(tier, FakeEngine, AutoscaleConfig(),
                       store=StubStore(), clock=clock)
    # park work on the victim (it serves (score, k=1) first by index order)
    futs = [router.submit("score", [float(i), 0, 0, 0], k=1)
            for i in range(4)]
    assert victim.held
    assert mgr.scale_down(victim=0) == 0
    # every accepted request resolved, with its ORIGINAL admission seed
    got = [f.result(timeout=5) for f in futs]
    assert got == [i * 1000.0 + float(i) for i in range(4)]
    assert len(router.engines) == 1
    assert router.registry.counter("router/reroutes").value >= 1


def test_manager_rebalance_pins_and_primes_affinity():
    mgr, engines, slo, clock = make_manager(
        n=2, costs={"m1": 100, "m2": 50}, model=None)
    plan = mgr.rebalance()
    assert isinstance(plan, PlacementPlan)
    assert sorted(p.model for p in mgr.store.pins) == ["m1", "m2"]
    # a re-plan swaps pins, never leaks them
    mgr.rebalance()
    assert sorted(p.model for p in mgr.store.pins) == ["m1", "m2"]
    rec = mgr.placement_log[-1]
    assert rec["event"] == "rebalance" and rec["costs"] == {"m1": 100,
                                                            "m2": 50}


def test_manager_control_thread_runs_and_stops():
    cfg = AutoscaleConfig(interval_s=0.01)
    mgr, engines, slo, clock = make_manager(n=2, config=cfg)
    mgr.start()
    try:
        wait_until(lambda: len(mgr.decision_log) >= 3,
                   msg="control loop ticks")
    finally:
        mgr.stop()
    n = len(mgr.decision_log)
    time.sleep(0.05)
    assert len(mgr.decision_log) == n            # the loop actually stopped


# ---------------------------------------------------------------------------
# the scale-event parity pin: elastic fleet == static fleet, bitwise
# ---------------------------------------------------------------------------

def test_scale_events_preserve_admission_order_results():
    """Grow mid-burst, shrink mid-burst: results are exactly what a static
    single-replica fleet returns for the same admission order, because
    seeds are minted at admission — fleet shape never touches them."""
    rows = [[float(i), 1.0, 0, 0] for i in range(18)]

    # reference: a static 1-replica fleet, same admission order
    static = ReplicaRouter([FakeEngine("auto")])
    ref = [static.submit("score", r).result(timeout=5) for r in rows]
    static.drain(timeout_s=5)

    clock = FakeClock()
    e0 = FakeEngine("auto")
    router = ReplicaRouter([e0], clock=clock)
    slo = SLOMonitor(registry=router.registry, clock=clock)

    class StubTier:
        pass

    tier = StubTier()
    tier.router, tier.slo, tier.clock = router, slo, clock
    mgr = FleetManager(tier, FakeEngine, AutoscaleConfig(),
                       store=StubStore(), clock=clock)
    got = []
    for i, r in enumerate(rows):
        if i == 6:
            mgr.scale_up()                      # grow 1 -> 2 mid-burst
        if i == 12:
            mgr.scale_down(victim=1)            # shrink back mid-burst
        got.append(router.submit("score", r).result(timeout=5))
    assert got == ref
    router.drain(timeout_s=5)


def test_scale_down_under_load_real_sockets_parity():
    """Satellite: drain-based removal with in-flight work over real
    sockets — every accepted request resolves ok, results bitwise equal to
    a static fleet with the same admission order."""
    from iwae_replication_project_tpu_torch.serving.frontend import TierClient

    # static reference fleet (1 replica), same admission order
    static = ServingTier([FakeEngine("auto")], monitor_interval_s=0.05)
    static.start()
    try:
        with TierClient("127.0.0.1", static.port) as c:
            ref = [c.score([[float(i), 0, 0, 0]])[0] for i in range(10)]
    finally:
        static.stop(timeout_s=10)

    doomed, keeper = FakeEngine("manual"), FakeEngine("auto")
    tier = ServingTier([doomed, keeper], monitor_interval_s=0.05)
    tier.start()
    try:
        with TierClient("127.0.0.1", tier.port) as c:
            ids = [c.submit("score", [[float(i), 0, 0, 0]], k=(i % 2) + 1)
                   for i in range(6)]
            wait_until(lambda: doomed.submitted + keeper.submitted == 6,
                       msg="burst routed")
            assert doomed.held                   # in-flight work to drain
            remover = threading.Thread(
                target=lambda: tier.router.remove_replica(0, timeout_s=10),
                daemon=True)
            remover.start()                      # FakeEngine.stop completes
            remover.join(timeout=10)             # the held futures
            assert not remover.is_alive()
            ids += [c.submit("score", [[float(i), 0, 0, 0]])
                    for i in range(6, 10)]
            done = c.drain(ids)
        assert len(done) == 10
        got = [done[rid]["result"][0] for rid in ids]
        assert all(done[rid]["ok"] for rid in ids)
        assert got == ref
        assert len(tier.router.engines) == 1
    finally:
        tier.stop(timeout_s=10)


# ---------------------------------------------------------------------------
# the port against the JAX package: decisions, plans, wire signals
# ---------------------------------------------------------------------------

def _random_snaps(rng, n):
    out = []
    t = 0.0
    for _ in range(n):
        t += float(rng.choice([0.5, 5.0, 40.0, 200.0]))
        live = int(rng.randint(0, 6))
        idx = tuple(int(i) for i in sorted(rng.choice(12, live,
                                                      replace=False)))
        out.append(dict(
            t=t, replicas=live, draining=int(rng.randint(0, 2)),
            unhealthy=int(rng.randint(0, 2)),
            outstanding=int(rng.choice([0, 0, 3])),
            burns={"5m": float(rng.choice([0.0, 0.1, 0.3, 0.9, 1.0, 4.0])),
                   "1h": float(rng.choice([0.0, 0.4, 1.5]))},
            requests={"5m": int(rng.randint(0, 50)),
                      "1h": int(rng.randint(0, 500))},
            store={}, live_indices=idx,
            inflight=tuple(int(rng.randint(0, 3)) for _ in idx)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_controller_decisions_match_jax(seed):
    """The same snapshot sequence through JAX's and the port's controller,
    under one seeded random config: identical decision records."""
    rng = np.random.RandomState(seed)
    lo = int(rng.randint(1, 3))
    kw = dict(min_replicas=lo, max_replicas=lo + int(rng.randint(0, 4)),
              scale_up_burn=float(rng.choice([0.9, 1.0, 2.0])),
              confirm_burn=float(rng.choice([0.0, 0.5])),
              scale_down_burn=0.25,
              up_cooldown_s=float(rng.choice([0.0, 30.0])),
              down_cooldown_s=float(rng.choice([0.0, 120.0])),
              dry_run=bool(rng.randint(0, 2)), seed=int(rng.randint(0, 5)))
    port = AutoscaleController(AutoscaleConfig(**kw))
    ref = jfleet.AutoscaleController(jfleet.AutoscaleConfig(**kw))
    for s in _random_snaps(rng, 40):
        d = port.decide(SignalSnapshot(**s))
        dj = ref.decide(jfleet.SignalSnapshot(**s))
        assert d.record(SignalSnapshot(**s), port.config) == \
            dj.record(jfleet.SignalSnapshot(**s), ref.config)
    assert port.log == ref.log
    assert {a for a in (r["action"] for r in port.log)} >= {"hold"}


@pytest.mark.parametrize("seed", range(8))
def test_plan_placement_matches_jax(seed):
    rng = np.random.RandomState(100 + seed)
    models = [f"m{i}" for i in range(int(rng.randint(1, 7)))]
    costs = {m: int(rng.randint(1, 1000)) for m in models}
    replicas = [int(i) for i in rng.choice(9, int(rng.randint(1, 5)),
                                           replace=False)]
    budgets = {i: (None if rng.rand() < 0.2 else int(rng.randint(0, 1500)))
               for i in replicas}
    caps = None
    if rng.rand() < 0.5:
        caps = {i: frozenset(m for m in models if rng.rand() < 0.7)
                for i in replicas}
    s = int(rng.randint(0, 4))
    got = plan_placement(costs, budgets, replica_models=caps, seed=s)
    want = jfleet.plan_placement(costs, budgets, replica_models=caps, seed=s)
    assert (got.assignments, got.overflow, got.costs) == \
        (want.assignments, want.overflow, want.costs)
    assert got.record() == want.record()


def test_wire_signals_of_a_jax_tier_equal_local_signals_on_the_port():
    """A JAX tier's ``slo`` document, read over TCP by the port's client,
    reduces through the port's wire_signals to what the port's local
    monitor reads after the same traffic (an objective no request meets,
    so every window burns at its ceiling)."""
    from iwae_replication_project_tpu.serving.frontend import (
        ServingTier as JaxTier)
    from iwae_replication_project_tpu_torch.serving.frontend import (
        TierClient)

    jtier = JaxTier([FakeEngine("auto")], monitor_interval_s=0.05,
                    slo=jslo.SLOMonitor(default=jslo.SLOObjective(
                        latency_s=1e-9)))
    ptier = ServingTier([FakeEngine("auto")], monitor_interval_s=0.05,
                        slo=SLOMonitor(default=SLOObjective(
                            latency_s=1e-9)))
    jtier.start()
    ptier.start()
    try:
        for tier in (jtier, ptier):
            with TierClient("127.0.0.1", tier.port) as c:
                for i in range(5):
                    c.score([[float(i), 0, 0, 0]])
                wait_until(lambda: c.slo()["slo"].get(
                    "score", {}).get("windows", {}).get("5m", {}).get(
                    "requests") == 5, msg="5 requests in the window")
        with TierClient("127.0.0.1", jtier.port) as c:
            doc = c.slo()
        states = ptier.router.replica_states()
        wire = wire_signals(doc, replica_states=states, t=1.0)
        local = local_signals(ptier, clock=lambda: 1.0)
        assert wire.burns == local.burns and wire.burns["5m"] > 1.0
        assert wire.requests == local.requests == {"5m": 5, "1h": 5}
        assert (wire.t, wire.replicas, wire.live_indices) == \
            (local.t, local.replicas, local.live_indices)
    finally:
        jtier.stop(timeout_s=10)
        ptier.stop(timeout_s=10)


# ---------------------------------------------------------------------------
# real engines: scale events over the CPU port, bitwise a static tier
# ---------------------------------------------------------------------------

def test_scale_events_with_real_engines_match_a_static_tier():
    """Real engines of the port (CPU, small widths) behind real sockets:
    one row per request, a warm join after the 4th request and a drain
    after the 9th; every response bitwise the static one-replica tier's for
    the same admission order (seeds are minted at admission), and the join
    found every program resident (no miss)."""
    from iwae_replication_project_tpu_torch.models.iwae import (
        ModelConfig, init_params)
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.serving.frontend import (
        TierClient)
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc

    cfg = ModelConfig(n_hidden_enc=(8,), n_latent_enc=(4,),
                      n_hidden_dec=(8,), n_latent_dec=(16,), x_dim=16,
                      likelihood="logits")
    params = init_params(torch.Generator().manual_seed(0), cfg)

    def engine(p=params):
        return ServingEngine(params=p, model_config=cfg, k=3, max_batch=4,
                             device="cpu", model="m")

    rows = (np.random.RandomState(3).rand(14, 16) > 0.5).astype(
        np.float32).tolist()
    with cc.isolated_aot_registry(budget_bytes=None):
        static = ServingTier([engine()], monitor_interval_s=0.05)
        static.warmup(ops=("score",))
        static.start()
        try:
            with TierClient("127.0.0.1", static.port) as c:
                ref = [c.score([r])[0] for r in rows]
        finally:
            static.stop(timeout_s=10)

        first = engine()
        tier = ServingTier([first], monitor_interval_s=0.05)
        tier.warmup(ops=("score",))
        tier.start()
        mgr = FleetManager(tier, lambda: engine(first._params),
                           AutoscaleConfig(max_replicas=2),
                           warmup_ops=("score",))
        try:
            got = []
            with TierClient("127.0.0.1", tier.port) as c:
                for i, r in enumerate(rows):
                    if i == 4:
                        s0 = cc.cache_stats()
                        mgr.scale_up()
                        d = cc.stats_delta(s0)
                        assert d["store_misses"] == 0
                        assert d["kernel_builds"] == 0
                    if i == 9:
                        mgr.scale_down(victim=0)
                    got.append(c.score([r])[0])
            assert got == ref
            assert len(tier.router.engines) == 1
            assert sum(e.metrics.counters()["completed"]
                       for e in [first] + list(tier.router.engines)) >= 10
        finally:
            tier.stop(timeout_s=10)


# ---------------------------------------------------------------------------
# the last-replica guard (the port's own rule; JAX's manager drains any
# victim the controller picks)
# ---------------------------------------------------------------------------

def _two_model_manager(models, clock):
    engines = [FakeEngine("auto", model=m) for m in models]
    router = ReplicaRouter(engines, clock=clock)
    slo = SLOMonitor(registry=router.registry, clock=clock,
                     default=SLOObjective(latency_s=0.01))

    class StubTier:
        pass

    tier = StubTier()
    tier.router, tier.slo, tier.clock = router, slo, clock
    mgr = FleetManager(
        tier, lambda: FakeEngine("auto", model=models[0]),
        AutoscaleConfig(min_replicas=1, max_replicas=4, up_cooldown_s=0.0,
                        down_cooldown_s=0.0),
        store=StubStore(), warm_join=True, clock=clock)
    return mgr, engines


def test_scale_down_never_drains_a_models_last_replica():
    """A two-model router with a spare replica of model "a": asked to drain
    model "b"'s only replica, scale_down drains a spare of "a" instead;
    with every model at one replica it raises, and the manager's step
    holds both replicas and logs the refused actuation."""
    clock = FakeClock()
    mgr, engines = _two_model_manager(["a", "a", "b"], clock)
    only_b = next(s["index"] for s in mgr.router.replica_states()
                  if s["model"] == "b")
    victim = mgr.scale_down(victim=only_b)
    assert victim != only_b
    left = mgr.router.replica_states()
    assert sorted(s["model"] for s in left) == ["a", "b"]
    assert mgr.retired == [engines[victim]] and engines[victim].stopped
    with pytest.raises(ValueError, match="last replica"):
        mgr.scale_down(victim=only_b)
    with pytest.raises(ValueError, match="last replica"):
        mgr.scale_down()
    # idle long enough for the controller to decide "down": the step
    # returns its decision, but no replica leaves
    clock.t = 5000.0
    d = mgr.step()
    assert d.action == "down"
    assert sorted(s["model"] for s in mgr.router.replica_states()) == \
        ["a", "b"]
    assert mgr.placement_log[-1]["event"] == "actuation-error"
    assert "last replica" in mgr.placement_log[-1]["error"]
    mgr.router.drain(timeout_s=5)
