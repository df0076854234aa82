"""Fleet actuation: turn Decisions into replica joins, drains, and plans
(port of ``serving/fleet/lifecycle.py``).

:class:`FleetManager` is the only fleet module that touches a live tier.
It owns:

* **the control thread** — :meth:`start` runs :meth:`step` every
  ``config.interval_s`` (signals → decide → actuate → re-place) until
  :meth:`stop`; each step also works standalone, which is how the tests
  and the chaos smoke drive deterministic scale events;
* **warm scale-up** — ``replica_factory()`` builds a new engine over the
  SHARED weight tensors, and the manager warms it (``engine.warmup()``)
  BEFORE :meth:`~..frontend.router.ReplicaRouter.add_replica` exposes it
  to traffic. Its programs key the executable store with the same weights,
  so the warmup finds them resident: store hits, no capture and no kernel
  build (the port's form of JAX's 0-fresh-compiles join);
* **drain-based scale-down** — the decision's victim (another, when it
  holds its model's last live replica) leaves through
  :meth:`~..frontend.router.ReplicaRouter.remove_replica`: intake stops,
  in-flight work finishes or reroutes with its original seeds, and only
  then does the replica leave the fleet. The stopped engine is retained
  in :attr:`retired` (the caller's teardown list), never abandoned;
* **placement** — after every shape change, :meth:`rebalance` re-plans
  model residency (:func:`~.planner.plan_placement` over the store's
  ``model_costs`` and budget), swaps the store's model pins to the new
  plan, and primes router affinity so each model's traffic favors its
  planned home. Placement moves warmth only — results are a pure
  function of (weights, payload, seed, k), and seeds were minted at
  admission.

A replica killed mid-scale-event (a fault schedule's favourite moment) is
absorbed by the router's failure path: its in-flight work
reroutes with original seeds, the manager's step logs the actuation error
and the loop keeps ticking — scaling machinery must never turn one
replica's death into a fleet outage.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence

from iwae_replication_project_tpu_torch.serving.fleet.controller import (
    AutoscaleConfig,
    AutoscaleController,
    Decision,
    choose_victim,
)
from iwae_replication_project_tpu_torch.serving.fleet.planner import (
    PlacementPlan,
    plan_placement,
)
from iwae_replication_project_tpu_torch.serving.fleet.signals import (
    SignalSnapshot,
    local_signals,
)

__all__ = ["FleetManager"]


class FleetManager:
    """One autoscaled tier: tier + replica factory + controller + planner.

    ``tier`` is a running :class:`~..frontend.server.ServingTier` (only
    its ``router``, ``slo``, and ``clock`` are used, so router-only test
    rigs drive it too). ``replica_factory`` is a zero-arg callable
    returning a NEW engine sharing the fleet's params — the scale-up
    primitive. ``store`` defaults to the process executable store;
    ``affinity_ops`` are the op groups placement primes (the default-k
    group per op). ``warm_join=False`` skips the pre-join warmup (tests
    with fakes; production keeps it on — joining cold would serve the
    first requests at capture latency)."""

    def __init__(self, tier, replica_factory: Callable[[], object],
                 config: Optional[AutoscaleConfig] = None, *,
                 store=None,
                 affinity_ops: Sequence[str] = ("score",),
                 warm_join: bool = True,
                 warmup_ops: Optional[Sequence[str]] = None,
                 drain_timeout_s: float = 30.0,
                 clock: Optional[Callable[[], float]] = None):
        self.tier = tier
        self.router = tier.router
        self.config = config if config is not None else AutoscaleConfig()
        self._factory = replica_factory
        self._clock = clock if clock is not None \
            else getattr(tier, "clock", time.monotonic)
        self.controller = AutoscaleController(
            self.config, registry=self.router.registry)
        if store is None:
            from iwae_replication_project_tpu_torch.utils.compile_cache import (
                executable_store)
            store = executable_store()
        self.store = store
        self.affinity_ops = tuple(affinity_ops)
        self.warm_join = bool(warm_join)
        #: ops the pre-join warmup admits (None = the engine's default
        #: full set); smokes pin this to the op set the tier itself warmed
        #: so the 0-captures join claim stays exact
        self.warmup_ops = tuple(warmup_ops) if warmup_ops is not None \
            else None
        self.drain_timeout_s = float(drain_timeout_s)
        #: engines retired by scale-down (already stopped; caller teardown)
        self.retired: List[object] = []
        #: placement + actuation-error records, same vein as controller.log
        self.placement_log: List[dict] = []
        self.plan: Optional[PlacementPlan] = None
        self._pins: List[object] = []
        # one actuation at a time: the loop thread and direct test calls
        # serialize here; the router/store locks are only ever taken
        # INSIDE this one (fleet -> router/store, never back — the lock
        # graph stays a tree)
        self._lock = threading.Lock()
        self._loop: Optional[threading.Thread] = None
        self._loop_stop = threading.Event()

    # -- one control tick ----------------------------------------------------

    def signals(self) -> SignalSnapshot:
        return local_signals(self.tier, clock=self._clock)

    def step(self) -> Decision:
        """signals → decide → actuate → re-place. Never raises for a
        failed actuation (a dead replica mid-scale-event is the router's
        to absorb) — the error lands in :attr:`placement_log` and the
        loop keeps its cadence."""
        with self._lock:
            snap = self.signals()
            decision = self.controller.decide(snap)
            if decision.dry_run or decision.action == "hold":
                return decision
            try:
                if decision.action == "up":
                    self._scale_up_locked()
                elif decision.action == "down":
                    self._scale_down_locked(decision.victim)
            except Exception as e:
                self.placement_log.append({
                    "t": snap.t, "event": "actuation-error",
                    "action": decision.action,
                    "error": f"{type(e).__name__}: {e}"})
            return decision

    # -- actuation ------------------------------------------------------------

    def scale_up(self) -> int:
        with self._lock:
            return self._scale_up_locked()

    def scale_down(self, victim: Optional[int] = None) -> int:
        with self._lock:
            return self._scale_down_locked(victim)

    def _scale_up_locked(self) -> int:
        engine = self._factory()
        start = getattr(engine, "start", None)
        if callable(start):
            start()
        if self.warm_join:
            warmup = getattr(engine, "warmup", None)
            if callable(warmup):
                # the warm join itself: over the shared weights every
                # program is a store hit — the replica meets traffic warm
                if self.warmup_ops is not None:
                    warmup(ops=self.warmup_ops)
                else:
                    warmup()
        index = self.router.add_replica(engine)
        self._rebalance_locked("scale-up")
        return index

    def _scale_down_locked(self, victim: Optional[int]) -> int:
        states = [s for s in self.router.replica_states()
                  if s["healthy"] and not s["draining"]]
        # a model's last live replica never leaves: the router would then
        # refuse every request for that model (the port's guard; the JAX
        # manager drains whatever the controller picked)
        per_model: dict = {}
        for s in states:
            per_model[s.get("model")] = per_model.get(s.get("model"), 0) + 1
        movable = [s for s in states if per_model[s.get("model")] > 1]
        if victim is None or victim not in [s["index"] for s in movable]:
            victim = choose_victim([s["index"] for s in movable],
                                   [s["inflight"] for s in movable],
                                   self.config.seed)
        if victim is None:
            raise ValueError("no live replica can leave without taking a "
                             "model's last replica")
        engine = self.router.remove_replica(victim, self.drain_timeout_s)
        self.retired.append(engine)
        self._rebalance_locked("scale-down")
        return victim

    # -- placement ------------------------------------------------------------

    def rebalance(self) -> PlacementPlan:
        with self._lock:
            return self._rebalance_locked("manual")

    def _rebalance_locked(self, cause: str) -> PlacementPlan:
        from iwae_replication_project_tpu_torch.utils.compile_cache import (
            DEFAULT_MODEL)

        costs = {}
        model_costs = getattr(self.store, "model_costs", None)
        if callable(model_costs):
            costs = dict(model_costs())
        states = [s for s in self.router.replica_states()
                  if not s["draining"]]
        budget = getattr(self.store, "budget_bytes", None)
        budgets = {s["index"]: budget for s in states}
        universe = frozenset(costs)
        replica_models = {
            s["index"]: (frozenset(s["models"])
                         if s.get("models") is not None else universe)
            for s in states}
        plan = plan_placement(costs, budgets,
                              replica_models=replica_models,
                              seed=self.config.seed)
        # swap pins to the new plan: pin-before-release, so a model placed
        # in both plans never has a pinless window a concurrent budget
        # squeeze could evict through
        old_pins, self._pins = self._pins, []
        for model in plan.placed():
            self._pins.append(self.store.pin_model(model))
        for pin in old_pins:
            pin.release()
        # affinity priming: each placed model's default-k groups point at
        # its planned home (a hint — load imbalance still overrides)
        for model in plan.placed():
            home = plan.home_of(model)
            if home is None or model == DEFAULT_MODEL:
                continue
            for op in self.affinity_ops:
                self.router.prime_affinity(model, op, None, home)
        self.plan = plan
        self.placement_log.append({  # iwaelint: disable=unlocked-shared-state -- every caller holds self._lock (the _locked suffix: step, scale_up, scale_down and rebalance take it first); the rule's write walk does not follow calls
            "t": self._clock(), "event": "rebalance", "cause": cause,
            **plan.record()})
        return plan

    # -- the control thread ----------------------------------------------------

    def start(self) -> "FleetManager":
        """Run :meth:`step` every ``config.interval_s`` until :meth:`stop`
        (idempotent; the thread is a daemon, like the tier monitor)."""
        if self._loop is not None:
            return self
        self._loop_stop.clear()

        def loop():
            while not self._loop_stop.wait(self.config.interval_s):
                self.step()

        self._loop = threading.Thread(target=loop,
                                      name="iwae-fleet-autoscaler",
                                      daemon=True)
        self._loop.start()
        return self

    def stop(self) -> None:
        if self._loop is not None:
            self._loop_stop.set()
            self._loop.join()
            self._loop = None

    # -- introspection ---------------------------------------------------------

    @property
    def decision_log(self) -> List[dict]:
        return self.controller.log

    def doc(self) -> dict:
        """One JSON-able status document (the smoke/bench artifact body)."""
        return {
            "config": dataclasses.asdict(self.config),
            "decisions": list(self.controller.log),
            "placements": list(self.placement_log),
            "replicas": self.router.replica_states(),
        }
