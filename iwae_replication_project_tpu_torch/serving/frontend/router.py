"""Replica routing: least-inflight dispatch, (op, k) affinity, health
(port of ``serving/frontend/router.py``, over the port's engine surface).

The router owns the fleet-level request lifecycle between admission
(server.py — quotas and parsing live there; the router never sees a client
id) and the per-replica engines:

* **seed minting** — every admitted request gets a tier-level seed in
  arrival order (or keeps an explicitly supplied one). Serving results are
  a pure function of (weights, payload, seed, k) — serving/programs.py —
  so routing, re-routing, and replica choice are all bitwise invisible:
  the fleet returns exactly what one direct engine would;
* **selection policy** — least-inflight over healthy replicas, tie-broken
  by lowest replica index, with sticky (op, k)-group affinity: the replica
  that last served a group keeps it while its inflight stays within
  ``affinity_slack`` of the least-loaded candidate, so same-shape requests
  keep flowing to the replica whose kernels, library handles and memory
  pools are already warm for that bucket — load imbalance beyond the slack
  overrides affinity;
* **model-affinity classification** — a fleet may serve a whole model zoo
  (multi-tenant replicas expose ``engine.model`` / ``engine.models`` — the
  capability snapshot, same machinery as the large-k bits below). A
  request naming a model is eligible only for replicas that hold that
  model's weights; a model no replica declares is a synchronous ValueError
  (the typed ``bad_request`` upstream — it must never be served by the
  wrong weights). Model-less requests in a multi-model fleet resolve to
  the tier's ``default_model`` (the first replica's) at admission, so
  results stay a pure function of the request, never of routing;
  the affinity groups below are keyed (model, op, k), so each tenant's
  traffic keeps hitting the replica that is warm for it;
* **large-k classification** — a fleet may mix single-device replicas with
  mesh-backed :class:`~..sharded.ShardedScoreEngine` replicas
  (``engine.sharded``). A ``score`` request with k above
  ``large_k_threshold`` (default: the fast replicas' ``k_max``) is
  eligible only for sharded replicas; everything else keeps the fast
  single-device path (sharded replicas pick small traffic up only when
  the fleet has no fast replica at all). Replicas also only ever see ops
  they serve (``engine.row_dims``). An explicit request k outside
  ``[1, max over replicas' k_max]`` is a synchronous ValueError — the
  typed ``bad_request`` upstream — since no replica could legally take
  it; selection then never has to reason about impossible asks;
* **failure handling** — an engine that raises (at submit or via its
  future) marks its replica unhealthy and its outstanding work is
  re-dispatched to healthy peers *with the original seeds* (a reroute
  returns the identical result). A replica whose oldest in-flight request
  stalls past ``stall_deadline_s`` is drained the same way. Unhealthy
  replicas are re-admitted after a successful warm probe (a real request
  through the engine's warmed program that completes within
  ``probe_timeout_s``). Duplicate completions from abandoned dispatches
  are first-wins and error-ignored;
* **admission ceiling** — at most ``max_outstanding`` requests live in the
  tier at once; past it, :meth:`submit` raises :class:`TierOverloaded`
  (the typed ``overloaded`` response upstream). An individual replica's
  :class:`~..batcher.EngineOverloaded` shed makes the router try its
  peers first; only when EVERY healthy replica sheds does the caller see
  the overload;
* **graceful drain** — :meth:`drain` stops intake, flushes every replica
  via ``engine.stop()``, waits for the outstanding count to reach zero,
  and error-completes any leftover future with
  :class:`ReplicaUnavailable`: every accepted request gets a result or a
  typed error, never silence;
* **elastic fleet shape** — :meth:`add_replica` joins a new engine at a
  stable, monotonically-assigned index (indices are never reused, so
  affinity maps and per-replica gauges stay unambiguous across the
  fleet's whole history), and :meth:`remove_replica` retires one through
  the same drain contract as shutdown: the replica stops taking new work,
  its engine is flushed, and anything it still holds is rerouted to peers
  *with the original seeds* — an accepted request resolves identically
  whether the fleet grew, shrank, or held still, because seeds are minted
  in admission order before any replica is chosen. Every shape change
  recomputes the fleet capability snapshot (``k_max``, ``models``,
  large-k classification, ``default_model`` — which is sticky while its
  model is still served, so model-less traffic never silently switches
  weights mid-flight) and prunes affinity entries pointing at departed
  replicas. An autoscaler drives both.

Observability: one :class:`~...telemetry.registry.MetricRegistry` per
router — ``router/inflight/r<i>`` and ``router/healthy/r<i>`` gauges per
replica plus routed/reroutes/sheds/replica_failures/affinity_hits/
stall_drains/probe_readmits counters, read over the wire by the tier's
``stats`` control op next to each replica engine's own counters.

The router holds exactly ONE lock; engines and the metric registry have
their own and never call back into the router while holding them, and tier
futures are completed outside the lock — the lock graph stays acyclic by
construction.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from iwae_replication_project_tpu_torch.serving.batcher import (
    EngineOverloaded,
    RequestTimeout,
    complete_future,
)
from iwae_replication_project_tpu_torch.serving.buckets import (
    target_class,
    validate_adaptive_target,
    validate_k,
    validate_model,
)
from iwae_replication_project_tpu_torch.serving.faults import (
    SITE_ROUTER_DISPATCH,
)
from iwae_replication_project_tpu_torch.telemetry.registry import (
    MetricRegistry,
)
from iwae_replication_project_tpu_torch.utils.faults import fault_point

__all__ = ["ReplicaRouter", "TierOverloaded", "ReplicaUnavailable"]

#: ops carrying an accuracy target instead of a fixed sample count — their
#: k is the CAP, their results end in a measured ``k_used`` column, and the
#: router dispatches them by least ESTIMATED work (the per-(op, target
#: class) EWMA of measured k_used) instead of least inflight
ADAPTIVE_OPS = ("score_adaptive",)

#: EWMA weight of the per-(op, target-class) measured-k_used estimator —
#: fast enough to track a workload shift within tens of requests, slow
#: enough that one freak row does not flip placement
WORK_EWMA_ALPHA = 0.3


class TierOverloaded(RuntimeError):
    """The tier-wide outstanding-request ceiling is hit; back off/retry."""


class ReplicaUnavailable(RuntimeError):
    """No healthy replica can take the request (fleet down or draining)."""


@dataclasses.dataclass
class _Tracked:
    """One admitted request's tier-level state (owned by the router)."""

    ticket: int
    op: str
    row: Any                      # validated payload row (np [d])
    k: Optional[int]
    seed: int
    future: Future
    #: resolved tenant (None only in an unlabeled single-model fleet)
    model: Optional[str] = None
    #: tracing context the attempt spans attach under (None = untraced)
    trace: Any = None
    #: the CURRENT dispatch attempt's open span — written by the flow that
    #: owns the request at that moment (dispatch path, or the owning
    #: engine-future callback; `owns` gates every touch), finished exactly
    #: once per attempt before the next attempt opens its own
    span: Any = None
    attempts: int = 0
    replica_index: int = -1
    t_dispatch: float = 0.0
    #: True while the dispatching thread is in the submit window — between
    #: placing the request on a replica and registering its done-callback,
    #: which runs OUTSIDE the router lock (engine.submit may block). A
    #: failure drain must not steal a request in this window: the
    #: dispatcher is still touching it, and stealing double-dispatches
    #: (two threads rerouting one request, both mutating its span and
    #: attempt count). Written only under the router lock.
    submitting: bool = False
    #: set (under the router lock) exactly once, when the tier future is
    #: completed — guards the outstanding-count decrement against the
    #: duplicate completions rerouting can produce
    finalized: bool = False
    #: adaptive accuracy target (``score_adaptive``; 0.0 = criterion
    #: disabled) — forwarded verbatim to the serving replica
    target_se: float = 0.0
    ess_floor: float = 0.0
    #: the coarse (decade-quantized) target class this request's measured
    #: k_used is attributed under; None = fixed-k traffic
    tclass: Optional[str] = None
    #: estimated samples this request will draw (adaptive: the target
    #: class's k_used EWMA, capped at k; fixed-k: the request k) — what the
    #: estimated-work selection sums per replica
    work: float = 1.0


class _Replica:
    """One engine plus its routing state. Deliberately lock-free: every
    mutable field is guarded by the owning router's single lock, so the
    fleet has one synchronization domain, not N+1."""

    __slots__ = ("index", "engine", "healthy", "draining", "outstanding",
                 "last_error", "sharded", "k_max", "ops", "model", "models",
                 "traces")

    def __init__(self, index: int, engine):
        self.index = index
        self.engine = engine
        self.healthy = True
        #: set by remove_replica: the replica finishes what it holds but
        #: takes no new work (excluded by _select, never warm-probed back)
        self.draining = False
        #: ticket -> _Tracked currently dispatched here (inflight = len)
        self.outstanding: Dict[int, _Tracked] = {}
        self.last_error: Optional[str] = None
        # capability snapshot (immutable per engine): the classification
        # bits _select filters on. Fakes without the attributes read as
        # fast/unbounded/serve-everything — the pre-large-k behavior.
        self.sharded = bool(getattr(engine, "sharded", False))
        self.k_max: Optional[int] = getattr(engine, "k_max", None)
        dims = getattr(engine, "row_dims", None)
        self.ops: Optional[frozenset] = \
            frozenset(dims) if dims is not None else None
        # model capability: the replica's default tenant plus the full set
        # it holds weights for (RemoteEngine proxies forward a child tier's
        # whole zoo). Neither attribute -> unlabeled (the single-model
        # legacy replica: serves model-less traffic only).
        self.model: Optional[str] = getattr(engine, "model", None)
        ms = getattr(engine, "models", None)
        self.models: Optional[frozenset] = \
            frozenset(ms) if ms else \
            (frozenset({self.model}) if self.model is not None else None)
        # tracing capability: whether the engine accepts submit(trace=) and
        # records pipeline-stage spans. Fakes without the bit never see the
        # kwarg — the router's attempt spans still cover the dispatch.
        self.traces = bool(getattr(engine, "traces", False))

    def serves(self, op: str) -> bool:
        return self.ops is None or op in self.ops

    def serves_model(self, model: Optional[str]) -> bool:
        """Whether this replica's weights may serve `model`: labeled
        replicas serve exactly their declared set; unlabeled replicas serve
        model-less traffic (the single-model legacy fleet)."""
        if model is None:
            return self.models is None
        return self.models is not None and model in self.models


class ReplicaRouter:
    """Least-inflight, affinity-aware dispatch over N engine replicas.

    ``engines`` share weights and config (the tier builds them that way);
    anything with the engine surface used here — ``submit(op, row, k=,
    seed=)`` returning a Future, ``stop()``, ``row_dims``, ``k`` — routes,
    so tests drive the full policy with fake engines and no device.
    """

    def __init__(self, engines: Sequence, *, max_outstanding: int = 4096,
                 affinity_slack: int = 2, stall_deadline_s: float = 30.0,
                 probe_timeout_s: float = 5.0,
                 probe_op: str = "score",
                 large_k_threshold: Optional[int] = None,
                 registry: Optional[MetricRegistry] = None,
                 clock: Callable[[], float] = time.monotonic):
        if not engines:
            raise ValueError("a router needs at least one replica engine")
        if max_outstanding < 1:
            raise ValueError(
                f"max_outstanding must be >= 1, got {max_outstanding}")
        self.registry = registry if registry is not None else MetricRegistry()
        self.max_outstanding = int(max_outstanding)
        self.affinity_slack = int(affinity_slack)
        self.stall_deadline_s = float(stall_deadline_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.probe_op = probe_op
        self._clock = clock
        self._lock = threading.Lock()
        self._empty = threading.Condition(self._lock)
        # the replica list is COPY-ON-WRITE: every shape change (join,
        # removal) rebinds self._replicas to a fresh list under the lock,
        # so lock-free readers (serves_op, drain's flush walk) always
        # iterate one coherent snapshot. Replica indices are stable and
        # monotonic — never list positions — and _by_index is the only
        # index -> replica resolution (affinity maps survive removals).
        self._replicas: List[_Replica] = \
            [_Replica(i, e) for i, e in enumerate(engines)]
        self._by_index: Dict[int, _Replica] = \
            {r.index: r for r in self._replicas}
        self._next_index = len(self._replicas)
        #: the constructor's explicit large-k threshold, if any — honored
        #: verbatim across every fleet-shape recompute
        self._large_k_explicit = large_k_threshold
        self._affinity: Dict[Tuple, int] = {}
        #: (op, target-class) -> EWMA of measured per-row k_used — the
        #: estimated-work weight adaptive dispatch balances on (guarded by
        #: the router lock; fed by _on_engine_done from each adaptive
        #: result's k_used column)
        self._work_ewma: Dict[Tuple[str, Optional[str]], float] = {}
        #: where a model-less request lands in an all-labeled fleet: the
        #: FIRST replica's default model — resolved at admission so results
        #: are a pure function of the request, never of replica choice.
        #: STICKY across fleet-shape changes while its model is still
        #: served (see _recompute_locked).
        self.default_model: Optional[str] = None
        self._seed_counter = 0
        self._ticket_counter = 0
        self._outstanding_total = 0
        self._closed = False
        self._monitor: Optional[threading.Thread] = None
        self._monitor_stop = threading.Event()
        self._recompute_locked()
        self.registry.gauge("router/outstanding").set(0)
        for r in self._replicas:
            self._publish_replica(r)
        # pre-register the counter schema so /metrics carries every router
        # counter from the first scrape (same idiom as ServingMetrics)
        for name in ("routed", "completed", "errors", "reroutes", "sheds",
                     "quota_rejections", "replica_failures", "affinity_hits",
                     "stall_drains", "probe_readmits", "probes"):
            self.registry.counter(f"router/{name}")

    # -- metric plumbing ---------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        self.registry.counter(f"router/{name}").inc(n)

    def _publish_replica(self, r: _Replica) -> None:
        """Per-replica gauges (caller holds the lock or is __init__)."""
        self.registry.gauge(f"router/inflight/r{r.index}").set(
            len(r.outstanding))
        self.registry.gauge(f"router/healthy/r{r.index}").set(
            1 if r.healthy else 0)

    # -- fleet capability snapshot -------------------------------------------

    def _recompute_locked(self) -> None:
        """Recompute the fleet-wide capability snapshot from the CURRENT
        replica list (caller holds the lock, or is __init__). Runs on
        construction and on every fleet-shape change, so admission bounds
        (``k_max``), the model universe, and the large-k classification
        always describe the replicas that can actually serve — a stale
        snapshot would reject valid requests or admit impossible ones.

        * ``large_k_threshold`` — an explicit constructor threshold is
          honored verbatim; the derived default (the fast replicas'
          smallest ``k_max``) is re-derived, and it collapses to None when
          the fleet has no sharded replica left (nothing to classify onto —
          a threshold then would turn valid k into spurious unavailable
          errors) or when no fast replica exposes a bound (a 0 threshold
          would push everything onto the sharded class);
        * ``default_model`` is STICKY: while the current default's model is
          still served somewhere, it stays — re-deriving it from the (new)
          first replica would silently switch which weights serve
          model-less traffic mid-stream, breaking the results-are-a-pure-
          function-of-the-request contract. Only when the default's model
          leaves the fleet entirely is it re-resolved;
        * affinity entries pointing at departed replicas are pruned (the
          live ones keep their stable indices, so they stay valid).
        """
        reps = self._replicas
        self._has_fast = any(not r.sharded for r in reps)
        has_sharded = any(r.sharded for r in reps)
        if not has_sharded:
            self.large_k_threshold: Optional[int] = None
        elif self._large_k_explicit is not None:
            self.large_k_threshold = int(self._large_k_explicit)
        elif self._has_fast:
            fast_maxes = [r.k_max for r in reps
                          if not r.sharded and r.k_max is not None]
            self.large_k_threshold = min(fast_maxes) if fast_maxes else None
        else:
            self.large_k_threshold = None
        #: the tier-wide k admission bound (None = engines enforce theirs):
        #: max over replica k_max — a request k above it gets a synchronous
        #: ValueError (typed bad_request), never an internal error
        k_maxes = [r.k_max for r in reps if r.k_max is not None]
        self.k_max: Optional[int] = max(k_maxes) if k_maxes else None
        #: the union of declared model capabilities over the fleet (empty =
        #: unlabeled single-model fleet) — the typed-bad_request universe
        self.models: frozenset = frozenset().union(
            *(r.models for r in reps if r.models is not None)) \
            if any(r.models for r in reps) else frozenset()
        self._has_unlabeled = any(r.models is None for r in reps)
        if self.default_model is None or self.default_model not in self.models:
            self.default_model = next(
                (r.model for r in reps if r.model is not None), None)
        self._affinity = {g: i for g, i in self._affinity.items()
                          if i in self._by_index}
        self.registry.gauge("router/replicas").set(len(reps))

    # -- fleet shape: join + drain-based removal -----------------------------

    def add_replica(self, engine) -> int:
        """Join ``engine`` as a new replica; returns its stable index.

        The engine is expected to arrive warm (its kernels built and its
        ladder warmed); the router itself only snapshots
        its capabilities and folds them into the fleet-wide bounds.
        Existing traffic is untouched: seeds were minted at admission, so
        work the new replica picks up returns bitwise what any peer would
        have returned.
        """
        with self._lock:
            if self._closed:
                raise ReplicaUnavailable(
                    "serving tier is draining; no new replicas")
            index = self._next_index
            self._next_index += 1
            r = _Replica(index, engine)
            self._replicas = self._replicas + [r]     # copy-on-write
            self._by_index[index] = r
            self._publish_replica(r)
            self._recompute_locked()
        return index

    def remove_replica(self, index: int, timeout_s: float = 30.0):
        """Retire replica ``index`` through the drain contract; returns its
        engine (the caller owns disposal).

        The replica is first marked draining (it finishes what it holds
        but is never selected again), then its engine is flushed via
        ``engine.stop()`` — queued work dispatches and every in-flight
        future completes. After the outstanding set empties (or
        ``timeout_s`` passes — e.g. the replica died mid-removal), the
        replica leaves the fleet, capabilities recompute, and anything it
        still held is rerouted to peers *with the original seeds*: no
        accepted request is ever lost to a scale-down, and results are
        bitwise identical to a fleet that never shrank.
        """
        with self._lock:
            r = self._by_index.get(index)
            if r is None:
                raise ValueError(f"no replica with index {index}")
            if not any(x is not r and not x.draining
                       for x in self._replicas):
                raise ValueError("cannot remove the last replica")
            if r.draining:
                raise ValueError(f"replica r{index} is already draining")
            r.draining = True
        try:
            # outside the lock: engine.stop() flushes queues and joins
            # worker threads — foreign blocking work the router lock never
            # nests around
            r.engine.stop()
        except Exception as e:
            # the replica died mid-removal (the chaos schedule's favorite
            # moment): the standard failure path reroutes its in-flight
            # work with the original seeds; removal then proceeds
            self._replica_failed(r, e)
        deadline = self._clock() + timeout_s
        with self._empty:
            while r.outstanding:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                self._empty.wait(timeout=min(remaining, 0.25))
        with self._lock:
            # steal only fully-dispatched leftovers — one still in its
            # submit window belongs to the dispatching thread, which
            # observes the unhealthy flag and reroutes it itself
            r.healthy = False
            leftovers = [t for t in r.outstanding.values()
                         if not t.submitting]
            for t in leftovers:
                del r.outstanding[t.ticket]
            self._replicas = [x for x in self._replicas if x is not r]
            self._by_index.pop(index, None)
            self._recompute_locked()
            self.registry.gauge(f"router/inflight/r{index}").set(0)
            self.registry.gauge(f"router/healthy/r{index}").set(0)
        for t in leftovers:
            self._count("reroutes")
            self._finish_span(t, ReplicaUnavailable(
                f"replica r{index} removed before the request completed"))
            self._redispatch(t, exclude={index})
        return r.engine

    def prime_affinity(self, model: Optional[str], op: str,
                       k: Optional[int], index: int) -> bool:
        """Placement hint: point the ``(model, op, k)`` affinity group at
        replica ``index``, so the group's next request lands there. A
        hint, not a constraint — load imbalance beyond ``affinity_slack``
        still overrides, exactly like organically-earned affinity. Returns
        False (no-op) when the target is gone, draining, or unhealthy."""
        with self._lock:
            return self._prime_affinity_locked(model, op, k, index)

    def _prime_affinity_locked(self, model: Optional[str], op: str,
                               k: Optional[int], index: int) -> bool:
        r = self._by_index.get(index)
        if r is None or r.draining or not r.healthy:
            return False
        self._affinity[(model, op, k)] = index
        return True

    # -- introspection -----------------------------------------------------

    @property
    def engines(self) -> List:
        return [r.engine for r in self._replicas]

    @property
    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding_total

    def serves_op(self, op: str) -> bool:
        """Whether ANY replica serves `op` (capability sets are immutable
        per engine and the replica list is copy-on-write, so a lock-free
        read iterates one coherent snapshot — same basis as submit's
        check). The front end's SLO accounting uses this to keep garbage
        op names from minting burn-rate gauges."""
        return any(r.serves(op) for r in self._replicas)

    def profilers(self) -> tuple:
        """The live :class:`~...telemetry.profiling.DispatchProfiler` of
        every replica engine that carries one (in-process engines do by
        default; RemoteEngine proxies and fakes do not): the ``/prof``
        view's backing set. Lock-free: the replica list is copy-on-write,
        the same basis as :meth:`serves_op`."""
        return tuple(p for p in (getattr(r.engine, "profiler", None)
                                 for r in self._replicas) if p is not None)

    def replica_states(self) -> List[dict]:
        with self._lock:
            return [{"index": r.index, "healthy": r.healthy,
                     "draining": r.draining,
                     "inflight": len(r.outstanding),
                     "model": r.model,
                     "models": sorted(r.models) if r.models is not None
                     else None,
                     "last_error": r.last_error} for r in self._replicas]

    # -- request intake ----------------------------------------------------

    def submit(self, op: str, row, k: Optional[int] = None, *,
               seed: Optional[int] = None,
               model: Optional[str] = None,
               trace=None,
               target_se: Optional[float] = None,
               ess_floor: Optional[float] = None) -> Future:
        """Admit and dispatch one request row; returns the tier Future.

        ``trace`` is an optional
        :class:`~...telemetry.tracing.TraceContext`: every dispatch
        attempt then records an attempt-indexed child span
        (``router/attempt-<n>``, attrs: replica index) — a reroute after a
        replica failure shows up as attempt-1 (errored) + attempt-2, and
        the engine's pipeline-stage spans nest under the attempt that
        served the request.

        ``model`` names the tenant whose weights must serve the row; a
        model no replica declares is a synchronous ValueError (the typed
        ``bad_request`` upstream). ``None`` resolves to the fleet's
        ``default_model`` when every replica is model-labeled (a
        multi-model fleet must not let replica choice pick the weights).

        Raises synchronously for non-serving outcomes the caller must turn
        into typed responses: ValueError (bad payload/op/model, via the
        engine's own validation), :class:`TierOverloaded` (ceiling),
        :class:`EngineOverloaded` (every healthy replica shed), and
        :class:`ReplicaUnavailable` (no healthy replica / draining). Once
        a Future is returned, it ALWAYS completes — with a result, or with
        one of the typed errors above, or :class:`~..batcher.RequestTimeout`.
        """
        if not any(r.serves(op) for r in self._replicas):
            # typed bad_request, not 'unavailable': NO replica serves this
            # op even when fully healthy — the request is wrong, and a
            # retrying client must not burn its budget on it
            served = sorted(set().union(*(r.ops for r in self._replicas
                                          if r.ops is not None)))
            raise ValueError(f"unknown op {op!r}; this fleet serves "
                             f"{served}")
        model = self.resolve_model(model)
        tclass: Optional[str] = None
        if op in ADAPTIVE_OPS:
            # typed bad_request at the tier boundary, via the ONE shared
            # validator: the cap defaults to the fleet bound (resolved at
            # ADMISSION, so the request is fully specified before any
            # replica is chosen — results stay a pure function of it)
            if k is None:
                if self.k_max is None:
                    raise ValueError(
                        "score_adaptive needs an explicit k cap: no replica "
                        "in this fleet declares a k_max to default to")
                k = self.k_max
            target_se, ess_floor, k = validate_adaptive_target(
                target_se, ess_floor, k,
                self.k_max if self.k_max is not None else 2 ** 31 - 1)
            tclass = target_class(target_se, ess_floor)
        elif target_se is not None or ess_floor is not None:
            raise ValueError(
                f"target_se/ess_floor only apply to adaptive ops "
                f"({sorted(ADAPTIVE_OPS)}); {op!r} is fixed-k")
        elif k is not None:
            # typed bad_request at the tier boundary: an out-of-range k is
            # rejected HERE, before it can occupy the ceiling or reach a
            # replica as an internal error (the engines re-validate against
            # their own k_max; this is the fleet-wide bound)
            k = validate_k(k, self.k_max) if self.k_max is not None \
                else validate_k(k, 2 ** 31 - 1)
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise ReplicaUnavailable(
                    "serving tier is draining; no new requests")
            if self._outstanding_total >= self.max_outstanding:
                self._count("sheds")
                raise TierOverloaded(
                    f"tier ceiling hit ({self.max_outstanding} requests "
                    f"outstanding); shedding — retry with backoff")
            if seed is None:
                seed = self._seed_counter
                self._seed_counter = (self._seed_counter + 1) % (2 ** 31)
            self._ticket_counter += 1
            t = _Tracked(ticket=self._ticket_counter, op=op, row=row, k=k,
                         seed=int(seed), future=fut, model=model,
                         trace=trace,
                         target_se=target_se or 0.0,
                         ess_floor=ess_floor or 0.0, tclass=tclass,
                         work=self._estimated_work_locked(op, tclass, k))
            self._outstanding_total += 1
            self.registry.gauge("router/outstanding").set(
                self._outstanding_total)
        try:
            self._dispatch(t, exclude=set())
        except Exception as e:
            self._finalize(t, exc=e)
            raise
        self._count("routed")
        return fut

    def resolve_model(self, model: Optional[str]) -> Optional[str]:
        """The ONE model-resolution step: validate a named model against
        the fleet's declared capability set (unknown = ValueError, the
        typed ``bad_request`` — rejected before it can occupy the ceiling,
        because the one wrong outcome is the wrong weights answering), and
        pin a model-less request to ``default_model`` in an all-labeled
        fleet (so results never depend on which replica the balancer
        picked). The front end resolves BEFORE quota admission with this
        same call, so default-model traffic and explicitly-named traffic
        meter through one (client, model) lane."""
        if model is not None:
            return validate_model(model, self.models)
        if not self._has_unlabeled:
            return self.default_model
        return None

    # -- selection + dispatch ----------------------------------------------

    def _estimated_work_locked(self, op: str, tclass: Optional[str],
                               k: Optional[int]) -> float:
        """Estimated samples one request will draw (caller holds the lock).
        Fixed-k traffic costs exactly its k; adaptive traffic costs its
        (op, target-class) measured-k_used EWMA, capped at the request's
        own cap — before any measurement exists, the cap itself (the
        conservative prior: over-estimating new traffic spreads it, which
        is the safe failure mode)."""
        base = float(k) if k is not None else 1.0
        if tclass is None:
            return base
        est = self._work_ewma.get((op, tclass))
        return min(est, base) if est is not None else base

    def work_estimates(self) -> Dict[str, float]:
        """The live per-(op, target-class) measured-k_used EWMAs (stats /
        debugging surface; keys rendered ``op/class``)."""
        with self._lock:
            return {f"{op}/{tc}": est
                    for (op, tc), est in self._work_ewma.items()}

    def _note_k_used(self, t: _Tracked, result) -> None:
        """Fold an adaptive result's measured k_used column into its
        target class's work EWMA (the estimated-work dispatch weight)."""
        try:
            k_used = float(result[2])
        except Exception:
            return    # a fake replica returned a bare scalar: nothing to learn
        with self._lock:
            key = (t.op, t.tclass)
            prev = self._work_ewma.get(key)
            self._work_ewma[key] = k_used if prev is None else \
                prev + WORK_EWMA_ALPHA * (k_used - prev)

    def _wants_sharded(self, op: str, k: Optional[int]) -> bool:
        """Whether (op, k) belongs to the mesh-backed class: score above
        the threshold (k=None means the replica default — always small)."""
        return (op == "score" and self.large_k_threshold is not None
                and k is not None and k > self.large_k_threshold)

    def _eligible(self, r: _Replica, op: str, k: Optional[int],
                  model: Optional[str] = None) -> bool:
        """Capability filter under the classification policy: the replica
        must hold the request's model weights; large-k score needs a
        sharded replica; small traffic keeps the fast path (sharded
        replicas pick it up only in an all-sharded fleet); a replica never
        sees an op it does not serve or a k above its own bound."""
        if not r.serves(op) or not r.serves_model(model):
            return False
        if r.k_max is not None and k is not None and k > r.k_max:
            return False
        if op in ADAPTIVE_OPS:
            # the adaptive op only exists on replicas that register it (the
            # mesh-backed scorer; serves() above filtered) — the fast/
            # sharded k classification does not apply to a cap
            return True
        if self._wants_sharded(op, k):
            return r.sharded
        return not r.sharded or not self._has_fast

    def _select(self, group: Tuple,
                exclude: Set[int]) -> Optional[_Replica]:
        """Pick a replica (caller holds the lock): sticky group affinity
        while balanced, else least-LOAD with lowest-index tie-break — over
        the replicas eligible for this (model, op, k[, target-class])
        group. Load is the outstanding-request count for fixed-k traffic
        (the historical least-inflight policy, unchanged) and the summed
        estimated work — each outstanding request's ``work`` samples — for
        adaptive groups: ten easy rows (k_used ~ 50) must not count like
        ten k=5000 rows, or an easy-traffic replica would starve while its
        peer drowns."""
        model, op, k = group[:3]
        adaptive = len(group) > 3

        def load(r: _Replica) -> float:
            if adaptive:
                return sum(x.work for x in r.outstanding.values())
            return float(len(r.outstanding))

        cands = [r for r in self._replicas
                 if r.healthy and not r.draining and r.index not in exclude
                 and self._eligible(r, op, k, model)]
        if not cands:
            return None
        least = min(load(r) for r in cands)
        # the affinity slack is denominated in requests; for work-based
        # selection it scales by the group's per-request estimate so the
        # imbalance tolerance means "this many typical requests" either way
        slack = self.affinity_slack * (
            self._estimated_work_locked(op, group[3], k) if adaptive else 1.0)
        aff = self._affinity.get(group)
        if aff is not None:
            ar = self._by_index.get(aff)
            if ar is not None and ar.healthy and not ar.draining and \
                    aff not in exclude and \
                    self._eligible(ar, op, k, model) and \
                    load(ar) <= least + slack:
                self._count("affinity_hits")
                return ar
        chosen = min(cands, key=lambda r: (load(r), r.index))
        self._affinity[group] = chosen.index
        return chosen

    @staticmethod
    def _finish_span(t: _Tracked,
                     exc: Optional[BaseException] = None) -> None:
        """Close the request's CURRENT attempt span (no-op when untraced),
        stamping the typed error code when the attempt failed."""
        span, t.span = t.span, None
        if span is None:
            return
        if exc is None:
            span.finish()
        else:
            from iwae_replication_project_tpu_torch.serving.frontend.protocol \
                import error_code_for
            span.finish(error=error_code_for(exc))

    def _dispatch(self, t: _Tracked, exclude: Set[int]) -> None:
        """Place `t` on a replica, walking past sheds and submit-time
        failures; raises the typed error when the fleet cannot take it."""
        from iwae_replication_project_tpu_torch.telemetry.tracing import (
            start_span)
        any_shed = False
        # adaptive groups key affinity/selection by target class too: one
        # class's warm replica keeps its traffic, and the work-based load
        # comparison applies only within the adaptive family
        group = (t.model, t.op, t.k) if t.tclass is None \
            else (t.model, t.op, t.k, t.tclass)
        while True:
            with self._lock:
                r = self._select(group, exclude)
                if r is None:
                    break
                r.outstanding[t.ticket] = t
                t.replica_index = r.index
                t.attempts += 1
                t.t_dispatch = self._clock()
                t.submitting = True
                self._publish_replica(r)
            if t.trace is not None:
                # attempt-indexed child span: a rerouted request's tree
                # shows attempt-1 (errored) + attempt-2 side by side
                t.span = start_span(f"router/attempt-{t.attempts}",
                                    ctx=t.trace,
                                    attrs={"replica": r.index, "op": t.op})
            try:
                # chaos hook inside the try: an injected raise is attributed
                # to THIS replica (submit-time failure path), like a real one
                fault_point(SITE_ROUTER_DISPATCH, router=self,
                            replica=r.index, attempt=t.attempts)
                # outside the lock: engine.submit takes the engine's own
                # lock and may block briefly; the router lock never nests
                # around foreign blocking work. The model/trace ride along
                # only when resolved/supported — legacy fakes/engines keep
                # their signature.
                kw = {}
                if t.model is not None:
                    kw["model"] = t.model
                if t.span is not None and r.traces:
                    kw["trace"] = t.span.ctx()
                if t.tclass is not None:
                    # 0.0 means disabled at the wire/tracking layer; the
                    # engine's validator wants None for a disabled criterion
                    kw["target_se"] = t.target_se or None
                    kw["ess_floor"] = t.ess_floor or None
                ef = r.engine.submit(t.op, t.row, k=t.k, seed=t.seed, **kw)
            except EngineOverloaded as e:
                any_shed = True
                self._finish_span(t, e)
                self._unplace(t, r)
                exclude.add(r.index)
                continue
            except ValueError as e:
                self._finish_span(t, e)
                self._unplace(t, r)
                raise          # bad request: the engine's validation speaks
            except Exception as e:
                self._finish_span(t, e)
                self._unplace(t, r)
                self._replica_failed(r, e)
                exclude.add(r.index)
                continue
            ef.add_done_callback(
                lambda f, t=t, r=r: self._on_engine_done(t, r, f))
            with self._lock:
                t.submitting = False
                # the replica failed while we were in the submit window:
                # the drain skipped this request (we still owned it) — if
                # the engine future's callback hasn't claimed it either,
                # take the reroute ourselves, as a submit failure would
                abandoned = not r.healthy and \
                    r.outstanding.get(t.ticket) is t
                if abandoned:
                    del r.outstanding[t.ticket]
                    self._publish_replica(r)
            if not abandoned:
                return
            self._finish_span(t, RuntimeError(
                f"replica r{r.index} failed during submit"))
            exclude.add(r.index)
            continue
        if any_shed:
            self._count("sheds")
            raise EngineOverloaded(
                "every healthy replica shed the request (queues full); "
                "retry with backoff")
        raise ReplicaUnavailable("no healthy replica available")

    def _unplace(self, t: _Tracked, r: _Replica) -> None:
        with self._lock:
            r.outstanding.pop(t.ticket, None)
            t.submitting = False
            self._publish_replica(r)

    def _redispatch(self, t: _Tracked, exclude: Set[int],
                    shed_exc: Optional[BaseException] = None) -> None:
        """Callback-context dispatch: failures complete the future instead
        of raising (there is no caller to raise to). ``shed_exc`` marks a
        redispatch triggered by an async shed: if no peer can take the
        request, the shedding replica is FULL, not gone — the caller must
        see the original ``overloaded`` (back off and retry), never an
        ``unavailable`` that reads as fleet-down."""
        try:
            self._dispatch(t, exclude)
        except ReplicaUnavailable as e:
            self._finalize(t, exc=shed_exc if shed_exc is not None else e)
        except Exception as e:
            self._finalize(t, exc=e)

    # -- completion + failure paths ----------------------------------------

    # tolerant completion (the engine's contract): duplicate completions
    # from rerouted requests and caller-side cancellations must never kill
    # a completion callback
    _complete = staticmethod(complete_future)

    def _finalize(self, t: _Tracked, result=None, exc=None) -> None:
        """Complete the tier future (first completion wins) and retire the
        request from the outstanding count exactly once."""
        if exc is None:
            delivered = self._complete(t.future, result=result)
        else:
            delivered = self._complete(t.future, exc=exc)
        with self._lock:
            if t.finalized:
                return
            t.finalized = True
            self._outstanding_total -= 1
            self.registry.gauge("router/outstanding").set(
                self._outstanding_total)
            self._empty.notify_all()
        if delivered:
            self._count("completed" if exc is None else "errors")

    def _on_engine_done(self, t: _Tracked, r: _Replica, ef: Future) -> None:
        """Engine-future callback (runs on the replica's completion/dispatch
        thread). Success is delivered first-wins; an error from the replica
        currently owning the request marks it unhealthy, drains it, and
        reroutes; errors from abandoned (already-rerouted) dispatches are
        dropped — the live dispatch is authoritative."""
        with self._lock:
            owns = r.outstanding.get(t.ticket) is t
            if owns:
                del r.outstanding[t.ticket]
                self._publish_replica(r)
            finalized = t.finalized      # snapshot under the lock that
            # guards the flag; a completion landing after the snapshot is
            # deduplicated by _finalize itself
        exc = ef.exception()
        if exc is None:
            if owns:
                # the attempt that actually served the request closes its
                # span; an abandoned dispatch's late success must not touch
                # the live attempt's
                self._finish_span(t)
            result = ef.result()
            if t.tclass is not None:
                # measured k_used feeds the estimated-work weight this
                # class's NEXT requests dispatch under
                self._note_k_used(t, result)
            self._finalize(t, result=result)
            return
        if not owns or finalized:
            return
        self._finish_span(t, exc)
        if isinstance(exc, RequestTimeout):
            # the request's own deadline passed inside the replica: a typed
            # per-request outcome, not a replica failure — no reroute (its
            # deadline has already passed; a retry would serve it late)
            self._finalize(t, exc=exc)
            return
        if isinstance(exc, EngineOverloaded):
            # an async shed (remote replicas — frontend/remote.py — deliver
            # sheds through the future): the replica is FULL, not failed;
            # try its peers without marking it unhealthy
            if t.attempts <= len(self._replicas):
                self._count("reroutes")
                self._redispatch(t, exclude={r.index}, shed_exc=exc)
            else:
                self._finalize(t, exc=exc)
            return
        self._replica_failed(r, exc)
        if t.attempts <= len(self._replicas):
            self._count("reroutes")
            self._redispatch(t, exclude={r.index})
        else:
            self._finalize(t, exc=exc)

    def _replica_failed(self, r: _Replica, exc: BaseException) -> None:
        """Mark `r` unhealthy (once) and reroute everything it still holds."""
        with self._lock:
            was_healthy = r.healthy
            r.healthy = False
            r.last_error = f"{type(exc).__name__}: {exc}"
            # steal only fully-dispatched requests: one still in its submit
            # window belongs to the dispatching thread, which will observe
            # the unhealthy flag (or a submit failure / the errored engine
            # future) and reroute it itself — stealing it here would
            # double-dispatch it
            drained = [t for t in r.outstanding.values() if not t.submitting]
            for t in drained:
                del r.outstanding[t.ticket]
            self._publish_replica(r)
        if was_healthy:
            self._count("replica_failures")
        for other in drained:
            self._count("reroutes")
            # the failed replica's attempt dies with it — close its span
            # (errored) before the reroute opens the next attempt's
            self._finish_span(other, exc)
            self._redispatch(other, exclude={r.index})

    # -- health: stall detection + warm-probe re-admission ------------------

    def check_stalls(self, now: Optional[float] = None) -> int:
        """Drain any healthy replica whose OLDEST in-flight request has
        been outstanding longer than ``stall_deadline_s`` (a wedged engine
        backs up its window without ever raising). Returns the number of
        replicas drained. Called by the monitor thread; callable directly
        (tests drive it with a fake clock)."""
        now = self._clock() if now is None else now
        stalled: List[_Replica] = []
        with self._lock:
            for r in self._replicas:
                if r.healthy and r.outstanding:
                    oldest = min(t.t_dispatch
                                 for t in r.outstanding.values())
                    if now - oldest > self.stall_deadline_s:
                        stalled.append(r)
        for r in stalled:
            self._count("stall_drains")
            self._replica_failed(r, RequestTimeout(
                f"replica r{r.index} stalled: oldest in-flight request "
                f"exceeded {self.stall_deadline_s}s"))
        return len(stalled)

    def probe_unhealthy(self) -> int:
        """Warm-probe every unhealthy replica with one real request through
        its warmed program; a probe that completes in time re-admits the
        replica. Returns the number re-admitted."""
        with self._lock:
            # a draining replica is leaving the fleet: probing it back in
            # would hand it new work mid-removal
            down = [r for r in self._replicas
                    if not r.healthy and not r.draining]
            if not down:
                return 0
        readmitted = 0
        for r in down:
            self._count("probes")
            try:
                # probe each replica against ITS OWN contract (a mixed
                # fast/sharded fleet has different row dims, ops, and k
                # bounds per replica — a template probe would misfire)
                op = self.probe_op if r.serves(self.probe_op) \
                    else sorted(r.engine.row_dims)[0]
                probe_row = [0.0] * r.engine.row_dims[op]
                # a labeled replica is probed under its own model, as live
                # traffic reaches it
                kw = {"model": r.model} if r.model is not None else {}
                ef = r.engine.submit(op, probe_row,
                                     k=getattr(r.engine, "k", None), seed=0,
                                     **kw)
                ef.result(timeout=self.probe_timeout_s)
            except Exception:
                continue      # still down; next monitor tick retries
            with self._lock:
                r.healthy = True
                r.last_error = None
                self._publish_replica(r)
            self._count("probe_readmits")
            readmitted += 1
        return readmitted

    def start_monitor(self, interval_s: float = 0.25) -> None:
        """Background health loop: stall sweep + re-admission probes."""
        if self._monitor is not None:
            return
        self._monitor_stop.clear()

        def loop():
            while not self._monitor_stop.wait(interval_s):
                self.check_stalls()
                self.probe_unhealthy()

        self._monitor = threading.Thread(target=loop,
                                         name="iwae-tier-monitor",
                                         daemon=True)
        self._monitor.start()

    def stop_monitor(self) -> None:
        if self._monitor is not None:
            self._monitor_stop.set()
            self._monitor.join()
            self._monitor = None

    # -- drain --------------------------------------------------------------

    def drain(self, timeout_s: float = 60.0) -> None:
        """Stop intake, flush every replica (``engine.stop()`` dispatches
        queued work and completes all in-flight futures), wait for the
        outstanding count to hit zero, and error-complete anything left
        (replicas that died mid-drain) with :class:`ReplicaUnavailable` —
        zero accepted requests are ever lost to a shutdown."""
        with self._lock:
            self._closed = True
        self.stop_monitor()
        for r in self._replicas:
            try:
                r.engine.stop()
            except Exception as e:
                self._replica_failed(r, e)
        deadline = self._clock() + timeout_s
        with self._empty:
            while self._outstanding_total > 0:
                remaining = deadline - self._clock()
                if remaining <= 0 or not self._empty.wait(
                        timeout=min(remaining, 0.25)):
                    if self._clock() >= deadline:
                        break
        leftovers: List[_Tracked] = []
        with self._lock:
            for r in self._replicas:
                leftovers.extend(r.outstanding.values())
                r.outstanding.clear()
                self._publish_replica(r)
        for t in leftovers:
            exc = ReplicaUnavailable(
                "tier drained before the request completed (replica lost "
                "mid-drain)")
            self._finish_span(t, exc)
            self._finalize(t, exc=exc)
