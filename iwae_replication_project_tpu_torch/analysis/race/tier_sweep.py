"""A fuzzed race sweep of the serving tier (port of the JAX package's
``scripts/race_smoke.py``).

Each round serves one ragged burst through the real tier: two replicas
behind :class:`~...serving.frontend.ServingTier` over TCP, the first one
killed mid-burst, so the router marks it unhealthy and reroutes. An
instrumented round installs :class:`~.instrument.Instrumentation` with a
:class:`~.model.RaceDetector` and a :class:`~.fuzz.PerturbFuzzer` of the
round's seed into the engine, batcher, router, server, quotas, client and
executable-store modules, and traces the attributes of their serving
classes (:func:`tracked_classes`). Four contracts:

1. **race-clean**: the detector records no race in any schedule; a report
   carries the seed that reproduces its schedule;
2. **leak-clean at run time**: after every round's drain, no open span in
   the round's flight recorder, no pinned executable-store entry and no
   outstanding router future;
3. **bitwise parity**: every round's rows, kill and reroutes included, are
   bitwise the rows of one uninstrumented direct engine (on the card C6
   makes a row's bits the same in every bucket);
4. **clean uninstall**: after the sweep every patched module global, the
   batcher's ``Request.future`` factory (its dataclass field and the
   closure cell of the generated ``__init__``) and every class hook is the
   original object again (:func:`uninstall_problems`).

Each round runs over a store of its own (:func:`round_store`), made while
the instrumentation is installed, so the store's lock is traced and the
store's entry and pin classes can be tracked. The scope of the attribute
tracer is the JAX sweep's: instance-attribute binds and rebinds (the
torn-flag and lost-counter class); container contents go through the
container object and are covered by the locksets and the queue and future
happens-before edges around them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue as _real_queue
import threading as _real_threading
import time
from concurrent.futures import Future as _RealFuture
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from iwae_replication_project_tpu_torch.analysis.race.fuzz import (
    PerturbFuzzer,
)
from iwae_replication_project_tpu_torch.analysis.race.instrument import (
    Instrumentation,
)
from iwae_replication_project_tpu_torch.analysis.race.model import (
    RaceDetector,
)

#: rows per request of a burst (small on purpose: the sweep buys coverage
#: from schedule diversity, not from burst size)
SIZES = (1, 3, 2, 4)


def serving_modules() -> tuple:
    """The modules whose ``threading``/``queue``/``Future`` globals a round
    swaps: the engine, batcher, router, server, quotas, client, and the
    executable store."""
    from iwae_replication_project_tpu_torch.serving import batcher, engine
    from iwae_replication_project_tpu_torch.serving.frontend import (
        client, quotas, router, server)
    from iwae_replication_project_tpu_torch.utils import compile_cache
    return (engine, batcher, router, server, quotas, client, compile_cache)


def tracked_classes() -> tuple:
    """The classes whose instance attributes a round traces: the JAX
    sweep's (engine, batcher, window, router, replica, tracked request,
    tier, connection, pending response, quotas) and the store's entry and
    pin handles."""
    from iwae_replication_project_tpu_torch.serving import batcher, engine
    from iwae_replication_project_tpu_torch.serving.frontend import (
        quotas, router, server)
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc
    return (engine.ServingEngine, batcher.MicroBatcher,
            batcher.InflightWindow, router.ReplicaRouter, router._Replica,
            router._Tracked, server.ServingTier, server._Connection,
            server._Pending, quotas.ClientQuotas, cc._StoreEntry,
            cc._PrefixPin, cc._ModelPin)


class KillableReplica:
    """Engine proxy with an induced-death switch: :meth:`kill` errors the
    futures in flight and refuses new submits, so the router must mark it
    unhealthy and reroute."""

    def __init__(self, engine):
        self.engine = engine
        self.row_dims = engine.row_dims
        self.k = engine.k
        self.k_max = engine.k_max
        self._lock = _real_threading.Lock()
        self._live: List[_RealFuture] = []
        self.killed = False
        self.submitted = 0

    def submit(self, op, row, k=None, *, seed=None):
        with self._lock:
            if self.killed:
                raise RuntimeError("replica killed (sweep fault injection)")
        f = self.engine.submit(op, row, k=k, seed=seed)
        with self._lock:
            self._live.append(f)
            self.submitted += 1
        return f

    def kill(self) -> None:
        with self._lock:
            self.killed = True
            live, self._live = self._live, []
        for f in live:
            if not f.done():
                with contextlib.suppress(Exception):  # completed meanwhile
                    f.set_exception(RuntimeError(
                        "replica killed (sweep fault injection)"))

    def start(self):
        self.engine.start()

    def stop(self) -> None:
        self.engine.stop()

    def warmup(self, ops=()):
        return self.engine.warmup(ops=tuple(ops))


def burst(port: int, x: np.ndarray, sizes: Sequence[int],
          victim: Optional[KillableReplica], recorder) -> List[dict]:
    """One ragged burst through a real socket, `victim` killed after the
    middle request; the responses in submit order."""
    from iwae_replication_project_tpu_torch.serving.frontend import (
        TierClient)

    with TierClient("127.0.0.1", port, trace=True, recorder=recorder,
                    timeout_s=300.0) as cli:
        ids, off = [], 0
        for i, n in enumerate(sizes):
            ids.append(cli.submit("score", x[off:off + n].tolist()))
            off += n
            if i == len(sizes) // 2 and victim is not None:
                deadline = time.monotonic() + 30.0
                while victim.submitted == 0:
                    if time.monotonic() > deadline:
                        raise RuntimeError("the victim replica never "
                                           "received work")
                    time.sleep(0.002)
                victim.kill()
        responses = cli.drain(ids)
    return [responses[rid] for rid in ids]


def patchables(modules: Sequence) -> list:
    """``(module, name, value)`` of every global the instrumentation can
    swap; after an uninstall the list must be the same objects."""
    return [(m, name, v) for m in modules for name, v in vars(m).items()
            if v is _real_threading or v is _real_queue or v is _RealFuture]


def uninstall_problems(modules: Sequence, classes: Sequence,
                       before: list) -> List[str]:
    """What an uninstall left behind (empty: contract 4 holds)."""
    from iwae_replication_project_tpu_torch.serving import batcher

    out = []
    if patchables(modules) != before:
        out.append("patched module globals left behind")
    if batcher.Request.__dataclass_fields__["future"].default_factory \
            is not _RealFuture:
        out.append("a traced default_factory left on Request.future")
    for cell in batcher.Request.__init__.__closure__ or ():
        v = cell.cell_contents
        if isinstance(v, type) and issubclass(v, _RealFuture) and \
                v is not _RealFuture:
            out.append("a traced factory left in Request.__init__'s closure")
    for cls in classes:
        for hook in ("__setattr__", "__getattribute__"):
            fn = vars(cls).get(hook)
            if fn is not None and "_patch_class" in getattr(
                    fn, "__qualname__", ""):
                out.append(f"the {hook} hook left on {cls.__name__}")
    return out


@contextlib.contextmanager
def round_store():
    """A fresh default executable store for one round, made now (so under
    an installed instrumentation its lock is a traced one), with the
    process's store restored on exit."""
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc

    saved = cc._store
    cc._store = cc.ExecutableStore(saved.budget_bytes)
    try:
        yield cc._store
    finally:
        cc._store = saved


@dataclasses.dataclass
class Round:
    """One round's outcome."""

    seed: Optional[int]
    rows: np.ndarray
    report: Optional[dict]
    leaks: Dict[str, int]
    #: score dispatches of the two engines during the burst
    dispatches: int
    seconds: float


def run_round(engine_factory: Callable[[], object], x: np.ndarray,
              seed: Optional[int], sizes: Sequence[int] = SIZES,
              on_served: Optional[Callable[[], None]] = None) -> Round:
    """One tier burst (2 replicas, the first killed mid-burst), under the
    instrumentation with a :class:`PerturbFuzzer` of `seed` (None: no
    instrumentation). `on_served` runs after the warmup and again after
    the tier stopped (the caller's launch-count snapshots)."""
    from iwae_replication_project_tpu_torch.serving.frontend import (
        ServingTier)
    from iwae_replication_project_tpu_torch.telemetry.tracing import (
        FlightRecorder)

    t0 = time.perf_counter()
    rec = FlightRecorder(capacity=64, sample_every=1)
    ins = None
    if seed is not None:
        ins = Instrumentation(RaceDetector(stack_depth=4),
                              PerturbFuzzer(seed, rate=0.25,
                                            max_sleep_s=0.002))
        ins.install(modules=serving_modules(), classes=tracked_classes())
    try:
        with round_store() as store:
            victim = KillableReplica(engine_factory())
            peer = engine_factory()
            tier = ServingTier([victim, peer], port=0,
                               monitor_interval_s=0.05, recorder=rec)
            tier.warmup(ops=("score",))
            if on_served is not None:
                on_served()
            tier.start()
            try:
                responses = burst(tier.port, x, sizes, victim, rec)
            finally:
                tier.stop(timeout_s=60)
            if on_served is not None:
                on_served()
            outstanding = tier.router.outstanding
            pinned = sum(1 for e in store.entries() if e["pinned"])
    finally:
        if ins is not None:
            ins.uninstall()
    bad = [r for r in responses if not r["ok"]]
    if bad:
        raise RuntimeError(f"seed {seed}: requests failed despite a healthy "
                           f"peer: {bad[:2]}")
    rows = np.concatenate([np.asarray(r["result"], np.float32)
                           for r in responses])
    # spans finalize as futures complete; give stragglers a moment
    deadline = time.monotonic() + 10.0
    while rec.stats()["open"] and time.monotonic() < deadline:
        time.sleep(0.01)
    leaks = {"open_spans": rec.stats()["open"], "pinned_entries": pinned,
             "outstanding_futures": outstanding}
    dispatches = sum(int(e.metrics.counters()["dispatches"])
                     for e in (victim.engine, peer))
    return Round(seed=seed, rows=rows,
                 report=ins.det.report() if ins is not None else None,
                 leaks=leaks, dispatches=dispatches,
                 seconds=time.perf_counter() - t0)


def round_problems(r: Round, ref: np.ndarray) -> List[str]:
    """Contracts 1-3 of one round (empty: the round holds them)."""
    out = []
    if r.rows.shape != ref.shape or not np.array_equal(r.rows, ref):
        out.append(f"seed {r.seed}: rows differ from the direct engine's")
    if r.report is not None and r.report["total"]:
        out.append(f"seed {r.seed} reproduces {r.report['total']} race(s): "
                   f"{r.report['races'][:2]}")
    if any(r.leaks.values()):
        out.append(f"seed {r.seed}: leak after the drain: {r.leaks}")
    return out


def direct_rows(engine_factory: Callable[[], object],
                x: np.ndarray) -> np.ndarray:
    """The parity reference: one uninstrumented engine scoring `x` (row i
    with seed i, as the tier's router numbers a burst's rows)."""
    eng = engine_factory()
    try:
        eng.warmup(ops=("score",))
        return np.asarray(eng.score(x), np.float32)
    finally:
        eng.stop()
