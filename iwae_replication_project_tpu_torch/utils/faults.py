"""Deterministic fault injection and preemption grace (port of
``utils/faults.py``, the part the training driver, the serving engine and
their tests use; the module is framework-free, so this is a copy).

A :class:`FaultSchedule` of (site, trigger, action) rules is installed
process-wide and fired from explicit :func:`fault_point` hooks: the driver
calls one after each dispatch of passes (:data:`SITE_TRAIN_PASS`) and one
after each durable checkpoint save (:data:`SITE_CKPT_SAVE`). Triggers are
visit counts, not probabilities, so the same run under the same schedule
meets the same faults. With no schedule installed a fault point is one
global load and a ``None`` check.

:class:`PreemptionGuard` absorbs SIGTERM/SIGINT into a flag the driver
polls at pass boundaries; the :func:`sigterm` action exists to exercise it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

#: the training driver's fault sites (names as in the JAX package)
SITE_TRAIN_PASS = "train.pass"            # experiment driver, per dispatch
SITE_CKPT_SAVE = "train.checkpoint.save"  # utils/checkpoint.save_checkpoint
#: where a call enters the executable store (utils/compile_cache.py,
#: ``aot_call_async``), after its entry is resolved and before it runs
SITE_AOT_CALL_ASYNC = "aot.call_async"


class FaultInjected(RuntimeError):
    """An injected fault: not one of the typed serving errors, so it is
    routed like any unexpected failure, as a real crash would be."""

    def __init__(self, message: str = "injected fault", site: str = ""):
        super().__init__(message)
        self.site = site


@dataclasses.dataclass
class FaultContext:
    """What an action sees when its rule fires."""

    site: str
    count: int                 # 1-based matched-visit number for the rule
    ctx: Dict[str, Any]        # the fault_point call's keyword arguments
    rng: random.Random         # per-rule deterministic stream (seeded)


Action = Callable[[FaultContext], None]


@dataclasses.dataclass
class FaultRule:
    """One (site, trigger, action) entry: fires on matched visits
    ``after+1 .. after+times`` (``times=None``: every matched visit past
    ``after``); ``match`` narrows by the fault point's keyword arguments."""

    site: str
    action: Action
    after: int = 0
    times: Optional[int] = 1
    match: Optional[Callable[[Dict[str, Any]], bool]] = None
    name: str = ""             # label for the firing log (default: site)


class FaultSchedule:
    """A seeded set of fault rules plus their firing state. Each firing is
    logged immediately before its action runs; an action that raises
    propagates out of the fault point, and later due rules of that visit
    are neither logged nor spent."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._counts = [0] * len(self.rules)
        self._fired = [0] * len(self.rules)
        self._rngs = [random.Random(self.seed * 1_000_003 + i)
                      for i in range(len(self.rules))]
        #: firing audit trail: (rule name, site, matched-visit count)
        self.log: List[Tuple[str, str, int]] = []

    def fire(self, site: str, **ctx) -> None:
        due = []
        with self._lock:
            for i, r in enumerate(self.rules):
                if r.site != site or (r.match is not None
                                      and not r.match(ctx)):
                    continue
                self._counts[i] += 1
                if self._counts[i] <= r.after:
                    continue
                if r.times is not None and self._fired[i] >= r.times:
                    continue
                due.append((i, r, FaultContext(site, self._counts[i], ctx,
                                               self._rngs[i])))
        for i, r, fc in due:
            with self._lock:
                if r.times is not None and self._fired[i] >= r.times:
                    continue
                self._fired[i] += 1
                self.log.append((r.name or r.site, fc.site, fc.count))
            r.action(fc)


_ACTIVE: Optional[FaultSchedule] = None


def install(schedule: FaultSchedule) -> FaultSchedule:
    """Install `schedule` process-wide (replacing any previous one)."""
    global _ACTIVE
    _ACTIVE = schedule
    return schedule


def clear() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def installed(schedule: FaultSchedule):
    """``with installed(FaultSchedule([...])) as s:`` -- scoped install."""
    install(schedule)
    try:
        yield schedule
    finally:
        clear()


def fault_point(site: str, **ctx) -> None:
    """The hook instrumented code calls; a raising action propagates from
    here, like an organic failure at that point."""
    sched = _ACTIVE
    if sched is not None:
        sched.fire(site, **ctx)


def raise_fault(message: str = "injected fault") -> Action:
    """Raise :class:`FaultInjected`."""
    def act(fc: FaultContext) -> None:
        raise FaultInjected(f"{message} [site={fc.site} visit={fc.count}]",
                            site=fc.site)
    return act


def raise_error(make: Callable[[FaultContext], BaseException]) -> Action:
    """Raise the exception `make` builds from the firing context: a typed
    failure (an ``OSError`` at a socket send)."""
    def act(fc: FaultContext) -> None:
        raise make(fc)
    return act


def delay(seconds: float, jitter_s: float = 0.0) -> Action:
    """Sleep on the calling thread (plus seeded jitter): the slow-replica
    fault."""
    def act(fc: FaultContext) -> None:
        time.sleep(seconds + (fc.rng.uniform(0.0, jitter_s)
                              if jitter_s > 0 else 0.0))
    return act


def sigterm(signum: int = signal.SIGTERM) -> Action:
    """Deliver a signal to this process (synchronously when fired on the
    main thread): the preemption :class:`PreemptionGuard` absorbs."""
    def act(fc: FaultContext) -> None:
        signal.raise_signal(signum)
    return act


class PreemptionGuard:
    """Absorb SIGTERM/SIGINT into a checked flag: the driver polls
    :attr:`requested` at pass boundaries, force-saves a mid-stage checkpoint
    and exits with its distinct code, so a preempted run loses at most one
    dispatch of passes.

    Context manager; handlers are installed on ``__enter__`` and the
    previous ones restored on ``__exit__``. Off the main thread the guard is
    inert (``requested`` stays False), since only the main thread may
    install signal handlers. A second signal during the grace window
    restores the previous handler and re-raises it.
    """

    def __init__(self, signums: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self._signums = signums
        self._old: Dict[int, Any] = {}
        self._evt = threading.Event()
        self.signum: Optional[int] = None

    @property
    def requested(self) -> bool:
        return self._evt.is_set()

    def _handle(self, signum, frame) -> None:
        if self._evt.is_set():
            self._restore()
            signal.raise_signal(signum)
            return
        self.signum = signum
        self._evt.set()

    def _restore(self) -> None:
        for s, old in self._old.items():
            with contextlib.suppress(ValueError, OSError, TypeError):
                signal.signal(s, old)
        self._old = {}

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in self._signums:
            self._old[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        self._restore()
