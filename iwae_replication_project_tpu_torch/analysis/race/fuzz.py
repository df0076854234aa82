"""Deterministic schedule fuzzing.

Two modes, one contract — the schedule is a pure function of the seed:

* :class:`CooperativeScheduler` (fixtures): a single-baton scheduler.
  Exactly one thread runs at any moment; every instrumented sync op is a
  yield point where the seeded RNG picks the next runnable thread from the
  deterministically-ordered candidate set (thread ids are registration
  ordinals, registration order is itself scheduled). Blocking traced ops
  never really block while holding the baton — they deschedule with a
  wake predicate instead. Because only the baton holder consumes the RNG,
  the whole interleaving — and therefore the detector's report — is
  byte-identical across same-seed runs: **every race report is a repro**.

* :class:`PerturbFuzzer` (the real socket-threaded serving stack): the
  ``utils/faults.py`` seeded-schedule idiom. Each thread draws from its
  own stream (``Random(seed * 1_000_003 + tid)``) and injects short
  sleeps at sync ops per that stream's decisions. The *decision schedule*
  is deterministic per thread; the achieved interleaving is best-effort
  (threads blocked in uninstrumented ops — ``socket.accept`` — cannot be
  descheduled cooperatively), which is exactly the honest contract for
  fuzzing a stack that talks to real sockets.

A cooperative run where every thread is descheduled with no satisfiable
wake predicate raises :class:`SchedulerDeadlock` — a deadlock is a
verdict, not a hang.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional

__all__ = ["CooperativeScheduler", "PerturbFuzzer", "SchedulerDeadlock"]


class SchedulerDeadlock(RuntimeError):
    """Every scheduled thread is descheduled and no wake predicate holds."""


class PerturbFuzzer:
    """Seeded per-thread sleep injection at instrumented sync ops."""

    cooperative = False

    def __init__(self, seed: int, rate: float = 0.25,
                 max_sleep_s: float = 0.002):
        self.seed = int(seed)
        self.rate = float(rate)
        self.max_sleep_s = float(max_sleep_s)
        self._mu = threading.Lock()
        self._streams: Dict[int, random.Random] = {}
        self.det = None
        self.ops = 0

    def bind(self, det) -> None:
        self.det = det
        det.seed = self.seed

    def on_op(self, kind: str) -> None:
        tid = self.det.current_tid()
        with self._mu:
            rng = self._streams.get(tid)
            if rng is None:
                rng = random.Random(self.seed * 1_000_003 + tid)
                self._streams[tid] = rng
            self.ops += 1
            fire = rng.random() < self.rate
            dur = rng.random() * self.max_sleep_s
        if fire:
            time.sleep(dur)


class CooperativeScheduler:
    """Single-baton deterministic scheduler over traced threads."""

    cooperative = True

    #: wall-clock bound on "nobody can run" before declaring deadlock; the
    #: only asynchronous wake this grace period exists for is a detached
    #: thread's interpreter bootstrap flipping ``is_alive`` to False
    DEADLOCK_GRACE_S = 5.0

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.rng = random.Random(self.seed)
        self._cv = threading.Condition(threading.Lock())
        self._state: Dict[int, str] = {}         # tid -> runnable|done
        self._preds: Dict[int, Optional[Callable[[], bool]]] = {}
        self._registered: set = set()            # thread objects seen
        self._current: Optional[int] = None
        self.det = None

    def bind(self, det) -> None:
        self.det = det
        det.seed = self.seed

    # -- lifecycle ----------------------------------------------------------

    def run(self, fn: Callable[[], object]):
        """Run `fn` (the fixture driver) as the scheduled root thread."""
        tid = self.det.register_thread("driver")
        with self._cv:
            self._state[tid] = "runnable"
            self._preds[tid] = None
            self._current = tid
        try:
            return fn()
        finally:
            with self._cv:
                self._state[tid] = "done"
                self._preds.pop(tid, None)
                if self._current == tid:
                    self._pick_locked()

    def register_child(self, thread, tid: int) -> None:
        """Called by a traced thread's run() before any user code: join the
        schedule, then wait for the baton."""
        with self._cv:
            self._state[tid] = "runnable"
            self._preds[tid] = None
            self._registered.add(id(thread))
            self._cv.notify_all()
            self._await_baton_locked(tid)

    def wait_child_registered(self, thread) -> None:
        """The parent (baton holder) blocks in start() until the child has
        joined the schedule — child registration order is thereby the
        deterministic program order of start() calls."""
        with self._cv:
            self._cv.wait_for(lambda: id(thread) in self._registered,
                              timeout=self.DEADLOCK_GRACE_S)

    def detach(self, tid: int) -> None:
        with self._cv:
            self._state[tid] = "done"
            self._preds.pop(tid, None)
            if self._current == tid:
                self._pick_locked()

    # -- yield points -------------------------------------------------------

    def on_op(self, kind: str) -> None:
        me = self.det.current_tid()
        with self._cv:
            if self._state.get(me) != "runnable":
                return              # unscheduled thread (e.g. pytest main)
            if self._current != me:
                # an unscheduled wake (timed waits in perturbed libraries);
                # fall into the normal baton wait
                self._await_baton_locked(me)
                return
            self._pick_locked()
            self._await_baton_locked(me)

    def block_until(self, pred: Callable[[], bool]) -> None:
        """Deschedule the caller until `pred` holds AND the seeded choice
        hands it the baton again. `pred` must be side-effect free and must
        touch raw (untraced) state only."""
        me = self.det.current_tid()
        with self._cv:
            if self._state.get(me) != "runnable":
                # unscheduled thread: poll outside the scheduler
                pass
            else:
                self._preds[me] = pred
                if self._current == me:
                    self._pick_locked()
                self._await_baton_locked(me)
                return
        deadline = time.monotonic() + self.DEADLOCK_GRACE_S
        while not pred():
            if time.monotonic() > deadline:
                raise SchedulerDeadlock(
                    "unscheduled thread's wake predicate never held")
            time.sleep(0.001)

    # -- internals (self._cv held) ------------------------------------------

    def _runnable_locked(self):
        out = []
        for tid in sorted(self._state):
            if self._state[tid] != "runnable":
                continue
            pred = self._preds.get(tid)
            if pred is None or pred():
                out.append(tid)
        return out

    def _pick_locked(self) -> None:
        cands = self._runnable_locked()
        if cands:
            self._current = self.rng.choice(cands)
        else:
            self._current = None        # probed again by waiting threads
        self._cv.notify_all()

    def _await_baton_locked(self, me: int) -> None:
        stalled_since = None
        while True:
            if self._current == me:
                self._preds[me] = None
                return
            granted = self._cv.wait(timeout=0.05)
            if self._current == me:
                self._preds[me] = None
                return
            if self._current is None:
                # nobody holds the baton: re-evaluate predicates (an
                # asynchronous flip — a detached thread finishing — is the
                # only way forward now)
                cands = self._runnable_locked()
                if cands:
                    self._current = self.rng.choice(cands)
                    self._cv.notify_all()
                    stalled_since = None
                    continue
                now = time.monotonic()
                if stalled_since is None:
                    stalled_since = now
                elif now - stalled_since > self.DEADLOCK_GRACE_S:
                    self._state[me] = "done"
                    raise SchedulerDeadlock(
                        f"all scheduled threads are descheduled and no "
                        f"wake predicate holds (seed {self.seed}) — the "
                        f"schedule found a deadlock")
            elif granted is False:
                stalled_since = None
