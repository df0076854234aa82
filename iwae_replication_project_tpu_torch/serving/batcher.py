"""Dynamic micro-batcher: queue, coalesce, expire — no device code here.

A framework-free copy of the JAX package's ``serving/batcher.py`` (the port
imports nothing from that package).

Pure data-structure layer so every policy decision is unit-testable with an
injected fake clock: the engine owns the threads and
the device dispatch, this module owns WHEN a batch forms
(:class:`MicroBatcher`) and HOW MANY dispatched batches may be outstanding
at once (:class:`InflightWindow` — the bounded hand-off between the
dispatcher and completion stages of the pipelined engine).

Policy (per coalescing group — requests only batch with same-program peers,
i.e. identical ``(op, k)``):

* flush when a group reaches ``max_batch`` requests (full-batch flush), or
* when the group's oldest request has waited ``max_wait_us`` (latency bound:
  a lone request is dispatched after at most max_wait_us even at zero load);
* a request whose deadline passes while queued is completed with a
  :class:`RequestTimeout` error — never dispatched, never a crash;
* ``submit`` on a full queue raises :class:`EngineOverloaded` — bounded
  memory and an explicit shed signal instead of an OOM/latency collapse;
* the dispatcher stalls (stops coalescing new dispatches) once
  ``max_inflight`` batches are outstanding — backpressure that flows into
  the queue bound above, so overload turns into shed, not unbounded
  device/host memory.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Callable, Deque, List, Optional, Tuple

import numpy as np


class EngineOverloaded(RuntimeError):
    """The bounded request queue is full; the caller must back off/retry."""


class RequestTimeout(RuntimeError):
    """The request's deadline passed while it waited in the queue."""


def complete_future(fut: Future, result=None, exc=None) -> bool:
    """Complete a future, tolerating caller-side cancellation and duplicate
    completions: a client that cancelled its pending Future — or a reroute
    that already delivered it — must not be able to kill the completing
    thread with InvalidStateError (dispatcher, completion, router-callback,
    and remote-reader threads all outlive any one request by contract).
    Returns whether this call delivered the result."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        return True
    except Exception:   # cancelled (or already completed): drop quietly
        return False


@dataclasses.dataclass
class Request:
    """One row of work: a single example plus its program selector.

    `seed` versions the request's private RNG stream inside the batched
    program (serving/programs.py seeds the row's generator from it and the
    engine's seed), so a
    request's result is a pure function of (weights, payload, seed) — not of
    whichever batch it happened to be coalesced into.
    """

    op: str
    payload: np.ndarray            # [d] one row, engine-validated
    k: int
    seed: int
    t_enqueue: float
    deadline: Optional[float]      # absolute clock time; None = no timeout
    future: Future = dataclasses.field(default_factory=Future)
    #: stamped by the engine when the batch carrying this request is enqueued
    #: on the device — splits observed latency into queue-wait
    #: (t_dispatch - t_enqueue) and device-wait (completion - t_dispatch)
    t_dispatch: Optional[float] = None
    #: optional trace context the engine's pipeline-stage spans attach
    #: under at completion (None = untraced)
    trace: Optional[Any] = None
    #: adaptive accuracy target (``score_adaptive`` only; 0.0 = criterion
    #: disabled). For adaptive requests ``k`` above holds ``k_cap``. These
    #: join the coalescing group: every request in one dispatch shares ONE
    #: set of target scalars (they ride the program as dynamic replicated
    #: inputs), so only exact-target peers may batch together.
    target_se: float = 0.0
    ess_floor: float = 0.0

    @property
    def group(self) -> Tuple:
        """The coalescing key: only same-program, same-dynamic-scalar peers
        may share a dispatch. Non-adaptive requests keep the historical
        ``(op, k)`` key; adaptive requests extend it with their exact
        target pair."""
        if self.target_se == 0.0 and self.ess_floor == 0.0:
            return (self.op, self.k)
        return (self.op, self.k, self.target_se, self.ess_floor)


class MicroBatcher:
    """Bounded multi-group FIFO with max-batch / max-wait flush policy.

    Not thread-safe by itself — the engine serializes access under its own
    lock. `clock` is injectable (tests drive a fake monotonic clock).
    """

    def __init__(self, *, max_batch: int, max_wait_us: float,
                 queue_limit: int,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_us) / 1e6
        self.queue_limit = int(queue_limit)
        self.clock = clock
        self._groups: "OrderedDict[Tuple[str, int], Deque[Request]]" = \
            OrderedDict()
        self._pending = 0

    @property
    def pending(self) -> int:
        return self._pending

    def submit(self, req: Request) -> None:
        if self._pending >= self.queue_limit:
            raise EngineOverloaded(
                f"request queue full ({self.queue_limit} pending); "
                f"shedding — retry with backoff")
        self._groups.setdefault(req.group, deque()).append(req)
        self._pending += 1

    def poll(self, now: Optional[float] = None, force: bool = False
             ) -> Tuple[List[Request], List[List[Request]]]:
        """``(expired, batches)`` ready at time `now`.

        `expired` are requests whose deadline passed while queued (the caller
        completes them with :class:`RequestTimeout`); each inner list of
        `batches` is one coalesced dispatch of <= max_batch same-group
        requests. `force=True` flushes every non-empty group regardless of
        the wait policy (inline/blocking mode and engine shutdown).

        Expiry pops from each group's HEAD only: deadlines are assumed
        FIFO-monotone per group (the engine derives them as
        ``enqueue_time + timeout_s`` under a monotonic clock, so they are).
        A caller minting out-of-order deadlines degrades gracefully — a
        mid-queue short-deadline request is served late instead of expired —
        and in exchange poll() touches O(flushed + expired) requests, not
        O(pending), per wakeup.
        """
        now = self.clock() if now is None else now
        expired: List[Request] = []
        batches: List[List[Request]] = []
        for group in list(self._groups):
            q = self._groups[group]
            while q and q[0].deadline is not None and now >= q[0].deadline:
                expired.append(q.popleft())
                self._pending -= 1
            while len(q) >= self.max_batch:
                batches.append([q.popleft() for _ in range(self.max_batch)])
                self._pending -= self.max_batch
            if q and (force or now - q[0].t_enqueue >= self.max_wait_s):
                batch = list(q)
                q.clear()
                self._pending -= len(batch)
                batches.append(batch)
            if not q:
                del self._groups[group]
        return expired, batches

    def next_event(self, now: Optional[float] = None) -> Optional[float]:
        """Earliest future clock time at which :meth:`poll` could produce
        something new (a wait-flush or an expiry), or None when idle. The
        dispatcher thread sleeps until this instead of busy-polling. Only
        each group's head matters: FIFO order makes both the wait-flush
        trigger and (per the monotone-deadline contract above) the earliest
        expiry a property of ``q[0]``."""
        now = self.clock() if now is None else now
        t: Optional[float] = None
        for q in self._groups.values():
            if not q:
                continue
            cand = q[0].t_enqueue + self.max_wait_s
            if q[0].deadline is not None:
                cand = min(cand, q[0].deadline)
            t = cand if t is None else min(t, cand)
        return t


class InflightWindow:
    """Bounded FIFO hand-off between the dispatcher and completion stages.

    The dispatcher :meth:`acquire`s a slot BEFORE enqueueing a batch on the
    device, :meth:`commit`s the in-flight handle after (or :meth:`release`s
    the slot when the enqueue failed); the completion thread :meth:`pop`s
    handles in dispatch order, fetches and completes, then calls
    :meth:`done`. A slot is held from acquire until done, so at most
    ``limit`` batches ever sit between device enqueue and future
    completion: the backpressure bound that keeps device/host memory flat
    under overload (the stalled dispatcher stops draining the request
    queue, which then sheds at ``queue_limit``).

    Pure synchronization — no device code, no clock — so pipeline mechanics
    (saturation, drain, FIFO hand-off) are unit-testable without real device
    timing.
    """

    def __init__(self, limit: int,
                 on_change: Optional[Callable[[int], None]] = None):
        if limit < 1:
            raise ValueError(f"limit must be >= 1, got {limit}")
        self.limit = int(limit)
        self._cv = threading.Condition()
        self._q: Deque[Any] = deque()
        self._open = 0   # acquired and not yet done()
        # observer for the slot count (the engine's inflight gauge), invoked
        # UNDER the window lock so two threads' updates can never land out
        # of order (a stale write would misreport device occupancy)
        self._on_change = on_change

    def _changed(self) -> None:
        if self._on_change is not None:
            self._on_change(self._open)

    @property
    def inflight(self) -> int:
        """Batches currently holding a slot (acquired, not yet done)."""
        with self._cv:
            return self._open

    def acquire(self, abort: Optional[Callable[[], bool]] = None,
                poll_s: float = 0.05) -> bool:
        """Block until a slot frees, then take it. `abort` (polled) breaks
        the wait — the slot is STILL taken (transiently exceeding the
        limit) so a shutting-down dispatcher can never lose a batch it
        already popped from the request queue. Returns False iff the
        acquire was forced past the limit by `abort`."""
        with self._cv:
            while self._open >= self.limit:
                if abort is not None and abort():
                    self._open += 1
                    self._changed()
                    return False
                self._cv.wait(timeout=poll_s if abort is not None else None)
            self._open += 1
            self._changed()
            return True

    def commit(self, item: Any) -> None:
        """Hand an enqueued batch (under a held slot) to the completion
        stage."""
        with self._cv:
            self._q.append(item)
            self._cv.notify_all()

    def release(self) -> None:
        """Give back a held slot without committing (the enqueue failed —
        its futures were error-completed by the dispatcher)."""
        with self._cv:
            self._open -= 1
            self._changed()
            self._cv.notify_all()

    def pop(self, stop: Optional[Callable[[], bool]] = None,
            poll_s: float = 0.05) -> Optional[Any]:
        """Next batch in dispatch order; blocks while empty. Returns None
        once `stop` (polled) is true AND the window is empty — the
        completion thread's drain-then-exit contract. (An acquired-but-not-
        yet-committed batch is safe: its committer is the dispatcher, which
        is joined before the completion stage is stopped.)"""
        with self._cv:
            while not self._q:
                if stop is not None and stop():
                    return None
                self._cv.wait(timeout=poll_s if stop is not None else None)
            return self._q.popleft()

    def done(self) -> None:
        """Release the slot of a popped batch (after its futures completed)."""
        with self._cv:
            self._open -= 1
            self._changed()
            self._cv.notify_all()

    def wake(self) -> None:
        """Nudge blocked acquire/pop callers to re-check their abort/stop
        predicates now (shutdown fast path)."""
        with self._cv:
            self._cv.notify_all()
