"""Detector core: vector clocks, locksets, and the race report.

The algorithm is the classic hybrid (Eraser's lockset refined by
happens-before, the shape TSan and FastTrack settled on):

* every thread carries a **vector clock**; the synchronization operations
  that *transfer* work between threads are HB edges — ``Thread.start``
  (parent -> child), ``Thread.join`` (child -> joiner), future
  ``set_result/set_exception`` -> ``result/exception/done-callback`` plus
  ``add_done_callback`` registration -> callback invocation,
  ``Queue.put`` -> the ``get`` that receives that item (FIFO pairing),
  ``Event.set`` -> a successful ``wait``/``is_set``, and lock ``release``
  -> a later ``acquire`` of the same lock (each lock carries a sync
  clock, TSan's happens-before mode). The lock edge is what accepts the
  serving stack's ownership-handoff idiom — transfer a request's
  exclusive owner under the router lock, then let the new owner touch it
  lock-free — at the known cost that a publish racing an *earlier*
  same-lock section in a different interleaving is summarized away
  (Eraser's pure-lockset mode would catch it; TSan's hb mode, and this
  one, trade it for not flagging every handoff in callback-driven code);
* every access to a tracked shared attribute records the accessing
  thread's current **lockset** (the traced locks it holds);
* a **data race** is two accesses to the same attribute from different
  threads, at least one a write, with an empty common lockset and no HB
  order between them — reported with both stacks, both locksets, and the
  schedule seed that produced the interleaving (the repro).

Access history is FastTrack-style bounded: per variable, the last
read and the last write per thread. With HB edges joining clocks on every
real handoff, that summary loses no race this codebase's idioms can
produce (the dispatcher->completion pipeline, router reroutes, connection
callback fans).

Everything here is deterministic given a deterministic schedule: thread
ids are registration-order ordinals, object labels are per-class creation
ordinals, and :meth:`RaceDetector.report` sorts — so the cooperative
fuzzer's same-seed runs serialize to byte-identical reports.
"""

from __future__ import annotations

import threading
import traceback
from collections import deque
from typing import Deque, Dict, FrozenSet, List, Optional, Tuple

__all__ = ["VectorClock", "Access", "RaceReport", "RaceDetector"]

#: frames from these path fragments are noise in an access stack (the
#: instrumentation layer itself, the interpreter's threading bootstrap)
_STACK_SKIP = ("analysis/race/", "lib/python", "importlib")


class VectorClock:
    """A mapping ``tid -> logical time``; absent entries are 0."""

    __slots__ = ("c",)

    def __init__(self, c: Optional[Dict[int, int]] = None):
        self.c: Dict[int, int] = dict(c) if c else {}

    def tick(self, tid: int) -> None:
        self.c[tid] = self.c.get(tid, 0) + 1

    def join(self, other: "VectorClock") -> None:
        for t, v in other.c.items():
            if v > self.c.get(t, 0):
                self.c[t] = v

    def copy(self) -> "VectorClock":
        return VectorClock(self.c)

    def time_of(self, tid: int) -> int:
        return self.c.get(tid, 0)

    def dominates(self, tid: int, t: int) -> bool:
        """Whether this clock has seen thread ``tid``'s time ``t`` (i.e. an
        event stamped ``(tid, t)`` happens-before the holder's present)."""
        return self.c.get(tid, 0) >= t

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"VC({self.c})"


class Access:
    """One recorded access: who, what kind, under which locks, when, where."""

    __slots__ = ("tid", "write", "lockset", "epoch", "stack")

    def __init__(self, tid: int, write: bool, lockset: FrozenSet[str],
                 epoch: int, stack: Tuple[str, ...]):
        self.tid = tid
        self.write = write
        self.lockset = lockset
        self.epoch = epoch          # accessing thread's own clock component
        self.stack = stack

    def describe(self) -> dict:
        return {
            "thread": self.tid,
            "op": "write" if self.write else "read",
            "lockset": sorted(self.lockset),
            "stack": list(self.stack),
        }


class RaceReport:
    """One detected race: a variable plus the two unordered accesses."""

    def __init__(self, var: str, prior: Access, current: Access,
                 thread_names: Dict[int, str]):
        self.var = var
        self.prior = prior
        self.current = current
        self.thread_names = thread_names

    def key(self) -> Tuple:
        """Dedup key: the same pair of program points races once per run."""
        return (self.var, self.prior.write, self.current.write,
                self.prior.stack, self.current.stack)

    def to_dict(self) -> dict:
        def side(a: Access) -> dict:
            d = a.describe()
            d["thread_name"] = self.thread_names.get(a.tid, f"t{a.tid}")
            return d
        return {"var": self.var, "first": side(self.prior),
                "second": side(self.current)}

    def human(self) -> str:
        a, b = self.prior, self.current
        lines = [f"RACE on {self.var}:"]
        for tag, acc in (("first", a), ("second", b)):
            name = self.thread_names.get(acc.tid, f"t{acc.tid}")
            held = ", ".join(sorted(acc.lockset)) or "no locks"
            lines.append(f"  {tag}: {'write' if acc.write else 'read'} by "
                         f"thread {acc.tid} ({name}) holding {held}")
            for frame in acc.stack:
                lines.append(f"    {frame}")
        return "\n".join(lines)


class _VarState:
    """Bounded access history for one variable (per-thread last read/write)."""

    __slots__ = ("reads", "writes")

    def __init__(self):
        self.reads: Dict[int, Access] = {}
        self.writes: Dict[int, Access] = {}


class RaceDetector:
    """The event sink every traced primitive and tracked attribute reports to.

    Thread-safe (one internal real lock — the detector is never itself
    traced). All ids handed out are deterministic under a deterministic
    schedule: thread ids and object labels are allocation ordinals.
    """

    def __init__(self, capture_stacks: bool = True, stack_depth: int = 5):
        self._mu = threading.Lock()
        self.capture_stacks = capture_stacks
        self.stack_depth = stack_depth
        # threads
        self._tids: Dict[int, int] = {}          # ident -> tid
        self._names: Dict[int, str] = {}         # tid -> name
        self._clocks: Dict[int, VectorClock] = {}
        self._final: Dict[int, VectorClock] = {}  # exited threads' clocks
        # sync objects
        self._locksets: Dict[int, List[str]] = {}  # tid -> held lock names
        self._lock_clocks: Dict[str, VectorClock] = {}
        self._future_clocks: Dict[int, VectorClock] = {}
        self._queue_clocks: Dict[int, Deque[VectorClock]] = {}
        self._event_clocks: Dict[int, VectorClock] = {}
        # shared state
        self._vars: Dict[str, _VarState] = {}
        self._races: Dict[Tuple, RaceReport] = {}
        self._label_counts: Dict[str, int] = {}
        self.seed: Optional[int] = None          # stamped by the fuzzer

    # -- threads ------------------------------------------------------------

    def register_thread(self, name: Optional[str] = None) -> int:
        """Register the calling OS thread; idempotent. Returns its tid."""
        ident = threading.get_ident()
        with self._mu:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._names)
                self._tids[ident] = tid
                self._names[tid] = name or threading.current_thread().name
                vc = VectorClock()
                vc.tick(tid)
                self._clocks[tid] = vc
            return tid

    def current_tid(self) -> int:
        return self.register_thread()

    def thread_started(self, parent_tid: int, child_tid: int) -> None:
        """HB edge parent -> child: everything the parent did before
        ``start()`` happens-before everything the child does."""
        with self._mu:
            self._clocks[child_tid].join(self._clocks[parent_tid])
            self._clocks[parent_tid].tick(parent_tid)
            self._clocks[child_tid].tick(child_tid)

    def thread_exited(self, tid: int) -> None:
        ident = threading.get_ident()
        with self._mu:
            self._final[tid] = self._clocks[tid].copy()
            self._locksets.pop(tid, None)
            # the OS recycles idents: a thread created after this one fully
            # exits can receive the same ident, and must get a FRESH tid —
            # aliasing two threads into one tid hides every race between
            # them (and whether recycling happens is OS timing, so leaving
            # the mapping would also break same-seed determinism)
            if self._tids.get(ident) == tid:
                del self._tids[ident]

    def thread_joined(self, child_tid: int) -> None:
        """HB edge child -> joiner: a completed ``join()`` publishes the
        child's whole history to the joining thread."""
        me = self.current_tid()
        with self._mu:
            src = self._final.get(child_tid) or self._clocks.get(child_tid)
            if src is not None:
                self._clocks[me].join(src)
            self._clocks[me].tick(me)

    # -- locks (locksets + release->acquire sync clocks) ---------------------

    def lock_acquired(self, lock_name: str) -> None:
        tid = self.current_tid()
        with self._mu:
            self._locksets.setdefault(tid, []).append(lock_name)
            # acquire side of the release->acquire HB edge: join everything
            # published by prior critical sections on this lock
            clk = self._lock_clocks.get(lock_name)
            if clk is not None:
                self._clocks[tid].join(clk)

    def lock_released(self, lock_name: str) -> None:
        tid = self.current_tid()
        with self._mu:
            held = self._locksets.get(tid, [])
            if lock_name in held:
                # remove the innermost matching hold (RLock reentrancy)
                for i in range(len(held) - 1, -1, -1):
                    if held[i] == lock_name:
                        del held[i]
                        break
            # release side: publish this thread's history to the lock
            clk = self._lock_clocks.setdefault(lock_name, VectorClock())
            clk.join(self._clocks[tid])
            self._clocks[tid].tick(tid)

    def held_locks(self) -> FrozenSet[str]:
        tid = self.current_tid()
        with self._mu:
            return frozenset(self._locksets.get(tid, ()))

    # -- futures / queues / events (HB edges) --------------------------------

    def future_completed(self, fid: int) -> None:
        tid = self.current_tid()
        with self._mu:
            clk = self._future_clocks.setdefault(fid, VectorClock())
            clk.join(self._clocks[tid])
            self._clocks[tid].tick(tid)

    def future_observed(self, fid: int) -> None:
        tid = self.current_tid()
        with self._mu:
            clk = self._future_clocks.get(fid)
            if clk is not None:
                self._clocks[tid].join(clk)

    def future_registered(self, fid: int) -> None:
        """HB edge registrant -> callback: ``add_done_callback`` publishes
        the registering thread's history to the callback invocation (CPython
        runs the callback in the completing thread strictly after the
        registration, or synchronously in the registrant itself). Without
        this edge every object handed to a done-callback via its closure
        looks unordered with the thread that built it."""
        self.future_completed(fid)

    def queue_put(self, qid: int) -> None:
        tid = self.current_tid()
        with self._mu:
            q = self._queue_clocks.setdefault(qid, deque())
            q.append(self._clocks[tid].copy())
            self._clocks[tid].tick(tid)

    def queue_got(self, qid: int) -> None:
        tid = self.current_tid()
        with self._mu:
            q = self._queue_clocks.get(qid)
            if q:
                self._clocks[tid].join(q.popleft())

    def event_set(self, eid: int) -> None:
        tid = self.current_tid()
        with self._mu:
            clk = self._event_clocks.setdefault(eid, VectorClock())
            clk.join(self._clocks[tid])
            self._clocks[tid].tick(tid)

    def event_observed(self, eid: int) -> None:
        tid = self.current_tid()
        with self._mu:
            clk = self._event_clocks.get(eid)
            if clk is not None:
                self._clocks[tid].join(clk)

    # -- shared-state accesses ----------------------------------------------

    def label_object(self, cls_name: str) -> str:
        """Deterministic object label: per-class creation ordinal."""
        with self._mu:
            n = self._label_counts.get(cls_name, 0)
            self._label_counts[cls_name] = n + 1
            return f"{cls_name}#{n}"

    def _stack(self) -> Tuple[str, ...]:
        if not self.capture_stacks:
            return ()
        frames = traceback.extract_stack()
        out: List[str] = []
        for fr in frames:
            fn = fr.filename.replace("\\", "/")
            if any(s in fn for s in _STACK_SKIP):
                continue
            short = "/".join(fn.rsplit("/", 2)[-2:])
            out.append(f"{short}:{fr.lineno} in {fr.name}")
        return tuple(out[-self.stack_depth:])

    def access(self, var: str, write: bool) -> None:
        """Record a read/write of ``var`` by the calling thread and check it
        against the bounded history for lockset+HB races."""
        tid = self.current_tid()
        stack = self._stack()
        with self._mu:
            my_clock = self._clocks[tid]
            lockset = frozenset(self._locksets.get(tid, ()))
            acc = Access(tid, write, lockset, my_clock.time_of(tid), stack)
            st = self._vars.setdefault(var, _VarState())
            # a write races prior reads and writes; a read races prior writes
            prior_pools = (st.writes,) if not write else (st.writes, st.reads)
            for pool in prior_pools:
                for other_tid, prior in pool.items():
                    if other_tid == tid:
                        continue
                    if my_clock.dominates(other_tid, prior.epoch):
                        continue                    # HB-ordered
                    if prior.lockset & lockset:
                        continue                    # common lock
                    report = RaceReport(var, prior, acc, dict(self._names))
                    self._races.setdefault(report.key(), report)
            (st.writes if write else st.reads)[tid] = acc
            my_clock.tick(tid)

    # -- results ------------------------------------------------------------

    @property
    def races(self) -> List[RaceReport]:
        return [self._races[k] for k in sorted(self._races,
                                               key=lambda k: repr(k))]

    def report(self) -> dict:
        """The run's verdict as one deterministic document (sorted; under
        the cooperative scheduler, same seed => byte-identical)."""
        return {
            "seed": self.seed,
            "threads": {str(t): self._names[t] for t in sorted(self._names)},
            "races": [r.to_dict() for r in self.races],
            "total": len(self._races),
        }
