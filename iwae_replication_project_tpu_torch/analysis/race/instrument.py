"""The injectable instrumented-sync layer.

:class:`Instrumentation` swaps traced twins of the stdlib concurrency
primitives into the *module attributes* of the serving stack's
``concurrency_paths`` modules — ``mod.threading`` becomes a proxy whose
``Lock/RLock/Condition/Event/Thread`` construct traced objects,
``mod.Future`` becomes a traced Future subclass, ``mod.queue`` a traced
Queue factory. Production code is untouched at the byte level: the swap is
a handful of module-dict entries, and :meth:`Instrumentation.uninstall`
restores the exact original objects, so instrumentation-off is the
byte-identical pre-instrumentation code path (a test pins this).

Attribute-level sharing is traced by patching ``__setattr__`` /
``__getattribute__`` on an explicit list of tracked classes: every
instance-attribute read/write reports to the :class:`RaceDetector` with
the accessing thread's current lockset. Objects get deterministic labels
(per-class creation ordinals), so reports are stable across same-seed
runs.

Every traced operation is also a **fuzz point**: when a fuzzer is bound
(fuzz.py), the op first offers the scheduler a chance to preempt — that
is what makes an interleaving a function of the seed.
"""

from __future__ import annotations

import contextlib
import queue as _real_queue
import threading as _real_threading
from concurrent.futures import Future as _RealFuture
from typing import Dict, Iterable, List, Optional, Tuple

from iwae_replication_project_tpu_torch.analysis.race.model import RaceDetector

__all__ = ["Instrumentation"]


class _TracedLock:
    """threading.Lock twin: lockset bookkeeping + fuzz points, no HB."""

    _KIND = "Lock"

    def __init__(self, ins: "Instrumentation", name: Optional[str] = None):
        self._ins = ins
        self._raw = self._make_raw()
        self.name = name or ins.next_name(self._KIND)

    def _make_raw(self):
        return _real_threading.Lock()

    def _try_acquire(self) -> bool:
        return self._raw.acquire(blocking=False)

    def _free(self) -> bool:
        return not self._raw.locked()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ins = self._ins
        ins.op("lock_acquire")
        if blocking and ins.cooperative:
            # cooperative mode: never really block while holding the baton —
            # deschedule until the raw lock is free, then retry
            while not self._try_acquire():
                ins.fuzz.block_until(self._free)
            got = True
        elif timeout is not None and timeout >= 0:
            got = self._raw.acquire(blocking, timeout)
        else:
            got = self._raw.acquire(blocking)
        if got:
            ins.det.lock_acquired(self.name)
        return got

    def release(self) -> None:
        self._ins.det.lock_released(self.name)
        self._raw.release()
        self._ins.op("lock_release")

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class _TracedRLock(_TracedLock):
    _KIND = "RLock"

    def _make_raw(self):
        return _real_threading.RLock()

    def _try_acquire(self) -> bool:
        return self._raw.acquire(blocking=False)

    def _free(self) -> bool:
        # RLock exposes no .locked() before 3.12; a cooperative waiter just
        # stays runnable and retries (the seeded choice rotates the baton)
        return True


class _TracedCondition:
    """threading.Condition twin. Aliases its lock (a Condition built on a
    traced lock IS that lock for lockset purposes — the engine's
    ``_cv``/``_lock`` pair). ``wait`` drops the lockset entry for its
    blocked span; notify carries no HB edge (mutual exclusion is not
    ordering; the state handed over is protected by the shared lock)."""

    def __init__(self, ins: "Instrumentation", lock=None):
        self._ins = ins
        if lock is None:
            lock = _TracedLock(ins, name=ins.next_name("Condition"))
        self._lock = lock
        raw = lock._raw if isinstance(lock, _TracedLock) else lock
        self._raw_cond = _real_threading.Condition(raw)
        self.name = getattr(lock, "name", ins.next_name("Condition"))
        self._gen = 0                     # notify generation (cooperative)

    def acquire(self, *a, **k):
        return self._lock.acquire(*a, **k)

    def release(self):
        return self._lock.release()

    def __enter__(self):
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)

    def wait(self, timeout: Optional[float] = None) -> bool:
        ins = self._ins
        ins.det.lock_released(self.name)
        ins.op("cond_wait")
        try:
            if ins.cooperative:
                gen = self._gen
                # release the raw lock for the blocked span so the notifier
                # can enter the critical section; the re-acquire must also
                # be cooperative (a real blocking acquire here can hold the
                # baton while the notifier still holds the raw lock)
                raw = self._raw_cond._lock \
                    if hasattr(self._raw_cond, "_lock") else None
                self._raw_cond.release()
                ins.fuzz.block_until(lambda: self._gen != gen)
                while not self._raw_cond.acquire(blocking=False):
                    ins.fuzz.block_until(
                        (lambda: not raw.locked()) if raw is not None
                        and hasattr(raw, "locked") else (lambda: True))
                return True
            return self._raw_cond.wait(timeout)
        finally:
            ins.det.lock_acquired(self.name)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # re-implemented over self.wait so the lockset bookkeeping (and the
        # cooperative path) is shared; predicate runs holding the lock
        import time as _time
        endtime = None if timeout is None else _time.monotonic() + timeout
        result = predicate()
        while not result:
            if endtime is not None:
                remaining = endtime - _time.monotonic()
                if remaining <= 0.0:
                    break
                self.wait(remaining)
            else:
                self.wait(None)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._gen += 1
        self._raw_cond.notify(n)
        self._ins.op("cond_notify")

    def notify_all(self) -> None:
        self._gen += 1
        self._raw_cond.notify_all()
        self._ins.op("cond_notify")


class _TracedEvent:
    """threading.Event twin; ``set -> (successful wait | is_set)`` is an HB
    edge (an observed flag publishes everything the setter did first)."""

    def __init__(self, ins: "Instrumentation"):
        self._ins = ins
        self._raw = _real_threading.Event()
        self._eid = ins.next_id()

    def set(self) -> None:
        self._ins.det.event_set(self._eid)
        self._raw.set()
        self._ins.op("event_set")

    def clear(self) -> None:
        self._raw.clear()

    def is_set(self) -> bool:
        s = self._raw.is_set()
        if s:
            self._ins.det.event_observed(self._eid)
        return s

    def wait(self, timeout: Optional[float] = None) -> bool:
        ins = self._ins
        ins.op("event_wait")
        if ins.cooperative:
            if timeout is None:
                ins.fuzz.block_until(self._raw.is_set)
            else:
                # a timed wait is a pacing sleep in this codebase's loops
                # (e.g. ``_stop_evt.wait(interval)``): model it as a zero-
                # length sleep plus a yield so the loop keeps spinning
                ins.op("event_wait_timeout")
            ok = self._raw.is_set()
        else:
            ok = self._raw.wait(timeout)
        if ok:
            self._ins.det.event_observed(self._eid)
        return ok


class _ThreadingProxy:
    """Stands in for the ``threading`` module inside instrumented modules:
    sync factories build traced twins, everything else passes through."""

    def __init__(self, ins: "Instrumentation"):
        self._ins = ins

    def Lock(self):
        return _TracedLock(self._ins)

    def RLock(self):
        return _TracedRLock(self._ins)

    def Condition(self, lock=None):
        return _TracedCondition(self._ins, lock)

    def Event(self):
        return _TracedEvent(self._ins)

    def Thread(self, *args, **kwargs):
        return self._ins.thread_cls(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(_real_threading, name)


def _make_thread_cls(ins: "Instrumentation"):
    class TracedThread(_real_threading.Thread):
        """Thread twin: start/join are HB edges; under the cooperative
        scheduler the child waits for the baton before running user code."""

        def start(self):
            self._race_parent = ins.det.current_tid()
            ins.op("thread_start")
            super().start()
            if ins.cooperative:
                ins.fuzz.wait_child_registered(self)

        def run(self):
            tid = ins.det.register_thread(self.name)
            self._race_tid = tid
            ins.det.thread_started(self._race_parent, tid)
            if ins.cooperative:
                ins.fuzz.register_child(self, tid)
            try:
                super().run()
            finally:
                ins.det.thread_exited(tid)
                if ins.cooperative:
                    ins.fuzz.detach(tid)

        def join(self, timeout: Optional[float] = None):
            ins.op("thread_join")
            if ins.cooperative and timeout is None:
                ins.fuzz.block_until(lambda: not self.is_alive())
            super().join(timeout)
            if not self.is_alive() and hasattr(self, "_race_tid"):
                ins.det.thread_joined(self._race_tid)

    return TracedThread


def _make_future_cls(ins: "Instrumentation"):
    class TracedFuture(_RealFuture):
        """Future twin: completion -> observation is an HB edge (the
        dispatcher->completion handoff, router reroutes, done-callbacks)."""

        def __init__(self):
            super().__init__()
            self._race_fid = ins.next_id()

        def set_result(self, result):
            ins.det.future_completed(self._race_fid)
            ins.op("future_set")
            super().set_result(result)

        def set_exception(self, exception):
            ins.det.future_completed(self._race_fid)
            ins.op("future_set")
            super().set_exception(exception)

        def result(self, timeout: Optional[float] = None):
            ins.op("future_get")
            if ins.cooperative and timeout is None:
                ins.fuzz.block_until(self.done)
            r = super().result(timeout)
            ins.det.future_observed(self._race_fid)
            return r

        def exception(self, timeout: Optional[float] = None):
            ins.op("future_get")
            if ins.cooperative and timeout is None:
                ins.fuzz.block_until(self.done)
            e = super().exception(timeout)
            ins.det.future_observed(self._race_fid)
            return e

        def add_done_callback(self, fn):
            # registration -> invocation is itself an HB edge: the callback
            # (and the closure state it captures) runs strictly after this
            # call, in whichever thread completes the future
            ins.det.future_registered(self._race_fid)
            ins.op("future_register")

            def _traced_cb(fut, _fn=fn):
                ins.det.future_observed(self._race_fid)
                _fn(fut)
            super().add_done_callback(_traced_cb)

    return TracedFuture


def _make_queue_cls(ins: "Instrumentation"):
    class TracedQueue(_real_queue.Queue):
        """Queue twin: ``put -> the get that receives that item`` is an HB
        edge (FIFO-paired clock transfer)."""

        def __init__(self, maxsize: int = 0):
            super().__init__(maxsize)
            self._race_qid = ins.next_id()

        def put(self, item, block: bool = True,
                timeout: Optional[float] = None):
            ins.op("queue_put")
            super().put(item, block, timeout)
            ins.det.queue_put(self._race_qid)

        def get(self, block: bool = True, timeout: Optional[float] = None):
            ins.op("queue_get")
            if ins.cooperative and block and timeout is None:
                while True:
                    try:
                        item = super().get(block=False)
                        break
                    except _real_queue.Empty:
                        ins.fuzz.block_until(lambda: not self.empty())
            else:
                item = super().get(block, timeout)
            ins.det.queue_got(self._race_qid)
            return item

    return TracedQueue


class _QueueModuleProxy:
    def __init__(self, ins: "Instrumentation"):
        self._ins = ins

    def Queue(self, maxsize: int = 0):
        return self._ins.queue_cls(maxsize)

    def __getattr__(self, name):
        return getattr(_real_queue, name)


#: attribute VALUES that are synchronization, not shared data: reading the
#: lock/condition/event/queue/future/thread handle off an object is how a
#: thread synchronizes — recording those reads would report "races" on
#: every lock attribute (all threads read it bare by construction)
_SYNC_TYPES = (
    _TracedLock, _TracedCondition, _TracedEvent,
    type(_real_threading.Lock()), type(_real_threading.RLock()),
    _real_threading.Condition, _real_threading.Event,
    _real_threading.Semaphore, _real_threading.Thread,
    _real_queue.Queue, _RealFuture,
)


def _is_sync(value) -> bool:
    return isinstance(value, _SYNC_TYPES)


class Instrumentation:
    """One detector + its traced primitives + the install/uninstall state."""

    def __init__(self, detector: Optional[RaceDetector] = None, fuzz=None):
        self.det = detector or RaceDetector()
        self.fuzz = fuzz
        if fuzz is not None:
            fuzz.bind(self.det)
        self._mu = _real_threading.Lock()
        self._name_counts: Dict[str, int] = {}
        self._next = 0
        self._labels: Dict[int, str] = {}
        self._label_refs: List[object] = []     # keep labeled objects alive:
        # id() reuse during a run would alias two objects into one label
        self._module_saves: List[Tuple[object, str, object]] = []
        self._field_saves: List[object] = []    # dataclass Field objects
        self._class_saves: List[Tuple[type, dict]] = []
        self.threading = _ThreadingProxy(self)
        self.queue = _QueueModuleProxy(self)
        self.thread_cls = _make_thread_cls(self)
        self.future_cls = _make_future_cls(self)
        self.queue_cls = _make_queue_cls(self)

    @property
    def cooperative(self) -> bool:
        return self.fuzz is not None and getattr(self.fuzz, "cooperative",
                                                 False)

    # -- ids / labels -------------------------------------------------------

    def next_name(self, kind: str) -> str:
        with self._mu:
            n = self._name_counts.get(kind, 0)
            self._name_counts[kind] = n + 1
            return f"{kind}#{n}"

    def next_id(self) -> int:
        with self._mu:
            self._next += 1
            return self._next

    def _label_of(self, obj) -> str:
        key = id(obj)
        with self._mu:
            label = self._labels.get(key)
            if label is None:
                label = self.det.label_object(type(obj).__name__)
                self._labels[key] = label
                self._label_refs.append(obj)
            return label

    # -- fuzz hook ----------------------------------------------------------

    def op(self, kind: str) -> None:
        if self.fuzz is not None:
            self.fuzz.on_op(kind)

    # -- direct construction (fixtures) -------------------------------------

    def lock(self, name: Optional[str] = None) -> _TracedLock:
        return _TracedLock(self, name)

    def rlock(self, name: Optional[str] = None) -> _TracedRLock:
        return _TracedRLock(self, name)

    def condition(self, lock=None) -> _TracedCondition:
        return _TracedCondition(self, lock)

    def event(self) -> _TracedEvent:
        return _TracedEvent(self)

    def thread(self, *args, **kwargs):
        return self.thread_cls(*args, **kwargs)

    def future(self):
        return self.future_cls()

    def make_queue(self, maxsize: int = 0):
        return self.queue_cls(maxsize)

    # -- injection ----------------------------------------------------------

    def install(self, modules: Iterable[object] = (),
                classes: Iterable[type] = ()) -> None:
        """Swap traced twins into `modules`' globals (every reference to
        the real ``threading``/``queue`` module or ``Future`` class) and
        patch attribute tracing onto `classes`."""
        for mod in modules:
            for name, val in list(vars(mod).items()):
                repl = None
                if val is _real_threading:
                    repl = self.threading
                elif val is _real_queue:
                    repl = self.queue
                elif val is _RealFuture:
                    repl = self.future_cls
                if repl is not None:
                    self._module_saves.append((mod, name, val))
                    setattr(mod, name, repl)
            # a dataclass ``field(default_factory=Future)`` captured the
            # REAL class at class-definition time — the module-global swap
            # can't reach it (batcher.Request.future is minted this way).
            # The factory lives in TWO places: the Field object (metadata)
            # and a closure cell of the generated __init__ (``_dflt_<name>``
            # — the one the constructor actually calls)
            for val in vars(mod).values():
                if not (isinstance(val, type)
                        and val.__module__ == mod.__name__):
                    continue
                fields = getattr(val, "__dataclass_fields__", {})
                if not any(f.default_factory is _RealFuture
                           for f in fields.values()):
                    continue
                for f in fields.values():
                    if f.default_factory is _RealFuture:
                        self._field_saves.append((f, "default_factory"))
                        f.default_factory = self.future_cls
                for cell in val.__init__.__closure__ or ():
                    if cell.cell_contents is _RealFuture:
                        self._field_saves.append((cell, "cell_contents"))
                        cell.cell_contents = self.future_cls
        for cls in classes:
            self._patch_class(cls)

    def uninstall(self) -> None:
        """Restore the exact original objects — the uninstrumented modules
        and classes are byte-identical to their pre-install state."""
        for mod, name, val in reversed(self._module_saves):
            setattr(mod, name, val)
        self._module_saves.clear()
        for obj, attr in self._field_saves:
            setattr(obj, attr, _RealFuture)
        self._field_saves.clear()
        for cls, saved in reversed(self._class_saves):
            for name, orig in saved.items():
                if orig is None:
                    if name in cls.__dict__:
                        delattr(cls, name)
                else:
                    setattr(cls, name, orig)
        self._class_saves.clear()

    @contextlib.contextmanager
    def active(self, modules: Iterable[object] = (),
               classes: Iterable[type] = ()):
        self.install(modules, classes)
        try:
            yield self
        finally:
            self.uninstall()

    def track(self, obj):
        """Track one object's class (fixture convenience); returns `obj`."""
        cls = type(obj)
        if not any(c is cls for c, _ in self._class_saves):
            self._patch_class(cls)
        return obj

    def _patch_class(self, cls: type) -> None:
        ins = self
        saved = {
            "__setattr__": cls.__dict__.get("__setattr__"),
            "__getattribute__": cls.__dict__.get("__getattribute__"),
        }
        orig_set = cls.__setattr__
        orig_get = cls.__getattribute__

        def __setattr__(self, name, value):
            if not name.startswith("_race_") and not _is_sync(value):
                ins.det.access(f"{ins._label_of(self)}.{name}", write=True)
            orig_set(self, name, value)

        def __getattribute__(self, name):
            value = orig_get(self, name)
            if not name.startswith(("__", "_race_")):
                try:
                    is_instance_attr = name in orig_get(self, "__dict__")
                except AttributeError:
                    is_instance_attr = name in getattr(
                        type(self), "__slots__", ())
                if is_instance_attr and not _is_sync(value):
                    ins.det.access(f"{ins._label_of(self)}.{name}",
                                   write=False)
            return value

        cls.__setattr__ = __setattr__
        cls.__getattribute__ = __getattribute__
        self._class_saves.append((cls, saved))
