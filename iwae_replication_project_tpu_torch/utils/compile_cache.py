"""The executable store: serving programs captured once and replayed, under
a device-memory budget (port of ``utils/compile_cache.py``, its store only).

Entries are keyed ``(model, name, build_key, signature)`` as in the JAX
package: the model label names the tenant (a zoo preset or checkpoint,
``@precision``-suffixed under a precision policy), ``name`` and
``build_key`` the program, the signature the shapes and dtypes of its
arguments. Past ``budget_bytes`` (:func:`set_store_budget`,
``IWAE_STORE_BUDGET_BYTES``, the serving CLI's ``--store-budget-mb``; None
is unbounded) the least recently used unpinned entries are evicted until
the resident set fits; an entry larger than the whole budget is still
admitted (refusing it would refuse to serve). :meth:`ExecutableStore.
pin_prefix` (refcounted) keeps a program's entries resident for the life of
each in-flight dispatch, and :meth:`~ExecutableStore.pin_model` keeps a
whole model resident for the fleet's placement planner
(``serving/fleet/``). The counters ``hits``, ``misses``, ``evictions``,
``demotions`` and ``readmits`` are mirrored into the telemetry registry as
``store/<name>``.

What differs from the JAX store:

* **The entry.** A JAX entry is an XLA executable. On the card a port entry
  is the serving program at one (op, k, path, dtype, bucket), captured as a
  ``torch.cuda.CUDAGraph`` in its own memory pool (:class:`GraphProgram`):
  it owns static buffers for its inputs (the payload and each layer's
  noise) and for its output, and a call copies the inputs in, replays the
  graph and copies the output out, all on the caller's stream. The first
  admission of a program runs it once eagerly on the capture stream (the
  warm-up of ``training/epoch.py``'s capture, so that nothing is
  initialised lazily inside the capture), then captures it; the graph's
  launches are counted per replay (``ops/_kernels.add_launches``). On the
  CPU, and for programs that are not captured (the sharded engine's, whose
  gloo/NCCL collectives and per-row device generators are not captured in
  this slice), the entry is the eager program (:class:`EagerProgram`), so
  the store's bookkeeping is the same everywhere.
* **The bill.** JAX bills an entry the ``peak_bytes`` of its trace-time
  cost record. The port bills the larger of two numbers: the bytes the
  caller reckons from the program's shapes
  (``serving.programs.program_bytes``: the static buffers plus the largest
  live activations at its bucket and k; without one, the bytes of its
  tensor arguments) and, for a :class:`GraphProgram`, the device bytes the
  capture holds (``pool_bytes``: the segments of the graph's private pool,
  read from the caching allocator's snapshot by the pool's id, plus the
  static input buffers). The allocator reserves whole segments, so on the
  card the second is the larger, and the budget bounds device bytes; an
  eager entry holds none (``pool_bytes`` 0), so CPU bills are the
  reckoned ones.
* **Eviction, readmission and builds.** Eviction drops the graph, its
  static buffers and its pool (the pool's memory returns to the caching
  allocator, which gives it back to the device at its next
  ``empty_cache``), so every eviction is a demotion: a later request for
  the key is a *readmit*, a re-capture of a program that ran before, with
  no warm-up and no ``nvcc`` build (the kernels' libraries stay loaded).
  The JAX store's "0 fresh compiles" is the port's "0 kernel builds"
  (``kernel_builds`` in :func:`cache_stats`, from ``ops/_kernels``).
* **Left out:** the persistent XLA cache, the donation gate and
  ``setup_persistent_cache`` have no counterpart (the CLI refuses
  ``--compile-cache-dir`` and ``--no-donate-buffers``), and no trace-time
  cost record is stamped.

**The shared key.** A graph bakes in the addresses of the weights it
captured, so the caller puts the weights' identity in ``build_key`` (the
serving engines use the weights' data pointers): replicas of one model,
which share their weight tensors, share entries; two engines over other
tensors never do.

**Concurrency.** Resolution holds the store's lock only for bookkeeping;
captures run outside it under one process-wide capture lock (in
``thread_local`` capture mode on a side stream of the high-priority pool,
on which no engine launches, so other engines' threads may launch
meanwhile), and so do the releases of evicted graphs. A call of
a :class:`GraphProgram` holds the entry's own lock while it enqueues: the
caller's stream first waits for the entry's previous call (its output
copied out), so two replicas on one entry, or two batches in flight, never
overwrite inputs or outputs that an earlier replay still uses.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.telemetry.spans import span
from iwae_replication_project_tpu_torch.utils.faults import (
    SITE_AOT_CALL_ASYNC,
    fault_point,
)

#: the default per-model label for callers that name no tenant
DEFAULT_MODEL = "default"

#: spellings of "unbounded" accepted from the environment
_OFF = ("off", "none", "disabled", "0", "")

#: "argument not passed" sentinel (None is a meaningful budget)
_UNSET = object()

_lock = threading.Lock()
#: process-wide counters (monotonic; consumers diff snapshots):
#: resolutions that hit and missed, captures (graphs recorded), the eager
#: warm-ups of first admissions, and the seconds the misses took
_counters = {"aot_hits": 0, "aot_misses": 0, "aot_captures": 0,
             "aot_warmups": 0, "aot_capture_seconds": 0.0}

#: one capture (or graph release) at a time in the process
_capture_lock = threading.RLock()


def _bump(name: str, n=1) -> None:
    with _lock:
        _counters[name] += n


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

class EagerProgram:
    """An entry that runs its program as it is: ``fn(*args, **kwargs)``
    (it holds no buffers of its own)."""

    pool_bytes = static_bytes = 0

    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def release(self) -> None:
        self.fn = None


class GraphProgram:
    """One serving program captured as a CUDA graph (module docstring).

    ``fn(*tensors) -> tensor`` is captured on a high-priority side stream
    of the tensors' device, over static copies of `tensors`; ``warm`` runs
    it once eagerly first (a first admission; a readmit skips it). A call
    ``entry(*tensors)`` copies the tensors into the static buffers, replays
    the graph and returns a copy of its output, on the current stream."""

    def __init__(self, fn: Callable, tensors, warm: bool = True):
        dev = tensors[0].device
        self.device = dev
        cur = torch.cuda.current_stream(dev)
        # captured on a stream of the high-priority pool: the engines
        # launch on the default-priority pool, and a capture on a stream
        # another engine's thread enqueues onto would record that work (or
        # fail); captures themselves take turns under _capture_lock
        side = torch.cuda.Stream(device=dev, priority=-1)
        side.wait_stream(cur)
        from iwae_replication_project_tpu_torch.ops import _kernels

        with _capture_lock, torch.inference_mode(), torch.cuda.device(dev), \
                torch.cuda.stream(side):
            self._static = [t.clone() for t in tensors]
            if warm:
                fn(*self._static)
                _bump("aot_warmups")
            graph = torch.cuda.CUDAGraph()
            with _kernels.recording() as tally:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = fn(*self._static)
                finally:
                    graph.capture_end()
            #: the device bytes this entry holds: the segments of the
            #: graph's private pool (the capture's intermediates and its
            #: output) plus the static input buffers, which live outside it
            self.pool_bytes = _pool_segment_bytes(dev, graph.pool()) + sum(
                t.numel() * t.element_size() for t in self._static)
        cur.wait_stream(side)
        #: the kernel launches of one replay
        self.launches = dict(tally)
        _kernels.add_launches(self.launches, -1)   # the capture ran nothing
        _bump("aot_captures")
        self._graph = graph
        self._out = out
        self._done: Optional[torch.cuda.Event] = None
        self._lock = threading.Lock()

    @property
    def static_bytes(self) -> int:
        """Bytes of the static input and output buffers."""
        return sum(t.numel() * t.element_size()
                   for t in self._static + [self._out])

    def __call__(self, *tensors):
        from iwae_replication_project_tpu_torch.ops import _kernels

        cur = torch.cuda.current_stream(self.device)
        with self._lock, torch.inference_mode():
            if self._graph is None:
                raise RuntimeError("this store entry was evicted")
            if self._done is not None:
                cur.wait_event(self._done)
            for s, t in zip(self._static, tensors):
                s.copy_(t, non_blocking=True)
            self._graph.replay()
            out = self._out.clone()
            self._done = torch.cuda.Event()
            self._done.record(cur)
        _kernels.add_launches(self.launches)
        return out

    def release(self) -> None:
        """Drop the graph, its pool and the static buffers."""
        with self._lock:
            self._graph = None
            self._out = None
            self._static = []
            self._done = None


def _pool_segment_bytes(device, pool) -> int:
    """Bytes of the caching allocator's segments that belong to the memory
    pool `pool` (a ``CUDAGraph.pool()`` id) on `device`. Unlike a
    ``memory_reserved`` delta it neither counts blocks another thread
    reserved meanwhile nor misses blocks of the general pool that a capture
    reused."""
    pool = tuple(pool)
    index = torch.device(device).index
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot(device)["segments"]
               if tuple(seg["segment_pool_id"]) == pool
               and seg["device"] == index)


def _release(entries) -> None:
    """Release evicted or superseded entries, one at a time with captures."""
    if not entries:
        return
    with _capture_lock:
        for exe in entries:
            exe.release()


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class _StoreEntry:
    """One resident entry: the program plus its budget bill."""

    __slots__ = ("exe", "bytes", "pins")

    def __init__(self, exe, nbytes: int):
        self.exe = exe
        #: device bytes billed against the store budget
        self.bytes = int(nbytes)
        #: pin refcount: > 0 means an in-flight dispatch holds the entry
        self.pins = 0


class _PrefixPin:
    """Handle for a ``(model, name, build_key)``-prefix pin (release once)."""

    __slots__ = ("_store", "_prefix", "_released")

    def __init__(self, store: "ExecutableStore", prefix: Tuple):
        self._store = store
        self._prefix = prefix
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._store._unpin_prefix(self._prefix)


class _ModelPin:
    """Handle for a model-level placement pin (release once)."""

    __slots__ = ("_store", "_model", "_released")

    def __init__(self, store: "ExecutableStore", model: str):
        self._store = store
        self._model = model
        self._released = False

    @property
    def model(self) -> str:
        return self._model

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._store._unpin_model(self._model)


class ExecutableStore:
    """Capacity-bounded, multi-tenant store of serving programs (module
    docstring)."""

    COUNTER_NAMES = ("hits", "misses", "evictions", "demotions", "readmits")

    def __init__(self, budget_bytes: Optional[int] = None):
        # reentrant: _evict_over_budget takes it itself, under callers that
        # already hold it
        self._lock = threading.RLock()
        #: key -> _StoreEntry in LRU order (last = most recently used)
        self._entries: "collections.OrderedDict[Tuple, _StoreEntry]" = \
            collections.OrderedDict()
        #: evicted keys: a miss on one is a readmit
        self._demoted: Dict[Tuple, int] = {}
        #: active (model, name, build_key) prefix pins (refcounted)
        self._prefix_pins: Dict[Tuple, int] = {}
        #: active model-level placement pins (refcounted)
        self._model_pins: Dict[str, int] = {}
        self._budget = int(budget_bytes) if budget_bytes is not None else None
        self._resident = 0
        self._counters = {n: 0 for n in self.COUNTER_NAMES}
        self._per_model: Dict[str, Dict[str, int]] = {}
        self._tel_counters: Dict[str, Any] = {}

    # -- accounting ----------------------------------------------------------

    def _count(self, name: str, model: str, n: int = 1) -> None:
        """Caller holds the lock. Mirrors every count into the telemetry
        registry as ``store/<name>``."""
        self._counters[name] += n
        per = self._per_model.setdefault(
            model, {k: 0 for k in self.COUNTER_NAMES})
        per[name] += n
        handle = self._tel_counters.get(name)
        if handle is None:
            from iwae_replication_project_tpu_torch.telemetry.registry import (
                get_registry)
            handle = self._tel_counters.setdefault(
                name, get_registry().counter(f"store/{name}"))
        handle.inc(n)

    def _publish_resident(self) -> None:
        """Caller holds the lock: the residency gauges (an unbounded budget
        reads +Inf)."""
        from iwae_replication_project_tpu_torch.telemetry.registry import (
            get_registry)
        reg = get_registry()
        reg.gauge("store/resident_bytes").set(float(self._resident))
        reg.gauge("store/budget_bytes").set(
            float(self._budget) if self._budget is not None
            else float("inf"))
        reg.gauge("store/entries").set(float(len(self._entries)))

    # -- budget --------------------------------------------------------------

    @property
    def budget_bytes(self) -> Optional[int]:
        with self._lock:
            return self._budget

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident

    def set_budget(self, budget_bytes: Optional[int]) -> None:
        """Set (or clear) the budget; an over-budget resident set is evicted
        down at once (LRU, pins respected). A negative budget raises."""
        if budget_bytes is not None and int(budget_bytes) < 0:
            raise ValueError(f"store budget must be >= 0 bytes (or None "
                             f"for unbounded), got {int(budget_bytes)}")
        with self._lock:
            self._budget = int(budget_bytes) \
                if budget_bytes is not None else None
            evicted = self._evict_over_budget()
            self._publish_resident()
        _release(evicted)

    def _pinned(self, key: Tuple, entry: _StoreEntry) -> bool:
        return entry.pins > 0 or key[:3] in self._prefix_pins \
            or key[0] in self._model_pins

    def _evict_over_budget(self) -> List[Any]:
        """Evict LRU unpinned entries until the resident set fits the
        budget; returns the evicted programs, which the caller releases
        once it has let go of the lock. Every eviction is a demotion."""
        out: List[Any] = []
        with self._lock:
            if self._budget is None:
                return out
            for key in list(self._entries):          # LRU -> MRU
                if self._resident <= self._budget:
                    break
                entry = self._entries[key]
                if self._pinned(key, entry):
                    continue
                del self._entries[key]
                self._resident -= entry.bytes
                self._demoted[key] = entry.bytes
                self._count("evictions", key[0])
                self._count("demotions", key[0])
                out.append(entry.exe)
        return out

    # -- pins ----------------------------------------------------------------

    def pin_prefix(self, model: Optional[str], name: str,
                   build_key: Tuple) -> _PrefixPin:
        """Pin every entry (present or future) under ``(model, name,
        build_key)`` against eviction; returns the release handle. The
        serving engines hold one per in-flight dispatch."""
        prefix = (model if model is not None else DEFAULT_MODEL,
                  name, build_key)
        with self._lock:
            self._prefix_pins[prefix] = self._prefix_pins.get(prefix, 0) + 1
        return _PrefixPin(self, prefix)

    def _unpin_prefix(self, prefix: Tuple) -> None:
        evicted: List[Any] = []
        with self._lock:
            n = self._prefix_pins.get(prefix, 0) - 1
            if n <= 0:
                self._prefix_pins.pop(prefix, None)
            else:
                self._prefix_pins[prefix] = n
            # a release may unblock a deferred eviction: scan only when
            # the resident set sits over the budget
            if self._budget is not None and self._resident > self._budget:
                evicted = self._evict_over_budget()
                self._publish_resident()
        _release(evicted)

    @contextlib.contextmanager
    def pinned(self, model: Optional[str], name: str, build_key: Tuple):
        pin = self.pin_prefix(model, name, build_key)
        try:
            yield
        finally:
            pin.release()

    def pin_model(self, model: Optional[str]) -> _ModelPin:
        """Pin every entry (present or future) under ``model`` against
        eviction: the fleet planner's residency primitive. Independent of
        the per-dispatch prefix pins."""
        model = model if model is not None else DEFAULT_MODEL
        with self._lock:
            self._model_pins[model] = self._model_pins.get(model, 0) + 1
        return _ModelPin(self, model)

    def _unpin_model(self, model: str) -> None:
        evicted: List[Any] = []
        with self._lock:
            n = self._model_pins.get(model, 0) - 1
            if n <= 0:
                self._model_pins.pop(model, None)
            else:
                self._model_pins[model] = n
            if self._budget is not None and self._resident > self._budget:
                evicted = self._evict_over_budget()
                self._publish_resident()
        _release(evicted)

    def model_pins(self) -> Dict[str, int]:
        """The active model-level pin refcounts (snapshot)."""
        with self._lock:
            return dict(self._model_pins)

    def model_costs(self) -> Dict[str, int]:
        """Per-model resident cost, the sum of each resident entry's bill:
        the fleet planner's cost model."""
        with self._lock:
            costs: Dict[str, int] = {}
            for key, e in self._entries.items():
                costs[key[0]] = costs.get(key[0], 0) + e.bytes
            return costs

    # -- resolution ----------------------------------------------------------

    def get_or_build(self, name: str, build: Callable[[bool], Any],
                     build_key: Tuple, signature: Tuple,
                     nbytes: int, count_hit: bool = True,
                     model: Optional[str] = None) -> Tuple[Any, bool]:
        """Resolve ``(model, name, build_key, signature)`` to its program;
        returns ``(program, hit)``. On a miss ``build(readmit)`` makes the
        program outside the store's lock (``readmit`` is True for a key
        evicted before) and it is admitted billed `nbytes`.
        ``count_hit=False`` lets warmup resolve without counting hits."""
        model = model if model is not None else DEFAULT_MODEL
        key = (model, name, build_key, signature)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)      # MRU
                if count_hit:
                    self._count("hits", model)
                    _bump("aot_hits")
                return entry.exe, True
            readmit = key in self._demoted
        t0 = time.perf_counter()
        exe = build(readmit)
        dropped: List[Any] = []
        with self._lock:
            prev = self._entries.get(key)
            if prev is not None:
                # another thread admitted it meanwhile: keep theirs
                self._entries.move_to_end(key)
                dropped.append(exe)
                exe = prev.exe
            else:
                self._demoted.pop(key, None)
                # a captured entry is billed at least the bytes it holds
                entry = _StoreEntry(exe, max(int(nbytes),
                                             int(getattr(exe, "pool_bytes",
                                                         0))))
                self._entries[key] = entry
                self._resident += entry.bytes
                self._count("misses", model)
                if readmit:
                    self._count("readmits", model)
                _bump("aot_misses")
                _bump("aot_capture_seconds", time.perf_counter() - t0)
                dropped += self._evict_over_budget()
            self._publish_resident()
        _release(dropped)
        return exe, False

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> List[Tuple]:
        """Entry keys, LRU -> MRU."""
        with self._lock:
            return list(self._entries)

    def entries(self) -> List[dict]:
        """Resident entries, LRU -> MRU: model, name, bytes, pinned, and
        the bytes a captured graph reserved (0 for eager entries)."""
        with self._lock:
            return [{"model": key[0], "name": key[1], "bytes": e.bytes,
                     "pinned": self._pinned(key, e),
                     "pool_bytes": int(getattr(e.exe, "pool_bytes", 0))}
                    for key, e in self._entries.items()]

    def scalar_stats(self) -> dict:
        """Counters and residency scalars only (no per-model walk)."""
        with self._lock:
            return {**self._counters,
                    "resident_bytes": self._resident,
                    "budget_bytes": self._budget,
                    "entries": len(self._entries)}

    def stats(self) -> dict:
        """Counters and residency, overall and per model."""
        with self._lock:
            per_model: Dict[str, dict] = {
                m: dict(c) for m, c in self._per_model.items()}
            for key, e in self._entries.items():
                per = per_model.setdefault(
                    key[0], {k: 0 for k in self.COUNTER_NAMES})
                per["resident_bytes"] = per.get("resident_bytes", 0) + e.bytes
                per["entries"] = per.get("entries", 0) + 1
            for per in per_model.values():
                per.setdefault("resident_bytes", 0)
                per.setdefault("entries", 0)
            return {**self._counters,
                    "resident_bytes": self._resident,
                    "budget_bytes": self._budget,
                    "entries": len(self._entries),
                    "demoted": len(self._demoted),
                    "model_pins": dict(self._model_pins),
                    "per_model": per_model}

    # -- state swap (test isolation) -----------------------------------------

    def _swap_state(self, entries=None, demoted=None, budget=_UNSET):
        """Replace entries and demoted keys (and optionally the budget),
        returning the previous triple: :func:`isolated_aot_registry`."""
        with self._lock:
            prev = (self._entries, self._demoted, self._budget)
            self._entries = entries if entries is not None \
                else collections.OrderedDict()
            self._demoted = demoted if demoted is not None else {}
            if budget is not _UNSET:
                self._budget = budget
            self._resident = sum(e.bytes for e in self._entries.values())
            evicted = self._evict_over_budget()
            self._publish_resident()
        _release(evicted)
        return prev


def _budget_from_env() -> Optional[int]:
    """``IWAE_STORE_BUDGET_BYTES`` as the default store's budget. Fail-soft:
    it runs at import time, so a value that is not a number or is negative
    warns and leaves the budget unbounded."""
    raw = (os.environ.get("IWAE_STORE_BUDGET_BYTES") or "").strip()
    if raw.lower() in _OFF:
        return None
    import warnings

    try:
        value = int(float(raw))
    except ValueError:
        warnings.warn(f"IWAE_STORE_BUDGET_BYTES={raw!r} is not a number; "
                      f"executable-store budget left UNBOUNDED")
        return None
    if value < 0:
        warnings.warn(f"IWAE_STORE_BUDGET_BYTES={value} is negative; "
                      f"executable-store budget left UNBOUNDED")
        return None
    return value


#: the process-default store every module-level helper routes through
_store = ExecutableStore(budget_bytes=_budget_from_env())


def executable_store() -> ExecutableStore:
    """The process-default :class:`ExecutableStore`."""
    return _store


def set_store_budget(budget_bytes: Optional[int]) -> None:
    """Set the default store's budget (None = unbounded); evicts at once
    when the resident set exceeds it."""
    _store.set_budget(budget_bytes)


def store_stats() -> dict:
    """The default store's counters and residency, overall and per model."""
    return _store.stats()


def _leaf_signature(x) -> Tuple:
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_leaf_signature(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _leaf_signature(x[k]))
                                 for k in sorted(x))
    return (type(x).__name__, repr(x))


def signature(args: Tuple, kwargs: Optional[dict] = None) -> Tuple:
    """Hashable fingerprint of a call: shape, dtype and device of every
    tensor (in lists, tuples and dicts too), type and value of the rest."""
    return (_leaf_signature(tuple(args)),
            _leaf_signature(dict(kwargs or {})))


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_tensor_bytes(v) for v in x.values())
    return 0


def _resolve(name: str, fn: Callable, args: Tuple, kwargs: dict,
             build_key: Tuple, model: Optional[str],
             nbytes: Optional[int], graph: bool, count_hit: bool,
             sig: Optional[Tuple]) -> Tuple[Any, bool]:
    if graph:
        def build(readmit: bool):
            return GraphProgram(fn, args, warm=not readmit)
    else:
        def build(readmit: bool):
            return EagerProgram(fn)
    bill = nbytes if nbytes is not None \
        else _tensor_bytes(args) + _tensor_bytes(kwargs)
    return _store.get_or_build(
        name, build, build_key, sig if sig is not None
        else signature(args, kwargs), bill, count_hit=count_hit, model=model)


def aot_call_async(name: str, fn: Callable, args: Tuple = (),
                   kwargs: Optional[dict] = None, *,
                   build_key: Tuple = (), model: Optional[str] = None,
                   nbytes: Optional[int] = None, graph: bool = False,
                   sig: Optional[Tuple] = None) -> Tuple[Any, bool]:
    """``fn(*args, **kwargs)`` through the store, without waiting for the
    device; returns ``(output, hit)``.

    The entry of ``(model, name, build_key, signature(args, kwargs))`` is
    resolved (on a miss: a :class:`GraphProgram` of `fn` over the tensors
    `args` when ``graph``, else the eager `fn`; billed `nbytes`, or the
    arguments' bytes), pinned for the resolve and the enqueue; then the
    fault point ``SITE_AOT_CALL_ASYNC`` fires (``name=``) and the entry
    runs on the current stream under the span ``aot/<name>``.
    ``build_key`` must hold everything `fn` bakes in, the weights' identity
    included: two programs must never share a slot. `sig` replaces the
    signature of the arguments (a caller whose arguments carry per-request
    values keys on their shapes alone)."""
    kwargs = kwargs or {}
    with _store.pinned(model, name, build_key):
        exe, hit = _resolve(name, fn, args, kwargs, build_key, model,
                            nbytes, graph, True, sig)
        fault_point(SITE_AOT_CALL_ASYNC, name=name)
        # every store dispatch funnels through here: one span site for all
        # of them, in the process registry (the host time of the enqueue or
        # the graph's replay, not the device's completion)
        with span(f"aot/{name}"):
            return exe(*args, **kwargs), hit


def aot_call(name: str, fn: Callable, args: Tuple = (),
             kwargs: Optional[dict] = None, *, build_key: Tuple = (),
             model: Optional[str] = None, nbytes: Optional[int] = None,
             graph: bool = False, sig: Optional[Tuple] = None) -> Any:
    """:func:`aot_call_async`'s output alone (the caller fetches it)."""
    return aot_call_async(name, fn, args, kwargs, build_key=build_key,
                          model=model, nbytes=nbytes, graph=graph,
                          sig=sig)[0]


def aot_warm(name: str, fn: Callable, args: Tuple = (),
             kwargs: Optional[dict] = None, *, build_key: Tuple = (),
             model: Optional[str] = None, nbytes: Optional[int] = None,
             graph: bool = False,
             sig: Optional[Tuple] = None) -> Tuple[Any, bool]:
    """Admit this call's entry without running it (a captured graph does
    run once, as its first admission's warm-up); returns ``(program,
    hit)``. A present entry is not counted as a hit: warmup probes must not
    skew the serving hit rate."""
    return _resolve(name, fn, args, kwargs or {}, build_key, model, nbytes,
                    graph, False, sig)


@contextlib.contextmanager
def isolated_aot_registry(budget_bytes=_UNSET):
    """Run with an EMPTY default store and restore its contents (dropping
    the entries made inside) on exit; ``budget_bytes`` optionally sets a
    budget for the duration."""
    prev_entries, prev_demoted, prev_budget = _store._swap_state(
        budget=budget_bytes)
    try:
        yield
    finally:
        inner = _store._swap_state(entries=prev_entries,
                                   demoted=prev_demoted, budget=prev_budget)
        _release([e.exe for e in inner[0].values()])


def kernel_builds() -> int:
    """The ``nvcc`` builds this process ran (``ops/_kernels.build_log``)."""
    from iwae_replication_project_tpu_torch.ops import _kernels

    return len(_kernels.build_log)


def cache_stats() -> dict:
    """Snapshot of the process-wide counters: ``aot_*`` (hits, misses,
    captures, warm-ups, seconds of the misses), the store's counters as
    ``store_<name>`` with its residency, and ``kernel_builds``, the ``nvcc``
    builds this process ran (``ops/_kernels.build_log``): a readmit and a
    warm join must leave it unchanged."""
    with _lock:
        snap = dict(_counters)
    st = _store.scalar_stats()
    snap["aot_executables"] = st["entries"]
    for name in ExecutableStore.COUNTER_NAMES:
        snap[f"store_{name}"] = st[name]
    snap["store_resident_bytes"] = st["resident_bytes"]
    snap["store_budget_bytes"] = st["budget_bytes"]
    snap["kernel_builds"] = kernel_builds()
    return snap


def stats_delta(before: dict, after: Optional[dict] = None) -> dict:
    """Numeric field-wise ``after - before`` of two :func:`cache_stats`
    snapshots (non-numeric fields are taken from `after`)."""
    if after is None:
        after = cache_stats()
    out = {}
    for k, v in after.items():
        b = before.get(k, 0)
        out[k] = v - b if isinstance(v, (int, float)) \
            and not isinstance(v, bool) and isinstance(b, (int, float)) else v
    return out


__all__ = ["DEFAULT_MODEL", "EagerProgram", "ExecutableStore",
           "GraphProgram", "aot_call", "aot_call_async", "aot_warm",
           "cache_stats", "executable_store", "isolated_aot_registry",
           "kernel_builds",
           "set_store_budget", "signature", "stats_delta", "store_stats"]
