"""ServingEngine: pipelined online inference on one device (port of
``serving/engine.py``).

Request lifecycle, a two-stage pipeline behind a bounded in-flight window:

    submit -> bounded queue -> [dispatcher thread]
                 coalesce (max_batch / max_wait_us) -> pad to shape bucket
                 -> draw per-row noise on the host -> launch on a side CUDA
                 stream, record an event (no host sync)
                 -> bounded in-flight window (max_inflight)
           -> [completion thread]
                 wait on the batch's event -> the one device-to-host copy
                 -> slice real rows -> complete futures, record latency

CUDA streams and events take the place of the JAX engine's asynchronous AOT
dispatch: the dispatcher never blocks on the device, so it coalesces the next
batch while the card computes the current one. ``max_inflight=0`` is the
serial mode (the dispatcher fetches inline). Without :meth:`start`, the
blocking helpers drain the queue inline on the calling thread.

Invariants:

* **row independence** -- each request row's noise comes from its own
  generator (serving/programs.py), and on the card every op of the program
  sums a row in an order its bucket does not change, so a row's result does
  not depend on its bucket, its neighbours or the padding;
* **bounded everything** -- queue bound (:class:`EngineOverloaded` shed),
  in-flight window, per-request queue timeout (:class:`RequestTimeout`), and
  launch/fetch errors that land in exactly the affected batch's futures
  (the fault sites ``serving/faults.py`` names fire in :meth:`_launch` and
  :meth:`_finish`);
* **tracing** -- ``submit(trace=)`` takes a
  :class:`~..telemetry.tracing.TraceContext`; the hot path stamps clock
  readings only, and at completion each traced request gets its pipeline
  stages as child spans of that context: ``engine/queue`` (enqueue to the
  batch's launch), ``engine/pad`` (padding to the bucket),
  ``engine/dispatch`` (the arguments and the launch, the JAX engine's AOT
  dispatch; it carries :meth:`_trace_attrs`) with two children of the
  port's own, ``engine/noise`` (the host draw of the batch's per-row noise
  and the copies to the card; the sharded engine's span is
  ``engine/args``, the payload's copy and the followers' header, its noise
  being drawn on the card) and ``engine/launch`` (the program's launch on
  the side CUDA stream, without waiting), then ``engine/device`` (launch to
  the start of the fetch) and ``engine/fetch`` (the wait on the batch's
  event and the copy to the host). Results are bitwise the same with and
  without ``trace``.

A dispatch goes through hooks a subclass overrides: :meth:`_resolve_kernel`
(the hot-loop gate, memoized per :meth:`_stamp_k` key and bucket),
:meth:`_program_for`, :meth:`_dispatch_args` and :meth:`_entry`. The
mesh-sharded large-k engine (``serving/sharded.py``) swaps in its programs
and the ``score_adaptive`` op (:attr:`_ADAPTIVE_OPS`) through them. The
engine serves a parameter tree, a compiled ``api.FlexibleModel`` or a
checkpoint run directory of the driver (``source=``).

**The executable store.** Every dispatch resolves its program through the
process's executable store (``utils/compile_cache.py``) under the engine's
:attr:`store_label`, keyed by (op, k, bucket, dispatch config, the weights'
identity), and pins that key from the launch until the batch completes, so
a budget squeeze by another model never evicts a program in flight. On the
card a fast engine's entry is the program captured as a CUDA graph, which a
dispatch replays; on the CPU it is the eager program. The ``aot_hits`` and
``aot_misses`` counters count the resolutions, ``recompiles`` the kernel
builds a dispatch caused; :meth:`warmup` fills the store for the ladder.

**Row invariance on the card.** ``serving_dispatch_config`` gives every
program on CUDA the row-invariant ops (``ops/row_invariant``), so a row's
result is bitwise the same in every bucket, beside any neighbours and
padding, as in the JAX package.

**Profiling.** ``profiling=`` (a
:class:`~..telemetry.profiling.ProfilingConfig`; True or None = on, the
default; False = off) attaches a :class:`~..telemetry.profiling.
DispatchProfiler` on the engine's registry, labelled :attr:`store_label`:
one ``observe`` per dispatch at completion, with the dispatch's device
interval, its FLOPs (:meth:`_prof_flops`, or :meth:`_prof_adaptive`'s at
each row's ``k_used``) and its static cost record
(``serving/programs.static_cost``). On the card the interval is
``start.elapsed_time(end)`` of two timing events on the engine's stream:
``start`` right before the store call (the arguments staged), ``end`` the
event the fetch waits on. A store entry shared with another engine first
waits for that engine's previous replay of it, and that wait falls inside
the interval; this engine's own earlier work on its stream does not. On the
CPU the interval is the host's, from the store call to the fetched result.
Profiling never touches seeds, payloads or programs. The spans
``serve/dispatch/<op>`` (the launch, on the engine's registry; the store's
``aot/<name>`` nests in it on the process registry),
``serve/complete/<op>`` (the fetch) and ``serve/warmup`` wrap host calls
only, never a capture.

Not ported yet: the int8 policy (ROADMAP A8b).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from iwae_replication_project_tpu_torch.models.iwae import to_device
from iwae_replication_project_tpu_torch.ops.hot_loop import (
    PATH_CODES,
    serving_dispatch_config,
)
from iwae_replication_project_tpu_torch.serving.batcher import (
    EngineOverloaded,
    InflightWindow,
    MicroBatcher,
    Request,
    RequestTimeout,
    complete_future,
)
from iwae_replication_project_tpu_torch.serving.buckets import (
    BucketLadder,
    as_row,
    as_rows,
    validate_adaptive_target,
    validate_k,
    validate_model,
)
from iwae_replication_project_tpu_torch.serving.faults import (
    SITE_ENGINE_FETCH,
    SITE_ENGINE_LAUNCH,
)
from iwae_replication_project_tpu_torch.serving.metrics import ServingMetrics
from iwae_replication_project_tpu_torch.serving.programs import (
    PROGRAMS,
    draw_noise,
    program_bytes,
    static_cost,
)
from iwae_replication_project_tpu_torch.telemetry.spans import span
from iwae_replication_project_tpu_torch.utils import compile_cache as cc
from iwae_replication_project_tpu_torch.utils.device import resolve_device
from iwae_replication_project_tpu_torch.utils.dtypes import validate_precision
from iwae_replication_project_tpu_torch.utils.faults import fault_point
from iwae_replication_project_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
)

__all__ = ["ServingEngine", "EngineOverloaded", "RequestTimeout"]

#: default per-request k admission bound; a k above it is a typed bad
#: request (ValueError) at submit
DEFAULT_K_MAX = 1024


@dataclasses.dataclass
class _InFlight:
    """One launched-but-uncompleted batch riding the in-flight window."""

    batch: List[Request]
    op: str
    k: int
    bucket: int
    out: torch.Tensor                  # device result, maybe still computing
    event: Optional[Any] = None        # torch.cuda.Event after the launch
    #: the launched input tensors, kept alive until the batch completes
    inputs: tuple = ()
    #: the executable-store pin held until the batch completes
    pin: Optional[Any] = None
    #: the profiler's timing event recorded before the program's call (on
    #: the card, with profiling on)
    start: Optional[Any] = None
    #: trace-stage clock readings: the launch began, the rows were padded,
    #: the program's arguments were staged
    t_launch0: float = 0.0
    t_pad: float = 0.0
    t_args: float = 0.0


class ServingEngine:
    """Typed online-inference API over one model's weights on one device.

    The weights come from ``source`` -- a checkpoint run directory of the
    driver (``<checkpoint_dir>/<run_name>``, served at its stored training
    k) or a compiled ``api.FlexibleModel`` (a snapshot of its weights) --
    or from ``params=`` (the port's parameter tree; see :mod:`..convert`
    for the JAX package's) and ``model_config=``. Knobs: ``k`` (default
    importance samples per score/encode request, 50), ``k_max`` (per-request
    admission bound, default ``max(1024, k)``), ``max_batch``/``max_wait_us``
    (coalescing; the shape buckets are the powers of two up to max_batch,
    or ``ladder``'s rungs), ``queue_limit`` (shed bound), ``max_inflight``
    (launched
    but uncompleted batches; 0 = serial), ``timeout_s`` (per-request queue
    deadline; None disables), ``seed`` (the engine seed every row generator
    mixes in), ``kernel_path`` (None = the CUDA kernel on the card, the
    plain version on the CPU; ``"kernel"`` or ``"reference"`` pins one for
    every score dispatch), ``model`` (tenant label; a submit naming another
    model is a bad request), ``precision`` (None, ``"fp32"`` or ``"bf16"``:
    bf16 matmul operands with fp32 accumulation), ``device`` (None =
    ``cuda``, which must exist; pass ``"cpu"`` to serve on the CPU) and
    ``profiling`` (module docstring).
    """

    #: ops whose program runs the hot-loop block and is therefore gated
    _GATED_OPS: Tuple[str, ...] = ("score",)
    #: ops whose program takes an accuracy target: their k is the cap and
    #: their submits go through ``validate_adaptive_target``; none here
    #: (the sharded engine registers ``score_adaptive``)
    _ADAPTIVE_OPS: Tuple[str, ...] = ()
    #: the trace span of :meth:`_dispatch_args`'s window (module docstring)
    _ARGS_SPAN = "engine/noise"

    def __init__(self, source=None, *, params=None, model_config=None,
                 k: Optional[int] = None, k_max: Optional[int] = None,
                 max_batch: int = 64, max_wait_us: float = 2000.0,
                 queue_limit: int = 1024, max_inflight: int = 2,
                 timeout_s: Optional[float] = 2.0,
                 ladder: Optional[BucketLadder] = None, seed: int = 0,
                 kernel_path: Optional[str] = None,
                 model: Optional[str] = None,
                 precision: Optional[str] = None,
                 device=None, profiling=None):
        self.device = resolve_device(device)
        if isinstance(source, (str, os.PathLike)):
            params, model_config, stored_k = _load_checkpoint(
                os.fspath(source))
            if k is None:
                k = stored_k  # serve at the k the model trained under
        elif source is not None:
            if getattr(source, "state", None) is None or \
                    not hasattr(source, "cfg"):
                raise ValueError(
                    "source must be a compiled FlexibleModel (call "
                    ".compile() first) or a checkpoint run directory")
            params = tree_map(lambda t: t.detach().clone(), source.params)
            model_config = source.cfg
        if params is None or model_config is None:
            raise ValueError("pass a checkpoint run directory, a compiled "
                             "FlexibleModel, or params= + model_config=")
        self.precision = validate_precision(precision) \
            if precision is not None else None
        self.cfg = dataclasses.replace(model_config, fused_likelihood=False,
                                       hot_loop_path=None)
        if self.precision == "bf16":
            self.cfg = dataclasses.replace(self.cfg, compute_dtype="bfloat16")
        elif self.precision == "fp32":
            self.cfg = dataclasses.replace(self.cfg, compute_dtype=None)
        if kernel_path not in (None, "kernel", "reference"):
            raise ValueError(f"kernel_path={kernel_path!r}: expected None | "
                             f"kernel | reference")
        if kernel_path == "kernel" and self.device.type != "cuda":
            raise ValueError("kernel_path='kernel' needs a CUDA device")
        self.kernel_path = kernel_path
        #: (op, stamp k, bucket) -> (dispatch cfg, path): the gate's memo
        self._kernel_cache: Dict[tuple, tuple] = {}
        self.model = str(model) if model is not None else None
        self.models = frozenset({self.model}) if self.model else None
        self.k = int(k) if k is not None else 50
        if k_max is not None and int(k_max) < self.k:
            raise ValueError(f"k_max={int(k_max)} is below this engine's "
                             f"default k={self.k}")
        self.k_max = int(k_max) if k_max is not None \
            else max(DEFAULT_K_MAX, self.k)
        #: whether this engine runs the mesh-sharded large-k path (the
        #: replica router's classification bit)
        self.sharded = False
        #: the router's capability bit: this engine takes submit(trace=)
        #: and records its pipeline stages as spans
        self.traces = True
        #: op -> (program, takes k?); subclasses swap programs here
        self._programs: Dict[str, tuple] = dict(PROGRAMS)
        self.timeout_s = timeout_s
        self.ladder = ladder or BucketLadder.powers_of_two(max_batch)
        max_batch = self.ladder.max_batch
        self.metrics = ServingMetrics(model=self.model,
                                      precision=self.precision)
        self.profiler = None
        if profiling is not False:
            from iwae_replication_project_tpu_torch.telemetry import (
                profiling as prof)
            prof_cfg = profiling \
                if isinstance(profiling, prof.ProfilingConfig) \
                else prof.ProfilingConfig()
            if prof_cfg.enabled:
                self.profiler = prof.DispatchProfiler(
                    registry=self.metrics.registry, config=prof_cfg,
                    label=self.store_label,
                    peaks=prof.detect_chip_peaks(self.device))
        self._clock = time.monotonic
        self._batcher = MicroBatcher(max_batch=max_batch,
                                     max_wait_us=max_wait_us,
                                     queue_limit=queue_limit,
                                     clock=self._clock)
        self._params = to_device(params, self.device)
        #: the weights' identity in the store's keys: a captured graph
        #: reads the tensors at these addresses
        self._weights_key = tuple(t.data_ptr()
                                  for t in tree_leaves(self._params))
        #: whether this engine's store entries are captured CUDA graphs
        self._graphs = self.device.type == "cuda"
        self._stream = None
        if self.device.type == "cuda":
            # every launch runs on this side stream; it first waits for the
            # parameter copies queued on the current stream
            self._stream = torch.cuda.Stream(device=self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._base_seed = int(seed)
        self._seed_counter = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        if max_inflight < 0:
            raise ValueError(f"max_inflight must be >= 0, got {max_inflight}")
        self.max_inflight = int(max_inflight)
        self._window: Optional[InflightWindow] = None
        self._completion_thread: Optional[threading.Thread] = None
        self._completion_stop = threading.Event()
        #: op -> required payload feature count
        self.row_dims = {
            "score": self.cfg.x_dim,
            "encode": self.cfg.x_dim,
            "decode": self.cfg.n_latent_enc[-1],
        }
        # the gate resolves here, so a kernel pin it refuses fails
        # construction, not the first dispatch
        for op in self._GATED_OPS:
            self._kernel_for(op)

    # ------------------------------------------------------------------
    # request API
    # ------------------------------------------------------------------

    def submit(self, op: str, row, k: Optional[int] = None, *,
               seed: Optional[int] = None,
               model: Optional[str] = None,
               trace=None,
               target_se: Optional[float] = None,
               ess_floor: Optional[float] = None) -> Future:
        """Enqueue ONE example; returns its Future. Raises
        :class:`EngineOverloaded` when the queue bound is hit.

        ``trace`` (a :class:`~..telemetry.tracing.TraceContext`) records the
        request's pipeline stages as its child spans at completion (module
        docstring); it never touches seeds, payloads or shapes.

        ``seed`` overrides the engine's per-request seed counter (a result
        is a pure function of weights, payload, seed and k, so a retry with
        the original seed returns the same result). For an adaptive op
        ``k`` is the cap and ``target_se``/``ess_floor`` the target
        (``validate_adaptive_target``); a target on a fixed-k op is a typed
        bad request. The queue drains only when something pumps it:
        :meth:`start`, :meth:`flush` or a blocking helper."""
        if op not in self._programs:
            raise ValueError(f"unknown op {op!r}; choose "
                             f"{sorted(self._programs)}")
        if model is not None:
            validate_model(model, self.models or ())
        _, takes_k = self._programs[op]
        if op in self._ADAPTIVE_OPS:
            target_se, ess_floor, k = validate_adaptive_target(
                target_se, ess_floor, self.k if k is None else k, self.k_max)
        elif target_se is not None or ess_floor is not None:
            raise ValueError(
                f"target_se/ess_floor only apply to adaptive ops "
                f"({sorted(self._ADAPTIVE_OPS)}); {op!r} is fixed-k: use "
                f"score_adaptive for accuracy-targeted scoring")
        else:
            target_se = ess_floor = 0.0
            k = validate_k(self.k if k is None else k, self.k_max) \
                if takes_k else 0
        row = as_row(row, self.row_dims[op], op)
        now = self._clock()
        if seed is not None and not 0 <= int(seed) < 2 ** 31:
            raise ValueError(f"seed must be in [0, 2**31), got {seed}")
        with self._cv:
            if seed is None:
                seed = self._seed_counter
                self._seed_counter = (self._seed_counter + 1) % (2 ** 31)
            req = Request(op=op, payload=row, k=k, seed=int(seed),
                          t_enqueue=now,
                          deadline=(now + self.timeout_s
                                    if self.timeout_s is not None else None),
                          trace=trace,
                          target_se=target_se, ess_floor=ess_floor)
            try:
                self._batcher.submit(req)
            except EngineOverloaded:
                self.metrics.count("shed")
                raise
            self.metrics.count("submitted")
            self.metrics.set_queue_depth(self._batcher.pending)
            self._cv.notify()
        return req.future

    def _blocking(self, op: str, x, k: Optional[int], **kw) -> np.ndarray:
        rows, single = as_rows(x)
        futures = [self.submit(op, r, k=k, **kw) for r in rows]
        if self._thread is None:
            self.flush()
        out = np.stack([f.result() for f in futures])
        return out[0] if single else out

    def score(self, x, k: Optional[int] = None) -> np.ndarray:
        """k-sample IWAE log p(x) per example (``[n]``, or a scalar for a
        single row). Blocks until served."""
        return self._blocking("score", x, k)

    def encode(self, x, k: Optional[int] = None) -> np.ndarray:
        """Posterior deepest-latent mean embedding per example."""
        return self._blocking("encode", x, k)

    def decode(self, h) -> np.ndarray:
        """Pixel probabilities decoded from deepest-latent rows."""
        return self._blocking("decode", h, None)

    def score_adaptive(self, x, k_cap: Optional[int] = None, *,
                       target_se: Optional[float] = None,
                       ess_floor: Optional[float] = None) -> np.ndarray:
        """Accuracy-targeted scoring: ``[n, 3]`` rows of ``(log p_hat,
        achieved se, k_used)`` (``[3]`` for a single row), each row stopped
        at the first prefix of its sample stream meeting ``target_se``
        and/or ``ess_floor``, capped at ``k_cap``. Blocks until served;
        only engines registering the adaptive op (the sharded scorer)
        accept it."""
        return self._blocking("score_adaptive", x, k_cap,
                              target_se=target_se, ess_floor=ess_floor)

    # ------------------------------------------------------------------
    # dispatch machinery
    # ------------------------------------------------------------------

    def flush(self) -> int:
        """Drain the queue inline; returns the number of dispatches."""
        n = 0
        while True:
            with self._cv:
                expired, batches = self._batcher.poll(force=True)
                self.metrics.set_queue_depth(self._batcher.pending)
            self._complete_expired(expired)
            if not batches:
                return n
            for batch in batches:
                self._dispatch(batch)
                n += 1

    def start(self) -> "ServingEngine":
        """Spawn the background pipeline (idempotent): the dispatcher thread,
        plus the completion thread when ``max_inflight >= 1``."""
        if self._thread is None:
            self._stop_evt.clear()
            self._completion_stop.clear()
            if self.max_inflight >= 1:
                self._window = InflightWindow(
                    self.max_inflight, on_change=self.metrics.set_inflight)
                self._completion_thread = threading.Thread(
                    target=self._completion_loop,
                    name="iwae-serve-complete", daemon=True)
                self._completion_thread.start()
            self._thread = threading.Thread(target=self._loop,
                                            name="iwae-serve-dispatch",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the pipeline, draining everything: queued requests are still
        dispatched and every in-flight batch completes before the threads
        are joined."""
        if self._thread is not None:
            self._stop_evt.set()
            with self._cv:
                self._cv.notify_all()
            if self._window is not None:
                self._window.wake()
            self._thread.join()
            self._thread = None
        if self._completion_thread is not None:
            self._completion_stop.set()
            self._window.wake()
            self._completion_thread.join()
            self._completion_thread = None
            self._window = None
        self.flush()

    def _loop(self) -> None:
        pipelined = self._window is not None
        while not self._stop_evt.is_set():
            with self._cv:
                expired, batches = self._batcher.poll()
                self.metrics.set_queue_depth(self._batcher.pending)
                if not batches and not expired:
                    nxt = self._batcher.next_event()
                    wait = None if nxt is None \
                        else max(nxt - self._clock(), 1e-4)
                    self._cv.wait(timeout=wait)
                    continue
            self._complete_expired(expired)
            for batch in batches:
                if pipelined:
                    # backpressure before the launch: block while
                    # max_inflight batches are outstanding
                    self._window.acquire(abort=self._stop_evt.is_set)
                    inf = self._launch_routed(batch)
                    if inf is None:
                        self._window.release()
                    else:
                        self._window.commit(inf)
                else:
                    self._dispatch(batch)

    def _completion_loop(self) -> None:
        while True:
            inf = self._window.pop(stop=self._completion_stop.is_set)
            if inf is None:
                return
            self._finish(inf)
            self._window.done()

    _complete = staticmethod(complete_future)

    def _complete_expired(self, expired: List[Request]) -> None:
        for r in expired:
            self.metrics.count("timeouts")
            self._complete(r.future, exc=RequestTimeout(
                f"{r.op} request expired after {self.timeout_s}s in queue "
                f"(engine saturated — shed load or raise timeout_s)"))

    # -- the hooks a subclass overrides ---------------------------------

    def _kernel_for(self, op: str, k: Optional[int] = None,
                    bucket: Optional[int] = None) -> tuple:
        """``(dispatch cfg, path name)`` of one dispatch (None: the engine's
        k, the largest bucket): the gate's resolution, memoized per (op,
        :meth:`_stamp_k`, bucket)."""
        k = self.k if k is None else k
        bucket = self.ladder.max_batch if bucket is None else bucket
        key = (op, self._stamp_k(op, k), bucket)
        hit = self._kernel_cache.get(key)
        if hit is None:
            hit = self._kernel_cache[key] = self._resolve_kernel(op, k,
                                                                 bucket)
        return hit

    def _resolve_kernel(self, op: str, k: int, bucket: int) -> tuple:
        """The serving gate's choice: gated ops run the CUDA kernel on the
        card for logits models (the plain composition otherwise; the port's
        gate needs no shape); the others never touch the decoder block.
        Every program on the card takes the row-invariant ops."""
        return serving_dispatch_config(self.cfg, device=self.device,
                                       force=self.kernel_path,
                                       gated=op in self._GATED_OPS)

    def _stamp_k(self, op: str, k: int):
        """The k of the metrics kernel stamp and the gate's memo: the
        request k for static-k programs (the sharded engine stamps one
        ``"dyn"`` per bucket)."""
        return k

    def _program_for(self, op: str, k: int, bucket: int):
        """The program of one dispatch."""
        return self._programs[op][0]

    def _dispatch_args(self, op: str, k: int, bucket: int,
                       payload: np.ndarray, seeds: List[int],
                       targets: Optional[Tuple[float, float]] = None,
                       n_real: Optional[int] = None) -> Tuple[tuple, dict]:
        """``(args, kwargs)`` of one program call, made on the launch
        stream: the batch's noise drawn on the host, payload and noise
        copied to the device. ``targets`` and ``n_real`` serve adaptive
        ops (none here)."""
        cfg, _ = self._kernel_for(op, k, bucket)
        _, takes_k = self._programs[op]
        noise = draw_noise(cfg, op, self._base_seed, seeds, k)
        x = torch.from_numpy(payload).to(self.device, non_blocking=True)
        noise = [t.to(self.device, non_blocking=True) for t in noise]
        args = (self._params, cfg, self._base_seed, seeds, x)
        return (args + (k,) if takes_k else args), {"noise": noise}

    @property
    def store_label(self) -> Optional[str]:
        """The executable-store tenant label of this engine's programs: the
        model name, ``@precision``-suffixed under a precision policy, so
        (model, precision) variants hold distinct entries (JAX
        serving/engine.py:690-699)."""
        if self.precision is None:
            return self.model
        return f"{self.model or 'default'}@{self.precision}"

    def _aot_name(self, op: str) -> str:
        """The store's and the fault sites' name of the op's program."""
        return f"serve_{op}"

    def _build_key(self, op: str, k: int, bucket: int) -> tuple:
        """Everything a program bakes in: the stamp k, the bucket, the
        dispatch config and the weights' identity."""
        cfg, _ = self._kernel_for(op, k, bucket)
        return (self._stamp_k(op, k), bucket, cfg, self._weights_key)

    def _program_nbytes(self, op: str, k: int, bucket: int) -> int:
        cfg, _ = self._kernel_for(op, k, bucket)
        return program_bytes(cfg, op, k, bucket)

    def _entry(self, op: str, k: int, bucket: int, program, args: tuple,
               kwargs: dict) -> tuple:
        """``(fn, args, kwargs, signature args, graph?)`` of a dispatch's
        store entry: the program over its payload and noise alone (the
        weights, config, k and bucket are in the key), captured on the
        card."""
        cfg, _ = self._kernel_for(op, k, bucket)
        params, base = self._params, self._base_seed
        extra = (k,) if self._programs[op][1] else ()
        pad_seeds = [0] * bucket     # unused: the noise is given

        def fn(x, *noise):
            return program(params, cfg, base, pad_seeds, x, *extra,
                           noise=list(noise))
        tensors = (args[4],) + tuple(kwargs["noise"])
        return fn, tensors, {}, tensors, self._graphs

    def _store_call(self, op: str, k: int, bucket: int, program,
                    args: tuple, kwargs: dict, warm: bool = False):
        """The dispatch's program through the executable store: ``(output,
        hit)``; with ``warm`` the entry is admitted (a captured graph runs
        its first admission's warm-up; an eager entry runs once) and
        ``(None, hit)`` returned."""
        fn, call_args, fn_kwargs, sig_args, graph = self._entry(
            op, k, bucket, program, args, kwargs)
        kw = dict(build_key=self._build_key(op, k, bucket),
                  model=self.store_label,
                  nbytes=self._program_nbytes(op, k, bucket), graph=graph,
                  sig=cc.signature(sig_args))
        if warm:
            with cc.executable_store().pinned(self.store_label,
                                              self._aot_name(op),
                                              kw["build_key"]):
                exe, hit = cc.aot_warm(self._aot_name(op), fn, call_args,
                                       fn_kwargs, **kw)
                if not graph:
                    exe(*call_args, **fn_kwargs)
            return None, hit
        return cc.aot_call_async(self._aot_name(op), fn, call_args,
                                 fn_kwargs, **kw)

    def _launch_context(self):
        """The card and the engine's side stream (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _run(self, op: str, k: int, bucket: int, payload: np.ndarray,
             seeds: List[int], targets: Optional[Tuple[float, float]] = None,
             n_real: Optional[int] = None):
        """Launch one program on the device without waiting; returns
        ``(out, event, inputs, t_args, hit, start)``, ``t_args`` the clock
        once the arguments were staged (the trace's noise/launch boundary),
        ``hit`` whether the store had the program, ``start`` the profiler's
        timing event before the program's call (None off the card or with
        profiling off)."""
        program = self._program_for(op, k, bucket)
        timed = self.profiler is not None and self._stream is not None
        with self._launch_context():
            args, kwargs = self._dispatch_args(op, k, bucket, payload, seeds,
                                               targets, n_real)
            t_args = self._clock()
            start = None
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._stream)
            out, hit = self._store_call(op, k, bucket, program, args, kwargs)
            if self._stream is None:
                return out, None, (), t_args, hit, None
            event = torch.cuda.Event(enable_timing=timed)
            event.record(self._stream)
        return out, event, (args, kwargs), t_args, hit, start

    def _launch(self, batch: List[Request]) -> _InFlight:
        """Stage one: pad, launch. Returns the in-flight handle without
        synchronizing (the adaptive op's per-round test excepted)."""
        op, k = batch[0].op, batch[0].k
        targets = (batch[0].target_se, batch[0].ess_floor) \
            if op in self._ADAPTIVE_OPS else None
        n = len(batch)
        # a raise here is the replica-crash signal: it lands in exactly
        # this batch's futures (_launch_routed)
        fault_point(SITE_ENGINE_LAUNCH, engine=self, op=op, k=k, batch=n)
        # trace-stage clock readings, stamped for every batch: the spans
        # are assembled at completion, and only for traced requests
        t_launch0 = self._clock()
        bucket = self.ladder.bucket_for(n)
        payload = self.ladder.pad_rows(
            np.stack([r.payload for r in batch]), bucket)
        seeds = [r.seed for r in batch] + [0] * (bucket - n)
        _, path = self._kernel_for(op, k, bucket)
        self.metrics.set_kernel(op, self._stamp_k(op, k), bucket,
                                PATH_CODES[path], path)
        t_pad = self._clock()
        builds = cc.kernel_builds()
        # the dispatch's store entry stays pinned until the batch completes:
        # a budget squeeze never evicts a program the card is running
        pin = cc.executable_store().pin_prefix(
            self.store_label, self._aot_name(op), self._build_key(op, k,
                                                                  bucket))
        try:
            with span(f"serve/dispatch/{op}", registry=self.metrics.registry):
                out, event, inputs, t_args, hit, start = self._run(
                    op, k, bucket, payload, seeds, targets, n)
        except BaseException:
            pin.release()
            raise
        t_disp = self._clock()
        for r in batch:
            r.t_dispatch = t_disp
        self.metrics.count("dispatches")
        self.metrics.count("real_rows", n)
        self.metrics.count("padded_rows", bucket - n)
        self.metrics.count("aot_hits" if hit else "aot_misses")
        self.metrics.count("recompiles", cc.kernel_builds() - builds)
        return _InFlight(batch=batch, op=op, k=k, bucket=bucket, out=out,
                         event=event, inputs=inputs, pin=pin, start=start,
                         t_launch0=t_launch0, t_pad=t_pad, t_args=t_args)

    def _launch_routed(self, batch: List[Request]) -> Optional[_InFlight]:
        """:meth:`_launch` with failure routing: an exception lands in
        exactly this batch's futures, never in the dispatcher thread."""
        try:
            return self._launch(batch)
        except Exception as e:
            for r in batch:
                self.metrics.count("errors")
                self._complete(r.future, exc=e)
            return None

    def _fetch(self, inf: _InFlight) -> np.ndarray:
        """The pipeline's one blocking device-to-host transfer: wait for the
        batch's event, then copy. Asynchronous device faults surface here."""
        if inf.event is not None:
            inf.event.synchronize()
            with torch.cuda.device(self.device):
                return inf.out.cpu().numpy()
        return inf.out.numpy()

    def _prof_flops(self, op: str, k: int, rows: int) -> Optional[float]:
        """Analytic matmul FLOPs of one dispatch's real rows (the measured
        MFU's numerator, ``utils/flops.py``). Only ``score`` runs the stack
        the accounting models; other ops profile device time without an
        MFU gauge."""
        if op != "score":
            return None
        from iwae_replication_project_tpu_torch.utils.flops import (
            serving_score_flops_per_row)
        return serving_score_flops_per_row(self.cfg, k) * rows

    def _static_cost_for(self, op: str, k: int, bucket: int
                         ) -> Optional[dict]:
        """This dispatch shape's static cost record
        (``serving/programs.static_cost``); None for an adaptive op, whose
        work depends on its rows."""
        if op in self._ADAPTIVE_OPS:
            return None
        return static_cost(self.cfg, op, k, bucket)

    def _prof_adaptive(self, inf: _InFlight, out: np.ndarray):
        """``(flops, total k_used)`` of an adaptive dispatch from the
        fetched rows, or None for fixed-k ops (none here)."""
        return None

    def _device_seconds(self, inf: _InFlight, now: float) -> float:
        """The dispatch's device interval (module docstring): the timing
        events' on the card, else the host's from the store call to the
        fetched result."""
        if inf.start is not None:
            return inf.start.elapsed_time(inf.event) / 1e3
        return now - inf.t_args

    def _profile_dispatch(self, inf: _InFlight, now: float,
                          out: np.ndarray) -> None:
        """One profiler observation per dispatch, at its (program, bucket,
        k-class) key."""
        flops = self._prof_flops(inf.op, inf.k, len(inf.batch))
        samples = None
        adaptive = self._prof_adaptive(inf, out)
        if adaptive is not None:
            flops, samples = adaptive
        self.profiler.observe(
            program=self._aot_name(inf.op), bucket=inf.bucket,
            k_class=self._stamp_k(inf.op, inf.k), rows=len(inf.batch),
            device_s=self._device_seconds(inf, now), flops=flops,
            cost=self._static_cost_for(inf.op, inf.k, inf.bucket),
            samples=samples)

    def _trace_attrs(self, op: str, k: int, bucket: int, n: int) -> dict:
        """Attrs of a traced dispatch's ``engine/dispatch`` span (the
        sharded engine adds its block shape)."""
        return {"op": op, "k": k, "bucket": bucket, "batch": n,
                "path": self._kernel_for(op, k, bucket)[1]}

    def _emit_trace_spans(self, inf: _InFlight, t_fetch0: float,
                          now: float, error: Optional[str] = None) -> None:
        """The pipeline-stage spans of this batch's traced requests, from
        the clock readings the hot path stamped (module docstring)."""
        traced = [r for r in inf.batch if r.trace is not None]
        if not traced:
            return
        from iwae_replication_project_tpu_torch.telemetry.tracing import (
            emit_span, start_span)

        attrs = self._trace_attrs(inf.op, inf.k, inf.bucket, len(inf.batch))
        for r in traced:
            ctx = r.trace
            t_disp = r.t_dispatch if r.t_dispatch is not None \
                else inf.t_args
            emit_span(ctx, "engine/queue", r.t_enqueue, inf.t_launch0)
            emit_span(ctx, "engine/pad", inf.t_launch0, inf.t_pad)
            dispatch = start_span("engine/dispatch", ctx=ctx, attrs=attrs,
                                  t_start=inf.t_pad)
            emit_span(dispatch.ctx(), self._ARGS_SPAN, inf.t_pad, inf.t_args)
            emit_span(dispatch.ctx(), "engine/launch", inf.t_args, t_disp)
            dispatch.finish(t_end=t_disp)
            if r.t_dispatch is not None:
                emit_span(ctx, "engine/device", r.t_dispatch, t_fetch0)
            emit_span(ctx, "engine/fetch", t_fetch0, now, error=error)

    def _finish(self, inf: _InFlight) -> None:
        """Stage two: fetch, slice padding, complete this batch's futures."""
        t_fetch0 = self._clock()
        try:
            with span(f"serve/complete/{inf.op}",
                      registry=self.metrics.registry):
                # a raise here models a deferred device failure
                fault_point(SITE_ENGINE_FETCH, engine=self, op=inf.op)
                out = self._fetch(inf)
        except Exception as e:
            if inf.pin is not None:
                inf.pin.release()
            self._emit_trace_spans(inf, t_fetch0, self._clock(),
                                   error="internal")
            for r in inf.batch:
                self.metrics.count("errors")
                self._complete(r.future, exc=e)
            return
        if inf.pin is not None:
            # the batch is complete: its program may be evicted again
            inf.pin.release()
        now = self._clock()
        if self.profiler is not None:
            self._profile_dispatch(inf, now, out)
        self._emit_trace_spans(inf, t_fetch0, now)
        for i, r in enumerate(inf.batch):
            self.metrics.record_latency(inf.op, inf.bucket, now - r.t_enqueue)
            if r.t_dispatch is not None:
                self.metrics.record_queue_wait(inf.op, inf.bucket,
                                               r.t_dispatch - r.t_enqueue)
                self.metrics.record_device_wait(inf.op, inf.bucket,
                                                now - r.t_dispatch)
            if self._complete(r.future, result=out[i]):
                self.metrics.count("completed")

    def _dispatch(self, batch: List[Request]) -> None:
        """Serial dispatch: launch, then fetch and complete on this thread."""
        inf = self._launch_routed(batch)
        if inf is not None:
            self._finish(inf)

    # ------------------------------------------------------------------
    # warmup
    # ------------------------------------------------------------------

    def warmup(self, ops: Sequence[str] = ("score", "encode", "decode")
               ) -> Dict[str, float]:
        """Admit every (op, bucket) of the ladder at the engine's k into the
        executable store (zero payloads; an adaptive op with its targets
        off), so the kernels are built and every first request is a store
        hit: on the card each program's first admission runs it once and
        captures its graph, an eager entry runs once. Returns
        ``{"programs": N, "captures": C, "builds": B, "seconds": S}``: C
        the programs the store did not hold, B the kernel builds it took (a
        replica joining over resident programs: 0 and 0)."""
        with span("serve/warmup", registry=self.metrics.registry):
            return self._warmup(ops)

    def _warmup(self, ops: Sequence[str]) -> Dict[str, float]:
        b0 = cc.kernel_builds()
        t0 = time.perf_counter()
        n_programs = captures = 0
        for op in ops:
            if op not in self._programs:
                raise ValueError(f"unknown op {op!r}")
            _, takes_k = self._programs[op]
            k = self.k if takes_k else 0
            targets = (0.0, 0.0) if op in self._ADAPTIVE_OPS else None
            for bucket in self.ladder.buckets:
                payload = np.zeros((bucket, self.row_dims[op]), np.float32)
                program = self._program_for(op, k, bucket)
                with self._launch_context():
                    args, kwargs = self._dispatch_args(
                        op, k, bucket, payload, [0] * bucket, targets,
                        bucket)
                    _, hit = self._store_call(op, k, bucket, program, args,
                                              kwargs, warm=True)
                if self._stream is not None:
                    self._stream.synchronize()
                captures += not hit
                _, path = self._kernel_for(op, k, bucket)
                self.metrics.set_kernel(op, self._stamp_k(op, k), bucket,
                                        PATH_CODES[path], path)
                n_programs += 1
        _, path = self._kernel_for(self._GATED_OPS[0], self.k,
                                   self.ladder.buckets[0])
        self.metrics.registry.gauge("kernel_path").set(
            float(PATH_CODES[path]))
        return {"programs": float(n_programs), "captures": float(captures),
                "builds": float(cc.kernel_builds() - b0),
                "seconds": round(time.perf_counter() - t0, 3)}


def _load_checkpoint(run_dir: str):
    """``(params, ModelConfig, trained k)`` of a driver checkpoint run
    directory (``<checkpoint_dir>/<run_name>``): the architecture from the
    stored config JSON of the newest intact step, the weights restored from
    that step, on the host."""
    from iwae_replication_project_tpu_torch.models.iwae import init_params
    from iwae_replication_project_tpu_torch.utils.checkpoint import (
        restore_latest_params,
        stored_config_json,
    )
    from iwae_replication_project_tpu_torch.utils.config import (
        ExperimentConfig,
    )

    cfg_json = stored_config_json(run_dir)
    if cfg_json is None:
        raise FileNotFoundError(
            f"no checkpoint (or no stored config) under {run_dir!r}: pass "
            f"the run directory the driver writes, "
            f"<checkpoint_dir>/<run_name>")
    ecfg = ExperimentConfig.from_json(cfg_json)
    model_cfg = ecfg.model_config("cpu")
    params = init_params(torch.Generator().manual_seed(ecfg.seed), model_cfg)
    if restore_latest_params(run_dir, params) is None:
        raise FileNotFoundError(f"no restorable checkpoint under "
                                f"{run_dir!r}")
    return params, model_cfg, ecfg.k
