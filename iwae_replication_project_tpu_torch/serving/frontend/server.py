"""The TCP front end: admission control over the replica router (port of
``serving/frontend/server.py``).

``ServingTier`` binds a listening socket and speaks the JSON-lines
protocol (protocol.py): one daemon accept thread, one daemon thread per
connection, responses completed out-of-order via future callbacks under a
per-connection write lock. The request path per line is::

    parse -> control op? (info: answered here)
          -> global ceiling + per-client token bucket  (admission)
          -> one router.submit per payload row          (routing)
          -> response written when the last row lands   (completion)

Admission failures are typed *responses* (protocol.ERROR_CODES) — a
rejected request never drops the connection. Client identity stops at the
quota check: nothing client-derived flows into the router or the engines,
so per-client state can never reach a program.

Shutdown (:meth:`stop`) is a graceful drain: the listener closes first
(no new connections), the router drains every replica via
``engine.stop()``, each connection finishes writing its pending responses,
and only then do the sockets close — zero accepted requests go
unanswered. Requests arriving mid-drain get typed ``unavailable``
responses.

The tier is transport only: batching, padding and launches live in the
replica engines, routing and health in router.py; this module imports no
torch and is exercised by tests over localhost sockets.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

from iwae_replication_project_tpu_torch.serving.buckets import (
    validate_adaptive_target,
    validate_k,
)
from iwae_replication_project_tpu_torch.serving.faults import SITE_TIER_WRITE
from iwae_replication_project_tpu_torch.serving.frontend import protocol
from iwae_replication_project_tpu_torch.serving.frontend.quotas import (
    ClientQuotas,
    QuotaExceeded,
    QuotaPolicy,
)
from iwae_replication_project_tpu_torch.serving.frontend.router import (
    ReplicaRouter,
)
from iwae_replication_project_tpu_torch.utils.dtypes import (
    validate_precision,
)
from iwae_replication_project_tpu_torch.utils.faults import fault_point

__all__ = ["ServingTier"]


class _Pending:
    """One in-flight request's per-row completion state (guarded by the
    owning connection's lock)."""

    __slots__ = ("req_id", "results", "remaining", "error", "op", "model",
                 "t_start", "span")

    def __init__(self, req_id: Any, n_rows: int, op: Optional[str] = None,
                 model: Optional[str] = None, t_start: float = 0.0,
                 span=None):
        self.req_id = req_id
        self.results: List[Any] = [None] * n_rows
        self.remaining = n_rows
        self.error: Optional[BaseException] = None
        # observability state: the request's op/model/admission time (SLO
        # accounting) and its tier request span (trace tree root-or-child)
        self.op = op
        self.model = model
        self.t_start = t_start
        self.span = span


class _Connection:
    """One client connection: a blocking read loop plus callback-driven
    response writes. All mutable state (pending map, closed flag) and the
    socket write side live under ONE lock; the read loop never holds it."""

    def __init__(self, tier: "ServingTier", sock: socket.socket, peer):
        self._tier = tier
        self._sock = sock
        self._peer = peer
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._pending = 0
        self._dead = False

    # -- writes (any thread) ------------------------------------------------

    def _write(self, obj: Dict[str, Any]) -> None:
        data = protocol.encode_line(obj)
        with self._lock:
            if self._dead:
                return
            # chaos hook, under the write lock so injected garbage/drops
            # are frame-aligned (deterministic runs); actions here touch
            # the socket only and never raise — the sendall below then
            # fails exactly like a real peer reset
            fault_point(SITE_TIER_WRITE, sock=self._sock, conn=self)
            try:
                self._sock.sendall(data)  # iwaelint: disable=blocking-call-under-lock -- the per-connection write lock IS the frame serializer: responses interleaving on one socket would corrupt the line protocol; a dead peer fails fast with OSError
            except OSError:
                # the client vanished; the response was produced — nothing
                # to deliver it to. Reads will fail and retire the loop.
                self._dead = True

    def _respond_error(self, req_id: Any, exc: BaseException) -> None:
        code = protocol.error_code_for(exc)
        # machine-readable back-off: the exception's own computed wait
        # (QuotaExceeded carries the exact refill time) beats the tier's
        # configured shed hint, which beats nothing
        hint = getattr(exc, "retry_after_s", None)
        if hint is None and code == "overloaded":
            hint = self._tier.shed_retry_after_s
        self._write(protocol.error_response(
            req_id, code, f"{type(exc).__name__}: {exc}",
            retry_after_s=hint))

    # -- request handling (read-loop thread + future callbacks) -------------

    def _row_done(self, pending: _Pending, i: int, fut) -> None:
        # the callback fires on an already-completed future, so exception()
        # and result() return immediately — but they are *blocking* calls
        # by contract, so both stay outside the connection lock
        exc = fut.exception()
        r = fut.result() if exc is None else None
        with self._lock:
            if exc is not None and pending.error is None:
                pending.error = exc
            elif exc is None:
                pending.results[i] = r.tolist() if hasattr(r, "tolist") else r
            pending.remaining -= 1
            finished = pending.remaining == 0
        if not finished:
            return
        code = None
        if pending.error is not None:
            code = protocol.error_code_for(pending.error)
            self._respond_error(pending.req_id, pending.error)
        else:
            self._write(protocol.ok_response(pending.req_id, pending.results))
        # observability AFTER the response write: the span's duration and
        # the SLO latency both cover the full request, response included
        self._tier.observe_request(pending.op, pending.model,
                                   pending.t_start, code, pending.span)
        with self._lock:
            self._pending -= 1
            self._idle.notify_all()

    def _handle(self, line: bytes) -> None:
        try:
            obj = protocol.decode_line(line)
        except protocol.ProtocolError as e:
            self._respond_error(None, e)
            return
        req_id = obj.get("id")
        op = obj.get("op")
        if op in protocol.CONTROL_OPS:
            doc = {"info": self._tier.info,
                   "stats": self._tier.stats,
                   "slo": self._tier.slo_doc}[op]() \
                if op != "traces" else self._tier.traces_doc(obj)
            self._write(protocol.ok_response(req_id, doc))
            return
        if op in protocol.JOB_OPS:
            # the bulk offline lane (jobs.py): job admission/status are
            # answered synchronously — the job's ROWS are pumped through
            # the router in the background, below interactive traffic.
            # Malformed job docs are typed bad_request responses and the
            # connection survives, like every other request.
            try:
                doc = self._tier.job_doc(op, obj)
            except Exception as e:
                self._respond_error(req_id, e)
                return
            self._write(protocol.ok_response(req_id, doc))
            return
        t_start = self._tier.clock()
        span = None
        model = None
        try:
            # trace context first: mint or accept (tier tracing on), but
            # VALIDATE unconditionally — a malformed/oversized trace field
            # is this request's typed bad_request whether or not the tier
            # records traces, and the connection survives it either way
            span = self._tier.open_request_span(obj.get("trace"), op,
                                                t_start)
            rows = _payload_rows(obj)
            client = obj.get("client")
            if client is not None and not isinstance(client, str):
                raise protocol.ProtocolError(
                    f"'client' must be a string, got "
                    f"{type(client).__name__}")
            model = obj.get("model")
            # the protocol surface of the typed unknown-model contract —
            # and the quota-lane resolution: a model-less request in an
            # all-labeled fleet resolves to the default model HERE, before
            # admission, so default and explicitly-named traffic meter
            # through the SAME (client, model) bucket
            try:
                model = self._tier.router.resolve_model(model)
            except ValueError as e:
                raise protocol.ProtocolError(str(e)) from None
            precision = obj.get("precision")
            if precision is not None:
                # the wire surface of the typed unknown-precision contract:
                # validate the vocabulary via the ONE shared
                # validator, then assert the fleet actually serves this
                # model at the asked-for numerics — a mismatch is this
                # request's typed bad_request, NEVER a silent serve at
                # whatever precision happens to be resident
                try:
                    validate_precision(precision)
                except ValueError as e:
                    raise protocol.ProtocolError(str(e)) from None
                held = self._tier.precisions_for(model)
                if precision not in held:
                    raise protocol.ProtocolError(
                        f"model {model!r} is not served at precision "
                        f"{precision!r} here; this fleet holds "
                        f"{sorted(held)}")
            k = obj.get("k")
            if k is not None:
                # the protocol surface of the typed out-of-range-k
                # contract: the ONE shared validator (buckets.validate_k,
                # type/positivity here; the fleet k_max range is the
                # router's synchronous ValueError — same typed code)
                try:
                    k = validate_k(k, 2 ** 31 - 1)
                except ValueError as e:
                    raise protocol.ProtocolError(str(e)) from None
            target_se = obj.get("target_se")
            ess_floor = obj.get("ess_floor")
            if target_se is not None or ess_floor is not None:
                # the wire surface of the adaptive-target contract: the ONE
                # shared validator (buckets.validate_adaptive_target —
                # type/positivity/reachability here; the fleet k_max cap
                # default is the router's synchronous ValueError, same
                # typed code). A malformed target is THIS request's
                # bad_request and the connection survives.
                try:
                    validate_adaptive_target(
                        target_se, ess_floor,
                        k if k is not None else 2 ** 31 - 1, 2 ** 31 - 1)
                except ValueError as e:
                    raise protocol.ProtocolError(str(e)) from None
            seed = obj.get("seed")
            if seed is not None:
                # the fleet-composition hook (protocol.py): one seed names
                # one row's RNG stream, so it only makes sense row-wise
                if not isinstance(seed, int) or isinstance(seed, bool):
                    raise protocol.ProtocolError(
                        f"'seed' must be an integer, got "
                        f"{type(seed).__name__}")
                if not 0 <= seed < 2 ** 31:
                    # seeds ride the engines' int32 seed tensor; an
                    # out-of-range value must die HERE as this client's
                    # bad_request, not inside a replica where it would
                    # error a whole coalesced batch and read as a
                    # replica failure
                    raise protocol.ProtocolError(
                        f"'seed' must be in [0, 2**31), got {seed}")
                if len(rows) != 1:
                    raise protocol.ProtocolError(
                        "'seed' applies to single-row payloads only")
            if span is not None:
                ann: Dict[str, Any] = {}
                if k is not None:
                    ann["k"] = k
                if target_se is not None:
                    ann["target_se"] = target_se
                if ess_floor is not None:
                    ann["ess_floor"] = ess_floor
                span.annotate(rows=len(rows), model=model, **ann)
            t_admit = self._tier.clock()
            self._tier.admit(client, len(rows), model=model)
            if span is not None:
                # quota admission as a timed child span (pre-timed emit:
                # zero tracing work inside the admission path itself)
                from iwae_replication_project_tpu_torch.telemetry.tracing \
                    import emit_span
                emit_span(span.ctx(), "tier/admit", t_admit,
                          self._tier.clock())
            pending = _Pending(req_id, len(rows), op=op, model=model,
                               t_start=t_start, span=span)
            with self._lock:
                self._pending += 1
            futures = []
            try:
                ctx = span.ctx() if span is not None else None
                kw: Dict[str, Any] = {}
                # forward adaptive targets only when the client set them —
                # the plain-op call shape is unchanged (fake routers in
                # tests keep their historical signatures)
                if target_se is not None:
                    kw["target_se"] = target_se
                if ess_floor is not None:
                    kw["ess_floor"] = ess_floor
                for row in rows:
                    futures.append(
                        self._tier.router.submit(op, row, k=k, seed=seed,
                                                 model=model, trace=ctx,
                                                 **kw))
            except Exception:
                # partial admission: rows already routed complete and are
                # discarded; the request as a unit gets the typed error —
                # and its full quota cost back (the client pays for served
                # requests, not for shed/rejected ones)
                self._tier.refund(client, len(rows), model=model)
                with self._lock:
                    self._pending -= 1
                    self._idle.notify_all()
                raise
            for i, f in enumerate(futures):
                f.add_done_callback(
                    lambda fut, i=i, p=pending: self._row_done(p, i, fut))
        except Exception as e:
            self._respond_error(req_id, e)
            self._tier.observe_request(op, model, t_start,
                                       protocol.error_code_for(e), span)

    def serve(self) -> None:
        """The read loop (own daemon thread): handle lines until EOF or a
        socket error, then wait for pending responses to flush and close."""
        reader = protocol.LineReader(self._sock)
        try:
            while True:
                try:
                    line = reader.next_line()
                except (protocol.ProtocolError, OSError):
                    break
                if line is None:
                    break
                if line.strip():
                    self._handle(line)
        finally:
            self.flush(timeout_s=60.0)
            self.close()
            self._tier._forget(self)

    def flush(self, timeout_s: float) -> bool:
        """Wait until every accepted request on this connection has been
        answered (the drain contract). Returns False on timeout."""
        with self._idle:
            return self._idle.wait_for(lambda: self._pending == 0,
                                       timeout=timeout_s)

    def close(self) -> None:
        with self._lock:
            self._dead = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            # best-effort shutdown of a possibly already-dead peer socket;
            # close() below is the real teardown
            pass
        self._sock.close()


def _engine_counters(engine) -> Dict[str, Any]:
    """One replica engine's counter snapshot for :meth:`ServingTier.stats`
    (fakes without a metrics registry report empty). Reads the counter
    block only."""
    metrics = getattr(engine, "metrics", None)
    if metrics is None:
        return {}
    if hasattr(metrics, "counters"):
        return dict(metrics.counters())
    return dict(metrics.snapshot()["counters"])


def _payload_rows(obj: Dict[str, Any]) -> List[Any]:
    """The request's ``x`` as a list of rows (single-row payloads wrap)."""
    x = obj.get("x")
    if not isinstance(x, (list, tuple)) or len(x) == 0:
        raise protocol.ProtocolError(
            "'x' must be a non-empty row or list of rows")
    if isinstance(x[0], (list, tuple)):
        return list(x)
    return [x]


class ServingTier:
    """N engine replicas + router + quotas behind one TCP endpoint.

    ``engines`` are ready-made replicas over shared weights (the serving
    CLI's ``_build_replicas`` constructs them; tests pass fakes). The tier
    owns their lifecycle from :meth:`start` to :meth:`stop`. ``port=0``
    binds an ephemeral port (read :attr:`port` after ``start``).
    """

    def __init__(self, engines: Sequence, *,
                 quota: Optional[QuotaPolicy] = None,
                 max_outstanding: int = 4096,
                 host: str = "127.0.0.1", port: int = 0,
                 affinity_slack: int = 2,
                 stall_deadline_s: float = 30.0,
                 probe_timeout_s: float = 5.0,
                 monitor_interval_s: float = 0.25,
                 large_k_threshold: Optional[int] = None,
                 shed_retry_after_s: float = 0.05,
                 bulk_headroom: Optional[int] = None,
                 registry=None, tracing: bool = True, recorder=None,
                 slo=None):
        self.router = ReplicaRouter(
            engines, max_outstanding=max_outstanding,
            affinity_slack=affinity_slack,
            stall_deadline_s=stall_deadline_s,
            probe_timeout_s=probe_timeout_s,
            large_k_threshold=large_k_threshold, registry=registry)
        self.registry = self.router.registry
        self.quotas = ClientQuotas(quota)
        self._quota = quota
        self.clock = time.monotonic
        # request tracing (telemetry/tracing.py): ``tracing=True`` (the
        # default) mints a trace per request — or joins one the client
        # supplied — and lands completed trees in ``recorder`` (the
        # process-default flight recorder unless injected). ``False``
        # disables minting/recording; the ``trace`` field is still
        # VALIDATED either way (protocol contract: malformed = typed
        # bad_request, connection survives).
        if tracing:
            from iwae_replication_project_tpu_torch.telemetry.tracing import (
                get_recorder)
            self.recorder = recorder if recorder is not None \
                else get_recorder()
        else:
            self.recorder = None
        # SLO burn-rate accounting (telemetry/slo.py): None = a default
        # monitor on the router registry (its gauges sit beside the
        # router's counters); pass an SLOMonitor to set objectives, or
        # ``False`` to disable
        if slo is None:
            from iwae_replication_project_tpu_torch.telemetry.slo import (
                SLOMonitor)
            self.slo: Optional[object] = SLOMonitor(registry=self.registry)
        else:
            self.slo = slo if slo is not False else None
        #: the ``retry_after_s`` hint stamped on ``overloaded`` responses
        #: that carry no exact wait of their own (queue-shed recovery time
        #: is unknowable server-side; this is the tier's suggested pause)
        self.shed_retry_after_s = float(shed_retry_after_s)
        # the bulk offline lane (jobs.py): dataset-sized jobs pumped
        # through the router below interactive traffic — the pump fills
        # idle capacity only up to `bulk_headroom` outstanding requests
        # (default: a quarter of the admission ceiling), yielding the rest
        # to latency traffic
        from iwae_replication_project_tpu_torch.serving.frontend.jobs import (
            BulkJobManager)
        self.jobs = BulkJobManager(
            self.router, admit=self.admit, refund=self.refund,
            headroom=(bulk_headroom if bulk_headroom is not None
                      else max(1, max_outstanding // 4)),
            registry=self.registry)
        self._host = host
        self._requested_port = port
        self._monitor_interval_s = monitor_interval_s
        self._lock = threading.Lock()
        self._conns: set = set()
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    # -- admission ----------------------------------------------------------

    def admit(self, client: Optional[str], cost: int,
              model: Optional[str] = None) -> None:
        """Per-(client, model) token-bucket admission (the router applies
        the global ceiling itself at submit). Raises
        :class:`QuotaExceeded` — one tenant's model cannot starve another's
        budget under the same client id."""
        try:
            self.quotas.admit(client, cost, model=model)
        except QuotaExceeded:
            self.registry.counter("router/quota_rejections").inc()
            raise

    def refund(self, client: Optional[str], cost: int,
               model: Optional[str] = None) -> None:
        """Return an admitted request's tokens when routing rejected it
        (ceiling/shed/unavailable): the quota meters served work, so a
        request whose response is a typed routing error costs nothing."""
        self.quotas.refund(client, cost, model=model)

    # -- observability (tracing + SLO) --------------------------------------

    def open_request_span(self, trace_field, op, t_start: float):
        """The request's ``tier/request`` span: minted fresh, or joined to
        the wire ``trace`` context (fleet-of-fleets). Returns None when the
        tier does not trace — but the field is VALIDATED regardless, so a
        malformed trace is a typed ``bad_request`` on every tier."""
        from iwae_replication_project_tpu_torch.telemetry import tracing

        trace_id = parent = None
        if trace_field is not None:
            try:
                trace_id, parent = tracing.parse_wire_trace(trace_field)
            except ValueError as e:
                raise protocol.ProtocolError(str(e)) from None
        if self.recorder is None:
            return None
        return tracing.start_span(
            "tier/request", recorder=self.recorder, trace_id=trace_id,
            parent_id=parent, t_start=t_start,
            attrs={"op": op if isinstance(op, str) else repr(op)})

    def observe_request(self, op, model, t_start: float,
                        error_code: Optional[str], span) -> None:
        """One finished (answered) request's observability fan-out: close
        its tier span and account it against the (model, op) SLO.
        ``bad_request`` traffic is traced but never SLO-observed — the
        request is the client's fault, and a garbage op name must not mint
        burn-rate gauges."""
        if span is not None:
            span.finish(error=error_code)
        if self.slo is None or error_code == "bad_request":
            return
        if not isinstance(op, str) or not self.router.serves_op(op):
            return
        self.slo.observe(op, self.clock() - t_start, model=model,
                         error_code=error_code)

    def precisions_for(self, model: Optional[str]) -> set:
        """The serving precision policies this fleet holds for `model`
        (every replica, for ``None`` — the unlabeled single-model fleet).
        An engine with no policy serves exact fp32, so it reads as
        ``"fp32"`` here: a client asserting ``precision: "fp32"`` against
        a legacy fleet is satisfied, not rejected."""
        out = set()
        for e in self.router.engines:
            if model is not None and getattr(e, "model", None) != model:
                continue
            out.add(getattr(e, "precision", None) or "fp32")
        return out

    def traces_doc(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """The ``{"op": "traces"}`` control response: the flight recorder's
        retained traces (``limit``/``trace_id`` filters), as raw documents
        (default) or one Chrome trace-event object (``format: "chrome"``).
        A tier without tracing answers with empty state, not an error."""
        from iwae_replication_project_tpu_torch.telemetry.tracing import (
            chrome_trace_events)

        limit = obj.get("limit")
        if not isinstance(limit, int) or isinstance(limit, bool):
            limit = None
        trace_id = obj.get("trace_id")
        if not isinstance(trace_id, str):
            trace_id = None
        if self.recorder is None:
            docs, stats = [], None
        else:
            docs = self.recorder.traces(limit=limit, trace_id=trace_id)
            stats = self.recorder.stats()
        if obj.get("format") == "chrome":
            return chrome_trace_events(docs)
        return {"stats": stats, "traces": docs}

    def job_doc(self, op: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        """Answer one bulk-lane wire op (protocol.JOB_OPS): job admission
        or status. Malformed docs raise ValueError — the connection's
        handler maps it to a typed ``bad_request`` response."""
        if op == "submit_job":
            return self.jobs.submit(obj)
        return self.jobs.status(obj)

    def slo_doc(self) -> Dict[str, Any]:
        """The ``{"op": "slo"}`` control response: the SLOMonitor's
        burn-rate + objective snapshot (telemetry/slo.py schema) — the
        scaling signal an autoscaler (or a fleet-of-fleets parent, via
        :meth:`RemoteEngine.slo`) reads as JSON. A tier with SLO accounting
        disabled answers with empty state, not an error (same contract as
        :meth:`traces_doc`)."""
        if self.slo is None:
            return {"enabled": False, "slo": {}}
        return {"enabled": True, "slo": self.slo.snapshot()}

    # -- info ---------------------------------------------------------------

    def info(self) -> Dict[str, Any]:
        """The ``{"op": "info"}`` control response: what clients need to
        size payloads and pace themselves. Ops/dims are the UNION over the
        fleet (a mixed fast + sharded tier serves the union; the router
        keeps each request on replicas that serve its op)."""
        row_dims: Dict[str, int] = {}
        for e in self.router.engines:
            row_dims.update(getattr(e, "row_dims", {}))
        engines = self.router.engines
        sharded = [e for e in engines if getattr(e, "sharded", False)]
        # per-class templates: buckets/k describe the class that actually
        # serves the request (a mixed tier has two ladders; engines[0]
        # alone would misdescribe one class or the other)
        fast_t = next((e for e in engines
                       if not getattr(e, "sharded", False)),
                      engines[0])
        # per-model capability sub-docs (the multi-tenant contract clients
        # and RemoteEngine proxies read): which models this fleet holds,
        # each with its own ops/dims/k — empty for an unlabeled fleet
        models: Dict[str, Any] = {}
        for e in engines:
            m = getattr(e, "model", None)
            if m is None:
                continue
            doc = models.setdefault(
                m, {"ops": set(), "row_dims": {},
                    "k": getattr(e, "k", None),
                    "k_max": getattr(e, "k_max", None),
                    # the serving precision policy of this tenant's
                    # replicas (None-policy engines serve exact fp32)
                    "precision": getattr(e, "precision", None) or "fp32",
                    "replicas": 0})
            doc["ops"].update(getattr(e, "row_dims", {}))
            doc["row_dims"].update(getattr(e, "row_dims", {}))
            doc["replicas"] += 1
            if getattr(e, "k_max", None) is not None and \
                    doc["k_max"] is not None:
                doc["k_max"] = max(doc["k_max"], e.k_max)
        for doc in models.values():
            doc["ops"] = sorted(doc["ops"])
        return {
            "ops": sorted(row_dims),
            "row_dims": row_dims,
            # which ops take accuracy targets (target_se/ess_floor) — the
            # union over the fleet, like ops/row_dims
            "adaptive_ops": sorted({op for e in engines
                                    for op in getattr(e, "_ADAPTIVE_OPS",
                                                      ())}),
            "models": models,
            "default_model": self.router.default_model,
            "k": getattr(fast_t, "k", None),
            "k_max": self.router.k_max,
            "large_k_threshold": self.router.large_k_threshold,
            "sharded_replicas": len(sharded),
            "sharded": ({
                "buckets": list(getattr(getattr(sharded[0], "ladder",
                                                None), "buckets", ())),
                "k_chunk": sharded[0].menu.k_chunk,
                "k_max": sharded[0].k_max,
                "k": getattr(sharded[0], "k", None),
            } if sharded and hasattr(sharded[0], "menu") else None),
            "buckets": list(getattr(getattr(fast_t, "ladder", None),
                                    "buckets", ())),
            "replicas": len(engines),
            "max_outstanding": self.router.max_outstanding,
            "quota": ({"rate": self._quota.rate, "burst": self._quota.burst}
                      if self._quota is not None else None),
        }

    def stats(self) -> Dict[str, Any]:
        """The ``{"op": "stats"}`` control response: live router counters
        and gauges plus each replica engine's own counter snapshot — the
        over-the-wire view of the failure accounting (same numbers the CLI
        prints at shutdown), and the process executable store's counters
        and residency (``utils/compile_cache.store_stats``)."""
        from iwae_replication_project_tpu_torch.utils.compile_cache import (
            store_stats)

        snap = self.registry.snapshot()
        return {
            "router": {name: v for name, v in snap["counters"].items()
                       if name.startswith("router/")},
            "gauges": {name: v for name, v in snap["gauges"].items()
                       if name.startswith("router/")},
            # the router's learned per-(op, target-class) k_used EWMAs —
            # what least-estimated-work dispatch weighs adaptive traffic by
            "work_estimates": self.router.work_estimates(),
            "jobs": self.jobs.jobs_doc(),
            "store": store_stats(),
            "replicas": self.router.replica_states(),
            "engines": [_engine_counters(e) for e in self.router.engines],
        }

    # -- lifecycle ----------------------------------------------------------

    def warmup(self, ops: Iterable[str] = ("score", "encode", "decode",
                                           "score_adaptive")
               ) -> Dict[str, float]:
        """Warm every replica's bucket ladder (kernels built and loaded,
        device libraries and memory pools initialised). Each replica warms
        only the ops it serves (a sharded replica serves score and
        score_adaptive). Returns summed stats."""
        total: Dict[str, float] = {}
        for e in self.router.engines:
            mine = tuple(op for op in ops
                         if op in getattr(e, "row_dims", {}))
            if not mine:
                continue
            w = e.warmup(ops=mine)
            for key, v in w.items():
                total[key] = total.get(key, 0.0) + v
        return total

    def start(self) -> "ServingTier":
        """Start replicas, the health monitor, and the accept loop."""
        for e in self.router.engines:
            e.start()
        self.router.start_monitor(self._monitor_interval_s)
        self.jobs.start()
        if self._listener is None:
            lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            lst.bind((self._host, self._requested_port))
            lst.listen(128)
            # a plain close() does not reliably wake a thread blocked in
            # accept() on Linux; a short accept timeout lets the loop poll
            # the stopping flag instead
            lst.settimeout(0.2)
            self._listener = lst
            self._stopping.clear()
            self._accept_thread = threading.Thread(
                target=self._accept_loop, args=(lst,),
                name="iwae-tier-accept", daemon=True)
            self._accept_thread.start()
        return self

    @property
    def port(self) -> Optional[int]:
        return self._listener.getsockname()[1] if self._listener else None

    def _accept_loop(self, listener: socket.socket) -> None:
        while not self._stopping.is_set():
            try:
                sock, peer = listener.accept()
            except socket.timeout:
                continue        # poll the stopping flag
            except OSError:
                return          # listener closed: shutdown
            sock.settimeout(None)   # connections block; accept timeout off
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Connection(self, sock, peer)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=conn.serve,
                             name=f"iwae-tier-conn-{peer[1]}",
                             daemon=True).start()

    def _forget(self, conn: _Connection) -> None:
        with self._lock:
            self._conns.discard(conn)

    def stop(self, timeout_s: float = 60.0) -> None:
        """Graceful drain: stop accepting, flush all replicas, answer
        everything, then close connections. Idempotent."""
        self._stopping.set()
        listener = self._listener
        self._listener = None
        if listener is not None:
            listener.close()
        if self._accept_thread is not None:
            self._accept_thread.join()
            self._accept_thread = None
        # the bulk pump stops BEFORE the drain: its already-submitted rows
        # complete below; unsubmitted rows stay unsubmitted — exactly the
        # interruption the job checkpoint/resume contract covers
        self.jobs.stop()
        # drain the fleet: every tier future completes (result or typed
        # error) before this returns
        self.router.drain(timeout_s=timeout_s)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.flush(timeout_s=timeout_s)
            c.close()
        with self._lock:
            self._conns.clear()
