"""``RemoteEngine``: a serving tier as one replica of a bigger fleet (port
of ``serving/frontend/remote.py``; the wire is the JAX package's, so the
child may be a tier of either package).

The proxy presents the engine surface the replica router dispatches over —
``submit(op, row, k=, seed=)`` returning a Future, ``stop()``,
``row_dims``, ``k`` — backed by ONE JSON-lines TCP connection to a running
:class:`~.server.ServingTier`. A parent :class:`~.router.ReplicaRouter`
over N RemoteEngines therefore composes fleets out of *processes* (each
child tier owns its own device), and recursively out of fleets:
protocol.py's explicit ``seed`` field exists so the parent's
admission-order seeds ride through to the leaf engines and results stay
bitwise independent of which process served each request.

Failure semantics map back onto the engine exception taxonomy the router
already speaks:

* a typed ``overloaded`` response completes the future with
  :class:`~..batcher.EngineOverloaded` (the router tries peers without
  declaring the replica dead — an async shed means *full*, not *failed*);
* ``timeout`` becomes :class:`~..batcher.RequestTimeout` (per-request
  outcome, no reroute);
* a lost connection fails every outstanding future with
  :class:`~.router.ReplicaUnavailable` and poisons the proxy — subsequent
  submits raise synchronously, so the parent marks the replica unhealthy.

**Reconnection** is opt-in via ``retry=RetryPolicy(...)``: a poisoned
proxy re-dials the child tier on the next ``submit`` (the parent's warm
probes are exactly that — one real request through the replica), rate-
limited by the policy's decorrelated backoff so a down child is not
hammered. Without a policy the poison is permanent — the pre-retry
semantics — and either way the futures
that were in flight when the connection died stay failed (typed): the
parent reroutes or the end client retries; the proxy never resends them
itself. ``close()`` is final: no policy reconnects a proxy its owner shut
down.

Ops and payload dims are validated locally against the child tier's
``info`` document (fetched at connect time), so malformed requests raise
``ValueError`` synchronously like the in-process engine instead of
surfacing as a ``bad_request`` future failure that would smear the replica.

One lock guards the socket write side + the pending-future map; the reader
thread completes futures strictly outside it (completion callbacks — the
parent router's — re-enter :meth:`submit`). Reader threads are generation-
tagged: a thread whose socket belongs to a superseded connection can
neither poison the proxy nor complete a live future.
"""

from __future__ import annotations

import contextlib
import socket
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional

from iwae_replication_project_tpu_torch.serving.batcher import (
    EngineOverloaded,
    RequestTimeout,
    complete_future as _complete,
)
from iwae_replication_project_tpu_torch.serving.buckets import (
    validate_model,
)
from iwae_replication_project_tpu_torch.serving.faults import (
    SITE_REMOTE_SEND,
)
from iwae_replication_project_tpu_torch.serving.frontend import protocol
from iwae_replication_project_tpu_torch.serving.frontend.retry import (
    RetryPolicy,
)
from iwae_replication_project_tpu_torch.serving.frontend.router import (
    ReplicaUnavailable,
)
from iwae_replication_project_tpu_torch.utils.faults import fault_point

__all__ = ["RemoteEngine"]

#: typed response code -> the engine exception the router dispatches on
_CODE_EXC = {
    "overloaded": EngineOverloaded,
    "timeout": RequestTimeout,
    "unavailable": ReplicaUnavailable,
    "bad_request": ValueError,
}


class RemoteEngine:
    """The engine surface over one TCP connection to a serving tier."""

    #: capability bit for a parent router: the proxy accepts
    #: ``submit(trace=)`` — the hop is recorded as a ``remote/hop`` span
    #: and the context rides the wire's ``trace`` field, so the child
    #: tier's request span joins the SAME tree (fleet-of-fleets tracing)
    traces = True

    def __init__(self, host: str, port: int, *,
                 connect_timeout_s: float = 30.0,
                 retry: Optional[RetryPolicy] = None):
        self._addr = (host, port)
        self._connect_timeout_s = connect_timeout_s
        self._retry = retry
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        #: wire id -> Future for every in-flight request (guarded by _lock)
        self._pending: Dict[int, Future] = {}
        #: wire id -> open remote/hop Span for traced requests (guarded by
        #: _lock beside _pending; finished outside it)
        self._spans: Dict[int, Any] = {}
        self._next_id = 0
        self._dead: Optional[str] = None  # poison reason once connection dies
        self._closed = False              # close() is final even under retry
        self._dialing = False             # one reconnect dial at a time
        self._gen = 0                     # connection generation (reader tag)
        self._backoff = None              # reconnect delay stream (lazy)
        self._next_reconnect_t = 0.0
        #: successful re-dials (the parent's probe-driven recovery evidence)
        self.reconnects = 0
        self._install_locked(*self._dial())  # ctor is single-threaded

    # -- connection management ----------------------------------------------

    def _dial(self):
        """Dial + info handshake; returns ``(sock, reader, doc)``. Mutates
        NO proxy state, so the reconnect path can run it OUTSIDE the lock —
        a black-holed dial (connect_timeout_s) must never stall other lock
        users (close(), stop(), concurrent submits, the reader thread)."""
        host, port = self._addr
        sock = socket.create_connection(self._addr,
                                        timeout=self._connect_timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            reader = protocol.LineReader(sock)
            # the child tier's shape contract, fetched synchronously before
            # the reader thread takes over the receive side
            sock.sendall(protocol.encode_line({"id": 0, "op": "info"}))
            line = reader.next_line()
            if line is None:
                raise ConnectionError(f"tier at {host}:{port} closed "
                                      "during the info handshake")
            info = protocol.decode_line(line)
            if not info.get("ok"):
                raise ConnectionError(
                    f"tier info handshake failed: {info.get('message')}")
        except BaseException:
            # EVERY handshake failure (timeout, garbage, refusal) must
            # close the fd it dialed: a flapping child under reconnect
            # backoff would otherwise leak one socket per attempt
            sock.close()
            raise
        sock.settimeout(None)       # the reader blocks; handshake timed
        return sock, reader, info["result"]

    def _install_locked(self, sock, reader, doc) -> None:
        """Publish a dialed connection (caller holds ``_lock``, or is the
        single-threaded ctor) and spawn its generation-tagged reader."""
        self.row_dims = {op: int(d) for op, d in doc["row_dims"].items()}
        self.k = doc.get("k")
        # capability bits for a PARENT router's large-k classification:
        # the child tier's fleet-wide k bound rides through, and a child
        # that is ENTIRELY mesh-backed proxies as one sharded replica (a
        # mixed child serves both classes itself, so it reads as fast)
        self.k_max = doc.get("k_max")
        self.sharded = bool(doc.get("sharded_replicas")) and \
            doc.get("sharded_replicas") == doc.get("replicas")
        # model capability forwarding: a multi-tenant child tier declares
        # its zoo in the info doc — the proxy presents the WHOLE set to a
        # parent router (one RemoteEngine can serve several models), with
        # the child's default as its own default label
        child_models = doc.get("models") or {}
        self.models = frozenset(child_models) if child_models else None
        self.model = doc.get("default_model")
        # adaptive capability forwarding: which of the child's ops take
        # accuracy targets — a parent tier's info doc and router read the
        # same attribute the in-process engines expose
        self._ADAPTIVE_OPS = tuple(doc.get("adaptive_ops") or ())
        self.info = doc
        self._sock = sock
        self._reader = reader
        self._gen += 1
        self._reader_thread = threading.Thread(
            target=self._read_loop, args=(reader, self._gen),
            name=f"iwae-remote-{self._addr[0]}:{self._addr[1]}", daemon=True)
        self._reader_thread.start()

    def _reconnect_if_needed(self) -> None:
        """Healthy: no-op. Poisoned: re-dial under the RetryPolicy (one
        dial at a time, backoff-limited, dial itself OUTSIDE the lock) or
        raise the typed unavailable."""
        with self._lock:
            if self._dead is None:
                return
            if self._retry is None or self._closed:
                raise ReplicaUnavailable(
                    f"remote tier {self._addr[0]}:{self._addr[1]} is gone "
                    f"({self._dead})")
            now = time.monotonic()
            if now < self._next_reconnect_t:
                raise ReplicaUnavailable(
                    f"remote tier {self._addr[0]}:{self._addr[1]} is gone "
                    f"({self._dead}); next reconnect attempt in "
                    f"{self._next_reconnect_t - now:.2f}s")
            if self._dialing:
                raise ReplicaUnavailable(
                    f"remote tier {self._addr[0]}:{self._addr[1]} is gone "
                    f"({self._dead}); a reconnect dial is in progress")
            self._dialing = True
            old = self._sock
        # retire the dead socket first so its reader thread exits instead
        # of hanging on a half-open connection
        with contextlib.suppress(OSError):
            old.close()
        try:
            sock, reader, doc = self._dial()
        except (OSError, protocol.ProtocolError) as e:
            with self._lock:
                self._dialing = False
                if self._backoff is None:
                    self._backoff = self._retry.backoff(stream=self._gen)
                self._next_reconnect_t = \
                    time.monotonic() + self._backoff.next_delay()
            raise ReplicaUnavailable(
                f"remote tier reconnect failed: {e}") from None
        with self._lock:
            self._dialing = False
            if self._closed:
                # close() won the race against the dial: stay final
                sock.close()
                raise ReplicaUnavailable(
                    f"remote tier {self._addr[0]}:{self._addr[1]} is gone "
                    f"(closed)")
            self._install_locked(sock, reader, doc)
            self._dead = None
            self._backoff = None
            self._next_reconnect_t = 0.0
            self.reconnects += 1

    # -- engine surface ------------------------------------------------------

    def submit(self, op: str, row, k: Optional[int] = None, *,
               seed: Optional[int] = None,
               model: Optional[str] = None,
               trace=None,
               target_se: Optional[float] = None,
               ess_floor: Optional[float] = None) -> Future:
        """One row to the child tier; returns the proxy Future.

        ``trace`` (a :class:`~...telemetry.tracing.TraceContext`) records
        this hop as a ``remote/hop`` span — open from send to response —
        and forwards the context on the wire, so the child tier's spans
        join the parent's tree.

        Validation (unknown op/model, wrong feature count, poisoned
        connection) raises synchronously, exactly like the in-process
        engine — the parent router's submit-failure path handles it. Under
        a ``RetryPolicy`` a poisoned proxy first attempts one (backoff-
        limited) reconnect, so the parent's warm probes drive recovery.
        ``model`` rides the wire's ``model`` field, so a parent fleet's
        model routing reaches the child tier's replicas unchanged.
        """
        if op not in self.row_dims:
            raise ValueError(
                f"unknown op {op!r}; this tier serves {sorted(self.row_dims)}")
        if model is not None:
            # the in-process engine's typed bad_request, via the ONE
            # shared validator: the child tier must hold these weights
            validate_model(model, self.models or ())
        row = row.tolist() if hasattr(row, "tolist") else list(row)
        if len(row) != self.row_dims[op]:
            raise ValueError(f"op {op!r} rows have {self.row_dims[op]} "
                             f"features, got {len(row)}")
        req: Dict[str, Any] = {"op": op, "x": row}
        if k is not None:
            req["k"] = int(k)
        if target_se is not None or ess_floor is not None:
            # adaptive targets ride the wire unchanged — the child tier's
            # own boundary validation answers malformed values with a
            # typed bad_request, which maps back to ValueError here (the
            # same shape the in-process engine raises synchronously)
            if op not in self._ADAPTIVE_OPS:
                raise ValueError(
                    f"target_se/ess_floor only apply to adaptive ops; "
                    f"this tier declares {sorted(self._ADAPTIVE_OPS)}, "
                    f"got op {op!r}")
            if target_se is not None:
                req["target_se"] = float(target_se)
            if ess_floor is not None:
                req["ess_floor"] = float(ess_floor)
        if model is not None:
            req["model"] = model
        if seed is not None:
            seed = int(seed)
            if not 0 <= seed < 2 ** 31:
                # the leaf engines' int32 seed-tensor bound, enforced at
                # every boundary a seed can enter the fleet through
                raise ValueError(f"seed must be in [0, 2**31), got {seed}")
            req["seed"] = seed
        # poisoned: under a RetryPolicy, attempt ONE backoff-limited re-dial
        # (the parent's warm probe lands here); otherwise — or after
        # close() — the poison is final. The dial runs outside the lock.
        self._reconnect_if_needed()
        hop = None
        if trace is not None:
            from iwae_replication_project_tpu_torch.telemetry.tracing import (
                start_span)
            hop = start_span("remote/hop", ctx=trace,
                             attrs={"host": self._addr[0],
                                    "port": self._addr[1], "op": op})
            req["trace"] = hop.ctx().wire()
        fut: Future = Future()
        with self._lock:
            if self._dead is not None:
                # died again between the reconnect check and the send
                if hop is not None:
                    hop.finish(error="unavailable")
                raise ReplicaUnavailable(
                    f"remote tier {self._addr[0]}:{self._addr[1]} is gone "
                    f"({self._dead})")
            self._next_id += 1
            req["id"] = self._next_id
            self._pending[self._next_id] = fut
            if hop is not None:
                self._spans[self._next_id] = hop
            try:
                # chaos hook: an injected OSError severs the proxy exactly
                # like a mid-send connection loss
                fault_point(SITE_REMOTE_SEND, addr=self._addr)
                self._sock.sendall(protocol.encode_line(req))  # iwaelint: disable=blocking-call-under-lock -- the proxy lock IS the frame serializer: id allocation, pending registration and the send must be atomic per request or concurrent submits interleave frames; a dead child tier fails fast with OSError
            except OSError as e:
                del self._pending[self._next_id]
                self._spans.pop(self._next_id, None)
                self._dead = f"send failed: {e}"
                if hop is not None:
                    hop.finish(error="unavailable")
                raise ReplicaUnavailable(
                    f"remote tier send failed: {e}") from None
        return fut

    def start(self) -> None:
        """No-op: the child tier's engines are already running."""

    def stop(self, timeout_s: float = 60.0) -> None:
        """Drain the proxy: wait for every outstanding future (the child
        tier is still serving them), then close the connection. The child
        tier itself keeps running — its own lifecycle owner stops it."""
        with self._idle:
            self._idle.wait_for(lambda: not self._pending or self._dead,
                                timeout=timeout_s)
        self.close()

    def warmup(self, ops=(), ks=None) -> Dict[str, float]:
        """No-op: the child tier warmed its replicas before its ready line
        (serving/cli.py `_tier_mode`); there is nothing to build here."""
        return {}

    def slo(self, timeout_s: float = 10.0) -> Dict[str, Any]:
        """The child tier's ``slo`` control document (``{"enabled": bool,
        "slo": <SLOMonitor.snapshot()>}``) — the scaling signal a fleet-of-
        fleets parent's autoscaler reads over the wire (telemetry/slo.py's
        ``peak_burns``/``window_requests`` reduce it identically to a local
        snapshot). Blocks up to ``timeout_s``; a dead/poisoned proxy raises
        :class:`ReplicaUnavailable`, exactly like :meth:`submit`."""
        self._reconnect_if_needed()
        fut: Future = Future()
        with self._lock:
            if self._dead is not None:
                raise ReplicaUnavailable(
                    f"remote tier {self._addr[0]}:{self._addr[1]} is gone "
                    f"({self._dead})")
            self._next_id += 1
            req = {"op": "slo", "id": self._next_id}
            self._pending[self._next_id] = fut
            try:
                self._sock.sendall(protocol.encode_line(req))  # iwaelint: disable=blocking-call-under-lock -- the frame-serializer rule of submit: id allocation, pending registration and the send are atomic per request
            except OSError as e:
                del self._pending[self._next_id]
                self._dead = f"send failed: {e}"
                raise ReplicaUnavailable(
                    f"remote tier send failed: {e}") from None
        return fut.result(timeout=timeout_s)

    # -- receive side --------------------------------------------------------

    def _read_loop(self, reader: protocol.LineReader, gen: int) -> None:
        while True:
            try:
                line = reader.next_line()
            except (protocol.ProtocolError, OSError) as e:
                self._conn_lost(gen, f"receive failed: {e}")
                return
            if line is None:
                self._conn_lost(gen, "tier closed the connection")
                return
            try:
                resp = protocol.decode_line(line)
            except protocol.ProtocolError as e:
                self._conn_lost(gen, f"malformed response: {e}")
                return
            with self._lock:
                if gen != self._gen:
                    return      # superseded connection: not ours to serve
                fut = self._pending.pop(resp.get("id"), None)
                hop = self._spans.pop(resp.get("id"), None)
                self._idle.notify_all()
            if fut is None:
                continue        # duplicate/unknown id: first-wins upstream
            # complete OUTSIDE the lock: the parent router's callback may
            # re-enter submit()
            if resp.get("ok"):
                if hop is not None:
                    hop.finish()
                result = resp.get("result")
                # one submit = one row; unwrap the per-row result list
                _complete(fut, result=result[0]
                          if isinstance(result, list) and len(result) == 1
                          else result)
            else:
                if hop is not None:
                    hop.finish(error=resp.get("error", "internal"))
                exc_type = _CODE_EXC.get(resp.get("error", "internal"),
                                         RuntimeError)
                _complete(fut, exc=exc_type(resp.get("message", "")))

    def _conn_lost(self, gen: int, reason: str) -> None:
        """A reader thread's connection died: poison the proxy and fail
        everything outstanding — UNLESS the proxy already moved on to a
        newer connection (then the stale thread just exits)."""
        with self._lock:
            if gen != self._gen:
                return
            if self._dead is None:
                self._dead = reason
            orphans = list(self._pending.values())
            self._pending.clear()
            orphan_spans = list(self._spans.values())
            self._spans.clear()
            self._idle.notify_all()
        for hop in orphan_spans:
            hop.finish(error="unavailable")
        for fut in orphans:
            _complete(fut, exc=ReplicaUnavailable(
                f"remote tier connection lost: {reason}"))

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._dead is None:
                self._dead = "closed"
            sock = self._sock
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            # best-effort shutdown: the socket may already be dead, and
            # close() below is the real teardown
            pass
        sock.close()

    def __enter__(self) -> "RemoteEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
