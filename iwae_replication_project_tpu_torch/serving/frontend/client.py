"""Socket client for the serving tier (port of
``serving/frontend/client.py``; the serving CLI's ``--client`` mode).

One TCP connection speaking the JSON-lines protocol, with two calling
shapes:

* **blocking** — :meth:`TierClient.request` (and the ``score`` / ``encode``
  / ``decode`` sugar) sends one request and waits for its response;
* **pipelined** — :meth:`submit` writes a request and returns its id
  immediately; :meth:`drain` reads until every outstanding id has its
  response. The tier answers out of order (replicas finish when they
  finish), so both shapes demultiplex on the echoed ``id``.

Results come back as plain Python lists (the JSON payload, one entry per
row) and errors as :class:`TierError` carrying the typed protocol code —
the client performs no array conversion, so callers choose their own
container.

**Self-healing** (``retry=RetryPolicy(...)``): the blocking path becomes
the failure model's last hop — typed retryable errors back off (honoring
the response's ``retry_after_s`` hint) and resend; a dropped or garbled
connection reconnects first; and with ``hedge_after_s`` set, a request
unanswered past the hedge delay is re-sent on a second connection,
first response wins, the loser's connection is closed. Retrying is safe
because serving results are a pure function of (weights, payload, seed,
k): a caller that pins an explicit ``seed`` gets the bitwise-identical
result on any attempt, any replica, any connection. The pipelined API
stays raw by design (ids are per connection; a reconnect abandons unread
pipelined responses), and :attr:`retry_stats` counts
retries/reconnects/hedges.

The client is intentionally single-threaded except during a hedge race:
reads happen on the calling thread inside ``request``/``drain``. One
client = one connection = one in-order request stream; run several
clients for concurrency.
"""

from __future__ import annotations

import queue as _queue
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from iwae_replication_project_tpu_torch.serving.frontend import protocol
from iwae_replication_project_tpu_torch.serving.frontend.retry import (
    RetryPolicy,
)

__all__ = ["TierClient", "TierError"]


class TierError(RuntimeError):
    """A typed error response from the tier (``code`` is one of
    :data:`~.protocol.ERROR_CODES`; ``retry_after_s`` is the response's
    optional machine-readable back-off hint)."""

    def __init__(self, code: str, message: str,
                 retry_after_s: Optional[float] = None):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.retry_after_s = retry_after_s


class TierClient:
    """One JSON-lines connection to a :class:`~.server.ServingTier`."""

    def __init__(self, host: str, port: int, *,
                 client_id: Optional[str] = None,
                 timeout_s: Optional[float] = 60.0,
                 retry: Optional[RetryPolicy] = None,
                 trace: bool = False, recorder=None):
        self.client_id = client_id
        self._host = host
        self._port = port
        self._timeout_s = timeout_s
        self._retry = retry
        # opt-in client-side tracing (telemetry/tracing.py): every request
        # roots a ``client/request`` span (retry/hedge attempts become
        # indexed children) and rides the wire ``trace`` field, so the
        # tier's tree hangs under the CLIENT's view of the request —
        # including the attempts the server never saw finish
        self._trace = bool(trace)
        if self._trace and recorder is None:
            from iwae_replication_project_tpu_torch.telemetry.tracing import (
                get_recorder)
            recorder = get_recorder()
        self._recorder = recorder
        #: wire id -> open auto-minted root span (pipelined/no-retry path)
        self._spans: Dict[int, Any] = {}
        self._next_id = 0
        self._retry_streams = 0
        #: id -> response, for replies read while waiting on another id
        self._responses: Dict[int, Dict[str, Any]] = {}
        #: self-healing accounting
        self.retry_stats = {"retries": 0, "reconnects": 0, "hedges": 0,
                            "hedge_wins": 0}
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[protocol.LineReader] = None
        self._closed = False
        self._connect()

    # -- connection lifecycle -----------------------------------------------

    def _connect(self) -> None:
        self._sock = socket.create_connection((self._host, self._port),
                                              timeout=self._timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = protocol.LineReader(self._sock)
        # wire ids are per connection: responses buffered from a previous
        # connection can never be matched again
        self._responses = {}

    def _disconnect(self) -> None:
        sock, self._sock, self._reader = self._sock, None, None
        # pipelined-mode root spans die with the connection: their wire ids
        # can never be answered again, so close them errored NOW (a trace
        # that waited for the recorder TTL would read as abandoned, and the
        # map would grow forever across reconnects — ids never repeat)
        spans, self._spans = self._spans, {}
        for sp in spans.values():
            sp.finish(error="connection")
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                # best-effort shutdown of a possibly already-dead socket;
                # close() below is the real teardown
                pass
            sock.close()

    def _ensure_connected(self) -> None:
        if self._closed:
            # close() is final: a silent re-dial would turn use-after-close
            # into a leaked socket instead of an error
            raise ConnectionError("client is closed")
        if self._sock is None:
            self._connect()
            self.retry_stats["reconnects"] += 1

    # -- pipelined API ------------------------------------------------------

    def submit(self, op: str, x, k: Optional[int] = None,
               seed: Optional[int] = None,
               model: Optional[str] = None, trace=None,
               target_se: Optional[float] = None,
               ess_floor: Optional[float] = None) -> int:
        """Send one request without waiting; returns its wire id. ``seed``
        (single-row payloads only) pins the row's RNG stream — the
        fleet-composition AND retry-parity hook (see protocol.py);
        ordinary non-retrying callers leave it unset. ``model`` names the
        tenant whose weights must serve the request (a multi-model tier;
        unknown names come back as typed ``bad_request`` responses).
        ``trace`` (a :class:`~...telemetry.tracing.TraceContext`) attaches
        the request under an existing span; with client tracing on
        (``TierClient(trace=True)``) and no explicit context, each submit
        roots its own ``client/request`` span, closed when its response is
        read by :meth:`wait`/:meth:`drain`."""
        if self._sock is None:
            raise ConnectionError("client is disconnected (a prior "
                                  "connection failure); blocking requests "
                                  "under a RetryPolicy reconnect themselves")
        self._next_id += 1
        req_id = self._next_id
        req: Dict[str, Any] = {"id": req_id, "op": op, "x": x}
        if k is not None:
            req["k"] = k
        if target_se is not None:
            req["target_se"] = target_se
        if ess_floor is not None:
            req["ess_floor"] = ess_floor
        if seed is not None:
            req["seed"] = seed
        if model is not None:
            req["model"] = model
        if self.client_id is not None:
            req["client"] = self.client_id
        if trace is not None:
            req["trace"] = trace.wire()
        elif self._trace:
            from iwae_replication_project_tpu_torch.telemetry.tracing import (
                start_span)
            span = start_span("client/request", recorder=self._recorder,
                              attrs={"op": op})
            self._spans[req_id] = span
            req["trace"] = span.ctx().wire()
        self._sock.sendall(protocol.encode_line(req))
        return req_id

    def _finish_span(self, req_id: int, resp: Dict[str, Any]) -> None:
        """Close the auto-minted root span of a pipelined request once its
        response has been read (error-coded when the tier said no)."""
        span = self._spans.pop(req_id, None)
        if span is not None:
            span.finish(error=None if resp.get("ok")
                        else resp.get("error", "internal"))

    def _read_one(self) -> Dict[str, Any]:
        line = self._reader.next_line()
        if line is None:
            raise ConnectionError("tier closed the connection")
        return protocol.decode_line(line)

    def wait(self, req_id: int) -> List[Any]:
        """Block until `req_id`'s response arrives (buffering others);
        returns the per-row result list or raises :class:`TierError`."""
        while req_id not in self._responses:
            resp = self._read_one()
            self._responses[resp.get("id")] = resp
        resp = self._responses.pop(req_id)
        self._finish_span(req_id, resp)
        if not resp.get("ok"):
            raise TierError(resp.get("error", "internal"),
                            resp.get("message", ""),
                            retry_after_s=resp.get("retry_after_s"))
        return resp["result"]

    def drain(self, req_ids: List[int]) -> Dict[int, Dict[str, Any]]:
        """Collect the raw response objects for every id (errors included
        as objects, NOT raised — burst callers triage afterwards)."""
        want = set(req_ids)
        out: Dict[int, Dict[str, Any]] = {}
        for rid in list(want):
            if rid in self._responses:
                out[rid] = self._responses.pop(rid)
                want.discard(rid)
        while want:
            resp = self._read_one()
            rid = resp.get("id")
            if rid in want:
                out[rid] = resp
                want.discard(rid)
            else:
                self._responses[rid] = resp
        for rid, resp in out.items():
            self._finish_span(rid, resp)
        return out

    # -- blocking API -------------------------------------------------------

    def request(self, op: str, x, k: Optional[int] = None,
                seed: Optional[int] = None,
                model: Optional[str] = None,
                target_se: Optional[float] = None,
                ess_floor: Optional[float] = None) -> List[Any]:
        if self._retry is None:
            return self.wait(self.submit(op, x, k=k, seed=seed, model=model,
                                         target_se=target_se,
                                         ess_floor=ess_floor))
        return self._request_retrying(op, x, k, seed, model,
                                      target_se, ess_floor)

    def score(self, x, k: Optional[int] = None,
              seed: Optional[int] = None,
              model: Optional[str] = None) -> List[Any]:
        """Per-row k-sample IWAE log p̂(x) (list of floats)."""
        return self.request("score", x, k=k, seed=seed, model=model)

    def score_adaptive(self, x, k: Optional[int] = None,
                       seed: Optional[int] = None,
                       model: Optional[str] = None, *,
                       target_se: Optional[float] = None,
                       ess_floor: Optional[float] = None) -> List[Any]:
        """Accuracy-targeted scoring: per-row ``[log_px, achieved_se,
        k_used]`` triples. ``k`` is the sample CAP (fleet ``k_max`` when
        unset); at least one of ``target_se`` / ``ess_floor`` must be a
        positive number (the typed-``bad_request`` contract otherwise).
        Retrying/hedging is as safe as for ``score``: results — k_used
        included — are a pure function of (weights, payload, seed, k,
        targets)."""
        return self.request("score_adaptive", x, k=k, seed=seed,
                            model=model, target_se=target_se,
                            ess_floor=ess_floor)

    def encode(self, x, k: Optional[int] = None,
               seed: Optional[int] = None,
               model: Optional[str] = None) -> List[Any]:
        return self.request("encode", x, k=k, seed=seed, model=model)

    def decode(self, h, seed: Optional[int] = None,
               model: Optional[str] = None) -> List[Any]:
        return self.request("decode", h, seed=seed, model=model)

    # -- retry/hedging machinery (blocking path only) -----------------------

    def _request_retrying(self, op: str, x, k: Optional[int],
                          seed: Optional[int],
                          model: Optional[str] = None,
                          target_se: Optional[float] = None,
                          ess_floor: Optional[float] = None) -> List[Any]:
        """The RetryPolicy loop: reconnect + resend across connection
        failures, back off and resend on typed retryable errors, give up
        at max_attempts or the overall deadline — whichever first. Raises
        the LAST failure unchanged (typed TierError, or the connection
        error) so callers keep the real diagnosis."""
        policy = self._retry
        self._retry_streams += 1
        backoff = policy.backoff(self._retry_streams)
        deadline = None if policy.deadline_s is None \
            else time.monotonic() + policy.deadline_s
        root = None
        if self._trace:
            from iwae_replication_project_tpu_torch.telemetry.tracing import (
                start_span)
            root = start_span("client/request", recorder=self._recorder,
                              attrs={"op": op})
        last: Optional[BaseException] = None
        try:
            for attempt in range(1, policy.max_attempts + 1):
                hint = None
                # attempt-indexed child span: a retried request's tree
                # shows every send, including ones the tier never answered
                aspan = root.child(f"client/attempt-{attempt}") \
                    if root is not None else None
                try:
                    self._ensure_connected()
                    rid = self.submit(op, x, k=k, seed=seed, model=model,
                                      trace=(aspan.ctx() if aspan is not None
                                             else None),
                                      target_se=target_se,
                                      ess_floor=ess_floor)
                    out = self._await(rid, op, x, k, seed, model, deadline,
                                      span=aspan, target_se=target_se,
                                      ess_floor=ess_floor)
                    if aspan is not None:
                        aspan.finish()
                    if root is not None:
                        root.finish()
                    return out
                except TierError as e:
                    if aspan is not None:
                        aspan.finish(error=e.code)
                    if not policy.retryable(e.code) or (
                            e.code == "quota_exceeded"
                            and e.retry_after_s is None):
                        # a quota rejection WITHOUT a refill hint is the
                        # cost-above-burst case: no wait can ever admit it —
                        # the request must be split, not re-sent
                        raise
                    last, hint = e, e.retry_after_s
                except (OSError, protocol.ProtocolError) as e:
                    if aspan is not None:
                        aspan.finish(error="connection")
                    if self._closed:
                        raise   # use-after-close is an error, not a retry
                    # dropped (OSError/ConnectionError) or garbled
                    # (ProtocolError) connection: the stream is unusable —
                    # reconnect before the next attempt
                    self._disconnect()
                    if not policy.retry_connection_errors:
                        raise
                    last = e
                if attempt >= policy.max_attempts:
                    break
                sleep_s = backoff.next_delay(hint)
                if deadline is not None and \
                        time.monotonic() + sleep_s > deadline:
                    break
                self.retry_stats["retries"] += 1
                time.sleep(sleep_s)
            raise last
        finally:
            if root is not None:
                # idempotent: a no-op after the success-path finish; on any
                # raise this closes the root errored so the trace finalizes
                root.finish(error="failed")

    def _await(self, rid: int, op: str, x, k, seed, model,
               deadline: Optional[float], span=None,
               target_se: Optional[float] = None,
               ess_floor: Optional[float] = None) -> List[Any]:
        """Wait for `rid`, hedging to a second connection when the policy
        asks for it and the primary is slow. ``span`` is the attempt span
        a hedge records its ``client/hedge`` child under."""
        policy = self._retry
        if policy.hedge_after_s is None:
            return self.wait(rid)
        # phase 1: give the primary hedge_after_s to answer (socket
        # timeout — partial frames stay buffered in the LineReader)
        self._sock.settimeout(policy.hedge_after_s)
        try:
            return self.wait(rid)
        except socket.timeout:  # iwaelint: disable=swallowed-exception -- the timeout IS the hedge trigger: a slow (not dead) primary falls through to the two-connection race below, where the pending request and its span stay live on purpose for the hedge to answer
            pass
        finally:
            if self._sock is not None:
                self._sock.settimeout(self._timeout_s)
        # phase 2: second connection, same request, SAME seed (bitwise-
        # identical answer); two waiter threads race into one queue
        self.retry_stats["hedges"] += 1
        finished = set()
        primary_broken = False
        hedge = TierClient(self._host, self._port, client_id=self.client_id,
                           timeout_s=self._timeout_s)
        # the hedge span opens only once the dial succeeded: a refused dial
        # raises out of here with no orphaned open span (the attempt span's
        # error closure keeps the trace finalizable)
        hspan = span.child("client/hedge") if span is not None else None
        # everything past the hedge dial runs under the finally that closes
        # it: a submit that dies on a freshly-reset connection must not
        # leak the hedge socket (nor skip the primary cleanup decision)
        try:
            hrid = hedge.submit(op, x, k=k, seed=seed, model=model,
                                trace=(hspan.ctx() if hspan is not None
                                       else None),
                                target_se=target_se, ess_floor=ess_floor)
            results: "_queue.Queue" = _queue.Queue()

            def waiter(tag: str, cli: "TierClient", r: int) -> None:
                try:
                    results.put((tag, None, cli.wait(r)))
                except BaseException as e:
                    results.put((tag, e, None))

            for tag, cli, r in (("primary", self, rid),
                                ("hedge", hedge, hrid)):
                threading.Thread(target=waiter, args=(tag, cli, r),
                                 daemon=True).start()
            tag, err, value = self._race(results, deadline)
            finished.add(tag)
            self._finish_hedge_span(hspan, tag, err)
            primary_broken |= tag == "primary" and \
                isinstance(err, (OSError, protocol.ProtocolError))
            if err is None:
                if tag == "hedge":
                    self.retry_stats["hedge_wins"] += 1
                return value
            # the first finisher failed; the slower leg may still win —
            # wait it out within the deadline, else surface the error
            tag2, err2, value2 = self._race(results, deadline)
            finished.add(tag2)
            self._finish_hedge_span(hspan, tag2, err2)
            primary_broken |= tag2 == "primary" and \
                isinstance(err2, (OSError, protocol.ProtocolError))
            if err2 is None:
                if tag2 == "hedge":
                    self.retry_stats["hedge_wins"] += 1
                return value2
            raise err
        finally:
            # first-wins cancellation: the hedge connection is throwaway
            # (closing it unblocks its waiter; the tier's write to a closed
            # socket is dropped server-side), and the primary is abandoned
            # too when a waiter may still be blocked on it — or when its
            # stream broke. It reconnects lazily on the next request.
            if hspan is not None and "hedge" not in finished:
                # the race ended before the hedge leg reported: close its
                # span so the trace can finalize (the tier-side subtree
                # still lands — the tier answers even a vanished client)
                hspan.finish(error="abandoned")
            hedge.close()
            if "primary" not in finished or primary_broken:
                self._disconnect()

    @staticmethod
    def _finish_hedge_span(hspan, tag: str, err) -> None:
        if hspan is None or tag != "hedge":
            return
        hspan.finish(error=None if err is None else (
            err.code if isinstance(err, TierError) else "connection"))

    @staticmethod
    def _race(results: "_queue.Queue", deadline: Optional[float]):
        timeout = None if deadline is None \
            else max(0.0, deadline - time.monotonic())
        try:
            return results.get(timeout=timeout)
        except _queue.Empty:
            raise TierError(
                "timeout", "request deadline passed while hedging "
                "(neither connection answered)") from None

    # -- control ops --------------------------------------------------------

    def _control(self, op: str, **fields) -> Dict[str, Any]:
        self._ensure_connected()
        self._next_id += 1
        req: Dict[str, Any] = {"id": self._next_id, "op": op}
        req.update({k: v for k, v in fields.items() if v is not None})
        self._sock.sendall(protocol.encode_line(req))
        return self.wait(self._next_id)

    def info(self) -> Dict[str, Any]:
        """The tier's ``info`` control document (ops, row dims, buckets)."""
        return self._control("info")

    def stats(self) -> Dict[str, Any]:
        """The tier's live ``stats`` document (router counters/gauges,
        replica health, per-engine counters)."""
        return self._control("stats")

    def slo(self) -> Dict[str, Any]:
        """The tier's ``slo`` control document: ``{"enabled": bool,
        "slo": {per-(model, op) burn rates}}`` — an autoscaler's wire
        signal."""
        return self._control("slo")

    def submit_job(self, x, *, job_op: str = "score",
                   k: Optional[int] = None,
                   target_se: Optional[float] = None,
                   ess_floor: Optional[float] = None,
                   seed: Optional[int] = None,
                   model: Optional[str] = None,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: Optional[int] = None,
                   resume: Optional[bool] = None) -> Dict[str, Any]:
        """Admit one bulk offline job (``submit_job`` wire op, jobs.py):
        every row of ``x`` scored through ``job_op`` in the background,
        below interactive traffic. Returns the job's initial status doc
        (``doc["job"]`` is the id for :meth:`job_status`)."""
        return self._control("submit_job", x=x, job_op=job_op, k=k,
                             target_se=target_se, ess_floor=ess_floor,
                             seed=seed, model=model,
                             client=self.client_id,
                             checkpoint_dir=checkpoint_dir,
                             checkpoint_every=checkpoint_every,
                             resume=resume)

    def job_status(self, job: str,
                   results: Optional[bool] = None) -> Dict[str, Any]:
        """One job's typed status doc (``results=True`` includes the
        per-row results collected so far — None for unfinished rows)."""
        return self._control("job_status", job=job, results=results)

    def traces(self, limit: Optional[int] = None,
               trace_id: Optional[str] = None,
               fmt: Optional[str] = None) -> Dict[str, Any]:
        """The tier's flight-recorder dump (``traces`` control op): raw
        trace documents + recorder stats, or — ``fmt="chrome"`` — one
        Chrome trace-event JSON object."""
        return self._control("traces", limit=limit, trace_id=trace_id,
                             format=fmt)

    def close(self) -> None:
        self._closed = True
        self._disconnect()

    def __enter__(self) -> "TierClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
