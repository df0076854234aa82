"""The serving tier's wire format: JSON lines over TCP, typed errors (port
of ``serving/frontend/protocol.py``, byte for byte the same format, so a
client or a parent router of either package talks to a tier of the other).

One request per ``\\n``-terminated UTF-8 line, one response line per
request; responses may arrive **out of order** (the tier completes them as
replicas finish), so callers match on the echoed ``id``.

Request object::

    {"op": "score" | "encode" | "decode" | "score_adaptive",  # required
     "x": [..row..] | [[..rows..]],          # required payload
     "k": 50,                                # optional (score/encode only;
                                             #  the k CAP for adaptive ops)
     "target_se": 0.1,                       # adaptive ops only: stop when
     "ess_floor": 64,                        #  SE <= target / ESS >= floor
     "id": <any JSON value>,                 # optional, echoed verbatim
     "client": "tenant-a",                   # optional quota principal
     "model": "table1-iwae-1l-k50",          # optional tenant model
     "precision": "bf16",                    # optional, asserted numerics
     "trace": "<tid>[/<span>]",              # optional trace context
     "seed": 17}                             # optional, single-row only

``target_se`` / ``ess_floor`` are the adaptive accuracy contract
(``score_adaptive``): at least one must be set (a finite positive number),
``k`` becomes the sample cap (defaulting to the fleet's ``k_max``), and
each row's result is the triple ``[log_px, achieved_se, k_used]``. The
shared validator (``buckets.validate_adaptive_target``) runs at the wire,
the router and the engine: a malformed target is a typed ``bad_request``
response at every depth and the connection survives. Targets on a
non-adaptive op are likewise ``bad_request``.

``model`` names which weights must serve the request on a multi-model
tier: the router classifies it onto replicas holding that model, quotas
meter per (client, model), and a model the fleet does not declare is a
typed ``bad_request``, never an answer from the wrong weights. Absent, the
tier's ``default_model`` serves (the ``info`` doc names it, plus a
per-model capability table under ``models``).

``trace`` is the request's tracing context (``telemetry/tracing.py``):
``"<trace-id>"`` or ``"<trace-id>/<parent-span-id>"``, each part 1-64
chars of ``[A-Za-z0-9_.:-]``. Absent, a tracing tier mints a fresh trace;
present, the request's spans join the caller's tree (a parent tier's
``RemoteEngine`` hop span parents the child tier's request span). A
malformed or oversized ``trace`` is a typed ``bad_request`` and the
connection survives. Tracing is host-side metadata only: it never reaches
seeds, payloads or program shapes.

``seed`` is the fleet-composition hook: serving results are a pure function
of (weights, payload, seed, k), so a parent router that mints its own seeds
(``remote.RemoteEngine`` proxying this tier as one replica of a bigger
fleet) gets results that do not depend on which process served the
request. It applies to single-row payloads only (a multi-row request with
``seed`` is a ``bad_request``); ordinary clients never need it, the tier
seeds requests itself in admission order.

``{"op": "info"}`` is answered by the front end itself (ops, per-op row
dims, default k, bucket ladder, replica count); ``{"op": "stats"}`` returns
the live router counters and gauges plus each replica engine's counters;
``{"op": "traces"}`` dumps the tier's flight recorder (optional ``limit``,
``trace_id`` and ``format``: ``"raw"`` trace documents, the default, or
``"chrome"`` for a Chrome trace-event object); ``{"op": "slo"}`` returns
the SLO burn-rate document. Control ops are never routed, quota'd or
counted against the ceiling.

Response object::

    {"id": ..., "ok": true,  "result": [..per-row results..]}
    {"id": ..., "ok": false, "error": "<code>", "message": "...",
     "retry_after_s": 0.25}                    # optional, machine-readable

``retry_after_s`` is the back-off hint of retryable rejections:
``quota_exceeded`` carries the client's exact token-refill wait
(``quotas.py``), ``overloaded`` the tier's configured shed hint. It is
absent where waiting cannot help (``bad_request``, a cost above the quota
burst).

Error codes (:data:`ERROR_CODES`), one per admission or serving outcome;
a rejected request is a typed response, never a dropped connection:

* ``bad_request``   -- malformed JSON, unknown op, wrong payload shape;
* ``overloaded``    -- the global ceiling hit or every replica's queue shed
  (:class:`~..batcher.EngineOverloaded`, :class:`~.router.TierOverloaded`):
  back off and retry;
* ``quota_exceeded``-- the client's token bucket ran dry
  (:class:`~.quotas.QuotaExceeded`): retry after the refill interval;
* ``timeout``       -- the request expired in a replica queue
  (:class:`~..batcher.RequestTimeout`);
* ``unavailable``   -- no healthy replica, or the tier is draining
  (:class:`~.router.ReplicaUnavailable`);
* ``internal``      -- anything else (the replica raised; the request was
  retried on other replicas first, see ``router.py``).

This module is data plumbing only: no sockets, no engines, no numpy.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

#: the typed error taxonomy (see the module docstring)
ERROR_CODES = ("bad_request", "overloaded", "quota_exceeded", "timeout",
               "unavailable", "internal")

#: ops the front end answers itself (never routed to a replica)
CONTROL_OPS = ("info", "stats", "traces", "slo")

#: the bulk offline lane's ops (``jobs.py``), answered synchronously like
#: control ops; the job's rows are pumped through the router in the
#: background, below interactive traffic:
#:
#: ``{"op": "submit_job", "job_op": "score_adaptive", "x": [[..rows..]],
#:    "k": 5000, "target_se": 0.1, "seed": 7, "client": "tenant-a",
#:    "checkpoint_dir": "/path", "checkpoint_every": 256,
#:    "resume": false}``  ->  the job's initial status document
#: ``{"op": "job_status", "job": "job-1", "results": true}``  ->  state,
#:    row counts, checkpoint progress, optionally per-row results
#:
#: Row ``i`` runs under seed ``(seed + i) mod 2**31``, so job results do not
#: depend on pump pacing or interruption; checkpoints are sealed with the
#: training checkpoints' manifests and ``resume`` restores the newest
#: intact prefix without resubmitting it.
JOB_OPS = ("submit_job", "job_status")

#: the largest accepted request line (bytes): a framing bound, not a row
#: bound; 64 MiB fits a max_batch x 784-float payload and stops one endless
#: line from ballooning server memory
MAX_LINE_BYTES = 64 * 1024 * 1024


class ProtocolError(ValueError):
    """Malformed frame or request object (maps to ``bad_request``)."""


def encode_line(obj: Dict[str, Any]) -> bytes:
    """One protocol object as a framed wire line."""
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode("utf-8")


def decode_line(line: bytes) -> Dict[str, Any]:
    """Parse one framed line into a protocol object (dict)."""
    try:
        obj = json.loads(line.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"malformed JSON line: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError(
            f"protocol objects are JSON objects, got {type(obj).__name__}")
    return obj


def ok_response(req_id: Any, result) -> Dict[str, Any]:
    return {"id": req_id, "ok": True, "result": result}


def error_response(req_id: Any, code: str, message: str,
                   retry_after_s: Optional[float] = None) -> Dict[str, Any]:
    if code not in ERROR_CODES:
        code = "internal"
    resp = {"id": req_id, "ok": False, "error": code, "message": message}
    if retry_after_s is not None:
        # only ever a non-negative float: clients sleep on it
        resp["retry_after_s"] = max(0.0, float(retry_after_s))
    return resp


def error_code_for(exc: BaseException) -> str:
    """The typed code a client sees for an exception from admission,
    routing or serving (imports deferred: this module stays light)."""
    from iwae_replication_project_tpu_torch.serving.batcher import (
        EngineOverloaded, RequestTimeout)
    from iwae_replication_project_tpu_torch.serving.frontend.quotas import (
        QuotaExceeded)
    from iwae_replication_project_tpu_torch.serving.frontend.router import (
        ReplicaUnavailable, TierOverloaded)

    if isinstance(exc, QuotaExceeded):
        return "quota_exceeded"
    if isinstance(exc, (TierOverloaded, EngineOverloaded)):
        return "overloaded"
    if isinstance(exc, RequestTimeout):
        return "timeout"
    if isinstance(exc, ReplicaUnavailable):
        return "unavailable"
    if isinstance(exc, (ProtocolError, ValueError, KeyError, TypeError)):
        return "bad_request"
    return "internal"


class LineReader:
    """Buffered ``\\n``-framed reader over a socket-like object.

    ``next_line()`` returns one complete line (without the terminator) or
    None on clean EOF; a line over ``max_line_bytes`` or an EOF mid-line
    raises :class:`ProtocolError`.
    """

    def __init__(self, sock, max_line_bytes: int = MAX_LINE_BYTES):
        self._sock = sock
        self._buf = bytearray()
        self._max = max_line_bytes

    def next_line(self) -> Optional[bytes]:
        while True:
            nl = self._buf.find(b"\n")
            if nl >= 0:
                line = bytes(self._buf[:nl])
                del self._buf[:nl + 1]
                return line
            if len(self._buf) > self._max:
                raise ProtocolError(
                    f"request line exceeds {self._max} bytes")
            chunk = self._sock.recv(65536)
            if not chunk:
                if self._buf:
                    raise ProtocolError("connection closed mid-line")
                return None
            self._buf.extend(chunk)
