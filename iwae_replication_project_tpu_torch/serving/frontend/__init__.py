"""The network-facing serving tier (port of ``serving/frontend/``): N
in-process engine replicas (``ServingEngine`` for small k,
``ShardedScoreEngine`` for paper-grade k) behind one TCP endpoint that
speaks the JAX package's JSON-lines protocol byte for byte:

    client ──TCP──► ServingTier (server.py)
                      │  admission: global ceiling + per-client quotas
                      ▼
                    ReplicaRouter (router.py)
                      │  least-inflight + (op, k) affinity, large-k
                      │  classification, failure reroute
                      ▼
                    engine replicas (serving/engine.py, serving/sharded.py)

One concern per file, every policy testable with fakes: ``protocol.py``
(the wire format and typed error codes), ``quotas.py`` (per-(client,
model) token buckets), ``router.py`` (selection, health, reroute with the
same seed, drain), ``server.py`` (the TCP front end), ``client.py`` (the
socket client), ``remote.py`` (a running tier as one replica of a parent
router), ``retry.py`` (backoff, retryability, deadlines, hedging) and
``jobs.py`` (the bulk offline lane).

Seeds are minted at tier admission in arrival order and carried through
routing, so results are bitwise those of one direct engine fed the same
rows in the same order, however the fleet routed, rerouted or padded the
work. Every request carries a trace context (``telemetry/tracing.py``)
whose spans cover admission, router attempts, remote hops and the
engine's pipeline stages, and each completion feeds the SLO monitor
(``telemetry/slo.py``); both are host-side metadata only.
"""

from iwae_replication_project_tpu_torch.serving.frontend.client import (
    TierClient,
)
from iwae_replication_project_tpu_torch.serving.frontend.protocol import (
    ERROR_CODES,
    error_code_for,
)
from iwae_replication_project_tpu_torch.serving.frontend.quotas import (
    ClientQuotas,
    QuotaExceeded,
    QuotaPolicy,
)
from iwae_replication_project_tpu_torch.serving.frontend.remote import (
    RemoteEngine,
)
from iwae_replication_project_tpu_torch.serving.frontend.retry import (
    RetryPolicy,
)
from iwae_replication_project_tpu_torch.serving.frontend.router import (
    ReplicaRouter,
    ReplicaUnavailable,
    TierOverloaded,
)
from iwae_replication_project_tpu_torch.serving.frontend.server import (
    ServingTier,
)

__all__ = ["ServingTier", "ReplicaRouter", "TierClient", "RemoteEngine",
           "RetryPolicy", "ClientQuotas", "QuotaPolicy", "QuotaExceeded",
           "TierOverloaded", "ReplicaUnavailable", "ERROR_CODES",
           "error_code_for"]
