"""Signal collection: one immutable snapshot per autoscaler tick (port of
``serving/fleet/signals.py``).

The controller never touches the tier directly — it decides from a
:class:`SignalSnapshot`, a frozen value object built here. That split is
what makes the whole loop deterministic and replayable: feed the same
snapshot sequence to the same config and the same decisions fall out
(tests construct snapshots by hand; the decision log records enough of
each to reconstruct why).

Two constructors, one schema:

* :func:`local_signals` — read the tier in-process: the SLOMonitor's
  snapshot (``telemetry/slo.py``), the router's replica states and
  outstanding count, the executable store's residency scalars;
* :func:`wire_signals` — the same snapshot from a child tier's ``slo``
  control document (:meth:`~..frontend.remote.RemoteEngine.slo`), so a
  fleet-of-fleets parent scales children it only sees as JSON — a JAX
  tier's document as well as the port's: the wire is the same.

Both reduce the per-(model, op) burn-rate document with the SAME pure
functions (:func:`~...telemetry.slo.peak_burns` /
:func:`~...telemetry.slo.window_requests`) — a wire hop must not change
what the controller sees.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

from iwae_replication_project_tpu_torch.telemetry.slo import (
    peak_burns,
    window_requests,
)

__all__ = ["SignalSnapshot", "local_signals", "wire_signals"]


@dataclasses.dataclass(frozen=True)
class SignalSnapshot:
    """Everything one autoscale decision is a function of (plus config).

    ``burns``/``requests`` are keyed by window label (``"5m"``/``"1h"``
    by default): the worst burn rate across every (model, op) class and
    both objectives, and the total trailing-window request count — the
    reductions :func:`~...telemetry.slo.peak_burns` and
    :func:`~...telemetry.slo.window_requests` define. ``t`` comes from
    the tier's (injectable) clock, so cooldown arithmetic is as testable
    as everything else."""

    t: float
    #: live replicas: healthy and not draining (what capacity decisions
    #: count); draining/unhealthy are context, not capacity
    replicas: int
    draining: int
    unhealthy: int
    outstanding: int
    burns: Dict[str, float]
    requests: Dict[str, int]
    #: store residency scalars ({} when unavailable): resident_bytes /
    #: budget_bytes / entries — the placement planner's context
    store: Dict[str, object]
    #: stable indices of the live replicas (victim selection input)
    live_indices: Tuple[int, ...] = ()
    #: per-live-replica inflight, aligned with live_indices
    inflight: Tuple[int, ...] = ()

    def burn(self, label: str) -> float:
        """Worst burn in window ``label`` (0.0 = no traffic observed)."""
        return float(self.burns.get(label, 0.0))

    def requests_in(self, label: str) -> int:
        return int(self.requests.get(label, 0))


def _from_parts(slo_snapshot: dict, replica_states, outstanding: int,
                store: Optional[dict], t: float) -> SignalSnapshot:
    live = [s for s in replica_states
            if s.get("healthy") and not s.get("draining")]
    return SignalSnapshot(
        t=float(t),
        replicas=len(live),
        draining=sum(1 for s in replica_states if s.get("draining")),
        unhealthy=sum(1 for s in replica_states
                      if not s.get("healthy") and not s.get("draining")),
        outstanding=int(outstanding),
        burns=peak_burns(slo_snapshot),
        requests=window_requests(slo_snapshot),
        store=dict(store) if store else {},
        live_indices=tuple(s["index"] for s in live),
        inflight=tuple(int(s.get("inflight", 0)) for s in live),
    )


def local_signals(tier, *,
                  clock: Optional[Callable[[], float]] = None,
                  ) -> SignalSnapshot:
    """Snapshot a local :class:`~..frontend.server.ServingTier`.

    A tier with SLO accounting disabled reads as zero burns (the
    controller then only ever scales on the explicit bounds) — missing
    signal must degrade to "hold", never crash the loop."""
    from iwae_replication_project_tpu_torch.utils.compile_cache import (
        executable_store)

    clk = clock if clock is not None else getattr(tier, "clock",
                                                  time.monotonic)
    slo = getattr(tier, "slo", None)
    snap = slo.snapshot() if slo is not None else {}
    return _from_parts(snap, tier.router.replica_states(),
                       tier.router.outstanding,
                       executable_store().scalar_stats(), clk())


def wire_signals(doc: dict, *, replica_states, outstanding: int = 0,
                 t: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 ) -> SignalSnapshot:
    """Snapshot from a child tier's ``slo`` control document.

    ``doc`` is what :meth:`~..frontend.remote.RemoteEngine.slo` returns
    (``{"enabled": ..., "slo": {...}}`` — the raw ``SLOMonitor.snapshot``
    shape is also accepted); ``replica_states`` come from the PARENT
    router (the parent scales its own proxies — the child's internal
    shape is the child's business)."""
    snap = doc.get("slo", doc) if isinstance(doc, dict) else {}
    return _from_parts(snap if isinstance(snap, dict) else {},
                       replica_states, outstanding, None,
                       t if t is not None else clock())
