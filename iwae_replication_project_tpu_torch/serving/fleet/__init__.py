"""Elastic fleet: the SLO-driven control loop over the serving tier (port
of ``serving/fleet/``, module for module).

This package closes the loop over what the rest of the serving stack
instruments: the burn-rate gauges (telemetry/slo.py), the model-affinity
router with dynamic replica add/remove (frontend/router.py), the
shape-billed executable store with placement pins, whose captured programs
make a joining replica warm (utils/compile_cache.py), and the lossless
drain contract that makes a leaving one invisible. The loop itself is four
small modules, one concern each:

    signals.py ──► controller.py ──► lifecycle.py ──► planner.py
     (observe)       (decide)         (actuate)       (re-place)

* :mod:`.signals` — one :class:`SignalSnapshot` per control tick: the SLO
  burn-rate reductions (worst burn per window, trailing request counts),
  replica states, outstanding work, store residency — from a local tier or
  from the ``slo`` wire control op of a child tier (fleet-of-fleets);
* :mod:`.controller` — :class:`AutoscaleController`: the pure decision
  function (snapshot, config, seed) → :class:`Decision`, with hysteresis
  (up-threshold above down-threshold), per-direction cooldowns, bounds,
  dry-run, and a structured decision log;
* :mod:`.planner` — :func:`plan_placement`: deterministic first-fit-
  decreasing bin-packing of models onto replica store budgets using the
  store's per-model bills — which programs live resident where;
* :mod:`.lifecycle` — :class:`FleetManager`: actuates decisions against a
  live tier (warm scale-up via a replica factory, drain-based scale-down
  via :meth:`~..frontend.router.ReplicaRouter.remove_replica`), applies
  each placement plan as store model-pins + router affinity hints, and
  runs the periodic control thread behind the serving CLI's
  ``--autoscale``.

The invariant every piece preserves: seeds are minted at tier admission in
arrival order, before any replica is chosen — so a fleet that scaled up,
scaled down, or lost a replica mid-scale-event returns bitwise the same
results as one that never changed shape (pinned by
tests/test_torch_fleet.py on the CPU and by chip_smoke.py on the card).
"""

from iwae_replication_project_tpu_torch.serving.fleet.controller import (
    AutoscaleConfig,
    AutoscaleController,
    Decision,
    choose_victim,
)
from iwae_replication_project_tpu_torch.serving.fleet.lifecycle import FleetManager
from iwae_replication_project_tpu_torch.serving.fleet.planner import (
    PlacementPlan,
    plan_placement,
)
from iwae_replication_project_tpu_torch.serving.fleet.signals import (
    SignalSnapshot,
    local_signals,
    wire_signals,
)

__all__ = ["AutoscaleConfig", "AutoscaleController", "Decision",
           "choose_victim", "FleetManager", "PlacementPlan",
           "plan_placement", "SignalSnapshot", "local_signals",
           "wire_signals"]
