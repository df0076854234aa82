"""Cost-model placement: bin-pack models onto replica store budgets (port
of ``serving/fleet/planner.py``; framework-free, so a copy).

The executable store bills every resident program the bytes reckoned from
its shapes (utils/compile_cache.py, ``serving.programs.program_bytes``),
and :meth:`~...utils.compile_cache.ExecutableStore.model_costs` sums that per
model — what one replica pays in store budget to keep a model's working
set warm. This module turns those costs plus per-replica budgets into a
:class:`PlacementPlan`: which models live *resident* where.

The packing is deterministic first-fit-decreasing — models sorted by
(cost desc, name asc), replicas visited in stable-index order rotated by
the config seed — so the same (costs, budgets, capabilities, seed)
always yields the same plan, and the decision log's placement records
replay. A model that fits no budgeted replica goes to ``overflow``: it is
still SERVED (routing eligibility never depends on placement — the
store's LRU tiers handle its executables), it just isn't pinned resident
anywhere.

Applying a plan is the lifecycle's job: model-level store pins
(:meth:`~...utils.compile_cache.ExecutableStore.pin_model`) make the
placed working sets unevictable, and router affinity hints
(:meth:`~..frontend.router.ReplicaRouter.prime_affinity`) steer each
model's traffic to its planned home — both re-applied on every
fleet-shape change, neither affecting results (seeds were minted at
admission; placement only moves warmth).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

__all__ = ["PlacementPlan", "plan_placement"]


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """One placement decision (immutable; logged verbatim).

    ``assignments`` maps each replica's stable index to the models planned
    resident there (sorted tuples throughout — the plan is its own
    canonical form); ``overflow`` lists models no budgeted replica could
    hold; ``costs`` echoes the cost model the packing used."""

    assignments: Tuple[Tuple[int, Tuple[str, ...]], ...]
    overflow: Tuple[str, ...]
    costs: Tuple[Tuple[str, int], ...]

    def models_for(self, index: int) -> Tuple[str, ...]:
        for i, models in self.assignments:
            if i == index:
                return models
        return ()

    def placed(self) -> Tuple[str, ...]:
        """Every model the plan made resident somewhere (sorted)."""
        return tuple(sorted({m for _, ms in self.assignments for m in ms}))

    def home_of(self, model: str) -> Optional[int]:
        """The replica index a model's traffic should favor (None when
        overflowed or unknown)."""
        for i, models in self.assignments:
            if model in models:
                return i
        return None

    def record(self) -> dict:
        """The decision-log entry shape."""
        return {"assignments": [[i, list(ms)] for i, ms in self.assignments],
                "overflow": list(self.overflow),
                "costs": {m: c for m, c in self.costs}}


def plan_placement(model_costs: Mapping[str, int],
                   replica_budgets: Mapping[int, Optional[int]],
                   *,
                   replica_models: Optional[Mapping[int, frozenset]] = None,
                   seed: int = 0) -> PlacementPlan:
    """First-fit-decreasing packing of ``model_costs`` onto
    ``replica_budgets``.

    ``replica_budgets`` maps stable replica index → store budget bytes
    (None = unbounded: everything offered fits). ``replica_models``
    optionally restricts which models a replica may host (its capability
    set — a replica is never planned to hold weights it doesn't have);
    absent, every replica may host every model. ``seed`` rotates the
    replica visiting order — the deterministic tie-break between replicas
    with equal remaining headroom, matching the controller's victim salt.
    """
    order = sorted(model_costs.items(), key=lambda kv: (-kv[1], kv[0]))
    indices = sorted(replica_budgets)
    if indices and seed:
        rot = seed % len(indices)
        indices = indices[rot:] + indices[:rot]
    remaining: Dict[int, Optional[float]] = {
        i: (None if replica_budgets[i] is None else float(replica_budgets[i]))
        for i in indices}
    placed: Dict[int, list] = {i: [] for i in indices}
    overflow = []
    for model, cost in order:
        home = None
        for i in indices:
            if replica_models is not None and \
                    model not in replica_models.get(i, frozenset()):
                continue
            room = remaining[i]
            if room is None or room >= cost:
                home = i
                break
        if home is None:
            overflow.append(model)
            continue
        placed[home].append(model)
        if remaining[home] is not None:
            remaining[home] -= cost
    return PlacementPlan(
        assignments=tuple(sorted((i, tuple(sorted(ms)))
                                 for i, ms in placed.items())),
        overflow=tuple(sorted(overflow)),
        costs=tuple(sorted((m, int(c)) for m, c in model_costs.items())),
    )
