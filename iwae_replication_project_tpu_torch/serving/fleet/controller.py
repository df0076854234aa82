"""The autoscale decision function: (snapshot, config, seed) → Decision
(port of ``serving/fleet/controller.py``; framework-free, so a copy).

Deterministic by construction — no wall clock, no randomness, no tier
access. Time enters only through each snapshot's ``t`` (the tier's
injectable clock) and the controller's record of when it last acted, which
is itself derived from prior snapshots' ``t``: replay the same snapshot
sequence against the same config and the identical decision sequence falls
out. The chaos smoke and tests lean on this to assert exact logs.

**Hysteresis semantics** (the serving CLI's ``--autoscale-*`` knobs):

* **scale-up** fires when the fast window's worst burn rate crosses
  ``scale_up_burn`` AND the slow window confirms at ``confirm_burn`` —
  the classic SRE multi-window guard: a 5-minute spike alone pages nobody
  and scales nothing unless the hour agrees the budget is actually
  burning. Bounded by ``max_replicas`` and ``up_cooldown_s``.
* **scale-down** fires when the fast burn is at or under
  ``scale_down_burn`` AND nothing is in flight — capacity leaves only
  when idle enough that removing a replica cannot create the breach that
  re-adds it. Bounded by ``min_replicas`` and ``down_cooldown_s``
  (measured from the last scale event in EITHER direction, so a fresh
  scale-up is never immediately unwound).
* the gap between ``scale_up_burn`` and ``scale_down_burn`` is the
  hysteresis band: inside it the fleet holds.

``dry_run`` evaluates and logs every rule identically but stamps the
decision non-actionable — the operator's rehearsal mode
(the serving CLI's ``--autoscale-dry-run``).

Every decision appends one structured record to :attr:`log` (inputs, rule,
action, cooldown state) and publishes ``fleet/*`` gauges/counters to the
registry, so the loop's reasoning is on the same Prometheus page as the
burn rates it read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from iwae_replication_project_tpu_torch.serving.fleet.signals import SignalSnapshot
from iwae_replication_project_tpu_torch.telemetry.registry import MetricRegistry

__all__ = ["AutoscaleConfig", "AutoscaleController", "Decision",
           "choose_victim"]


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """The control loop's knobs (frozen: one immutable policy per loop).

    Defaults are deliberately conservative: scale up only on a confirmed
    burn ≥ 1 (budget burning faster than it refills), scale down only
    when idle, and wait much longer to shrink than to grow."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: fast-window worst burn at/above which the fleet grows
    scale_up_burn: float = 1.0
    #: slow-window confirmation for scale-up (0 = fast window alone)
    confirm_burn: float = 0.0
    #: fast-window worst burn at/below which an idle fleet shrinks
    scale_down_burn: float = 0.25
    up_cooldown_s: float = 30.0
    down_cooldown_s: float = 120.0
    #: window labels (must match the SLOMonitor's — DEFAULT_WINDOWS)
    fast_window: str = "5m"
    slow_window: str = "1h"
    #: evaluate + log decisions but never actuate
    dry_run: bool = False
    #: deterministic tie-break salt: victim choice among equally-loaded
    #: replicas and planner placement order both derive from it — NEVER
    #: from request traffic, so reruns replay exactly
    seed: int = 0
    #: seconds between control ticks (the lifecycle thread's period)
    interval_s: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, "
                             f"got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"min_replicas ({self.min_replicas})")
        if self.scale_down_burn > self.scale_up_burn:
            raise ValueError(
                f"scale_down_burn ({self.scale_down_burn}) above "
                f"scale_up_burn ({self.scale_up_burn}) would make the "
                f"fleet flap: the band between them is the hysteresis")
        for name in ("up_cooldown_s", "down_cooldown_s", "interval_s"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One control tick's outcome (also the decision log's record shape).

    ``action`` is ``"up"``, ``"down"``, or ``"hold"``; ``target`` the
    desired live-replica count after actuation (equal to ``replicas`` on
    hold); ``victim`` the stable index scale-down should drain (None
    otherwise); ``rule`` names the clause that decided (the log's grep
    key); ``dry_run`` marks a decision that must not be actuated."""

    action: str
    target: int
    replicas: int
    rule: str
    reason: str
    t: float
    victim: Optional[int] = None
    dry_run: bool = False

    def record(self, snapshot: SignalSnapshot,
               config: AutoscaleConfig) -> dict:
        """The structured log entry: decision + the inputs it was a pure
        function of (enough to replay the tick)."""
        return {
            "t": self.t, "action": self.action, "rule": self.rule,
            "reason": self.reason, "replicas": self.replicas,
            "target": self.target, "victim": self.victim,
            "dry_run": self.dry_run,
            "inputs": {
                "burn_fast": snapshot.burn(config.fast_window),
                "burn_slow": snapshot.burn(config.slow_window),
                "requests_fast": snapshot.requests_in(config.fast_window),
                "outstanding": snapshot.outstanding,
                "draining": snapshot.draining,
                "unhealthy": snapshot.unhealthy,
            },
        }


def choose_victim(live_indices: Sequence[int], inflight: Sequence[int],
                  seed: int = 0) -> Optional[int]:
    """Which replica a scale-down drains: the least-loaded, youngest-first
    (highest stable index — the most recently joined replica has the
    coldest affinity groups, so removing it disturbs the fewest warm
    paths). Among candidates tied on both, ``seed`` rotates the pick —
    a deterministic salt, not randomness. None when no candidate."""
    if not live_indices:
        return None
    pairs = sorted(zip(live_indices, inflight),
                   key=lambda p: (p[1], -p[0]))
    best = [i for i, load in pairs if load == pairs[0][1]]
    return best[seed % len(best)]


class AutoscaleController:
    """Holds the config, the cooldown state, and the decision log.

    :meth:`decide` is the loop's brain; it never actuates — the
    :class:`~.lifecycle.FleetManager` (or a dry-run operator) owns that.
    ``registry`` is where the ``fleet/*`` instruments land (pass the tier
    router's registry so they share its Prometheus page)."""

    def __init__(self, config: AutoscaleConfig,
                 registry: Optional[MetricRegistry] = None):
        self.config = config
        self.registry = registry if registry is not None else MetricRegistry()
        self.log: List[dict] = []
        #: t of the last actuated scale event per direction (None = never);
        #: derived purely from decided snapshots' t — replay-stable
        self._last_up: Optional[float] = None
        self._last_down: Optional[float] = None
        for name in ("decisions", "scale_ups", "scale_downs", "holds"):
            self.registry.counter(f"fleet/{name}")
        self.registry.gauge("fleet/target_replicas").set(0)

    # -- the decision function ----------------------------------------------

    def decide(self, snap: SignalSnapshot) -> Decision:
        """One tick: reduce the snapshot to a Decision under the config's
        hysteresis/cooldown/bounds rules, append the structured record,
        publish the ``fleet/*`` instruments."""
        cfg = self.config
        fast = snap.burn(cfg.fast_window)
        slow = snap.burn(cfg.slow_window)
        n = snap.replicas
        d = self._decide(snap, cfg, fast, slow, n)
        if not d.dry_run:
            if d.action == "up":
                self._last_up = d.t
            elif d.action == "down":
                self._last_down = d.t
        self.log.append(d.record(snap, cfg))
        self._publish(d, fast, slow)
        return d

    def _decide(self, snap: SignalSnapshot, cfg: AutoscaleConfig,
                fast: float, slow: float, n: int) -> Decision:
        def mk(action, target, rule, reason, victim=None):
            return Decision(action=action, target=target, replicas=n,
                            rule=rule, reason=reason, t=snap.t,
                            victim=victim, dry_run=cfg.dry_run)

        if n == 0:
            # nothing live (mid-fault, or every replica draining): shape
            # changes now would race recovery — the probe loop owns this
            return mk("hold", n, "no-live-replicas",
                      "no live replica to scale against")
        breach = fast >= cfg.scale_up_burn and slow >= cfg.confirm_burn
        if breach:
            if n >= cfg.max_replicas:
                return mk("hold", n, "at-max",
                          f"burn {fast:.2f} breaches {cfg.scale_up_burn} "
                          f"but fleet is at max_replicas={cfg.max_replicas}")
            last = self._last_up
            if last is not None and snap.t - last < cfg.up_cooldown_s:
                return mk("hold", n, "up-cooldown",
                          f"burn {fast:.2f} breaches but last scale-up was "
                          f"{snap.t - last:.1f}s ago "
                          f"(< {cfg.up_cooldown_s}s)")
            return mk("up", n + 1, "burn-breach",
                      f"fast burn {fast:.2f} >= {cfg.scale_up_burn} with "
                      f"slow burn {slow:.2f} >= {cfg.confirm_burn}: grow "
                      f"{n} -> {n + 1}")
        idle = fast <= cfg.scale_down_burn and snap.outstanding == 0
        if idle and n > cfg.min_replicas:
            last_event = max((t for t in (self._last_up, self._last_down)
                              if t is not None), default=None)
            if last_event is not None and \
                    snap.t - last_event < cfg.down_cooldown_s:
                return mk("hold", n, "down-cooldown",
                          f"idle but last scale event was "
                          f"{snap.t - last_event:.1f}s ago "
                          f"(< {cfg.down_cooldown_s}s)")
            victim = choose_victim(snap.live_indices, snap.inflight,
                                   cfg.seed)
            return mk("down", n - 1, "idle",
                      f"fast burn {fast:.2f} <= {cfg.scale_down_burn} with "
                      f"0 outstanding: shrink {n} -> {n - 1} "
                      f"(drain r{victim})", victim=victim)
        if idle:
            return mk("hold", n, "at-min",
                      f"idle but fleet is at min_replicas={cfg.min_replicas}")
        return mk("hold", n, "in-band",
                  f"fast burn {fast:.2f} inside the hysteresis band "
                  f"({cfg.scale_down_burn}, {cfg.scale_up_burn})")

    # -- observability -------------------------------------------------------

    def _publish(self, d: Decision, fast: float, slow: float) -> None:
        reg = self.registry
        reg.counter("fleet/decisions").inc()
        reg.counter("fleet/scale_ups" if d.action == "up" else
                    "fleet/scale_downs" if d.action == "down" else
                    "fleet/holds").inc()
        reg.gauge("fleet/target_replicas").set(d.target)
        reg.gauge("fleet/burn_fast").set(fast)
        reg.gauge("fleet/burn_slow").set(slow)
        reg.gauge("fleet/dry_run").set(1 if d.dry_run else 0)
