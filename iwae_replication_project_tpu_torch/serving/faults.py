"""The engine's fault sites and chaos rule builders (port of
``serving/faults.py``, its engine part).

The engine fires :func:`~..utils.faults.fault_point` at these sites (the
names are the schedule's addressing scheme, so the constants are the one
spelling):

====================  =====================================================
site                  where / ctx keyword arguments
====================  =====================================================
SITE_ENGINE_LAUNCH    ``ServingEngine._launch``, before the batch is padded
                      and launched (``engine``, ``op``, ``k``, ``batch``):
                      a raise lands in exactly that batch's futures, the
                      signal of a replica crash
SITE_ENGINE_FETCH     the completion stage, before the device-to-host
                      fetch (``engine``, ``op``): a deferred device failure
====================  =====================================================

The tier's sites (router dispatch, tier write, remote send) come with the
serving frontend.
"""

from __future__ import annotations

from iwae_replication_project_tpu_torch.utils.faults import (
    FaultRule,
    delay,
    raise_fault,
)

__all__ = ["SITE_ENGINE_LAUNCH", "SITE_ENGINE_FETCH", "crash_replica",
           "slow_replica"]

SITE_ENGINE_LAUNCH = "serve.engine.launch"
SITE_ENGINE_FETCH = "serve.engine.fetch"


def _is_engine(engine):
    return lambda ctx: ctx.get("engine") is engine


def crash_replica(engine, after: int = 0, times=None,
                  name: str = "crash_replica") -> FaultRule:
    """Raise from `engine`'s launch after `after` launches: the batch's
    futures error. ``times=None`` keeps it failing until the schedule is
    cleared; a finite ``times`` models a transient crash."""
    return FaultRule(site=SITE_ENGINE_LAUNCH, after=after, times=times,
                     match=_is_engine(engine), name=name,
                     action=raise_fault("replica crash (chaos)"))


def slow_replica(engine, delay_s: float, after: int = 0, times=1,
                 name: str = "slow_replica") -> FaultRule:
    """Stall `engine`'s dispatcher for `delay_s` on one (or `times`)
    launches: the tail-latency fault."""
    return FaultRule(site=SITE_ENGINE_LAUNCH, after=after, times=times,
                     match=_is_engine(engine), name=name,
                     action=delay(delay_s))
