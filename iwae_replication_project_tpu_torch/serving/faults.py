"""The serving stack's fault sites and the rules that fire at them (port of
``serving/faults.py``).

The serving stack fires :func:`~..utils.faults.fault_point` at these sites
(the names are the schedule's addressing scheme and the JAX package's
strings, so the constants are the one spelling):

====================  =====================================================
site                  where / ctx keyword arguments
====================  =====================================================
SITE_ENGINE_LAUNCH    ``ServingEngine._launch``, before the batch is padded
                      and launched (``engine``, ``op``, ``k``, ``batch``):
                      a raise lands in exactly that batch's futures, the
                      signal of a replica crash
SITE_ENGINE_FETCH     the completion stage, before the device-to-host
                      fetch (``engine``, ``op``): a deferred device failure
SITE_ROUTER_DISPATCH  ``ReplicaRouter._dispatch``, inside the per-replica
                      submit try (``router``, ``replica``, ``attempt``)
SITE_TIER_WRITE       the tier connection's response write, under the
                      connection lock before ``sendall`` (``sock``,
                      ``conn``): where dropped and garbled TCP lives
SITE_REMOTE_SEND      ``RemoteEngine.submit``, inside the send try
                      (``addr``): an ``OSError`` here poisons the proxy
====================  =====================================================

:func:`crash_aot_dispatch` fires at ``utils.faults.SITE_AOT_CALL_ASYNC``,
inside the executable store (``utils/compile_cache.aot_call_async``), where
every serving dispatch enters it (``name``: the program, ``serve_<op>``).
"""

from __future__ import annotations

import contextlib
import socket

from iwae_replication_project_tpu_torch.utils.faults import (
    SITE_AOT_CALL_ASYNC,
    FaultContext,
    FaultRule,
    delay,
    raise_error,
    raise_fault,
)

__all__ = ["SITE_ENGINE_LAUNCH", "SITE_ENGINE_FETCH", "SITE_ROUTER_DISPATCH",
           "SITE_TIER_WRITE", "SITE_REMOTE_SEND", "SITE_AOT_CALL_ASYNC",
           "crash_replica", "slow_replica", "drop_tier_connection",
           "garble_tier_connection", "crash_aot_dispatch", "sever_remote"]

SITE_ENGINE_LAUNCH = "serve.engine.launch"
SITE_ENGINE_FETCH = "serve.engine.fetch"
SITE_ROUTER_DISPATCH = "serve.router.dispatch"
SITE_TIER_WRITE = "serve.tier.write"
SITE_REMOTE_SEND = "serve.remote.send"


def _is_engine(engine):
    return lambda ctx: ctx.get("engine") is engine


def crash_replica(engine, after: int = 0, times=None,
                  name: str = "crash_replica") -> FaultRule:
    """Raise from `engine`'s launch after `after` launches: the batch's
    futures error, and a router marks the replica unhealthy and reroutes its
    work with the original seeds. ``times=None`` keeps it failing until the
    schedule is cleared; a finite ``times`` models a transient crash."""
    return FaultRule(site=SITE_ENGINE_LAUNCH, after=after, times=times,
                     match=_is_engine(engine), name=name,
                     action=raise_fault("replica crash (chaos)"))


def slow_replica(engine, delay_s: float, after: int = 0, times=1,
                 name: str = "slow_replica") -> FaultRule:
    """Stall `engine`'s dispatcher for `delay_s` on one (or `times`)
    launches: the tail-latency fault client hedging exists for."""
    return FaultRule(site=SITE_ENGINE_LAUNCH, after=after, times=times,
                     match=_is_engine(engine), name=name,
                     action=delay(delay_s))


def _kill_sock(fc: FaultContext) -> None:
    sock_ = fc.ctx.get("sock")
    if sock_ is not None:
        with contextlib.suppress(OSError):
            sock_.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            sock_.close()


def drop_tier_connection(after: int = 0, times=1,
                         name: str = "drop_connection") -> FaultRule:
    """Close the client connection under the tier's response write: the
    response is produced but never delivered, and the client must reconnect
    and retry. The action touches only the socket (it never raises), so the
    server's own ``OSError`` handling runs as for a real peer reset."""
    return FaultRule(site=SITE_TIER_WRITE, after=after, times=times,
                     name=name, action=_kill_sock)


def _garble_sock(fc: FaultContext) -> None:
    sock_ = fc.ctx.get("sock")
    if sock_ is not None:
        with contextlib.suppress(OSError):
            # not JSON, not even UTF-8: the client's framed reader must
            # raise a ProtocolError
            sock_.sendall(b"\xff\xfe{garbled" + b"\n")


def garble_tier_connection(after: int = 0, times=1,
                           name: str = "garble_connection") -> FaultRule:
    """Put garbage bytes on the wire before a response line (under the
    connection's write lock, so the garbage is frame-aligned): the client
    reads a malformed frame and must treat the connection as poisoned."""
    return FaultRule(site=SITE_TIER_WRITE, after=after, times=times,
                     name=name, action=_garble_sock)


def crash_aot_dispatch(after: int = 0, times=1,
                       program_prefix: str = "serve_",
                       name: str = "crash_aot") -> FaultRule:
    """Raise inside the executable store's ``aot_call_async`` for programs
    whose name starts with `program_prefix`: the failure class of a launch
    (out of memory, a poisoned context) that must land in exactly the
    affected batch's futures and never kill a dispatcher thread."""
    return FaultRule(
        site=SITE_AOT_CALL_ASYNC, after=after, times=times, name=name,
        match=lambda ctx: str(ctx.get("name", "")).startswith(program_prefix),
        action=raise_fault("AOT dispatch failure (chaos)"))


def sever_remote(after: int = 0, times=1,
                 name: str = "sever_remote") -> FaultRule:
    """Raise ``OSError`` from ``RemoteEngine``'s socket send: the proxy
    poisons itself, its outstanding futures fail typed, and under a
    ``RetryPolicy`` the next submit dials a fresh connection."""
    return FaultRule(site=SITE_REMOTE_SEND, after=after, times=times,
                     name=name,
                     action=raise_error(
                         lambda fc: OSError("connection severed (chaos)")))
