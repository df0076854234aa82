"""Processes and their process group (port of ``parallel/multihost.py``).

The JAX package runs one process per host and lets ``jax.distributed``
join the hosts. Here every rank of the mesh is a process of its own, with
one card each (or a share of the CPU):

* :func:`initialize` joins this process to the group, through
  ``torch.distributed.init_process_group``: the rendezvous is
  ``tcp://<coordinator>`` (or a ``file://`` or ``tcp://`` URL as given);
  where the arguments are None, torchrun's ``RANK``, ``WORLD_SIZE`` and
  ``MASTER_ADDR``/``MASTER_PORT`` take their place (JAX's auto-detection).
  The backend is NCCL for ranks on CUDA, one card per rank, and gloo on the
  CPU; only a caller of this function may name gloo for CUDA tensors
  (several ranks on one card, as the tests and ``chip_smoke.py`` run them).
  A timeout is always set;
* :func:`spawn` starts one process per rank on this host and waits for
  them, with a timeout, killing the rest when one fails (the driver's
  ``--mesh-dp``/``--mesh-sp`` without ``--multihost``);
* the training state is replicated on every rank, so :func:`fetch` is the
  identity, and each rank takes its own ``B/dp`` rows of a batch
  (:func:`host_local_batch_to_global` checks that they do).
"""

from __future__ import annotations

import datetime
import os
import signal
import sys
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from iwae_replication_project_tpu_torch.utils.device import resolve_device

#: how long a collective may wait for the other ranks before it fails
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> dict:
    """Join (or form) the process group; returns :func:`process_info`.

    `coordinator_address` is ``host:port`` of rank 0 (or a ``tcp://`` or
    ``file://`` URL); None reads ``MASTER_ADDR``/``MASTER_PORT``.
    `num_processes` and `process_id` default to ``WORLD_SIZE`` and
    ``RANK``. `device` is where this rank runs (None: the card); on CUDA
    the rank takes local card ``LOCAL_RANK`` (else ``process_id`` modulo
    the cards of the host) and the backend is NCCL unless `backend` says
    otherwise.
    """
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = dev.index if dev.index is not None else int(env.get(
            "LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, world_size=world, rank=rank,
        timeout=timeout)
    return process_info()


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> dict:
    """This process's place in the cluster (for logging and data slicing)."""
    on = dist.is_initialized()
    return {"process_index": dist.get_rank() if on else 0,
            "process_count": dist.get_world_size() if on else 1,
            "local_device_count": torch.cuda.device_count(),
            "backend": dist.get_backend() if on else None}


def fetch(tree):
    """The host values of replicated outputs: every rank holds them whole,
    so this is the identity (the JAX package's ``fetch`` gathers from
    other hosts)."""
    return tree


def host_local_batch_to_global(batch: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch, as the mesh's steps take them:
    each rank holds its own contiguous ``B/dp`` rows (its dp row's slice).
    Checks, with one MAX ``all_reduce``, that every rank holds as many rows
    and returns the batch on the rank's device; the global batch never
    exists on one host."""
    rows = torch.tensor([batch.shape[0], -batch.shape[0]],
                        dtype=torch.float32, device=mesh.device)
    mesh.all_reduce(rows, op="max")
    if int(rows[0]) != -int(rows[1]):
        raise ValueError(f"ranks hold {-int(rows[1])} to {int(rows[0])} "
                         f"rows: each must hold its B/dp = "
                         f"{batch.shape[0]} rows")
    return batch.to(mesh.device)


# ---------------------------------------------------------------------------
# one process per rank on this host
# ---------------------------------------------------------------------------

def _child(fn: Callable, rank: int, world: int, args: Sequence) -> None:
    try:
        code = fn(rank, world, *args)
    except SystemExit as e:
        code = e.code
    except BaseException:  # the parent reads the exit code, not this
        traceback.print_exc()
        sys.stderr.flush()
        code = 1
    sys.stdout.flush()
    os._exit(code if isinstance(code, int) else (0 if code is None else 1))


def spawn(fn: Callable, world: int, args: Sequence = (), *,
          timeout: Optional[float] = None, grace: float = 30.0
          ) -> List[Optional[int]]:
    """Run ``fn(rank, world, *args)`` in `world` fresh processes (start
    method ``spawn``) and return their exit codes, rank by rank; ``fn``'s
    return value is the code (None: 0).

    When a process fails, the others get `grace` seconds to finish (they
    may be waiting in a collective for it) and are then killed. Past
    `timeout` seconds every process still running is killed and
    ``TimeoutError`` raised. A SIGTERM to this process is passed on to the
    ranks, whose preemption grace handles it.
    """
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    old = None
    try:
        old = signal.signal(signal.SIGTERM, forward)
    except ValueError:  # not the main thread: nothing to forward from
        old = None
    try:
        deadline = None if timeout is None else time.monotonic() + timeout
        failed_at = None
        while any(p.is_alive() for p in procs):
            now = time.monotonic()
            if deadline is not None and now > deadline:
                _kill(procs)
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout:.0f} s: killed")
            if failed_at is None and any(
                    p.exitcode not in (None, 0) for p in procs):
                failed_at = now
            if failed_at is not None and now - failed_at > grace:
                _kill(procs)
                break
            for p in procs:
                p.join(0.05)
        return [p.exitcode for p in procs]
    finally:
        if old is not None:
            signal.signal(signal.SIGTERM, old)
        _kill(procs)


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)
