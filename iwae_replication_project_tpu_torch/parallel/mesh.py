"""The ``(dp, sp)`` process mesh (port of ``parallel/mesh.py``).

* ``dp``, data parallelism: each dp rank takes ``B/dp`` rows of every
  batch, and the gradients are averaged over dp;
* ``sp``, sample parallelism: each sp rank draws ``k/sp`` of the
  importance samples, and the bound's log-mean-exp merges over sp with one
  MAX and one SUM ``all_reduce`` (``parallel/dp.py``).

There is one process per rank. The ranks form a ``torch.distributed``
process group (NCCL on the card, gloo on the CPU: ``multihost.initialize``)
laid out as a 2-D ``DeviceMesh`` with dims ``("dp", "sp")``: global rank
``r`` sits at ``(r // sp, r % sp)``, so the sp ranks of a dp row are
neighbours. The sp and dp groups come from ``DeviceMesh.get_group``; the
gradient reduction runs on the whole world. A world of one process needs no
process group: ``make_mesh(1, 1)`` works uninitialised, and its collectives
are the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from iwae_replication_project_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: str = "dp"
    sp: str = "sp"


AXES = MeshAxes()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a ``(dp, sp)`` mesh.

    ``device_mesh`` is None for the uninitialised world of one; then every
    collective of :meth:`all_reduce` and :meth:`broadcast` is the
    identity."""

    dp: int
    sp: int
    rank: int
    device: torch.device
    device_mesh: Optional[object] = None

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.sp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp

    @property
    def backend(self) -> Optional[str]:
        """The process group's backend (``"nccl"``, ``"gloo"``), None
        uninitialised."""
        return None if self.device_mesh is None else dist.get_backend()

    def group(self, axis: Optional[str]):
        """The process group of mesh axis ``"dp"`` or ``"sp"``; None for the
        whole world."""
        if self.device_mesh is None or axis is None:
            return None
        return self.device_mesh.get_group(mesh_dim=axis)

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   axis: Optional[str] = None) -> torch.Tensor:
        """`t` reduced in place over the ranks of mesh axis `axis` (None:
        the world) with ``"sum"`` or ``"max"``; returns `t`."""
        if self.device_mesh is not None:
            dist.all_reduce(t, op=_OPS[op], group=self.group(axis))
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`t` overwritten in place with global rank `src`'s."""
        if self.device_mesh is not None:
            dist.broadcast(t, src=src)
        return t

    def barrier(self) -> None:
        if self.device_mesh is not None:
            self.all_reduce(torch.zeros(1, device=self.device))


def make_mesh(dp: Optional[int] = None, sp: int = 1,
              device=None) -> Mesh:
    """The ``(dp, sp)`` mesh of the current process group; with `dp` None,
    dp absorbs the ranks sp leaves.

    `device` is this rank's device (None: the card). Without a process
    group the world is this one process. Sizes the world cannot hold raise
    ``ValueError``; a mesh must also take every rank, since a rank outside
    it would have no part of the work. Under NCCL one ``all_reduce`` on
    each group creates its communicator here, before any CUDA graph could
    capture a collective.
    """
    initialized = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if sp < 1 or (dp is not None and dp < 1):
        raise ValueError(f"mesh sizes must be >= 1, got dp={dp}, sp={sp}")
    if dp is None:
        if n % sp != 0:
            raise ValueError(f"sp={sp} must divide the world size {n}")
        dp = n // sp
    if dp * sp > n:
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} ranks, have {n}")
    if dp * sp < n:
        raise ValueError(f"mesh {dp}x{sp} takes {dp * sp} of the {n} ranks; "
                         f"every rank must have a place in the mesh")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not initialized:
        return Mesh(dp=dp, sp=sp, rank=0, device=dev)
    from torch.distributed.device_mesh import DeviceMesh
    dm = DeviceMesh(dev.type, torch.arange(n).reshape(dp, sp),
                    mesh_dim_names=(AXES.dp, AXES.sp))
    mesh = Mesh(dp=dp, sp=sp, rank=rank, device=dev, device_mesh=dm)
    for axis in (None, AXES.dp, AXES.sp):
        mesh.all_reduce(torch.zeros(1, device=dev), axis=axis)
    return mesh
