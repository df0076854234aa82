"""ShardedScoreEngine: paper-grade k behind the serving API (port of
``serving/sharded.py``).

The paper's flagship number is the k=5000 IWAE estimate of log p(x). This
engine serves it per request through the base engine's request lifecycle
(micro-batcher, bucket padding, in-flight window, completion slice) with the
``score`` op swapped for the mesh-sharded large-k program and the
accuracy-targeted ``score_adaptive`` op beside it
(``serving/programs.make_sharded_score_rows``/``_adaptive``):

* **rows over dp, k blocks over sp**: one dispatch per coalesced batch
  however large k is; each block is one encoder pass and one decoder-block
  call (B1 on the card) at ``[k_chunk, bucket/dp]``; the carries merge
  over sp with one MAX and one SUM;
* **one program per bucket serves every k** in ``[1, k_max]``
  (:class:`~.buckets.KChunkMenu`): the kernel gate resolves per bucket,
  never per k, and the metrics stamp one ``"dyn"`` k per bucket, so a
  ragged k stream creates no per-k state;
* **per-request randomness**: row b's block g draws from (engine seed,
  request seed, g), so results do not depend on coalescing, padding or
  which sp rank streams which block, and equal the offline scorers
  (``parallel/eval.sharded_score_offline``, ``_adaptive_offline``) bitwise,
  which call the same programs;
* **the executable store**: each bucket's program is an eager entry of the
  store (``utils/compile_cache.py``), keyed and billed as the base engine's
  (at ``k_chunk`` x ``bucket/dp`` rows): its gloo/NCCL collectives and
  per-row device generators are not captured as CUDA graphs in this slice.
  The store's fault site fires after the followers received a dispatch,
  so on a world of several ranks an injected ``crash_aot_dispatch`` leaves
  them in the program's first collective until the group's timeout.

**One engine over a process-per-rank mesh.** JAX runs one controller over
the whole mesh; the port runs one process per rank (``parallel/``). Every
rank builds the engine with the same arguments. Rank 0 owns it: the queue,
the batcher, both threads and the futures. Every other rank runs
:func:`serve_rank`, a follower loop: for each dispatch it receives from rank
0 a fixed header (op, bucket, k, the targets, the real rows), then the
bucket's seeds and payload (tiny: the whole bucket is broadcast and each
rank takes its dp rows), runs the same program, and takes part in the
gather of the dp rows' results to every rank. Rank 0's :meth:`stop` sends
the header that ends the loops. Every collective of a dispatch is issued by
rank 0's dispatcher thread (the completion thread issues none), in the same
order on the followers, so with ``max_inflight=2`` dispatch N+1's
collectives follow N's and never interleave with them. A world of one
needs no process group and no follower. A follower that dies mid-dispatch
fails rank 0's collective within the process group's timeout (under gloo at
once, the connection closing), which lands in that batch's futures; under
NCCL a dead peer is seen only at the timeout.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from iwae_replication_project_tpu_torch.ops.hot_loop import (
    serving_dispatch_config,
)
from iwae_replication_project_tpu_torch.parallel.mesh import make_mesh
from iwae_replication_project_tpu_torch.serving.buckets import (
    BucketLadder,
    KChunkMenu,
)
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine
from iwae_replication_project_tpu_torch.serving.programs import (
    make_sharded_score_adaptive,
    make_sharded_score_rows,
    program_bytes,
)

__all__ = ["ShardedScoreEngine", "default_sharded_ladder", "serve_rank"]

#: op codes of the dispatch header; 0 ends the followers' loops
OP_CODES = {"score": 1, "score_adaptive": 2}
_OPS = {code: op for op, code in OP_CODES.items()}
#: header: op code, bucket, k, target_se, ess_floor, real rows
_HEADER = 6


def default_sharded_ladder(dp: int, max_batch: int) -> BucketLadder:
    """Batch rungs that are all dp multiples (each rank takes equal row
    shards): ``dp * (1, 2, 4, ...)`` up to ``max_batch`` (floored to a dp
    multiple, at least dp)."""
    rungs = []
    b = dp
    while b < max_batch:
        rungs.append(b)
        b *= 2
    rungs.append(max(max_batch - max_batch % dp, dp) if max_batch >= dp
                 else dp)
    return BucketLadder(tuple(sorted(set(rungs))))


class ShardedScoreEngine(ServingEngine):
    """Mesh-backed ``score`` and ``score_adaptive`` serving replica (see
    the module docstring).

    ``mesh`` is a ``(dp, sp)`` mesh of ``parallel.make_mesh`` (None:
    ``make_mesh(dp=1, sp=world)`` on `device`, the card unless ``"cpu"``;
    k is the axis that scales). ``k_chunk`` is the sample-block size (it
    versions the sample stream: results are a pure function of (weights,
    payload, engine seed, request seed, k, k_chunk)); ``k_max`` the
    admission bound. Ladder rungs must be dp multiples (the default ladder
    is). An inherited default k (the checkpoint's, or 50) is clamped to
    ``k_max``; an explicit one must fit. The rest is the base engine's.
    """

    _GATED_OPS = ("score", "score_adaptive")
    _ADAPTIVE_OPS = ("score_adaptive",)
    #: the trace span of the arguments' window: the payload's copy and the
    #: followers' header (the noise is drawn on the card, per block)
    _ARGS_SPAN = "engine/args"

    def __init__(self, source=None, *, params=None, model_config=None,
                 mesh=None, k_chunk: int = 250, k_max: int = 5000,
                 k: Optional[int] = None, max_batch: int = 8,
                 ladder: Optional[BucketLadder] = None, device=None, **kw):
        if mesh is None:
            world = dist.get_world_size() if dist.is_available() and \
                dist.is_initialized() else 1
            mesh = make_mesh(dp=1, sp=world, device=device)
        if kw.get("precision") == "int8":
            raise ValueError("the sharded large-k engine serves the fp32 "
                             "and bf16 policies; int8 is served by the "
                             "fast engines only (as in the JAX package)")
        dp = mesh.dp
        if ladder is None:
            ladder = default_sharded_ladder(dp, max_batch)
        bad = [b for b in ladder.buckets if b % dp != 0]
        if bad:
            raise ValueError(f"sharded batch buckets must be multiples of "
                             f"dp={dp}; got {bad}")
        super().__init__(source, params=params, model_config=model_config,
                         k=k, max_batch=ladder.max_batch, ladder=ladder,
                         device=mesh.device, **kw)
        self.menu = KChunkMenu(batch=ladder, k_chunk=int(k_chunk),
                               k_max=int(k_max))
        if k is None:
            self.k = min(self.k, int(k_max))
        self.k = self.menu.validate_k(self.k)
        self.k_max = int(k_max)
        self.mesh = mesh
        self.sharded = True
        self._programs = {
            "score": (make_sharded_score_rows(self.cfg, mesh, int(k_chunk)),
                      True),
            "score_adaptive": (make_sharded_score_adaptive(
                self.cfg, mesh, int(k_chunk)), True)}
        #: (op, dispatch cfg) -> program
        self._sharded_programs: Dict[tuple, object] = {}
        self.row_dims = {"score": self.cfg.x_dim,
                         "score_adaptive": self.cfg.x_dim}
        self._followers_stopped = False

    @property
    def _multi(self) -> bool:
        return self.mesh.device_mesh is not None

    def submit(self, op: str, row, k: Optional[int] = None, **kw):
        if self.mesh.rank != 0:
            raise RuntimeError("only rank 0's engine takes requests; run "
                               "serve_rank(engine) on the other ranks")
        return super().submit(op, row, k, **kw)

    def stop(self) -> None:
        """Drain and stop the pipeline (the base engine's :meth:`stop`),
        then end the followers' loops. A broken process group (a follower
        died) raises here."""
        super().stop()
        if self._multi and self.mesh.rank == 0 and \
                not self._followers_stopped:
            self._followers_stopped = True
            with self._launch_context():
                self.mesh.broadcast(torch.zeros(_HEADER, dtype=torch.float64,  # iwaelint: disable=dtype-promotion -- the stop header: the dispatch header's type, never model numerics
                                                device=self.device))

    # -- the dispatch hooks ----------------------------------------------

    def _stamp_k(self, op: str, k: int):
        """One ``"dyn"`` k per bucket: the gate's memo and the kernel
        stamp are per bucket, the gate resolved at (k_chunk, bucket/dp),
        never per request k."""
        return "dyn"

    def _prof_adaptive(self, inf, out):
        """An adaptive dispatch's ``(flops, total k_used)`` at each row's
        own ``k_used`` (the result's third column), never the cap: a batch
        of easy rows bills what it computed. The base engine's
        :meth:`_prof_flops` already counts a score dispatch at the
        request's own k under the bucket's ``"dyn"`` key."""
        if inf.op not in self._ADAPTIVE_OPS or out is None:
            return None
        from iwae_replication_project_tpu_torch.utils.flops import (
            serving_score_flops_per_row)
        k_used = out[:len(inf.batch), 2]
        flops = float(sum(serving_score_flops_per_row(self.cfg, int(ku))
                          for ku in k_used))
        return flops, float(k_used.sum())

    def _trace_attrs(self, op: str, k: int, bucket: int, n: int) -> dict:
        """The base attrs plus the streaming shape, so a large-k dispatch's
        time in a trace reads against its blocks: the request k (the cap
        for an adaptive op), ``k_chunk``, the blocks ``ceil(k / k_chunk)``
        (an adaptive row may stop earlier) and the mesh."""
        attrs = super()._trace_attrs(op, k, bucket, n)
        attrs.update({"sharded": True, "k_chunk": self.menu.k_chunk,
                      "blocks": self.menu.n_chunks(k),
                      "dp": self.mesh.dp, "sp": self.mesh.sp})
        return attrs

    def _program_for(self, op: str, k: int, bucket: int):
        cfg_d, _ = self._kernel_for(op, k, bucket)
        key = (op, cfg_d)
        prog = self._sharded_programs.get(key)
        if prog is None:
            make = make_sharded_score_adaptive \
                if op in self._ADAPTIVE_OPS else make_sharded_score_rows
            prog = self._sharded_programs[key] = make(cfg_d, self.mesh,
                                                      self.menu.k_chunk)
        return prog

    def _dispatch_args(self, op: str, k: int, bucket: int,
                       payload: np.ndarray, seeds: List[int],
                       targets: Optional[Tuple[float, float]] = None,
                       n_real: Optional[int] = None) -> Tuple[tuple, dict]:
        """Send the dispatch to the followers (header, seeds, payload), then
        the program's arguments: k, the targets and the real rows are plain
        numbers, so one program per bucket serves them all."""
        tse, floor = targets if targets is not None else (0.0, 0.0)
        n_real = bucket if n_real is None else int(n_real)
        x = torch.from_numpy(payload).to(self.device, non_blocking=True)
        if self._multi:
            if self._followers_stopped:
                raise RuntimeError("the followers were stopped; this "
                                   "engine takes no more dispatches")
            mesh = self.mesh
            mesh.broadcast(torch.tensor(
                [OP_CODES[op], bucket, k, tse, floor, n_real],
                dtype=torch.float64, device=self.device))  # iwaelint: disable=dtype-promotion -- the broadcast dispatch header carries k, the bucket and the target se exactly (integers to 2^53); it never enters the model's numerics
            mesh.broadcast(torch.tensor(seeds, dtype=torch.int64,
                                        device=self.device))
            mesh.broadcast(x)
        return self._args(op, k, x, list(seeds), tse, floor, n_real)

    def _args(self, op, k, x, seeds, tse, floor, n_real):
        if op in self._ADAPTIVE_OPS:
            return ((self._params, self._base_seed, seeds, x, k, tse, floor),
                    {"n_real": n_real})
        return (self._params, self._base_seed, seeds, x, k), {}

    def _resolve_kernel(self, op: str, k: int, bucket: int) -> tuple:
        """The gate at the model's widths alone: one program serves every
        k in ``k_chunk`` blocks, so no ``serving_row`` winner of one
        (k, bucket) applies to it."""
        return serving_dispatch_config(self.cfg, device=self.device,
                                       force=self.kernel_path,
                                       gated=op in self._GATED_OPS)

    def _build_key(self, op: str, k: int, bucket: int) -> tuple:
        """The base key (the stamp k is ``"dyn"``) with the mesh and the
        sample block, which the program bakes in."""
        return super()._build_key(op, k, bucket) + (
            self.mesh.dp, self.mesh.sp, self.mesh.rank, self.menu.k_chunk)

    def _program_nbytes(self, op: str, k: int, bucket: int) -> int:
        cfg, _ = self._kernel_for(op, k, bucket)
        return program_bytes(cfg, "score", self.menu.k_chunk,
                             bucket // self.mesh.dp)

    def _entry(self, op: str, k: int, bucket: int, program, args: tuple,
               kwargs: dict) -> tuple:
        """The program itself, eager, on its full arguments (seeds and k
        are per dispatch); keyed on the payload's shape."""
        return program, args, kwargs, (args[3],), False

    def _serve_one(self) -> bool:
        """A follower's side of one dispatch; False on rank 0's stop."""
        dev = self.device
        with self._launch_context():
            header = torch.zeros(_HEADER, dtype=torch.float64, device=dev)  # iwaelint: disable=dtype-promotion -- the follower's receive buffer of the float64 dispatch header
            self.mesh.broadcast(header)
            code, bucket, k, tse, floor, n_real = header.tolist()
            if code == 0:
                return False
            op, bucket, k = _OPS[int(code)], int(bucket), int(k)
            seeds = torch.zeros(bucket, dtype=torch.int64, device=dev)
            self.mesh.broadcast(seeds)
            x = torch.empty((bucket, self.row_dims[op]), dtype=torch.float32,
                            device=dev)
            self.mesh.broadcast(x)
            args, kwargs = self._args(op, k, x, seeds.tolist(), tse, floor,
                                      int(n_real))
            self._program_for(op, k, bucket)(*args, **kwargs)
        return True

    def warmup(self, ops: Sequence[str] = ("score", "score_adaptive")
               ) -> Dict[str, float]:
        """Run every bucket once at the engine's k: one program per bucket
        serves every k and target, so this covers the whole k range."""
        return super().warmup(ops=ops)


def serve_rank(engine: ShardedScoreEngine) -> int:
    """The follower loop of every rank but 0 (see the module docstring):
    serves rank 0's dispatches until its :meth:`~ShardedScoreEngine.stop`;
    returns the number served. A broken process group raises."""
    if engine.mesh.rank == 0:
        raise ValueError("rank 0 owns the engine; serve_rank runs on the "
                         "other ranks")
    n = 0
    while engine._serve_one():
        n += 1
    return n
