"""The audited program suite: the port's real programs, recorded (port of
``programs.py``).

Builders return :class:`~.core.AuditProgram`\\ s for the programs the port
dispatches on the card, recorded on CPU tensors by ``graphs.trace`` with
the kernel paths the card takes: every kernel wrapper records its plain
version, stamped as the kernel's region. Each program takes every tensor
it reads as an argument (weights, optimizer state, payload, noise), as the
JAX package's build functions trace ``fn(params, ...)``.

=====================  ===============================================
JAX program            the port's program
=====================  ===============================================
``train_step``         ``training/train_step.make_train_step``'s step on
                       the flagship (logits, bf16 operands) through
                       ``FusedBlockLL`` (B1 forward, B2's plain backward
                       ``_bwd_plain``), with Adam's in-place updates of
                       the parameters, gradients and moments declared as
                       ``state_inputs``
``eval_scorer_k5000``  ``evaluation/metrics.streaming_log_px`` at
                       k=5000 in chunks of 250 through B1; the Python
                       chunk loop unrolls, each chunk's intermediates
                       dead before the next
``serve_score``        ``serving/programs.PROGRAMS`` under the card's
``serve_encode``       dispatch config (``row_invariant=True``: the
``serve_decode``       fixed-order ``row_dense``/``row_sum`` plain
                       versions; score through B1), noise injected, the
                       padded rows of a bucket declared as taints
``serve_score_fused``  the score program under the blocked-scan pin of
                       the fused dispatch config (JAX's choice, :146)
``serve_score_sharded`` ``make_sharded_score_rows`` over a
                       ``graphs.RecordingMesh`` of (dp, sp) = (1, 2):
                       each ``all_reduce``/``broadcast`` a recorded node
``hot_loop_reference`` the three ``ops/hot_loop.select_path`` paths
``hot_loop_blocked_scan`` composed with ``iwae_per_example``;
``hot_loop_kernel``    ``hot_loop_kernel`` is JAX's ``hot_loop_pallas``
=====================  ===============================================

Shapes are audit-representative, not production-sized: the passes check
program *structure*, which k and batch scale without changing, with two
exceptions the docstrings of ``ops/row_invariant`` state: ``rowwise`` and
the slab sums unroll a Python loop per row or slab, so the serving graphs
grow with the bucket (capped here at 8) while their structure per row
stays the same. Padded axes have pairwise-distinct sizes (bucket 8 of 5
real rows, k=4, latents 100 and 50). ``build_programs(..., mode="fake",
shapes=...)`` records the same programs at full width on fake tensors for
the cost analyzer.

B3/B4 (``ops/fused_likelihood``) lie on no program of the port: the model
fuses its likelihood through the hot loop; their op is tested alone.
"""

from __future__ import annotations

import dataclasses
import functools
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import torch

from iwae_replication_project_tpu_torch.analysis.audit.core import AuditProgram

#: program names in build order (the CLI's default suite)
PROGRAM_NAMES = (
    "train_step",
    "eval_scorer_k5000",
    "serve_score",
    "serve_encode",
    "serve_decode",
    "serve_score_fused",
    "serve_score_sharded",
    "hot_loop_reference",
    "hot_loop_blocked_scan",
    "hot_loop_kernel",
)

#: the audit shapes (the JAX package's)
TRAIN_K, TRAIN_B = 8, 16
EVAL_B, EVAL_K, EVAL_CHUNK = 16, 5000, 250
BUCKET, REAL_ROWS, SERVE_K = 8, 5, 4
SHARDED_K, SHARDED_CHUNK = 10, 4


def flagship():
    """The flagship architecture as the card runs it: logits, bf16
    operands."""
    from iwae_replication_project_tpu_torch.models.iwae import ModelConfig

    return ModelConfig.two_layer(likelihood="logits",
                                 compute_dtype="bfloat16")


def card_config(cfg, *, serving: bool = False, gated: bool = True,
                path: str = "kernel"):
    """`cfg` pinned as the card dispatches it: the fused hot loop on
    `path` for logits models (the card's gate takes the kernel at the
    flagship's widths), and for serving programs the row-invariant ops
    (``ops/hot_loop.serving_dispatch_config``)."""
    fused = cfg.likelihood == "logits" and gated
    return dataclasses.replace(
        cfg, row_invariant=serving or cfg.row_invariant,
        fused_likelihood=fused or cfg.fused_likelihood,
        hot_loop_path=path if fused else cfg.hot_loop_path)


def _weights(cfg, seed: int = 0):
    """``(host tree, its leaves)``: the weights drawn on the host."""
    from iwae_replication_project_tpu_torch.models import iwae as model
    from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

    host = model.init_params(torch.Generator().manual_seed(seed), cfg)
    return host, tree_leaves(host)


def _unflatten(like, leaves):
    from iwae_replication_project_tpu_torch.utils.tree import tree_unflatten

    return tree_unflatten(like, list(leaves))


def record(name: str, fn: Callable, *args, mode: str = "real",
           **fields) -> AuditProgram:
    """:class:`AuditProgram` `name` of ``fn(*args)``. A program that reads a
    traced value on the host cannot be recorded: it comes back with
    ``graph=None`` and ``error`` set, for the host-transfer pass."""
    from iwae_replication_project_tpu_torch.analysis.audit.graphs import trace

    try:
        gm = trace(fn, *args, mode=mode)
    except RuntimeError as e:
        text = str(e)
        if "_local_scalar_dense" not in text and "data-dependent" not in \
                text and "value out of" not in text:
            raise
        pkg = "iwae_replication_project_tpu_torch/"
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if pkg in f.filename and "/analysis/" not in f.filename]
        where = (f"{frames[-1].filename.split(pkg)[-1]}:"
                 f"{frames[-1].lineno}") if frames else "the program"
        return AuditProgram(name=name, graph=None,
                            error=f"a host read at {where}", **fields)
    return AuditProgram(name=name, graph=gm, **fields)


def build_train_step(k: int = TRAIN_K, batch: int = TRAIN_B,
                     mode: str = "real", cfg=None) -> AuditProgram:
    """The flagship's training step as the card runs it: the objective's
    gradients through the kernel path, Adam on the state's tensors. The
    card's Adam is the capturable one (its step counts on the device, the
    learning rate a device tensor); on CPU tensors the fused Adam keeps
    the same state as tensors, read by no host op (the plain CPU Adam reads
    each step count with ``.item()``, which this pass would report).
    Inputs: the batch, then the parameters, gradients, both moments, the
    step counts (all written in place: ``state_inputs``) and the learning
    rate."""
    from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
    from iwae_replication_project_tpu_torch.training.train_step import (
        ADAM_BETAS,
        ADAM_EPS,
        TrainState,
        make_train_step,
    )

    cfg = card_config(cfg or flagship())
    host, leaves = _weights(cfg)
    n = len(leaves)
    params = [t.clone().requires_grad_(True) for t in leaves]
    grads = [torch.zeros_like(t) for t in leaves]
    m1 = [torch.zeros_like(t) for t in leaves]
    m2 = [torch.zeros_like(t) for t in leaves]
    steps = [torch.zeros((), dtype=torch.float32) for _ in leaves]
    lr = torch.tensor(1e-3)
    x = torch.zeros((batch, cfg.x_dim))
    step = make_train_step(ObjectiveSpec(name="IWAE", k=k), cfg).__wrapped__

    def train_step(x, *flat):
        p, g = flat[:n], flat[n:2 * n]
        a, b, c = flat[2 * n:3 * n], flat[3 * n:4 * n], flat[4 * n:5 * n]
        for leaf, gr in zip(p, g):
            leaf.grad = gr
        opt = torch.optim.Adam(list(p), lr=1e-3, betas=ADAM_BETAS,
                               eps=ADAM_EPS, fused=True)
        # the device-resident rate, set past the constructor's range check
        # (a comparison of a tensor on the host)
        opt.param_groups[0]["lr"] = flat[-1]
        for leaf, s, e1, e2 in zip(p, c, a, b):
            opt.state[leaf] = {"step": s, "exp_avg": e1, "exp_avg_sq": e2}
        # the noise from the default generator: a generator object is no
        # argument every torch's recorder takes (the draws are the same op)
        state = TrainState(params=_unflatten(host, p), optimizer=opt,
                           generator=None)
        _, metrics = step(state, x)
        return metrics["loss"]

    args = (x, *params, *grads, *m1, *m2, *steps, lr)
    return record("train_step", train_step, *args, mode=mode,
                  state_inputs=frozenset(range(1, 5 * n + 1)),
                  captured=True)


def build_eval_scorer(batch: int = EVAL_B, k: int = EVAL_K,
                      chunk: int = EVAL_CHUNK, mode: str = "real",
                      cfg=None) -> AuditProgram:
    """The paper-grade streamed NLL scorer: k samples in chunks through the
    online-logsumexp carry, each chunk's noise drawn on the device (the
    default generator) and its decoder block through B1."""
    from iwae_replication_project_tpu_torch.evaluation.metrics import (
        streaming_log_px)

    cfg = card_config(cfg or flagship())
    host, leaves = _weights(cfg)
    x = torch.zeros((batch, cfg.x_dim))

    def eval_scorer(x, *flat):
        return streaming_log_px(_unflatten(host, flat), cfg, x, k=k,
                                chunk=chunk)

    return record("eval_scorer_k5000", eval_scorer, x, *leaves, mode=mode)


def _serving_fields(op: str, bucket: int, real: int, n_weights: int,
                    noise: Sequence[torch.Tensor], payload) -> dict:
    """Taints and store signature of a serving program over ``(payload,
    *weights, *noise)``: the payload's rows and each noise tensor's rows
    (axis 1 of ``[k, B, d]``, axis 0 of ``[B, d]``) past `real` are the
    engine's padding (``serving/programs.PADDED_ROW_KWARGS``)."""
    row_axis = 0 if op == "decode" else 1
    taints = {0: {0: real}}
    for j in range(len(noise)):
        taints[1 + n_weights + j] = {row_axis: real}
    # the engine keys its entry on the payload and the noise alone
    # (serving/engine.py _entry): the weights, k and bucket are the key's
    return {"taints": taints, "sig_args": ((payload, *noise), {}),
            "captured": True}


def build_serving(op: str, bucket: int = BUCKET, real: int = REAL_ROWS,
                  k: int = SERVE_K, mode: str = "real", cfg=None,
                  path: str = "kernel",
                  name: Optional[str] = None) -> AuditProgram:
    """One serving program at a padded bucket (`real` real rows), under the
    card's dispatch config, with its noise injected as the engine hands it
    over."""
    from iwae_replication_project_tpu_torch.serving.programs import (
        PROGRAMS,
        noise_shapes,
    )

    program, takes_k = PROGRAMS[op]
    cfg = card_config(cfg or flagship(), serving=True,
                      gated=op == "score", path=path)
    host, leaves = _weights(cfg)
    n = len(leaves)
    dim = cfg.n_latent_enc[-1] if op == "decode" else cfg.x_dim
    payload = torch.zeros((bucket, dim))
    gen = torch.Generator().manual_seed(2)
    noise = []
    for shp in noise_shapes(cfg, op, k):
        full = (shp[0], bucket, shp[1]) if len(shp) == 2 else (bucket,) + shp
        noise.append(torch.randn(full, generator=gen))
    extra = (k,) if takes_k else ()
    seeds = [0] * bucket

    def serve(payload, *flat):
        return program(_unflatten(host, flat[:n]), cfg, 0, seeds, payload,
                       *extra, noise=list(flat[n:]))

    return record(name or f"serve_{op}", serve, payload, *leaves, *noise,
                  mode=mode,
                  **_serving_fields(op, bucket, real, n, noise, payload))


def build_serving_fused(mode: str = "real") -> AuditProgram:
    """The score program under the fused dispatch config with the
    blocked-scan pin (the JAX package's choice): slabs of k through the
    row-invariant plain composition, each under ``torch.utils.checkpoint``
    off (no grad)."""
    return build_serving("score", mode=mode, path="blocked_scan",
                         name="serve_score_fused")


def build_serving_sharded(bucket: int = BUCKET, real: int = REAL_ROWS,
                          k: int = SHARDED_K, k_chunk: int = SHARDED_CHUNK,
                          sp: int = 2, mode: str = "real") -> AuditProgram:
    """The mesh-sharded large-k score program (``ShardedScoreEngine``'s
    dispatch) as sp rank 0 of a (1, sp) mesh runs it, over a recording
    mesh: ``ceil(ceil(k / k_chunk) / sp)`` blocks drawn on the device, one
    MAX and one SUM over sp to merge, one SUM over the world to gather."""
    from iwae_replication_project_tpu_torch.analysis.audit.graphs import (
        RecordingMesh)
    from iwae_replication_project_tpu_torch.serving.programs import (
        make_sharded_score_rows)

    cfg = card_config(flagship(), serving=True)
    host, leaves = _weights(cfg)
    mesh = RecordingMesh(dp=1, sp=sp, rank=0, device=torch.device("cpu"))
    program = make_sharded_score_rows(cfg, mesh, k_chunk=k_chunk)
    payload = torch.zeros((bucket, cfg.x_dim))
    seeds = [0] * bucket

    def noise_fn(g, rows):
        # each block's draws on the device, as the program's own per-row
        # generators make them (a generator object is no argument every
        # torch's recorder takes)
        return [torch.randn((k_chunk, len(rows), dim))
                for dim in cfg.n_latent_enc]

    def sharded(payload, *flat):
        return program(_unflatten(host, flat), 0, seeds, payload, k,
                       noise_fn=noise_fn)

    # the sharded engine keys its eager entry on the payload alone
    # (serving/sharded.py _entry): seeds and k are per-dispatch numbers
    return record("serve_score_sharded", sharded, payload, *leaves,
                  mode=mode, taints={0: {0: real}},
                  sig_args=((payload,), {}))


def build_hot_loop(path: str, mode: str = "real") -> AuditProgram:
    """One hot-loop path composed with the estimator reduction it feeds
    (``iwae_per_example``'s logmeanexp over k); pairwise-distinct sizes."""
    from iwae_replication_project_tpu_torch.objectives.estimators import (
        iwae_per_example)
    from iwae_replication_project_tpu_torch.ops.hot_loop import decoder_score

    k, b, h1_dim, hid, pix = 12, 24, 20, 40, 30
    gen = torch.Generator().manual_seed(3)
    shapes = [(h1_dim, hid), (hid,), (hid, hid), (hid,), (hid, pix), (pix,)]
    weights = [torch.randn(s, generator=gen) * 0.1 for s in shapes]
    x = torch.zeros((b, pix))
    h1 = torch.randn((k, b, h1_dim), generator=gen)

    def hot_loop(w1, b1, w2, b2, w3, b3, x, h1):
        out = {"l1": {"w": w1, "b": b1}, "l2": {"w": w2, "b": b2},
               "out": {"w": w3, "b": b3}}
        return iwae_per_example(decoder_score(out, x, h1, force_path=path))

    return record(f"hot_loop_{path}", hot_loop, *weights, x, h1, mode=mode,
                  sig_args=((*weights, x, h1), {}))


BUILDERS: Dict[str, Callable[..., AuditProgram]] = {
    "train_step": build_train_step,
    "eval_scorer_k5000": build_eval_scorer,
    "serve_score": functools.partial(build_serving, "score"),
    "serve_encode": functools.partial(build_serving, "encode"),
    "serve_decode": functools.partial(build_serving, "decode"),
    "serve_score_fused": build_serving_fused,
    "serve_score_sharded": build_serving_sharded,
    "hot_loop_reference": functools.partial(build_hot_loop, "reference"),
    "hot_loop_blocked_scan": functools.partial(build_hot_loop,
                                               "blocked_scan"),
    "hot_loop_kernel": functools.partial(build_hot_loop, "kernel"),
}


@functools.lru_cache(maxsize=None)
def _built(name: str) -> AuditProgram:
    return BUILDERS[name]()


def build_programs(include: Optional[Sequence[str]] = None
                   ) -> List[AuditProgram]:
    """The full audited suite (or the named subset), in PROGRAM_NAMES order,
    at the audit shapes. Programs are recorded once per process."""
    names = list(include) if include else list(PROGRAM_NAMES)
    unknown = set(names) - set(BUILDERS)
    if unknown:
        raise ValueError(f"unknown program(s): {sorted(unknown)}; "
                         f"known: {sorted(BUILDERS)}")
    return [_built(name) for name in names]


__all__ = ["BUILDERS", "PROGRAM_NAMES", "build_eval_scorer",
           "build_hot_loop", "build_programs", "build_serving",
           "build_serving_fused", "build_serving_sharded",
           "build_train_step", "card_config", "flagship", "record"]
