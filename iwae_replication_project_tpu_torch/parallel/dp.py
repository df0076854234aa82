"""Data and sample parallelism over a ``(dp, sp)`` mesh (port of
``parallel/dp.py``).

Every rank runs the single-device step on its shard: ``B/dp`` rows of the
batch (dp) and ``k/sp`` of the importance samples (sp), with noise of its
own. The ranks meet in two places:

* **the bound over the sharded k axis.** With ``sp = 1`` each rank runs
  the single-device objective (``objectives.objective_value_and_grad``).
  With ``sp > 1`` the statistics the bound needs are merged over sp from
  the detached log-weights: the log-mean-exp as one MAX of the per-rank
  maxima and one SUM of the rescaled partial sums
  (:func:`distributed_logmeanexp`), sums as one SUM, L_median's full
  weight vector as one SUM of zero-filled buffers. From the merged
  statistics each rank forms the bound's cotangent on its own ``[k/sp,
  B/dp]`` log-weights (the globally normalised weights for IWAE, DReG, STL
  and PIWAE's decoder, ``1/(k B)`` for the means, the middle order
  statistics for L_median) and runs one local backward. Every collective
  sits on the stop-gradient side, so nothing differentiates through an
  ``all_reduce``. (JAX differentiates its collectives and so needs a
  pmean over sp where ``transpose(psum) = psum``; here that question does
  not arise.)
* **the gradient reduction.** The partial gradients, with the dp row's
  bound from its sp rank 0, are packed into one flat buffer, summed over
  the world in one ``all_reduce`` (the sum over sp of the partials, over
  dp of the rows) and divided by dp (the mean over dp).

A world of one, uninitialised or not, reduces nothing: ``/1`` is exact,
so with the same draws it gives the single-device step's bits.

**The epoch** (:func:`make_parallel_epoch_fn`) is ``training/epoch.py``'s,
entered through its seam: the value-and-grad above, and the rank's columns
of each batch. Its data semantics are JAX's (:276-284, :321-328): the
training set is replicated, every rank draws the same permutation and takes
its dp row's ``B/dp`` columns of each batch, the stochastic binarization
is drawn per (batch, dp) and not per sp, so the k-shards of a row see the
same pixels, and the model noise is independent per (dp, sp). That takes
three generators per rank (:func:`parallel_train_state`), seeded from the
seed of the state's training generator ``s`` and the rank's coordinates:

* ``streams["shuffle"]``: ``mix(s, "shuffle")``, the same on every rank;
* ``streams["binarize"]``: ``mix(s, "binarize", dp)``, one per dp row;
* ``generator`` (the model noise): ``mix(s, "noise", dp, sp)``;

where ``mix`` is the first 63 bits of the SHA-256 of the tuple's repr. On
NCCL the step, its ``all_reduce`` included, is captured as one CUDA graph
and replayed as on one device. Gloo's collectives cannot be captured: on
CUDA tensors under gloo the step runs eagerly, and only because the caller
passed ``cuda_graph=False``; asking for a graph there raises.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives import (
    ObjectiveSpec,
    objective_value_and_grad,
)
from iwae_replication_project_tpu_torch.objectives import estimators as est
from iwae_replication_project_tpu_torch.objectives.gradients import (
    _grad_leaves,
    _grads,
    _split_pass,
)
from iwae_replication_project_tpu_torch.ops import distributions as dist
from iwae_replication_project_tpu_torch.ops.logsumexp import logmeanexp
from iwae_replication_project_tpu_torch.parallel.mesh import AXES, Mesh
from iwae_replication_project_tpu_torch.telemetry.spans import spanned
from iwae_replication_project_tpu_torch.training.train_step import (
    TrainState,
    apply_gradients,
)
from iwae_replication_project_tpu_torch.utils.tree import (
    tree_leaves,
    tree_unflatten,
)

#: every objective shards its k axis over sp: the means and log-mean-exps
#: with O(B) collectives, L_median with its O(k B) weight vector, DReG, STL
#: and PIWAE with globally normalised cotangents
SP_SHARDABLE = ("IWAE", "VAE", "VAE_V1", "L_alpha", "CIWAE", "L_power_p",
                "L_median", "MIWAE", "PIWAE", "DReG", "STL")


def mix_seed(*parts) -> int:
    """A 63-bit seed from a tuple: the first 8 bytes of the SHA-256 of its
    repr (one seed per rank coordinate, independent of the others)."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def distributed_logmeanexp(log_w_local: torch.Tensor, mesh: Mesh,
                           k_global: int, scale: float = 1.0
                           ) -> torch.Tensor:
    """``[B]`` ``log mean exp(scale * log_w)`` over a k axis sharded on sp,
    a value (detached): one MAX of the per-rank maxima, then one SUM of the
    rescaled partial sums, O(B) bytes whatever k."""
    return _softmax_over_sp(scale * log_w_local.detach(), mesh, k_global)[1]


def _softmax_over_sp(z: torch.Tensor, mesh: Mesh, k_global: int):
    """``(w, lme)``: the softmax over the whole sharded k axis of this
    rank's ``[k/sp, B]`` slice of `z` (detached), and the ``[B]``
    log-mean-exp of `z` over all k."""
    m = mesh.all_reduce(torch.amax(z, dim=0), "max", AXES.sp)
    e = torch.exp(z - m)
    denom = mesh.all_reduce(torch.sum(e, dim=0), "sum", AXES.sp)
    return e / denom, torch.log(denom) + m - math.log(float(k_global))


def _sp_sums(mesh: Mesh, *rows: torch.Tensor) -> List[torch.Tensor]:
    """The sums over the sp ranks of ``[B]`` vectors, in one SUM."""
    return list(mesh.all_reduce(torch.stack(rows), "sum", AXES.sp))


def _sharded_bound(spec: ObjectiveSpec, log_w: torch.Tensor, aux: dict,
                   mesh: Mesh, k_global: int):
    """``(bound, outputs, cotangents)`` of a standard objective on this
    rank's ``[k/sp, B]`` log-weights: the dp row's bound (a value, the
    same on its sp ranks) and the cotangents of the tensors of this rank's
    pass whose backward gives its partial gradient (JAX :59-104)."""
    name = spec.name
    lw = log_w.detach()
    B = lw.shape[1]
    kb = float(k_global * B)
    if name == "VAE":
        (total,) = _sp_sums(mesh, torch.sum(lw, dim=0))
        return (torch.mean(total / k_global), [log_w],
                [torch.full_like(lw, 1.0 / kb)])
    if name in ("IWAE", "CIWAE", "L_power_p"):
        z = spec.p * lw if name == "L_power_p" else lw
        w, lme = _softmax_over_sp(z, mesh, k_global)
        if name == "L_power_p":
            return torch.mean(lme / spec.p), [log_w], [w / B]
        iwae = torch.mean(lme)
        if name == "IWAE":
            return iwae, [log_w], [w / B]
        (total,) = _sp_sums(mesh, torch.sum(lw, dim=0))
        beta = spec.beta
        return (beta * torch.mean(total / k_global) + (1.0 - beta) * iwae,
                [log_w], [beta / kb + (1.0 - beta) * w / B])
    if name == "MIWAE":
        # each rank holds k2/sp whole k1-sample groups (sp | k2 validated)
        grouped = lw.reshape(-1, spec.k // spec.k2, B)
        (total,) = _sp_sums(mesh, torch.sum(logmeanexp(grouped, dim=1),
                                            dim=0))
        ct = torch.softmax(grouped, dim=1).reshape(lw.shape) / (spec.k2 * B)
        return torch.mean(total / spec.k2), [log_w], [ct]
    if name == "L_median":
        # the full per-example weight vector, as one SUM of zero-filled
        # [k, B] buffers (gloo has no all_gather for CUDA tensors)
        k_local = lw.shape[0]
        lo = mesh.sp_rank * k_local
        full = torch.zeros((k_global, B), dtype=lw.dtype, device=lw.device)
        full[lo:lo + k_local] = lw
        full = mesh.all_reduce(full, "sum", AXES.sp).requires_grad_(True)
        with torch.enable_grad():
            bound = est.median_bound(full)
            (ct_full,) = torch.autograd.grad(bound, full)
        return bound.detach(), [log_w], [ct_full[lo:lo + k_local]]
    lpxh = aux["log_px_given_h"]
    if name == "L_alpha":
        recon, total = _sp_sums(mesh, torch.sum(lpxh.detach(), dim=0),
                                torch.sum(lw, dim=0))
        a = spec.alpha
        bound = (1.0 - a) * torch.mean(recon / k_global) \
            + a * torch.mean(total / k_global)
        return (bound, [log_w, lpxh],
                [torch.full_like(lw, a / kb),
                 torch.full_like(lw, (1.0 - a) / kb)])
    if name == "VAE_V1":
        if aux["q_last"] is None:       # models.iwae.encode: L >= 2
            raise ValueError("VAE_V1 is single-stochastic-layer only "
                             "(flexible_IWAE.py:433)")
        q_mu, q_std = aux["q_last"]
        (recon,) = _sp_sums(mesh, torch.sum(lpxh.detach(), dim=0))
        kl = torch.mean(torch.sum(dist.normal_kl_standard(q_mu, q_std),
                                  dim=-1))
        # every sp rank computes the same k-independent KL: each takes
        # 1/sp of its gradient, so the sum over sp counts it once
        return (torch.mean(recon / k_global) - kl.detach(), [lpxh, kl],
                [torch.full_like(lw, 1.0 / kb),
                 torch.full_like(kl, -1.0 / mesh.sp)])
    raise ValueError(f"objective {name!r} is not sample-parallel shardable; "
                     f"use sp=1 (supported: {SP_SHARDABLE})")


def _sharded_value_and_grad(spec: ObjectiveSpec, cfg: model.ModelConfig,
                            mesh: Mesh, k_local: int, params, x,
                            generator, eps):
    """This rank's ``(dp row's bound, partial gradients)`` with k sharded
    over sp (``sp > 1``)."""
    params = _grad_leaves(params)
    name = spec.name
    B = x.shape[0]
    if name in ("DReG", "STL", "PIWAE"):
        # JAX :136-188: cotangents from the globally normalised weights
        log_w = model.log_weights(params, cfg, x, k_local,
                                  generator=generator, eps=eps,
                                  stop_q_score=name != "PIWAE")
        lw = log_w.detach()
        w_tilde, lme = _softmax_over_sp(lw, mesh, spec.k)
        bound = torch.mean(lme)
        if name == "STL":
            leaves = tree_leaves(params)
            return bound, tree_unflatten(params,
                                         _grads(log_w, leaves, w_tilde / B))
        if name == "DReG":
            return bound, _split_pass(log_w, params, w_tilde.square() / B,
                                      w_tilde / B)
        # PIWAE: encoder on MIWAE(k1, k2) over this rank's whole groups
        grouped = lw.reshape(spec.k2 // mesh.sp, -1, B)
        ct_enc = torch.softmax(grouped, dim=1).reshape(lw.shape) \
            / (spec.k2 * B)
        return bound, _split_pass(log_w, params, ct_enc, w_tilde / B)
    log_w, aux = model.log_weights_and_aux(params, cfg, x, k_local,
                                           generator=generator, eps=eps)
    bound, outputs, cts = _sharded_bound(spec, log_w, aux, mesh, spec.k)
    leaves = tree_leaves(params)
    got = torch.autograd.grad(outputs, leaves, grad_outputs=cts,
                              allow_unused=True)
    return bound, tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, got)])


def reduce_gradients(mesh: Mesh, bound: torch.Tensor, grads):
    """``(bound, grads)`` of the whole mesh from this rank's: the partial
    gradients summed over sp and averaged over dp, and the dp rows' bounds
    (taken from each row's sp rank 0) averaged, in one SUM ``all_reduce``
    of one flat buffer over the world."""
    leaves = tree_leaves(grads)
    own = bound.reshape(1) if mesh.sp_rank == 0 else torch.zeros_like(
        bound).reshape(1)
    flat = torch.cat([g.reshape(-1) for g in leaves] + [own])
    mesh.all_reduce(flat, "sum")
    flat = flat / mesh.dp
    out, at = [], 0
    for g in leaves:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return flat[at].reshape(bound.shape), tree_unflatten(grads, out)


def _validate_sharding(spec: ObjectiveSpec, mesh: Mesh,
                       batch_size: Optional[int]) -> Tuple[int, int]:
    """Build-time divisibility and support checks; returns ``(n_sp,
    k_local)`` (JAX :120-133, with the same errors)."""
    n_sp, n_dp = mesh.sp, mesh.dp
    if n_sp > 1 and spec.name not in SP_SHARDABLE:
        raise ValueError(f"objective {spec.name!r} does not support sp>1")
    if spec.k % n_sp != 0:
        raise ValueError(f"sp={n_sp} must divide k={spec.k}")
    if spec.name in ("MIWAE", "PIWAE") and n_sp > 1 and spec.k2 % n_sp != 0:
        raise ValueError(f"{spec.name} with sp={n_sp} needs sp | k2={spec.k2}")
    if batch_size is not None and batch_size % n_dp != 0:
        raise ValueError(
            f"batch_size={batch_size} must be divisible by dp={n_dp}")
    return n_sp, spec.k // n_sp


def make_parallel_value_and_grad(spec: ObjectiveSpec, cfg: model.ModelConfig,
                                 mesh: Mesh, batch_size: Optional[int] = None
                                 ) -> Callable:
    """``vg(params, x_local, *, generator=None, eps=None) -> (bound,
    grads)``, both the whole mesh's on every rank.

    `x_local` is this rank's ``[B/dp, x_dim]`` rows; the rank draws
    ``k/sp`` samples from `generator` (its noise stream) or takes them
    injected as `eps` (``[k/sp, B/dp, d_i]`` per layer), which is how tests
    replay the JAX package's per-coordinate draws. Pass `batch_size` to
    fail at build time on a batch dp does not divide.
    """
    n_sp, k_local = _validate_sharding(spec, mesh, batch_size)

    def vg(params, x_local, *, generator=None, eps=None):
        if n_sp == 1:
            bound, grads = objective_value_and_grad(
                spec, params, cfg, x_local, generator=generator, eps=eps)
        else:
            bound, grads = _sharded_value_and_grad(
                spec, cfg, mesh, k_local, params, x_local, generator, eps)
        return reduce_gradients(mesh, bound, grads)

    return vg


def shard_batch(mesh: Mesh, batch: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global batch, which every rank holds whole:
    its dp row's contiguous ``B/dp`` rows, on the rank's device."""
    n_dp = mesh.dp
    if batch.shape[0] % n_dp != 0:
        raise ValueError(
            f"batch size {batch.shape[0]} must be divisible by dp={n_dp}")
    b = batch.shape[0] // n_dp
    return batch[mesh.dp_rank * b:(mesh.dp_rank + 1) * b].to(mesh.device)


def replicate(mesh: Mesh, tree):
    """Every tensor of `tree` overwritten in place with rank 0's (one
    ``broadcast`` per leaf); returns `tree`."""
    with torch.no_grad():
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                mesh.broadcast(t.data if t.requires_grad else t)
    return tree


def parallel_train_state(mesh: Mesh, state: TrainState) -> TrainState:
    """`state` (built alike on every rank) made a rank's state of the
    mesh: the parameters and any Adam moments broadcast from rank 0, and
    the three generator streams of the module note seeded from the seed of
    its training generator and the rank's coordinates."""
    replicate(mesh, state.params)
    for p in tree_leaves(state.params):
        replicate(mesh, [v for v in state.optimizer.state.get(p, {}).values()
                         if isinstance(v, torch.Tensor)])
    s = state.generator.initial_seed()
    dev = mesh.device

    def gen(*parts):
        return torch.Generator(device=dev).manual_seed(mix_seed(s, *parts))

    state.generator = gen("noise", mesh.dp_rank, mesh.sp_rank)
    state.streams = {"shuffle": gen("shuffle"),
                     "binarize": gen("binarize", mesh.dp_rank)}
    state.graphs.clear()
    return state


def _check_graph_backend(mesh: Mesh, cuda_graph: bool) -> None:
    if cuda_graph and mesh.device.type == "cuda" \
            and mesh.backend not in (None, "nccl"):
        raise ValueError(
            f"the {mesh.backend} backend's collectives cannot be captured "
            f"in a CUDA graph: pass cuda_graph=False to run the step "
            f"eagerly on CUDA tensors")


def make_parallel_epoch_fn(spec: ObjectiveSpec, cfg: model.ModelConfig,
                           mesh: Mesh, n_train: int, batch_size: int,
                           stochastic_binarization: bool = False,
                           shuffle: bool = True, epochs_per_call: int = 1,
                           diagnostics=None,
                           cuda_graph: bool = True) -> Callable:
    """Whole passes under the mesh: ``epoch(state, x_train) -> (state,
    losses)``, ``training/epoch.make_epoch_fn``'s contract, with `state`
    from :func:`parallel_train_state` and `x_train` the whole training set
    on every rank. The losses and the gradient-SNR scalars are the whole
    mesh's, the same on every rank.

    Injected draws (``perm``, ``noise``, ``uniforms``) are this rank's:
    the whole permutation, and per step its ``[k/sp, B/dp, d_i]`` noise and
    its ``[B/dp, x_dim]`` uniforms.
    """
    from iwae_replication_project_tpu_torch.training.epoch import (
        make_epoch_fn)

    _validate_sharding(spec, mesh, batch_size)
    _check_graph_backend(mesh, cuda_graph)
    b_local = batch_size // mesh.dp
    lo = mesh.dp_rank * b_local
    epoch = make_epoch_fn(
        spec, cfg, n_train, batch_size,
        stochastic_binarization=stochastic_binarization, shuffle=shuffle,
        diagnostics=diagnostics, epochs_per_call=epochs_per_call,
        cuda_graph=cuda_graph,
        value_and_grad=make_parallel_value_and_grad(spec, cfg, mesh,
                                                    batch_size),
        shard=(lo, lo + b_local))
    name = f"parallel_epoch_{spec.name}_k{spec.k}" if epochs_per_call == 1 \
        else f"parallel_epoch_block{epochs_per_call}_{spec.name}_k{spec.k}"
    epoch = epoch.__wrapped__           # re-spanned under the mesh's name
    epoch.__name__ = epoch.__qualname__ = name
    return spanned(epoch, "train/parallel_epoch")


def make_parallel_train_step(spec: ObjectiveSpec, cfg: model.ModelConfig,
                             mesh: Mesh, batch_size: Optional[int] = None
                             ) -> Callable:
    """``step(state, x_local, eps=None) -> (state, metrics)``: one Adam
    step of the mesh on this rank's ``B/dp`` rows (:func:`shard_batch`),
    drawing from the rank's noise stream; ``metrics`` as
    ``train_step.make_train_step``'s, the loss the whole mesh's."""
    vg = make_parallel_value_and_grad(spec, cfg, mesh, batch_size)

    def step(state: TrainState, x_local: torch.Tensor,
             eps: Optional[Sequence[torch.Tensor]] = None):
        bound, grads = vg(state.params, x_local, generator=state.generator,
                          eps=eps)
        apply_gradients(state, grads)
        loss = -bound
        return state, {"loss": loss, spec.name: loss, "grads": grads}

    return step
