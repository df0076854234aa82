"""Mesh-sharded evaluation: the k=5000 NLL and the whole statistics suite
(port of ``parallel/eval.py``; its sharded serving scorers belong to the
serving stack, ROADMAP A9).

The single-device suite (``evaluation/metrics.py``) already streams its
large-k reductions; here the same reductions are split over the ``(dp,
sp)`` mesh:

* test batches shard over dp: each rank takes its dp row's ``B/dp`` rows;
* the sample axes shard over sp: each rank streams ``nll_k/sp`` samples in
  chunks through ``evaluation.metrics.streaming_log_px`` (on CUDA, B1 at
  chunk x ``B/dp`` rows), and the online-logsumexp carries merge over sp
  with one MAX and one SUM (:func:`merge_lse_over_sp`, the collective form
  of ``ops.logsumexp.online_logsumexp_merge``; :func:`merge_lse_var_over_sp`
  that of ``online_lse_var_merge``);
* the activity estimate splits its ``n_samples`` encoder passes over all
  ranks, and one SUM adds their posterior-mean sums;
* the pruned NLL runs on the whole first batch, its samples split over the
  sp ranks of dp row 0, and rank 0's value is broadcast (the JAX program
  returns device 0's).

**Randomness.** The suite draws from two generators per rank, made from the
seed ``s`` of the `generator` the caller passes (the stage's, the same on
every rank): ``mix(s, "eval", dp, sp)`` for every sample draw, so all
``k`` samples are independent, and ``mix(s, "eval-dp", dp)`` for the
1-sample reconstruction, which the sp ranks of a row compute alike (JAX
folds only dp into its key there). ``mix`` is ``parallel.dp.mix_seed``.
Tests inject each rank's draws instead, as ``training_statistics`` takes
them.

Output schema matches ``evaluation.metrics.training_statistics``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.evaluation import activity
from iwae_replication_project_tpu_torch.evaluation import metrics as ev
from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.ops.logsumexp import (
    OnlineLSE,
    OnlineLSEVar,
)
from iwae_replication_project_tpu_torch.parallel.dp import mix_seed
from iwae_replication_project_tpu_torch.parallel.mesh import AXES, Mesh
from iwae_replication_project_tpu_torch.utils.sizes import largest_divisor_leq


def _safe(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def merge_lse_over_sp(mesh: Mesh, state: OnlineLSE) -> OnlineLSE:
    """The carry of all sp ranks' samples from this rank's: one MAX of the
    maxima, one SUM of the sums rescaled to it."""
    m_g = mesh.all_reduce(state.m.clone(), "max", AXES.sp)
    s_g = mesh.all_reduce(state.s * torch.exp(state.m - _safe(m_g)), "sum",
                          AXES.sp)
    return OnlineLSE(m=m_g, s=s_g, n=state.n * mesh.sp)


def merge_lse_var_over_sp(mesh: Mesh, state: OnlineLSEVar) -> OnlineLSEVar:
    """:func:`merge_lse_over_sp` of the augmented carry: ``s`` by the same
    expression, ``s2`` rescaled by the squared shift, both in one SUM."""
    m_g = mesh.all_reduce(state.m.clone(), "max", AXES.sp)
    scale = torch.exp(state.m - _safe(m_g))
    both = mesh.all_reduce(torch.stack([state.s * scale,
                                        state.s2 * scale * scale]),
                           "sum", AXES.sp)
    return OnlineLSEVar(m=m_g, s=both[0], s2=both[1], n=state.n * mesh.sp)


def _sp_k(name: str, k: int, mesh: Mesh) -> int:
    if k % mesh.sp != 0:
        raise ValueError(f"sp={mesh.sp} must divide {name}={k}")
    return k // mesh.sp


@torch.no_grad()
def parallel_batch_metrics(params, cfg: model.ModelConfig, mesh: Mesh,
                           x_local: torch.Tensor, k: int, *,
                           generator: Optional[torch.Generator] = None,
                           eps=None) -> Dict[str, torch.Tensor]:
    """``evaluation.metrics.batch_metrics`` with the k fan-out over sp: the
    dp row's scalars (means over its rows), the same on its sp ranks."""
    k_local = _sp_k("eval k", k, mesh)
    log_w, aux = model.log_weights_and_aux(params, cfg, x_local, k_local,
                                           generator=generator, eps=eps)
    m = mesh.all_reduce(torch.amax(log_w, dim=0), "max", AXES.sp)
    vae, s, recon = mesh.all_reduce(torch.stack([
        torch.sum(log_w, dim=0), torch.sum(torch.exp(log_w - m), dim=0),
        torch.sum(aux["log_px_given_h"], dim=0)]), "sum", AXES.sp)
    vae = torch.mean(vae / k)
    recon = torch.mean(recon / k)
    return {"VAE": vae,
            "IWAE": torch.mean(torch.log(s) + m - math.log(float(k))),
            "E_q(h|x)[log(p(x|h))]": recon,
            "D_kl(q(h|x),p(h))": recon - vae}


def parallel_streaming_log_px(params, cfg: model.ModelConfig, mesh: Mesh,
                              x_local: torch.Tensor, k: int = 5000,
                              chunk: int = 250, *,
                              generator: Optional[torch.Generator] = None,
                              noise=None) -> torch.Tensor:
    """``[B/dp]`` log p^(x) of this rank's rows from all ``k`` samples: it
    streams ``k/sp`` of them in chunks of `chunk` (clamped to a divisor of
    ``k/sp``) and merges the carries over sp."""
    k_local = _sp_k("nll_k", k, mesh)
    return ev.streaming_log_px(
        params, cfg, x_local, k_local, largest_divisor_leq(k_local, chunk),
        generator=generator, noise=noise,
        merge=lambda st: merge_lse_over_sp(mesh, st))


@torch.no_grad()
def parallel_dataset_scalars(params, cfg: model.ModelConfig, mesh: Mesh,
                             batches_local: torch.Tensor, k: int, nll_k: int,
                             nll_chunk: int, *,
                             generator: Optional[torch.Generator] = None,
                             generator_dp: Optional[torch.Generator] = None,
                             noise=None) -> torch.Tensor:
    """The 7 eval scalars over ``[n_batches, B/dp, d]`` batch shards, in
    ``SCALAR_NAMES`` order, averaged over batches and dp rows: the same
    ``[7]`` tensor on every rank. Per batch: the metrics, the streamed NLL,
    the reconstruction (from `generator_dp`), as
    ``evaluation.metrics.dataset_scalars`` draws them."""
    tot = torch.zeros(len(ev.SCALAR_NAMES), device=batches_local.device)
    for i in range(batches_local.shape[0]):
        xb = batches_local[i]
        nz = {} if noise is None else noise(i)
        m = parallel_batch_metrics(params, cfg, mesh, xb, k,
                                   generator=generator,
                                   eps=nz.get("metrics"))
        nll = -torch.mean(parallel_streaming_log_px(
            params, cfg, mesh, xb, nll_k, nll_chunk, generator=generator,
            noise=nz.get("nll")))
        rl = ev.reconstruction_loss(params, cfg, xb, generator=generator_dp,
                                    enc_eps=nz.get("recon_enc"),
                                    dec_eps=nz.get("recon_dec"))
        tot += torch.stack([
            m["VAE"], m["IWAE"], nll, m["E_q(h|x)[log(p(x|h))]"],
            m["D_kl(q(h|x),p(h))"], -nll - m["VAE"], rl])
    mesh.all_reduce(tot, "sum", AXES.dp)
    return tot / (mesh.dp * batches_local.shape[0])


@torch.no_grad()
def parallel_posterior_means(params, cfg: model.ModelConfig, mesh: Mesh,
                             x: torch.Tensor, n_samples: int, chunk: int = 10,
                             *, generator: Optional[torch.Generator] = None,
                             noise=None):
    """Per layer the ``[N, d_i]`` Monte-Carlo posterior means of all of
    `x` (every rank holds it whole), the `n_samples` encoder passes split
    over all ranks and their sums added in one SUM."""
    n_dev = mesh.size
    if n_samples % n_dev != 0:
        raise ValueError(f"activity n_samples={n_samples} must be divisible "
                         f"by the rank count {n_dev}")
    sums = activity.posterior_sample_sums(params, cfg, x, n_samples // n_dev,
                                          chunk, generator=generator,
                                          noise=noise)
    flat = mesh.all_reduce(torch.cat([s.reshape(-1) for s in sums]))
    out, at = [], 0
    for s in sums:
        out.append(flat[at:at + s.numel()].view_as(s) / n_samples)
        at += s.numel()
    return out


@torch.no_grad()
def parallel_pruned_nll(params, cfg: model.ModelConfig, mesh: Mesh,
                        x: torch.Tensor, masks, k: int = 5000,
                        chunk: int = 250, *,
                        generator: Optional[torch.Generator] = None,
                        noise=None) -> torch.Tensor:
    """0-d masked-latent NLL of `x` (the whole first batch, on every rank)
    with k over the sp ranks of dp row 0, broadcast from rank 0."""
    k_local = _sp_k("pruned-NLL k", k, mesh)
    out = torch.zeros((), device=x.device)
    if mesh.dp_rank == 0:
        out = activity.nll_without_inactive_units(
            params, cfg, x, masks, k=k_local, chunk=chunk,
            generator=generator, noise=noise,
            merge=lambda st: merge_lse_over_sp(mesh, st))
    return mesh.broadcast(out.reshape(1)).reshape(())


def eval_generators(mesh: Mesh, generator: Optional[torch.Generator]
                    ) -> Tuple[torch.Generator, torch.Generator]:
    """This rank's ``(sample, reconstruction)`` generators (module note)."""
    s = generator.initial_seed() if generator is not None \
        else torch.initial_seed()
    dev = mesh.device
    return (torch.Generator(device=dev).manual_seed(
                mix_seed(s, "eval", mesh.dp_rank, mesh.sp_rank)),
            torch.Generator(device=dev).manual_seed(
                mix_seed(s, "eval-dp", mesh.dp_rank)))


@torch.no_grad()
def parallel_training_statistics(params, cfg: model.ModelConfig, mesh: Mesh,
                                 x_test: torch.Tensor, k: int,
                                 batch_size: int = 100, nll_k: int = 5000,
                                 nll_chunk: int = 250,
                                 activity_samples: int = 1000, *,
                                 generator: Optional[torch.Generator] = None,
                                 noise: Optional[dict] = None
                                 ) -> Tuple[Dict[str, float],
                                            Dict[str, object]]:
    """Mesh-sharded ``evaluation.metrics.training_statistics``: the same
    ``(res, res2)`` on every rank, fetched once.

    As in JAX (:520-607): a test set dp does not divide is trimmed to a
    multiple of dp; the batch is the largest size up to
    ``max(batch_size, dp)`` that divides the set and that dp divides;
    ``activity_samples`` is rounded down to a multiple of the rank count
    (at least one each). ``nll_chunk`` is stamped as the chunk each rank
    used (clamped to a divisor of ``nll_k/sp``), ``kernel_path`` as the
    hot-loop path of this rank's device. `noise` injects this rank's
    draws, in ``training_statistics``'s layout (the batches' rows being
    this rank's).
    """
    noise = noise or {}
    n_dp, n_sp = mesh.dp, mesh.sp
    n = x_test.shape[0]
    if n % n_dp != 0:
        n_use = (n // n_dp) * n_dp
        if mesh.rank == 0:
            print(f"parallel eval: trimming test set {n} -> {n_use} for "
                  f"dp={n_dp} sharding")
        x_test = x_test[:n_use]
        n = n_use
    batch_size = max(d for d in range(1, min(max(batch_size, n_dp), n) + 1)
                     if n % d == 0 and d % n_dp == 0)
    _sp_k("eval k", k, mesh)
    _sp_k("nll_k", nll_k, mesh)
    n_dev = mesh.size
    activity_samples = max(n_dev, (activity_samples // n_dev) * n_dev)
    chunk = largest_divisor_leq(nll_k // n_sp, nll_chunk)
    gen, gen_dp = eval_generators(mesh, generator)

    n_batches = n // batch_size
    b_local = batch_size // n_dp
    batches = x_test.reshape(n_batches, batch_size, -1)
    lo = mesh.dp_rank * b_local
    scalars = parallel_dataset_scalars(
        params, cfg, mesh, batches[:, lo:lo + b_local], k, nll_k, chunk,
        generator=gen, generator_dp=gen_dp, noise=noise.get("batches"))
    means = parallel_posterior_means(params, cfg, mesh, x_test.reshape(n, -1),
                                     activity_samples, generator=gen,
                                     noise=noise.get("activity"))
    variances, eigvals = activity.activity_from_means(means)
    masks, n_active, n_active_pca = activity.active_units(variances, eigvals)
    pruned = parallel_pruned_nll(params, cfg, mesh, batches[0], masks,
                                 k=nll_k, chunk=chunk, generator=gen,
                                 noise=noise.get("pruned"))
    fetched = torch.cat([scalars, n_active.float(), n_active_pca.float(),
                         pruned.reshape(1)]).cpu().tolist()  # the one fetch
    L = len(masks)
    res = dict(zip(ev.SCALAR_NAMES, fetched))
    res["nll_chunk"] = float(chunk)
    res["eval_batch"] = float(batch_size)
    res["kernel_path"] = ev._kernel_path_code(cfg, mesh.device)
    res["LL_pruned"] = fetched[-1]
    rest = fetched[len(ev.SCALAR_NAMES):]
    res2 = {"active_units": masks,
            "number_of_active_units": [int(v) for v in rest[:L]],
            "number_of_PCA_active_units": [int(v) for v in rest[L:2 * L]],
            "variances": variances}
    return res, res2
