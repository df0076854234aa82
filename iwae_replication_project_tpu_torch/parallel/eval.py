"""Mesh-sharded evaluation: the k=5000 NLL, the whole statistics suite and
the per-rank bodies of the sharded serving scorers (port of
``parallel/eval.py``).

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

**The serving scorers** (:func:`local_row_streaming_log_px`,
:func:`local_row_adaptive_log_px`; entered offline through
:func:`sharded_score_offline` and :func:`sharded_score_adaptive_offline`,
which call the very programs ``serving/sharded.py`` dispatches) take each
rank's ``B/dp`` rows and stream k in fixed ``k_chunk`` blocks over sp. A
row's block ``g`` (the *global* block index) draws its noise from the row's
own (engine seed, request seed, g) stream through the `noise` callable the
program passes, so a row's weights do not depend on its batch, the padding
or which sp rank streams the block. Each block is one encoder pass over the
rank's rows and one decoder-block call (B1 on the card) at ``[k_chunk,
B/dp]``. Samples at a global index >= k are ``-inf``; a block no row needs
is skipped, since an all ``-inf`` block is an exact identity update of the
carry.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from iwae_replication_project_tpu_torch.evaluation import activity
from iwae_replication_project_tpu_torch.evaluation import metrics as ev
from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.ops.logsumexp import (
    OnlineLSE,
    OnlineLSEVar,
    lse_var_stats,
    online_logsumexp_init,
    online_logsumexp_update,
    online_lse_var_init,
    online_lse_var_update,
)
from iwae_replication_project_tpu_torch.parallel.dp import mix_seed
from iwae_replication_project_tpu_torch.parallel.mesh import AXES, Mesh
from iwae_replication_project_tpu_torch.telemetry.spans import span
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


#: ``noise(blocks) -> [k_chunk, B_local, d]`` per encoder layer: the draws
#: of global block ``blocks[b]`` for local row b (None: the row needs no
#: block here; any finite values do)
BlockNoise = Callable[[Sequence[Optional[int]]], List[torch.Tensor]]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _mask_from(lw: torch.Tensor, valid: Sequence[int]) -> torch.Tensor:
    """`lw` ``[k_chunk, B]`` with samples ``j >= valid[b]`` of row b set to
    ``-inf``; unchanged where every row keeps its whole block."""
    kc = lw.shape[0]
    if all(v >= kc for v in valid):
        return lw
    lim = torch.tensor(valid, device=lw.device)
    keep = torch.arange(kc, device=lw.device)[:, None] < lim[None, :]
    return torch.where(keep, lw, torch.full_like(lw, -math.inf))


@torch.no_grad()
def local_row_streaming_log_px(params, cfg: model.ModelConfig, mesh: Mesh,
                               x_local: torch.Tensor, k: int, k_chunk: int,
                               noise: BlockNoise) -> OnlineLSE:
    """This rank's carry of the fixed-k serving scorer (JAX :99-136): the
    ``ceil(ceil(k/k_chunk)/sp)`` blocks ``sp_rank*bpd + i`` of each of its
    ``B/dp`` rows, unmerged. Callers merge over sp and normalise by
    ``log k``."""
    n_rows = x_local.shape[0]
    n_blocks = _ceil_div(k, k_chunk)
    bpd = _ceil_div(n_blocks, mesh.sp)
    st = online_logsumexp_init((n_rows,), device=x_local.device)
    for i in range(bpd):
        g = mesh.sp_rank * bpd + i
        if g >= n_blocks:
            break
        lw = model.log_weights(params, cfg, x_local, k_chunk,
                               eps=noise([g] * n_rows))
        lw = _mask_from(lw, [k - g * k_chunk] * n_rows)
        st = online_logsumexp_update(st, lw, dim=0,
                                     fixed_order=cfg.row_invariant)
    return st


@torch.no_grad()
def local_row_adaptive_log_px(params, cfg: model.ModelConfig, mesh: Mesh,
                              x_local: torch.Tensor, k_cap: int,
                              target_se: float, ess_floor: float,
                              k_chunk: int, noise: BlockNoise,
                              n_real: Optional[int] = None) -> torch.Tensor:
    """This rank's ``[B/dp, 3]`` rows of ``(log p_hat, achieved se,
    k_used)`` of the accuracy-targeted scorer (JAX :139-240).

    **Phase 1** walks the stream round-robin: round r folds global block
    ``r*sp + sp_rank`` into the augmented carry, merges it over sp (one
    MAX, one SUM) and tests every row's delta-method SE and ESS against the
    targets (<= 0 disables one); a row converges at the first round whose
    prefix of ``min((r+1)*sp*k_chunk, k_cap)`` samples meets one, which
    freezes its ``k_used``. The loop ends when every one of the first
    `n_real` rows has converged (None: all rows; the engine's padding rows
    never hold it up) or the cap is reached. The test reads sp-merged
    statistics, so every rank of an sp group runs as many rounds and issues
    as many collectives; it is one host sync per round.

    **Phase 2** recomputes each row's answer over its ``k_used`` prefix
    with the fixed-k schedule (block ``sp_rank*bpd_row + i``, the same
    masking and carry arithmetic), ``max(bpd_row)`` iterations over the
    real rows, so the result is bitwise the fixed-k score at ``k = k_used``
    on the same rows.
    """
    dev = x_local.device
    n_rows = x_local.shape[0]
    real = n_rows if n_real is None else max(0, min(int(n_real), n_rows))
    sp, spr = mesh.sp, mesh.sp_rank
    n_blocks_cap = _ceil_div(k_cap, k_chunk)
    rounds_cap = _ceil_div(n_blocks_cap, sp)
    tse = torch.tensor(target_se, dtype=torch.float32, device=dev)
    floor = torch.tensor(ess_floor, dtype=torch.float32, device=dev)

    st = online_lse_var_init((n_rows,), device=dev)
    converged = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    k_used = torch.full((n_rows,), k_cap, dtype=torch.int64, device=dev)
    for r in range(rounds_cap):
        if real == 0 or (r and bool(converged[:real].all())):
            break
        g = r * sp + spr
        if g < n_blocks_cap:
            lw = model.log_weights(params, cfg, x_local, k_chunk,
                                   eps=noise([g] * n_rows))
            lw = _mask_from(lw, [k_cap - g * k_chunk] * n_rows)
            st = online_lse_var_update(st, lw, dim=0,
                                       fixed_order=cfg.row_invariant)
        merged = merge_lse_var_over_sp(mesh, st)
        n_drawn = min((r + 1) * sp * k_chunk, k_cap)
        ess, se = lse_var_stats(merged.s, merged.s2, n_drawn)
        ok = ((tse > 0) & (se <= tse)) | ((floor > 0) & (ess >= floor))
        k_used = torch.where(ok & ~converged, torch.full_like(k_used, n_drawn),
                             k_used)
        converged = converged | ok

    used = k_used.tolist()  # iwaelint: disable=host-sync -- the adaptive round's one fetch: each row's block count sizes the second pass's draws on the host
    bpd_row = [_ceil_div(_ceil_div(u, k_chunk), sp) for u in used]
    st2 = online_lse_var_init((n_rows,), device=dev)
    for i in range(max(bpd_row[:real], default=0)):
        blocks = [spr * b + i for b in bpd_row]
        valid = [max(0, min(k_chunk, u - g * k_chunk)) if i < b else 0
                 for u, g, b in zip(used, blocks, bpd_row)]
        if not any(valid):
            continue
        lw = model.log_weights(params, cfg, x_local, k_chunk, eps=noise(
            [g if v else None for g, v in zip(blocks, valid)]))
        st2 = online_lse_var_update(st2, _mask_from(lw, valid), dim=0,
                                    fixed_order=cfg.row_invariant)
    merged = merge_lse_over_sp(mesh, OnlineLSE(m=st2.m, s=st2.s, n=st2.n))
    safe = _safe(merged.m)
    s2 = mesh.all_reduce(st2.s2 * torch.exp(2.0 * (st2.m - safe)), "sum",
                         AXES.sp)
    k_f = k_used.to(torch.float32)
    log_px = torch.log(merged.s) + safe - torch.log(k_f)
    _, se = lse_var_stats(merged.s, s2, k_f)
    return torch.stack([log_px, se, k_f], dim=1)


def _padded(mesh: Mesh, seeds, x: torch.Tensor):
    """`seeds` and `x` zero-padded to a multiple of dp rows, as the engine
    pads a bucket."""
    seeds = [int(s) for s in seeds]
    pad = (-len(seeds)) % mesh.dp
    if pad:
        seeds += [0] * pad
        x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]),
                                      dtype=x.dtype, device=x.device)])
    return seeds, x


def sharded_score_offline(params, cfg: model.ModelConfig, mesh: Mesh,
                          base_seed: int, seeds, x: torch.Tensor, k: int,
                          k_chunk: int = 250, *,
                          kernel_path: Optional[str] = None,
                          noise_fn=None) -> torch.Tensor:
    """Offline entry to the sharded serving ``score`` program: ``[B]``
    log p_hat(x) with rows over dp and k blocks over sp (JAX :273-305).

    Every rank calls it with the whole batch. It resolves the hot-loop gate
    as the engine does (``serving_dispatch_config`` on the mesh's device,
    `kernel_path` a pin) and calls the program the engine dispatches
    (``serving.programs.make_sharded_score_rows``), so an offline sweep
    and an online request at the same (mesh, k_chunk, engine seed, request
    seed) are bitwise equal by construction. A batch dp does not divide is
    zero-padded and sliced, as the engine's bucket. `noise_fn(g, seeds)`
    replaces the device draws of block g (tests replay JAX's draws)."""
    from iwae_replication_project_tpu_torch.ops.hot_loop import (
        serving_dispatch_config)
    from iwae_replication_project_tpu_torch.serving.programs import (
        make_sharded_score_rows)

    n = x.shape[0]
    seeds, x = _padded(mesh, seeds, x)
    cfg_d, _ = serving_dispatch_config(cfg, device=mesh.device,
                                       force=kernel_path)
    fn = make_sharded_score_rows(cfg_d, mesh, k_chunk)
    return fn(params, base_seed, seeds, x, k, noise_fn=noise_fn)[:n]


def sharded_score_adaptive_offline(params, cfg: model.ModelConfig,
                                   mesh: Mesh, base_seed: int, seeds,
                                   x: torch.Tensor, *, k_cap: int,
                                   target_se: float = 0.0,
                                   ess_floor: float = 0.0,
                                   k_chunk: int = 250,
                                   kernel_path: Optional[str] = None,
                                   noise_fn=None) -> torch.Tensor:
    """Offline entry to the adaptive serving program (JAX :243-270):
    ``[B, 3]`` rows of ``(log p_hat, achieved se, k_used)``, through the
    program ``score_adaptive`` dispatches, as :func:`sharded_score_offline`
    does for ``score``. A target <= 0 disables that criterion."""
    from iwae_replication_project_tpu_torch.ops.hot_loop import (
        serving_dispatch_config)
    from iwae_replication_project_tpu_torch.serving.programs import (
        make_sharded_score_adaptive)

    n = x.shape[0]
    seeds, x = _padded(mesh, seeds, x)
    cfg_d, _ = serving_dispatch_config(cfg, device=mesh.device,
                                       force=kernel_path)
    fn = make_sharded_score_adaptive(cfg_d, mesh, k_chunk)
    return fn(params, base_seed, seeds, x, k_cap, target_se, ess_floor,
              n_real=n, noise_fn=noise_fn)[:n]


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
    # the JAX driver's spans (JAX :571-603); they time the host's launches,
    # the suite fetching once at its end
    with span("eval/scalars"):
        scalars = parallel_dataset_scalars(
            params, cfg, mesh, batches[:, lo:lo + b_local], k, nll_k, chunk,
            generator=gen, generator_dp=gen_dp, noise=noise.get("batches"))
    with span("eval/activity"):
        means = parallel_posterior_means(
            params, cfg, mesh, x_test.reshape(n, -1), activity_samples,
            generator=gen, noise=noise.get("activity"))
    variances, eigvals = activity.activity_from_means(means)
    masks, n_active, n_active_pca = activity.active_units(variances, eigvals)
    with span("eval/pruned_nll"):
        pruned = parallel_pruned_nll(params, cfg, mesh, batches[0], masks,
                                     k=nll_k, chunk=chunk, generator=gen,
                                     noise=noise.get("pruned"))
    fetched = torch.cat([scalars, n_active.float(), n_active_pca.float(),  # iwaelint: disable=host-sync -- the suite's one fetch, after all of its device work
                         pruned.reshape(1)]).cpu().tolist()
    L = len(masks)
    res = dict(zip(ev.SCALAR_NAMES, fetched))
    res["nll_chunk"] = float(chunk)
    res["eval_batch"] = float(batch_size)
    res["kernel_path"] = ev._kernel_path_code(cfg, mesh.device, chunk,
                                              b_local)
    res["LL_pruned"] = fetched[-1]
    rest = fetched[len(ev.SCALAR_NAMES):]
    res2 = {"active_units": masks,
            "number_of_active_units": [int(v) for v in rest[:L]],
            "number_of_PCA_active_units": [int(v) for v in rest[L:2 * L]],
            "variances": variances}
    return res, res2
