"""Evaluation metrics (port of ``evaluation/metrics.py``): every scalar of a
batch from one log-weights pass, and the k=5000 NLL streamed in k-chunks.

* VAE bound        = mean(log w)
* IWAE bound       = mean_B logmeanexp_k(log w)
* E_q[log p(x|h)]  = mean(log p(x|h))
* D_KL(q||p(h))    = E_q[log p(x|h)] - L_VAE
* D_KL(q||p(h|x))  = L_5000 - L_VAE
* NLL              = -IWAE bound at k=5000

The NLL is a Python loop over k-chunks folding each chunk's ``[chunk, B]``
log-weights into an :class:`..ops.logsumexp.OnlineLSE` carry, so memory is
O(chunk), never O(k): ``[5000, B, ...]`` is never materialised. Evaluation
never differentiates: every function here runs under ``torch.no_grad()``,
so on the card the hot loop's forward kernel (B1) runs and its backward (B2)
never does.

**Randomness.** Every function draws from a ``torch.Generator`` on the
tensors' device, in a fixed order, or takes injected standard-normal noise
instead, as ``models.iwae.encode`` does (tests replay the JAX package's
draws through it). :func:`eval_generator` seeds the generator of stage `s`
of a run from ``(seed + 10_000, s)``, and that of the stage's estimator
diagnostics from ``(seed + 10_000, 30_000 + s)``: the port's twin of JAX's
``fold_in(PRNGKey(seed + 10_000), s)`` (experiment.py:246, 359, 397). The two
frameworks' generators never give the same numbers; only the structure is
shared.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from iwae_replication_project_tpu_torch.evaluation import activity
from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives import estimators as est
from iwae_replication_project_tpu_torch.ops import distributions as dist
from iwae_replication_project_tpu_torch.ops import hot_loop
from iwae_replication_project_tpu_torch.ops.logsumexp import (
    OnlineLSE,
    streaming_logmeanexp,
)
from iwae_replication_project_tpu_torch.utils.sizes import largest_divisor_leq

#: encoder noise of one chunk or batch: one tensor per stochastic layer
Eps = Sequence[torch.Tensor]

SCALAR_NAMES = ("VAE", "IWAE", "NLL", "E_q(h|x)[log(p(x|h))]",
                "D_kl(q(h|x),p(h))", "D_kl(q(h|x),p(h|x))",
                "reconstruction_loss")


def eval_generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator on `device` of eval stream `stream` (the stage, or
    ``30_000 + stage`` for the estimator diagnostics) of a run seeded
    `seed`: seeded from ``(seed + 10_000, stream)``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(((seed + 10_000) << 20) + stream)
    return gen


@torch.no_grad()
def batch_metrics(params, cfg: model.ModelConfig, x: torch.Tensor, k: int, *,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[Eps] = None) -> Dict[str, torch.Tensor]:
    """The single-pass metric bundle (everything but the k=5000 terms), as
    0-d tensors on the device."""
    log_w, aux = model.log_weights_and_aux(params, cfg, x, k,
                                           generator=generator, eps=eps)
    vae = est.vae_bound(log_w)
    recon_term = torch.mean(aux["log_px_given_h"])
    return {"VAE": vae, "IWAE": est.iwae_bound(log_w),
            "E_q(h|x)[log(p(x|h))]": recon_term,
            "D_kl(q(h|x),p(h))": recon_term - vae}


@torch.no_grad()
def streaming_log_px(params, cfg: model.ModelConfig, x: torch.Tensor,
                     k: int = 5000, chunk: int = 250, *,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Callable[[int], Eps]] = None,
                     merge: Optional[Callable[[OnlineLSE], OnlineLSE]] = None
                     ) -> torch.Tensor:
    """Per-example IWAE-k log-likelihood estimate ``[B]``, O(chunk) memory.

    Chunk j draws `chunk` fresh importance samples (``noise(j)`` injects
    them) and folds their log-weights into the online carry. `merge` turns
    the carry of these k samples into that of all the ranks' samples
    (``parallel/eval.py``; the estimate then averages over them all)."""
    return streaming_logmeanexp(
        lambda j: model.log_weights(params, cfg, x, chunk, generator=generator,
                                    eps=None if noise is None else noise(j)),
        k, chunk, (x.shape[0],), device=x.device, merge=merge)


def streaming_nll(params, cfg: model.ModelConfig, x: torch.Tensor,
                  k: int = 5000, chunk: int = 250, *,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Callable[[int], Eps]] = None
                  ) -> torch.Tensor:
    """0-d NLL = -mean_B log p^(x)."""
    return -torch.mean(streaming_log_px(params, cfg, x, k, chunk,
                                        generator=generator, noise=noise))


@torch.no_grad()
def reconstruction_loss(params, cfg: model.ModelConfig, x: torch.Tensor, *,
                        generator: Optional[torch.Generator] = None,
                        enc_eps: Optional[Eps] = None,
                        dec_eps: Optional[Eps] = None) -> torch.Tensor:
    """Pixel BCE of the 1-sample ancestral reconstruction:
    ``-mean_B sum_pix log p(x | recon probs)``."""
    probs = model.reconstruct_probs(params, cfg, x, generator=generator,
                                    enc_eps=enc_eps, dec_eps=dec_eps)
    lp = dist.bernoulli_log_prob(x[None], probs)
    return -torch.mean(torch.sum(lp, dim=-1))


@torch.no_grad()
def dataset_scalars(params, cfg: model.ModelConfig, batches: torch.Tensor,
                    k: int, nll_k: int, nll_chunk: int, *,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Callable[[int], dict]] = None
                    ) -> torch.Tensor:
    """The 7 eval scalars over ``[n_batches, B, d]`` batches, in
    :data:`SCALAR_NAMES` order and averaged over batches: a ``[7]`` tensor
    on the device, which the caller fetches once.

    Per batch: :func:`batch_metrics`, the streamed NLL, then
    :func:`reconstruction_loss`, drawing in that order. ``noise(i)`` injects
    batch i's draws as a dict: ``"metrics"`` (encoder eps), ``"nll"`` (a
    callable: chunk j -> encoder eps), ``"recon_enc"`` and ``"recon_dec"``.
    """
    tot = torch.zeros(len(SCALAR_NAMES), device=batches.device)
    for i in range(batches.shape[0]):
        xb = batches[i]
        nz = {} if noise is None else noise(i)
        m = batch_metrics(params, cfg, xb, k, generator=generator,
                          eps=nz.get("metrics"))
        nll = streaming_nll(params, cfg, xb, nll_k, nll_chunk,
                            generator=generator, noise=nz.get("nll"))
        rl = reconstruction_loss(params, cfg, xb, generator=generator,
                                 enc_eps=nz.get("recon_enc"),
                                 dec_eps=nz.get("recon_dec"))
        tot += torch.stack([
            m["VAE"], m["IWAE"], nll, m["E_q(h|x)[log(p(x|h))]"],
            m["D_kl(q(h|x),p(h))"],
            -nll - m["VAE"],  # L_5000 - L_VAE
            rl])
    return tot / batches.shape[0]


def _kernel_path_code(cfg: model.ModelConfig, device, k: int,
                      batch: int) -> float:
    """The ``PATH_CODES`` code of the hot-loop path ``log_px_given_h``
    takes for `cfg` on `device` at a (k, batch) call (JAX
    ``path_code_for_model``: the NLL chunk's)."""
    if not cfg.fused_likelihood:
        return float(hot_loop.PATH_CODES["reference"])
    return float(hot_loop.PATH_CODES[hot_loop.select_path(
        device, cfg.hot_loop_path, widths=hot_loop.block_widths(cfg),
        shape=(k, batch, cfg.x_dim))])


@torch.no_grad()
def training_statistics(params, cfg: model.ModelConfig, x_test: torch.Tensor,
                        k: int, batch_size: int = 100, nll_k: int = 5000,
                        nll_chunk: int = 250, activity_samples: int = 1000,
                        *,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[dict] = None
                        ) -> Tuple[Dict[str, float], Dict[str, object]]:
    """The full eval suite (JAX :142-206): returns ``(res, res2)``.

    `res` maps the 7 scalar names plus ``nll_chunk`` and ``eval_batch``
    (the sizes actually used: the batch is clamped to the largest divisor
    of the test-set size, the chunk to the largest divisor of `nll_k`),
    ``kernel_path`` and ``LL_pruned``; `res2` holds ``active_units`` (0/1
    masks per layer), ``number_of_active_units``,
    ``number_of_PCA_active_units`` and ``variances``. Everything is
    computed on the device and fetched once. Draws come from `generator` in
    the order: the batches (:func:`dataset_scalars`), the activity estimate,
    the pruned NLL; `noise` injects them as a dict ``{"batches": ...,
    "activity": ..., "pruned": ...}`` of the callables those functions
    take.
    """
    noise = noise or {}
    n = x_test.shape[0]
    batch_size = largest_divisor_leq(n, batch_size)
    nll_chunk = largest_divisor_leq(nll_k, nll_chunk)
    n_batches = n // batch_size
    batches = x_test.reshape(n_batches, batch_size, -1)
    scalars = dataset_scalars(params, cfg, batches, k, nll_k, nll_chunk,
                              generator=generator, noise=noise.get("batches"))
    variances, eigvals = activity.posterior_mean_activity(
        params, cfg, x_test.reshape(n, -1), n_samples=activity_samples,
        generator=generator, noise=noise.get("activity"))
    masks, n_active, n_active_pca = activity.active_units(variances, eigvals)
    pruned = activity.nll_without_inactive_units(
        params, cfg, batches[0], masks, k=nll_k, chunk=nll_chunk,
        generator=generator, noise=noise.get("pruned"))
    fetched = torch.cat([scalars, n_active.float(), n_active_pca.float(),
                         pruned.reshape(1)]).cpu().tolist()  # the one fetch
    L = len(masks)
    res = dict(zip(SCALAR_NAMES, fetched))
    res["nll_chunk"] = float(nll_chunk)
    res["eval_batch"] = float(batch_size)
    res["kernel_path"] = _kernel_path_code(cfg, x_test.device, nll_chunk,
                                           batch_size)
    res["LL_pruned"] = fetched[-1]
    rest = fetched[len(SCALAR_NAMES):]
    res2 = {"active_units": masks,
            "number_of_active_units": [int(v) for v in rest[:L]],
            "number_of_PCA_active_units": [int(v) for v in rest[L:2 * L]],
            "variances": variances}
    return res, res2
