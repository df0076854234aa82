"""Stable log-space reductions, including a streaming (online) logsumexp
(port of ``ops/logsumexp.py``).

The dense reductions serve the bounds; the online carries (running max plus
rescaled sum) serve large-k evaluation, which folds the k=5000 NLL in
k-chunks with O(chunk) memory. Every carry is never-NaN: an all ``-inf``
column finalizes to ``-inf`` and :func:`lse_var_stats` gives it ess 0 and se
``+inf``. The element count ``n`` is a Python int: chunk sizes are known on
the host. ``fixed_order=True`` (the serving programs) takes every
sum through ``ops/row_invariant.fixed_sum``, whose outputs do not depend on
the batch; maxima are exact in any order.

While the span recorder is on (``telemetry/spans.REC``), a call of
:func:`streaming_logmeanexp` records ``eval/batch`` (attr ``batch``, the
call's sequence number) around its carry, its chunks and its end; per chunk
``eval/chunk`` (with the CUDA event pair: the chunk's device time; attrs
``batch`` and ``chunk``) and its children ``eval/log_weights`` and
``eval/lse_update``; then ``eval/finalize``; and counts ``eval/chunks``.
Off, a chunk pays one flag test.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from iwae_replication_project_tpu_torch.ops.row_invariant import (
    sum_over as _sum,
)
from iwae_replication_project_tpu_torch.telemetry.spans import REC


def logsumexp(log_w: torch.Tensor, dim: int = 0,
              fixed_order: bool = False) -> torch.Tensor:
    """Max-subtracted logsumexp along `dim`; an all ``-inf`` column gives
    ``-inf``, not NaN."""
    m = torch.amax(log_w, dim=dim, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(_sum(torch.exp(log_w - m), dim, fixed_order)) \
        + m.squeeze(dim)


def logmeanexp(log_w: torch.Tensor, dim: int = 0,
               fixed_order: bool = False) -> torch.Tensor:
    """``log mean exp`` along `dim`: the IWAE bound core."""
    return logsumexp(log_w, dim=dim, fixed_order=fixed_order) \
        - math.log(float(log_w.shape[dim]))


def _safe(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


class OnlineLSE(NamedTuple):
    """Carry of the streaming logsumexp (JAX :34-82): `m` the running max,
    `s` the sum of ``exp(x - m)`` seen so far, `n` the element count.
    Merging two states is associative."""

    m: torch.Tensor
    s: torch.Tensor
    n: int


def online_logsumexp_init(shape, dtype=torch.float32,
                          device=None) -> OnlineLSE:
    return OnlineLSE(m=torch.full(shape, -math.inf, dtype=dtype,
                                  device=device),
                     s=torch.zeros(shape, dtype=dtype, device=device), n=0)


def online_logsumexp_update(state: OnlineLSE, log_w: torch.Tensor,
                            dim: int = 0,
                            fixed_order: bool = False) -> OnlineLSE:
    """Fold a chunk of log-weights (reduced along `dim`) into the state."""
    new_m = torch.maximum(state.m, torch.amax(log_w, dim=dim))
    safe_m = _safe(new_m)
    scaled_old = state.s * torch.exp(state.m - safe_m)
    chunk_s = _sum(torch.exp(log_w - safe_m.unsqueeze(dim)), dim,
                   fixed_order)
    return OnlineLSE(m=new_m, s=scaled_old + chunk_s,
                     n=state.n + log_w.shape[dim])


def online_logsumexp_merge(a: OnlineLSE, b: OnlineLSE) -> OnlineLSE:
    """Associative merge of two partial states."""
    new_m = torch.maximum(a.m, b.m)
    safe_m = _safe(new_m)
    return OnlineLSE(m=new_m, s=a.s * torch.exp(a.m - safe_m)
                     + b.s * torch.exp(b.m - safe_m), n=a.n + b.n)


def online_logsumexp_finalize(state: OnlineLSE,
                              mean: bool = False) -> torch.Tensor:
    out = torch.log(state.s) + _safe(state.m)
    if mean:
        out = out - math.log(float(state.n))
    return out


class OnlineLSEVar(NamedTuple):
    """The streaming carry with the second weight moment (JAX :85-148):
    ``s2 = sum(exp(2 (x - m)))`` under the same running max, which per-row
    ESS and standard-error estimates need (:func:`lse_var_stats`). The
    ``(m, s)`` arithmetic is expression-identical to :class:`OnlineLSE`'s,
    so both carries give bitwise the same ``(m, s)``."""

    m: torch.Tensor
    s: torch.Tensor
    s2: torch.Tensor
    n: int


def online_lse_var_init(shape, dtype=torch.float32,
                        device=None) -> OnlineLSEVar:
    return OnlineLSEVar(m=torch.full(shape, -math.inf, dtype=dtype,
                                     device=device),
                        s=torch.zeros(shape, dtype=dtype, device=device),
                        s2=torch.zeros(shape, dtype=dtype, device=device),
                        n=0)


def online_lse_var_update(state: OnlineLSEVar, log_w: torch.Tensor,
                          dim: int = 0,
                          fixed_order: bool = False) -> OnlineLSEVar:
    """Fold a chunk of log-weights into the augmented state; ``s2``
    rescales by ``exp(2 (m_old - m_new))``."""
    new_m = torch.maximum(state.m, torch.amax(log_w, dim=dim))
    safe_m = _safe(new_m)
    scaled_old = state.s * torch.exp(state.m - safe_m)
    chunk_s = _sum(torch.exp(log_w - safe_m.unsqueeze(dim)), dim,
                   fixed_order)
    scaled_old2 = state.s2 * torch.exp(2.0 * (state.m - safe_m))
    chunk_s2 = _sum(torch.exp(2.0 * (log_w - safe_m.unsqueeze(dim))), dim,
                    fixed_order)
    return OnlineLSEVar(m=new_m, s=scaled_old + chunk_s,
                        s2=scaled_old2 + chunk_s2,
                        n=state.n + log_w.shape[dim])


def online_lse_var_merge(a: OnlineLSEVar, b: OnlineLSEVar) -> OnlineLSEVar:
    """Associative merge of two augmented partial states."""
    new_m = torch.maximum(a.m, b.m)
    safe_m = _safe(new_m)
    return OnlineLSEVar(
        m=new_m,
        s=a.s * torch.exp(a.m - safe_m) + b.s * torch.exp(b.m - safe_m),
        s2=a.s2 * torch.exp(2.0 * (a.m - safe_m))
        + b.s2 * torch.exp(2.0 * (b.m - safe_m)),
        n=a.n + b.n)


def lse_var_stats(s: torch.Tensor, s2: torch.Tensor, n) -> tuple:
    """``(ess, se)`` from the max-subtracted sums of an augmented carry
    (JAX :151-169): ``ess = s^2 / s2`` and the delta-method standard error
    of ``log mean(w)`` with the n/(n-1) correction. ``n`` is one count or a
    tensor of per-row counts (the adaptive scorer's ``k_used``), whose
    correction is then formed in ``s``'s dtype, as JAX forms it. A row with
    ``s == 0`` (all ``-inf``) gets ess 0 and se ``+inf``, never NaN."""
    pos = s > 0
    safe_s = torch.where(pos, s, torch.ones_like(s))
    safe_s2 = torch.where(s2 > 0, s2, torch.ones_like(s2))
    ess = torch.where(pos, safe_s * safe_s / safe_s2, torch.zeros_like(s))
    if isinstance(n, torch.Tensor):
        n_f = n.to(s.dtype)
        bessel = n_f / torch.clamp_min(n_f - 1.0, 1.0)
        inv_n = 1.0 / torch.clamp_min(n_f, 1.0)
    else:
        n_f = float(n)
        bessel = n_f / max(n_f - 1.0, 1.0)
        inv_n = 1.0 / max(n_f, 1.0)
    var = torch.clamp_min(safe_s2 / (safe_s * safe_s) - inv_n, 0.0) * bessel
    se = torch.where(pos, torch.sqrt(var), torch.full_like(s, math.inf))
    return ess, se


def streaming_logmeanexp(log_w_fn: Callable[[int], torch.Tensor], k: int,
                         chunk: int, shape, dtype=torch.float32,
                         device=None,
                         merge: Optional[Callable[[OnlineLSE], OnlineLSE]]
                         = None) -> torch.Tensor:
    """``logmeanexp`` over k samples produced chunk by chunk:
    ``log_w_fn(i)`` returns the ``[chunk, *shape]`` log-weights of chunk i.
    Memory is O(chunk), not O(k). `merge` maps the carry of these k samples
    to that of all samples before it is finalised (``parallel/eval.py``
    merges the carries of the ranks that share the sample axis)."""
    if k % chunk != 0:
        raise ValueError(f"k={k} is not divisible by chunk={chunk}: "
                         f"the chunk must divide k")
    batch = REC.next_seq("eval/batch") if REC.on else None
    outer = REC.begin("eval/batch", {"batch": batch}) if REC.on else None
    try:
        state = online_logsumexp_init(shape, dtype, device)
        for i in range(k // chunk):
            if outer is not None:
                state = _recorded_chunk(state, log_w_fn, i, batch, device)
            else:
                state = online_logsumexp_update(state, log_w_fn(i), dim=0)
        with REC.section("eval/finalize"):
            if merge is not None:
                state = merge(state)
            return online_logsumexp_finalize(state, mean=True)
    finally:
        if outer is not None:
            REC.end(outer)


def _recorded_chunk(state: OnlineLSE, log_w_fn, i: int, batch: int,
                    device) -> OnlineLSE:
    """One chunk of :func:`streaming_logmeanexp` under its spans."""
    on_card = device is not None and torch.device(device).type == "cuda"
    sp = REC.begin("eval/chunk", {"batch": batch, "chunk": i},
                   device=on_card)
    try:
        with REC.section("eval/log_weights"):
            log_w = log_w_fn(i)
        with REC.section("eval/lse_update"):
            state = online_logsumexp_update(state, log_w, dim=0)
    finally:
        REC.end(sp)
    REC.count("eval/chunks")
    return state
