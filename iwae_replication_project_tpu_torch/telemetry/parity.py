"""Statistical parity acceptance for low-precision serving (port of
``telemetry/parity.py``, the port's own copy: pure numpy, nothing of the
JAX package imported).

Bitwise parity is the wrong gate for the bf16 and int8 decoder paths: their
point is not to reproduce fp32 bit for bit. What must hold instead is that
the estimator a tenant receives is statistically indistinguishable for
serving purposes, and this module is the one definition of that contract,
shared by ``chip_smoke.py``'s int8 phase and the tests.

Given the ``[k, B]`` log-weight matrices of the fp32 oracle and of a
low-precision leg over the same rows, seeds and k, acceptance requires all
of:

* ``row_rel_max`` -- max over rows of ``|delta log p_hat(x)|``, relative to
  the oracle's batch-NLL magnitude, within ``max_row_rel_delta``;
* ``batch_nll`` -- ``|delta mean(-log p_hat)|`` in absolute nats within
  ``max_batch_nll_delta``;
* ``ess_frac`` -- absolute drift of the normalized effective sample size
  within ``max_ess_frac_drift``;
* ``log_weight_var`` -- drift of ``mean Var_k[log w]`` relative to the
  oracle's value within ``max_log_weight_var_rel_drift``.

Every check is two-sided: a "better" NLL from a quantized path is as much
a parity violation as a worse one. This is an offline gate over
log-weights the caller already fetched; nothing here touches the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class ParityTolerances:
    """Acceptance bounds for one precision policy (frozen -> hashable,
    usable as a parameter of cached check programs).

    All bounds are two-sided; ``row`` and ``log_weight_var`` are relative
    to the oracle's own magnitude (see the module docstring), ``batch_nll``
    and ``ess_frac`` are absolute.
    """

    #: max over rows of |Δ log p̂(x)| / max(1, |oracle batch NLL|) — the
    #: per-request bound, scale-free
    max_row_rel_delta: float
    #: |Δ batch mean NLL| in nats — the fleet-quality bound
    max_batch_nll_delta: float
    #: |Δ mean ESS/k| — importance-weight coverage drift (range [0, 1])
    max_ess_frac_drift: float
    #: |Δ mean Var_k[log w]| / max(1, oracle value) — weight-spread drift
    max_log_weight_var_rel_drift: float

    def __post_init__(self):
        for f in dataclasses.fields(self):
            if getattr(self, f.name) <= 0:
                raise ValueError(f"{f.name} must be > 0 (a zero tolerance "
                                 f"is a request for bitwise parity — serve "
                                 f"fp32 instead)")


#: bf16 operands / fp32 accumulation: ~8 mantissa bits through the whole
#: pass — measured deltas sit ~10x inside these at both the 24-pixel
#: smoke shape and the 784-pixel paper shape, while a +1-nat bias or a
#: wrong-weights program lands far outside.
BF16_TOLERANCES = ParityTolerances(
    max_row_rel_delta=0.01,
    max_batch_nll_delta=0.1,
    max_ess_frac_drift=0.05,
    max_log_weight_var_rel_drift=0.1,
)

#: weight-only int8 (symmetric per-output-channel, fp32 accumulation):
#: quantization noise is bounded by the per-channel step but compounds
#: through the stack, so the gate is looser than bf16 — still orders of
#: magnitude tighter than any wrong-program failure mode.
INT8_TOLERANCES = ParityTolerances(
    max_row_rel_delta=0.02,
    max_batch_nll_delta=0.25,
    max_ess_frac_drift=0.1,
    max_log_weight_var_rel_drift=0.2,
)

#: policy name -> default gate; fp32 has no entry on purpose (its contract
#: is bitwise identity, checked directly by the callers)
DEFAULT_TOLERANCES = {"bf16": BF16_TOLERANCES, "int8": INT8_TOLERANCES}


def _row_log_phat(log_w: np.ndarray) -> np.ndarray:
    """Per-row IWAE estimate ``log p̂ = logsumexp_k(log w) - log k``,
    max-stabilized exactly like the bound itself."""
    m = np.max(log_w, axis=0)
    return m + np.log(np.mean(np.exp(log_w - m), axis=0))


def _weight_stats(log_w: np.ndarray) -> Dict[str, float]:
    """Host twin of diagnostics.weight_diagnostics + the NLL the serving
    row delivers."""
    k = log_w.shape[0]
    lse1 = np.max(log_w, axis=0) + np.log(
        np.sum(np.exp(log_w - np.max(log_w, axis=0)), axis=0))
    lse2 = np.max(2.0 * log_w, axis=0) + np.log(
        np.sum(np.exp(2.0 * log_w - np.max(2.0 * log_w, axis=0)), axis=0))
    ess = np.exp(2.0 * lse1 - lse2)
    return {
        "batch_nll": float(-np.mean(_row_log_phat(log_w))),
        "ess_frac": float(np.mean(ess) / k),
        "log_weight_var": float(np.mean(np.var(log_w, axis=0))),
    }


def statistical_parity(log_w_ref: np.ndarray, log_w_test: np.ndarray,
                       tol: ParityTolerances) -> Dict:
    """Gate one low-precision leg against the fp32 oracle.

    `log_w_ref` / `log_w_test` are ``[k, B]`` log-weight matrices over the
    same rows, seeds, and k (shape mismatch is a harness bug and raises).
    Returns a JSON-ready verdict::

        {"accepted": bool,
         "deltas":   {row_abs_max, row_rel_max, batch_nll, ess_frac,
                      log_weight_var, log_weight_var_rel},
         "ref":      {batch_nll, ess_frac, log_weight_var},
         "test":     {...},
         "failures": ["batch_nll 0.31 exceeds 0.25", ...]}

    Gated deltas are ``row_rel_max`` / ``batch_nll`` / ``ess_frac`` /
    ``log_weight_var_rel`` (the absolute ``row_abs_max`` and
    ``log_weight_var`` ride along for the artifact); ``failures`` is empty
    iff ``accepted``. A NaN anywhere in the test leg fails every gate it
    reaches (NaN comparisons are False, so ``accepted`` can never be True
    off a NaN delta — pinned by the unit tests).
    """
    if log_w_ref.shape != log_w_test.shape:
        raise ValueError(f"log-weight shapes differ: oracle "
                         f"{log_w_ref.shape} vs test {log_w_test.shape}; "
                         f"parity legs must share rows, seeds, and k")
    ref = _weight_stats(log_w_ref)
    test = _weight_stats(log_w_test)
    row_abs = float(np.max(np.abs(
        _row_log_phat(log_w_test) - _row_log_phat(log_w_ref))))
    var_abs = float(abs(test["log_weight_var"] - ref["log_weight_var"]))
    deltas = {
        "row_abs_max": row_abs,
        "row_rel_max": row_abs / max(1.0, abs(ref["batch_nll"])),
        "batch_nll": float(abs(test["batch_nll"] - ref["batch_nll"])),
        "ess_frac": float(abs(test["ess_frac"] - ref["ess_frac"])),
        "log_weight_var": var_abs,
        "log_weight_var_rel": var_abs / max(1.0, ref["log_weight_var"]),
    }
    bounds = {
        "row_rel_max": tol.max_row_rel_delta,
        "batch_nll": tol.max_batch_nll_delta,
        "ess_frac": tol.max_ess_frac_drift,
        "log_weight_var_rel": tol.max_log_weight_var_rel_drift,
    }
    failures = [f"{name} {deltas[name]:.6g} exceeds {bounds[name]:g}"
                for name in bounds
                if not deltas[name] <= bounds[name]]   # NaN-safe: not <=
    return {"accepted": not failures, "deltas": deltas,
            "ref": ref, "test": test, "failures": failures}
