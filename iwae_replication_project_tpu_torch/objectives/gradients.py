"""Gradient estimators, including the ones that differ from plain autodiff
(port of ``objectives/gradients.py``).

Standard objectives (VAE/IWAE/VAE_V1/MIWAE/CIWAE/L_*) are the autograd
gradient of the bound. Three estimators prescribe other gradients for the
same IWAE-family bound:

* **STL** (sticking the landing): the score term of ``log q`` dropped, the
  pathwise gradient under cotangent ``w~`` (the normalized weights);
* **DReG** (doubly reparameterized): encoder cotangent ``w~^2`` on the
  score-stopped graph, decoder the standard ``w~``;
* **PIWAE**: decoder trained on the full k-sample IWAE bound, encoder on the
  MIWAE(k1, k2) bound.

All three are explicit cotangents on the ``[k, B]`` log-weights: one
forward pass, then ``torch.autograd.grad(log_w, leaves, grad_outputs=ct)``
per cotangent, the encoder leaves from one pass and the rest from the other.
With the fused hot loop each such pass runs the backward kernel once, so a
DReG or PIWAE step launches it twice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives import estimators as est
from iwae_replication_project_tpu_torch.utils.tree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)


def _grad_leaves(params):
    """`params` with every leaf a tensor that autograd can differentiate
    against (leaves already requiring grad are kept, others are detached
    views with ``requires_grad``)."""
    return tree_map(lambda t: t if t.requires_grad and t.is_leaf
                    else t.detach().requires_grad_(True), params)


def _grads(out, leaves, grad_outputs=None, retain_graph=False):
    """d out / d leaves, zeros for leaves `out` does not depend on."""
    got = torch.autograd.grad(out, leaves, grad_outputs=grad_outputs,
                              retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, got)]


def _split_pass(log_w, params, ct_enc, ct_rest):
    """Encoder gradients under cotangent `ct_enc`, every other subtree under
    `ct_rest`: two backward passes over the same graph."""
    enc = tree_leaves(params["enc"])
    rest_tree = {key: v for key, v in params.items() if key != "enc"}
    rest = tree_leaves(rest_tree)
    g_enc = _grads(log_w, enc, ct_enc, retain_graph=True)
    g_rest = _grads(log_w, rest, ct_rest)
    out = tree_unflatten(rest_tree, g_rest)
    out["enc"] = tree_unflatten(params["enc"], g_enc)
    return {key: out[key] for key in params}


def _normalized_weights(log_w: torch.Tensor) -> torch.Tensor:
    """``w~ = softmax_k(log w)``, as a constant."""
    return torch.softmax(log_w.detach(), dim=0)


def objective_value_and_grad(spec: est.ObjectiveSpec, params, cfg, x, *,
                             generator: Optional[torch.Generator] = None,
                             eps: Optional[Sequence[torch.Tensor]] = None
                             ) -> Tuple[torch.Tensor, dict]:
    """``(bound, d bound / d params)`` for any objective, special-casing the
    modified-gradient estimators. The bound is a detached 0-d tensor on the
    device (no host sync); the gradients form a tree shaped like `params`.
    Train steps negate them for descent. The model's noise comes from
    `generator`, or is injected through `eps` (one tensor per stochastic
    layer, as ``models.iwae.encode`` takes it)."""
    params = _grad_leaves(params)
    name = spec.name
    B = x.shape[0]
    if name in ("DReG", "STL"):
        log_w = model.log_weights(params, cfg, x, spec.k, generator=generator,
                                  eps=eps, stop_q_score=True)
        w_tilde = _normalized_weights(log_w)
        bound = est.iwae_bound(log_w.detach())
        if name == "STL":
            leaves = tree_leaves(params)
            return bound, tree_unflatten(
                params, _grads(log_w, leaves, w_tilde / B))
        return bound, _split_pass(log_w, params, w_tilde.square() / B,
                                  w_tilde / B)
    if name == "PIWAE":
        log_w = model.log_weights(params, cfg, x, spec.k, generator=generator,
                                  eps=eps)
        bound = est.iwae_bound(log_w.detach())
        # d IWAE / d log_w: softmax over the full k axis, / B
        ct_dec = _normalized_weights(log_w) / B
        # d MIWAE / d log_w: softmax within each k1-group, / (k2 * B)
        k2 = spec.k2
        grouped = log_w.detach().reshape(k2, spec.k // k2, *log_w.shape[1:])
        ct_enc = torch.softmax(grouped, dim=1).reshape(log_w.shape) / (k2 * B)
        return bound, _split_pass(log_w, params, ct_enc, ct_dec)

    log_w, aux = model.log_weights_and_aux(params, cfg, x, spec.k,
                                           generator=generator, eps=eps)
    bound = est.bound_from_log_weights(spec, log_w, aux)
    leaves = tree_leaves(params)
    return bound.detach(), tree_unflatten(params, _grads(bound, leaves))
