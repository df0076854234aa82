"""Dense / stochastic-block primitives on plain parameter dicts (port of
``models/mlp.py``).

Parameters keep the JAX package's tree: a dense layer is ``{"w": [in, out],
"b": [out]}``, a stochastic block ``{"l1", "l2", "mu", "lstd"}`` and the
decoder output block ``{"l1", "l2", "out"}``. The k-sample fan-out lives in the
leading axes of the activations (``[k, B, d]``), so each layer is one matmul.

bf16 semantics follow JAX's ``jnp.dot(x.astype(bf16), w.astype(bf16),
preferred_element_type=f32)``: both operands are rounded to bf16, the product
is accumulated in fp32 and returned in fp32. ``torch.matmul`` on bf16 tensors
would round its output to bf16 a second time, so the operands are rounded and
then multiplied in fp32 instead (a product of two bf16 values is exact in
fp32, so only the summation order can differ from JAX).

``row_invariant=True`` (the serving programs on every device, set by
``ops/hot_loop.serving_dispatch_config``) runs each layer through
``ops/row_invariant.dense``: the same function with every output summed
over K in one fixed order, so a row's bits do not depend on its batch.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from iwae_replication_project_tpu_torch.ops import latent_block
from iwae_replication_project_tpu_torch.ops import row_invariant as ri_ops

Params = Dict[str, Any]


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               bias=None) -> Params:
    """Glorot-uniform kernel, zero (or given) bias: Keras Dense defaults."""
    limit = math.sqrt(6.0 / (in_dim + out_dim))
    w = (torch.rand((in_dim, out_dim), generator=generator) * 2.0 - 1.0) * limit
    b = torch.zeros(out_dim) if bias is None \
        else torch.as_tensor(bias, dtype=torch.float32).clone()
    return {"w": w, "b": b}


def dense_apply(p: Params, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None, *,
                tanh: bool = False,
                row_invariant: bool = False) -> torch.Tensor:
    """``x @ w + b`` (then tanh with ``tanh=True``)."""
    layer = ri_ops.dense if row_invariant else ri_ops.dense_plain
    return layer(x, p["w"], p["b"], compute_dtype, tanh)


def stochastic_block_init(generator: torch.Generator, in_dim: int,
                          hidden: int, latent: int) -> Params:
    return {
        "l1": dense_init(generator, in_dim, hidden),
        "l2": dense_init(generator, hidden, hidden),
        "mu": dense_init(generator, hidden, latent),
        "lstd": dense_init(generator, hidden, latent),
    }


def stochastic_block_apply(p: Params, x: torch.Tensor,
                           std_floor: float = 1e-6,
                           compute_dtype: Optional[torch.dtype] = None,
                           row_invariant: bool = False):
    """``(mu, std)`` of the conditional Gaussian given `x`;
    std = exp(head) + floor: ``ops/latent_block.mu_std``, whose plain
    versions of the fused sample-level block share it."""
    return latent_block.mu_std(p, x, std_floor, compute_dtype, row_invariant)


def output_block_init(generator: torch.Generator, in_dim: int, hidden: int,
                      out_dim: int, out_bias=None) -> Params:
    """Final deterministic decoder head: 2x tanh-Dense + logit layer.
    `out_bias` (``[out_dim]``, e.g. the data layer's logit of the pixel
    means) initialises the logit layer's bias; None means zeros."""
    return {
        "l1": dense_init(generator, in_dim, hidden),
        "l2": dense_init(generator, hidden, hidden),
        "out": dense_init(generator, hidden, out_dim, bias=out_bias),
    }


def output_block_apply(p: Params, x: torch.Tensor,
                       compute_dtype: Optional[torch.dtype] = None,
                       row_invariant: bool = False) -> torch.Tensor:
    """Pixel *logits* of shape ``[..., out_dim]``."""
    kw = dict(row_invariant=row_invariant)
    y = dense_apply(p["l1"], x, compute_dtype, tanh=True, **kw)
    y = dense_apply(p["l2"], y, compute_dtype, tanh=True, **kw)
    return dense_apply(p["out"], y, compute_dtype, **kw)
