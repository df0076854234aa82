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
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

Params = Dict[str, Any]


def dense_init(generator: torch.Generator, in_dim: int,
               out_dim: int) -> Params:
    """Glorot-uniform kernel, zero bias: Keras Dense defaults."""
    limit = math.sqrt(6.0 / (in_dim + out_dim))
    w = (torch.rand((in_dim, out_dim), generator=generator) * 2.0 - 1.0) * limit
    return {"w": w, "b": torch.zeros(out_dim)}


def dense_apply(p: Params, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    w = p["w"]
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
    return torch.matmul(x, w) + p["b"]


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
                           compute_dtype: Optional[torch.dtype] = None):
    """``(mu, std)`` of the conditional Gaussian given `x`;
    std = exp(head) + floor."""
    y = torch.tanh(dense_apply(p["l1"], x, compute_dtype))
    y = torch.tanh(dense_apply(p["l2"], y, compute_dtype))
    mu = dense_apply(p["mu"], y, compute_dtype)
    std = torch.exp(dense_apply(p["lstd"], y, compute_dtype)) + std_floor
    return mu, std


def output_block_init(generator: torch.Generator, in_dim: int, hidden: int,
                      out_dim: int) -> Params:
    """Final deterministic decoder head: 2x tanh-Dense + logit layer."""
    return {
        "l1": dense_init(generator, in_dim, hidden),
        "l2": dense_init(generator, hidden, hidden),
        "out": dense_init(generator, hidden, out_dim),
    }


def output_block_apply(p: Params, x: torch.Tensor,
                       compute_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Pixel *logits* of shape ``[..., out_dim]``."""
    y = torch.tanh(dense_apply(p["l1"], x, compute_dtype))
    y = torch.tanh(dense_apply(p["l2"], y, compute_dtype))
    return dense_apply(p["out"], y, compute_dtype)
