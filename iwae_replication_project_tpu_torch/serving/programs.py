"""The serving programs: batched, yet row-independent (port of
``serving/programs.py``).

A micro-batching engine pads ragged request batches to shape buckets, so a
row's result must not depend on which batch it rides in, on its neighbours or
on the padding. The JAX package gets that from ``vmap`` over a per-row key
``fold_in(base_key, seed)``; here each request row gets its own
``torch.Generator``, seeded only by (engine seed, request seed) through
:func:`row_seed`, and draws its noise in a fixed per-layer order. The noise
is drawn on the host (CPU generators give the same numbers whatever device
then computes) and handed to the batched model functions as injected noise,
so the whole bucket then runs as one batched pass on the device.

All three ops share ``(params, cfg, base_seed, seeds[B], payload[B, d], ...)``
and take optional injected ``noise`` (the tests replay the JAX package's
per-row draws through it):

* score/encode noise: one ``[k, B, n_latent_enc[i]]`` tensor per encoder layer;
* decode noise: one ``[B, n_latent_dec[i]]`` tensor per decoder layer above
  the output block.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives.estimators import (
    iwae_per_example,
)

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def row_seed(base_seed: int, seed: int) -> int:
    """The seed of one request's generator: a pure function of the engine
    seed and the request seed (splitmix64 mixing, 63 bits)."""
    return _splitmix64(_splitmix64(int(base_seed)) ^ int(seed)) >> 1


def noise_shapes(cfg: model.ModelConfig, op: str, k: int = 0) -> List[tuple]:
    """Per-row shapes of `op`'s draws, in draw order."""
    if op in ("score", "encode"):
        return [(k, d) for d in cfg.n_latent_enc]
    if op == "decode":
        return [(d,) for d in cfg.n_latent_dec[:-1]]
    raise ValueError(f"unknown op {op!r}")


def draw_noise(cfg: model.ModelConfig, op: str, base_seed: int,
               seeds: Sequence[int], k: int = 0) -> List[torch.Tensor]:
    """The batch's standard-normal noise, on the host: row b's generator is
    seeded with ``row_seed(base_seed, seeds[b])`` and draws each layer in
    order. score/encode tensors are ``[k, B, d]``, decode ``[B, d]``."""
    shapes = noise_shapes(cfg, op, k)
    per_layer: List[List[torch.Tensor]] = [[] for _ in shapes]
    for seed in seeds:
        g = torch.Generator().manual_seed(row_seed(base_seed, seed))
        for i, shape in enumerate(shapes):
            per_layer[i].append(torch.randn(shape, generator=g))
    dim = 1 if op in ("score", "encode") else 0
    return [torch.stack(rows, dim=dim) for rows in per_layer]


def _noise_on(noise, device):
    return [n.to(device, non_blocking=True) for n in noise]


@torch.inference_mode()
def score_rows(params, cfg: model.ModelConfig, base_seed: int,
               seeds: Sequence[int], x: torch.Tensor, k: int, *,
               noise: Optional[Sequence[torch.Tensor]] = None
               ) -> torch.Tensor:
    """Per-request k-sample IWAE log-likelihood estimate ``[B]``:
    ``log p(x_i) ~= logmeanexp_k(log w)``."""
    if noise is None:
        noise = draw_noise(cfg, "score", base_seed, seeds, k)
    log_w = model.log_weights(params, cfg, x, k,
                              eps=_noise_on(noise, x.device))   # [k, B]
    return iwae_per_example(log_w)


@torch.inference_mode()
def encode_rows(params, cfg: model.ModelConfig, base_seed: int,
                seeds: Sequence[int], x: torch.Tensor, k: int, *,
                noise: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """Posterior representation per request: the k-sample mean of the
    deepest latent ``[B, n_latent_enc[-1]]``."""
    if noise is None:
        noise = draw_noise(cfg, "encode", base_seed, seeds, k)
    h, _, _ = model.encode(params, cfg, x, k, eps=_noise_on(noise, x.device))
    return torch.mean(h[-1], dim=0)


@torch.inference_mode()
def decode_rows(params, cfg: model.ModelConfig, base_seed: int,
                seeds: Sequence[int], h_top: torch.Tensor, *,
                noise: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """Ancestral decode of deepest-latent rows -> pixel probabilities
    ``[B, x_dim]``."""
    if noise is None:
        noise = draw_noise(cfg, "decode", base_seed, seeds)
    eps = [n[None] for n in _noise_on(noise, h_top.device)]     # [1, B, d]
    return model.generate_x(params, cfg, h_top[None], eps=eps)[0]


#: op name -> (program, takes k?)
PROGRAMS = {
    "score": (score_rows, True),
    "encode": (encode_rows, True),
    "decode": (decode_rows, False),
}
