"""The IWAE model family on plain parameter dicts (port of ``models/iwae.py``).

Shapes follow the JAX package: ``h[i]`` is ``[k, B, n_latent_enc[i]]`` and
log-densities reduce to ``[k, B]``. Randomness is explicit: every sampling
entry point takes a ``torch.Generator`` or the injected standard-normal noise
``eps`` (one tensor per stochastic draw, in the order the draws happen), so
tests can replay the JAX package's draws exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from iwae_replication_project_tpu_torch.models import mlp
from iwae_replication_project_tpu_torch.ops import distributions as dist

Params = Dict[str, Any]

#: hot-loop implementations a config may pin (ops/hot_loop.PATH_CODES)
HOT_LOOP_PATHS = ("kernel", "reference")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture hyperparameters (JAX ``ModelConfig`` :35-130).

    ``n_hidden_enc[i]``/``n_latent_enc[i]`` size encoder stochastic layer i;
    the decoder lists run top-down and ``n_latent_dec[-1]`` must equal
    ``x_dim``. ``likelihood`` is ``"clamp"`` (sigmoid + reference clamp) or
    ``"logits"`` (exact ``x*l - softplus(l)``). ``compute_dtype`` is None or
    ``"bfloat16"`` (matmul operands; accumulation stays fp32).
    ``fused_likelihood`` routes ``log p(x|h)`` through
    :func:`..ops.hot_loop.decoder_score` and needs ``likelihood="logits"``;
    ``hot_loop_path`` pins its implementation (``"kernel"`` |
    ``"reference"``; None = the dispatcher's choice by device). The JAX
    config's ``hot_loop_tile`` has no counterpart: the CUDA kernel's tile is
    fixed inside the kernel.
    """

    n_hidden_enc: Tuple[int, ...]
    n_latent_enc: Tuple[int, ...]
    n_hidden_dec: Tuple[int, ...]
    n_latent_dec: Tuple[int, ...]
    x_dim: int = 784
    std_floor: float = dist.STD_FLOOR
    likelihood: str = "clamp"
    compute_dtype: Optional[str] = None
    fused_likelihood: bool = False
    hot_loop_path: Optional[str] = None

    def __post_init__(self):
        L = self.n_stochastic
        if not (len(self.n_latent_enc) == L and len(self.n_hidden_dec) == L
                and len(self.n_latent_dec) == L):
            raise ValueError("encoder/decoder size lists must have equal "
                             "length")
        if self.n_latent_dec[-1] != self.x_dim:
            raise ValueError(f"n_latent_dec[-1]={self.n_latent_dec[-1]} must "
                             f"equal x_dim={self.x_dim}")
        if self.likelihood not in ("clamp", "logits"):
            raise ValueError(f"unknown likelihood {self.likelihood!r}")
        if self.compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"compute_dtype must be None or 'bfloat16', got "
                             f"{self.compute_dtype!r}")
        if self.fused_likelihood and self.likelihood != "logits":
            raise ValueError("fused_likelihood requires likelihood='logits'")
        if self.hot_loop_path is not None:
            if self.hot_loop_path not in HOT_LOOP_PATHS:
                raise ValueError(f"unknown hot_loop_path "
                                 f"{self.hot_loop_path!r}; expected one of "
                                 f"{HOT_LOOP_PATHS}")
            if not self.fused_likelihood:
                raise ValueError("hot_loop_path is a pin on the fused "
                                 "dispatcher; it requires "
                                 "fused_likelihood=True")

    @property
    def n_stochastic(self) -> int:
        return len(self.n_hidden_enc)

    @property
    def matmul_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None

    @staticmethod
    def two_layer(**kw) -> "ModelConfig":
        """The flagship architecture (experiment_example.py:48-51)."""
        defaults = dict(n_hidden_enc=(200, 100), n_latent_enc=(100, 50),
                        n_hidden_dec=(100, 200), n_latent_dec=(100, 784))
        defaults.update(kw)
        return ModelConfig(**defaults)

    @staticmethod
    def one_layer(**kw) -> "ModelConfig":
        """The 1-stochastic-layer architecture of Burda Table 1."""
        defaults = dict(n_hidden_enc=(200,), n_latent_enc=(50,),
                        n_hidden_dec=(200,), n_latent_dec=(784,))
        defaults.update(kw)
        return ModelConfig(**defaults)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                output_bias=None) -> Params:
    """The parameter tree, drawn on the host from `generator` (a CPU
    generator, so the same seed gives the same weights on every device);
    callers move it to their device. `output_bias` is the logit-of-pixel-mean
    vector of the data layer (``data.output_bias_from_pixel_means``); None
    starts the output bias at zero."""
    L = cfg.n_stochastic
    enc = []
    in_dim = cfg.x_dim
    for i in range(L):
        enc.append(mlp.stochastic_block_init(generator, in_dim,
                                             cfg.n_hidden_enc[i],
                                             cfg.n_latent_enc[i]))
        in_dim = cfg.n_latent_enc[i]
    dec = []
    in_dim = cfg.n_latent_enc[-1]
    for i in range(L - 1):
        dec.append(mlp.stochastic_block_init(generator, in_dim,
                                             cfg.n_hidden_dec[i],
                                             cfg.n_latent_dec[i]))
        in_dim = cfg.n_latent_dec[i]
    out = mlp.output_block_init(generator, in_dim, cfg.n_hidden_dec[-1],
                                cfg.x_dim, out_bias=output_bias)
    return {"enc": tuple(enc), "dec": tuple(dec), "out": out}


def to_device(tree, device: torch.device):
    """The parameter tree with every tensor moved to `device`."""
    if isinstance(tree, dict):
        return {key: to_device(v, device) for key, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device)


def _noise(eps: Optional[Sequence[torch.Tensor]], i: int):
    return None if eps is None else eps[i]


def encode(params: Params, cfg: ModelConfig, x: torch.Tensor, k: int, *,
           generator: Optional[torch.Generator] = None,
           eps: Optional[Sequence[torch.Tensor]] = None,
           stop_q_score: bool = False):
    """The inference chain q(h|x) with a k-sample fan-out at the first layer.

    Returns ``(h, log_q, q_last)``: ``h`` a tuple of ``[k, B, d_i]`` samples,
    ``log_q`` ``[k, B]`` and ``q_last`` the (mu, std) of the last
    conditional. ``eps[i]`` (shape ``[k, B, d_i]``) injects layer i's noise;
    without it the draws come from `generator` in layer order.
    `stop_q_score=True` detaches mu and std inside ``log q`` only, keeping
    the pathwise dependence through the samples: the score-term removal that
    DReG and STL need (JAX :162-190).
    """
    if eps is not None and len(eps) != cfg.n_stochastic:
        raise ValueError(f"encode needs {cfg.n_stochastic} noise tensors, "
                         f"got {len(eps)}")
    dt = cfg.matmul_dtype
    sg = (lambda t: t.detach()) if stop_q_score else (lambda t: t)
    mu, std = mlp.stochastic_block_apply(params["enc"][0], x, cfg.std_floor,
                                         dt)
    h1 = dist.normal_sample(mu, std, (k,), generator=generator,
                            eps=_noise(eps, 0))
    log_q = torch.sum(dist.normal_log_prob(h1, sg(mu), sg(std)), dim=-1)
    h = [h1]
    q_last = (mu, std)
    for i in range(1, cfg.n_stochastic):
        mu, std = mlp.stochastic_block_apply(params["enc"][i], h[-1],
                                             cfg.std_floor, dt)
        hi = dist.normal_sample(mu, std, generator=generator,
                                eps=_noise(eps, i))
        log_q = log_q + torch.sum(dist.normal_log_prob(hi, sg(mu), sg(std)),
                                  dim=-1)
        h.append(hi)
        q_last = (mu, std)
    return tuple(h), log_q, q_last


def decode_logits(params: Params, cfg: ModelConfig,
                  h1: torch.Tensor) -> torch.Tensor:
    """Pixel logits from the bottom latent, ``[k, B, x_dim]``."""
    return mlp.output_block_apply(params["out"], h1, cfg.matmul_dtype)


def decode_probs(params: Params, cfg: ModelConfig,
                 h1: torch.Tensor) -> torch.Tensor:
    """Clamped pixel probabilities."""
    return dist.clamp_probs(torch.sigmoid(decode_logits(params, cfg, h1)))


def log_px_given_h(params: Params, cfg: ModelConfig, x: torch.Tensor,
                   h1: torch.Tensor) -> torch.Tensor:
    """``log p(x|h)`` summed over pixels -> ``[k, B]``."""
    if cfg.fused_likelihood:
        # the hot-loop dispatcher: the CUDA kernel for CUDA tensors, the
        # plain composition for CPU tensors or a "reference" pin
        from iwae_replication_project_tpu_torch.ops import hot_loop
        return hot_loop.decoder_score(params["out"], x, h1,
                                      compute_dtype=cfg.matmul_dtype,
                                      force_path=cfg.hot_loop_path)
    logits = decode_logits(params, cfg, h1)
    if cfg.likelihood == "clamp":
        probs = dist.clamp_probs(torch.sigmoid(logits))
        lp = dist.bernoulli_log_prob(x, probs)
    else:
        lp = dist.bernoulli_log_prob_from_logits(x, logits)
    return torch.sum(lp, dim=-1)


def log_prior(params: Params, cfg: ModelConfig,
              h: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """``log p(h)``: standard Normal on the deepest latent plus the decoder's
    conditional chain down to h1 -> ``[k, B]``."""
    L = cfg.n_stochastic
    log_p = torch.sum(dist.standard_normal_log_prob(h[-1]), dim=-1)
    for i in range(L - 1):
        mu, std = mlp.stochastic_block_apply(params["dec"][i], h[L - 1 - i],
                                             cfg.std_floor, cfg.matmul_dtype)
        log_p = log_p + torch.sum(dist.normal_log_prob(h[L - 2 - i], mu, std),
                                  dim=-1)
    return log_p


def generate_x(params: Params, cfg: ModelConfig, h_top: torch.Tensor, *,
               generator: Optional[torch.Generator] = None,
               eps: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Ancestral sampling from the deepest latent down, returning pixel
    probabilities. ``eps[i]`` injects the noise of decoder layer i (shape of
    its mean); without it the draws come from `generator`."""
    L = cfg.n_stochastic
    if eps is not None and len(eps) != L - 1:
        raise ValueError(f"generate_x needs {L - 1} noise tensors, got "
                         f"{len(eps)}")
    h = h_top
    for i in range(L - 1):
        mu, std = mlp.stochastic_block_apply(params["dec"][i], h,
                                             cfg.std_floor, cfg.matmul_dtype)
        h = dist.normal_sample(mu, std, generator=generator,
                               eps=_noise(eps, i))
    return decode_probs(params, cfg, h)


def log_weights_and_aux(params: Params, cfg: ModelConfig, x: torch.Tensor,
                        k: int, *,
                        generator: Optional[torch.Generator] = None,
                        eps: Optional[Sequence[torch.Tensor]] = None,
                        stop_q_score: bool = False):
    """One encoder+decoder pass -> ``[k, B]`` log importance weights plus the
    intermediates: ``log w = (log p(h) + log p(x|h)) - log q(h|x)``."""
    h, log_q, q_last = encode(params, cfg, x, k, generator=generator,
                              eps=eps, stop_q_score=stop_q_score)
    log_pxh_cond = log_px_given_h(params, cfg, x, h[0])
    log_ph = log_prior(params, cfg, h)
    log_w = log_ph + log_pxh_cond - log_q
    aux = {"h": h, "log_q": log_q, "log_px_given_h": log_pxh_cond,
           "log_prior": log_ph, "q_last": q_last}
    return log_w, aux


def log_weights(params: Params, cfg: ModelConfig, x: torch.Tensor, k: int, *,
                generator: Optional[torch.Generator] = None,
                eps: Optional[Sequence[torch.Tensor]] = None,
                stop_q_score: bool = False) -> torch.Tensor:
    return log_weights_and_aux(params, cfg, x, k, generator=generator,
                               eps=eps, stop_q_score=stop_q_score)[0]
