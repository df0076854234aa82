"""The plain fp32 reference of the IWAE model: forward pass, bound,
gradients, Adam step and the streamed k-sample log-likelihood.

A frozen, independent statement of Burda et al. 2015 (arXiv:1509.00519) as
the port computes it at commit 3ec051a (``models/iwae.py``, ``mlp.py``,
``ops/distributions.py``, ``objectives/estimators.py``,
``training/train_step.py``, ``ops/logsumexp.py``): Gaussian stochastic
blocks of two tanh layers and a mean and log-std head (std = exp + 1e-6),
a decoder output block of two tanh layers and a logit layer, the Bernoulli
log-likelihood from logits (``x*l - softplus(l)``), the k-sample IWAE
bound, and Adam with eps 1e-4 ascending it. It is written from those
equations with plain ``torch`` operations and autograd; it imports nothing
of the port and nothing of JAX.

Weights are a flat ``{name: tensor}`` dict (``harness/weights.LAYOUT``
names), widths a :class:`Widths`. Every matrix product goes through
``q``, which rounds both operands: :func:`exact` (fp32; the caller turns
TF32 off) for the reference, :func:`fp8` for the control, one precision
below the configuration's bf16 operands.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

STD_FLOOR = 1e-6
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

#: an operand rounding: tensor -> tensor of the same dtype
Rounding = Callable[[torch.Tensor], torch.Tensor]


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, the format's largest value, and back. The
    rounding passes gradients through unchanged, so a product's backward
    multiplies by the rounded operands and the gradients stay fp32."""
    d = t.detach()
    scale = 448.0 / d.abs().amax().clamp_min(1e-12)
    rounded = (d * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (rounded - d)


def no_tf32() -> None:
    """fp32 products in fp32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Widths:
    """``enc[i] = (hidden, latent)`` of encoder stochastic layer i,
    ``dec[i]`` of decoder layer i (top-down), ``out_hidden`` the output
    block's width, ``x_dim`` the pixels."""

    enc: Tuple[Tuple[int, int], ...]
    dec: Tuple[Tuple[int, int], ...]
    out_hidden: int
    x_dim: int = 784

    @staticmethod
    def from_config(c: dict) -> "Widths":
        he, le = c["n_hidden_encoder"], c["n_latent_encoder"]
        hd, ld = c["n_hidden_decoder"], c["n_latent_decoder"]
        return Widths(enc=tuple(zip(he, le)),
                      dec=tuple(zip(hd[:-1], ld[:-1])),
                      out_hidden=hd[-1], x_dim=c.get("x_dim", 784))

    @property
    def layers(self) -> int:
        return len(self.enc)


def _dense(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor,
           q: Rounding) -> torch.Tensor:
    return q(x) @ q(w[name + ".w"]) + w[name + ".b"]


def _gaussian(w, name: str, x: torch.Tensor, q: Rounding):
    y = torch.tanh(_dense(w, name + ".l1", x, q))
    y = torch.tanh(_dense(w, name + ".l2", y, q))
    return _dense(w, name + ".mu", y, q), \
        torch.exp(_dense(w, name + ".lstd", y, q)) + STD_FLOOR


def _normal_lp(h, mu, std):
    z = (h - mu) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - _HALF_LOG_2PI, dim=-1)


def log_weights(w: Dict[str, torch.Tensor], widths: Widths, x: torch.Tensor,
                eps: Sequence[torch.Tensor], q: Rounding = exact
                ) -> torch.Tensor:
    """``[k, B]`` log importance weights ``log p(h) + log p(x|h) - log
    q(h|x)`` of the rows `x` ``[B, x_dim]`` with the standard-normal draws
    `eps` (``[k, B, latent_i]`` per encoder layer, in layer order)."""
    L = widths.layers
    mu, std = _gaussian(w, "enc0", x, q)
    h = [mu + std * eps[0]]
    log_q = _normal_lp(h[0], mu, std)
    for i in range(1, L):
        mu, std = _gaussian(w, f"enc{i}", h[-1], q)
        h.append(mu + std * eps[i])
        log_q = log_q + _normal_lp(h[-1], mu, std)
    log_p = torch.sum(-0.5 * h[-1] * h[-1] - _HALF_LOG_2PI, dim=-1)
    for i in range(L - 1):
        mu, std = _gaussian(w, f"dec{i}", h[L - 1 - i], q)
        log_p = log_p + _normal_lp(h[L - 2 - i], mu, std)
    y = torch.tanh(_dense(w, "out.l1", h[0], q))
    y = torch.tanh(_dense(w, "out.l2", y, q))
    logits = _dense(w, "out.out", y, q)
    softplus = torch.clamp_min(logits, 0.0) \
        + torch.log1p(torch.exp(-torch.abs(logits)))
    log_px = torch.sum(x * logits - softplus, dim=-1)
    return log_p + log_px - log_q


def log_mean_exp(lw: torch.Tensor, dim: int = 0) -> torch.Tensor:
    m = torch.amax(lw, dim=dim, keepdim=True).detach()
    return torch.log(torch.sum(torch.exp(lw - m), dim=dim)) + m.squeeze(dim) \
        - math.log(lw.shape[dim])


def iwae_bound(lw: torch.Tensor) -> torch.Tensor:
    """The k-sample bound averaged over the batch."""
    return torch.mean(log_mean_exp(lw, 0))


@dataclasses.dataclass
class AdamState:
    """Adam (Kingma and Ba) of the reference: betas, eps, learning rate and
    the moments of each leaf."""

    lr: float
    betas: Tuple[float, float]
    eps: float
    m: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    v: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    t: int = 0

    def step(self, w: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for name, g in grads.items():
            m = self.m.get(name, torch.zeros_like(g)) * b1 + (1.0 - b1) * g
            v = self.v.get(name, torch.zeros_like(g)) * b2 \
                + (1.0 - b2) * g * g
            self.m[name], self.v[name] = m, v
            w[name] = w[name] - (self.lr / c1) * m \
                / (torch.sqrt(v) / math.sqrt(c2) + self.eps)


@dataclasses.dataclass
class TrainTrace:
    """What the reference's steps give: each step's loss (the negated
    bound), each leaf's gradient of the first step as Adam gets it (of the
    loss), and the weights after the last step."""

    losses: List[float]
    first_grads: Dict[str, torch.Tensor]
    weights: Dict[str, torch.Tensor]


def train_steps(w0: Dict[str, torch.Tensor], widths: Widths,
                steps: Iterable[Tuple[torch.Tensor, Sequence[torch.Tensor]]],
                *, lr: float, betas: Tuple[float, float], eps: float,
                q: Rounding = exact, rows: int = 0) -> TrainTrace:
    """Adam steps that ascend the IWAE bound from the weights `w0`
    (copied), one per ``(batch, draws)`` of `steps`. `rows` > 0 keeps only
    the first `rows` rows of each batch and their draws (the half-batch
    fault)."""
    w = {n: t.detach().clone() for n, t in w0.items()}
    adam = AdamState(lr=lr, betas=betas, eps=eps)
    losses, first = [], None
    for x, eps_i in steps:
        if rows:
            x = x[:rows]
            eps_i = [e[:, :rows] for e in eps_i]
        leaves = {n: t.detach().requires_grad_(True) for n, t in w.items()}
        bound = iwae_bound(log_weights(leaves, widths, x, eps_i, q))
        names = list(leaves)
        got = torch.autograd.grad(-bound, [leaves[n] for n in names])
        grads = dict(zip(names, got))
        losses.append(-bound.detach())
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        with torch.no_grad():
            adam.step(w, grads)
    return TrainTrace(losses=torch.stack(losses).tolist(), first_grads=first,
                      weights=w)


@torch.no_grad()
def streamed_log_px(w: Dict[str, torch.Tensor], widths: Widths,
                    x: torch.Tensor,
                    chunks: Sequence[Callable[[], Sequence[torch.Tensor]]],
                    q: Rounding = exact) -> torch.Tensor:
    """``[B]`` log-mean-exp over all samples of the chunks: chunk ``j``'s
    draws come from ``chunks[j]()``, folded into a running max and a
    rescaled sum so that memory stays one chunk's."""
    m = torch.full((x.shape[0],), -math.inf, device=x.device)
    s = torch.zeros((x.shape[0],), device=x.device)
    n = 0
    for draw in chunks:
        lw = log_weights(w, widths, x, draw(), q)
        new_m = torch.maximum(m, torch.amax(lw, dim=0))
        s = s * torch.exp(m - new_m) + torch.sum(torch.exp(lw - new_m), 0)
        m = new_m
        n += lw.shape[0]
    return torch.log(s) + m - math.log(n)
