"""The eager oracle behind ``backend="torch"`` (port of
``backends/torch_ref.py``).

An independent implementation of the facade's semantics: per-op autograd,
dynamic dispatch, no fusion and no hand kernel, with the reference's
parity constants (probability clamp ``p*(1-1e-6)+1e-7``, std floor 1e-6,
flexible_IWAE.py:75,102) and Adam with eps 1e-4. It imports nothing of the
port's ``ops/``, ``models/``, ``objectives/`` or ``training/``, so a bug in
the core (a kernel, a hand-rolled cotangent) cannot hide in both sides of
a comparison; the eleven objectives are written here again, and DReG, STL
and PIWAE are autograd of surrogate scalars (Roeder et al. 2017; Tucker et
al. 2018; Rainforth et al. 2018) where the core writes explicit
cotangents.

The port's idiom over JAX's oracle: an explicit ``device=`` (None: the
card; on the card the oracle is the same eager arithmetic, which is what
makes it a check of the kernels there) and an explicit ``torch.Generator``
on that device for the weights' initialization and every draw, where the
JAX oracle seeds and draws from torch's global generator. ``h_fixed``
replays given latents through the reparameterization, so gradients can be
held against another implementation draw for draw.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from iwae_replication_project_tpu_torch.api import (
    FlexibleModel,
    assemble_tree,
)
from iwae_replication_project_tpu_torch.utils.device import resolve_device
from iwae_replication_project_tpu_torch.utils.sizes import largest_divisor_leq

_PCLAMP_SCALE = 1.0 - 1e-6
_PCLAMP_SHIFT = 1e-7
_STD_FLOOR = 1e-6
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


class _Linear(torch.nn.Module):
    """``x @ weight.T + bias`` with torch's ``[out, in]`` weight, initialized
    as ``torch.nn.Linear`` is (uniform in +-1/sqrt(in)) from an explicit
    generator."""

    def __init__(self, in_dim: int, out_dim: int, gen: torch.Generator,
                 device: torch.device):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)

        def uniform(*shape):
            u = torch.rand(shape, generator=gen, device=device)
            return torch.nn.Parameter(u * (2 * bound) - bound)

        self.weight = uniform(out_dim, in_dim)
        self.bias = uniform(out_dim)

    def forward(self, x):
        return torch.nn.functional.linear(x, self.weight, self.bias)


class _StochasticBlock(torch.nn.Module):
    def __init__(self, in_dim: int, hidden: int, latent: int, gen, device):
        super().__init__()
        self.l1 = _Linear(in_dim, hidden, gen, device)
        self.l2 = _Linear(hidden, hidden, gen, device)
        self.mu = _Linear(hidden, latent, gen, device)
        self.lstd = _Linear(hidden, latent, gen, device)

    def forward(self, x):
        y = torch.tanh(self.l1(x))
        y = torch.tanh(self.l2(y))
        return self.mu(y), torch.exp(self.lstd(y)) + _STD_FLOOR


def _normal_log_prob(x, mu, std):
    z = (x - mu) / std
    return -0.5 * z * z - torch.log(std) - _HALF_LOG_2PI


class TorchFlexibleModel(FlexibleModel):
    def __init__(self, *args, mesh=None, mesh_sp: int = 1, compute_dtype=None,
                 likelihood: str = "clamp", device=None, **kwargs):
        # accept (and ignore) the core's execution knobs so callers can flip
        # backend= without changing anything else; unknown kwargs raise
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(self.seed)
        gen, dev = self._gen, self.device
        L = len(self.n_hidden_encoder)
        self.L = L
        enc, in_dim = [], self.n_latent_decoder[-1]
        for i in range(L):
            enc.append(_StochasticBlock(in_dim, self.n_hidden_encoder[i],
                                        self.n_latent_encoder[i], gen, dev))
            in_dim = self.n_latent_encoder[i]
        self.enc = torch.nn.ModuleList(enc)
        dec, in_dim = [], self.n_latent_encoder[-1]
        for i in range(L - 1):
            dec.append(_StochasticBlock(in_dim, self.n_hidden_decoder[i],
                                        self.n_latent_decoder[i], gen, dev))
            in_dim = self.n_latent_decoder[i]
        self.dec = torch.nn.ModuleList(dec)
        hid, out_dim = self.n_hidden_decoder[-1], self.n_latent_decoder[-1]
        self.out = torch.nn.Sequential(
            _Linear(in_dim, hid, gen, dev), torch.nn.Tanh(),
            _Linear(hid, hid, gen, dev), torch.nn.Tanh(),
            _Linear(hid, out_dim, gen, dev))
        if self._output_bias is not None:
            with torch.no_grad():
                self.out[-1].bias.copy_(torch.as_tensor(
                    np.asarray(self._output_bias, np.float32), device=dev))
        self.optimizer: Optional[torch.optim.Optimizer] = None

    # ------------------------------------------------------------------

    def compile(self, optimizer=None, learning_rate: float = 1e-3):
        params = list(self.enc.parameters()) + list(self.dec.parameters()) \
            + list(self.out.parameters())
        self.optimizer = optimizer or torch.optim.Adam(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-4)
        return self

    def set_learning_rate(self, lr: float):
        for g in self.optimizer.param_groups:
            g["lr"] = lr

    def _randn(self, shape):
        return torch.randn(shape, generator=self._gen, device=self.device)

    def _encode(self, x, k: int, stop_q_score: bool = False, h_fixed=None,
                masks=None):
        """Encoder pass. `stop_q_score` detaches the density parameters inside
        log q while keeping the pathwise sample dependence (the score-term
        removal of STL/DReG). `h_fixed` replays given latent values through
        the reparameterization (eps recovered with detached moments).
        `masks` zeroes inactive latent coords after sampling, densities
        evaluated at the masked values (flexible_IWAE.py:466-494)."""
        sg = (lambda t: t.detach()) if stop_q_score else (lambda t: t)

        def draw(mu, std, i, shape):
            if h_fixed is None:
                return mu + std * self._randn(shape)
            given = self._as_tensor(h_fixed[i])
            if tuple(given.shape) != tuple(shape):
                raise ValueError(
                    f"h_fixed[{i}] has shape {tuple(given.shape)}, expected "
                    f"{tuple(shape)} — k / latent sizes of the replayed draws "
                    f"must match this model")
            eps = ((given - mu) / std).detach()
            return mu + std * eps

        mu, std = self.enc[0](x)
        h1 = draw(mu, std, 0, (k,) + tuple(mu.shape))
        if masks is not None:
            h1 = h1 * masks[0]
        log_q = _normal_log_prob(h1, sg(mu), sg(std)).sum(-1)
        h = [h1]
        q_last = (mu, std)
        for i in range(1, self.L):
            mu, std = self.enc[i](h[-1])
            hi = draw(mu, std, i, tuple(mu.shape))
            if masks is not None:
                hi = hi * masks[i]
            log_q = log_q + _normal_log_prob(hi, sg(mu), sg(std)).sum(-1)
            h.append(hi)
            q_last = (mu, std)
        return h, log_q, q_last

    def _decode_probs(self, h1):
        probs = torch.sigmoid(self.out(h1))
        return probs * _PCLAMP_SCALE + _PCLAMP_SHIFT

    def _log_weights_aux(self, x, k: int, stop_q_score: bool = False,
                         h_fixed=None, masks=None):
        h, log_q, q_last = self._encode(x, k, stop_q_score=stop_q_score,
                                        h_fixed=h_fixed, masks=masks)
        probs = self._decode_probs(h[0])
        log_pxIh = (x * torch.log(probs)
                    + (1 - x) * torch.log1p(-probs)).sum(-1)
        log_ph = (-0.5 * h[-1] ** 2 - _HALF_LOG_2PI).sum(-1)
        for i in range(self.L - 1):
            mu, std = self.dec[i](h[self.L - 1 - i])
            log_ph = log_ph + _normal_log_prob(h[self.L - 2 - i], mu,
                                               std).sum(-1)
        return log_ph + log_pxIh - log_q, {"log_px_given_h": log_pxIh,
                                           "q_last": q_last, "h": h}

    def get_log_weights(self, x, n_samples: int):
        return self._log_weights_aux(self._flatten(x), n_samples)[0]

    @staticmethod
    def _iwae(log_w):
        m = log_w.max(dim=0, keepdim=True).values.detach()
        return (torch.log(torch.exp(log_w - m).mean(0)) + m[0]).mean()

    @staticmethod
    def _miwae(log_w, k2: int):
        """Mean of k2 independent IWAE(k//k2) bounds, group-major reshape."""
        g = log_w.reshape(k2, log_w.shape[0] // k2, *log_w.shape[1:])
        m = g.max(dim=1, keepdim=True).values.detach()
        return (torch.log(torch.exp(g - m).mean(1)) + m[:, 0]).mean()

    def _bound(self, name, x, k, h_fixed=None, **over):
        x = self._flatten(x)
        log_w, aux = self._log_weights_aux(x, k, h_fixed=h_fixed)
        if name == "VAE":
            return log_w.mean()
        if name == "IWAE":
            return self._iwae(log_w)
        if name == "L_power_p":
            p = over.get("p", self.p)
            return self._iwae(p * log_w) / p
        if name == "L_median":
            return log_w.median(dim=0).values.mean()
        if name == "CIWAE":
            b = over.get("beta", self.beta)
            return b * log_w.mean() + (1 - b) * self._iwae(log_w)
        if name == "L_alpha":
            a = over.get("alpha", self.alpha)
            return (1 - a) * aux["log_px_given_h"].mean() + a * log_w.mean()
        if name == "MIWAE":
            return self._miwae(log_w, over.get("k2", self.k2))
        if name == "VAE_V1":
            if len(self.enc) > 1:
                raise ValueError(
                    "VAE_V1's analytic KL is defined for single-stochastic-"
                    "layer models only (flexible_IWAE.py:433); this model "
                    f"has {len(self.enc)} stochastic layers")
            mu, std = aux["q_last"]
            kl = (-0.5 * (1 + 2 * torch.log(std) - mu ** 2 - std ** 2)
                  ).sum(-1).mean()
            return aux["log_px_given_h"].mean() - kl
        raise NotImplementedError(
            f"objective {name!r} is not implemented in the torch oracle")

    # ------------------------------------------------------------------
    # gradients: DReG / STL / PIWAE as surrogate scalars, every other
    # objective as autograd of its bound
    # ------------------------------------------------------------------

    def _param_groups(self):
        enc = list(self.enc.parameters())
        rest = list(self.dec.parameters()) + list(self.out.parameters())
        return enc, rest

    def _estimator_value_and_grads(self, x, name: str, k: int, k2: int = 1,
                                   h_fixed=None):
        """``(bound, {param: grad})``.

        * STL: autograd of the IWAE bound on the score-stopped graph —
          surrogate sum_i sg(w~_i) log w_i / B.
        * DReG: encoder surrogate uses sg(w~_i^2), decoder sg(w~_i), both on
          the score-stopped graph.
        * PIWAE: decoder from the full-k IWAE bound, encoder from the
          MIWAE(k1, k2) bound, one shared (standard, score-carrying) graph.
        * any other objective: autograd of its bound (with ``k2`` for
          MIWAE).
        """
        x = self._flatten(x)
        enc_p, rest_p = self._param_groups()
        grads: Dict = {}
        if name in ("DReG", "STL"):
            log_w, _ = self._log_weights_aux(x, k, stop_q_score=True,
                                             h_fixed=h_fixed)
            B = log_w.shape[1]
            w = torch.softmax(log_w, dim=0).detach()
            bound = self._iwae(log_w).detach()
            s_dec = (w * log_w).sum() / B
            if name == "STL":
                g = torch.autograd.grad(s_dec, enc_p + rest_p)
                grads.update(zip(enc_p + rest_p, g))
            else:
                s_enc = (w.pow(2) * log_w).sum() / B
                g_enc = torch.autograd.grad(s_enc, enc_p, retain_graph=True)
                g_dec = torch.autograd.grad(s_dec, rest_p)
                grads.update(zip(enc_p, g_enc))
                grads.update(zip(rest_p, g_dec))
        elif name == "PIWAE":
            log_w, _ = self._log_weights_aux(x, k, h_fixed=h_fixed)
            bound = self._iwae(log_w)
            g_dec = torch.autograd.grad(bound, rest_p, retain_graph=True)
            g_enc = torch.autograd.grad(self._miwae(log_w, k2), enc_p)
            grads.update(zip(enc_p, g_enc))
            grads.update(zip(rest_p, g_dec))
            bound = bound.detach()
        else:
            bound = self._bound(name, x, k, h_fixed=h_fixed, k2=k2)
            g = torch.autograd.grad(bound, enc_p + rest_p, allow_unused=True)
            grads.update((p, torch.zeros_like(p) if gi is None else gi)
                         for p, gi in zip(enc_p + rest_p, g))
            bound = bound.detach()
        return bound, grads

    def _iter_linear_tree(self):
        """Yield ``(_Linear, tree path)`` pairs: the one definition of the
        module <-> ``models/iwae.init_params`` tree correspondence (the
        weights' load and export, and the gradient export)."""
        for group, blocks in (("enc", self.enc), ("dec", self.dec)):
            for i, blk in enumerate(blocks):
                for nm in ("l1", "l2", "mu", "lstd"):
                    yield getattr(blk, nm), (group, i, nm)
        for idx, nm in ((0, "l1"), (2, "l2"), (4, "out")):
            yield self.out[idx], ("out", nm)

    def estimator_gradients_as_jax_tree(self, x, name: str, k: int,
                                        k2: int = 1, h_fixed=None):
        """``(bound, grad tree)`` in the ``models/iwae.init_params`` layout,
        the JAX package's and the port's (``w`` transposed back to
        ``[in, out]``), as host arrays: the cross-implementation gradient
        hook. `h_fixed` should be the latents of the other side's forward
        (its ``aux["h"]``) so both differentiate the same realized draws."""
        bound, grads = self._estimator_value_and_grads(x, name, k, k2=k2,
                                                       h_fixed=h_fixed)
        return float(bound), self._tree(
            lambda lin: {"w": grads[lin.weight].detach().T.cpu().numpy(),
                         "b": grads[lin.bias].detach().cpu().numpy()})

    def _tree(self, leaf_fn):
        """The ``init_params`` tree of one ``{"w", "b"}`` leaf per linear
        layer (``w`` already ``[in, out]`` from `leaf_fn`)."""
        return assemble_tree((path, leaf_fn(lin))
                             for lin, path in self._iter_linear_tree())

    def _weights_tree(self):
        return self._tree(lambda lin: {"w": lin.weight.detach().T,
                                       "b": lin.bias.detach()})

    def _set_weights_tree(self, leaves: list) -> None:
        from iwae_replication_project_tpu_torch.utils.tree import (
            tree_unflatten)
        self.load_jax_params(tree_unflatten(self._weights_tree(), leaves))

    def load_jax_params(self, params) -> "TorchFlexibleModel":
        """Copy a parameter tree in the ``models/iwae.init_params`` layout
        (the JAX package's or the port's: kernels ``[in, out]``, tensors or
        arrays) into this oracle, for weight-tied comparisons."""
        for linear, path in self._iter_linear_tree():
            d = params
            for key in path:
                d = d[key]
            with torch.no_grad():
                linear.weight.copy_(self._as_tensor(d["w"]).T)
                linear.bias.copy_(self._as_tensor(d["b"]))
        return self

    def _as_tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.detach().to(self.device, torch.float32)
        return torch.as_tensor(np.array(a, np.float32), device=self.device)

    def _eval_bound(self, name, x, k, **over):
        """The public bound getters are evaluation: no autograd graph."""
        with torch.no_grad():
            return self._bound(name, x, k, **over)

    def get_L(self, x, k: int = 5000):
        return self._eval_bound("VAE", x, k)

    def get_L_k(self, x, k: int):
        return self._eval_bound("IWAE", x, k)

    def get_L_V1(self, x, n_samples: int):
        return self._eval_bound("VAE_V1", x, n_samples)

    def get_L_alpha(self, x, n_samples: int, alpha: float):
        return self._eval_bound("L_alpha", x, n_samples, alpha=alpha)

    def get_L_power_p(self, x, k: int, p: float):
        return self._eval_bound("L_power_p", x, k, p=p)

    def get_L_median(self, x, k: int):
        return self._eval_bound("L_median", x, k)

    def get_L_CIWAE(self, x, n_samples: int, beta: float):
        return self._eval_bound("CIWAE", x, n_samples, beta=beta)

    def get_L_MIWAE(self, x, k1: int, k2: int):
        return self._eval_bound("MIWAE", x, k1 * k2, k2=k2)

    def train_step(self, x) -> Dict[str, float]:
        if self.optimizer is None:
            raise RuntimeError("call .compile() first")
        if self.loss_function in ("DReG", "STL", "PIWAE"):
            bound, grads = self._estimator_value_and_grads(
                x, self.loss_function, self.k, k2=self.k2)
            self.optimizer.zero_grad()
            for p, g in grads.items():
                p.grad = -g  # ascend the bound
            self.optimizer.step()
            self.epoch += 1
            return {self.loss_function: float(-bound)}
        loss = -self._bound(self.loss_function, x, self.k)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        self.epoch += 1
        return {self.loss_function: float(loss.detach())}

    # ------------------------------------------------------------------
    # evaluation (flexible_IWAE.py:249-302, 466-526)
    # ------------------------------------------------------------------

    def _generate_from_top(self, h_top):
        """Ancestral sampling from the deepest latent
        (flexible_IWAE.py:107-118)."""
        h = h_top
        for i in range(self.L - 1):
            mu, std = self.dec[i](h)
            h = mu + std * self._randn(mu.shape)
        return self._decode_probs(h)

    def reconstructed_x_probs(self, x):
        """1-sample encode + ancestral decode (flexible_IWAE.py:249-254)."""
        with torch.no_grad():
            h, _, _ = self._encode(self._flatten(x), 1)
            return self._generate_from_top(h[-1])

    def generate(self, n: int):
        """Prior samples -> pixel probs ``[n, x_dim]``."""
        with torch.no_grad():
            h_top = self._randn((1, n, self.n_latent_encoder[-1]))
            return self._generate_from_top(h_top)[0]

    def get_reconstruction_loss(self, x):
        """Pixel BCE of the reconstruction (flexible_IWAE.py:256-262)."""
        x = self._flatten(x)
        with torch.no_grad():
            probs = self.reconstructed_x_probs(x)
            lp = (x * torch.log(probs)
                  + (1 - x) * torch.log1p(-probs)).sum(-1)
            return -lp.mean()

    def get_E_qhIx_log_pxIh(self, x, n_samples: int):
        with torch.no_grad():
            _, aux = self._log_weights_aux(self._flatten(x), n_samples)
            return aux["log_px_given_h"].mean()

    def get_Dkl_qhIx_ph(self, x, k: int):
        """E_q[log p(x|h)] - L, one pass (flexible_IWAE.py:414-415)."""
        with torch.no_grad():
            lw, aux = self._log_weights_aux(self._flatten(x), k)
            return aux["log_px_given_h"].mean() - lw.mean()

    def get_Dkl_qhIx_phIx(self, x, k: int):
        """L_5000 - L (flexible_IWAE.py:411-412)."""
        with torch.no_grad():
            return -(self._bound("VAE", x, k) + self.get_NLL(x))

    def get_levels_of_units_activity(self, x, n_samples: int,
                                     chunk: int = 10):
        """MC posterior means -> per-unit variances + PCA eigenvalues
        (flexible_IWAE.py:264-291), chunked like the reference's passes."""
        x = self._flatten(x)
        with torch.no_grad():
            sums = [torch.zeros(x.shape[0], d, device=self.device)
                    for d in self.n_latent_encoder]
            done = 0
            while done < n_samples:
                c = min(chunk, n_samples - done)
                h, _, _ = self._encode(x, c)
                for j, hj in enumerate(h):
                    sums[j] += hj.sum(0)
                done += c
            means = [s / n_samples for s in sums]
            variances = [m.var(dim=0, unbiased=False) for m in means]
            eig = [self.get_eigenvalues_PCA(m) for m in means]
            return variances, eig

    def get_eigenvalues_PCA(self, data):
        data = self._as_tensor(data)
        centered = data - data.mean(0)
        cov = centered.T @ centered / data.shape[0]
        return torch.linalg.eigvalsh(cov)

    def get_active_units(self, variances, eigen_values,
                         threshold: float = 0.01):
        masks = [(v > threshold).float() for v in variances]
        n_active = [int(m.sum()) for m in masks]
        n_pca = [int((e > threshold).sum()) for e in eigen_values]
        return masks, n_active, n_pca

    def _streamed_nll(self, x, n_samples: int, chunk: int, masks=None):
        """-mean log mean_k w over `n_samples` draws in chunks (an online
        logsumexp in O(chunk) memory)."""
        with torch.no_grad():
            m = torch.full((x.shape[0],), -float("inf"), device=self.device)
            s = torch.zeros(x.shape[0], device=self.device)
            for _ in range(n_samples // chunk):
                lw = self._log_weights_aux(x, chunk, masks=masks)[0]
                cm = torch.maximum(m, lw.max(0).values)
                s = s * torch.exp(m - cm) + torch.exp(lw - cm).sum(0)
                m = cm
            return -(torch.log(s / n_samples) + m).mean()

    def get_NLL_without_inactive_units(self, x, threshold: float = 0.01,
                                       n_samples: int = 5000,
                                       activity_samples: int = 1000,
                                       chunk: int = 250):
        x = self._flatten(x)
        variances, eig = self.get_levels_of_units_activity(x,
                                                           activity_samples)
        masks, _, _ = self.get_active_units(variances, eig, threshold)
        return self._streamed_nll(x, n_samples,
                                  largest_divisor_leq(n_samples, chunk),
                                  masks=masks)

    def get_NLL(self, x, k: int = 5000, chunk: int = 250):
        """Streaming large-k NLL; a chunk that does not divide k is clamped
        to the largest divisor, as on the core."""
        return self._streamed_nll(self._flatten(x), k,
                                  largest_divisor_leq(k, chunk))

    def get_training_statistics(self, x, k: int, batch_size: int = 100,
                                nll_k: int = 5000, nll_chunk: int = 250,
                                activity_samples: int = 1000,
                                activity_threshold: float = 0.01,
                                include_pruned_nll: bool = True):
        """The evaluation suite, the core's schema
        (flexible_IWAE.py:496-526). One log-weights pass feeds the
        per-batch scalars."""
        x = self._flatten(x)
        n = x.shape[0]
        batch_size = largest_divisor_leq(n, batch_size)
        nll_chunk = largest_divisor_leq(nll_k, nll_chunk)
        n_batches = n // batch_size

        acc = {"VAE": 0.0, "IWAE": 0.0, "NLL": 0.0,
               "E_q(h|x)[log(p(x|h))]": 0.0, "D_kl(q(h|x),p(h))": 0.0,
               "D_kl(q(h|x),p(h|x))": 0.0, "reconstruction_loss": 0.0,
               "nll_chunk": float(nll_chunk),
               "eval_batch": float(batch_size)}
        with torch.no_grad():
            for i in range(n_batches):
                xb = x[i * batch_size:(i + 1) * batch_size]
                lw, aux = self._log_weights_aux(xb, k)
                vae = float(lw.mean())
                recon_term = float(aux["log_px_given_h"].mean())
                nll = float(self.get_NLL(xb, k=nll_k, chunk=nll_chunk))
                acc["VAE"] += vae / n_batches
                acc["IWAE"] += float(self._iwae(lw)) / n_batches
                acc["NLL"] += nll / n_batches
                acc["E_q(h|x)[log(p(x|h))]"] += recon_term / n_batches
                acc["D_kl(q(h|x),p(h))"] += (recon_term - vae) / n_batches
                acc["D_kl(q(h|x),p(h|x))"] += (-nll - vae) / n_batches
                acc["reconstruction_loss"] += float(
                    self.get_reconstruction_loss(xb)) / n_batches

        variances, eig = self.get_levels_of_units_activity(x,
                                                           activity_samples)
        masks, n_active, n_pca = self.get_active_units(variances, eig,
                                                       activity_threshold)
        res2 = {"active_units": masks, "number_of_active_units": n_active,
                "number_of_PCA_active_units": n_pca, "variances": variances}
        if include_pruned_nll:
            acc["LL_pruned"] = float(self.get_NLL_without_inactive_units(
                x[:batch_size], activity_threshold, nll_k, activity_samples,
                nll_chunk))
        return acc, res2

    def _flatten(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x, np.float32))
        x = x.to(self.device, torch.float32)
        return x.reshape(x.shape[0], -1)
