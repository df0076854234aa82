"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Both packages see the same numbers: inputs are drawn with numpy, parameters
are made by the JAX package and handed to the port as numpy arrays, and the
port's noise is JAX's own draws, rebuilt from the same keys in the order
``models/iwae.encode`` and ``generate_x`` draw them and injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from iwae_replication_project_tpu.models import iwae as jmodel
from iwae_replication_project_tpu_torch.convert import params_from_numpy
from iwae_replication_project_tpu_torch.models import iwae as tmodel

D = 20  # pixels at test width

ARCH = {
    1: dict(n_hidden_enc=(16,), n_latent_enc=(6,), n_hidden_dec=(16,),
            n_latent_dec=(D,)),
    2: dict(n_hidden_enc=(16, 12), n_latent_enc=(8, 5), n_hidden_dec=(12, 16),
            n_latent_dec=(8, D)),
}


def configs(layers=2, likelihood="logits", compute_dtype=None,
            fused=False):
    """(JAX ModelConfig, port ModelConfig) of one tiny architecture."""
    kw = dict(ARCH[layers], x_dim=D, likelihood=likelihood,
              compute_dtype=compute_dtype)
    return (jmodel.ModelConfig(**kw),
            tmodel.ModelConfig(**kw, fused_likelihood=fused))


def params(jcfg, seed=0):
    """(JAX params, the same values as port tensors on the CPU)."""
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def binary_rows(n, seed=0, d=D):
    return (np.random.RandomState(seed).rand(n, d) > 0.5).astype(np.float32)


def encode_noise(jcfg, key, k, batch):
    """JAX's encode draws for `key`: layer 0 ``[k, B, d0]``, layer i
    ``[k, B, d_i]`` (iwae.py:178-187, distributions.py:27-37)."""
    keys = jax.random.split(key, jcfg.n_stochastic)
    return [np.asarray(jax.random.normal(keys[i], (k, batch, d),
                                         dtype=jnp.float32))
            for i, d in enumerate(jcfg.n_latent_enc)]


def row_encode_noise(jcfg, base_key, seeds, k):
    """Per-row ``fold_in(base_key, seed)`` encode draws of the serving
    programs, stacked as the port's ``[k, B, d]`` noise tensors."""
    rows = [encode_noise(jcfg, jax.random.fold_in(base_key, s), k, 1)
            for s in seeds]
    return [torch.from_numpy(np.concatenate([r[i] for r in rows], axis=1))
            for i in range(jcfg.n_stochastic)]


def row_decode_noise(jcfg, base_key, seeds):
    """Per-row draws of ``generate_x`` under ``fold_in(base_key, seed)``, as
    the port's ``[B, d]`` decode noise tensors."""
    L = jcfg.n_stochastic
    out = [[] for _ in range(L - 1)]
    for s in seeds:
        keys = jax.random.split(jax.random.fold_in(base_key, s), max(L - 1, 1))
        for i in range(L - 1):
            d = jcfg.n_latent_dec[i]
            out[i].append(np.asarray(jax.random.normal(
                keys[i], (1, 1, d), dtype=jnp.float32))[0, 0])
    return [torch.from_numpy(np.stack(o)) for o in out]


def assert_close(got, want, atol, rtol, what=""):
    """np.testing.assert_allclose on tensors/arrays; returns the worst abs
    error for the record."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def worst_errors():
    """``{(what, compute dtype): (max abs err, max rel err)}`` of the port
    against JAX over the inputs the parity tests use: log-weights (L=1/2,
    clamp/logits, on replayed draws), ``score_rows`` (per-row draws) and the
    plain ``decoder_score`` against JAX's ``_reference_impl``."""
    from iwae_replication_project_tpu.ops import hot_loop as jhl
    from iwae_replication_project_tpu.serving import programs as jprog
    from iwae_replication_project_tpu_torch.ops import hot_loop as thl
    from iwae_replication_project_tpu_torch.serving import programs as tprog

    def err(got, want):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        d = np.abs(got - np.asarray(want))
        return float(d.max()), float((d / np.maximum(np.abs(want),
                                                     1e-6)).max())

    out = {}
    for cd in (None, "bfloat16"):
        lw, sc, dec = [], [], []
        for layers in (1, 2):
            for lik in ("clamp", "logits"):
                jcfg, tcfg = configs(layers, lik, cd)
                jp, tp = params(jcfg, seed=layers)
                x, key = binary_rows(6, seed=3), jax.random.PRNGKey(11)
                eps = [torch.from_numpy(e)
                       for e in encode_noise(jcfg, key, 5, 6)]
                lw.append(err(
                    tmodel.log_weights(tp, tcfg, torch.from_numpy(x), 5,
                                       eps=eps),
                    jmodel.log_weights(jp, jcfg, key, jnp.asarray(x), 5)))
            jcfg, tcfg = configs(layers, "logits", cd)
            jp, tp = params(jcfg, seed=layers)
            seeds, key = [0, 5, 17, 3, 2 ** 31 - 1], jax.random.PRNGKey(7)
            x = binary_rows(len(seeds), seed=1)
            sc.append(err(
                tprog.score_rows(tp, tcfg, 0, seeds, torch.from_numpy(x), 4,
                                 noise=row_encode_noise(jcfg, key, seeds, 4)),
                jprog.score_rows(jp, jcfg, key, jnp.asarray(seeds, jnp.int32),
                                 jnp.asarray(x), 4)))
        for k, b, d in [(1, 1, 12), (3, 7, 130), (7, 17, 140), (10, 300, 12)]:
            rs = np.random.RandomState(0)
            args = [rs.randn(k, b, 8), rs.randn(8, 16) * 0.2,
                    rs.randn(16) * 0.1, rs.randn(16, 16) * 0.2,
                    rs.randn(16) * 0.1, rs.randn(16, d) * 0.2,
                    rs.randn(d) * 0.1, rs.rand(b, d) > 0.5]
            args = [np.asarray(a, np.float32) for a in args]
            t = [torch.from_numpy(a) for a in args]
            dec.append(err(
                thl._reference_impl(*t, compute_dtype=torch.bfloat16
                                    if cd else None),
                jhl._reference_impl(*(jnp.asarray(a) for a in args),
                                    compute_dtype=cd)))
        for what, errs in (("log_weights", lw), ("score_rows", sc),
                           ("decoder_score", dec)):
            out[(what, cd or "fp32")] = tuple(max(e) for e in zip(*errs))
    return out


if __name__ == "__main__":
    # PYTHONPATH=. python tests/torch_parity.py: the worst errors the parity
    # tests see
    for (what, cd), (a, r) in worst_errors().items():
        print(f"{what} {cd}: max_abs_err={a:.3e} max_rel_err={r:.3e}")
