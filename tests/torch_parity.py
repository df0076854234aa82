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


def train_step_keys(key, n):
    """The model keys of `n` consecutive JAX train steps from state key
    `key` (train_step.py:69: ``key, subkey = split(key)``) and the state key
    after them."""
    subs = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs, key


def epoch_draws(jcfg, state_key, n_train, batch_size, k, x_dim=D,
                binarize=False):
    """JAX's draws of one ``make_epoch_fn`` pass (epoch.py:80-92): the
    permutation, per step the encoder noise under ``fold_in(k_batch, i)``
    and, with `binarize`, the uniforms of ``bernoulli(fold_in(k_bin, i))``.
    Returns ``(perm, noise, uniforms)`` as torch tensors (uniforms None
    without `binarize`)."""
    _, k_batch, k_perm, k_bin = jax.random.split(state_key, 4)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(k_perm,
                                                              n_train)))
    noise, uniforms = [], []
    for i in range(n_train // batch_size):
        noise.append([torch.from_numpy(e) for e in encode_noise(
            jcfg, jax.random.fold_in(k_batch, i), k, batch_size)])
        if binarize:
            uniforms.append(torch.from_numpy(np.asarray(jax.random.uniform(
                jax.random.fold_in(k_bin, i), (batch_size, x_dim)))))
    return perm, noise, (uniforms if binarize else None)


def leaf_errors(got_leaves, want_leaves):
    """Per leaf ``(max abs err, max abs err / max |want|)``."""
    out = []
    for g, w in zip(got_leaves, want_leaves):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) \
            else np.asarray(g)
        w = np.asarray(w)
        e = float(np.max(np.abs(g - w))) if w.size else 0.0
        out.append((e, e / max(float(np.max(np.abs(w))) if w.size else 0.0,
                               1e-12)))
    return out


def assert_leaves_close(got_leaves, want_leaves, rel, floor=1e-6, what=""):
    """Every leaf's max abs error within ``rel * max |want| + floor``: a
    tolerance on the leaf's own scale, as gradients of different leaves
    differ by orders of magnitude."""
    got_leaves, want_leaves = list(got_leaves), list(want_leaves)
    assert len(got_leaves) == len(want_leaves), what
    for i, ((e, r), w) in enumerate(zip(leaf_errors(got_leaves, want_leaves),
                                        want_leaves)):
        scale = float(np.max(np.abs(np.asarray(w)))) if np.asarray(w).size \
            else 0.0
        assert e <= rel * scale + floor, \
            f"{what} leaf {i}: max abs err {e:.3e} (rel {r:.3e}) > " \
            f"{rel:g} * {scale:.3e} + {floor:g}"


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
        out.update(_gradient_errors(cd))
    return out


def _gradient_errors(cd):
    """Per-leaf gradient errors (max abs, max abs / leaf max) of the port
    against JAX on the parity tests' inputs: all 11 objectives at L = 1
    and 2, and the plain backward against interpret-mode ``_bwd_pallas``."""
    from iwae_replication_project_tpu.objectives import estimators as jest
    from iwae_replication_project_tpu.objectives import gradients as jgrad
    from iwae_replication_project_tpu.ops import hot_loop as jhl
    from iwae_replication_project_tpu_torch.objectives import (
        estimators as test_, gradients as tgrad)
    from iwae_replication_project_tpu_torch.ops import hot_loop as thl
    from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

    specs = [("VAE", {}), ("IWAE", {}), ("VAE_V1", {}),
             ("L_alpha", dict(alpha=0.3)), ("L_power_p", dict(p=2.0)),
             ("L_median", {}), ("CIWAE", dict(beta=0.3)),
             ("MIWAE", dict(k2=3)), ("PIWAE", dict(k2=3)), ("DReG", {}),
             ("STL", {})]
    obj = []
    for layers in (1, 2):
        jcfg, tcfg = configs(layers, "logits", cd)
        jp, tp = params(jcfg, seed=layers)
        x, key = binary_rows(5, seed=2), jax.random.PRNGKey(3)
        eps = [torch.from_numpy(e) for e in encode_noise(jcfg, key, 6, 5)]
        for name, kw in specs:
            if name == "VAE_V1" and layers == 2:
                continue
            _, jg = jgrad.objective_value_and_grad(
                jest.ObjectiveSpec(name=name, k=6, **kw), jp, jcfg, key,
                jnp.asarray(x))
            _, tg = tgrad.objective_value_and_grad(
                test_.ObjectiveSpec(name=name, k=6, **kw), tp, tcfg,
                torch.from_numpy(x), eps=eps)
            obj += leaf_errors(tree_leaves(tg), jax.tree_util.tree_leaves(jg))
    bwd = []
    for k, b, d in [(1, 1, 12), (3, 7, 130), (13, 17, 130), (10, 300, 12)]:
        rs = np.random.RandomState(0)
        args = [rs.randn(k, b, 8), rs.randn(8, 16) * 0.2, rs.randn(16) * 0.1,
                rs.randn(16, 16) * 0.2, rs.randn(16) * 0.1,
                rs.randn(16, d) * 0.2, rs.randn(d) * 0.1, rs.rand(b, d) > 0.5,
                rs.randn(k, b)]
        args = [np.asarray(a, np.float32) for a in args]
        want = jhl._bwd_pallas(*(jnp.asarray(a) for a in args), tk=min(8, k),
                               tb=128 if b > 128 else b, interpret=True,
                               compute_dtype=cd)
        got = thl._bwd_plain(*(torch.from_numpy(a) for a in args),
                             compute_dtype=torch.bfloat16 if cd else None)
        bwd += leaf_errors(got, want)
    name = cd or "fp32"
    return {(what, name): tuple(max(e) for e in zip(*errs))
            for what, errs in (("objective_grads (abs, rel to leaf max)", obj),
                               ("bwd_plain vs _bwd_pallas (abs, rel to leaf "
                                "max)", bwd))}


if __name__ == "__main__":
    # PYTHONPATH=. python tests/torch_parity.py: the worst errors the parity
    # tests see
    for (what, cd), (a, r) in worst_errors().items():
        print(f"{what} {cd}: max_abs_err={a:.3e} max_rel_err={r:.3e}")
