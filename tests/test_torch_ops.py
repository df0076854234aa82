"""Port numerics against the JAX package: distributions, softplus,
logsumexp/logmeanexp (iwae_replication_project_tpu_torch/ops) and the bound
reducers (objectives/estimators)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.objectives import estimators as jobj
from iwae_replication_project_tpu.ops import distributions as jdist
from iwae_replication_project_tpu_torch.objectives import estimators as tobj
from iwae_replication_project_tpu_torch.ops import distributions as tdist
from iwae_replication_project_tpu_torch.ops import logsumexp as tlse

# the package re-exports the function under the module's name
jlse = importlib.import_module("iwae_replication_project_tpu.ops.logsumexp")

# elementwise fp32 math on the same inputs; the two libraries' exp/log/log1p
# may differ by an ulp or two, so agreement is held to a few fp32 ulps
ATOL, RTOL = 1e-6, 1e-6


def _arrays(seed=0, shape=(5, 7, 9)):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    mu = rs.randn(*shape).astype(np.float32)
    std = np.exp(rs.randn(*shape)).astype(np.float32) + 1e-3
    probs = rs.rand(*shape).astype(np.float32)
    bits = (rs.rand(*shape) > 0.5).astype(np.float32)
    return x, mu, std, probs, bits


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", ["normal_log_prob", "standard_normal",
                                  "kl_standard", "clamp_probs", "bernoulli",
                                  "bernoulli_logits"])
def test_distributions_match_jax(name):
    x, mu, std, probs, bits = _arrays()
    logits = 8.0 * x   # spans both softplus branches well past |l| = 20
    cases = {
        "normal_log_prob": (jdist.normal_log_prob(x, mu, std),
                            tdist.normal_log_prob(_t(x), _t(mu), _t(std))),
        "standard_normal": (jdist.standard_normal_log_prob(x),
                            tdist.standard_normal_log_prob(_t(x))),
        "kl_standard": (jdist.normal_kl_standard(mu, std),
                        tdist.normal_kl_standard(_t(mu), _t(std))),
        "clamp_probs": (jdist.clamp_probs(probs),
                        tdist.clamp_probs(_t(probs))),
        "bernoulli": (jdist.bernoulli_log_prob(bits, jdist.clamp_probs(probs)),
                      tdist.bernoulli_log_prob(
                          _t(bits), tdist.clamp_probs(_t(probs)))),
        "bernoulli_logits": (
            jdist.bernoulli_log_prob_from_logits(bits, logits),
            tdist.bernoulli_log_prob_from_logits(_t(bits), _t(logits))),
    }
    want, got = cases[name]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=RTOL)


def test_parity_constants():
    assert tdist.STD_FLOOR == jdist.STD_FLOOR
    assert tdist.PROB_CLAMP_SCALE == jdist.PROB_CLAMP_SCALE
    assert tdist.PROB_CLAMP_SHIFT == jdist.PROB_CLAMP_SHIFT


@pytest.mark.parametrize("scale", [1.0, 15.0, 40.0])
def test_softplus_matches_jax_both_branches(scale):
    """The port's softplus is JAX's logaddexp(l, 0) form, not torch's
    threshold-20 softplus: it must agree with jax.nn.softplus beyond |l|=20
    as well as near 0."""
    l = (np.linspace(-1.0, 1.0, 101) * scale).astype(np.float32)
    want = np.asarray(jax.nn.softplus(l))
    np.testing.assert_allclose(tdist.softplus(_t(l)).numpy(), want,
                               atol=ATOL, rtol=RTOL)


def test_normal_sample_injected_noise_and_shape_check():
    _, mu, std, _, _ = _arrays(shape=(3, 4))
    eps = np.random.RandomState(1).randn(5, 3, 4).astype(np.float32)
    got = tdist.normal_sample(_t(mu), _t(std), (5,), eps=_t(eps))
    np.testing.assert_allclose(got.numpy(), mu + std * eps, rtol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        tdist.normal_sample(_t(mu), _t(std), (4,), eps=_t(eps))
    g = torch.Generator().manual_seed(0)
    assert tdist.normal_sample(_t(mu), _t(std), (5,),
                               generator=g).shape == (5, 3, 4)


@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("fn", ["logsumexp", "logmeanexp"])
def test_logsumexp_matches_jax(fn, dim):
    lw = (np.random.RandomState(2).randn(50, 9) * 30 - 200).astype(np.float32)
    want = np.asarray(getattr(jlse, fn)(jnp.asarray(lw), axis=dim))
    got = getattr(tlse, fn)(_t(lw), dim=dim).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("fn", ["vae_bound", "iwae_per_example",
                                "iwae_bound"])
def test_estimators_match_jax(fn):
    """The bound reducers on log-weights of a few hundred nats: fp32 sums
    over 50 x 9 terms, held to the same tolerance as logsumexp."""
    lw = (np.random.RandomState(4).randn(50, 9) * 30 - 200).astype(np.float32)
    want = np.asarray(getattr(jobj, fn)(jnp.asarray(lw)))
    got = getattr(tobj, fn)(_t(lw)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("fn", ["logsumexp", "logmeanexp"])
def test_all_neg_inf_column_gives_neg_inf_not_nan(fn):
    lw = np.random.RandomState(3).randn(6, 4).astype(np.float32)
    lw[:, 1] = -np.inf
    lw[2, 3] = -np.inf   # a partly -inf column stays finite
    want = np.asarray(getattr(jlse, fn)(jnp.asarray(lw), axis=0))
    got = getattr(tlse, fn)(_t(lw), dim=0).numpy()
    assert np.isneginf(got[1]) and np.isneginf(want[1])
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got[[0, 2, 3]], want[[0, 2, 3]], atol=1e-5,
                               rtol=1e-6)
