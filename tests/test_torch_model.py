"""The port's model (iwae_replication_project_tpu_torch/models) against the
JAX package on JAX's own draws, replayed: log-weights for 1 and 2 stochastic
layers, clamp and logits likelihoods, fp32 and bf16; plus parameter
conversion and config validation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.models import iwae as jmodel
from iwae_replication_project_tpu_torch.convert import (
    params_from_numpy,
    params_to_numpy,
)
from iwae_replication_project_tpu_torch.models import iwae as tmodel
from torch_parity import (
    assert_close,
    binary_rows,
    configs,
    encode_noise,
    params,
)

#: (atol, rtol) on log-weights of tens of nats at test width. fp32: the
#: same float32 arithmetic in another summation order. bf16: both round the
#: same operands to bf16; an encoder pre-activation within an fp32 rounding
#: of a bf16 midpoint can round differently, which moves a sample's latent by
#: one bf16 step and its log-weight by up to ~1e-2 nats.
TOL = {None: (1e-3, 1e-5), "bfloat16": (5e-2, 1e-3)}


def _jax_log_w(jp, jcfg, key, x, k):
    return np.asarray(jmodel.log_weights(jp, jcfg, key, jnp.asarray(x), k))


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("likelihood", ["clamp", "logits"])
@pytest.mark.parametrize("layers", [1, 2])
def test_log_weights_match_jax_on_replayed_draws(layers, likelihood, cd):
    jcfg, tcfg = configs(layers, likelihood, cd)
    jp, tp = params(jcfg, seed=layers)
    x = binary_rows(6, seed=3)
    k = 5
    key = jax.random.PRNGKey(11)
    want = _jax_log_w(jp, jcfg, key, x, k)
    eps = [torch.from_numpy(e) for e in encode_noise(jcfg, key, k, 6)]
    got = tmodel.log_weights(tp, tcfg, torch.from_numpy(x), k, eps=eps)
    assert got.shape == (k, 6)
    assert_close(got, want, *TOL[cd], what=f"L={layers} {likelihood} {cd}")


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_fused_reference_path_matches_unfused_jax(cd):
    """A logits model routed through the hot-loop dispatcher (the CPU takes
    its plain path) gives JAX's unfused log-weights."""
    jcfg, tcfg = configs(2, "logits", cd, fused=True)
    jp, tp = params(jcfg)
    x = binary_rows(4, seed=5)
    key = jax.random.PRNGKey(2)
    want = _jax_log_w(jp, jcfg, key, x, 3)
    eps = [torch.from_numpy(e) for e in encode_noise(jcfg, key, 3, 4)]
    got = tmodel.log_weights(tp, tcfg, torch.from_numpy(x), 3, eps=eps)
    assert_close(got, want, *TOL[cd])


def test_aux_terms_match_jax():
    jcfg, tcfg = configs(2, "logits")
    jp, tp = params(jcfg)
    x = binary_rows(3, seed=7)
    key = jax.random.PRNGKey(4)
    _, jaux = jmodel.log_weights_and_aux(jp, jcfg, key, jnp.asarray(x), 4)
    eps = [torch.from_numpy(e) for e in encode_noise(jcfg, key, 4, 3)]
    _, taux = tmodel.log_weights_and_aux(tp, tcfg, torch.from_numpy(x), 4,
                                         eps=eps)
    for name in ("log_q", "log_px_given_h", "log_prior"):
        assert_close(taux[name], np.asarray(jaux[name]), 1e-3, 1e-5, name)
    for i in range(2):
        assert_close(taux["h"][i], np.asarray(jaux["h"][i]), 1e-5, 1e-5)


@pytest.mark.parametrize("layers", [1, 2])
def test_generate_x_matches_jax_on_replayed_draws(layers):
    jcfg, tcfg = configs(layers, "clamp")
    jp, tp = params(jcfg)
    key = jax.random.PRNGKey(9)
    h_top = np.random.RandomState(1).randn(1, 4, jcfg.n_latent_enc[-1]) \
        .astype(np.float32)
    want = np.asarray(jmodel.generate_x(jp, jcfg, key, jnp.asarray(h_top)))
    keys = jax.random.split(key, max(layers - 1, 1))
    eps = [torch.from_numpy(np.asarray(jax.random.normal(
        keys[i], (1, 4, jcfg.n_latent_dec[i]), dtype=jnp.float32)))
        for i in range(layers - 1)]
    got = tmodel.generate_x(tp, tcfg, torch.from_numpy(h_top), eps=eps)
    assert got.shape == (1, 4, jcfg.x_dim)
    assert_close(got, want, 1e-6, 1e-5)


def test_params_from_numpy_round_trip():
    jcfg, _ = configs(2)
    jp, tp = params(jcfg)
    host = jax.tree_util.tree_map(np.asarray, jp)
    back = params_to_numpy(tp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(host)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(host)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    again = params_from_numpy(back, "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(params_to_numpy(again)),
        jax.tree_util.tree_leaves(back)))


def test_init_params_layout_matches_jax_tree():
    """The port draws its own weights, in the JAX package's tree and
    shapes, and the same generator seed gives the same weights."""
    jcfg, tcfg = configs(2)
    jp, _ = params(jcfg)
    tp = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    host = jax.tree_util.tree_map(np.asarray, jp)
    got = params_to_numpy(tp)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(host)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(host)):
        assert a.shape == b.shape
    tp2 = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(got),
        jax.tree_util.tree_leaves(params_to_numpy(tp2))))


@pytest.mark.parametrize("bad,match", [
    (dict(likelihood="probit"), "likelihood"),
    (dict(compute_dtype="float16"), "compute_dtype"),
    (dict(fused_likelihood=True), "fused_likelihood requires"),
    (dict(likelihood="logits", hot_loop_path="kernel"), "requires"),
    (dict(likelihood="logits", fused_likelihood=True, hot_loop_path="pallas"),
     "unknown hot_loop_path"),
    (dict(n_latent_dec=(100, 10)), "x_dim"),
    (dict(n_hidden_dec=(100,)), "equal length"),
])
def test_model_config_validation(bad, match):
    with pytest.raises(ValueError, match=match):
        tmodel.ModelConfig.two_layer(**bad)


def test_encode_noise_count_is_checked():
    _, tcfg = configs(2)
    _, tp = params(configs(2)[0])
    with pytest.raises(ValueError, match="noise"):
        tmodel.encode(tp, tcfg, torch.zeros(2, 20), 3,
                      eps=[torch.zeros(3, 2, 8)])
