"""The port's objectives (``objectives/estimators.py`` and
``objectives/gradients.py``) against the JAX package: every bound reducer,
and the per-leaf gradients of all 11 objectives on replayed draws, for 1 and
2 stochastic layers where the objective allows it, in fp32 and bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.objectives import estimators as jest
from iwae_replication_project_tpu.objectives import gradients as jgrad
from iwae_replication_project_tpu.models import iwae as jmodel
from iwae_replication_project_tpu_torch.models import iwae as tmodel
from iwae_replication_project_tpu_torch.objectives import estimators as test_
from iwae_replication_project_tpu_torch.objectives import gradients as tgrad
from iwae_replication_project_tpu_torch.ops import hot_loop as thl
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves
from torch_parity import (
    assert_leaves_close,
    binary_rows,
    configs,
    encode_noise,
    params,
)

K, B = 6, 5  # k even: L_median takes the mean of the middle pair

#: every objective with the hyperparameters it is tested under (MIWAE and
#: PIWAE with k2 > 1)
SPECS = [("VAE", {}), ("IWAE", {}), ("VAE_V1", {}),
         ("L_alpha", dict(alpha=0.3)), ("L_power_p", dict(p=2.0)),
         ("L_median", {}), ("CIWAE", dict(beta=0.3)), ("MIWAE", dict(k2=3)),
         ("PIWAE", dict(k2=3)), ("DReG", {}), ("STL", {})]

#: per-leaf gradient tolerance, relative to the leaf's largest magnitude.
#: fp32: the same arithmetic in another summation order (measured worst
#: 8.8e-6). bf16: both round the same operands, but a value within an fp32
#: rounding of a bf16 midpoint can round to the neighbouring bf16 value on
#: one side only, moving that operand by 2^-8 relative; a few such flips
#: across layers gave 7.5e-3 at worst.
GRAD_TOL = {None: 5e-5, "bfloat16": 2e-2}
#: bound values: sums of tens of nats in fp32 (measured worst 3.8e-6)
BOUND_ATOL = 5e-5


def _cases():
    for name, kw in SPECS:
        for layers in (1, 2):
            if name == "VAE_V1" and layers == 2:
                continue  # defined for one stochastic layer only
            for cd in (None, "bfloat16"):
                yield name, kw, layers, cd


@pytest.mark.parametrize("name,kw,layers,cd", list(_cases()),
                         ids=lambda v: str(v))
def test_objective_grads_match_jax(name, kw, layers, cd):
    jcfg, tcfg = configs(layers, "logits", cd)
    jp, tp = params(jcfg, seed=layers)
    x, key = binary_rows(B, seed=2), jax.random.PRNGKey(3)
    eps = [torch.from_numpy(e) for e in encode_noise(jcfg, key, K, B)]
    jb, jg = jgrad.objective_value_and_grad(
        jest.ObjectiveSpec(name=name, k=K, **kw), jp, jcfg, key,
        jnp.asarray(x))
    tb, tg = tgrad.objective_value_and_grad(
        test_.ObjectiveSpec(name=name, k=K, **kw), tp, tcfg,
        torch.from_numpy(x), eps=eps)
    assert abs(float(tb) - float(jb)) <= BOUND_ATOL
    assert set(tg) == {"enc", "dec", "out"}
    assert_leaves_close(tree_leaves(tg),
                        [np.asarray(a) for a in jax.tree_util.tree_leaves(jg)],
                        GRAD_TOL[cd], what=f"{name} L={layers} {cd}")


@pytest.mark.parametrize("name", ["IWAE", "DReG", "PIWAE"])
def test_fused_wiring_gives_the_reference_gradients(name, monkeypatch):
    """With the fused hot loop forced onto its kernel path on the CPU,
    gradients flow through FusedBlockLL (plain forward and backward) and
    equal the reference path's; DReG and PIWAE run the backward twice."""
    _, tcfg = configs(2, "logits", None, fused=True)
    _, tp = params(configs(2)[0], seed=4)
    x = torch.from_numpy(binary_rows(B, seed=5))
    spec = test_.ObjectiveSpec(name=name, k=K, k2=2 if name == "PIWAE" else 1)
    eps = [torch.from_numpy(e) for e in encode_noise(
        configs(2)[0], jax.random.PRNGKey(6), K, B)]
    _, want = tgrad.objective_value_and_grad(spec, tp, tcfg, x, eps=eps)
    calls = []
    real = thl.fused_backward
    monkeypatch.setattr(thl, "select_path",
                        lambda dev, force=None, widths=None, shape=None:
                        "kernel")
    monkeypatch.setattr(thl, "fused_backward",
                        lambda *a: calls.append(1) or real(*a))
    _, got = tgrad.objective_value_and_grad(spec, tp, tcfg, x, eps=eps)
    assert len(calls) == (1 if name == "IWAE" else 2)
    assert_leaves_close(tree_leaves(got), [w.numpy() for w in
                                           tree_leaves(want)], 1e-5)


@pytest.mark.parametrize("name,kw", [s for s in SPECS
                                     if s[0] not in ("VAE_V1",)])
def test_bound_reducers_match_jax(name, kw):
    rs = np.random.RandomState(0)
    log_w = (rs.randn(K, B) * 3 - 80).astype(np.float32)
    aux = {"log_px_given_h": (rs.randn(K, B) - 60).astype(np.float32)}
    want = jest.bound_from_log_weights(
        jest.ObjectiveSpec(name=name, k=K, **kw), jnp.asarray(log_w),
        {key: jnp.asarray(v) for key, v in aux.items()})
    got = test_.bound_from_log_weights(
        test_.ObjectiveSpec(name=name, k=K, **kw), torch.from_numpy(log_w),
        {key: torch.from_numpy(v) for key, v in aux.items()})
    assert abs(float(got) - float(want)) <= BOUND_ATOL


@pytest.mark.parametrize("k", [4, 5])
def test_median_is_jax_median(k):
    """torch.median takes the lower middle value for an even k; the port
    averages the middle pair as jnp.median does, and its gradient splits
    between the two."""
    log_w = torch.tensor(np.random.RandomState(k).randn(k, 3),
                         dtype=torch.float32, requires_grad=True)
    got = test_.median_bound(log_w)
    want = float(jnp.mean(jnp.median(jnp.asarray(log_w.detach().numpy()),
                                      axis=0)))
    assert abs(got.item() - want) <= 1e-6
    if k % 2 == 0:
        assert abs(float(torch.median(log_w, 0).values.mean()) - want) > 1e-3
    got.backward()
    nonzero = (log_w.grad != 0).sum(0)
    assert nonzero.tolist() == [2 if k % 2 == 0 else 1] * 3


def test_vae_v1_rejects_two_layers():
    _, tcfg = configs(2)
    _, tp = params(configs(2)[0])
    x = torch.from_numpy(binary_rows(B))
    with pytest.raises(ValueError, match="single-stochastic-layer"):
        test_.objective_bound(test_.ObjectiveSpec(name="VAE_V1", k=K), tp,
                              tcfg, x, generator=torch.Generator())


def test_objective_spec_checks():
    with pytest.raises(ValueError, match="unknown objective"):
        test_.ObjectiveSpec(name="ELBO")
    with pytest.raises(ValueError, match="k2"):
        test_.ObjectiveSpec(name="MIWAE", k=6, k2=4)
    assert test_.OBJECTIVE_NAMES == jest.OBJECTIVE_NAMES


@pytest.mark.parametrize("layers", [1, 2])
def test_stop_q_score_changes_gradients_not_values(layers):
    """stop_q_score detaches mu and std inside log q only: the log-weights
    equal JAX's with and without it, and the encoder gradient changes."""
    jcfg, tcfg = configs(layers)
    jp, tp = params(jcfg, seed=7)
    x, key = binary_rows(B, seed=8), jax.random.PRNGKey(9)
    eps = [torch.from_numpy(e) for e in encode_noise(jcfg, key, K, B)]
    want = np.asarray(jmodel.log_weights(jp, jcfg, key, jnp.asarray(x), K,
                                         stop_q_score=True))
    grads = []
    for stop in (False, True):
        leaves = tmodel.to_device(tp, "cpu")
        enc_w = leaves["enc"][0]["l1"]["w"].clone().requires_grad_(True)
        leaves["enc"][0]["l1"]["w"] = enc_w
        lw = tmodel.log_weights(leaves, tcfg, torch.from_numpy(x), K,
                                eps=eps, stop_q_score=stop)
        np.testing.assert_allclose(lw.detach().numpy(), want, atol=1e-4,
                                   rtol=1e-6)
        grads.append(torch.autograd.grad(lw.sum(), enc_w)[0])
    assert not torch.allclose(grads[0], grads[1])
