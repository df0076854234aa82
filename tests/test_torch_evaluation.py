"""The port's evaluation path against the JAX package on replayed draws: the
online logsumexp carries, the batch metrics with the streamed NLL, the
reconstruction loss, the seven dataset scalars, the activity estimate with
active units and the pruned NLL, the estimator diagnostics, the whole
``training_statistics`` suite and the per-stage evaluation of
``run_experiment``. Everything runs on the CPU at test widths.

Tolerances. In fp32 both sides run the same arithmetic in another summation
order: log-weights agree to ~1e-5 nats on rows of a few tens of nats, so the
scalars (means of them) are held to 1e-4 nats + 1e-5 relative. In bf16 both
round the same operands to bf16 and sum in fp32, but an operand within an
fp32 rounding of a bf16 midpoint may round to the neighbouring bf16 value on
one side only (2^-8 relative in that one operand); the scalars are held to
1e-4 relative. Variances and eigenvalues of the posterior means: 1e-5
absolute + 1e-4 relative. The active-unit counts must be equal. The worst
errors on the inputs of test_training_statistics_matches_jax are printed by
``PYTHONPATH=.:tests python tests/torch_parity.py`` (7.0e-7 relative for
the scalars in bf16, 6.0e-8 absolute for the variances).
"""

import dataclasses
import importlib
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.evaluation import activity as jact
from iwae_replication_project_tpu.evaluation import metrics as jmet
from iwae_replication_project_tpu.telemetry import diagnostics as jdiag
from iwae_replication_project_tpu.utils.config import (
    ExperimentConfig as JConfig,
)
from iwae_replication_project_tpu_torch import zoo
from iwae_replication_project_tpu_torch.evaluation import activity as tact
from iwae_replication_project_tpu_torch.evaluation import metrics as tmet
from iwae_replication_project_tpu_torch.ops import hot_loop as thl
from iwae_replication_project_tpu_torch.ops import logsumexp as tlse
from iwae_replication_project_tpu_torch.telemetry import diagnostics as tdiag
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig
from iwae_replication_project_tpu_torch.utils.sizes import largest_divisor_leq
from iwae_replication_project_tpu_torch.utils.tree import tree_map
from torch_parity import (
    batch_eval_noise,
    binary_rows,
    chunk_noise,
    configs,
    decode_noise,
    encode_noise,
    params,
    training_statistics_noise,
)

# the JAX package's ops/__init__ re-exports a function of the module's name
jlse = importlib.import_module("iwae_replication_project_tpu.ops.logsumexp")

#: (atol, rtol) of the eval scalars per compute dtype; see the docstring
SCALAR_TOL = {None: (1e-4, 1e-5), "bfloat16": (0.0, 1e-4)}
MOMENT_TOL = (1e-5, 1e-4)

CASES = [(1, None), (2, None), (1, "bfloat16"), (2, "bfloat16")]


def _setup(layers, cd):
    jcfg, tcfg = configs(layers, "logits", cd)
    jp, tp = params(jcfg, seed=layers)
    return jcfg, tcfg, jp, tp


def _close(got, want, cd, what=""):
    atol, rtol = SCALAR_TOL[cd]
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol,
                               err_msg=what)


# --------------------------------------------------------------------------
# the online logsumexp carries
# --------------------------------------------------------------------------

def _lw(seed, shape=(7, 5)):
    lw = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3.0
    lw[:, 0] = -np.inf  # an all -inf column
    return lw


@pytest.mark.parametrize("order", [(0, 1, 2), (2, 0, 1), (1, 2, 0)])
def test_online_carries_update_and_merge_match_jax(order):
    """Chunks folded by update and partial states merged, in any order,
    give JAX's carries to fp32 rounding and the dense logsumexp; the
    all -inf column finalizes to -inf, and (m, s) of the two carries are
    bitwise equal."""
    chunks = [_lw(i) for i in range(3)]
    t, tv = tlse.online_logsumexp_init((5,)), tlse.online_lse_var_init((5,))
    j, jv = jlse.online_logsumexp_init((5,)), jlse.online_lse_var_init((5,))
    parts, var_parts = [], []
    for i in order:
        c, cj = torch.from_numpy(chunks[i]), jnp.asarray(chunks[i])
        t = tlse.online_logsumexp_update(t, c)
        tv = tlse.online_lse_var_update(tv, c)
        j = jlse.online_logsumexp_update(j, cj)
        jv = jlse.online_lse_var_update(jv, cj)
        parts.append(tlse.online_logsumexp_update(
            tlse.online_logsumexp_init((5,)), c))
        var_parts.append(tlse.online_lse_var_update(
            tlse.online_lse_var_init((5,)), c))
    assert torch.equal(t.m, tv.m) and torch.equal(t.s, tv.s)
    for got, want in ((t.m, j.m), (t.s, j.s), (tv.s2, jv.s2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert t.n == int(j.n) == 21
    merged = tlse.online_logsumexp_merge(
        tlse.online_logsumexp_merge(parts[0], parts[1]), parts[2])
    merged_var = tlse.online_lse_var_merge(
        tlse.online_lse_var_merge(var_parts[0], var_parts[1]), var_parts[2])
    assert torch.equal(merged.m, merged_var.m) and \
        torch.equal(merged.s, merged_var.s)
    np.testing.assert_allclose(merged.s.numpy(), t.s.numpy(), rtol=1e-6)
    np.testing.assert_allclose(merged_var.s2.numpy(), tv.s2.numpy(),
                               rtol=1e-5)
    out = tlse.online_logsumexp_finalize(merged, mean=True)
    assert out[0] == -math.inf
    dense = np.concatenate(chunks)
    np.testing.assert_allclose(
        out.numpy()[1:], np.asarray(jax.nn.logsumexp(dense, axis=0))[1:]
        - np.log(21), rtol=1e-6)
    np.testing.assert_allclose(
        tlse.online_logsumexp_finalize(t).numpy(),
        np.asarray(jlse.online_logsumexp_finalize(j)), rtol=1e-6)


def test_lse_var_stats_match_jax_and_never_nan():
    """ess and se against JAX, with s == 0 (all -inf) giving ess 0 and
    se +inf, and n = 1 staying finite."""
    rs = np.random.RandomState(0)
    s = np.abs(rs.randn(6)).astype(np.float32)
    s2 = (s * s * rs.uniform(0.2, 1.0, 6)).astype(np.float32)
    s[0] = s2[0] = 0.0
    for n in (1, 8):
        ess, se = tlse.lse_var_stats(torch.from_numpy(s),
                                     torch.from_numpy(s2), n)
        jess, jse = jlse.lse_var_stats(jnp.asarray(s), jnp.asarray(s2), n)
        assert ess[0] == 0.0 and se[0] == math.inf
        assert not torch.isnan(ess).any() and not torch.isnan(se).any()
        np.testing.assert_allclose(ess.numpy(), np.asarray(jess), rtol=1e-6)
        np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-6)


def test_streaming_logmeanexp_matches_jax_and_dense():
    lw = np.random.RandomState(1).randn(12, 4).astype(np.float32) * 4.0
    got = tlse.streaming_logmeanexp(lambda i: torch.from_numpy(
        lw[3 * i:3 * i + 3]), 12, 3, (4,))
    want = jlse.streaming_logmeanexp(lambda i: jax.lax.dynamic_slice_in_dim(
        jnp.asarray(lw), 3 * i, 3), 12, 3, (4,))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), tlse.logmeanexp(torch.from_numpy(lw)).numpy(),
        rtol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        tlse.streaming_logmeanexp(lambda i: None, 10, 3, (4,))


def test_largest_divisor_leq_matches_jax():
    from iwae_replication_project_tpu.utils.flops import (
        largest_divisor_leq as jldl)
    for n, cap in [(5000, 250), (5000, 300), (256, 500), (1000, 500),
                   (7, 3), (1, 10)]:
        assert largest_divisor_leq(n, cap) == jldl(n, cap)


# --------------------------------------------------------------------------
# per-batch metrics, on replayed draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layers,cd", CASES)
def test_batch_functions_match_jax(layers, cd):
    """batch_metrics, the streamed log p(x) (nll_k=40 in chunks of 8) and
    the reconstruction loss."""
    jcfg, tcfg, jp, tp = _setup(layers, cd)
    x = binary_rows(9, seed=4)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    key = jax.random.PRNGKey(5)
    got = tmet.batch_metrics(tp, tcfg, xt, 6, eps=[
        torch.from_numpy(e) for e in encode_noise(jcfg, key, 6, 9)])
    want = jmet.batch_metrics(jp, jcfg, key, xj, 6)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], cd, name)
    _close(tmet.streaming_log_px(tp, tcfg, xt, 40, 8,
                                 noise=chunk_noise(jcfg, key, 8, 9)),
           jmet.streaming_log_px(jp, jcfg, key, xj, k=40, chunk=8), cd)
    k_enc, k_dec = jax.random.split(key)
    _close(tmet.reconstruction_loss(
        tp, tcfg, xt, enc_eps=[torch.from_numpy(e)
                               for e in encode_noise(jcfg, k_enc, 1, 9)],
        dec_eps=decode_noise(jcfg, k_dec, 9)),
        jmet.reconstruction_loss(jp, jcfg, key, xj), cd)
    with pytest.raises(ValueError, match="divide"):
        tmet.streaming_log_px(tp, tcfg, xt, 40, 7)


@pytest.mark.parametrize("layers,cd", CASES)
def test_dataset_scalars_match_jax(layers, cd):
    """The seven scalars over 2 batches, with JAX's per-batch key
    structure."""
    jcfg, tcfg, jp, tp = _setup(layers, cd)
    batches = binary_rows(12, seed=6).reshape(2, 6, -1)
    key = jax.random.PRNGKey(7)
    got = tmet.dataset_scalars(tp, tcfg, torch.from_numpy(batches), 5, 24, 6,
                               noise=batch_eval_noise(jcfg, key, 6, 5, 6))
    want = jmet.dataset_scalars(jp, jcfg, key, jnp.asarray(batches), 5, 24, 6)
    assert got.shape == (len(tmet.SCALAR_NAMES),)
    assert tmet.SCALAR_NAMES == jmet.SCALAR_NAMES
    _close(got, want, cd)


# --------------------------------------------------------------------------
# activity and the pruned NLL
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layers,cd", CASES)
def test_activity_and_pruned_nll_match_jax(layers, cd):
    """Variances (population, correction=0) and ascending PCA eigenvalues
    of the posterior means over 40 samples in chunks of 10, equal
    active-unit counts, and the pruned NLL on the same masks."""
    jcfg, tcfg, jp, tp = _setup(layers, cd)
    x = binary_rows(30, seed=6)
    key = jax.random.PRNGKey(8)
    var, eig = tact.posterior_mean_activity(
        tp, tcfg, torch.from_numpy(x), n_samples=40,
        noise=chunk_noise(jcfg, key, 10, 30))
    jvar, jeig = jact.posterior_mean_activity(jp, jcfg, key, jnp.asarray(x),
                                              n_samples=40)
    for got, want in list(zip(var, jvar)) + list(zip(eig, jeig)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MOMENT_TOL[0], rtol=MOMENT_TOL[1])
    masks, n_active, n_pca = tact.active_units(var, eig)
    jmasks, jn_active, jn_pca = jact.active_units(jvar, jeig)
    assert n_active.tolist() == jn_active and n_pca.tolist() == jn_pca
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    xb = x[:8]
    _close(tact.nll_without_inactive_units(
        tp, tcfg, torch.from_numpy(xb), masks, k=24, chunk=6,
        noise=chunk_noise(jcfg, key, 6, 8)),
        jact.nll_without_inactive_units(jp, jcfg, key, jnp.asarray(xb),
                                        jmasks, k=24, chunk=6), cd)


def test_pca_eigenvalues_and_dead_unit():
    """pca_eigenvalues is the ascending spectrum of the covariance divided
    by N; a constant unit has variance 0 and counts as inactive."""
    data = np.random.RandomState(0).randn(40, 5).astype(np.float32)
    data[:, 2] = 0.5
    want = np.linalg.eigvalsh(np.cov(data.T, bias=True))
    got = tact.pca_eigenvalues(torch.from_numpy(data))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    var = torch.var(torch.from_numpy(data), dim=0, correction=0)
    masks, n_active, n_pca = tact.active_units((var,), (got,))
    assert masks[0][2] == 0 and n_active.tolist() == [4]
    assert n_pca.tolist() == [4]


# --------------------------------------------------------------------------
# estimator diagnostics
# --------------------------------------------------------------------------

def test_weight_diagnostics_match_jax():
    """With and without n_samples (scalar and per-row, with a zero count:
    ESS 0, never NaN)."""
    lw = np.random.RandomState(2).randn(8, 5).astype(np.float32) * 2.0
    for n in (None, 5, np.array([8, 3, 0, 1, 6], np.float32)):
        got = tdiag.weight_diagnostics(torch.from_numpy(lw), n_samples=(
            None if n is None else torch.as_tensor(n)))
        want = jdiag.weight_diagnostics(jnp.asarray(lw), n_samples=(
            None if n is None else jnp.asarray(n)))
        assert set(got) == set(want)
        for key in want:
            assert not torch.isnan(got[key])
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, err_msg=f"{key} n={n}")
    np.testing.assert_allclose(
        tdiag.ess(torch.zeros(8, 3)).numpy(), 8.0, rtol=1e-6)


@pytest.mark.parametrize("layers,cd", CASES)
def test_estimator_diagnostics_match_jax(layers, cd):
    jcfg, tcfg, jp, tp = _setup(layers, cd)
    batches = binary_rows(12, seed=9).reshape(2, 6, -1)
    key = jax.random.PRNGKey(10)
    got = tdiag.estimator_diagnostics(
        tp, tcfg, torch.from_numpy(batches), 5, tdiag.DiagnosticsConfig(),
        noise=lambda i: [torch.from_numpy(e) for e in encode_noise(
            jcfg, jax.random.fold_in(key, i), 5, 6)])
    want = jdiag.estimator_diagnostics(jp, jcfg, key, jnp.asarray(batches),
                                       5, jdiag.DiagnosticsConfig())
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------
# the whole suite and the experiment loop
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layers,cd", CASES)
def test_training_statistics_matches_jax(layers, cd):
    """End to end at tiny width: 24 test rows asked in batches of 9 (clamped
    to 8), nll_k=24 asked in chunks of 5 (clamped to 4), 20 activity
    samples; every draw replayed from JAX's keys."""
    jcfg, tcfg, jp, tp = _setup(layers, cd)
    x = binary_rows(24, seed=8)
    key = jax.random.PRNGKey(11)
    kw = dict(batch_size=9, nll_k=24, nll_chunk=5, activity_samples=20)
    got, got2 = tmet.training_statistics(
        tp, tcfg, torch.from_numpy(x), 4, **kw,
        noise=training_statistics_noise(jcfg, key, 24, 8, 4, 4))
    want, want2 = jmet.training_statistics(jp, jcfg, key, jnp.asarray(x), 4,
                                           **kw)
    assert set(got) == set(want)
    assert got["eval_batch"] == want["eval_batch"] == 8.0
    assert got["nll_chunk"] == want["nll_chunk"] == 4.0
    assert got["kernel_path"] == want["kernel_path"] == 0.0
    for name in tmet.SCALAR_NAMES + ("LL_pruned",):
        _close(got[name], want[name], cd, name)
    for name in ("number_of_active_units", "number_of_PCA_active_units"):
        assert got2[name] == want2[name], name
    for v, jv in zip(got2["variances"], want2["variances"]):
        np.testing.assert_allclose(v.numpy(), np.asarray(jv),
                                   atol=MOMENT_TOL[0], rtol=MOMENT_TOL[1])


def test_eval_never_differentiates_and_counts_its_forwards(monkeypatch):
    """On the kernel path (forced here on the CPU, where the wrappers run
    their plain versions) the suite runs the hot loop's forward exactly
    n_batches * (1 + nll_k / chunk) + nll_k / chunk times and its backward
    never, and returns no autograd graph though the parameters require
    gradients."""
    _, tcfg = configs(2, "logits", None, fused=True)
    _, tp = params(configs(2)[0], seed=3)
    tp = tree_map(lambda t: t.requires_grad_(True), tp)
    calls = []
    real = thl.fused_forward
    monkeypatch.setattr(thl, "select_path",
                        lambda dev, force=None, widths=None, shape=None:
                        "kernel")
    monkeypatch.setattr(thl, "fused_forward",
                        lambda *a: calls.append(1) or real(*a))

    def no_backward(*a):
        raise AssertionError("evaluation ran the hot loop's backward")

    monkeypatch.setattr(thl, "fused_backward", no_backward)
    x = torch.from_numpy(binary_rows(12, seed=1))
    res, _ = tmet.training_statistics(tp, tcfg, x, 3, batch_size=6, nll_k=12,
                                      nll_chunk=4, activity_samples=10,
                                      generator=torch.Generator()
                                      .manual_seed(0))
    assert len(calls) == 2 * (1 + 12 // 4) + 12 // 4
    assert res["kernel_path"] == float(thl.PATH_CODES["kernel"])
    assert all(np.isfinite(res[n]) for n in tmet.SCALAR_NAMES)
    out = tmet.streaming_log_px(tp, tcfg, x, 4, 4,
                                generator=torch.Generator().manual_seed(0))
    assert not out.requires_grad


def test_eval_generator_streams():
    """Stage s and its diagnostics draw from distinct, reproducible
    streams seeded from (seed + 10_000, stream)."""
    a = torch.randn(4, generator=tmet.eval_generator(0, 1, "cpu"))
    assert torch.equal(a, torch.randn(
        4, generator=tmet.eval_generator(0, 1, "cpu")))
    for other in ((0, 2), (0, 30_001), (1, 1)):
        assert not torch.equal(a, torch.randn(
            4, generator=tmet.eval_generator(*other, "cpu")))


def test_run_experiment_rows_carry_the_eval_scalars(tmp_path):
    """run_experiment evaluates after each stage: every row carries the
    seven scalars (finite), the pruned NLL, the sizes used, active-unit
    counts, the estimator diagnostics and both stage timers; the eval batch
    is clamped to a divisor of the 256 synthetic test rows."""
    arch = dict(n_hidden_encoder=(16, 12), n_latent_encoder=(8, 5),
                n_hidden_decoder=(12, 16), n_latent_decoder=(8, 784))
    cfg = dataclasses.replace(
        zoo.get("northstar-iwae-2l-k50"), k=3, batch_size=32,
        data_dir="/nonexistent", n_stages=2, eval_k=4, nll_k=40,
        nll_chunk=16, eval_batch_size=100, activity_samples=20,
        log_dir=str(tmp_path / "runs"), checkpoint_dir=str(tmp_path / "ckpt"),
        **arch)
    _, history = zoo.train(cfg, device="cpu", max_batches_per_pass=2)
    assert [h["stage"] for h in history] == [1, 2]
    for row in history:
        for name in tmet.SCALAR_NAMES + ("LL_pruned",):
            assert np.isfinite(row[name]), name
        assert row["eval_batch"] == 64.0 and row["nll_chunk"] == 10.0
        assert len(row["number_of_active_units"]) == 2
        assert np.isfinite(row["diag/ess"]) and \
            np.isfinite(row["diag/grad_snr_enc"])
        assert row["stage_train_seconds"] > 0 and \
            row["stage_eval_seconds"] > 0
        # the k=40 bound is at least as tight as the k=4 one, up to noise
        assert row["NLL"] <= -row["IWAE"] + 5.0


def test_experiment_config_eval_fields_match_jax():
    cfg, jcfg = ExperimentConfig(), JConfig()
    for name in ("eval_k", "nll_k", "nll_chunk", "eval_batch_size",
                 "activity_samples"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    # one threshold serves both active-unit counts, as the JAX defaults do
    assert tact.ACTIVE_THRESHOLD == \
        jdiag.DiagnosticsConfig().active_threshold == \
        inspect.signature(jact.active_units).parameters["threshold"].default
