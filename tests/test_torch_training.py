"""The port's training path (``training/``, ``experiment.py``,
``zoo.train``, ``data/``) against the JAX package: three Adam steps with a
stage-boundary learning-rate change, one whole epoch with replayed draws, the
Burda stage table, the output bias, the staged training loop and objective
switching. Everything runs on the CPU at test widths."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.data import loaders as jloaders
from iwae_replication_project_tpu.objectives import ObjectiveSpec as JSpec
from iwae_replication_project_tpu.training import epoch as jepoch
from iwae_replication_project_tpu.training import schedule as jschedule
from iwae_replication_project_tpu.training import train_step as jtrain
from iwae_replication_project_tpu.telemetry.diagnostics import (
    DiagnosticsConfig as JDiag,
)
from iwae_replication_project_tpu_torch import zoo
from iwae_replication_project_tpu_torch.convert import params_from_numpy
from iwae_replication_project_tpu_torch.data import loaders as tloaders
from iwae_replication_project_tpu_torch.experiment import run_experiment
from iwae_replication_project_tpu_torch.models import iwae as tmodel
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
    DiagnosticsConfig,
)
from iwae_replication_project_tpu_torch.training import epoch as tepoch
from iwae_replication_project_tpu_torch.training import schedule as tschedule
from iwae_replication_project_tpu_torch.training import train_step as ttrain
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves, tree_map
from torch_parity import (
    D,
    assert_leaves_close,
    binary_rows,
    configs,
    encode_noise,
    epoch_draws,
    train_step_keys,
)

LR, ADAM_EPS = 1e-3, 1e-4
#: fp32 gradient elements agree with JAX to 5.6e-6 at worst over every
#: objective at these widths (test_torch_objectives.py); allow 2e-5
GRAD_ATOL = 2e-5
#: Adam moves a parameter by lr * m / (sqrt(v) + eps), so a gradient error
#: of d moves it by at most (lr / eps) * d; n steps add up to n times that
PARAM_ATOL_PER_STEP = (LR / ADAM_EPS) * GRAD_ATOL
LOSS_ATOL = 5e-5


def _port_state(jstate, lr=LR):
    """A port TrainState holding the JAX state's parameters and a fresh
    Adam, as ``create_train_state`` would build it."""
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jstate.params),
                           "cpu")
    tp = tree_map(lambda t: t.requires_grad_(True), tp)
    return ttrain.TrainState(
        params=tp, optimizer=ttrain.make_adam(tree_leaves(tp), lr, ADAM_EPS),
        generator=torch.Generator().manual_seed(0))


def _jax_leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("name,k2", [("IWAE", 1), ("DReG", 1), ("PIWAE", 2)])
def test_three_adam_steps_match_jax(name, k2):
    """Three steps from the same parameters on replayed noise, with the
    learning rate changed before the third (the moments carry over)."""
    jcfg, tcfg = configs(2)
    k, batch = 4, 6
    jspec = JSpec(name=name, k=k, k2=k2)
    jstate = jtrain.create_train_state(jax.random.PRNGKey(1), jcfg, lr=LR,
                                       optimizer=jtrain.make_adam(LR))
    tstate = _port_state(jstate)
    jstep = jax.jit(jtrain.make_train_step_fn(jspec, jcfg,
                                              jtrain.make_adam(LR)))
    tstep = ttrain.make_train_step(ObjectiveSpec(name=name, k=k, k2=k2), tcfg)
    subkeys, _ = train_step_keys(jstate.key, 3)
    for i, sub in enumerate(subkeys):
        x = binary_rows(batch, seed=10 + i)
        if i == 2:
            jstate = jtrain.set_learning_rate(jstate, LR / 3)
            before = [tstate.optimizer.state[p]["exp_avg"].clone()
                      for p in tree_leaves(tstate.params)]
            ttrain.set_learning_rate(tstate, LR / 3)
            after = [tstate.optimizer.state[p]["exp_avg"]
                     for p in tree_leaves(tstate.params)]
            assert all(torch.equal(a, b) for a, b in zip(before, after))
            assert tstate.optimizer.param_groups[0]["lr"] == LR / 3
        jstate, jm = jstep(jstate, jnp.asarray(x))
        eps = [torch.from_numpy(e) for e in encode_noise(jcfg, sub, k, batch)]
        tstate, tm = tstep(tstate, torch.from_numpy(x), eps=eps)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert tstate.step == 3 and int(jstate.step) == 3
    want = _jax_leaves(jstate.params)
    assert_leaves_close(tree_leaves(tstate.params), want, rel=0.0,
                        floor=3 * PARAM_ATOL_PER_STEP, what="params")
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(want, _jax_leaves(
                    jtrain.create_train_state(jax.random.PRNGKey(1), jcfg)
                    .params)))
    # each step moves a parameter by up to ~lr: more than the tolerance
    assert moved > 3 * PARAM_ATOL_PER_STEP
    mu = _jax_leaves(jstate.opt_state.inner_state[0].mu)
    assert_leaves_close([tstate.optimizer.state[p]["exp_avg"]
                         for p in tree_leaves(tstate.params)], mu, rel=0.0,
                        floor=GRAD_ATOL, what="first moments")


@pytest.mark.parametrize("binarize,diag", [(False, False), (True, True)])
def test_one_epoch_matches_jax(binarize, diag):
    """One pass of n_train=40, batch 10 (4 steps) with JAX's permutation,
    per-step noise and, with stochastic binarization, its uniforms replayed
    (epoch.py:80-92): losses, parameters and, with diagnostics, the
    gradient-SNR scalars agree."""
    jcfg, tcfg = configs(2)
    k, n_train, batch = 4, 40, 10
    rs = np.random.RandomState(3)
    x = (rs.rand(n_train, D) if binarize
         else rs.rand(n_train, D) > 0.5).astype(np.float32)
    jstate = jtrain.create_train_state(jax.random.PRNGKey(2), jcfg, lr=LR,
                                       optimizer=jtrain.make_adam(LR))
    tstate = _port_state(jstate)
    perm, noise, uniforms = epoch_draws(jcfg, jstate.key, n_train, batch, k,
                                        binarize=binarize)
    jfn = jepoch.make_epoch_fn(JSpec(name="IWAE", k=k), jcfg, n_train, batch,
                               stochastic_binarization=binarize,
                               optimizer=jtrain.make_adam(LR), donate=False,
                               diagnostics=JDiag(snr_window=3) if diag
                               else None)
    tfn = tepoch.make_epoch_fn(ObjectiveSpec(name="IWAE", k=k), tcfg, n_train,
                               batch, stochastic_binarization=binarize,
                               diagnostics=DiagnosticsConfig(snr_window=3)
                               if diag else None)
    jstate, jout = jfn(jstate, jnp.asarray(x))
    tstate, tout = tfn(tstate, torch.from_numpy(x), perm=perm, noise=noise,
                       uniforms=uniforms)
    if diag:
        (jl, jd), (tl, td) = jout, tout
        assert set(td) == set(jd)
        for key in jd:
            # a mean of |mean| / std over 3 steps: the gradients' relative
            # error, amplified where a parameter's gradient barely varies
            assert abs(float(td[key]) - float(jd[key])) <= \
                1e-3 * abs(float(jd[key]))
    else:
        jl, tl = jout, tout
    assert tl.shape == (n_train // batch,)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOSS_ATOL,
                               rtol=0)
    assert_leaves_close(tree_leaves(tstate.params), _jax_leaves(jstate.params),
                        rel=0.0, floor=(n_train // batch)
                        * PARAM_ATOL_PER_STEP, what="params")


def test_epoch_draws_on_the_device_stream(monkeypatch):
    """Without injected draws the epoch shuffles and binarizes from the
    state's generator: each pass visits distinct rows, binarized batches
    are {0, 1} with the pixel probabilities as their mean."""
    seen = []

    def fake_make_train_step(spec, cfg):
        def step(state, batch, eps=None):
            seen.append(batch.clone())
            state.step += 1
            return state, {"loss": batch.sum(), "grads": None}
        return step

    monkeypatch.setattr(tepoch, "make_train_step", fake_make_train_step)
    _, tcfg = configs(1)
    n_train, batch = 400, 50
    x = torch.arange(n_train, dtype=torch.float32)[:, None].repeat(1, D)
    state = ttrain.TrainState(params=None, optimizer=None,
                              generator=torch.Generator().manual_seed(5))
    fn = tepoch.make_epoch_fn(ObjectiveSpec(name="IWAE", k=2), tcfg, n_train,
                              batch)
    state, losses = fn(state, x)
    rows = torch.cat([b[:, 0] for b in seen])
    assert len(set(rows.tolist())) == n_train and state.step == 8
    assert losses.shape == (8,)
    seen.clear()
    p = torch.full((n_train, D), 0.3)
    fn = tepoch.make_epoch_fn(ObjectiveSpec(name="IWAE", k=2), tcfg, n_train,
                              batch, stochastic_binarization=True)
    fn(state, p)
    vals = torch.cat(seen)
    assert set(vals.unique().tolist()) <= {0.0, 1.0}
    # 8000 Bernoulli(0.3) draws: the mean's standard error is 0.005
    assert abs(float(vals.mean()) - 0.3) < 0.03


def test_burda_stages_match_jax():
    assert tschedule.burda_stages(8) == jschedule.burda_stages(8)
    assert sum(n for _, _, n in tschedule.burda_stages(8)) == 3280
    assert tschedule.burda_stages(8, 0.2) == jschedule.burda_stages(8, 0.2)


def test_output_bias_from_pixel_means():
    """The data layer's output bias (logit of the clipped pixel means)
    matches JAX's and becomes the initial output bias."""
    ds = tloaders.load_dataset("binarized_mnist", data_dir="/nonexistent",
                               synthetic_sizes=(64, 16))
    jds = jloaders.load_dataset("binarized_mnist", data_dir="/nonexistent",
                                synthetic_sizes=(64, 16))
    assert ds.synthetic and np.array_equal(ds.x_train, jds.x_train)
    np.testing.assert_array_equal(ds.output_bias, jds.output_bias)
    means = np.array([0.0, 0.5, 0.999, 1.0], np.float32)
    np.testing.assert_allclose(
        tloaders.output_bias_from_pixel_means(means),
        [np.log(0.001 / 0.999), 0.0, np.log(0.999 / 0.001),
         np.log(0.999 / 0.001)], rtol=1e-5)
    _, tcfg = configs(1)
    bias = np.linspace(-2, 2, D).astype(np.float32)
    state = ttrain.create_train_state(0, tcfg, output_bias=bias, device="cpu")
    np.testing.assert_array_equal(
        state.params["out"]["out"]["b"].detach().numpy(), bias)
    assert all(p.requires_grad for p in tree_leaves(state.params))
    zero = tmodel.init_params(torch.Generator().manual_seed(0), tcfg)
    assert not zero["out"]["out"]["b"].any()


def _tiny(tmp_path, **kw):
    """The flagship preset at test widths, with the per-stage evaluation cut
    to a few samples (nll_k=40, 20 activity samples) to stay fast, logging
    and checkpointing under `tmp_path`."""
    arch = dict(n_hidden_encoder=(16, 12), n_latent_encoder=(8, 5),
                n_hidden_decoder=(12, 16), n_latent_decoder=(8, 784),
                eval_k=4, nll_k=40, nll_chunk=8, activity_samples=20,
                log_dir=str(tmp_path / "runs"),
                checkpoint_dir=str(tmp_path / "ckpt"))
    arch.update(kw)
    return dataclasses.replace(zoo.get("northstar-iwae-2l-k50"), k=3,
                               batch_size=32, data_dir="/nonexistent", **arch)


def test_run_experiment_on_cpu_two_stages(tmp_path):
    state, history = run_experiment(dataclasses.replace(_tiny(tmp_path),
                                                        n_stages=2),
                                    max_batches_per_pass=3, device="cpu")
    assert [h["stage"] for h in history] == [1, 2]
    assert [h["passes"] for h in history] == [1, 3]
    assert [len(h["pass_losses"]) for h in history] == [1, 3]
    assert history[-1]["steps"] == state.step == (1 + 3) * 3
    assert all(np.isfinite(h["pass_losses"]).all() for h in history)
    assert history[0]["learning_rate"] == tschedule.burda_stage_lr(1)
    assert all(np.isfinite(h["diag/grad_snr_enc"]) for h in history)
    assert history[0]["synthetic_data"]
    assert state.optimizer.param_groups[0]["lr"] == \
        tschedule.burda_stage_lr(2)


def test_objective_switching_changes_the_spec(tmp_path):
    cfg = _tiny(tmp_path, switch_stage=2, switch_loss="VAE", switch_k=1,
                n_stages=2, diagnostics=False)
    assert cfg.objective_spec(1) == ObjectiveSpec(name="IWAE", k=3)
    assert cfg.objective_spec(2) == ObjectiveSpec(name="VAE", k=1)
    assert cfg.objective_spec() == cfg.objective_spec(1)
    _, history = zoo.train(cfg, device="cpu", max_batches_per_pass=2)
    assert [(h["objective"], h["k"]) for h in history] == [("IWAE", 3),
                                                           ("VAE", 1)]
    assert "diag/grad_snr" not in history[0]


def test_training_entry_points_need_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.train("northstar-iwae-2l-k50", n_stages=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.create_train_state(0, configs(1)[1])


def test_experiment_config_training_fields_match_jax():
    from iwae_replication_project_tpu.utils.config import (
        ExperimentConfig as JConfig)
    cfg, jcfg = ExperimentConfig(), JConfig()
    for name in ("batch_size", "n_stages", "adam_eps", "diagnostics",
                 "snr_window", "data_dir", "allow_synthetic"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.diagnostics_config() == DiagnosticsConfig(snr_window=50)
    assert ExperimentConfig(diagnostics=False).diagnostics_config() is None
    assert tmodel.ModelConfig.one_layer().n_latent_enc == (50,)
