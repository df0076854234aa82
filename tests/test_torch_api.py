"""The port's ``FlexibleModel`` facade (``api.py``) against the JAX
package's ``JaxFlexibleModel``: the method surface, the weights file both
write and read, the get_L* family within Monte Carlo error on the same
weights, and ``fit`` under a (2, 2) gloo mesh (the port's counterpart of
tests/test_facade_mesh.py)."""

import inspect
import os

import jax
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.api import FlexibleModel as JFlexibleModel
from iwae_replication_project_tpu.backends.jax_backend import JaxFlexibleModel
from iwae_replication_project_tpu_torch.api import (
    CoreFlexibleModel,
    FlexibleModel,
    key_paths,
)
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves
from torch_parity import ARCH, D, binary_rows
import torch_parallel_worker as W

ARCH_1L = ([16], [16], [6], [D])
ARCH_2L = ([16, 12], [12, 16], [8, 5], [8, D])


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(arch=ARCH_1L, **kw):
    return JFlexibleModel(*arch, dataset_bias=None, backend="jax",
                          **kw).compile()


def _port_model(arch=ARCH_1L, **kw):
    return FlexibleModel(*arch, dataset_bias=None, device="cpu",
                         **kw).compile()


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def test_method_surface_is_the_jax_facades():
    # the shared base and the backend="jax" class, each against JAX's
    assert _public(FlexibleModel) == _public(JFlexibleModel)
    assert _public(CoreFlexibleModel) == _public(JaxFlexibleModel)
    # the reference's constructor order and defaults
    want = inspect.signature(JFlexibleModel.__init__).parameters
    got = inspect.signature(FlexibleModel.__init__).parameters
    positional = [n for n, p in want.items()
                  if p.kind is p.POSITIONAL_OR_KEYWORD]
    assert [n for n, p in got.items()
            if p.kind is p.POSITIONAL_OR_KEYWORD] == positional
    for name in positional[6:]:  # after self, the 4 lists, dataset_bias
        assert got[name].default == want[name].default, name
    jk = inspect.signature(JaxFlexibleModel.__init__).parameters
    ck = inspect.signature(CoreFlexibleModel.__init__).parameters
    for name in ("likelihood", "compute_dtype", "mesh", "mesh_sp"):
        assert ck[name].default == jk[name].default, name
    for name in ("k2", "seed", "data_dir", "pixel_means", "bias"):
        assert got[name].default == want[name].default, name


def test_facade_defaults_run_no_kernel():
    mdl = FlexibleModel(*ARCH_2L, dataset_bias=None, device="cpu")
    assert mdl.cfg.likelihood == "clamp" and mdl.cfg.compute_dtype is None
    assert not mdl.cfg.fused_likelihood


@pytest.mark.parametrize("arch", [ARCH_1L, ARCH_2L], ids=["1l", "2l"])
def test_key_paths_are_jax_keystr(arch):
    jm = _jax_model(arch)
    tm = _port_model(arch)
    flat, _ = jax.tree_util.tree_flatten_with_path(jm.params)
    assert key_paths(tm.params) == [jax.tree_util.keystr(kp)
                                    for kp, _ in flat]


def test_npz_written_by_jax_loads_into_the_port_and_back(tmp_path):
    jm = _jax_model(ARCH_2L, seed=3)
    path = str(tmp_path / "jax_weights")
    jm.save_weights(path)
    tm = _port_model(ARCH_2L, seed=11)
    tm.load_weights(path)
    for t, j in zip(tree_leaves(tm.params),
                    jax.tree_util.tree_leaves(jm.params)):
        assert np.array_equal(t.detach().numpy(), np.asarray(j))
    out = tm.save_weights(str(tmp_path / "port_weights.npz"))
    back = _jax_model(ARCH_2L, seed=5)
    back.load_weights(out)
    for a, b in zip(jax.tree_util.tree_leaves(back.params),
                    jax.tree_util.tree_leaves(jm.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # and the port reads its own file bitwise
    again = _port_model(ARCH_2L, seed=1)
    again.load_weights(out)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again.params),
                                                 tree_leaves(tm.params)))


@pytest.mark.parametrize("other", [
    ([16], [16], [7], [D]), ARCH_2L, ([17], [16], [6], [D])],
    ids=["latent", "depth", "hidden"])
def test_mismatched_architecture_is_refused(other, tmp_path):
    jm = _jax_model(other)
    path = str(tmp_path / "w.npz")
    jm.save_weights(path)
    tm = _port_model(ARCH_1L)
    before = [t.clone() for t in tree_leaves(tm.params)]
    with pytest.raises(ValueError, match="architecture mismatch"):
        tm.load_weights(path)
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 tree_leaves(tm.params)))
    # the JAX facade refuses the port's file alike
    out = tm.save_weights(str(tmp_path / "port.npz"))
    with pytest.raises(ValueError, match="architecture mismatch"):
        _jax_model(other).load_weights(out)


def test_legacy_pickle_is_refused(tmp_path):
    path = tmp_path / "old.pkl"
    path.write_bytes(b"not read")
    with pytest.raises(ValueError, match="legacy pickle"):
        _port_model().load_weights(str(path))


#: (method, args) of the bounds family, at k=400 on 32 rows
METHODS = [("get_L", (400,)), ("get_L_k", (400,)), ("get_L_V1", (400,)),
           ("get_L_alpha", (400, 0.3)), ("get_L_power_p", (400, 2.0)),
           ("get_L_median", (400,)), ("get_L_CIWAE", (400, 0.25)),
           ("get_L_MIWAE", (40, 10)), ("get_NLL", (400, 100)),
           ("get_E_qhIx_log_pxIh", (400,)), ("get_Dkl_qhIx_ph", (400,)),
           ("get_reconstruction_loss", ())]
REPEATS = 4


@pytest.fixture(scope="module")
def same_weights(tmp_path_factory):
    jm = _jax_model(ARCH_1L, seed=2)
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    jm.save_weights(path)
    tm = _port_model(ARCH_1L, seed=9)
    tm.load_weights(path)
    return jm, tm, binary_rows(32, seed=4)


@pytest.mark.parametrize("method,args", METHODS, ids=[m for m, _ in METHODS])
def test_bounds_family_agrees_with_jax_within_monte_carlo_error(
        method, args, same_weights):
    """Different draws (threefry against torch's generators) on the same
    weights: each package's mean over 4 calls agrees with the other's
    within 4 standard errors of the difference (from the calls' own
    spread), plus 1e-3 nats for the estimators whose spread is ~0."""
    jm, tm, x = same_weights
    got = [float(getattr(tm, method)(x, *args)) for _ in range(REPEATS)]
    want = [float(getattr(jm, method)(x, *args)) for _ in range(REPEATS)]
    assert np.all(np.isfinite(got))
    se = np.sqrt(np.var(got, ddof=1) / REPEATS
                 + np.var(want, ddof=1) / REPEATS)
    assert abs(np.mean(got) - np.mean(want)) <= 4 * se + 1e-3, \
        (method, got, want)


def test_activity_statistics_and_generate(same_weights):
    jm, tm, x = same_weights
    res, res2 = tm.get_training_statistics(x, 8, batch_size=16, nll_k=40,
                                           nll_chunk=20, activity_samples=20)
    jres, jres2 = jm.get_training_statistics(x, 8, batch_size=16, nll_k=40,
                                             nll_chunk=20,
                                             activity_samples=20)
    assert set(res) == set(jres)
    assert res["eval_batch"] == jres["eval_batch"] == 16
    assert abs(res["NLL"] - jres["NLL"]) < 5.0
    variances, eig = tm.get_levels_of_units_activity(x, 50)
    masks, n_active, _ = tm.get_active_units(variances, eig)
    assert masks[0].shape == (6,) and int(n_active[0]) >= 0
    with pytest.raises(ValueError, match="threshold"):
        tm.get_active_units(variances, eig, threshold=0.5)
    assert np.isfinite(float(tm.get_NLL_without_inactive_units(
        x, n_samples=40, activity_samples=20)))
    probs = tm.generate(5)
    assert probs.shape == (5, D) and bool(((probs > 0) & (probs < 1)).all())
    assert tm.reconstructed_x_probs(x).shape == (1, 32, D)


def test_train_step_and_fit_on_one_device(tmp_path):
    tm = _port_model(ARCH_2L, loss_function="IWAE", k=4)
    x = np.random.RandomState(0).rand(40, D).astype(np.float32)
    out = tm.train_step(x[:10])
    assert set(out) == {"IWAE"} and np.isfinite(out["IWAE"])
    hist = tm.fit(x, epochs=2, batch_size=10, binarization="stochastic")
    assert len(hist["loss"]) == 2 and tm.epoch == 1 + 8
    tm.set_learning_rate(5e-4)
    assert tm.state.optimizer.param_groups[0]["lr"] == 5e-4
    tm.tensorboard_log({"NLL": 1.0}, epoch_n=1, logdir=str(tmp_path))
    assert os.path.exists(tmp_path / "IWAE-2L-k_4" / "metrics.jsonl")
    eng = tm.serving_engine()
    assert eng.k == 4


def test_fit_under_a_2x2_mesh_is_the_parallel_epoch_bitwise(tmp_path):
    """``fit`` on a (2, 2) gloo mesh runs one parallel epoch function call
    per epoch: the same losses and parameter bits as driving
    make_parallel_epoch_fn from the same seed (tests/test_facade_mesh.py's
    contract for JAX)."""
    a = ARCH[2]
    payload = dict(dp=2, sp=2, batch=10, k=4, seed=3,
                   arch=(a["n_hidden_enc"], a["n_hidden_dec"],
                         a["n_latent_enc"], a["n_latent_dec"]),
                   x=np.random.RandomState(1).rand(40, D).astype(np.float32))
    ranks = W.launch("facade", 4, payload, tmp_path)
    for res in ranks:
        fit_losses, direct_losses, fit_params, direct_params = res["fit"]
        assert fit_losses == direct_losses
        assert all(torch.equal(p, q) for p, q in zip(fit_params,
                                                     direct_params))
        assert np.isfinite(res["step"]["IWAE"]) and res["epoch"] == 9
        assert res["fit"][0] == ranks[0]["fit"][0]
