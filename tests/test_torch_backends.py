"""The port's ``backend=`` switch and eager oracles (``api.FlexibleModel``,
``backends/``) against the JAX package's: dispatch and ``isinstance`` for
all three values, the unknown-backend and typo errors; the port's torch
oracle against JAX's torch oracle (weight-tied, on the same injected draws:
bound and per-leaf gradients), against JAX's ``backend="jax"`` at JAX's
``tests/test_api.py`` tolerances, and against the port's own core on the
same draws; the ``.npz`` weights across backends and packages; the staged
eager driver; the TF2 oracle against JAX's TF2 oracle; and the guidance
error without TensorFlow."""

import ast
import os
import sys

import jax
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.api import FlexibleModel as JFlexibleModel
from iwae_replication_project_tpu.models import iwae as jmodel
from iwae_replication_project_tpu.objectives.estimators import (
    ObjectiveSpec as JObjectiveSpec,
)
from iwae_replication_project_tpu.objectives.gradients import (
    objective_value_and_grad as j_value_and_grad,
)
from iwae_replication_project_tpu_torch.api import (
    CoreFlexibleModel,
    FlexibleModel,
    _to_numpy,
)
from iwae_replication_project_tpu_torch.backends.torch_ref import (
    TorchFlexibleModel,
)
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARCH_1L = ([16], [16], [4], [12])
ARCH_2L = ([8, 6], [6, 8], [5, 3], [5, 12])

#: JAX's own oracle tolerance against its jax path (tests/test_api.py:
#: bound rtol 1e-5 atol 1e-6, per-leaf gradients rtol 2e-3 atol 2e-6)
BOUND_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-3, atol=2e-6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_x(n=8, d=12, seed=1):
    return (np.random.RandomState(seed).rand(n, d) > 0.5).astype(np.float32)


def build(backend="jax", arch=ARCH_1L, **kw):
    if backend != "tf2":
        kw.setdefault("device", "cpu")
    return FlexibleModel(*arch, dataset_bias=None, backend=backend, **kw)


def jbuild(backend="jax", arch=ARCH_1L, **kw):
    return JFlexibleModel(*arch, dataset_bias=None, backend=backend, **kw)


def _jcfg(arch):
    return jmodel.ModelConfig(n_hidden_enc=tuple(arch[0]),
                              n_latent_enc=tuple(arch[2]),
                              n_hidden_dec=tuple(arch[1]),
                              n_latent_dec=tuple(arch[3]),
                              x_dim=arch[3][-1])


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _flat(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

class TestDispatch:
    @pytest.mark.parametrize("backend,cls", [
        ("jax", CoreFlexibleModel), ("torch", TorchFlexibleModel)])
    def test_backend_class_and_isinstance(self, backend, cls):
        m = build(backend)
        assert type(m) is cls
        assert isinstance(m, FlexibleModel)

    def test_default_backend_is_the_core(self):
        m = FlexibleModel(*ARCH_1L, dataset_bias=None, device="cpu")
        assert type(m) is CoreFlexibleModel

    def test_unknown_backend_raises_jaxs_error(self):
        with pytest.raises(ValueError) as mine:
            build("mxnet")
        with pytest.raises(ValueError) as theirs:
            jbuild("mxnet")
        assert str(mine.value) == str(theirs.value)

    @pytest.mark.parametrize("backend", ["jax", "torch"])
    def test_typo_kwargs_rejected(self, backend):
        with pytest.raises(TypeError):
            build(backend, loss_fuction="IWAE")  # codespell:ignore

    @pytest.mark.parametrize("backend", ["jax", "torch"])
    def test_the_card_unless_the_cpu_is_asked_for(self, backend,
                                                  monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FlexibleModel(*ARCH_1L, dataset_bias=None, backend=backend)

    def test_the_oracle_accepts_the_cores_knobs(self):
        m = build("torch", likelihood="logits", compute_dtype="bfloat16",
                  mesh_sp=1)
        assert type(m) is TorchFlexibleModel

    def test_the_oracles_inherit_no_compute_of_the_core(self):
        core_only = set(vars(CoreFlexibleModel)) - set(vars(FlexibleModel))
        for name in core_only:
            assert name in vars(TorchFlexibleModel) or \
                getattr(TorchFlexibleModel, name, None) is None or \
                getattr(TorchFlexibleModel, name) is not \
                getattr(CoreFlexibleModel, name), name
        assert CoreFlexibleModel not in TorchFlexibleModel.__mro__

    def test_the_oracle_imports_nothing_of_the_core(self):
        """torch_ref is independent of the core: no import of ops/,
        models/, objectives/ or training/ (so it never launches a hand
        kernel)."""
        path = os.path.join(REPO, "iwae_replication_project_tpu_torch",
                            "backends", "torch_ref.py")
        mods = set()
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module)
            elif isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
        port = "iwae_replication_project_tpu_torch."
        assert {m for m in mods if m.startswith(port)} == {
            port + "api", port + "utils.device", port + "utils.sizes",
            port + "utils.tree"}

    def test_serving_is_the_cores(self):
        with pytest.raises(NotImplementedError, match="backend='jax'"):
            build("torch").compile().serving_engine()


# ---------------------------------------------------------------------------
# the port's oracle against JAX's oracle and JAX's jax path, weight-tied on
# the same realized draws
# ---------------------------------------------------------------------------

def _tied(arch, name, k, k2, seed=0):
    """JAX params, their draws' latents, and the JAX estimator's
    ``(bound, grads)`` on one batch."""
    cfg = _jcfg(arch)
    params = jmodel.init_params(jax.random.PRNGKey(seed), cfg)
    x = make_x(4, arch[3][-1], seed=2)
    dkey = jax.random.PRNGKey(7)
    jbound, jgrads = j_value_and_grad(JObjectiveSpec(name, k=k, k2=k2),
                                      params, cfg, dkey, jax.numpy.asarray(x))
    _, aux = jmodel.log_weights_and_aux(params, cfg, dkey,
                                        jax.numpy.asarray(x), k)
    h_fixed = [np.asarray(h) for h in aux["h"]]
    return params, x, h_fixed, float(jbound), jgrads


ESTIMATORS = [("STL", 1), ("DReG", 1), ("PIWAE", 3)]


class TestOracleParity:
    @pytest.mark.parametrize("name,k2", ESTIMATORS)
    def test_bitwise_the_jax_packages_torch_oracle(self, name, k2):
        """Both oracles are eager torch on the CPU with the same
        arithmetic: on tied weights and the same replayed draws they agree
        bit for bit (the tolerance found: 0)."""
        params, x, h, _, _ = _tied(ARCH_2L, name, 6, k2)
        mine = build("torch", arch=ARCH_2L).compile()
        mine.load_jax_params(_np_tree(params))
        theirs = jbuild("torch", arch=ARCH_2L).compile()
        theirs.load_jax_params(params)
        b1, g1 = mine.estimator_gradients_as_jax_tree(x, name, 6, k2=k2,
                                                      h_fixed=h)
        b2, g2 = theirs.estimator_gradients_as_jax_tree(x, name, 6, k2=k2,
                                                        h_fixed=h)
        assert b1 == b2
        assert jax.tree.structure(g1) == jax.tree.structure(g2)
        for a, b in zip(_flat(g1), _flat(g2)):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("name,k2", ESTIMATORS + [("IWAE", 1)])
    def test_jax_path_parity_at_jaxs_tolerances(self, name, k2):
        """The port's oracle against JAX's hand-rolled cotangents (and, for
        IWAE, JAX's autodiff of the bound) on the draws JAX sampled."""
        params, x, h, jbound, jgrads = _tied(ARCH_2L, name, 6, k2)
        mine = build("torch", arch=ARCH_2L).compile()
        mine.load_jax_params(_np_tree(params))
        tbound, tgrads = mine.estimator_gradients_as_jax_tree(
            x, name, 6, k2=k2, h_fixed=h)
        np.testing.assert_allclose(jbound, tbound, **BOUND_TOL)
        assert jax.tree.structure(jgrads) == jax.tree.structure(tgrads)
        jl = _flat(jgrads)
        assert any(np.abs(g).max() > 1e-8 for g in jl)
        for jg, tg in zip(jl, _flat(tgrads)):
            np.testing.assert_allclose(jg, tg, **GRAD_TOL)

    @pytest.mark.parametrize("name", ["IWAE", "DReG"])
    def test_the_cores_gradients_on_the_same_draws(self, name):
        """The port's core (``objective_value_and_grad`` on injected noise,
        clamp, fp32) against its oracle on the latents the core drew: the
        card's phase 17 comparison, here on the CPU, at JAX's tolerances."""
        from iwae_replication_project_tpu_torch.models import iwae as tmodel
        from iwae_replication_project_tpu_torch.objectives.gradients import (
            objective_value_and_grad)

        core = build("jax", arch=ARCH_2L, loss_function=name, k=6).compile()
        oracle = build("torch", arch=ARCH_2L).compile()
        oracle.load_jax_params(core.params)
        x = torch.as_tensor(make_x(4, 12, seed=3))
        g = torch.Generator().manual_seed(0)
        eps = [torch.randn((6, 4, 5), generator=g),
               torch.randn((6, 4, 3), generator=g)]
        cbound, cgrads = objective_value_and_grad(
            core.objective_spec(), core.params, core.cfg, x, eps=eps)
        h, _, _ = tmodel.encode(core.params, core.cfg, x, 6, eps=eps)
        obound, ograds = oracle.estimator_gradients_as_jax_tree(
            x, name, 6, h_fixed=[t.detach() for t in h])
        np.testing.assert_allclose(float(cbound), obound, **BOUND_TOL)
        for cg, og in zip(tree_leaves(cgrads), _flat(ograds)):
            np.testing.assert_allclose(cg.numpy(), og, **GRAD_TOL)

    def test_dreg_encoder_grad_differs_from_stl(self):
        params, x, h, _, _ = _tied(ARCH_2L, "STL", 6, 1)
        m = build("torch", arch=ARCH_2L).compile()
        m.load_jax_params(_np_tree(params))
        _, stl = m.estimator_gradients_as_jax_tree(x, "STL", 6, h_fixed=h)
        _, dreg = m.estimator_gradients_as_jax_tree(x, "DReG", 6, h_fixed=h)
        assert not np.allclose(stl["enc"][0]["l1"]["w"],
                               dreg["enc"][0]["l1"]["w"])
        np.testing.assert_array_equal(stl["out"]["out"]["w"],
                                      dreg["out"]["out"]["w"])

    def test_replayed_draws_must_match_the_shapes(self):
        m = build("torch", arch=ARCH_2L).compile()
        with pytest.raises(ValueError, match="h_fixed"):
            m.estimator_gradients_as_jax_tree(
                make_x(4), "IWAE", 6, h_fixed=[np.zeros((5, 4, 5))] * 2)


class TestOracleSurface:
    def test_reference_method_surface_and_training(self):
        m = build("torch", loss_function="IWAE", k=4, seed=0).compile()
        x = make_x()
        assert tuple(m.get_log_weights(x, 3).shape) == (3, 8)
        for val in (m.get_L(x, 6), m.get_L_k(x, 4), m.get_L_V1(x, 4),
                    m.get_L_alpha(x, 4, 0.5), m.get_L_power_p(x, 4, 2.0),
                    m.get_L_median(x, 4), m.get_L_CIWAE(x, 4, 0.3),
                    m.get_L_MIWAE(x, 2, 2), m.get_NLL(x, k=8, chunk=4),
                    m.get_E_qhIx_log_pxIh(x, 4), m.get_Dkl_qhIx_ph(x, 4),
                    m.get_reconstruction_loss(x)):
            assert np.isfinite(float(val))
        assert np.isfinite(m.train_step(x)["IWAE"]) and m.epoch == 1
        assert tuple(m.generate(3).shape) == (3, 12)
        res, res2 = m.get_training_statistics(x, 4, batch_size=4, nll_k=8,
                                              nll_chunk=4,
                                              activity_samples=10)
        assert {"VAE", "IWAE", "NLL", "LL_pruned"} <= set(res)
        assert len(res2["number_of_active_units"]) == 1

    def test_same_seed_same_model_and_draws(self):
        x = make_x()
        a = build("torch", seed=3).compile()
        b = build("torch", seed=3).compile()
        assert all(torch.equal(p, q) for p, q in zip(
            a.enc.parameters(), b.enc.parameters()))
        assert float(a.get_L_k(x, 5)) == float(b.get_L_k(x, 5))
        before = torch.random.get_rng_state()
        build("torch", seed=4).compile().get_L(x, 5)
        assert torch.equal(before, torch.random.get_rng_state())  # no global

    def test_fit_epochs_compose_as_jaxs_oracle(self):
        """fit(epochs=2) == fit(epochs=1) twice, batch for batch the JAX
        oracle's shuffle stream (``backends.epoch_batches``)."""
        from iwae_replication_project_tpu.data import epoch_batches as jeb
        from iwae_replication_project_tpu_torch.backends import epoch_batches
        x = np.random.RandomState(0).rand(40, 12).astype(np.float32)
        for e in range(3):
            for b in ("none", "stochastic"):
                for a, c in zip(epoch_batches(x, 10, e, 5, b),
                                jeb(x, 10, epoch=e, seed=5,
                                    binarization=b)):
                    np.testing.assert_array_equal(a, c)
        one = build("torch", loss_function="IWAE", k=3).compile()
        two = build("torch", loss_function="IWAE", k=3).compile()
        h1 = one.fit(x, epochs=2, batch_size=10)
        h2 = two.fit(x, epochs=1, batch_size=10)["loss"] + \
            two.fit(x, epochs=1, batch_size=10)["loss"]
        assert h1["loss"] == h2
        assert one.epoch == 8

    @pytest.mark.parametrize("name", ["DReG", "STL", "PIWAE"])
    def test_modified_estimators_train(self, name):
        m = build("torch", arch=ARCH_2L, loss_function=name, k=6,
                  k2=3 if name == "PIWAE" else 1).compile()
        out = m.train_step(make_x())
        assert np.isfinite(out[name])

    def test_vae_v1_rejects_multilayer(self):
        with pytest.raises(ValueError, match="single-stochastic-layer"):
            build("torch", arch=ARCH_2L).compile().get_L_V1(make_x(), 4)


# ---------------------------------------------------------------------------
# weights across backends and packages
# ---------------------------------------------------------------------------

class TestWeights:
    @pytest.mark.parametrize("src,dst", [
        ("torch", "jax"), ("jax", "torch"), ("torch", "torch")])
    def test_npz_across_the_ports_backends(self, src, dst, tmp_path):
        a = build(src, arch=ARCH_2L, seed=3).compile()
        b = build(dst, arch=ARCH_2L, seed=9).compile()
        out = a.save_weights(str(tmp_path / "w"))
        b.load_weights(out)
        for p, q in zip(tree_leaves(a._weights_tree()),
                        tree_leaves(b._weights_tree())):
            np.testing.assert_array_equal(_to_numpy(p), _to_numpy(q))

    @pytest.mark.parametrize("jax_backend", ["jax", "torch"])
    def test_npz_across_the_packages(self, jax_backend, tmp_path):
        jm = jbuild(jax_backend, arch=ARCH_2L, seed=3).compile()
        path = str(tmp_path / "jax_w")
        jm.save_weights(path)
        mine = build("torch", arch=ARCH_2L, seed=5).compile()
        mine.load_weights(path + ".npz")
        out = mine.save_weights(str(tmp_path / "port_w"))
        back = jbuild(jax_backend, arch=ARCH_2L, seed=7).compile()
        back.load_weights(out)
        for a, b in zip(jax.tree.leaves(jm._weights_pytree()),
                        jax.tree.leaves(back._weights_pytree())):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_oracle_refuses_another_architecture(self, tmp_path):
        out = build("jax", arch=ARCH_2L).compile().save_weights(
            str(tmp_path / "w"))
        with pytest.raises(ValueError, match="architecture mismatch"):
            build("torch", arch=ARCH_1L).compile().load_weights(out)


# ---------------------------------------------------------------------------
# the staged eager driver
# ---------------------------------------------------------------------------

def _tiny_cfg(tmp_path, **kw):
    from iwae_replication_project_tpu_torch.utils.config import (
        ExperimentConfig)
    base = dict(n_hidden_encoder=(16,), n_hidden_decoder=(16,),
                n_latent_encoder=(4,), n_latent_decoder=(784,), k=4,
                batch_size=32, n_stages=2, eval_k=4, nll_k=8, nll_chunk=4,
                activity_samples=10, eval_batch_size=64, backend="torch",
                log_dir=str(tmp_path / "runs"),
                checkpoint_dir=str(tmp_path / "ckpt"))
    base.update(kw)
    return ExperimentConfig(**base)


class TestEagerDriver:
    def test_run_experiment_on_the_torch_oracle(self, tmp_path):
        from iwae_replication_project_tpu_torch.experiment import (
            run_experiment)
        cfg = _tiny_cfg(tmp_path)
        mdl, history = run_experiment(cfg, max_batches_per_pass=2,
                                      device="cpu")
        assert type(mdl) is TorchFlexibleModel
        assert [r["stage"] for r in history] == [1, 2]
        assert [r["passes"] for r in history] == [1, 3]
        assert [r["steps"] for r in history] == [2, 8]
        for r in history:
            assert np.isfinite(r["NLL"]) and r["stage_train_seconds"] > 0
            assert r["bfloat16"] is False
        runs = os.listdir(tmp_path / "runs")
        assert runs == [f"{cfg.run_name()}-torch"]
        assert not (tmp_path / "ckpt").exists()   # no checkpoint, no resume

    def test_the_cli_takes_backend_torch(self, tmp_path, capsys):
        from iwae_replication_project_tpu_torch.experiment import main
        main(["--backend", "torch", "--device", "cpu", "--n-stages", "1",
              "--k", "3", "--hidden-encoder", "8", "--hidden-decoder", "8",
              "--latent-encoder", "3", "--latent-decoder", "784",
              "--batch-size", "256", "--eval-k", "3", "--nll-k", "6",
              "--nll-chunk", "3", "--log-dir", str(tmp_path / "runs"),
              "--checkpoint-dir", str(tmp_path / "ckpt")])
        assert "'NLL'" in capsys.readouterr().out
        (run,) = os.listdir(tmp_path / "runs")
        assert run.endswith("-torch")

    @pytest.mark.parametrize("kw", [{"mesh_sp": 2}, {"multihost": True},
                                    {"mesh_dp": 1}])
    def test_a_mesh_with_an_eager_backend_raises(self, kw, tmp_path):
        from iwae_replication_project_tpu_torch.experiment import (
            run_experiment)
        with pytest.raises(ValueError, match="require backend='jax'"):
            run_experiment(_tiny_cfg(tmp_path, **kw), device="cpu")

    def test_an_unknown_backend_raises_the_facades_error(self, tmp_path):
        from iwae_replication_project_tpu_torch.experiment import (
            run_experiment)
        with pytest.raises(ValueError, match="choose jax|torch|tf2"):
            run_experiment(_tiny_cfg(tmp_path, backend="mxnet"),
                           device="cpu")


# ---------------------------------------------------------------------------
# the TF2 oracle
# ---------------------------------------------------------------------------

class TestTF2:
    def test_against_jaxs_tf2_oracle(self, tmp_path):
        """Same seed, same whole-process TF seeding, same arithmetic: the
        port's TF2 oracle is bitwise JAX's, and their weights files load
        into each other and into the port's torch oracle."""
        pytest.importorskip("tensorflow")
        from iwae_replication_project_tpu_torch.backends.tf2_ref import (
            TF2FlexibleModel)
        x = make_x(6, 12, seed=0)

        def run(make):
            m = make("tf2", arch=ARCH_2L, loss_function="IWAE", k=4,
                     seed=3).compile()
            return m, [float(m.get_L_k(x, 5)), m.train_step(x)["IWAE"],
                       float(m.get_NLL(x, 8, 4))]

        mine, a = run(build)
        theirs, b = run(jbuild)
        assert isinstance(mine, TF2FlexibleModel)
        assert isinstance(mine, FlexibleModel)
        assert a == b
        out = mine.save_weights(str(tmp_path / "tf"))
        theirs.load_weights(out)
        oracle = build("torch", arch=ARCH_2L).compile()
        oracle.load_weights(out)
        for p, q in zip(tree_leaves(mine._weights_tree()),
                        tree_leaves(oracle._weights_tree())):
            np.testing.assert_array_equal(_to_numpy(p), _to_numpy(q))

    def test_tf2_estimators_and_stats(self):
        pytest.importorskip("tensorflow")
        m = build("tf2", arch=ARCH_2L, loss_function="DReG", k=4).compile()
        x = make_x(6, 12, seed=0)
        assert np.isfinite(m.train_step(x)["DReG"])
        res, _ = m.get_training_statistics(x, 4, batch_size=3, nll_k=8,
                                           nll_chunk=4, activity_samples=8)
        assert np.isfinite(res["NLL"])

    def test_guidance_error_without_tensorflow(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "tensorflow", None)
        with pytest.raises(ImportError) as e:
            build("tf2")
        msg = str(e.value)
        assert "requires TensorFlow" in msg
        assert "backend='jax'" in msg and "backend='torch'" in msg
