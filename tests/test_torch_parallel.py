"""The port's data and sample parallelism (``parallel/``) against the JAX
package's, on the CPU.

The ranks are gloo worlds of 2 or 4 processes spawned with
``parallel.multihost.spawn`` (tests/torch_parallel_worker.py, which imports
no JAX); the JAX side runs on conftest's 8-device fake mesh, on the first
``dp x sp`` devices. The parent rebuilds each mesh coordinate's draws from
JAX's folded keys (``parallel/dp.py:237-240``) and injects them into that
rank. Each world runs several cases, and its results are shared by the
tests that read them (``--dist loadfile`` keeps a file on one worker).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.objectives import ObjectiveSpec as JSpec
from iwae_replication_project_tpu.parallel import dp as jdp
from iwae_replication_project_tpu.parallel import eval as jeval
from iwae_replication_project_tpu.parallel import make_mesh as jmake_mesh
from iwae_replication_project_tpu.training import train_step as jtrain
from iwae_replication_project_tpu_torch.models import iwae as tmodel
from iwae_replication_project_tpu_torch.objectives import (
    ObjectiveSpec,
    objective_value_and_grad,
)
from iwae_replication_project_tpu_torch.ops import logsumexp as tlse
from iwae_replication_project_tpu_torch.parallel import dp as pdp
from iwae_replication_project_tpu_torch.parallel import make_mesh
from iwae_replication_project_tpu_torch.parallel.mesh import Mesh
from iwae_replication_project_tpu_torch.training import epoch as tepoch
from iwae_replication_project_tpu_torch.training import train_step as ts
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves
from torch_parity import (
    ARCH,
    D,
    assert_leaves_close,
    binary_rows,
    configs,
    decode_noise,
    encode_noise,
    params,
)
import torch_parallel_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = [(2, 1), (1, 2), (2, 2)]
#: the 11 objectives with their hyperparameters; sp=2 divides k2
OBJECTIVES = [("VAE", {}), ("IWAE", {}), ("VAE_V1", {}),
              ("L_alpha", {"alpha": 0.3}), ("CIWAE", {"beta": 0.25}),
              ("L_power_p", {"p": 2.0}), ("L_median", {}),
              ("MIWAE", {"k2": 2}), ("PIWAE", {"k2": 2}), ("DReG", {}),
              ("STL", {})]
K, BATCH = 8, 8
LR, ADAM_EPS = 1e-3, 1e-4

#: the mesh's value-and-grad against JAX's, fp32 at test widths: each
#: gradient leaf within 1e-5 of its largest magnitude plus 2e-5 (the bound
#: of the single-device parity, test_torch_training.py's GRAD_ATOL; the
#: partials are summed over sp and dp in another order than JAX's pmean
#: of pmeans, ~1e-7 relative); the bound within 5e-5 nats
GRAD_REL, GRAD_FLOOR, BOUND_ATOL = 1e-5, 2e-5, 5e-5
#: a pass of 4 Adam steps: each moves a parameter by at most (lr / eps) x
#: the gradient error, so 4 x 1e-2 x 2e-5 (test_torch_training.py)
PARAM_ATOL = 4 * (LR / ADAM_EPS) * GRAD_FLOOR
LOSS_ATOL = 5e-5
#: the eval scalars (test_torch_evaluation.py's fp32 SCALAR_TOL and
#: MOMENT_TOL): the same arithmetic on the same draws, summed in another
#: order over the ranks
SCALAR_ATOL, SCALAR_RTOL = 1e-4, 1e-5
MOMENT_ATOL, MOMENT_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jmesh(dp, sp):
    return jmake_mesh(dp, sp, devices=jax.devices()[:dp * sp])


def _coord_key(key, i_dp, i_sp):
    """JAX's per-coordinate key (dp.py:237-240)."""
    return jax.random.fold_in(jax.random.fold_in(key, i_dp), i_sp)


def _case(name, kw, layers):
    jcfg, tcfg = configs(layers)
    jp, _ = params(jcfg, seed=layers)
    case = dict(name=name, k=K, k2=kw.get("k2", 1), p=kw.get("p", 1.0),
                alpha=kw.get("alpha", 1.0), beta=kw.get("beta", 0.5))
    return case, jcfg, jp


# --------------------------------------------------------------------------
# the value-and-grad on every mesh, for every objective
# --------------------------------------------------------------------------

_VG = {}


def _value_and_grad_world(dp, sp, tmp_dir):
    """One world per mesh: every objective's port result and JAX's."""
    if (dp, sp) in _VG:
        return _VG[(dp, sp)]
    key = jax.random.PRNGKey(7)
    x = binary_rows(BATCH, seed=11)
    jmesh = _jmesh(dp, sp)
    cases, want = [], []
    for name, kw in OBJECTIVES:
        layers = 1 if name == "VAE_V1" else 2
        case, jcfg, jp = _case(name, kw, layers)
        case["cfg"] = dict(ARCH[layers], x_dim=D, likelihood="logits")
        case["params"] = _np_tree(jp)
        case["eps"] = {(i, j): encode_noise(jcfg, _coord_key(key, i, j),
                                            K // sp, BATCH // dp)
                       for i in range(dp) for j in range(sp)}
        cases.append(case)
        jspec = JSpec(**{k: case[k] for k in ("name", "k", "k2", "p",
                                               "alpha", "beta")})
        fn = jdp.make_parallel_value_and_grad(jspec, jcfg, jmesh, BATCH)
        bound, grads = fn(jp, key, jdp.shard_batch(jmesh, jnp.asarray(x)))
        want.append((float(bound),
                     [np.asarray(g) for g in jax.tree_util.tree_leaves(
                         grads)]))
    payload = dict(dp=dp, sp=sp, x=x, cases=cases)
    if (dp, sp) == (2, 2):
        payload["bad_meshes"] = [(3, 1), (4, 2), (None, 3), (1, 2)]
        payload["host_local"] = True
    if sp == 2:
        rs = np.random.RandomState(5)
        payload["lse"] = [(rs.randn(6, 3) * 4).astype(np.float32)
                          for _ in range(2)]
    _VG[(dp, sp)] = (W.launch("value_and_grad", dp * sp, payload, tmp_dir),
                     want, payload)
    return _VG[(dp, sp)]


@pytest.mark.parametrize("name", [n for n, _ in OBJECTIVES])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}-sp{m[1]}")
def test_parallel_value_and_grad_matches_jax(mesh, name, tmp_path_factory):
    ranks, want, _ = _value_and_grad_world(*mesh, tmp_path_factory.mktemp(
        "vg"))
    i = [n for n, _ in OBJECTIVES].index(name)
    wb, wg = want[i]
    for r, res in enumerate(ranks):
        bound, grads = res["cases"][i]
        assert abs(bound - wb) <= BOUND_ATOL, (r, bound, wb)
        assert_leaves_close(grads, wg, rel=GRAD_REL, floor=GRAD_FLOOR,
                            what=f"{name} {mesh} rank {r}")
        # the reduced result is the same bits on every rank
        assert bound == ranks[0]["cases"][i][0]
        assert all(torch.equal(a, b) for a, b in
                   zip(grads, ranks[0]["cases"][i][1]))


def test_lse_var_carry_merges_over_sp(tmp_path_factory):
    ranks, _, payload = _value_and_grad_world(1, 2, tmp_path_factory.mktemp(
        "vg"))
    states = [tlse.online_lse_var_update(tlse.online_lse_var_init((3,)),
                                         torch.from_numpy(a))
              for a in payload["lse"]]
    want = tlse.online_lse_var_merge(*states)
    for res in ranks:
        m, s, s2, n = res["lse"]
        assert torch.equal(m, want.m) and n == want.n == 12
        np.testing.assert_allclose(s.numpy(), want.s.numpy(), rtol=1e-6)
        np.testing.assert_allclose(s2.numpy(), want.s2.numpy(), rtol=1e-6)
        # the sharded log-mean-exp is the one over the whole k axis
        full = torch.from_numpy(np.concatenate(payload["lse"]))
        np.testing.assert_allclose(
            res["dlme"].numpy(), tlse.logmeanexp(2.0 * full, dim=0).numpy(),
            rtol=1e-6)


def test_host_local_batches_hold_b_over_dp_rows(tmp_path_factory):
    ranks, _, _ = _value_and_grad_world(2, 2, tmp_path_factory.mktemp("vg"))
    for res in ranks:
        assert res["fed"]
        assert "ranks hold 3 to 4 rows" in res["uneven"]


def test_make_mesh_errors(tmp_path_factory):
    """Sizes the world cannot hold raise ValueError, as JAX's make_mesh
    does (mesh.py:60-65); a world of one needs no process group."""
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="sp=2 must divide the world size"):
        make_mesh(None, 2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh(0, 1, device="cpu")
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        jmake_mesh(16, 1)
    one = make_mesh(device="cpu")
    assert (one.dp, one.sp, one.rank, one.device_mesh) == (1, 1, 0, None)
    t = torch.ones(3)
    assert one.all_reduce(t, "max") is t and torch.equal(t, torch.ones(3))
    ranks, _, _ = _value_and_grad_world(2, 2, tmp_path_factory.mktemp("vg"))
    for res in ranks:
        assert len(res["errors"]) == 4
        e31, e42, e_3, e12 = res["errors"]
        assert "takes 3 of the 4 ranks" in e31
        assert "mesh 4x2 needs 8 ranks, have 4" in e42
        assert "sp=3 must divide the world size 4" in e_3
        assert "takes 2 of the 4 ranks" in e12


@pytest.mark.parametrize("spec,batch", [
    (ObjectiveSpec(name="IWAE", k=3), 4), (ObjectiveSpec(name="MIWAE", k=4,
                                                         k2=1), 4),
    (ObjectiveSpec(name="IWAE", k=4), 3)])
def test_sharding_validation_errors_match_jax(spec, batch):
    mesh = Mesh(dp=2, sp=2, rank=0, device=torch.device("cpu"))
    jspec = JSpec(name=spec.name, k=spec.k, k2=spec.k2)
    with pytest.raises(ValueError) as got:
        pdp._validate_sharding(spec, mesh, batch)
    with pytest.raises(ValueError) as want:
        jdp._validate_sharding(jspec, _jmesh(2, 2), batch)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["IWAE", "L_median", "DReG", "PIWAE"])
def test_world_of_one_is_the_single_device_step_bitwise(name):
    """Uninitialised (1, 1): no reduction, so the single-device bits."""
    _, tcfg = configs(2)
    jcfg, _ = configs(2)
    _, tp = params(jcfg, seed=3)
    x = torch.from_numpy(binary_rows(6, seed=4))
    eps = [torch.randn((4, 6, d), generator=torch.Generator().manual_seed(i))
           for i, d in enumerate(jcfg.n_latent_enc)]
    spec = ObjectiveSpec(name=name, k=4, k2=2 if name == "PIWAE" else 1)
    vg = pdp.make_parallel_value_and_grad(spec, tcfg, make_mesh(
        device="cpu"))
    b1, g1 = vg(tp, x, eps=eps)
    b0, g0 = objective_value_and_grad(spec, tp, tcfg, x, eps=eps)
    assert torch.equal(b1, b0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1),
                                                 tree_leaves(g0)))


def test_world_of_one_epoch_is_the_single_device_epoch_bitwise():
    jcfg, tcfg = configs(2)
    _, tp = params(jcfg, seed=5)
    n_train, batch, k = 24, 6, 3
    x = torch.rand((n_train, D), generator=torch.Generator().manual_seed(0))
    spec = ObjectiveSpec(name="IWAE", k=k)
    g = torch.Generator().manual_seed(1)
    perm = torch.randperm(n_train, generator=g)
    noise = [[torch.randn((k, batch, d), generator=g)
              for d in jcfg.n_latent_enc] for _ in range(n_train // batch)]
    uniforms = [torch.rand((batch, D), generator=g)
                for _ in range(n_train // batch)]
    mesh = make_mesh(device="cpu")
    out = []
    for fn in (tepoch.make_epoch_fn(spec, tcfg, n_train, batch,
                                    stochastic_binarization=True),
               pdp.make_parallel_epoch_fn(spec, tcfg, mesh, n_train, batch,
                                          stochastic_binarization=True)):
        state = ts.create_train_state(0, tcfg, device="cpu")
        with torch.no_grad():
            for p, q in zip(tree_leaves(state.params), tree_leaves(tp)):
                p.copy_(q)
        state, losses = fn(state, x, perm=perm, noise=noise,
                           uniforms=uniforms)
        out.append((losses, tree_leaves(state.params)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# --------------------------------------------------------------------------
# the parallel epoch
# --------------------------------------------------------------------------

def _epoch_draws(jcfg, state_key, n_train, batch, dp, sp, binarize):
    """JAX's draws of one make_parallel_epoch_fn pass per coordinate
    (dp.py:312-333)."""
    _, k_batch, k_perm, k_bin = jax.random.split(state_key, 4)
    perm = np.asarray(jax.random.permutation(k_perm, n_train))
    b_local, k_local = batch // dp, K // sp
    out = {}
    for i in range(dp):
        for j in range(sp):
            noise, uniforms = [], []
            for s in range(n_train // batch):
                noise.append(encode_noise(
                    jcfg, _coord_key(jax.random.fold_in(k_batch, s), i, j),
                    k_local, b_local))
                uniforms.append(np.asarray(jax.random.uniform(
                    jax.random.fold_in(jax.random.fold_in(k_bin, s), i),
                    (b_local, D))))
            out[(i, j)] = {"perm": perm, "noise": noise,
                           "uniforms": uniforms}
    return out


_EPOCH = {}


def _epoch_world(binarize, tmp_dir):
    if binarize in _EPOCH:
        return _EPOCH[binarize]
    dp, sp, n_train, batch = 2, 2, 40, 10
    jcfg, _ = configs(2)
    rs = np.random.RandomState(3)
    x = rs.rand(n_train, D).astype(np.float32)
    jstate = jtrain.create_train_state(jax.random.PRNGKey(2), jcfg, lr=LR,
                                       optimizer=jtrain.make_adam(LR))
    draws = _epoch_draws(jcfg, jstate.key, n_train, batch, dp, sp, binarize)
    jmesh = _jmesh(dp, sp)
    jfn = jdp.make_parallel_epoch_fn(JSpec(name="IWAE", k=K), jcfg, jmesh,
                                     n_train, batch,
                                     stochastic_binarization=binarize,
                                     optimizer=jtrain.make_adam(LR),
                                     donate=False)
    payload = dict(dp=dp, sp=sp, cfg=dict(ARCH[2], x_dim=D,
                                          likelihood="logits"),
                   params=_np_tree(jstate.params), lr=LR, x=x, batch=batch,
                   binarize=binarize, seed=9, draws=draws,
                   case=dict(name="IWAE", k=K, k2=1, p=1.0, alpha=1.0,
                             beta=0.5))
    jstate, jlosses = jfn(jdp.replicate(jmesh, jstate),
                          jdp.replicate(jmesh, jnp.asarray(x)))
    _EPOCH[binarize] = (W.launch("epoch", dp * sp, payload, tmp_dir),
                        (np.asarray(jlosses), [np.asarray(a) for a in
                                               jax.tree_util.tree_leaves(
                                                   jstate.params)]),
                        payload)
    return _EPOCH[binarize]


@pytest.mark.parametrize("binarize", [False, True])
def test_parallel_epoch_matches_jax(binarize, tmp_path_factory):
    """One (2, 2) pass on JAX's replayed permutation, per-(dp, sp) noise
    and per-dp uniforms: the losses and parameters of every rank agree
    with JAX's."""
    ranks, (jl, jp), _ = _epoch_world(binarize, tmp_path_factory.mktemp("e"))
    for r, res in enumerate(ranks):
        losses, leaves = res["injected"]
        np.testing.assert_allclose(losses.numpy(), jl, atol=LOSS_ATOL,
                                   rtol=0)
        assert_leaves_close(leaves, jp, rel=0.0, floor=PARAM_ATOL,
                            what=f"params rank {r}")


@pytest.mark.parametrize("binarize", [False, True])
def test_parallel_epoch_twice_gives_equal_bits(binarize, tmp_path_factory):
    """Two (2, 2) passes from the same seed on the ranks' own streams:
    equal losses, parameters, moments and generator states, and every rank
    holds the same losses and parameters."""
    ranks, _, _ = _epoch_world(binarize, tmp_path_factory.mktemp("e"))
    for res in ranks:
        a, b = res["runs"]
        assert torch.equal(a[0], b[0])
        for x, y in zip(a[1] + a[2], b[1] + b[2]):
            assert torch.equal(x, y)
        assert torch.equal(a[3], b[3])
        assert all(torch.equal(a[4][k], b[4][k]) for k in a[4])
        ref = ranks[0]["runs"][0]
        assert torch.equal(a[0], ref[0])
        assert all(torch.equal(x, y) for x, y in zip(a[1], ref[1]))


def test_every_rank_draws_the_same_permutation(tmp_path_factory):
    """Without binarization each step's rows are x_train rows: the dp rows'
    slices of every step together are distinct rows, the pass covers the
    whole set, and the sp ranks of a dp row take the same rows."""
    ranks, _, payload = _epoch_world(False, tmp_path_factory.mktemp("e"))
    x = payload["x"]
    rows = {tuple(r) for r in x}
    dp, sp = payload["dp"], payload["sp"]
    seen = []
    for s in range(len(x) // payload["batch"]):
        for i in range(dp):
            got = ranks[i * sp]["batches"][s].numpy()
            for j in range(1, sp):
                assert np.array_equal(got, ranks[i * sp + j]["batches"][s]
                                      .numpy())
            seen += [tuple(r) for r in got]
    assert len(seen) == len(set(seen)) == len(x) and set(seen) == rows
    # the injected pass took JAX's permutation, a different order
    assert not np.array_equal(payload["draws"][(0, 0)]["perm"],
                              np.arange(len(x)))


def test_binarized_pixels_are_shared_across_sp(tmp_path_factory):
    """With stochastic binarization the k-shards of a dp row see the same
    pixels, and the dp rows see their own rows' draws."""
    ranks, _, payload = _epoch_world(True, tmp_path_factory.mktemp("e"))
    dp, sp = payload["dp"], payload["sp"]
    for s in range(len(payload["x"]) // payload["batch"]):
        rows = []
        for i in range(dp):
            got = ranks[i * sp]["batches"][s]
            assert set(np.unique(got.numpy())) <= {0.0, 1.0}
            for j in range(1, sp):
                assert torch.equal(got, ranks[i * sp + j]["batches"][s])
            rows.append(got)
        assert not torch.equal(rows[0], rows[1])


# --------------------------------------------------------------------------
# the sharded evaluation suite
# --------------------------------------------------------------------------

_STATS = {}


def _stats_world(n_test, tmp_dir):
    if n_test in _STATS:
        return _STATS[n_test]
    dp, sp = 2, 2
    k, nll_k, nll_chunk, batch_size, act = 4, 8, 2, 12, 8
    jcfg, _ = configs(2)
    jp, _ = params(jcfg, seed=8)
    x = binary_rows(n_test, seed=12)
    key = jax.random.PRNGKey(21)
    jres, jres2 = jeval.parallel_training_statistics(
        jp, jcfg, _jmesh(dp, sp), key, jnp.asarray(x), k,
        batch_size=batch_size, nll_k=nll_k, nll_chunk=nll_chunk,
        activity_samples=act)
    n = (n_test // dp) * dp
    n_batches = n // batch_size
    b_local, chunk = batch_size // dp, nll_chunk
    a_local = act // (dp * sp)
    k_au, k_pruned = jax.random.split(jax.random.fold_in(key, n_batches))
    noise = {}
    for i in range(dp):
        for j in range(sp):
            batches = []
            for b in range(n_batches):
                k1, k2, k3 = jax.random.split(jax.random.fold_in(key, b), 3)
                k_enc, k_dec = jax.random.split(jax.random.fold_in(k3, i))
                kn = _coord_key(k2, i, j)
                batches.append({
                    "metrics": encode_noise(jcfg, _coord_key(k1, i, j),
                                            k // sp, b_local),
                    "nll": [encode_noise(jcfg, jax.random.fold_in(kn, c),
                                         chunk, b_local)
                            for c in range(nll_k // sp // chunk)],
                    "recon_enc": encode_noise(jcfg, k_enc, 1, b_local),
                    "recon_dec": [t.numpy() for t in decode_noise(
                        jcfg, k_dec, b_local)]})
            ka, kp = _coord_key(k_au, i, j), _coord_key(k_pruned, i, j)
            noise[(i, j)] = {
                "batches": batches,
                "activity": [encode_noise(jcfg, jax.random.fold_in(ka, c),
                                          a_local, n)
                             for c in range(1)],
                "pruned": [encode_noise(jcfg, jax.random.fold_in(kp, c),
                                        chunk, batch_size)
                           for c in range(nll_k // sp // chunk)]}
    payload = dict(dp=dp, sp=sp, cfg=dict(ARCH[2], x_dim=D,
                                          likelihood="logits"),
                   params=_np_tree(jp), x=x, k=k, nll_k=nll_k,
                   nll_chunk=nll_chunk, batch_size=batch_size,
                   activity_samples=act, noise=noise)
    _STATS[n_test] = (W.launch("statistics", dp * sp, payload, tmp_dir),
                      (jres, jres2))
    return _STATS[n_test]


@pytest.mark.parametrize("n_test", [24, 25], ids=["even", "trimmed"])
def test_parallel_training_statistics_match_jax(n_test, tmp_path_factory):
    ranks, (jres, jres2) = _stats_world(n_test, tmp_path_factory.mktemp("s"))
    for r, res in enumerate(ranks):
        got = res["res"]
        assert set(got) == set(jres)
        for name, want in jres.items():
            np.testing.assert_allclose(got[name], want, atol=SCALAR_ATOL,
                                       rtol=SCALAR_RTOL,
                                       err_msg=f"{name} rank {r}")
        assert list(res["counts"][0]) == [int(v) for v in
                                          jres2["number_of_active_units"]]
        assert list(res["counts"][1]) == [
            int(v) for v in jres2["number_of_PCA_active_units"]]
        for v, w in zip(res["variances"], jres2["variances"]):
            np.testing.assert_allclose(v.numpy(), np.asarray(w),
                                       atol=MOMENT_ATOL, rtol=MOMENT_RTOL)
        assert res["res"] == ranks[0]["res"]
    trimmed = "trimming test set 25 -> 24 for dp=2" in ranks[0]["stdout"]
    assert trimmed == (n_test == 25)
    assert not any("trimming" in res["stdout"] for res in ranks[1:])


# --------------------------------------------------------------------------
# the driver on a mesh
# --------------------------------------------------------------------------

def _driver_cfg(tmp, sub, **over):
    d = dict(dataset="binarized_mnist", data_dir=str(tmp / "data"),
             n_hidden_encoder=(16,), n_hidden_decoder=(16,),
             n_latent_encoder=(4,), n_latent_decoder=(784,),
             loss_function="IWAE", k=4, batch_size=32, n_stages=3,
             eval_k=4, nll_k=8, nll_chunk=4, eval_batch_size=16,
             activity_samples=8, mesh_dp=2, mesh_sp=2,
             log_dir=str(tmp / sub / "runs"),
             checkpoint_dir=str(tmp / sub / "ckpt"))
    d.update(over)
    return d


def test_mesh_driver_killed_and_resumed_gives_the_same_bits(tmp_path):
    """A (2, 2) run stopped by a SIGTERM that reaches rank 1 alone, after
    stage 3's third pass: every rank saves and stops there; the resume
    gives every rank the uninterrupted run's parameters, Adam moments and
    generator streams, bit for bit, and the same NLL."""
    payload = dict(a=_driver_cfg(tmp_path, "A", resume=False),
                   b=_driver_cfg(tmp_path, "B", checkpoint_every_passes=2),
                   kill=(3, 3), kill_rank=1)
    ranks = W.launch("driver", 4, payload, tmp_path)
    for r, res in enumerate(ranks):
        assert res["preempted"] == (3, 3), r
        assert res["stages_b"] == [3]
        assert len(res["a"]) == len(res["b"])
        for x, y in zip(res["a"], res["b"]):
            assert torch.equal(x, y), r
        assert res["nll"][0] == res["nll"][1]
    assert "resumed from mid-stage checkpoint; continuing at stage 3, " \
        "pass 4" in ranks[0]["stdout"]
    assert not any("resumed" in res["stdout"] for res in ranks[1:])
    # rank 0 alone logs: one row per stage (B: 1-2, then 3 on resume)
    for sub in ("A", "B"):
        (run,) = os.listdir(tmp_path / sub / "runs")
        with open(tmp_path / sub / "runs" / run / "metrics.jsonl") as f:
            assert [json.loads(line)["stage"] for line in f] == [1, 2, 3]
    # the ranks' noise streams differ; their parameters are one replica
    assert not torch.equal(ranks[0]["a"][-3], ranks[1]["a"][-3])
    assert all(torch.equal(x, y) for x, y in zip(ranks[0]["a"][:4],
                                                 ranks[3]["a"][:4]))


def test_cli_runs_a_2x2_mesh_on_the_cpu(tmp_path):
    """``python -m iwae_replication_project_tpu_torch --mesh-dp 2
    --mesh-sp 2 --device cpu``: four spawned gloo ranks run two stages;
    rank 0 alone prints and logs."""
    argv = ["--device", "cpu", "--mesh-dp", "2", "--mesh-sp", "2",
            "--data-dir", str(tmp_path / "data"),
            "--hidden-encoder", "8", "--hidden-decoder", "8",
            "--latent-encoder", "3", "--latent-decoder", "784", "--k", "2",
            "--batch-size", "128", "--n-stages", "2", "--eval-k", "2",
            "--nll-k", "4", "--nll-chunk", "2",
            "--log-dir", str(tmp_path / "runs"),
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "iwae_replication_project_tpu_torch", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("stage 1:") == 1
    assert proc.stdout.count("stage 2:") == 1
    runs = os.listdir(tmp_path / "runs")
    assert len(runs) == 1
    with open(tmp_path / "runs" / runs[0] / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["stage"] for r in rows] == [1.0, 2.0]
    assert all(np.isfinite(r["NLL"]) for r in rows)


# --------------------------------------------------------------------------
# the DDP-placed step
# --------------------------------------------------------------------------

def test_ddp_step_matches_the_explicit_step(tmp_path):
    """Three steps of DistributedDataParallel over the single-device bound
    against make_parallel_train_step on a (2, 1) mesh, the same draws:
    within fp32 rounding (another summation order of the dp mean)."""
    jcfg, _ = configs(2)
    jp, _ = params(jcfg, seed=6)
    g = torch.Generator().manual_seed(2)
    xs = [binary_rows(BATCH, seed=30 + s) for s in range(3)]
    eps = [[[torch.randn((K, BATCH // 2, d), generator=g).numpy()
             for d in jcfg.n_latent_enc] for _ in range(2)]
           for _ in range(3)]
    cases = [dict(name=n, k=K, k2=1, p=1.0, alpha=1.0, beta=0.5)
             for n in ("IWAE", "STL", "VAE")]
    payload = dict(dp=2, cfg=dict(ARCH[2], x_dim=D, likelihood="logits"),
                   params=_np_tree(jp), lr=LR, xs=xs, eps=eps, cases=cases)
    ranks = W.launch("ddp", 2, payload, tmp_path)
    for res in ranks:
        for case in res:
            for a, b in case["losses"]:
                assert abs(a - b) <= 1e-5 * abs(a)
            assert_leaves_close(case["ddp"], case["explicit"], rel=1e-6,
                                floor=3 * (LR / ADAM_EPS) * 1e-7)


def test_ddp_step_refuses_what_it_cannot_reduce():
    from iwae_replication_project_tpu_torch.parallel.auto import (
        make_ddp_train_step)
    _, tcfg = configs(2)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="data-parallel only"):
        make_ddp_train_step(ObjectiveSpec(name="IWAE", k=4), tcfg,
                            Mesh(dp=1, sp=2, rank=0, device=cpu))
    with pytest.raises(ValueError, match="two cotangents"):
        make_ddp_train_step(ObjectiveSpec(name="DReG", k=4), tcfg,
                            Mesh(dp=2, sp=1, rank=0, device=cpu))


def test_gloo_on_cuda_refuses_a_graph():
    """Asking for a CUDA graph on a gloo group raises; no quiet eager."""
    mesh = Mesh(dp=1, sp=1, rank=0, device=torch.device("cuda", 0),
                device_mesh=object())
    pdp_backend = type(mesh).backend
    try:
        type(mesh).backend = property(lambda self: "gloo")
        _, tcfg = configs(2)
        with pytest.raises(ValueError, match="cuda_graph=False"):
            pdp.make_parallel_epoch_fn(ObjectiveSpec(name="IWAE", k=4), tcfg,
                                       mesh, 8, 4)
        pdp.make_parallel_epoch_fn(ObjectiveSpec(name="IWAE", k=4), tcfg,
                                   mesh, 8, 4, cuda_graph=False)
    finally:
        type(mesh).backend = pdp_backend
