"""The port's sharded large-k serving (serving/sharded.py, the sharded
programs of serving/programs.py, the per-rank scorers of parallel/eval.py):
against the JAX package's offline scorers on replayed per-(row, block)
draws at four mesh shapes; bitwise contracts inside the port (engine ==
offline twin, early-stopped == fixed-k at k_used, padded == unpadded,
serial == pipelined, a checkpoint run directory == its restored
parameters); the admission rules; checkpoint loading, faults and the CLI.

Meshes other than (1, 1) run as gloo worlds of CPU processes through
tests/torch_parallel_worker.py; JAX's side runs on conftest's 8-device
fake mesh.
"""

import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.ops.logsumexp import (
    lse_var_stats as j_lse_var_stats,
    online_lse_var_init as j_online_lse_var_init,
    online_lse_var_update as j_online_lse_var_update,
)
from iwae_replication_project_tpu.parallel import eval as jeval
from iwae_replication_project_tpu.parallel.mesh import make_mesh as jmesh
from iwae_replication_project_tpu_torch import zoo
from iwae_replication_project_tpu_torch.models import iwae as tmodel
from iwae_replication_project_tpu_torch.ops import logsumexp as tlse
from iwae_replication_project_tpu_torch.parallel import eval as peval
from iwae_replication_project_tpu_torch.parallel.mesh import Mesh
from iwae_replication_project_tpu_torch.serving import (
    BucketLadder,
    KChunkMenu,
    ShardedScoreEngine,
    ServingEngine,
    crash_replica,
    default_sharded_ladder,
    serve_rank,
    slow_replica,
    target_class,
    validate_adaptive_target,
    validate_k,
)
from iwae_replication_project_tpu_torch.serving import cli
from iwae_replication_project_tpu_torch.serving import programs as tprog
from iwae_replication_project_tpu_torch.serving.faults import (
    SITE_ENGINE_FETCH,
)
from iwae_replication_project_tpu_torch.utils import checkpoint as tckpt
from iwae_replication_project_tpu_torch.utils import faults
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig
from iwae_replication_project_tpu_torch.training.train_step import (
    create_train_state,
)
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves
from torch_parity import binary_rows, block_noise_table, configs, params
import torch_parallel_worker as W

REPO = Path(__file__).resolve().parent.parent

#: the sample block of every test (the engine's default is 250)
KC = 4
#: k (and k_cap) at and around the block edges: one sample, one block, a
#: block and one, and a ragged multi-block stream
KS = [1, KC, KC + 1, 3 * KC + 7]
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]
#: five request rows, so dp=2 pads one
SEEDS = [3, 11, 29, 40, 57]
#: (atol, rtol) of a per-request score against JAX on the same draws, as
#: test_torch_serving.SCORE_TOL: log-weights of tens of nats, fp32 differing
#: in summation order only; bf16 rounding the same operands, a product near
#: a bf16 midpoint rounding the other way on one side
SCORE_TOL = {"fp32": (1e-3, 1e-5), "bfloat16": (5e-2, 1e-3)}
#: the adaptive scorer's achieved SE against JAX's: relative, a ratio of
#: sums the two sides form in another order (fp32)
SE_RTOL = 1e-3
#: targets keep this relative distance from every row's SE at every round
#: boundary, so the two sides' last-bit differences cannot flip a stop
TARGET_MARGIN = 0.01
BASE_KEY = jax.random.PRNGKey(7)


# --------------------------------------------------------------------------
# the JAX side, the draws and the port's worlds (computed once)
# --------------------------------------------------------------------------

def _se_stream(lw: np.ndarray, n: int) -> float:
    """Delta-method SE of log mean(w) over the first n log-weights."""
    v = lw[:n].astype(np.float64)
    w = np.exp(v - v.max())
    s, s2 = w.sum(), (w * w).sum()
    if n <= 1:
        return 0.0
    return float(np.sqrt(max(s2 / (s * s) - 1.0 / n, 0.0) * n / (n - 1)))


def _boundary_ses(streams, sp: int, k_cap: int):
    """Every row's SE at every round boundary of the adaptive phase 1."""
    rounds = -(-(-(-k_cap // KC)) // sp)
    return [_se_stream(lw, min((r + 1) * sp * KC, k_cap))
            for lw in streams for r in range(rounds)]


def _target(ses) -> float:
    """A target SE in the widest gap between the boundary SEs (0.5 when
    there is none), then checked against :data:`TARGET_MARGIN`."""
    pos = sorted(set(v for v in ses if v > 0))
    if len(pos) < 2:
        t = 0.5 if not pos else pos[0] * 2.0
    else:
        i = max(range(len(pos) - 1), key=lambda j: pos[j + 1] / pos[j])
        t = math.sqrt(pos[i] * pos[i + 1])
    assert min(abs(v - t) / t for v in ses) >= TARGET_MARGIN, (ses, t)
    return t


@pytest.fixture(scope="module")
def side():
    """Parameters, rows, the replayed draws, every mesh's JAX results and
    the adaptive targets."""
    x = binary_rows(len(SEEDS), seed=5)
    n_blocks = -(-max(KS) // KC)
    out = {"x": x, "cases": {}, "jax": {}, "jax_adaptive": {},
           "targets": {}}
    table = None
    for cd in (None, "bfloat16"):
        name = cd or "fp32"
        jcfg, tcfg = configs(2, "logits", cd)
        jp, tp = params(jcfg, seed=4)
        if table is None:
            table = block_noise_table(jcfg, BASE_KEY, SEEDS + [0], n_blocks,
                                      KC)
        out["cases"][name] = (jcfg, tcfg, jp, tp)
        for dp, sp in MESHES:
            mesh = jmesh(dp, sp)
            for k in KS:
                out["jax"][(name, dp, sp, k)] = np.asarray(
                    jeval.sharded_score_offline(
                        jp, jcfg, mesh, BASE_KEY,
                        np.asarray(SEEDS, np.int32), x, k, k_chunk=KC))
    out["table"] = table
    # the adaptive scorer in fp32: targets from the rows' own streams
    jcfg, tcfg, jp, tp = out["cases"]["fp32"]
    noise_fn = W.table_noise_fn(table)
    streams = []
    for s, row in zip(SEEDS, x):
        lw = [tmodel.log_weights(tp, tcfg, torch.from_numpy(row[None]), KC,
                                 eps=noise_fn(g, [s]))[:, 0]
              for g in range(n_blocks)]
        streams.append(torch.cat(lw).numpy())
    for dp, sp in MESHES:
        mesh = jmesh(dp, sp)
        for k in KS:
            t = _target(_boundary_ses(streams, sp, k))
            out["targets"][(sp, k)] = t
            out["jax_adaptive"][(dp, sp, k)] = np.asarray(
                jeval.sharded_score_adaptive_offline(
                    jp, jcfg, mesh, BASE_KEY, np.asarray(SEEDS, np.int32), x,
                    k_cap=k, target_se=t, k_chunk=KC))
    return out


def _payload(side, dp, sp):
    cases = []
    for name, (jcfg, tcfg, jp, tp) in side["cases"].items():
        case = {"name": name, "cfg": _cfg_dict(tcfg),
                "params": W.numpy_tree(tp), "ks": KS}
        if name == "fp32":
            case["adaptive"] = {k: side["targets"][(sp, k)] for k in KS}
        cases.append(case)
    _, tcfg, _, tp = side["cases"]["fp32"]
    engine = {"cfg": _cfg_dict(tcfg), "params": W.numpy_tree(tp),
              "ks": [1, 9], "k_cap": 40, "target_se": 0.6,
              "x": binary_rows(8, seed=9), "seeds": list(range(20, 28))}
    return dict(dp=dp, sp=sp, x=side["x"], seeds=SEEDS, k_chunk=KC,
                table=side["table"], cases=cases, engine=engine)


def _cfg_dict(tcfg):
    return dataclasses.asdict(tcfg)


@pytest.fixture(scope="module")
def worlds(side, tmp_path_factory):
    """Rank results of the port's job per mesh, computed on first use: the
    world of one in this process, the others as gloo worlds."""
    cache = {}

    def get(dp, sp):
        if (dp, sp) not in cache:
            payload = _payload(side, dp, sp)
            if dp * sp == 1:
                cache[(dp, sp)] = [W.JOBS["sharded_serving"](payload)]
            else:
                cache[(dp, sp)] = W.launch(
                    "sharded_serving", dp * sp, payload,
                    tmp_path_factory.mktemp(f"sharded-{dp}x{sp}"))
        return cache[(dp, sp)]
    return get


# --------------------------------------------------------------------------
# against JAX, on JAX's draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cd", ["fp32", "bfloat16"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dp,sp", MESHES)
def test_sharded_score_matches_jax(side, worlds, dp, sp, k, cd):
    got = worlds(dp, sp)[0]["score"][(cd, k)]
    want = side["jax"][(cd, dp, sp, k)]
    assert got.shape == (len(SEEDS),) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, *SCORE_TOL[cd])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dp,sp", MESHES)
def test_sharded_adaptive_matches_jax(side, worlds, dp, sp, k):
    """log p_hat within the score tolerance, the achieved SE within
    SE_RTOL and k_used equal, at a target no row's round-boundary SE lies
    within 1% of (asserted where the target is chosen)."""
    got = worlds(dp, sp)[0]["adaptive"][("fp32", k)].numpy()
    want = side["jax_adaptive"][(dp, sp, k)]
    assert got.shape == (len(SEEDS), 3)
    assert np.array_equal(got[:, 2], want[:, 2]), (got[:, 2], want[:, 2])
    np.testing.assert_allclose(got[:, 0], want[:, 0], *SCORE_TOL["fp32"])
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=SE_RTOL,
                               atol=1e-7)


def test_adaptive_targets_engage_the_stopping_rule(side):
    """With the chosen targets rows stop below the cap, and every k_used
    lies on its mesh's round grid (``min((r+1)*sp*k_chunk, k_cap)``)."""
    early = 0
    for dp, sp in MESHES:
        for k in KS:
            ku = side["jax_adaptive"][(dp, sp, k)][:, 2]
            grid = {min((r + 1) * sp * KC, k) for r in range(k)}
            assert set(ku.astype(int)) <= grid
            early += int((ku < k).sum())
    assert early > 0


# --------------------------------------------------------------------------
# the worlds: engine == offline twin, followers, merges, a dead follower
# --------------------------------------------------------------------------

@pytest.mark.parametrize("inflight", [0, 2])
@pytest.mark.parametrize("dp,sp", MESHES)
def test_engine_matches_offline_twin_bitwise(worlds, dp, sp, inflight):
    """Rank 0's engine (followers in serve_rank), serial and pipelined,
    returns bitwise the offline scorers' rows on the device draws, for
    score at two k and for score_adaptive."""
    ranks = worlds(dp, sp)
    served, offline, offline_a = ranks[0]["engine"]
    got, got_a, kernel = served[inflight]
    assert np.array_equal(got, offline)
    assert np.array_equal(got_a, offline_a)
    assert set(kernel) <= {f"{op}/b{b}/kdyn" for op in
                           ("score", "score_adaptive") for b in (1, 2, 4)}
    for r in ranks[1:]:  # each follower served both engines' dispatches
        assert r["engine"][0] == {0: 6, 2: 6}


@pytest.mark.parametrize("dp,sp", MESHES)
def test_idle_sp_rank_and_all_inf_rows_stay_finite(worlds, dp, sp):
    """k=1 leaves every sp rank but one idle: finite. The merges of a rank
    whose rows are all -inf stay NaN-free, finite where any rank saw a
    sample."""
    r0 = worlds(dp, sp)[0]
    for name in ("fp32", "bfloat16"):
        assert torch.isfinite(r0["score"][(name, 1)]).all()
    m, s, s2, pm, ps = r0["merge"]
    for t in (m, s, s2, pm, ps):
        assert not torch.isnan(t).any()
    if sp > 1:
        assert torch.equal(m, torch.tensor([0.5, -math.inf, 2.0]))
        assert torch.equal(s, torch.tensor([1.0, 0.0, 1.0]))
        assert torch.equal(pm, m) and torch.equal(ps, s)
    else:
        assert torch.isinf(m).all() and (s == 0).all()


def test_a_dead_follower_errors_the_batch_not_hangs(side, tmp_path):
    """A follower that dies after receiving a dispatch: rank 0's collective
    fails (gloo: the connection closes), the batch's future errors within
    the group's timeout, and stop() reports the broken group."""
    _, tcfg, _, tp = side["cases"]["fp32"]
    payload = dict(dp=1, sp=2, cfg=_cfg_dict(tcfg), params=W.numpy_tree(tp),
                   x=side["x"], timeout_s=30.0)
    r0, r1 = W.launch("sharded_kill", 2, payload, tmp_path, codes=[0, 3])
    assert r1 is None
    assert r0["error"] is not None and r0["waited"] < 30.0
    assert r0["stop_error"] is not None


# --------------------------------------------------------------------------
# bitwise contracts inside the port, a world of one on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = configs(2, "logits")
    _, tp = params(jcfg, seed=2)
    return {"cfg": tcfg, "params": tp, "x": binary_rows(12, seed=6)}


def make_sharded(tiny, **kw):
    kw.setdefault("k_chunk", KC)
    kw.setdefault("k_max", 100)
    kw.setdefault("k", 8)
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_wait_us", 1e7)
    kw.setdefault("timeout_s", 60.0)
    kw.setdefault("device", "cpu")
    return ShardedScoreEngine(params=tiny["params"],
                              model_config=tiny["cfg"], **kw)


def _serve(eng, op, rows, seeds, **kw):
    fs = [eng.submit(op, r, seed=int(s), **kw) for s, r in zip(seeds, rows)]
    eng.flush()
    return np.stack([f.result(timeout=60) for f in fs])


def _offline(eng, rows, seeds, k):
    return peval.sharded_score_offline(
        eng._params, eng.cfg, eng.mesh, 0, seeds, torch.from_numpy(rows), k,
        KC).numpy()


def _offline_adaptive(eng, rows, seeds, **kw):
    return peval.sharded_score_adaptive_offline(
        eng._params, eng.cfg, eng.mesh, 0, seeds, torch.from_numpy(rows),
        k_chunk=KC, **kw).numpy()


@pytest.mark.parametrize("k", KS + [100])
def test_engine_score_equals_offline_twin(tiny, k):
    eng = make_sharded(tiny)
    seeds = list(range(40, 48))
    got = _serve(eng, "score", tiny["x"][:8], seeds, k=k)
    assert np.array_equal(got, _offline(eng, tiny["x"][:8], seeds, k))


@pytest.mark.parametrize("target", [dict(target_se=0.5),
                                    dict(ess_floor=6.0),
                                    dict(target_se=0.3, ess_floor=20.0)])
def test_engine_adaptive_equals_offline_twin(tiny, target):
    eng = make_sharded(tiny)
    seeds = list(range(60, 68))
    got = _serve(eng, "score_adaptive", tiny["x"][:8], seeds, k=100,
                 **target)
    want = _offline_adaptive(eng, tiny["x"][:8], seeds, k_cap=100, **target)
    assert got.shape == (8, 3) and np.array_equal(got, want)
    assert np.all((got[:, 2] >= 1) & (got[:, 2] <= 100))


@pytest.mark.parametrize("seed", [91, 92, 93])
def test_early_stop_equals_fixed_k_prefix(tiny, seed):
    """An early-stopped row's log p_hat is bitwise the fixed-k score at k =
    k_used under the same seed, on the same rows."""
    eng = make_sharded(tiny)
    log_px, se, k_used = _serve(eng, "score_adaptive", tiny["x"][:1],
                                [seed], k=100, target_se=0.8)[0]
    assert 1 <= k_used < 100 and np.isfinite(se)
    fixed = _serve(eng, "score", tiny["x"][:1], [seed], k=int(k_used))[0]
    assert log_px == fixed


def test_early_stop_equals_fixed_k_prefix_in_a_batch(tiny):
    eng = make_sharded(tiny)
    seeds = list(range(70, 78))
    out = _serve(eng, "score_adaptive", tiny["x"][:8], seeds, k=100,
                 target_se=0.45)
    assert len(set(out[:, 2])) > 1
    for i, ku in enumerate(out[:, 2]):
        fixed = _serve(eng, "score", tiny["x"][:8], seeds, k=int(ku))
        assert out[i, 0] == fixed[i]


@pytest.mark.parametrize("n", [1, 3, 5, 7])
def test_padded_bucket_equals_unpadded(tiny, n):
    """n rows padded to their bucket, against the program on exactly those
    rows: score and score_adaptive."""
    eng = make_sharded(tiny)
    seeds = list(range(100, 100 + n))
    rows = tiny["x"][:n]
    assert np.array_equal(_serve(eng, "score", rows, seeds, k=19),
                          _offline(eng, rows, seeds, 19))
    assert np.array_equal(
        _serve(eng, "score_adaptive", rows, seeds, k=40, target_se=0.5),
        _offline_adaptive(eng, rows, seeds, k_cap=40, target_se=0.5))


def test_serial_equals_pipelined(tiny):
    """Serial and pipelined engines agree bitwise, every dispatch a whole
    bucket (the requests queued before the pump starts)."""
    out = []
    for inflight in (0, 2):
        eng = make_sharded(tiny, max_inflight=inflight)
        fs = [eng.submit("score", r, k=k, seed=i)
              for k in (5, 19) for i, r in enumerate(tiny["x"][:8])]
        fa = [eng.submit("score_adaptive", r, k=40, seed=i, target_se=0.5)
              for i, r in enumerate(tiny["x"][:8])]
        eng.start()
        try:
            out.append((np.stack([f.result(60) for f in fs]),
                        np.stack([f.result(60) for f in fa])))
        finally:
            eng.stop()
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])


def test_block_draws_are_a_pure_function_of_row_and_block(tiny):
    cfg = tiny["cfg"]
    a = tprog.draw_block_noise(cfg, 3, [9, 1, 4], [2, None, 5], KC, "cpu")
    b = tprog.draw_block_noise(cfg, 3, [4, 9], [5, 2], KC, "cpu")
    for la, lb in zip(a, b):
        assert la.shape == (KC, 3, la.shape[2]) and la.is_contiguous()
        assert torch.equal(la[:, 0], lb[:, 1])
        assert torch.equal(la[:, 2], lb[:, 0])
        assert (la[:, 1] == 0).all()
    c = tprog.draw_block_noise(cfg, 3, [9], [3], KC, "cpu")
    assert not torch.equal(a[0][:, 0], c[0][:, 0])
    assert tprog.row_seed(3, 9) == tprog.row_seed(3, 9, None)
    assert len({tprog.row_seed(3, 9, g) for g in range(50)}) == 50
    assert all(0 <= tprog.row_seed(3, 9, g) < 2 ** 63 for g in range(5))


def test_noise_fn_replays_the_draws(tiny):
    """A noise_fn returning the device draws reproduces the program's
    result bitwise."""
    eng = make_sharded(tiny)
    seeds = list(range(8))
    x = torch.from_numpy(tiny["x"][:8])

    def replay(g, ss):
        return tprog.draw_block_noise(eng.cfg, 5, ss, [g] * len(ss), KC,
                                      "cpu")
    prog = tprog.make_sharded_score_rows(eng.cfg, eng.mesh, KC)
    assert torch.equal(prog(eng._params, 5, seeds, x, 19),
                       prog(eng._params, 5, seeds, x, 19, noise_fn=replay))


# --------------------------------------------------------------------------
# the online carries
# --------------------------------------------------------------------------

def test_lse_var_keeps_m_s_bitwise_and_matches_jax():
    rs = np.random.RandomState(0)
    chunks = [rs.randn(n, 6).astype(np.float32) * 3 for n in (4, 1, 7, 3)]
    chunks[1][:, 2] = -np.inf
    plain = tlse.online_logsumexp_init((6,))
    var = tlse.online_lse_var_init((6,))
    jst = j_online_lse_var_init((6,))
    for c in chunks:
        plain = tlse.online_logsumexp_update(plain, torch.from_numpy(c))
        var = tlse.online_lse_var_update(var, torch.from_numpy(c))
        jst = j_online_lse_var_update(jst, jnp.asarray(c))
    assert torch.equal(plain.m, var.m) and torch.equal(plain.s, var.s)
    for got, want in ((var.m, jst.m), (var.s, jst.s), (var.s2, jst.s2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)
    n = var.n
    ess, se = tlse.lse_var_stats(var.s, var.s2, n)
    jess, jse = j_lse_var_stats(jst.s, jst.s2, n)
    np.testing.assert_allclose(ess.numpy(), np.asarray(jess), rtol=1e-6)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-6)
    ess_t, se_t = tlse.lse_var_stats(var.s, var.s2,
                                     torch.full((6,), float(n)))
    np.testing.assert_allclose(se_t.numpy(), se.numpy(), rtol=1e-6)
    np.testing.assert_allclose(ess_t.numpy(), ess.numpy(), rtol=1e-6)


@pytest.mark.parametrize("n", [0, 1, 5, torch.tensor([0.0, 1.0, 5.0])])
def test_lse_var_stats_all_inf_rows_never_nan(n):
    st = tlse.online_lse_var_update(tlse.online_lse_var_init((3,)),
                                    torch.full((4, 3), -math.inf))
    ess, se = tlse.lse_var_stats(st.s, st.s2, n)
    assert (ess == 0).all() and torch.isinf(se).all()
    assert not torch.isnan(ess).any() and not torch.isnan(se).any()


# --------------------------------------------------------------------------
# admission: the menu, the targets, the engine's rules
# --------------------------------------------------------------------------

MENU = KChunkMenu(batch=BucketLadder((2, 4, 8)), k_chunk=250, k_max=5000)


@pytest.mark.parametrize("k,want", [(1, 1), (5000, 5000), (np.int32(7), 7),
                                    (np.int64(250), 250)])
def test_k_chunk_menu_accepts(k, want):
    got = MENU.validate_k(k)
    assert got == want and type(got) is int


@pytest.mark.parametrize("k,chunks", [(250, 1), (251, 2), (5000, 20),
                                      (1, 1)])
def test_k_chunk_menu_counts_chunks(k, chunks):
    assert MENU.n_chunks(k) == chunks


@pytest.mark.parametrize("bad,match", [(0, "out of range"),
                                       (-3, "out of range"),
                                       (5001, "out of range"),
                                       ("50", "integer"), (2.5, "integer"),
                                       (True, "integer"), (None, "integer")])
def test_k_chunk_menu_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        MENU.validate_k(bad)


@pytest.mark.parametrize("kw,match", [(dict(k_chunk=0), "k_chunk"),
                                      (dict(k_max=0), "k_max")])
def test_k_chunk_menu_construction_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        KChunkMenu(batch=BucketLadder((2,)), **kw)


def test_validate_k_accepts_numpy_integers():
    assert validate_k(np.int32(7), 10) == 7
    assert isinstance(validate_k(np.int64(7), 10), int)


BAD_TARGETS = (
    {"target_se": "x"},                      # non-number
    {"target_se": -1.0},                     # non-positive
    {"target_se": float("nan")},             # non-finite
    {"ess_floor": True},                     # bool masquerading as number
    {"ess_floor": 1e9},                      # can never be met under the cap
    {},                                      # target-less adaptive request
)


@pytest.mark.parametrize("bad", BAD_TARGETS, ids=str)
def test_validate_adaptive_target_rejects(bad):
    with pytest.raises(ValueError):
        validate_adaptive_target(bad.get("target_se"), bad.get("ess_floor"),
                                 100, 100)


def test_validate_adaptive_target_normalizes():
    assert validate_adaptive_target(0.1, None, 50, 100) == (0.1, 0.0, 50)
    assert validate_adaptive_target(None, 8.0, 50, 100) == (0.0, 8.0, 50)
    with pytest.raises(ValueError, match="out of range"):
        validate_adaptive_target(0.1, None, 101, 100)


def test_target_class_decade_labels():
    assert target_class(1e-2, 0.0) == "se:e-2"
    assert target_class(0.05, 0.0) == "se:e-2"
    assert target_class(0.0, 250.0) == "ess:e+2"
    assert target_class(0.011, 0.0) == target_class(0.099, 0.0)


@pytest.mark.parametrize("bad", BAD_TARGETS, ids=str)
def test_engine_rejects_malformed_targets(tiny, bad):
    eng = make_sharded(tiny)
    with pytest.raises(ValueError):
        eng.submit("score_adaptive", tiny["x"][0], k=50, **bad)
    assert eng.metrics.snapshot()["counters"]["submitted"] == 0


@pytest.mark.parametrize("kw", [dict(target_se=0.1), dict(ess_floor=3.0)])
def test_targets_on_fixed_k_ops_are_typed_errors(tiny, kw):
    eng = make_sharded(tiny)
    with pytest.raises(ValueError, match="fixed-k"):
        eng.submit("score", tiny["x"][0], k=5, **kw)
    base = ServingEngine(params=tiny["params"], model_config=tiny["cfg"],
                         device="cpu")
    with pytest.raises(ValueError, match="fixed-k"):
        base.submit("score", tiny["x"][0], **kw)


@pytest.mark.parametrize("dp,max_batch,rungs", [(1, 8, (1, 2, 4, 8)),
                                                (2, 8, (2, 4, 8)),
                                                (2, 5, (2, 4)),
                                                (3, 8, (3, 6)),
                                                (4, 2, (4,))])
def test_default_sharded_ladder_is_dp_aligned(dp, max_batch, rungs):
    assert default_sharded_ladder(dp, max_batch).buckets == rungs


def _fake_mesh(dp, sp, rank=0):
    return Mesh(dp=dp, sp=sp, rank=rank, device=torch.device("cpu"))


def test_sharded_engine_requires_dp_aligned_buckets(tiny):
    with pytest.raises(ValueError, match="multiples of dp=2"):
        make_sharded(tiny, mesh=_fake_mesh(2, 1),
                     ladder=BucketLadder((1, 2, 4)))


def test_default_k_clamps_and_explicit_k_must_fit(tiny):
    eng = make_sharded(tiny, k=None, k_max=40)
    assert eng.k == 40 and eng.k_max == 40
    assert make_sharded(tiny, k=None, k_max=5000).k == 50
    with pytest.raises(ValueError, match="out of range"):
        make_sharded(tiny, k=50, k_max=40)
    with pytest.raises(ValueError, match="out of range"):
        make_sharded(tiny).submit("score", tiny["x"][0], k=101)


def test_a_ragged_k_stream_creates_no_per_k_state(tiny):
    """One program per bucket serves every k: the gate's memo, the
    programs and the kernel gauges stay keyed on bucket."""
    eng = make_sharded(tiny, max_batch=4)
    for k in range(1, 30, 3):
        _serve(eng, "score", tiny["x"][:4], range(4), k=k)
        _serve(eng, "score_adaptive", tiny["x"][:2], range(2), k=k,
               target_se=0.5)
    assert {key[1] for key in eng._kernel_cache} == {"dyn"}
    assert {key[2] for key in eng._kernel_cache} <= set(eng.ladder.buckets)
    assert len(eng._sharded_programs) == 2
    gauges = [g for g in eng.metrics.registry.snapshot()["gauges"]
              if g.startswith("kernel/")]
    assert sorted(gauges) == ["kernel/score/b4/kdyn",
                              "kernel/score_adaptive/b2/kdyn"]


def test_sharded_engine_without_cuda_raises(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedScoreEngine(params=tiny["params"], model_config=tiny["cfg"])
    with pytest.raises(ValueError, match="CUDA"):
        make_sharded(tiny, kernel_path="kernel")


def test_only_rank_zero_takes_requests(tiny):
    follower = make_sharded(tiny, mesh=_fake_mesh(1, 2, rank=1))
    with pytest.raises(RuntimeError, match="rank 0"):
        follower.submit("score", tiny["x"][0])
    with pytest.raises(ValueError, match="rank 0"):
        serve_rank(make_sharded(tiny))


def test_warmup_covers_both_ops_and_every_bucket(tiny):
    eng = make_sharded(tiny)
    warm = eng.warmup()
    assert warm["programs"] == 2 * len(eng.ladder.buckets)
    assert eng.sharded and not ServingEngine(
        params=tiny["params"], model_config=tiny["cfg"],
        device="cpu").sharded


# --------------------------------------------------------------------------
# faults
# --------------------------------------------------------------------------

def test_crash_replica_errors_exactly_the_batch(tiny):
    eng = make_sharded(tiny)
    with faults.installed(faults.FaultSchedule([crash_replica(eng,
                                                              times=1)])):
        bad = [eng.submit("score", r, k=5) for r in tiny["x"][:2]]
        eng.flush()
        good = eng.submit("score", tiny["x"][0], k=5)
        eng.flush()
    for f in bad:
        with pytest.raises(faults.FaultInjected, match="replica crash"):
            f.result(timeout=10)
    assert np.isfinite(good.result(timeout=10))
    assert eng.metrics.snapshot()["counters"]["errors"] == 2


def test_slow_replica_stalls_the_launch(tiny):
    eng = make_sharded(tiny)
    with faults.installed(faults.FaultSchedule([slow_replica(eng, 0.3)])):
        t0 = time.monotonic()
        _serve(eng, "score", tiny["x"][:2], [1, 2], k=5)
        assert time.monotonic() - t0 >= 0.3


def test_a_fetch_fault_lands_in_the_batch(tiny):
    eng = make_sharded(tiny, max_inflight=2).start()
    rule = faults.FaultRule(SITE_ENGINE_FETCH,
                            faults.raise_fault("device lost"),
                            match=lambda c: c["engine"] is eng)
    try:
        with faults.installed(faults.FaultSchedule([rule])):
            f = eng.submit("score", tiny["x"][0], k=5)
            with pytest.raises(faults.FaultInjected, match="device lost"):
                f.result(timeout=30)
    finally:
        eng.stop()


# --------------------------------------------------------------------------
# checkpoint loading, zoo and the CLI
# --------------------------------------------------------------------------

TINY_ECFG = dict(n_hidden_encoder=(16,), n_latent_encoder=(4,),
                 n_hidden_decoder=(16,), n_latent_decoder=(784,), k=6,
                 seed=3)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A driver checkpoint run directory of a tiny config: steps 3 and 5,
    each with weights moved off their initial values."""
    d = str(tmp_path_factory.mktemp("ckpt") / "run")
    ecfg = ExperimentConfig(**TINY_ECFG)
    mcfg = ecfg.model_config("cpu")
    for step in (3, 5):
        state = create_train_state(ecfg.seed, mcfg, device="cpu")
        g = torch.Generator().manual_seed(step)
        with torch.no_grad():
            for p in tree_leaves(state.params):
                p.add_(0.05 * torch.randn(p.shape, generator=g))
        tckpt.save_checkpoint(d, step, state, stage=1,
                              config_json=ecfg.to_json())
    return d


def _restored(run_dir):
    ecfg = ExperimentConfig(**TINY_ECFG)
    template = create_train_state(ecfg.seed, ecfg.model_config("cpu"),
                                  device="cpu")
    step, state, _, _ = tckpt.restore_latest(run_dir, template)
    return step, state, ecfg


def test_source_run_dir_equals_the_restored_params(run_dir):
    """ServingEngine(run_dir) serves at the stored k and scores bitwise as
    an engine over the parameters restore_latest restores."""
    step, state, ecfg = _restored(run_dir)
    assert step == 5
    eng = ServingEngine(run_dir, device="cpu", timeout_s=60.0)
    ref = ServingEngine(params=state.params,
                        model_config=ecfg.model_config("cpu"), k=ecfg.k,
                        device="cpu", timeout_s=60.0)
    assert eng.k == ecfg.k == 6
    x = binary_rows(4, seed=1, d=784)
    assert np.array_equal(eng.score(x), ref.score(x))
    for a, b in zip(tree_leaves(eng._params), tree_leaves(state.params)):
        assert torch.equal(a, b.detach())


def test_sharded_engine_from_a_run_dir(run_dir):
    step, state, ecfg = _restored(run_dir)
    eng = ShardedScoreEngine(run_dir, device="cpu", k_chunk=KC, k_max=64,
                             max_batch=4, timeout_s=60.0)
    assert eng.k == 6
    x = binary_rows(4, seed=2, d=784)
    got = _serve(eng, "score", x, range(4), k=9)
    want = peval.sharded_score_offline(
        state.params, eng.cfg, eng.mesh, 0, list(range(4)),
        torch.from_numpy(x), 9, KC).numpy()
    assert np.array_equal(got, want)


def test_zoo_checkpoint_dir_and_config_fallback(run_dir, tmp_path):
    eng = zoo.serving_engine(checkpoint_dir=run_dir, device="cpu", k=2)
    assert eng.k == 2 and eng.cfg.n_hidden_enc == (16,)
    assert json.loads(tckpt.stored_config_json(run_dir))["k"] == 6
    # a truncated newest step: both readers fall back to step 3
    import shutil
    d = str(tmp_path / "run")
    shutil.copytree(run_dir, d)
    tckpt.truncate_newest_checkpoint(d)
    params = ServingEngine(d, device="cpu")._params
    template = create_train_state(3, ExperimentConfig(
        **TINY_ECFG).model_config("cpu"), device="cpu")
    assert tckpt.restore_latest(d, template)[0] == 3
    for a, b in zip(tree_leaves(params), tree_leaves(template.params)):
        assert torch.equal(a, b.detach())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ServingEngine(str(tmp_path / "empty"), device="cpu")
    with pytest.raises(ValueError, match="preset"):
        zoo.serving_engine(device="cpu")


def test_source_flexible_model_is_a_snapshot():
    """A compiled FlexibleModel serves a copy of its weights: training on
    does not move the engine's answers."""
    from iwae_replication_project_tpu_torch.api import FlexibleModel
    mdl = FlexibleModel([16], [16], [4], [784], dataset_bias=None, k=3,
                        device="cpu").compile()
    eng = ServingEngine(mdl, device="cpu")
    assert eng.k == 50 and eng.cfg.n_hidden_enc == (16,)
    x = binary_rows(3, seed=4, d=784)
    before = _serve(eng, "score", x, [1, 2, 3])
    with torch.no_grad():
        for p in tree_leaves(mdl.params):
            p.add_(0.5)
    assert np.array_equal(before, _serve(eng, "score", x, [1, 2, 3]))
    assert not np.array_equal(before, _serve(
        ServingEngine(mdl, device="cpu"), "score", x, [1, 2, 3]))
    with pytest.raises(ValueError, match="compiled FlexibleModel"):
        ServingEngine(FlexibleModel([16], [16], [4], [784],
                                    dataset_bias=None, device="cpu"),
                      device="cpu")


def test_cli_checkpoint_interactive(run_dir, monkeypatch, capsys):
    lines = [json.dumps({"op": "score", "x": binary_rows(2, seed=3,
                                                          d=784).tolist()}),
             json.dumps({"op": "encode",
                         "x": binary_rows(1, seed=4, d=784)[0].tolist(),
                         "k": 3}),
             "not json",
             json.dumps({"op": "score_adaptive", "x": [0.0] * 784})]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    rc = cli.main(["--checkpoint", run_dir, "--interactive", "--device",
                   "cpu", "--buckets", "1,4", "--seed", "2"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert out[0]["k"] == 6 and out[0]["buckets"] == [1, 4]
    assert out[0]["source"] == run_dir and out[0]["device"] == "cpu"
    assert out[1]["op"] == "score" and len(out[1]["result"]) == 2
    assert np.isfinite(out[1]["result"]).all()
    assert out[2]["op"] == "encode" and len(out[2]["result"]) == 4
    assert "error" in out[3] and "unknown op" in out[4]["error"]


def test_cli_checkpoint_load_with_log_dir(run_dir, tmp_path, capsys):
    rc = cli.main(["--checkpoint", run_dir, "--device", "cpu", "--requests",
                   "4", "--sizes", "1,2", "--ops", "score", "--max-batch",
                   "2", "--queue-limit", "64", "--max-inflight", "0",
                   "--timeout-s", "0", "--log-dir", str(tmp_path)])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["counters"]["completed"] == 6
    assert doc["checkpoint"] == run_dir and doc["k"] == 6
    rows = (tmp_path / "serving" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(rows[-1])["completed"] == 6


@pytest.mark.parametrize("argv,match", [
    # A8b: the per-model pairs parse, and a typo'd policy is refused
    pytest.param(["--precision", "m1=int4"], "int4", id="argv0-A8"),
    (["--precision", "fp16"], "unknown precision"),
    (["--replicas", "2", "--autoscale"], None),
    (["--autoscale-dry-run"], None),
    (["--sharded-replicas", "1", "--autoscale-min", "1"], None),
    (["--autoscale"], None),
    (["--metrics-port", "0"], None),
    (["--store-budget-mb", "10"], None),
    (["--checkpoint", "a", "--preset", "b"], "not allowed"),
])
def test_cli_refuses_what_is_not_ported(argv, match, capsys):
    """What the port lacks is an argparse error with its reason; the
    fleet's, the store's and the metrics page's flags (match None) are
    ported and parse."""
    if match is None:
        args = cli.build_argparser().parse_args(argv)
        assert args.autoscale or args.autoscale_dry_run or \
            args.autoscale_min == 1 or args.store_budget_mb == 10 or \
            args.metrics_port == 0
        return
    with pytest.raises(SystemExit) as e:
        cli.build_argparser().parse_args(argv)
    assert e.value.code == 2
    assert match in capsys.readouterr().err


def test_cli_module_entry_point(run_dir):
    """``python -m iwae_replication_project_tpu_torch.serving --checkpoint
    RUN_DIR --interactive`` in a fresh process: one score and one encode
    line in, two result lines out, exit 0."""
    req = "\n".join(json.dumps({"op": op, "x": [1.0, 0.0] * 392})
                    for op in ("score", "encode")) + "\n"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "iwae_replication_project_tpu_torch.serving",
         "--checkpoint", run_dir, "--interactive", "--device", "cpu",
         "--buckets", "1"], input=req, capture_output=True, text=True,
        cwd=REPO, env=env, timeout=180)
    assert proc.returncode == 0, proc.stderr
    out = [json.loads(ln) for ln in proc.stdout.splitlines()]
    assert [o.get("op") for o in out[1:]] == ["score", "encode"]
    assert np.isfinite(out[1]["result"])
