"""The port's serving slice (iwae_replication_project_tpu_torch/serving): the
row programs against the JAX programs on replayed per-row ``fold_in`` draws
(the slice as a whole), the engine's contracts on the CPU, the zoo/CLI entry
points, and the rule that no port module imports JAX or the JAX package."""

import ast
import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.serving import programs as jprog
from iwae_replication_project_tpu_torch import zoo
from iwae_replication_project_tpu_torch.serving import cli
from iwae_replication_project_tpu_torch.serving import programs as tprog
from iwae_replication_project_tpu_torch.serving.engine import (
    EngineOverloaded,
    RequestTimeout,
    ServingEngine,
)
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig
from torch_parity import (
    assert_close,
    binary_rows,
    configs,
    params,
    row_decode_noise,
    row_encode_noise,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "iwae_replication_project_tpu_torch"

#: (atol, rtol): per-request scores are logmeanexps of log-weights of tens
#: of nats (fp32: summation order only; bf16: see test_torch_model.TOL)
SCORE_TOL = {None: (1e-3, 1e-5), "bfloat16": (5e-2, 1e-3)}
SEEDS = [0, 5, 17, 3, 2 ** 31 - 1]
K = 4


def _base_key():
    return jax.random.PRNGKey(7)


# --------------------------------------------------------------------------
# the programs against the JAX programs, on JAX's per-row draws
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("layers", [1, 2])
def test_score_rows_match_jax(layers, cd):
    jcfg, tcfg = configs(layers, "logits", cd)
    jp, tp = params(jcfg, seed=layers)
    x = binary_rows(len(SEEDS), seed=1)
    want = np.asarray(jprog.score_rows(jp, jcfg, _base_key(),
                                       jnp.asarray(SEEDS, jnp.int32),
                                       jnp.asarray(x), K))
    noise = row_encode_noise(jcfg, _base_key(), SEEDS, K)
    got = tprog.score_rows(tp, tcfg, 0, SEEDS, torch.from_numpy(x), K,
                           noise=noise)
    assert got.shape == (len(SEEDS),)
    assert_close(got, want, *SCORE_TOL[cd])


def test_encode_rows_match_jax():
    jcfg, tcfg = configs(2, "logits")
    jp, tp = params(jcfg)
    x = binary_rows(len(SEEDS), seed=2)
    want = np.asarray(jprog.encode_rows(jp, jcfg, _base_key(),
                                        jnp.asarray(SEEDS, jnp.int32),
                                        jnp.asarray(x), K))
    got = tprog.encode_rows(tp, tcfg, 0, SEEDS, torch.from_numpy(x), K,
                            noise=row_encode_noise(jcfg, _base_key(), SEEDS,
                                                   K))
    assert got.shape == (len(SEEDS), jcfg.n_latent_enc[-1])
    # latent means: fp32 sums of K samples of O(1) values
    assert_close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("layers", [1, 2])
def test_decode_rows_match_jax(layers):
    jcfg, tcfg = configs(layers, "clamp")
    jp, tp = params(jcfg)
    h = np.random.RandomState(3).randn(len(SEEDS), jcfg.n_latent_enc[-1]) \
        .astype(np.float32)
    want = np.asarray(jprog.decode_rows(jp, jcfg, _base_key(),
                                        jnp.asarray(SEEDS, jnp.int32),
                                        jnp.asarray(h)))
    got = tprog.decode_rows(tp, tcfg, 0, SEEDS, torch.from_numpy(h),
                            noise=row_decode_noise(jcfg, _base_key(), SEEDS))
    assert got.shape == (len(SEEDS), jcfg.x_dim)
    assert_close(got, want, 1e-6, 1e-5)


def test_zero_padding_rows_stay_finite():
    """The engine pads buckets with zero rows (seed 0); every op must compute
    finite values on them, so they can never poison a dispatch."""
    jcfg, tcfg = configs(2, "logits", fused=True)
    _, tp = params(jcfg)
    zeros = torch.zeros(5, 20)
    assert torch.isfinite(tprog.score_rows(tp, tcfg, 0, [0] * 5, zeros,
                                           K)).all()
    assert torch.isfinite(tprog.encode_rows(tp, tcfg, 0, [0] * 5, zeros,
                                            K)).all()
    assert torch.isfinite(tprog.decode_rows(tp, tcfg, 0, [0] * 5,
                                            torch.zeros(5, 5))).all()


def test_row_noise_is_independent_of_its_batch():
    """A row's draws depend only on (engine seed, request seed): the same
    seed gives the same noise in any batch, at any position."""
    _, tcfg = configs(2)
    a = tprog.draw_noise(tcfg, "score", 3, [9, 1, 4], K)
    b = tprog.draw_noise(tcfg, "score", 3, [4, 9], K)
    for la, lb in zip(a, b):
        assert la.shape[1] == 3 and lb.shape[1] == 2
        assert torch.equal(la[:, 0], lb[:, 1]) and torch.equal(la[:, 2],
                                                               lb[:, 0])
    other = tprog.draw_noise(tcfg, "score", 4, [9], K)
    assert not torch.equal(a[0][:, 0], other[0][:, 0])
    assert tprog.row_seed(3, 9) == tprog.row_seed(3, 9) < 2 ** 63
    dec = tprog.draw_noise(tcfg, "decode", 3, [1, 2])
    assert [tuple(t.shape) for t in dec] == [(2, tcfg.n_latent_dec[0])]


# --------------------------------------------------------------------------
# the engine on the CPU
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = configs(2, "logits")
    _, tp = params(jcfg)
    return {"cfg": tcfg, "params": tp, "x": binary_rows(17, seed=4)}


def make_engine(tiny, **kw):
    kw.setdefault("k", K)
    kw.setdefault("max_batch", 8)
    kw.setdefault("timeout_s", 30.0)
    kw.setdefault("device", "cpu")
    return ServingEngine(params=tiny["params"], model_config=tiny["cfg"],
                         **kw)


def test_blocking_ops_shapes(tiny):
    eng = make_engine(tiny)
    s = eng.score(tiny["x"][:5])
    assert s.shape == (5,) and s.dtype == np.float32 and np.isfinite(s).all()
    assert eng.score(tiny["x"][0]).shape == ()
    assert eng.encode(tiny["x"][:3]).shape == (3, 5)
    probs = eng.decode(np.random.RandomState(1).randn(2, 5))
    assert probs.shape == (2, 20) and probs.min() > 0 and probs.max() < 1
    snap = eng.metrics.snapshot()
    assert snap["counters"]["completed"] == 11
    assert snap["kernel"]["score/b8/k4"]["path"] == "reference"


@pytest.mark.parametrize("n", [1, 3, 7, 17])
def test_padded_bucket_parity_score(tiny, n):
    """Engine score over a ragged batch (padded to its bucket) == the
    program the engine serves (its dispatch config) on exactly those rows,
    unpadded, with the same seeds. On the CPU this holds bitwise: the
    row's arithmetic does not change with the batch size."""
    eng = make_engine(tiny, max_batch=32)
    x = tiny["x"][:n]
    got = eng.score(x)
    direct = tprog.score_rows(eng._params, eng._kernel_for("score")[0], 0,
                              list(range(n)), torch.from_numpy(x), K).numpy()
    assert np.array_equal(got, direct)


@pytest.mark.parametrize("op", ["encode", "decode"])
def test_padded_bucket_parity_encode_decode(tiny, op):
    eng = make_engine(tiny, max_batch=32)
    payload = tiny["x"][:7] if op == "encode" \
        else np.random.RandomState(2).randn(7, 5).astype(np.float32)
    got = getattr(eng, op)(payload)
    prog = tprog.PROGRAMS[op][0]
    args = (torch.from_numpy(payload), K) if op == "encode" \
        else (torch.from_numpy(payload),)
    direct = prog(eng._params, eng._kernel_for(op)[0], 0, list(range(7)),
                  *args).numpy()
    assert np.array_equal(got, direct)


def test_serial_vs_pipelined_parity(tiny):
    """Results do not depend on how the work was pipelined: the serial
    engine and the threaded pipelined engine agree bitwise per seed."""
    serial = make_engine(tiny, max_inflight=0, max_wait_us=100.0).start()
    piped = make_engine(tiny, max_inflight=2, max_wait_us=100.0).start()
    try:
        fs = [e.submit("score", r, seed=i)
              for e in (serial, piped) for i, r in enumerate(tiny["x"])]
        out = np.array([f.result(timeout=60) for f in fs])
    finally:
        serial.stop()
        piped.stop()
    n = len(tiny["x"])
    assert np.array_equal(out[:n], out[n:])
    assert piped.metrics.inflight == 0


def test_stop_drains_everything(tiny):
    eng = make_engine(tiny, max_wait_us=1e6).start()
    fs = [eng.submit("score", r) for r in tiny["x"][:5]]
    eng.stop()
    assert all(f.done() for f in fs)
    assert np.isfinite([f.result() for f in fs]).all()


def test_backpressure_sheds(tiny):
    eng = make_engine(tiny, queue_limit=2)
    eng.submit("score", tiny["x"][0])
    eng.submit("score", tiny["x"][1])
    with pytest.raises(EngineOverloaded):
        eng.submit("score", tiny["x"][2])
    assert eng.metrics.snapshot()["counters"]["shed"] == 1
    assert eng.flush() == 1


def test_timeout_is_a_per_request_error(tiny):
    eng = make_engine(tiny, timeout_s=0.0)
    fut = eng.submit("score", tiny["x"][0])
    eng.flush()
    with pytest.raises(RequestTimeout):
        fut.result(timeout=5)
    assert eng.metrics.snapshot()["counters"]["timeouts"] == 1


def test_k_max_and_request_validation(tiny):
    eng = make_engine(tiny, k_max=8)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit("score", tiny["x"][0], k=9)
    with pytest.raises(ValueError, match="integer"):
        eng.submit("score", tiny["x"][0], k=2.5)
    with pytest.raises(ValueError, match="features"):
        eng.submit("score", tiny["x"][0][:5])
    with pytest.raises(ValueError, match="unknown op"):
        eng.submit("score_adaptive", tiny["x"][0])
    with pytest.raises(ValueError, match="seed"):
        eng.submit("score", tiny["x"][0], seed=-1)
    with pytest.raises(ValueError, match="below"):
        make_engine(tiny, k=8, k_max=4)
    assert eng.score(tiny["x"][0], k=8).shape == ()


def test_model_label_is_enforced(tiny):
    eng = make_engine(tiny, model="a")
    with pytest.raises(ValueError, match="unknown model"):
        eng.submit("score", tiny["x"][0], model="b")
    fut = eng.submit("score", tiny["x"][0], model="a")
    eng.flush()
    assert np.isfinite(fut.result())


@pytest.mark.parametrize("bad,err,match", [
    (dict(precision="int4"), ValueError, "precision"),
    (dict(precision="fp16"), ValueError, "precision"),
    (dict(kernel_path="pallas"), ValueError, "kernel_path"),
    (dict(kernel_path="kernel"), ValueError, "CUDA"),
    (dict(max_inflight=-1), ValueError, "max_inflight"),
])
def test_engine_construction_errors(tiny, bad, err, match):
    with pytest.raises(err, match=match):
        make_engine(tiny, **bad)


def test_no_cuda_means_an_error_not_a_cpu_engine(tiny, monkeypatch):
    """``device=None`` means the card; without one the engine and the zoo
    raise instead of quietly serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params=tiny["params"], model_config=tiny["cfg"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.serving_engine("northstar-iwae-2l-k50")


def test_precision_policies_set_the_compute_dtype(tiny):
    assert make_engine(tiny, precision="bf16").cfg.compute_dtype == "bfloat16"
    assert make_engine(tiny, precision="fp32").cfg.compute_dtype is None
    bf = make_engine(tiny, precision="bf16").score(tiny["x"][:3])
    fp = make_engine(tiny, precision="fp32").score(tiny["x"][:3])
    assert np.isfinite(bf).all() and not np.array_equal(bf, fp)


def test_warmup_covers_the_ladder(tiny):
    eng = make_engine(tiny)
    warm = eng.warmup()
    assert warm["programs"] == 3 * len(eng.ladder.buckets)
    assert eng.metrics.snapshot()["kernel_path"] == 0


# --------------------------------------------------------------------------
# zoo, config and CLI
# --------------------------------------------------------------------------

def test_zoo_engine_on_cpu_is_the_flagship():
    eng = zoo.serving_engine("northstar-iwae-2l-k50", device="cpu")
    assert eng.k == 50 and eng.cfg.compute_dtype == "bfloat16"
    assert eng.cfg.n_hidden_enc == (200, 100) and eng.cfg.x_dim == 784
    again = zoo.serving_engine("northstar-iwae-2l-k50", device="cpu")
    assert torch.equal(eng._params["out"]["out"]["w"],
                       again._params["out"]["out"]["w"])
    assert set(zoo.configs()) >= {"northstar-iwae-2l-k50", "table1-iwae-2l-k50"}
    with pytest.raises(KeyError, match="did you mean"):
        zoo.get("northstar-iwae-2l-k5")


def test_experiment_config_fused_auto_is_logits_and_cuda():
    cfg = ExperimentConfig()
    assert cfg.model_config("cuda").fused_likelihood
    assert not cfg.model_config("cpu").fused_likelihood
    assert not ExperimentConfig(likelihood="clamp").model_config(
        "cuda").fused_likelihood
    assert ExperimentConfig(compute_dtype="float32").compute_dtype is None
    with pytest.raises(ValueError, match="precision"):
        ExperimentConfig(serving_precision="int4")


def test_cli_synthetic_load_on_cpu(capsys):
    rc = cli.main(["--device", "cpu", "--requests", "6", "--sizes", "1,3",
                   "--ops", "score,decode", "--max-batch", "4"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["failed"] == 0 and doc["device"] == "cpu"
    assert doc["counters"]["completed"] == 12
    assert doc["warmup"]["programs"] == 2 * 3


# --------------------------------------------------------------------------
# the port imports neither JAX nor the JAX package
# --------------------------------------------------------------------------

def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root == "jax" or root == "jaxlib" or \
        root == "iwae_replication_project_tpu"


#: the card scripts that import the port alone (the others' JAX halves
#: import JAX inside their own functions)
PORT_SCRIPTS = ("scripts/torch_run_replication.py",
                "scripts/torch_estimator_convergence.py",
                "scripts/torch_dress_rehearsal.py",
                "scripts/torch_prepare_data.py")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + [
        REPO / s for s in PORT_SCRIPTS]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_port_sources(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """Import every port module, chip_smoke.py and the port's card scripts
    (``PORT_SCRIPTS``) in a fresh interpreter: neither jax nor the JAX
    package may end up in sys.modules."""
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import iwae_replication_project_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        + "".join(f"runpy.run_path({s!r}, run_name='not_main')\n"
                  for s in PORT_SCRIPTS) +
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'iwae_replication_project_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


def test_chip_smoke_refuses_to_run_without_cuda():
    """Without a card chip_smoke.py exits non-zero and prints no result."""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_many_submitters_one_engine(tiny):
    """More submitting threads than cores against the pipelined engine:
    every future completes exactly once and counters add up."""
    eng = make_engine(tiny, max_wait_us=200.0).start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            fs = list(pool.map(lambda i: eng.submit(
                "score", tiny["x"][i % 17], seed=i), range(96)))
        vals = [f.result(timeout=60) for f in fs]
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert np.isfinite(vals).all()
    c = eng.metrics.snapshot()["counters"]
    assert c["submitted"] == c["completed"] == 96


# --------------------------------------------------------------------------
# the copied framework-free pieces: batcher policy and the registry
# --------------------------------------------------------------------------

def test_micro_batcher_policy_on_a_fake_clock():
    from iwae_replication_project_tpu_torch.serving.batcher import (
        MicroBatcher, Request)

    now = [0.0]
    mb = MicroBatcher(max_batch=3, max_wait_us=1000.0, queue_limit=8,
                      clock=lambda: now[0])

    def req(op="score", k=4, deadline=None):
        return Request(op=op, payload=np.zeros(2, np.float32), k=k, seed=0,
                       t_enqueue=now[0], deadline=deadline)

    for _ in range(4):
        mb.submit(req())
    mb.submit(req(k=8))
    mb.submit(req(k=16, deadline=0.0005))
    expired, batches = mb.poll()
    assert expired == [] and [len(b) for b in batches] == [3]  # full batch
    assert mb.next_event() == 0.0005
    now[0] = 0.0006
    expired, batches = mb.poll()
    assert len(expired) == 1 and batches == []   # k=16 expired, rest waits
    now[0] = 0.002                               # max_wait passed
    expired, batches = mb.poll()
    assert sorted(len(b) for b in batches) == [1, 1] and expired == []
    assert mb.pending == 0 and mb.next_event() is None


def test_inflight_window_bounds_and_drains():
    from iwae_replication_project_tpu_torch.serving.batcher import (
        InflightWindow)

    seen = []
    w = InflightWindow(2, on_change=seen.append)
    assert w.acquire() and w.acquire()
    assert w.acquire(abort=lambda: True) is False    # forced past the limit
    w.release()
    w.commit("a")
    w.commit("b")
    assert w.pop() == "a" and w.pop() == "b"
    w.done()
    w.done()
    assert w.inflight == 0 and w.pop(stop=lambda: True) is None
    assert max(seen) == 3 and seen[-1] == 0


def test_registry_instruments_and_percentiles():
    from iwae_replication_project_tpu_torch.telemetry.registry import (
        MetricRegistry)

    reg = MetricRegistry()
    reg.counter("c").inc(2)
    reg.gauge("g").set(1.5)
    h = reg.histogram("h")
    for v in (1e-3, 2e-3, 3e-3, 1.0):
        h.record(v)
    snap = reg.snapshot()
    assert snap["counters"] == {"c": 2} and snap["gauges"] == {"g": 1.5}
    s = snap["histograms"]["h"]
    assert s["count"] == 4 and s["max"] == 1.0
    assert 2e-3 <= s["p50"] <= 2e-3 * 10 ** (1 / 8) and s["p99"] == 1.0
    with pytest.raises(ValueError, match="different instrument"):
        reg.gauge("c")
