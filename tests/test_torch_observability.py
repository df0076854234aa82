"""The port's observability plane against the JAX package's: the Prometheus
page byte for byte, the dispatch profiler's snapshot and findings, the FLOP
accounting of every zoo preset, the ``span/*`` names of a serving run and
of a driver run, the metrics server's endpoints on a CPU tier of the CLI,
the trace dump across the two packages' tiers, profiled rows bitwise
unprofiled ones, the store's bill of a captured entry (C7), ``nan_guard``,
``StepTimer`` and ``trace``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the page, the span names, the FLOP counts, the document keys
and the served rows are compared exactly; the profilers' floats to 1e-12
relative (the same float operations in the same order; the tolerance
covers nothing but repr round trips).
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu import zoo as jzoo
from iwae_replication_project_tpu.experiment import (
    run_experiment as jrun_experiment,
)
from iwae_replication_project_tpu.serving import frontend as jfront
from iwae_replication_project_tpu.serving.engine import (
    ServingEngine as JEngine,
)
from iwae_replication_project_tpu.telemetry import exporters as jexp
from iwae_replication_project_tpu.telemetry import profiling as jprof
from iwae_replication_project_tpu.telemetry import registry as jreg
from iwae_replication_project_tpu.telemetry import trace_cli as jtrace_cli
from iwae_replication_project_tpu.utils import compile_cache as jcc
from iwae_replication_project_tpu.utils import flops as jflops
from iwae_replication_project_tpu.utils import profiling as jutil_prof
from iwae_replication_project_tpu.utils.config import (
    ExperimentConfig as JConfig,
)
from iwae_replication_project_tpu_torch import zoo as tzoo
from iwae_replication_project_tpu_torch.experiment import (
    run_experiment as trun_experiment,
)
from iwae_replication_project_tpu_torch.serving import frontend as tfront
from iwae_replication_project_tpu_torch.serving.engine import (
    ServingEngine as TEngine,
)
from iwae_replication_project_tpu_torch.serving.programs import static_cost
from iwae_replication_project_tpu_torch.telemetry import exporters as texp
from iwae_replication_project_tpu_torch.telemetry import profiling as tprof
from iwae_replication_project_tpu_torch.telemetry import registry as treg
from iwae_replication_project_tpu_torch.telemetry import (
    trace_cli as ttrace_cli,
)
from iwae_replication_project_tpu_torch.utils import compile_cache as tcc
from iwae_replication_project_tpu_torch.utils import flops as tflops
from iwae_replication_project_tpu_torch.utils import profiling as tutil_prof
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig
from torch_parity import binary_rows, configs, params

REPO = Path(__file__).resolve().parents[1]
WAIT = 60.0
#: the profilers' floats: the same operations in the same order
PROF_RTOL = 1e-12


@pytest.fixture
def fresh_registries(monkeypatch):
    """Empty process-default registries in both packages for the test."""
    j, t = jreg.MetricRegistry(), treg.MetricRegistry()
    monkeypatch.setattr(jreg, "_DEFAULT", j)
    monkeypatch.setattr(treg, "_DEFAULT", t)
    return j, t


def _span_names(reg, drop_aot=False):
    names = {k for k in reg.snapshot()["histograms"] if k.startswith("span/")}
    if drop_aot:
        names = {n for n in names if "/aot/" not in n}
    return sorted(names)


# --------------------------------------------------------------------------
# the Prometheus page
# --------------------------------------------------------------------------

NAMES = ["latency/score/b8", "queue_wait/score/b8", "device_wait/encode",
         "router/completed", "slo/burn/5m", "span/serve/dispatch/score",
         "store/hits", "kernel/path", "autotune/hits", "telemetry/x",
         "diag/ess", "prof/device_s/m/serve_score/b64/k50", "plain",
         "9starts-with-digit", 'odd"name\\with\nnewline', "dots.and-dash"]


def _fill(reg, rng_seed):
    rng = np.random.RandomState(rng_seed)
    for i, name in enumerate(NAMES):
        kind = i % 3
        if kind == 0:
            reg.counter(name).inc(int(rng.randint(1, 1000)))
        elif kind == 1:
            reg.gauge(name).set(float(rng.randn()) * 10 ** int(
                rng.randint(-6, 6)))
        else:
            h = reg.histogram(name)
            for v in rng.lognormal(-6, 2, size=int(rng.randint(1, 60))):
                h.record(float(v))
    reg.histogram("empty/histogram")
    reg.gauge("flag/bool").set(True)


def test_prometheus_text_is_byte_equal_to_jax(fresh_registries):
    jproc, tproc = fresh_registries
    jr, tr = jreg.MetricRegistry(), treg.MetricRegistry()
    _fill(jr, 0)
    _fill(tr, 0)
    # a second registry colliding on some names: last writer wins, counted
    j2, t2 = jreg.MetricRegistry(), treg.MetricRegistry()
    for r2 in (j2, t2):
        r2.counter("router/completed").inc(3)
        r2.gauge("plain").set(0.25)
        r2.histogram("span/serve/dispatch/score").record(0.5)
    want = jexp.prometheus_text((jr, j2))
    got = texp.prometheus_text((tr, t2))
    assert got.encode() == want.encode()
    assert "# HELP iwae_span_serve_dispatch_score host-side span" in got
    assert 'quantile="0.5"' in got and "_sum " in got
    # router/completed and the span histogram collide ("plain" is a
    # counter in one registry and a gauge in the other: no collision)
    assert jproc.counter("telemetry/export_collisions").value == \
        tproc.counter("telemetry/export_collisions").value == 2
    # one registry, no collision
    assert texp.prometheus_text(tr) == jexp.prometheus_text(jr)


# --------------------------------------------------------------------------
# the dispatch profiler
# --------------------------------------------------------------------------

def _observations(seed=3):
    """A (program, bucket, k-class) mix with jitter, then a 2x interval on
    every key after warm-up, adaptive samples on one key."""
    rng = np.random.RandomState(seed)
    keys = [("serve_score", 64, 50, 1.2e-3), ("serve_score", 8, 50, 4e-4),
            ("serve_encode", 64, 50, 3e-4), ("serve_decode", 4, 0, 1e-4),
            ("serve_score_adaptive", 8, "dyn", 2e-3)]
    obs = []
    for i in range(30):
        for program, bucket, kc, base in keys:
            dev = base * float(rng.lognormal(0.0, 0.02))
            if i == 20:
                dev *= 2.0                       # the fake 2x interval
            if i == 25 and program == "serve_decode":
                dev = -1e-6                      # a clock artifact
            rows = int(rng.randint(1, bucket + 1))
            flops = None if program == "serve_decode" else \
                float(rng.randint(1, 10 ** 6)) * 1e3
            cost = None if program.endswith("adaptive") else {
                "flops": float(rng.randint(1, 10 ** 6)) * 1e3,
                "bytes_accessed_fused": float(rng.randint(1, 10 ** 7))}
            samples = float(rng.randint(rows, rows * 250)) \
                if program.endswith("adaptive") else None
            obs.append(dict(program=program, bucket=bucket, k_class=kc,
                            rows=rows, device_s=dev, flops=flops, cost=cost,
                            samples=samples))
    return obs


def _close(a, b, path="doc"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        assert math.isclose(a, b, rel_tol=PROF_RTOL, abs_tol=0.0) or \
            (math.isinf(a) and a == b), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("peaks", ["explicit", "config", "none"])
def test_dispatch_profiler_matches_jax(peaks):
    kw = {}
    if peaks == "explicit":
        pk = {"peak_flops": 989e12, "peak_hbm_bytes": 3.35e12,
              "source": "test"}
        jkw, tkw = dict(peaks=dict(pk)), dict(peaks=dict(pk))
    elif peaks == "config":
        kw = dict(peak_flops=1e12, peak_hbm_bytes=1e11)
        none = {"peak_flops": None, "peak_hbm_bytes": None, "source": "-"}
        jkw = dict(peaks=dict(none),
                   config=jprof.ProfilingConfig(warmup_samples=4, **kw))
        tkw = dict(peaks=dict(none),
                   config=tprof.ProfilingConfig(warmup_samples=4, **kw))
    else:
        none = {"peak_flops": None, "peak_hbm_bytes": None, "source": "-"}
        jkw, tkw = dict(peaks=dict(none)), dict(peaks=dict(none))
    jp = jprof.DispatchProfiler(registry=jreg.MetricRegistry(),
                                label="m@bf16", **jkw)
    tp = tprof.DispatchProfiler(registry=treg.MetricRegistry(),
                                label="m@bf16", **tkw)
    jf, tf = [], []
    for o in _observations():
        jf.append(jp.observe(**o))
        tf.append(tp.observe(**o))
    assert [f is None for f in jf] == [f is None for f in tf]
    assert any(f is not None for f in tf), "the 2x interval must alarm"
    _close(jp.snapshot(), tp.snapshot())
    _close(jp.findings(), tp.findings())
    _close(jp.findings(limit=2), tp.findings(limit=2))
    _close(jp.registry.snapshot(), tp.registry.snapshot())
    for cost in (None, {"flops": 1e9}, {"bytes_accessed_fused": 5e6},
                 {"flops": 1e9, "bytes_accessed_fused": 5e9}):
        assert jprof.DispatchProfiler.static_floor_s(cost, jp.peaks) == \
            tprof.DispatchProfiler.static_floor_s(cost, tp.peaks)


def test_profiling_config_validation_matches_jax():
    for bad in (dict(ewma_alpha=0.0), dict(z_threshold=0.0),
                dict(warmup_samples=1)):
        with pytest.raises(ValueError):
            jprof.ProfilingConfig(**bad)
        with pytest.raises(ValueError):
            tprof.ProfilingConfig(**bad)


def test_chip_peaks_name_the_h100_row_and_nothing_else():
    """The card rows: the H100 SXM5 at its bf16 and HBM peaks; any other
    card, and the CPU, get None peaks with a reason; the TPU rows are
    JAX's."""
    for name in ("NVIDIA H100 80GB HBM3", "H100 SXM5 80GB"):
        assert tflops.peak_flops_for_card(name)[0] == 989e12
        assert tflops.peak_hbm_bytes_for_card(name)[0] == 3.35e12
    for name in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                 "NVIDIA A100-SXM4-80GB", "Tesla V100-SXM2-16GB",
                 "NVIDIA GeForce RTX 4090"):
        val, why = tflops.peak_flops_for_card(name)
        assert val is None and name in why
        assert tflops.peak_hbm_bytes_for_card(name)[0] is None
    assert tflops.PEAK_BF16_FLOPS == jflops.PEAK_BF16_FLOPS
    assert tflops.PEAK_HBM_BYTES == jflops.PEAK_HBM_BYTES
    peaks = tprof.detect_chip_peaks("cpu")
    assert peaks["peak_flops"] is None and peaks["peak_hbm_bytes"] is None
    assert "cpu" in peaks["source"]
    eng = TEngine(params=params(configs(1)[0])[1], model_config=configs(1)[1],
                  k=4, max_batch=4, device="cpu")
    assert eng.profiler.peaks["peak_flops"] is None


# --------------------------------------------------------------------------
# FLOP accounting
# --------------------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(tzoo.configs()))
def test_flop_counts_match_jax(preset):
    jcfg = jzoo.get(preset).model_config()
    tcfg = tzoo.get(preset).model_config("cpu")
    assert tflops.per_row_macs(tcfg) == jflops.per_row_macs(jcfg)
    assert tflops.param_count(tcfg) == jflops.param_count(jcfg)
    for dt in ("float32", "bfloat16"):
        assert tflops.model_param_bytes(tcfg, dt) == \
            jflops.model_param_bytes(jcfg, dt)
    for b, k in ((1, 1), (64, 50), (100, 5000), (7, 13)):
        assert tflops.forward_flops(tcfg, b, k) == \
            jflops.forward_flops(jcfg, b, k)
        assert tflops.train_step_flops(tcfg, b, k) == \
            jflops.train_step_flops(jcfg, b, k)
        assert tflops.serving_score_flops_per_row(tcfg, k) == \
            jflops.serving_score_flops_per_row(jcfg, k)
    assert tflops.eval_suite_flops_per_image(tcfg, 50, 5000, 250) == \
        jflops.eval_suite_flops_per_image(jcfg, 50, 5000, 250)
    for n, cap in ((5000, 250), (1000, 300), (97, 10), (12, 100)):
        assert tflops.largest_divisor_leq(n, cap) == \
            jflops.largest_divisor_leq(n, cap)
    # the static cost record of a score program counts the forward
    assert static_cost(tcfg, "score", 50, 64)["flops"] == \
        jflops.forward_flops(jcfg, 64, 50)


def test_static_cost_record_of_the_flagship():
    """score/b64 at k=50: 2 x 64 x (236,800 + 50 x 281,800) FLOPs; the
    unavoidable bytes are the fp32 weights, payload, noise and output."""
    cfg = tzoo.get("northstar-iwae-2l-k50").model_config("cpu")
    rec = static_cost(cfg, "score", 50, 64)
    assert rec["flops"] == 2.0 * 64 * (236_800 + 50 * 281_800)
    noise = 50 * 64 * sum(cfg.n_latent_enc)
    assert rec["bytes_accessed_fused"] == 4.0 * (
        tflops.param_count(cfg) + 64 * 784 + noise + 64)
    enc = static_cost(cfg, "encode", 50, 64)
    dec = static_cost(cfg, "decode", 0, 64)
    # encode + the decoder at k x bucket rows = the score's forward
    assert enc["flops"] + 50 * dec["flops"] == rec["flops"]


# --------------------------------------------------------------------------
# span names
# --------------------------------------------------------------------------

def test_serving_span_names_match_jax(fresh_registries):
    jproc, tproc = fresh_registries
    jcfg, tcfg = configs(1)
    jp, tp = params(jcfg)
    x = binary_rows(5)
    h = np.zeros((2, jcfg.n_latent_enc[-1]), np.float32)
    with jcc.isolated_aot_registry():
        je = JEngine(params=jp, model_config=jcfg, k=4, max_batch=4)
        je.warmup()
        je.score(x)
        je.encode(x)
        je.decode(h)
    with tcc.isolated_aot_registry():
        te = TEngine(params=tp, model_config=tcfg, k=4, max_batch=4,
                     device="cpu")
        te.warmup()
        te.score(x)
        te.encode(x)
        te.decode(h)
    want = _span_names(je.metrics.registry)
    assert _span_names(te.metrics.registry) == want
    assert "span/serve/warmup" in want and \
        "span/serve/complete/decode" in want
    want = _span_names(jproc)
    assert _span_names(tproc) == want
    assert "span/serve/dispatch/score/aot/serve_score" in want
    # the profilers' keys and instruments' names agree too
    assert sorted(te.profiler.snapshot()["keys"]) == \
        sorted(je.profiler.snapshot()["keys"])
    names = lambda r: sorted(  # noqa: E731
        k for kind in r.snapshot().values() for k in kind
        if k.startswith("prof/"))
    assert names(te.metrics.registry) == names(je.metrics.registry)


def _driver_config(cls, tmp_path, sub, **extra):
    return cls(dataset="binarized_mnist", data_dir=str(tmp_path / "data"),
               n_hidden_encoder=(16,), n_hidden_decoder=(16,),
               n_latent_encoder=(4,), n_latent_decoder=(784,),
               loss_function="IWAE", k=4, batch_size=32, n_stages=2,
               eval_k=4, nll_k=8, nll_chunk=4, eval_batch_size=16,
               activity_samples=8, log_dir=str(tmp_path / sub / "runs"),
               checkpoint_dir=str(tmp_path / sub / "ckpt"), **extra)


def test_driver_span_names_match_jax(tmp_path, fresh_registries):
    """A 2-stage tiny driver run in each package: the same ``span/*`` names
    once JAX's ``aot/*`` ones are left out (the port's training does not
    resolve through a store)."""
    jproc, tproc = fresh_registries
    torch.set_num_threads(1)
    with jcc.isolated_aot_registry():
        jrun_experiment(_driver_config(JConfig, tmp_path, "jax",
                                       save_figures=False),
                        max_batches_per_pass=1)
    trun_experiment(_driver_config(ExperimentConfig, tmp_path, "port"),
                    max_batches_per_pass=1, device="cpu")
    want = _span_names(jproc, drop_aot=True)
    assert _span_names(tproc) == want
    assert {"span/train/stage", "span/train/stage/train/epoch",
            "span/eval/statistics", "span/eval/diagnostics"} <= set(want)


# --------------------------------------------------------------------------
# profiling never changes a row
# --------------------------------------------------------------------------

def test_profiled_rows_are_bitwise_unprofiled_rows():
    jcfg, tcfg = configs(2)
    _, tp = params(jcfg, seed=2)
    x = binary_rows(11, seed=4)
    out = {}
    for prof in (True, False):
        eng = TEngine(params=tp, model_config=tcfg, k=6, max_batch=8,
                      device="cpu", profiling=prof)
        with tcc.isolated_aot_registry():
            futs = [eng.submit("score", r, seed=i) for i, r in enumerate(x)]
            futs += [eng.submit("encode", r, seed=i)
                     for i, r in enumerate(x[:5])]
            eng.flush()
            out[prof] = [f.result() for f in futs]
        names = [k for kind in eng.metrics.registry.snapshot().values()
                 for k in kind if k.startswith("prof/")]
        if prof:
            snap = eng.profiler.snapshot()
            assert snap["keys"] and all(d["count"] > 0
                                        for d in snap["keys"].values())
            assert names and snap["label"] is None
        else:
            assert eng.profiler is None and not names
    for a, b in zip(out[True], out[False]):
        assert np.array_equal(a, b)


# --------------------------------------------------------------------------
# the metrics server, the CLI's tier mode, the trace dump
# --------------------------------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=WAIT) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_metrics_server_healthz_prof_and_404():
    reg = treg.MetricRegistry()
    reg.counter("router/completed").inc(2)
    prof = tprof.DispatchProfiler(registry=reg, peaks={
        "peak_flops": None, "peak_hbm_bytes": None, "source": "-"})
    prof.observe(program="serve_score", bucket=4, k_class=5, rows=3,
                 device_s=1e-3)

    def boom():
        raise RuntimeError("tier is dying")

    servers = [texp.start_metrics_server(reg, 0, profilers=[prof]),
               texp.start_metrics_server(reg, 0, health=boom),
               texp.start_metrics_server(reg, 0,
                                         health=lambda: {"ok": False})]
    try:
        ports = [s.server_address[1] for s in servers]
        status, ctype, body = _get(ports[0], "/metrics")
        assert status == 200 and ctype.startswith("text/plain; version=0.0.4")
        assert body.decode() == texp.prometheus_text(reg)
        status, _, body = _get(ports[0], "/healthz")
        assert status == 200 and json.loads(body) == {"ok": True}
        status, _, body = _get(ports[0], "/prof")
        assert status == 200 and json.loads(body)["profilers"][0]["keys"]
        assert _get(ports[0], "/traces")[0] == 404
        assert _get(ports[0], "/nope")[0] == 404
        status, _, body = _get(ports[1], "/healthz")
        assert status == 503 and json.loads(body) == {
            "ok": False, "error": "tier is dying"}
        assert _get(ports[1], "/prof")[0] == 404
        assert _get(ports[2], "/healthz")[0] == 503
    finally:
        for s in servers:
            s.shutdown()
    # shutdown() also closed the socket: the port can be bound again
    again = texp.start_metrics_server(reg, ports[0])
    again.shutdown()


def _start_cli(args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "iwae_replication_project_tpu_torch.serving",
         "--preset", "digits-vae-1l-k1", "--device", "cpu", "--max-batch",
         "4", "--port", "0", "--metrics-port", "0"] + args,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(REPO), env=env)
    line = proc.stdout.readline()
    if not line.startswith("{"):
        proc.kill()
        raise AssertionError(proc.stderr.read()[-3000:])
    return proc, json.loads(line)


def _finish_cli(proc):
    proc.stdin.close()
    try:
        rc = proc.wait(timeout=WAIT)
    finally:
        if proc.poll() is None:
            proc.kill()
    return rc, proc.stdout.read()


def test_cli_tier_serves_the_metrics_page(tmp_path):
    """``--replicas 2 --metrics-port 0`` on the CPU: the page carries the
    router's and the SLO's families, /healthz answers 200, /traces holds
    Chrome events, /prof one document per replica; the port's trace dump
    against it writes a Chrome JSON; the tier exits 0 on stdin EOF."""
    proc, ready = _start_cli(["--replicas", "2"])
    try:
        mport, port = ready["metrics_port"], ready["tier"]["port"]
        assert isinstance(mport, int) and mport > 0
        with tfront.TierClient("127.0.0.1", port, timeout_s=WAIT) as c:
            rows = binary_rows(3, d=784).tolist()
            for i in range(6):
                c.score(rows[: 1 + i % 3])
        status, ctype, body = _get(mport, "/metrics")
        page = body.decode()
        assert status == 200 and "version=0.0.4" in ctype
        assert "iwae_router_completed_total" in page
        assert "iwae_slo_" in page
        status, _, body = _get(mport, "/healthz")
        doc = json.loads(body)
        assert status == 200 and doc["ok"] and doc["healthy"] == 2
        status, _, body = _get(mport, "/traces")
        assert status == 200 and "traceEvents" in json.loads(body)
        status, _, body = _get(mport, "/prof")
        profs = json.loads(body)["profilers"]
        assert status == 200 and len(profs) == 2
        assert sum(d["count"] for p in profs for d in p["keys"].values()) > 0
        out = tmp_path / "traces.json"
        assert ttrace_cli.main([f"127.0.0.1:{port}", "--out",
                                str(out)]) == 0
        assert "traceEvents" in json.loads(out.read_text())
    finally:
        rc, _ = _finish_cli(proc)
    assert rc == 0


def test_cli_engine_mode_serves_prof_and_span_families():
    proc, ready = _start_cli(["--interactive"])
    try:
        mport = ready["metrics_port"]
        row = binary_rows(1, d=784)[0].tolist()
        proc.stdin.write(json.dumps({"op": "score", "x": [row]}) + "\n")
        proc.stdin.flush()
        assert "result" in json.loads(proc.stdout.readline())
        page = _get(mport, "/metrics")[2].decode()
        assert "iwae_prof_device_s_" in page
        assert "iwae_span_serve_dispatch_score" in page
        assert "iwae_span_serve_warmup" in page
        status, _, body = _get(mport, "/prof")
        assert status == 200 and len(json.loads(body)["profilers"]) == 1
        assert _get(mport, "/healthz")[0] == 200
    finally:
        rc, _ = _finish_cli(proc)
    assert rc == 0


class _FakeEngine:
    """The minimal engine surface both tiers route to."""

    def __init__(self):
        self.row_dims = {"score": 4, "encode": 4, "decode": 4}
        self.k = 5

    def submit(self, op, row, k=None, *, seed=None, model=None):
        f = Future()
        f.set_result(float(seed or 0) + float(sum(row)))
        return f

    def start(self):
        pass

    def stop(self, timeout_s=None):
        pass

    def warmup(self, ops=(), ks=None):
        return {}


@contextlib.contextmanager
def _fake_tiers():
    """A JAX tier and a port tier over fake engines, each with traced
    requests in its flight recorder."""
    jt = jfront.ServingTier([_FakeEngine()], monitor_interval_s=0.05).start()
    tt = tfront.ServingTier([_FakeEngine()], monitor_interval_s=0.05).start()
    try:
        for front, tier in ((jfront, jt), (tfront, tt)):
            with front.TierClient("127.0.0.1", tier.port,
                                  timeout_s=WAIT, trace=True) as c:
                for i in range(4):
                    c.score([[1.0, 0.0, 0.0, 0.0]], seed=i)
        yield jt, tt
    finally:
        jt.stop(timeout_s=10)
        tt.stop(timeout_s=10)


def _dump(main, port, args, capsys):
    rc = main([f"127.0.0.1:{port}"] + args)
    return rc, json.loads(capsys.readouterr().out)


def _keys(doc):
    if isinstance(doc, dict):
        return {k: _keys(v) if k in ("data", "stats") else None
                for k, v in doc.items()}
    return type(doc).__name__


@pytest.mark.parametrize("args", [[], ["--raw", "--limit", "2"], ["--stats"],
                                  ["--json"], ["--raw", "--json"]])
def test_trace_dump_across_the_two_packages(args, capsys):
    """JAX's trace dump against a port tier and the port's against a JAX
    tier: exit 0 and the same document keys as each against its own."""
    with _fake_tiers() as (jt, tt):
        docs = {}
        for name, main in (("jax", jtrace_cli.main),
                           ("port", ttrace_cli.main)):
            for tname, tier in (("jax", jt), ("port", tt)):
                rc, doc = _dump(main, tier.port, args, capsys)
                assert rc == 0, (name, tname)
                docs[name, tname] = _keys(doc)
    want = docs["jax", "jax"]
    assert all(d == want for d in docs.values()), docs
    if "--json" in args:
        assert want["tool"] is None and "data" in want


def test_trace_dump_reports_an_unreachable_tier(capsys):
    from iwae_replication_project_tpu.analysis.regress import (
        ENVELOPE_SCHEMA, make_envelope)

    assert ttrace_cli.main(["127.0.0.1:1"]) == 2
    assert "cannot reach" in capsys.readouterr().err
    assert ttrace_cli.ENVELOPE_SCHEMA == ENVELOPE_SCHEMA
    for kw in (dict(ok=True, data={}), dict(ok=False, findings=[{"a": 1}])):
        assert ttrace_cli.make_envelope("iwae-trace", "chrome", **kw) == \
            make_envelope("iwae-trace", "chrome", **kw)


def test_router_profilers_are_the_replica_engines():
    jcfg, tcfg = configs(1)
    _, tp = params(jcfg)
    engines = [TEngine(params=tp, model_config=tcfg, k=4, max_batch=4,
                       device="cpu", profiling=p) for p in (True, False,
                                                            True)]
    router = tfront.ReplicaRouter(engines + [_FakeEngine()])
    try:
        assert router.profilers() == (engines[0].profiler,
                                      engines[2].profiler)
    finally:
        router.drain(timeout_s=5)


# --------------------------------------------------------------------------
# the store bills a captured entry what it holds (C7)
# --------------------------------------------------------------------------

class _Holding:
    """A store entry that holds `pool_bytes` of device memory."""

    def __init__(self, pool_bytes):
        self.pool_bytes = pool_bytes
        self.released = False

    def release(self):
        self.released = True


def test_store_bills_an_entry_at_least_its_pool_bytes():
    with tcc.isolated_aot_registry(budget_bytes=None):
        store = tcc.executable_store()
        big = _Holding(5_000)
        exe, hit = store.get_or_build("serve_score", lambda r: big, ("a",),
                                      ("sig",), nbytes=100, model="m")
        assert exe is big and not hit
        small, _ = store.get_or_build("serve_score", lambda r: _Holding(10),
                                      ("b",), ("sig",), nbytes=300,
                                      model="m")
        assert [e["bytes"] for e in store.entries()] == [5_000, 300]
        assert [e["pool_bytes"] for e in store.entries()] == [5_000, 10]
        assert store.model_costs() == {"m": 5_300}
        assert store.resident_bytes == 5_300
        assert store.scalar_stats()["resident_bytes"] == 5_300
        assert treg.get_registry().gauge("store/resident_bytes").value == \
            5_300.0
        # the budget bounds the bills: admitting another holder evicts
        store.set_budget(6_000)
        store.get_or_build("serve_score", lambda r: _Holding(2_000), ("c",),
                           ("sig",), nbytes=10, model="m")
        assert big.released and store.resident_bytes == 2_300
        assert sum(e["pool_bytes"] for e in store.entries()) <= 6_000
        # readmitted, it is billed its new holding again
        store.set_budget(None)
        again = _Holding(7_000)
        _, hit = store.get_or_build("serve_score", lambda r: again, ("a",),
                                    ("sig",), nbytes=100, model="m")
        assert not hit and store.stats()["readmits"] == 1
        assert store.entries()[-1]["bytes"] == 7_000
    # an eager entry holds nothing: its bill is the reckoned one
    with tcc.isolated_aot_registry(budget_bytes=None):
        out, _ = tcc.aot_call_async("f", lambda t: t + 1,
                                    (torch.zeros(3),), nbytes=123)
        assert tcc.executable_store().entries()[0]["bytes"] == 123


# --------------------------------------------------------------------------
# utils/profiling
# --------------------------------------------------------------------------

def test_nan_guard_names_the_first_non_finite_op():
    x = torch.tensor([1.0, -1.0, 4.0])
    with tutil_prof.nan_guard():
        y = torch.sqrt(x.abs())                 # finite: runs
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)
        with pytest.raises(FloatingPointError, match="div"):
            x / torch.zeros(3)
    assert torch.equal(y, torch.tensor([1.0, 1.0, 2.0]))
    assert torch.isnan(torch.log(x)).any()      # off outside the guard
    with tutil_prof.nan_guard(enable=False):
        torch.log(x)

    class NanGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t * 2

        @staticmethod
        def backward(ctx, g):
            return g * float("nan")

    w = torch.ones(3, requires_grad=True)
    with tutil_prof.nan_guard():
        loss = NanGrad.apply(w).sum()
        with pytest.raises((FloatingPointError, RuntimeError)):
            loss.backward()


def test_assert_finite_tree():
    tree = {"a": torch.ones(2), "b": [torch.zeros(3), torch.ones(1)]}
    tutil_prof.assert_finite_tree(tree, "params")
    tree["b"][0][1] = float("inf")
    with pytest.raises(AssertionError, match="non-finite values in grads"):
        tutil_prof.assert_finite_tree(tree, "grads")


def test_step_timer_summary_schema_matches_jax():
    calls = []
    t = tutil_prof.StepTimer(sync_fn=lambda: calls.append(1))
    j = jutil_prof.StepTimer()
    assert t.summary() == j.summary() == {"count": 0}
    for timer in (t, j):
        for _ in range(5):
            with timer:
                time.sleep(0.001)
    ts, js = t.summary(), j.summary()
    assert sorted(ts) == sorted(js) and ts["count"] == js["count"] == 5
    assert len(calls) == 5 and t.count == 5
    assert 0.001 <= ts["p50_s"] <= ts["max_s"] and ts["total_s"] >= 0.005
    t.reset()
    assert t.summary() == {"count": 0}


def test_trace_writes_spans_into_a_chrome_trace(tmp_path):
    from iwae_replication_project_tpu_torch.telemetry.spans import span

    with tutil_prof.trace(str(tmp_path)) as tr:
        with span("serve/dispatch/score", registry=treg.MetricRegistry()):
            torch.ones(8) @ torch.ones(8)
    doc = json.loads(Path(tr.path).read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "serve/dispatch/score" in names


def test_spanned_nests_and_exposes_the_wrappee():
    from iwae_replication_project_tpu_torch.telemetry import spans

    reg = treg.MetricRegistry()
    seen = []

    def inner():
        seen.append(spans.current_span())
        return 7

    wrapped = spans.spanned(inner, "b", registry=reg)
    assert wrapped.__wrapped__ is inner and wrapped.__name__ == "inner"
    with spans.span("a", registry=reg):
        assert wrapped() == 7
    assert seen == ["a/b"] and spans.current_span() is None
    assert sorted(reg.snapshot()["histograms"]) == ["span/a", "span/a/b"]
    with pytest.raises(ValueError):
        with spans.span("c", registry=reg):
            raise ValueError("still recorded")
    assert reg.histogram("span/c").n == 1


def test_new_modules_are_under_the_import_checks():
    """The AST and fresh-process checks of tests/test_torch_serving.py walk
    every module of the port; this slice's modules are among them."""
    import pkgutil

    import iwae_replication_project_tpu_torch as port

    names = {m.name for m in pkgutil.walk_packages(port.__path__,
                                                   port.__name__ + ".")}
    for mod in ("telemetry.exporters", "telemetry.spans",
                "telemetry.profiling", "telemetry.trace_cli",
                "utils.flops", "utils.profiling"):
        assert f"{port.__name__}.{mod}" in names
    for path in ("telemetry/exporters.py", "telemetry/trace_cli.py",
                 "telemetry/profiling.py", "utils/flops.py"):
        text = (REPO / "iwae_replication_project_tpu_torch" / path) \
            .read_text()
        assert "import jax" not in text and \
            "from iwae_replication_project_tpu." not in text


def test_threads_share_no_span_stack():
    from iwae_replication_project_tpu_torch.telemetry import spans

    reg = treg.MetricRegistry()
    seen = {}

    def work(name):
        with spans.span(name, registry=reg):
            time.sleep(0.01)
            seen[name] = spans.current_span()

    threads = [threading.Thread(target=work, args=(n,)) for n in "xyz"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {"x": "x", "y": "y", "z": "z"}

