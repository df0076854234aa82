"""The port's measured autotuner (``ops/autotune.py``) and the hot loop's
blocked scan and env levers, held against the JAX package on the CPU.

Mirrors ``tests/test_autotune.py`` case for case where a case has a
counterpart: the winner cache's lifecycle (persistence and reload, a free
second tune, invalidation by version and, in place of the JAX key's chip
and VMEM budget, by the card's architecture, its name and the kernel
sources' digest, each on its own; a corrupt file warns and the hand rules
stand), the candidate space, the dispatcher's consultation points
(``select_path``, ``_scan_block_k``, the serving gate, B1's row groups) and
the search. Then the parts JAX has and the port gained here: the blocked
scan against JAX's ``_blocked_scan_impl`` and the port's reference, and
``IWAE_HOT_LOOP_PATH``/``IWAE_HOT_LOOP_SCAN_BYTES`` against JAX's
``select_path`` on the same env.
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.ops import hot_loop as jhl
from iwae_replication_project_tpu_torch.models.iwae import (
    ModelConfig,
    init_params,
)
from iwae_replication_project_tpu_torch.ops import autotune as at
from iwae_replication_project_tpu_torch.ops import hot_loop as hl
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine
from iwae_replication_project_tpu_torch.telemetry.registry import get_registry

#: one small shape shared by most tests (k, b, h1_dim, hid, n_pixels)
SHAPE = (4, 8, 10, 16, 20)

#: a card's identity for keys planted as if measured there
CARD = ("sm_90", "NVIDIA H100 80GB HBM3")


@pytest.fixture(autouse=True)
def fresh_store(monkeypatch):
    """Every test sees an empty in-memory store, no cache env and no path
    lever, and leaves no winner behind for the next test on its worker."""
    for name in ("IWAE_AUTOTUNE_CACHE", "IWAE_HOT_LOOP_PATH",
                 "IWAE_HOT_LOOP_SCAN_BYTES", "IWAE_SERVING_INT8"):
        monkeypatch.delenv(name, raising=False)
    at.reload_store()
    yield
    at.reload_store()


def _counter(name: str) -> float:
    return get_registry().counter(f"autotune/{name}").value


def _fake_measure(ms_by_call):
    """Injected measurement: the next wall ms per candidate (cycling), so a
    test picks the winner without timing anything."""
    calls = []

    def measure(fn, args, reps):
        calls.append(fn)
        return ms_by_call[(len(calls) - 1) % len(ms_by_call)]

    measure.calls = calls
    return measure


def _plant(tmp_path, monkeypatch, kind, shape, record, dt=None,
           card=None):
    """Persist one winner record (keyed for the CPU, or for `card`) and
    point the default store at it."""
    p = str(tmp_path / "autotune.json")
    kw = {} if card is None else dict(arch=card[0], dev_name=card[1])
    at._save_store(p, {at.entry_key(kind, *shape, dt, **kw): record})
    monkeypatch.setenv("IWAE_AUTOTUNE_CACHE", p)
    at.reload_store()
    return p


def _as_card(monkeypatch):
    """Make ``torch.device("cuda")`` key as :data:`CARD` on this CPU host
    (nothing is launched: only the key's identity is read)."""
    monkeypatch.setattr(at, "_card", lambda index: CARD)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)


def _stub_limits(h1_dim, hidden, bf16):
    return hl.BlockLimits(1000, 1000, True, True)


# ---------------------------------------------------------------------------
# the store's lifecycle
# ---------------------------------------------------------------------------

def test_winner_persistence_and_reload(tmp_path):
    p = str(tmp_path / "autotune.json")
    rec = at.tune("serving_row", *SHAPE, path=p,
                  measure=_fake_measure([3.0, 1.0, 2.0]))
    assert rec["cache"] == "tuned"
    assert rec["path"] in ("blocked_scan", "reference")
    doc = json.load(open(p))
    assert doc["version"] == at.AUTOTUNE_VERSION and len(doc["entries"]) == 1
    at.reload_store()                      # a fresh process reads the file
    got = at.winner_for("serving_row", *SHAPE, None, path=p)
    assert got is not None and got["path"] == rec["path"]
    assert got["measured_ms"] == 1.0       # the min of the injected walls
    assert len(got["all_measured"]) == rec["measured_candidates"]


def test_second_tune_run_is_free(tmp_path):
    """A warm cache makes tune() a pure lookup: no search, no candidate
    tried, zero timed runs (the injected measure is never called)."""
    p = str(tmp_path / "autotune.json")
    timed0 = _counter("timed_runs")
    rec = at.tune("serving_row", *SHAPE, path=p, reps=1)   # real measure
    assert rec["cache"] == "tuned"
    assert _counter("timed_runs") - timed0 == rec["measured_candidates"]
    at.reload_store()
    probes0, searches0 = _counter("probe_compiles"), _counter("searches")
    timed0 = _counter("timed_runs")
    measure = _fake_measure([1.0])
    rec2 = at.tune("serving_row", *SHAPE, path=p, measure=measure)
    assert rec2["cache"] == "hit" and rec2["path"] == rec["path"]
    assert measure.calls == []
    assert _counter("timed_runs") == timed0
    assert _counter("probe_compiles") == probes0
    assert _counter("searches") == searches0


def test_version_invalidation(tmp_path):
    p = str(tmp_path / "autotune.json")
    at.tune("serving_row", *SHAPE, path=p, measure=_fake_measure([1.0]))
    doc = json.load(open(p))
    doc["version"] = at.AUTOTUNE_VERSION + 1
    json.dump(doc, open(p, "w"))
    at.reload_store()
    before = _counter("version_mismatch")
    assert at.winner_for("serving_row", *SHAPE, None, path=p) is None
    assert _counter("version_mismatch") == before + 1


@pytest.mark.parametrize("field", ["arch", "dev_name", "digest"])
def test_card_key_invalidation(tmp_path, field):
    """The port's counterparts of the JAX key's chip and VMEM budget: a
    winner keyed on another architecture, another card or another kernel
    source misses, each field on its own."""
    p = str(tmp_path / "autotune.json")
    own = at.entry_key("serving_row", *SHAPE, None)
    foreign = at.entry_key("serving_row", *SHAPE, None,
                           **{field: "other"})
    assert foreign != own
    at._save_store(p, {foreign: {"path": "blocked_scan", "block_k": 2}})
    at.reload_store()
    assert at.winner_for("serving_row", *SHAPE, None, path=p) is None
    at._save_store(p, {own: {"path": "blocked_scan", "block_k": 2}})
    at.reload_store()
    assert at.winner_for("serving_row", *SHAPE, None,
                         path=p)["path"] == "blocked_scan"


def test_key_names_the_card_and_the_kernel_sources(monkeypatch):
    _as_card(monkeypatch)
    key = at.entry_key("fwd", *SHAPE, "bfloat16", device="cuda")
    assert key.endswith(f"|dt=bfloat16|arch=sm_90|dev={CARD[1]}"
                        f"|kv={at.kernel_digest()}")
    assert at.entry_key("fwd", *SHAPE, None).split("|")[-3:-1] == [
        "arch=cpu", "dev=cpu"]
    assert len(at.kernel_digest()) == 16


def test_corrupt_cache_loud_fallback(tmp_path):
    p = str(tmp_path / "autotune.json")
    with open(p, "w") as f:
        f.write("{this is not json")
    before = _counter("cache_corrupt")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert at.winner_for("serving_row", *SHAPE, None, path=p) is None
    assert _counter("cache_corrupt") == before + 1
    # the dispatcher keeps working on the hand rules
    k, b, h1, hid, d = SHAPE
    assert hl.select_path(torch.device("cpu"), widths=(h1, hid, False),
                          shape=(k, b, d)) == "reference"


def test_corrupt_cache_wrong_schema(tmp_path):
    p = str(tmp_path / "autotune.json")
    json.dump({"version": at.AUTOTUNE_VERSION, "entries": "nope"},
              open(p, "w"))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert at.winner_for("serving_row", *SHAPE, None, path=p) is None


def test_entry_key_validates_kind():
    with pytest.raises(ValueError, match="unknown autotune kind"):
        at.entry_key("nope", *SHAPE, None)
    with pytest.raises(ValueError, match="unknown autotune kind"):
        at.candidates_for("nope", *SHAPE)
    with pytest.raises(ValueError, match="compute_dtype"):
        at.entry_key("fwd", *SHAPE, "float16")


@pytest.mark.parametrize("env,want", [("off", None), ("none", None),
                                      ("0", None), ("/x/y.json",
                                                    "/x/y.json")])
def test_cache_path_resolution(monkeypatch, env, want):
    assert at.cache_path() is None                 # memory only by default
    monkeypatch.setenv("IWAE_AUTOTUNE_CACHE", env)
    assert at.cache_path() == want
    assert at.cache_path("/explicit.json") == "/explicit.json"


# ---------------------------------------------------------------------------
# the candidate space
# ---------------------------------------------------------------------------

def test_candidates_on_and_off_the_card():
    """bf16 tries B1 at 1..4 row groups, fp32 its one launch; off the card
    no kernel candidate is measured; the blocked scan covers the divisor
    ladder of k with the hand rule's slab in it."""
    k, b = 50, 100
    bf = at.candidates_for("fwd", k, b, 100, 200, 784, "bfloat16",
                           include_kernel=True)
    assert [c.groups for c in bf if c.path == "kernel"] == [1, 2, 3, 4]
    fp = at.candidates_for("fwd", k, b, 100, 200, 784, None,
                           include_kernel=True)
    assert [c.label() for c in fp if c.path == "kernel"] == ["kernel"]
    cpu = at.candidates_for("fwd", k, b, 100, 200, 784, "bfloat16")
    assert all(c.path != "kernel" for c in cpu)
    scans = [c.block_k for c in cpu if c.path == "blocked_scan"]
    assert scans == sorted(scans) and all(k % s == 0 for s in scans)
    assert hl._scan_block_k(k, b, 200, 784) in scans
    assert any(c.path == "reference" for c in cpu)
    assert [c.path for c in at.candidates_for(
        "bwd", k, b, 100, 200, 784, "bfloat16", include_kernel=True)
        if c.path == "kernel"] == ["kernel"]      # B2's splits stay fixed
    assert all(c.path == "blocked_scan"
               for c in at.candidates_for("scan", k, b, 100, 200, 784))
    assert [c.path for c in at.candidates_for(
        "serving_int8", k, 64, 100, 200, 784)] == ["int8", "reference"]


def test_hand_rule_is_in_the_space(monkeypatch):
    """The hand rule's candidate is always measured, so a winner can only
    meet or beat it: on the card B1 at ``fwd_groups`` (1 group at a serving
    bucket, 4 at the eval chunk), on the CPU the reference."""
    monkeypatch.setattr(hl, "library_limits", _stub_limits)
    cuda = torch.device("cuda")
    assert at.hand_rule("serving_row", 50, 64, 100, 200, 784, "bfloat16",
                        device=cuda).label() == "kernel(groups=1)"
    assert at.hand_rule("fwd", 250, 500, 100, 200, 784, "bfloat16",
                        device=cuda).label() == "kernel(groups=4)"
    assert at.hand_rule("fwd", 50, 100, 100, 200, 784, None,
                        device=cuda).label() == "kernel"
    assert at.hand_rule("fwd", *SHAPE).label() == "reference"
    assert at.hand_rule("serving_int8", *SHAPE).label() == "reference"
    assert hl.fwd_groups(264 * 16) == 1 and hl.fwd_groups(264 * 16 + 1) == 4


def test_prior_ranks_the_fused_kernel_first():
    """The roofline prior (H100 row) charges the unfused paths their
    activations' bytes and int8 a quarter of the weight bytes."""
    c = {p: at.Candidate(p) for p in ("kernel", "reference", "int8")}
    ms = {p: at._prior_ms("fwd", c[p], 50, 64, 100, 200, 784, None)
          for p in c}
    assert ms["kernel"] < ms["int8"] < ms["reference"]


# ---------------------------------------------------------------------------
# the dispatcher's consultation points (ops/hot_loop.py)
# ---------------------------------------------------------------------------

def test_scan_winner_overrides_remat_slab(tmp_path, monkeypatch):
    k, b, h1, hid, pix = 12, 8, 10, 16, 20
    cpu = torch.device("cpu")
    assert hl._scan_block_k(k, b, hid, pix, h1, None, cpu) == k  # hand
    _plant(tmp_path, monkeypatch, "scan", (k, b, h1, hid, pix),
           {"path": "blocked_scan", "block_k": 3})
    assert hl._scan_block_k(k, b, hid, pix, h1, None, cpu) == 3
    # a slab outside [1, k] leaves the hand pick
    _plant(tmp_path, monkeypatch, "scan", (k, b, h1, hid, pix),
           {"path": "blocked_scan", "block_k": 500})
    assert hl._scan_block_k(k, b, hid, pix, h1, None, cpu) == k
    # JAX's hand pick agrees at the flagship's eval chunk
    assert hl._scan_block_k(250, 500, 200, 784) == \
        jhl._scan_block_k(250, 500, 200, 784)


def test_fwd_winner_decides_auto_path(tmp_path, monkeypatch):
    k, b, h1, hid, pix = 4, 6, 10, 16, 20
    cpu = torch.device("cpu")
    kw = dict(widths=(h1, hid, False), shape=(k, b, pix))
    assert hl.select_path(cpu, **kw) == "reference"
    _plant(tmp_path, monkeypatch, "fwd", (k, b, h1, hid, pix),
           {"path": "blocked_scan", "block_k": 2})
    assert hl.select_path(cpu, **kw) == "blocked_scan"
    assert hl.select_path(cpu, "reference", **kw) == "reference"
    monkeypatch.setenv("IWAE_HOT_LOOP_PATH", "reference")
    assert hl.select_path(cpu, **kw) == "reference"   # the lever outranks


def test_serving_winner_decides_gate(tmp_path, monkeypatch):
    cfg = ModelConfig(n_hidden_enc=(16,), n_latent_enc=(10,),
                      n_hidden_dec=(16,), n_latent_dec=(20,), x_dim=20,
                      likelihood="logits")
    cpu = torch.device("cpu")
    # every serving program takes the row-invariant ops, on the CPU too
    served = dataclasses.replace(cfg, row_invariant=True)
    assert hl.serving_dispatch_config(cfg, 4, 8, device=cpu) == (
        served, "reference")
    _plant(tmp_path, monkeypatch, "serving_row", (4, 8, 10, 16, 20),
           {"path": "blocked_scan", "block_k": 2})
    out, path = hl.serving_dispatch_config(cfg, 4, 8, device=cpu)
    assert path == "blocked_scan" and out.hot_loop_path == "blocked_scan"
    assert out.fused_likelihood and out.hot_loop_tile is None
    # no (k, rows): no winner is read (the sharded engine's gate)
    assert hl.serving_dispatch_config(cfg, device=cpu)[1] == "reference"


def test_serving_winner_reaches_engine_gate(tmp_path, monkeypatch):
    """A cached serving winner changes what the engine dispatches: the
    blocked scan's rows match the reference program's to fp32 rounding
    (the port's slabs run the CPU's matmul at another row count, so not
    bitwise as in JAX; 1e-5 relative of rows of tens of nats)."""
    cfg = ModelConfig(n_hidden_enc=(16,), n_latent_enc=(4,),
                      n_hidden_dec=(16,), n_latent_dec=(12,), x_dim=12,
                      likelihood="logits")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    x = (np.random.RandomState(1).rand(4, 12) > 0.5).astype(np.float32)
    want = ServingEngine(params=params, model_config=cfg, k=4, max_batch=4,
                         timeout_s=None, kernel_path="reference",
                         device="cpu").score(x)
    _plant(tmp_path, monkeypatch, "serving_row", (4, 4, 4, 16, 12),
           {"path": "blocked_scan", "block_k": 2})
    eng = ServingEngine(params=params, model_config=cfg, k=4, max_batch=4,
                        timeout_s=None, device="cpu")
    got = eng.score(x)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert eng.metrics.snapshot()["kernel"]["score/b4/k4"]["path"] == \
        "blocked_scan"


def test_kernel_winner_groups_reach_the_kernel(tmp_path, monkeypatch):
    """A card's ``kernel`` winner: its row groups reach B1 (a ``fwd``
    winner through ``decoder_score``, a ``serving_row`` winner baked into
    ``hot_loop_tile``); an fp32 winner has no groups to give."""
    _as_card(monkeypatch)
    monkeypatch.setattr(hl, "library_limits", _stub_limits)
    cuda = torch.device("cuda")
    shape, widths = (50, 64, 784), (100, 200, True)
    _plant(tmp_path, monkeypatch, "fwd", (50, 64, 100, 200, 784),
           {"path": "kernel", "groups": 3}, dt="bfloat16", card=CARD)
    assert hl._winner_groups("fwd", shape, widths, cuda) == 3
    assert hl._winner_groups("fwd", shape, (100, 200, False), cuda) is None
    assert hl.select_path(cuda, widths=widths, shape=shape) == "kernel"
    cfg = ModelConfig.two_layer(likelihood="logits",
                                compute_dtype="bfloat16")
    _plant(tmp_path, monkeypatch, "serving_row", (50, 64, 100, 200, 784),
           {"path": "kernel", "groups": 2}, dt="bfloat16", card=CARD)
    out, path = hl.serving_dispatch_config(cfg, 50, 64, device=cuda)
    assert path == "kernel" and out.hot_loop_tile == 2 and out.row_invariant
    with pytest.raises(ValueError, match="hot_loop_tile"):
        dataclasses.replace(out, hot_loop_tile=5)


def test_kernel_winner_never_routes_a_cpu_tensor_to_a_kernel(tmp_path,
                                                             monkeypatch):
    """A ``kernel`` winner keyed for the CPU (a hand-edited file) leaves the
    choice to the hand rule: the CPU never reaches a kernel."""
    k, b, h1, hid, pix = SHAPE
    _plant(tmp_path, monkeypatch, "fwd", SHAPE,
           {"path": "kernel", "groups": 2})
    cpu = torch.device("cpu")
    assert hl.select_path(cpu, widths=(h1, hid, False),
                          shape=(k, b, pix)) == "reference"
    assert hl._winner_groups("fwd", (k, b, pix), (h1, hid, True),
                             cpu) is None
    cfg = ModelConfig(n_hidden_enc=(16,), n_latent_enc=(h1,),
                      n_hidden_dec=(hid,), n_latent_dec=(pix,), x_dim=pix,
                      likelihood="logits")
    _plant(tmp_path, monkeypatch, "serving_row", SHAPE,
           {"path": "kernel", "groups": 2})
    assert hl.serving_dispatch_config(cfg, k, b, device=cpu) == (
        dataclasses.replace(cfg, row_invariant=True), "reference")


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def test_tune_winner_is_measured_min(tmp_path):
    p = str(tmp_path / "autotune.json")
    cands = at.candidates_for("serving_row", *SHAPE)
    walls = [5.0 + i for i in range(len(cands))]
    walls[2] = 0.5
    rec = at.tune("serving_row", *SHAPE, path=p,
                  measure=_fake_measure(walls))
    assert rec["measured_ms"] == 0.5 and rec["runner_up_ms"] == 5.0
    assert rec["measured_candidates"] == len(cands)
    assert rec["all_measured"][0]["measured_ms"] == 0.5
    assert rec["hand_rule"] == "reference" and rec["hand_rule_ms"] >= 5.0


def test_tune_failed_candidates_are_skipped(tmp_path):
    p = str(tmp_path / "autotune.json")
    seen = []

    def measure(fn, args, reps):
        seen.append(fn)
        return None if len(seen) == 1 else float(len(seen))

    rec = at.tune("serving_row", *SHAPE, path=p, measure=measure)
    assert rec["measured_candidates"] == rec["candidates"] - 1
    with pytest.raises(RuntimeError, match="every candidate failed"):
        at.tune("scan", *SHAPE, path=p, measure=lambda *a: None,
                force=True)


def test_concurrent_searches_of_one_shape_measure_it_once():
    """Two engines racing one shape at the same time: the searches take
    turns, so the second finds the first's winner and times nothing, and
    both get the same verdict."""
    import threading

    n_cands = len(at.candidates_for("serving_row", *SHAPE))
    started, release = threading.Event(), threading.Event()
    calls = []

    def measure(fn, args, reps):
        calls.append(fn)
        started.set()
        release.wait(10)
        return float(len(calls))

    searches = _counter("searches")
    out = {}

    def run(name):
        out[name] = at.tune("serving_row", *SHAPE, measure=measure)

    first = threading.Thread(target=run, args=("first",))
    first.start()
    assert started.wait(10)
    second = threading.Thread(target=run, args=("second",))
    second.start()
    release.set()
    first.join(10)
    second.join(10)
    assert len(calls) == n_cands and _counter("searches") == searches + 1
    assert out["first"]["cache"] == "tuned" and out["second"]["cache"] == "hit"
    assert out["second"]["path"] == out["first"]["path"]
    assert out["second"]["measured_ms"] == out["first"]["measured_ms"]


def test_measure_discards_and_counts_a_failing_candidate():
    """A build or launch failure is a discarded candidate, counted, never a
    crash of the search."""
    before = _counter("probe_failures")

    def broken(*args):
        raise RuntimeError("nvcc failed")

    with pytest.warns(RuntimeWarning, match="discarded"):
        assert at._measure_candidate(broken, (), 3) is None
    assert _counter("probe_failures") == before + 1
    assert at._measure_candidate(lambda: None, (), 2) >= 0.0


def test_tune_ladder_and_cli(tmp_path, capsys):
    """tune_ladder covers the (k, bucket) grid of both serving kinds and a
    warm re-run hits; the CLI runs end to end on the CPU."""
    p = str(tmp_path / "autotune.json")
    cfg = ModelConfig(n_hidden_enc=(16,), n_latent_enc=(4,),
                      n_hidden_dec=(16,), n_latent_dec=(12,), x_dim=12,
                      likelihood="logits")
    kinds = ("serving_row", "serving_int8")
    rows = at.tune_ladder(cfg, ks=[2], buckets=[1, 2], kinds=kinds, reps=1,
                          path=p)
    assert len(rows) == 4 and all(r["cache"] == "tuned" for r in rows)
    at.reload_store()
    assert all(r["cache"] == "hit" for r in at.tune_ladder(
        cfg, ks=[2], buckets=[1, 2], kinds=kinds, reps=1, path=p))
    with pytest.raises(ValueError, match="train_batch"):
        at.tune_ladder(cfg, ks=[2], buckets=[1], kinds=("fwd",), path=p)
    cli = str(tmp_path / "cli.json")
    assert at.main(["--k", "2", "--buckets", "1", "--kinds", "scan",
                    "--train-batch", "4", "--reps", "1", "--cache", cli,
                    "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["shapes_tuned"] == 1 and summary["device"] == "cpu"
    assert json.loads(lines[0])["kind"] == "scan"
    assert os.path.exists(cli)


def test_import_check_covers_the_new_modules():
    """tests/test_torch_serving.py's AST check walks every port module:
    the autotuner and the parity gate are among them."""
    import tests.test_torch_serving as ts

    names = {p.name for p in ts._port_files()}
    assert {"autotune.py", "parity.py"} <= names


# ---------------------------------------------------------------------------
# the blocked scan and the env levers, against JAX
# ---------------------------------------------------------------------------

def _block_inputs(k, b, h1, hid, d, seed=0):
    rs = np.random.RandomState(seed)
    f = np.float32
    return [rs.randn(k, b, h1).astype(f) * 0.5,
            rs.randn(h1, hid).astype(f) * 0.2, rs.randn(hid).astype(f) * 0.1,
            rs.randn(hid, hid).astype(f) * 0.2,
            rs.randn(hid).astype(f) * 0.1,
            rs.randn(hid, d).astype(f) * 0.2, rs.randn(d).astype(f) * 0.1,
            (rs.rand(b, d) > 0.5).astype(f)]


@pytest.mark.parametrize("block_k", [1, 2, 3, 5, 12])
@pytest.mark.parametrize("cd", [None, torch.bfloat16])
def test_blocked_scan_matches_jax_and_the_reference(block_k, cd):
    """The port's slabs against JAX's ``_blocked_scan_impl`` and the port's
    ``_reference_impl`` on the same inputs: the same per-row fp32 math in
    another summation order, rows of ~100 nats: 1e-5 relative (bf16:
    identical bf16-rounded operands, so the same bound)."""
    arrs = _block_inputs(12, 5, 10, 16, 40)
    t = [torch.from_numpy(a) for a in arrs]
    got = hl._blocked_scan_impl(*t, block_k=block_k, compute_dtype=cd)
    want = hl._reference_impl(*t, cd)
    jcd = None if cd is None else jnp.bfloat16
    jx = jhl._blocked_scan_impl(*[jnp.asarray(a) for a in arrs],
                                block_k=block_k, compute_dtype=jcd)
    assert got.shape == (12, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=1e-5)


def test_blocked_scan_gradients_match_the_reference():
    """Under autograd each slab is checkpointed: the gradients equal plain
    autograd of the reference to fp32 rounding (1e-5 relative, 1e-6
    absolute for near-zero entries)."""
    arrs = _block_inputs(6, 3, 8, 12, 20, seed=2)

    def grads(fn):
        ps = [torch.from_numpy(a).requires_grad_(True) for a in arrs[:7]]
        out = fn(*ps, torch.from_numpy(arrs[7]))
        return torch.autograd.grad(out.sum(), ps)

    got = grads(lambda *a: hl._blocked_scan_impl(*a, block_k=2))
    want = grads(hl._reference_impl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_decoder_score_takes_the_scan_over_the_threshold(monkeypatch):
    """``IWAE_HOT_LOOP_SCAN_BYTES`` below the working set sends a CPU call
    to the blocked scan, as JAX's ``select_path`` off the TPU."""
    arrs = _block_inputs(6, 3, 8, 12, 20, seed=3)
    t = [torch.from_numpy(a) for a in arrs]
    out = {"l1": {"w": t[1], "b": t[2]}, "l2": {"w": t[3], "b": t[4]},
           "out": {"w": t[5], "b": t[6]}}
    before = hl.path_counters().get("blocked_scan", 0)
    monkeypatch.setenv("IWAE_HOT_LOOP_SCAN_BYTES", "1000")
    got = hl.decoder_score(out, t[7], t[0])
    assert hl.path_counters()["blocked_scan"] == before + 1
    np.testing.assert_allclose(got.numpy(), hl._reference_impl(*t).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("env,scan_bytes", [
    (None, None), ("auto", None), ("reference", None),
    ("blocked_scan", None), ("BLOCKED_SCAN", None), (None, "1000"),
    (None, "1e12")])
def test_env_levers_choose_as_jax_off_the_accelerator(monkeypatch, env,
                                                      scan_bytes):
    """The port's CPU choice is JAX's off-TPU choice for the same env."""
    for name, val in (("IWAE_HOT_LOOP_PATH", env),
                      ("IWAE_HOT_LOOP_SCAN_BYTES", scan_bytes)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    k, b, h1, hid, d = 50, 100, 100, 200, 784
    want, _ = jhl.select_path(k, b, h1, hid, d, on_tpu=False)
    got = hl.select_path(torch.device("cpu"), widths=(h1, hid, False),
                         shape=(k, b, d))
    assert got == want


@pytest.mark.parametrize("env", ["fused", "pallas2", "interpret"])
def test_unknown_path_lever_is_a_typed_error_in_both(monkeypatch, env):
    monkeypatch.setenv("IWAE_HOT_LOOP_PATH", env)
    with pytest.raises(ValueError, match="IWAE_HOT_LOOP_PATH"):
        jhl.select_path(4, 4, 8, 8, 8, on_tpu=False)
    with pytest.raises(ValueError, match="IWAE_HOT_LOOP_PATH"):
        hl.select_path(torch.device("cpu"))
    cfg = ModelConfig.two_layer(likelihood="logits")
    with pytest.raises(ValueError, match="IWAE_HOT_LOOP_PATH"):
        hl.serving_dispatch_config(cfg, 50, 4, device="cpu")


def test_path_lever_kernel_and_pallas(monkeypatch):
    """``pallas`` (JAX's name) and ``kernel`` force the fused path: on the
    card where the libraries take the widths, an error on the CPU."""
    monkeypatch.setattr(hl, "library_limits", _stub_limits)
    for env in ("pallas", "kernel"):
        monkeypatch.setenv("IWAE_HOT_LOOP_PATH", env)
        assert hl.select_path(torch.device("cuda"),
                              widths=(100, 200, True)) == "kernel"
        with pytest.raises(ValueError, match="needs CUDA"):
            hl.select_path(torch.device("cpu"))


def test_scan_bytes_lever_rejects_junk(monkeypatch):
    monkeypatch.setenv("IWAE_HOT_LOOP_SCAN_BYTES", "lots")
    with pytest.raises(ValueError, match="IWAE_HOT_LOOP_SCAN_BYTES"):
        hl.select_path(torch.device("cpu"), widths=(8, 8, False),
                       shape=(4, 4, 8))
    monkeypatch.delenv("IWAE_HOT_LOOP_SCAN_BYTES")
    assert hl._scan_threshold(True) == float("inf")
    assert hl._scan_threshold(False) == float(jhl._SCAN_BYTES_DEFAULT)
