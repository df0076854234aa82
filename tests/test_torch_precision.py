"""The port's serving precision policies, int8 included, held against the
JAX package on the CPU.

Mirrors ``tests/test_precision.py`` case for case where a case has a
counterpart:

* **parity gate** (``telemetry/parity.py``, the port's own copy): the JAX
  module's synthetic cases, and the same verdict dict as JAX's on seeded
  log-weight sets (inside, outside, NaN, bad shape);
* **the int8 functions**: ``quantize_out_block`` bitwise JAX's,
  ``dense_int8_plain`` and ``decoder_score_int8`` against JAX's
  ``_dense_wq``/``decoder_score_int8``, ``serving_int8_admit``'s env
  contract and reasons;
* **vocabulary**: an unknown policy is a typed error at every boundary
  (validator, engine, zoo manifest, the CLI's ``--precision`` and its
  ``model=policy`` pairs);
* **store hygiene**: (model, precision) variants never collide, the int8
  entry bills less than its fp32 twin, eviction accounting stays exact;
* **engine**: an explicit fp32 policy is bitwise the no-policy engine,
  bf16 and forced int8 within their row tolerance, int8 in auto mode
  without a winner serves the exact fp32 program and records why, a
  winner admits it;
* **wire**: ``info()`` and the request's ``precision`` assertion with int8.
"""

from __future__ import annotations

import json
import socket
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.ops import hot_loop as jhl
from iwae_replication_project_tpu.telemetry import parity as jparity
from iwae_replication_project_tpu_torch import zoo
from iwae_replication_project_tpu_torch.ops import autotune as at
from iwae_replication_project_tpu_torch.ops import hot_loop as hl
from iwae_replication_project_tpu_torch.ops import row_invariant as ri
from iwae_replication_project_tpu_torch.serving import cli
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine
from iwae_replication_project_tpu_torch.telemetry import (
    BF16_TOLERANCES,
    DEFAULT_TOLERANCES,
    INT8_TOLERANCES,
    ParityTolerances,
    statistical_parity,
)
from iwae_replication_project_tpu_torch.utils import compile_cache as cc
from iwae_replication_project_tpu_torch.utils.dtypes import (
    validate_precision,
)
from torch_parity import binary_rows, configs, params


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    """No admission lever, no winner cache, no path lever; no winner left
    behind for the next test on this worker."""
    for name in ("IWAE_SERVING_INT8", "IWAE_AUTOTUNE_CACHE",
                 "IWAE_HOT_LOOP_PATH", "IWAE_HOT_LOOP_SCAN_BYTES"):
        monkeypatch.delenv(name, raising=False)
    at.reload_store()
    yield
    at.reload_store()


def _log_weights(k=8, b=64, seed=0):
    """Synthetic [k, B] log-weight matrix with known spread."""
    return np.random.RandomState(seed).normal(size=(k, b))


# ---------------------------------------------------------------------------
# the statistical acceptance helper
# ---------------------------------------------------------------------------

class TestParityGate:
    def test_identical_legs_accept_with_zero_deltas(self):
        lw = _log_weights()
        v = statistical_parity(lw, lw.copy(), BF16_TOLERANCES)
        assert v["accepted"] and not v["failures"]
        assert all(d == 0.0 for d in v["deltas"].values())

    def test_known_bias_inside_bounds_accepts_both_directions(self):
        lw = _log_weights()
        for sign in (+1.0, -1.0):
            v = statistical_parity(lw, lw + sign * 0.015, INT8_TOLERANCES)
            assert v["accepted"], (sign, v["failures"])
            assert v["deltas"]["batch_nll"] == pytest.approx(0.015)

    def test_known_bias_outside_bounds_rejects_both_directions(self):
        lw = _log_weights()
        for sign in (+1.0, -1.0):
            v = statistical_parity(lw, lw + sign * 1.0, INT8_TOLERANCES)
            assert not v["accepted"], sign
            assert any("batch_nll" in f for f in v["failures"])

    def test_known_variance_inflation_rejected(self):
        lw = _log_weights()
        mean = lw.mean(axis=0, keepdims=True)
        v = statistical_parity(lw, mean + 2.0 * (lw - mean),
                               INT8_TOLERANCES)
        assert not v["accepted"]
        assert any("log_weight_var_rel" in f for f in v["failures"])
        assert v["deltas"]["log_weight_var"] == pytest.approx(
            3.0 * v["ref"]["log_weight_var"], rel=1e-6)

    def test_nan_leg_can_never_be_accepted(self):
        lw = _log_weights()
        bad = lw.copy()
        bad[0, 0] = np.nan
        v = statistical_parity(lw, bad, INT8_TOLERANCES)
        assert not v["accepted"] and v["failures"]

    def test_shape_mismatch_is_a_typed_error(self):
        with pytest.raises(ValueError, match="shapes differ"):
            statistical_parity(_log_weights(k=8), _log_weights(k=4),
                               BF16_TOLERANCES)

    def test_zero_or_negative_tolerance_is_a_typed_error(self):
        for bad in (0.0, -0.1):
            with pytest.raises(ValueError, match="must be > 0"):
                ParityTolerances(bad, 0.1, 0.1, 0.1)

    def test_defaults_cover_exactly_the_low_precision_policies(self):
        assert set(DEFAULT_TOLERANCES) == {"bf16", "int8"}

    def test_verdict_is_json_ready(self):
        lw = _log_weights()
        json.dumps(statistical_parity(lw, lw + 0.01, BF16_TOLERANCES))

    @pytest.mark.parametrize("case", ["inside", "outside", "variance",
                                      "nan"])
    @pytest.mark.parametrize("policy", ["bf16", "int8"])
    def test_verdict_equals_jax(self, case, policy):
        """The same verdict dict as the JAX module's on seeded sets (every
        number the same float: the two copies run the same numpy)."""
        lw = _log_weights(k=16, b=32, seed=7)
        rs = np.random.RandomState(8)
        test = {"inside": lw + 0.01 * rs.randn(*lw.shape),
                "outside": lw + 0.5,
                "variance": lw * 1.6,
                "nan": np.where(rs.rand(*lw.shape) < 0.01, np.nan, lw)}[case]
        got = statistical_parity(lw, test, DEFAULT_TOLERANCES[policy])
        want = jparity.statistical_parity(
            lw, test, jparity.DEFAULT_TOLERANCES[policy])
        assert json.dumps(got, sort_keys=True) == \
            json.dumps(want, sort_keys=True)
        assert DEFAULT_TOLERANCES[policy] == ParityTolerances(
            **jparity.DEFAULT_TOLERANCES[policy].__dict__)

    def test_bad_shape_raises_in_both(self):
        for fn in (statistical_parity, jparity.statistical_parity):
            with pytest.raises(ValueError, match="shapes differ"):
                fn(_log_weights(k=8), _log_weights(k=8, b=3),
                   INT8_TOLERANCES)


# ---------------------------------------------------------------------------
# the int8 functions against JAX
# ---------------------------------------------------------------------------

def _out_block(h1=10, hid=16, d=40, seed=0):
    rs = np.random.RandomState(seed)
    f = np.float32
    blk = {"l1": {"w": rs.randn(h1, hid).astype(f) * 0.3,
                  "b": rs.randn(hid).astype(f) * 0.1},
           "l2": {"w": rs.randn(hid, hid).astype(f) * 0.3,
                  "b": rs.randn(hid).astype(f) * 0.1},
           "out": {"w": rs.randn(hid, d).astype(f) * 0.3,
                   "b": rs.randn(d).astype(f) * 0.1}}
    blk["l2"]["w"][:, 3] = 0.0                    # an all-zero channel
    # exact ties: column 0 of l1 has scale 0.5 (its max is 63.5) and its
    # other entries are odd multiples of 0.25, so w / scale ends in .5
    blk["l1"]["w"][:, 0] = (np.arange(h1, dtype=f) - h1 / 2.0) * 0.5 + 0.25
    blk["l1"]["w"][0, 0] = 127.0 / 2.0
    return blk


def _torch_block(blk):
    return {n: {k: torch.from_numpy(v) for k, v in lay.items()}
            for n, lay in blk.items()}


def test_quantize_out_block_is_bitwise_jax():
    """``w_q`` and ``scale`` equal JAX's bit for bit (both round half to
    even; the zero channel gets scale 1.0; the biases pass through)."""
    blk = _out_block()
    jq = jhl.quantize_out_block(jax.tree_util.tree_map(jnp.asarray, blk))
    tq = hl.quantize_out_block(_torch_block(blk))
    for name in ("l1", "l2", "out"):
        for leaf in ("w_q", "scale", "b"):
            want = np.asarray(jq[name][leaf])
            got = tq[name][leaf].numpy()
            assert got.dtype == want.dtype, (name, leaf)
            assert np.array_equal(got, want), (name, leaf)
    assert tq["l2"]["scale"][3] == 1.0 and not tq["l2"]["w_q"][:, 3].any()
    col = tq["l1"]["w_q"][1:, 0].numpy()
    assert np.array_equal(col, np.round(blk["l1"]["w"][1:, 0] / 0.5))
    assert (col % 2 == 0).all()                  # halves went to even


@pytest.mark.parametrize("tanh", [False, True])
def test_dense_int8_plain_matches_jax_dense_wq(tanh):
    """The plain int8 layer against JAX's ``_dense_wq`` (then tanh): the
    same fp32 products summed in another order; outputs of order 1:
    1e-5 absolute. On the CPU the wrapper is the plain composition with
    its product in the fixed slab order (``in_slabs=True``), bit for
    bit."""
    blk = _out_block()
    jq = jhl.quantize_out_block(jax.tree_util.tree_map(jnp.asarray, blk))
    tq = hl.quantize_out_block(_torch_block(blk))
    x = np.random.RandomState(4).randn(6, 3, 10).astype(np.float32)
    want = jhl._dense_wq(jnp.asarray(x), jq["l1"])
    want = np.asarray(jnp.tanh(want) if tanh else want)
    got = ri.dense_int8(torch.from_numpy(x), tq["l1"]["w_q"],
                        tq["l1"]["scale"], tq["l1"]["b"], tanh)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
    assert torch.equal(got, ri.dense_int8_plain(
        torch.from_numpy(x), tq["l1"]["w_q"], tq["l1"]["scale"],
        tq["l1"]["b"], tanh, in_slabs=True))


@pytest.mark.parametrize("row_invariant", [False, True])
def test_decoder_score_int8_matches_jax(row_invariant):
    """``decoder_score_int8`` against JAX's on the same quantized block:
    rows of ~30 nats, fp32 in another summation order: 1e-5 relative. On
    the CPU the row-invariant sum is the fixed slab order's
    (``row_invariant.sum_in_slabs``), ``torch.sum``'s within rounding."""
    blk = _out_block()
    jq = jhl.quantize_out_block(jax.tree_util.tree_map(jnp.asarray, blk))
    tq = hl.quantize_out_block(_torch_block(blk))
    rs = np.random.RandomState(5)
    h1 = rs.randn(7, 4, 10).astype(np.float32)
    x = (rs.rand(4, 40) > 0.5).astype(np.float32)
    before = hl.path_counters().get("int8", 0)
    got = hl.decoder_score_int8(tq, torch.from_numpy(x),
                                torch.from_numpy(h1),
                                row_invariant=row_invariant)
    assert hl.path_counters()["int8"] == before + 1
    want = np.asarray(jhl.decoder_score_int8(jq, jnp.asarray(x),
                                             jnp.asarray(h1)))
    assert got.shape == (7, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_int8_score_stays_near_the_fp32_block():
    """Quantization moves a row of the fp32 block by a bounded amount:
    within INT8_TOLERANCES' row bound relative to the rows' magnitude."""
    blk = _torch_block(_out_block())
    rs = np.random.RandomState(6)
    h1 = torch.from_numpy(rs.randn(7, 4, 10).astype(np.float32))
    x = torch.from_numpy((rs.rand(4, 40) > 0.5).astype(np.float32))
    exact = hl._reference_impl(h1, blk["l1"]["w"], blk["l1"]["b"],
                               blk["l2"]["w"], blk["l2"]["b"],
                               blk["out"]["w"], blk["out"]["b"], x)
    q = hl.decoder_score_int8(hl.quantize_out_block(blk), x, h1)
    scale = max(1.0, float(exact.abs().mean()))
    assert float((q - exact).abs().max()) <= \
        INT8_TOLERANCES.max_row_rel_delta * scale


class TestAdmission:
    SHAPE = (3, 4, 8, 8, 16)

    @pytest.mark.parametrize("env", ["sometimes", "on", "1"])
    def test_unknown_admission_env_is_a_typed_error(self, monkeypatch, env):
        monkeypatch.setenv("IWAE_SERVING_INT8", env)
        with pytest.raises(ValueError, match="IWAE_SERVING_INT8"):
            hl.serving_int8_admit(*self.SHAPE, device="cpu")
        with pytest.raises(ValueError, match="IWAE_SERVING_INT8"):
            jhl.serving_int8_admit(*self.SHAPE, on_tpu=False)

    @pytest.mark.parametrize("env,admitted", [("force", True),
                                              ("off", False)])
    def test_levers_and_their_reasons_are_jax(self, monkeypatch, env,
                                              admitted):
        monkeypatch.setenv("IWAE_SERVING_INT8", env)
        got = hl.serving_int8_admit(*self.SHAPE, device="cpu")
        assert got == jhl.serving_int8_admit(*self.SHAPE, on_tpu=False)
        assert got[0] is admitted

    def test_no_winner_off_the_card_rejects(self):
        ok, why = hl.serving_int8_admit(*self.SHAPE, device="cpu")
        assert not ok and "measured win" in why
        _, jwhy = jhl.serving_int8_admit(*self.SHAPE, on_tpu=False)
        assert "measured win" in jwhy

    def test_a_measured_winner_decides(self, tmp_path, monkeypatch):
        p = str(tmp_path / "autotune.json")
        monkeypatch.setenv("IWAE_AUTOTUNE_CACHE", p)
        walls = iter([1.0, 2.0])
        rec = at.tune("serving_int8", *self.SHAPE,
                      measure=lambda fn, a, r: next(walls))
        ok, why = hl.serving_int8_admit(*self.SHAPE, device="cpu")
        assert ok == (rec["path"] == "int8") and rec["measured_ms"] == 1.0
        key = at.entry_key("serving_int8", *self.SHAPE, None)
        for path, want in (("int8", True), ("reference", False)):
            at._save_store(p, {key: {
                "path": path, "measured_ms": 1.0, "runner_up_ms": 2.0,
                "all_measured": [{"candidate": "int8(weight-only)"},
                                 {"candidate": "reference"}]}})
            at.reload_store()
            ok, why = hl.serving_int8_admit(*self.SHAPE, device="cpu")
            assert ok is want
            assert ("faster" if want else "slower") in why
        at._save_store(p, {key: {"path": "reference", "all_measured": [
            {"candidate": "reference"}]}})
        at.reload_store()
        ok, why = hl.serving_int8_admit(*self.SHAPE, device="cpu")
        assert not ok and "failed its measurement" in why


# ---------------------------------------------------------------------------
# vocabulary: typed errors at every boundary, never a silent fp32
# ---------------------------------------------------------------------------

class TestPrecisionVocabulary:
    def test_validator_accepts_policies_and_returns_them(self):
        for p in ("fp32", "bf16", "int8"):
            assert validate_precision(p) == p

    def test_validator_rejects_unknowns_typed(self):
        for bad in ("fp16", "FP32", "", "int4", 8, None):
            with pytest.raises((ValueError, TypeError)):
                validate_precision(bad)

    def test_engine_ctor_boundary(self):
        with pytest.raises(ValueError, match="fp16"):
            _tiny_engine(precision="fp16")

    def test_zoo_manifest_boundary(self):
        with pytest.raises(ValueError, match="fp16"):
            zoo.serving_engines(["northstar-iwae-2l-k50"],
                                precisions="fp16", device="cpu")
        with pytest.raises(ValueError, match="not in this manifest"):
            zoo.serving_engines(["northstar-iwae-2l-k50"],
                                precisions={"table1-vae-1l-k1": "bf16"},
                                device="cpu")

    def test_serve_cli_boundary(self):
        """The port's ``--precision`` parses as JAX's ``_parse_precision``
        (a typo is an argparse error, exit 2, naming the flag)."""
        from iwae_replication_project_tpu.serving import cli as jcli

        ap = cli.build_argparser()
        assert ap.parse_args([]).precision is None
        for spec in ("bf16", "int8", "m1=bf16,m2=int8"):
            assert ap.parse_args(["--precision", spec]).precision == \
                jcli._parse_precision(spec)
        for bad in ("fp16", "m1=fp16", "m1=bf16,int8", "=bf16"):
            with pytest.raises(SystemExit) as e:
                ap.parse_args(["--precision", bad])
            assert e.value.code == 2
            with pytest.raises(SystemExit, match="--precision"):
                jcli._parse_precision(bad)

    def test_single_engine_pairs_name_only_the_preset(self):
        ap = cli.build_argparser()
        args = ap.parse_args(["--preset", "digits-vae-1l-k1", "--precision",
                              "digits-vae-1l-k1=int8"])
        assert cli._single_engine_precision(args) == "int8"
        args = ap.parse_args(["--precision", "m1=int8"])
        with pytest.raises(SystemExit, match="per-model pairs need"):
            cli._single_engine_precision(args)

    def test_cli_refuses_int8_sharded_replicas(self):
        class First:
            precision = "int8"

        args = cli.build_argparser().parse_args(["--sharded-replicas", "1"])
        with pytest.raises(SystemExit, match="sharded"):
            cli._sharded_engines(args, [("m", First())])
        with pytest.raises(ValueError, match="sharded"):
            from iwae_replication_project_tpu_torch.serving.sharded import (
                ShardedScoreEngine)
            jcfg, tcfg = configs(2, "logits")
            ShardedScoreEngine(params=params(jcfg)[1], model_config=tcfg,
                               precision="int8", device="cpu")


# ---------------------------------------------------------------------------
# store hygiene and billing: two precisions of one model, one store
# ---------------------------------------------------------------------------

def _tiny_engine(model=None, precision=None, **kw):
    jcfg, tcfg = configs(2, "logits")
    _, tp = params(jcfg)
    kw.setdefault("k", 3)
    kw.setdefault("max_batch", 4)
    return ServingEngine(params=tp, model_config=tcfg, model=model,
                         precision=precision, device="cpu", **kw)


def _serve_one(eng, seed=0):
    fut = eng.submit("score", binary_rows(1, seed=9)[0], seed=seed)
    eng.flush()
    return float(fut.result())


class TestStorePrecisionHygiene:
    def _resident_pair(self, monkeypatch):
        """fp32-policy and forced-int8 engines of the same model label, one
        program each, in the caller's isolated store."""
        e32 = _tiny_engine(model="m", precision="fp32")
        _serve_one(e32)
        monkeypatch.setenv("IWAE_SERVING_INT8", "force")
        e8 = _tiny_engine(model="m", precision="int8")
        _serve_one(e8)
        monkeypatch.delenv("IWAE_SERVING_INT8")
        return e32, e8

    def test_precision_variants_never_collide(self, monkeypatch):
        with cc.isolated_aot_registry(budget_bytes=None):
            _, e8 = self._resident_pair(monkeypatch)
            store = cc.executable_store()
            assert {"m@fp32", "m@int8"} <= set(store.stats()["per_model"])
            models = [e["model"] for e in store.entries()]
            assert models.count("m@fp32") >= 1
            assert models.count("m@int8") >= 1
            # the precision rides the build key of the quantized entry
            assert e8._build_key("score", 3, 1)[-1] == "int8"
            assert e8._build_key("score", 3, 1)[3] == e8._weights_key_q

    def test_int8_entry_bills_less_than_fp32_twin(self, monkeypatch):
        """The int8 program reads its output block as int8 weights with
        fp32 scales, and its bill counts those bytes."""
        with cc.isolated_aot_registry(budget_bytes=None):
            self._resident_pair(monkeypatch)
            per_model = cc.executable_store().stats()["per_model"]
            b32 = per_model["m@fp32"]["resident_bytes"]
            b8 = per_model["m@int8"]["resident_bytes"]
            assert 0 < b8 < b32, (b8, b32)

    def test_eviction_accounting_exact_with_two_precisions(self,
                                                           monkeypatch):
        with cc.isolated_aot_registry(budget_bytes=None):
            s0 = cc.cache_stats()
            self._resident_pair(monkeypatch)
            store = cc.executable_store()
            stats = store.stats()
            assert stats["resident_bytes"] == \
                sum(e["bytes"] for e in store.entries()) == \
                sum(m["resident_bytes"]
                    for m in stats["per_model"].values())
            pre_ev = {m: v["evictions"]
                      for m, v in stats["per_model"].items()}
            store.set_budget(stats["resident_bytes"] - 1)
            after = store.stats()
            assert after["resident_bytes"] <= stats["resident_bytes"] - 1
            assert after["resident_bytes"] == \
                sum(e["bytes"] for e in store.entries()) == \
                sum(m["resident_bytes"]
                    for m in after["per_model"].values())
            evicted = {m: v["evictions"] - pre_ev.get(m, 0)
                       for m, v in after["per_model"].items()
                       if v["evictions"] != pre_ev.get(m, 0)}
            assert sum(evicted.values()) == \
                cc.stats_delta(s0)["store_evictions"] > 0
            assert set(evicted) <= {"m@fp32", "m@int8"}, evicted


# ---------------------------------------------------------------------------
# engine: fp32 bitwise, bf16/int8 bounded, auto admission honest
# ---------------------------------------------------------------------------

class TestEnginePrecision:
    N = 4

    def _serve(self, eng):
        rows = binary_rows(self.N, seed=1)
        futs = [eng.submit("score", rows[i], seed=i) for i in range(self.N)]
        eng.flush()
        return [float(f.result()) for f in futs]

    def _oracle(self):
        with cc.isolated_aot_registry():
            return self._serve(_tiny_engine())

    def test_fp32_policy_is_bitwise(self):
        ref = self._oracle()
        with cc.isolated_aot_registry():
            assert self._serve(_tiny_engine(precision="fp32")) == ref

    def test_bf16_and_forced_int8_within_row_tolerance(self, monkeypatch):
        ref = self._oracle()
        scale = max(1.0, abs(float(np.mean(ref))))
        with cc.isolated_aot_registry():
            got = self._serve(_tiny_engine(precision="bf16"))
        worst = max(abs(a - b) for a, b in zip(got, ref))
        assert worst <= BF16_TOLERANCES.max_row_rel_delta * scale, worst
        monkeypatch.setenv("IWAE_SERVING_INT8", "force")
        with cc.isolated_aot_registry():
            e8 = _tiny_engine(precision="int8")
            got8 = self._serve(e8)
            snap = e8.metrics.snapshot()
        worst8 = max(abs(a - b) for a, b in zip(got8, ref))
        assert worst8 <= INT8_TOLERANCES.max_row_rel_delta * scale, worst8
        assert got8 != ref                 # the quantized program served
        int8_recs = [rec for rec in snap["kernel"].values()
                     if rec.get("path") == "int8"]
        assert int8_recs and all(
            rec["precision"] == "int8" for rec in int8_recs)
        assert all("forced" in r for r in e8.int8_admission.values())

    def test_auto_without_measured_win_serves_exact_fp32(self):
        """No winner on the CPU: the exact fp32 program serves, bitwise,
        and the engine records why for every gated shape it resolved."""
        ref = self._oracle()
        with cc.isolated_aot_registry():
            e = _tiny_engine(precision="int8")
            got = self._serve(e)
            paths = {rec.get("path")
                     for rec in e.metrics.snapshot()["kernel"].values()}
        assert got == ref and "int8" not in paths
        assert e.int8_admission and all(
            "measured win" in r for r in e.int8_admission.values())
        assert {key[0] for key in e.int8_admission} == {"score"}

    def test_a_winner_admits_int8_in_the_engine(self, tmp_path,
                                                monkeypatch):
        p = str(tmp_path / "autotune.json")
        monkeypatch.setenv("IWAE_AUTOTUNE_CACHE", p)
        entries = {at.entry_key("serving_int8", 3, b, *at.dims_for_model(
            configs(2, "logits")[1]), None): {
                "path": "int8", "measured_ms": 1.0, "runner_up_ms": 2.0}
            for b in (1, 2, 4)}
        at._save_store(p, entries)
        at.reload_store()
        ref = self._oracle()
        with cc.isolated_aot_registry():
            e = _tiny_engine(precision="int8")
            got = self._serve(e)
        assert got != ref
        assert all("faster" in r for r in e.int8_admission.values())
        assert e._kernel_for("score", 3, 4)[1] == "int8"
        assert e._kernel_for("encode", 3, 4)[1] == "reference"

    def test_int8_engine_quantizes_once_and_shares_the_chain(self):
        e = _tiny_engine(precision="int8")
        assert "out" not in e._params_q and "out_q" in e._params_q
        assert e._params_q["enc"] is e._params["enc"]
        assert e._params_q["out_q"]["l1"]["w_q"].dtype == torch.int8
        assert e.cfg.compute_dtype is None
        assert _tiny_engine()._params_q is None


# ---------------------------------------------------------------------------
# wire: precision is validated and asserted per request, declared in info
# ---------------------------------------------------------------------------

class PrecisionFakeEngine:
    """Minimal engine surface with model and precision labels (no device):
    the wire contract under test is validation and declaration."""

    def __init__(self, model, precision=None, dims=4):
        self.model = model
        self.models = frozenset({model})
        self.row_dims = {"score": dims}
        self.k = 5
        self.precision = precision

    def submit(self, op, row, k=None, *, seed=None, model=None, **kw):
        f = Future()
        f.set_result(float(sum(row)))
        return f

    def start(self):
        pass

    def stop(self, timeout_s=None):
        pass

    def warmup(self, ops=(), ks=None):
        return {"programs": 0.0}


def _raw_request(port, req):
    from iwae_replication_project_tpu_torch.serving.frontend import protocol

    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(protocol.encode_line(req))
        buf = b""
        while b"\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.split(b"\n", 1)[0].decode())


class TestWirePrecision:
    def _tier(self):
        from iwae_replication_project_tpu_torch.serving.frontend import (
            ServingTier)

        tier = ServingTier([PrecisionFakeEngine("m-a"),
                            PrecisionFakeEngine("m-b", precision="int8")],
                           port=0)
        tier.start()
        return tier

    def test_precisions_for_reports_fleet_policies(self):
        tier = self._tier()
        try:
            assert tier.precisions_for("m-a") == {"fp32"}
            assert tier.precisions_for("m-b") == {"int8"}
        finally:
            tier.stop(timeout_s=10)

    def test_unknown_precision_is_bad_request_connection_survives(self):
        tier = self._tier()
        try:
            resp = _raw_request(tier.port, {
                "id": 1, "op": "score", "x": [1.0] * 4, "model": "m-a",
                "precision": "fp16"})
            assert resp["ok"] is False and resp["error"] == "bad_request"
            assert "fp16" in resp["message"]
            resp = _raw_request(tier.port, {
                "id": 2, "op": "score", "x": [1.0] * 4, "model": "m-a",
                "precision": "int8"})
            assert resp["ok"] is False and resp["error"] == "bad_request"
            assert "not served at precision" in resp["message"]
            assert "fp32" in resp["message"]
        finally:
            tier.stop(timeout_s=10)

    def test_matching_precision_assertion_serves(self):
        tier = self._tier()
        try:
            for model, precision in (("m-a", "fp32"), ("m-b", "int8")):
                resp = _raw_request(tier.port, {
                    "id": 1, "op": "score", "x": [1.0] * 4,
                    "model": model, "precision": precision})
                assert resp["ok"] is True, resp
        finally:
            tier.stop(timeout_s=10)

    def test_info_declares_per_model_precision(self):
        tier = self._tier()
        try:
            models = tier.info()["models"]
            assert models["m-a"]["precision"] == "fp32"
            assert models["m-b"]["precision"] == "int8"
        finally:
            tier.stop(timeout_s=10)
