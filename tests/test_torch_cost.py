"""The port's cost analyzer (``analysis/audit/cost.py``) against the JAX
analyzer's cases (tests/test_cost.py), on aten graphs.

The FLOP accounting reconciles bit-exactly with ``utils/flops.py`` on the
flagship config for every program (the train step with its stated
correction), and ``utils/flops.py`` gives the JAX package's numbers on the
same config; the serving programs' I/O bytes equal
``serving/programs.static_cost`` at every bucket; the live-range memory
pass is proven on seeded fixtures (a materialised outer product and its
streaming twin, an in-place op, the k=5000 scorer's flat peak, a kernel
region charged as the card runs it); the sharded score's merge is one MAX
and one SUM over sp; and the suite analyzes clean, as the committed
``results/torch_cost_report.json`` records.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from iwae_replication_project_tpu_torch.analysis.audit import programs as P
from iwae_replication_project_tpu_torch.analysis.audit.core import (
    BARE_WAIVER,
)
from iwae_replication_project_tpu_torch.analysis.audit.cost import (
    BLOCK_BYTES,
    DEFAULT_BLOWUP_FACTOR,
    RULE_ACCIDENTAL_GATHER,
    RULE_MEMORY_BLOWUP,
    CostAnalyzer,
    analyze_programs,
    report_payload,
    resolve_card,
    roofline,
)
from iwae_replication_project_tpu_torch.analysis.audit.programs import (
    PROGRAM_NAMES,
    build_programs,
    record,
)
from iwae_replication_project_tpu_torch.utils import flops as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = os.path.join(REPO, "results", "torch_cost_report.json")

#: the flagship architecture every reconciliation is stated against
CFG = P.flagship()
H100 = "NVIDIA H100 80GB HBM3"


def analyze(fn, *args, name="fixture", waivers=None, mode="real",
            blowup_factor=DEFAULT_BLOWUP_FACTOR, scratch=None):
    prog = record(name, fn, *args, mode=mode, waivers=waivers or {})
    return CostAnalyzer(blowup_factor=blowup_factor,
                        scratch=scratch).analyze(prog)


def rules_of(findings):
    return [f.rule for f in findings]


def one(name):
    return CostAnalyzer().analyze(build_programs([name])[0])[0]


# ---------------------------------------------------------------------------
# byte widths (the port's utils/flops.byte_width)
# ---------------------------------------------------------------------------

class TestDtypes:
    @pytest.mark.parametrize("dtype,width", [
        (torch.float32, 4), (torch.bfloat16, 2), (torch.int32, 4),
        (torch.int8, 1), (torch.bool, 1), ("float32", 4), ("bfloat16", 2)])
    def test_widths(self, dtype, width):
        assert F.byte_width(dtype) == width

    @pytest.mark.parametrize("name", ["float32", "bfloat16", "int32",
                                      "int8", "bool", "uint8"])
    def test_widths_match_the_jax_package(self, name):
        from iwae_replication_project_tpu.utils.dtypes import byte_width
        assert F.byte_width(name) == byte_width(name)

    def test_unknown_dtype_raises(self):
        with pytest.raises(AttributeError):
            F.byte_width("no_such_dtype")

    def test_model_param_bytes_match_the_jax_package(self):
        from iwae_replication_project_tpu.models.iwae import ModelConfig
        from iwae_replication_project_tpu.utils import flops as JF
        jcfg = ModelConfig.two_layer(likelihood="logits")
        assert F.model_param_bytes(CFG) == JF.model_param_bytes(jcfg)
        assert F.model_param_bytes(CFG, "bfloat16") == \
            JF.model_param_bytes(jcfg, "bfloat16")


# ---------------------------------------------------------------------------
# pass 2: FLOP accounting, bit-exact against utils/flops.py
# ---------------------------------------------------------------------------

class TestFlopReconciliation:
    """iwae-cost counts the recorded program; utils/flops.py derives from
    the architecture; on the flagship they agree to the FLOP."""

    def test_serving_score_reconciles(self):
        # the audited serve_score: bucket 8, k=4
        assert one("serve_score").matmul_flops == \
            P.BUCKET * F.serving_score_flops_per_row(CFG, P.SERVE_K)

    def test_fused_serving_score_reconciles(self):
        assert one("serve_score_fused").matmul_flops == \
            P.BUCKET * F.serving_score_flops_per_row(CFG, P.SERVE_K)

    def test_sharded_score_reconciles(self):
        # rank 0 of sp=2 streams ceil(ceil(10/4)/2) = 2 blocks of 4
        assert one("serve_score_sharded").matmul_flops == \
            2 * F.forward_flops(CFG, P.BUCKET, P.SHARDED_CHUNK)

    def test_eval_scorer_reconciles(self):
        nll = (F.eval_suite_flops_per_image(CFG, 5, 5000, 250)
               - F.forward_flops(CFG, 1, 5) - F.forward_flops(CFG, 1, 1))
        assert one("eval_scorer_k5000").matmul_flops == P.EVAL_B * nll

    def test_eval_suite_term_identity(self):
        no_k, per_k = F.per_row_macs(CFG)
        nll = 2.0 * ((5000 // 250) * no_k + 5000 * per_k)
        assert (F.eval_suite_flops_per_image(CFG, 5, 5000, 250)
                == F.forward_flops(CFG, 1, 5) + nll
                + F.forward_flops(CFG, 1, 1))

    def test_full_eval_suite_reconciles(self):
        # the whole 7-scalar eval (metric pass + streamed NLL + 1-sample
        # reconstruction) against eval_suite_flops_per_image
        from iwae_replication_project_tpu_torch.evaluation.metrics import (
            dataset_scalars)
        host, leaves = P._weights(CFG)
        nb, B, k, nll_k, chunk = 2, 4, 3, 20, 10

        def suite(xb, *flat):
            return dataset_scalars(P._unflatten(host, flat), CFG, xb, k,
                                   nll_k, chunk)
        rec, _ = analyze(suite, torch.zeros(nb, B, CFG.x_dim), *leaves)
        assert rec.matmul_flops == \
            nb * B * F.eval_suite_flops_per_image(CFG, k, nll_k, chunk)

    def test_train_step_reconciles_with_exact_correction(self):
        # train_step_flops models backward as 2x forward. The recorded step
        # differs by two terms: B2 recomputes the output block's forward
        # (+2 k B out_macs), and the batch takes no gradient through the
        # first encoder layer (-2 B x_dim h0). With both the
        # reconciliation is bit-exact.
        k, b = P.TRAIN_K, P.TRAIN_B
        out_macs = F.output_block_macs(CFG.n_latent_dec[-2],
                                       CFG.n_hidden_dec[-1], CFG.x_dim)
        correction = 2.0 * k * b * out_macs \
            - 2.0 * b * CFG.x_dim * CFG.n_hidden_enc[0]
        assert one("train_step").matmul_flops == \
            F.train_step_flops(CFG, b, k) + correction

    @pytest.mark.parametrize("path", ["reference", "blocked_scan",
                                      "kernel"])
    def test_hot_loop_paths_reconcile(self, path):
        k, b = 12, 24
        assert one(f"hot_loop_{path}").matmul_flops == \
            2.0 * k * b * F.output_block_macs(20, 40, 30)

    def test_train_state_bytes_reconcile_with_param_count(self):
        # parameters, gradients and both moments (4x the parameter bytes),
        # one fp32 step count per leaf, the learning rate, the batch
        rec = one("train_step")
        leaves = len(P._weights(CFG)[1])
        assert rec.input_bytes == (4 * F.model_param_bytes(CFG)
                                   + 4 * leaves + 4
                                   + P.TRAIN_B * CFG.x_dim * 4)

    def test_flops_match_the_jax_package(self):
        from iwae_replication_project_tpu.models.iwae import ModelConfig
        from iwae_replication_project_tpu.utils import flops as JF
        jcfg = ModelConfig.two_layer(likelihood="logits")
        assert F.per_row_macs(CFG) == JF.per_row_macs(jcfg)
        assert F.forward_flops(CFG, 64, 50) == JF.forward_flops(jcfg, 64, 50)
        assert F.train_step_flops(CFG, 100, 50) == \
            JF.train_step_flops(jcfg, 100, 50)
        assert F.eval_suite_flops_per_image(CFG, 5, 5000, 250) == \
            JF.eval_suite_flops_per_image(jcfg, 5, 5000, 250)

    def test_declared_kernel_flops_count_once(self):
        # row_dense's plain version multiplies elementwise: its region
        # counts the kernel's 2 M K N, not its interior ops
        from iwae_replication_project_tpu_torch.ops import row_invariant as ri
        rec, _ = analyze(lambda x, w, b: ri.dense(x, w, b),
                         torch.zeros(6, 50), torch.zeros(50, 30),
                         torch.zeros(30))
        assert rec.matmul_flops == rec.flops == 2.0 * 6 * 50 * 30

    def test_matmul_flops_dominate_the_suite(self):
        records, _ = analyze_programs(["train_step", "serve_score"])
        for rec in records.values():
            assert 0.9 < rec.matmul_flops / rec.flops <= 1.0


class TestStaticCost:
    """The serving programs' recorded cost against the analytic record the
    observability plane divides by (serving/programs.static_cost)."""

    @pytest.mark.parametrize("op", ["score", "encode", "decode"])
    @pytest.mark.parametrize("bucket", [1, 2, 4, 8, 16, 32, 64])
    def test_serving_bytes_and_flops_equal_static_cost(self, op, bucket):
        from iwae_replication_project_tpu_torch.serving.programs import (
            static_cost)
        prog = P.build_serving(op, bucket=bucket, real=bucket, k=50,
                               mode="fake")
        rec, _ = CostAnalyzer().analyze(prog)
        want = static_cost(P.card_config(CFG, serving=True), op, 50, bucket)
        assert rec.bytes_accessed_fused == want["bytes_accessed_fused"]
        assert rec.matmul_flops == want["flops"]


# ---------------------------------------------------------------------------
# pass 1: live-range peak memory
# ---------------------------------------------------------------------------

class TestPeakMemory:
    N = 512  # fixture elements: 2048 bytes, a whole number of blocks

    def test_inputs_are_resident(self):
        rec, _ = analyze(lambda x: x * 2.0, torch.zeros(self.N))
        assert rec.input_bytes == self.N * 4
        assert rec.peak_bytes >= 2 * self.N * 4  # input + output live

    def test_dead_intermediates_are_freed(self):
        def chain(x):
            for _ in range(8):
                x = x * 2.0
            return x
        rec, _ = analyze(chain, torch.zeros(self.N))
        assert rec.peak_bytes <= 4 * self.N * 4

    def test_inplace_ops_allocate_nothing(self):
        # the port's counterpart of JAX's donation: a write into the
        # operand's own storage
        def inplace(a, b):
            return a.add_(b)
        rec_i, _ = analyze(inplace, torch.zeros(self.N), torch.zeros(self.N))
        rec_p, _ = analyze(lambda a, b: a + b, torch.zeros(self.N),
                           torch.zeros(self.N))
        assert rec_i.peak_bytes == 2 * self.N * 4
        assert rec_p.peak_bytes == 3 * self.N * 4

    def test_views_allocate_nothing(self):
        rec, _ = analyze(lambda x: x.view(-1, 4).t().unsqueeze(0) * 2,
                         torch.zeros(self.N))
        assert rec.peak_bytes == 2 * self.N * 4

    def test_blocks_round_up_as_the_allocator_does(self):
        rec, _ = analyze(lambda x: x * 2, torch.zeros(3))
        assert rec.peak_bytes == 2 * BLOCK_BYTES
        assert rec.peak_bytes_plain == 2 * 3 * 4

    def test_streaming_memory_is_flat_in_k(self):
        # the k=5000 eval design, statically: the streamed scorer's peak is
        # one chunk's working set, however many chunks stream through
        from iwae_replication_project_tpu_torch.evaluation.metrics import (
            streaming_log_px)
        host, leaves = P._weights(P.card_config(CFG))
        x = torch.zeros(4, CFG.x_dim)

        def scorer(k):
            def fn(x, *flat):
                return streaming_log_px(P._unflatten(host, flat),
                                        P.card_config(CFG), x, k=k,
                                        chunk=100)
            return analyze(fn, x, *leaves, mode="fake")[0]
        short, long = scorer(200), scorer(2000)
        assert long.peak_bytes > 1_000_000
        assert long.peak_bytes == short.peak_bytes
        assert long.matmul_flops / short.matmul_flops == pytest.approx(
            10.0, rel=1e-9)

    def test_kernel_region_is_charged_as_the_card_runs_it(self):
        # B1's plain version materialises its logits; the kernel keeps them
        # on chip and hands out [k, B] alone
        rec = one("hot_loop_kernel")
        ref = one("hot_loop_reference")
        assert rec.peak_bytes < ref.peak_bytes
        assert rec.peak_bytes_plain == ref.peak_bytes_plain

    def test_kernel_scratch_is_charged_during_its_call(self):
        prog = build_programs(["hot_loop_kernel"])[0]
        base, _ = CostAnalyzer().analyze(prog)
        more, _ = CostAnalyzer(scratch={"hot_loop_fwd": 1 << 20}).analyze(
            prog)
        assert base.peak_bytes < more.peak_bytes <= \
            base.peak_bytes + (1 << 20)
        assert more.scratch_bytes == 1 << 20

    def test_memory_blowup_fires_on_materialized_outer_product(self):
        x, y = torch.zeros(256, 1), torch.zeros(1, 256)
        rec, findings = analyze(lambda x, y: torch.sum(x * y), x, y,
                                name="blowup")
        assert rules_of(findings) == [RULE_MEMORY_BLOWUP]
        assert "OOM cliff" in findings[0].message
        assert rec.largest_intermediate_bytes == 256 * 256 * 4

    def test_discharged_twin_is_clean(self):
        x, y = torch.zeros(256, 1), torch.zeros(1, 256)
        rec, findings = analyze(lambda x, y: torch.sum(x) * torch.sum(y),
                                x, y, name="streamed")
        assert findings == []
        assert rec.largest_intermediate_bytes <= 256 * 4

    def test_waiver_with_justification_silences(self):
        x, y = torch.zeros(256, 1), torch.zeros(1, 256)
        _, findings = analyze(
            lambda x, y: torch.sum(x * y), x, y, name="waived",
            waivers={RULE_MEMORY_BLOWUP: "fixture: the blowup is the test"})
        assert findings == []

    def test_bare_waiver_is_its_own_finding(self):
        x, y = torch.zeros(256, 1), torch.zeros(1, 256)
        _, findings = analyze(lambda x, y: torch.sum(x * y), x, y,
                              name="bare", waivers={RULE_MEMORY_BLOWUP: ""})
        got = rules_of(findings)
        assert BARE_WAIVER in got and RULE_MEMORY_BLOWUP in got

    def test_timeline_peaks_at_the_peak(self):
        prog = build_programs(["serve_decode"])[0]
        an = CostAnalyzer()
        rec, _ = an.analyze(prog)
        curve = an.timeline(prog)
        assert curve and max(c for _, c in curve) <= rec.peak_bytes


# ---------------------------------------------------------------------------
# pass 3: collective accounting
# ---------------------------------------------------------------------------

class TestCollectives:
    def test_sharded_score_merge_is_one_max_one_sum_over_sp(self):
        """The merge contract, machine-checked: one MAX and one SUM of the
        [B] carries over sp, and one SUM over the world to gather the rows;
        nothing else, no gathers."""
        rec, findings = CostAnalyzer().analyze(
            build_programs(["serve_score_sharded"])[0])
        assert findings == []
        rows = 4.0 * P.BUCKET
        assert rec.collectives == {
            "all_reduce.max": {"sp": {"count": 1.0, "bytes": rows}},
            "all_reduce.sum": {"sp": {"count": 1.0, "bytes": rows},
                               "world": {"count": 1.0, "bytes": rows}},
        }

    def test_unsharded_programs_have_no_collectives(self):
        records, _ = analyze_programs(["serve_score", "train_step"])
        for rec in records.values():
            assert rec.collectives == {}
            assert rec.collective_bytes == 0.0

    def test_accidental_all_gather_is_a_finding(self):
        # a gather over dp=2 of the rows, just to be summed again
        def gathery(x):
            return torch.sum(torch.ops.iwae_audit.all_gather(x, "dp", 2),
                             dim=0)
        rec, findings = analyze(gathery, torch.zeros(4, 8), name="gathery")
        assert rules_of(findings) == [RULE_ACCIDENTAL_GATHER]
        assert "all_gather" in rec.collectives
        assert "serving-latency cliff" in findings[0].message


# ---------------------------------------------------------------------------
# roofline verdicts
# ---------------------------------------------------------------------------

class TestRoofline:
    def test_big_matmul_is_compute_bound_on_the_h100(self):
        # AI of a 2048^3 fp32 matmul ~ 341 flops/byte > ridge ~ 295
        a = torch.zeros(2048, 2048)
        rec, _ = analyze(lambda a, b: a @ b, a, a, name="mm", mode="fake")
        assert roofline(rec, H100)["verdict"] == "compute-bound"

    def test_elementwise_is_memory_bound(self):
        x = torch.zeros(4096)
        rec, _ = analyze(lambda x, y: x + y, x, x, name="ew")
        assert roofline(rec, H100)["verdict"] == "memory-bound"

    def test_unknown_card_reports_null_not_fabricated(self):
        rec, _ = analyze(lambda x: x * 2, torch.zeros(8))
        rl = roofline(rec, "mystery9000")
        assert rl["verdict"] is None and "mystery9000" in \
            rl["verdict_null_reason"]

    def test_mfu_ceiling_is_a_fraction(self):
        ceiling = roofline(one("serve_score"), H100)["static_mfu_ceiling"]
        assert 0.0 < ceiling <= 1.0

    def test_card_resolution_never_silent(self):
        name, source = resolve_card(None)
        if not torch.cuda.is_available():
            assert name == H100 and "assuming" in source
        assert resolve_card("NVIDIA A100") == ("NVIDIA A100",
                                               "explicit --card")


# ---------------------------------------------------------------------------
# the real program suite
# ---------------------------------------------------------------------------

class TestRealSuite:
    def test_full_suite_analyzes_clean(self):
        """The acceptance gate: cost records for all 10 programs, zero
        findings (scripts/torch_check.py's cost stage)."""
        records, findings = analyze_programs()
        assert findings == [], "\n".join(f.human() for f in findings)
        assert list(records) == list(PROGRAM_NAMES)
        for rec in records.values():
            assert rec.peak_bytes > 0 and rec.flops > 0

    def test_eval_scorer_sits_under_the_blowup_threshold_with_margin(self):
        rec = one("eval_scorer_k5000")
        ratio = rec.largest_intermediate_bytes / rec.input_bytes
        assert ratio < DEFAULT_BLOWUP_FACTOR * 0.75

    def test_card_peak_is_below_the_plain_versions_for_kernel_programs(self):
        for name in ("eval_scorer_k5000", "serve_score", "hot_loop_kernel"):
            rec = one(name)
            assert rec.peak_bytes - rec.resident_bytes < \
                rec.peak_bytes_plain - rec.input_bytes, name

    def test_committed_report_matches_a_fresh_run(self):
        """results/torch_cost_report.json is the analyzer's own output on
        this suite (regenerate: python -m
        iwae_replication_project_tpu_torch.analysis.audit.cost --out
        results/torch_cost_report.json)."""
        with open(REPORT, encoding="utf-8") as f:
            committed = json.load(f)
        records, findings = analyze_programs()
        card, source = resolve_card(committed["card"]["name"])
        fresh = json.loads(json.dumps(report_payload(
            records, findings, card, committed["card"]["source"]),
            sort_keys=True))
        assert fresh == committed
        assert committed["total"] == 0
        assert set(committed["programs"]) == set(PROGRAM_NAMES)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_cli(module, *args):
    return subprocess.run(
        [sys.executable, "-m",
         f"iwae_replication_project_tpu_torch.analysis.audit{module}",
         *args], cwd=REPO, capture_output=True, text=True)


class TestCli:
    def test_clean_json_run(self, tmp_path):
        out = tmp_path / "cost_report.json"
        r = run_cli(".cost", "--format", "json",
                    "--programs", "hot_loop_reference,hot_loop_kernel",
                    "--out", str(out))
        assert r.returncode == 0, r.stdout + r.stderr
        payload = json.loads(r.stdout)
        assert payload["total"] == 0
        assert set(payload["programs"]) == {"hot_loop_reference",
                                            "hot_loop_kernel"}
        rec = payload["programs"]["hot_loop_reference"]
        assert rec["peak_bytes"] > 0 and rec["roofline"]["card"]
        assert json.loads(out.read_text())["programs"].keys() \
            == payload["programs"].keys()

    def test_findings_exit_1(self):
        # an absurd threshold turns an ordinary intermediate into a
        # finding: exit 1 (findings), not 2 (crash)
        r = run_cli(".cost", "--programs", "hot_loop_reference",
                    "--blowup-factor", "0.1")
        assert r.returncode == 1
        assert RULE_MEMORY_BLOWUP in r.stdout

    @pytest.mark.parametrize("module", [".cost", ""])
    def test_unknown_program_exits_2_listing_valid_names(self, module):
        r = run_cli(module, "--programs", "no_such_program")
        assert r.returncode == 2, (module, r.stdout, r.stderr)
        assert "unknown program" in r.stderr
        assert "serve_score_sharded" in r.stderr
        assert "Traceback" not in r.stderr
