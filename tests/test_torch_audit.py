"""The port's program auditor (``iwae_replication_project_tpu_torch/analysis/
audit/``) against the JAX auditor's cases (tests/test_audit.py), on aten
graphs.

Every pass is proven live by a fixture program seeding its hazard (an
in-place write into the payload, an output aliasing an input, an unmasked
padded reduction, a host read inside a hot program, a Python number in the
store's signature, a closure constant in a captured program), each
hazard's twin is proven clean, the real program suite audits clean (the
gate ``scripts/torch_check.py`` runs), and the golden aten signatures pin
the serving programs and the train step. The JAX lint fixtures of
tests/test_audit.py (TestConcurrencyRules) have their port counterparts in
tests/test_torch_analysis.py.
"""

import inspect
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from iwae_replication_project_tpu_torch.analysis.audit import (
    BARE_WAIVER,
    PROGRAM_NAMES,
    AuditEnv,
    all_passes,
    build_programs,
    run_audit,
    select_passes,
    signature,
)
from iwae_replication_project_tpu_torch.analysis.audit.programs import record

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_PATH = os.path.join(REPO, "tests", "golden",
                           "torch_aten_signatures.json")

#: an env without the live store (no cross-test bleed)
ENV = AuditEnv(device="cuda")


def prog(name, fn, *args, taints=None, sig_args=None, hot=True,
         captured=False, state_inputs=(), waivers=None):
    return record(name, fn, *args, taints=taints or {}, sig_args=sig_args,
                  hot=hot, captured=captured,
                  state_inputs=frozenset(state_inputs),
                  waivers=waivers or {})


def audit(p, pass_name, env=ENV):
    return run_audit([p], select_passes([pass_name]), env)


def rules_of(findings):
    return [f.rule for f in findings]


def lse_rows(x):
    """THE IWAE hazard: a logsumexp over the (padded) row axis."""
    return torch.logsumexp(x, dim=0).mean()


# ---------------------------------------------------------------------------
# framework
# ---------------------------------------------------------------------------

class TestFramework:
    def test_four_passes_registered(self):
        assert set(all_passes()) >= {"donation-safety", "padding-taint",
                                     "host-transfer", "recompile-cardinality"}

    def test_unknown_pass_raises(self):
        with pytest.raises(ValueError, match="unknown pass"):
            select_passes(["no-such-pass"])

    def test_unknown_program_raises(self):
        with pytest.raises(ValueError, match="unknown program"):
            build_programs(["no-such-program"])

    def test_program_names_are_jaxs_with_the_kernel_path(self):
        from iwae_replication_project_tpu.analysis.audit.programs import (
            PROGRAM_NAMES as JAX_NAMES)
        assert PROGRAM_NAMES == tuple(
            "hot_loop_kernel" if n == "hot_loop_pallas" else n
            for n in JAX_NAMES)

    def test_waiver_silences_with_justification(self):
        p = prog("waived", lambda x: lse_rows(
            torch.nn.functional.pad(x, (0, 0, 0, 3))), torch.zeros(8, 4),
            waivers={"padding-taint": "fixture: the hazard is the test"})
        assert audit(p, "padding-taint") == []

    def test_bare_waiver_is_its_own_finding(self):
        p = prog("bare", lambda x: lse_rows(
            torch.nn.functional.pad(x, (0, 0, 0, 3))), torch.zeros(8, 4),
            waivers={"padding-taint": ""})
        got = rules_of(audit(p, "padding-taint"))
        assert BARE_WAIVER in got and "padding-taint" in got


# ---------------------------------------------------------------------------
# pass 1: donation-safety (in-place writes into inputs the program does
# not own; outputs aliasing inputs)
# ---------------------------------------------------------------------------

class TestDonationSafety:
    def test_fires_on_inplace_write_into_the_payload(self):
        def scale(x, w):
            x.mul_(2.0)                 # writes into the caller's payload
            return x @ w
        p = prog("writes_payload", scale, torch.zeros(4, 3),
                 torch.zeros(3, 2))
        got = audit(p, "donation-safety")
        assert rules_of(got) == ["donation-safety"]
        assert "not among the program's declared state" in got[0].message

    def test_clean_when_the_write_is_declared_state(self):
        def update(p, g):
            p.add_(g)
            return (p * 2).sum()
        p = prog("state", update, torch.zeros(3), torch.zeros(3),
                 state_inputs={0})
        assert audit(p, "donation-safety") == []

    def test_fires_on_output_aliasing_an_input(self):
        p = prog("alias_out", lambda x: x.view(-1), torch.zeros(2, 3))
        got = audit(p, "donation-safety")
        assert rules_of(got) == ["donation-safety"]
        assert "aliases input #0" in got[0].message

    def test_clean_on_a_fresh_output(self):
        p = prog("fresh", lambda x: x.view(-1) * 2, torch.zeros(2, 3))
        assert audit(p, "donation-safety") == []

    def test_write_through_a_view_reaches_the_input(self):
        def through_view(x):
            x[1:].zero_()
            return x.sum()
        p = prog("view_write", through_view, torch.zeros(4, 3))
        assert rules_of(audit(p, "donation-safety")) == ["donation-safety"]

    def test_graph_program_clones_its_output(self):
        # a replay's output is copied out of the graph's static buffer: a
        # caller never holds memory the next replay overwrites
        from iwae_replication_project_tpu_torch.utils.compile_cache import (
            GraphProgram)
        assert "self._out.clone()" in inspect.getsource(
            GraphProgram.__call__)

    def test_real_train_step_writes_only_its_state(self):
        from iwae_replication_project_tpu_torch.analysis.audit.graphs import (
            iter_nodes, mutated_args, placeholders)
        from iwae_replication_project_tpu_torch.analysis.audit.passes import (
            storage_root)
        p = build_programs(["train_step"])[0]
        index = {n: i for i, n in enumerate(placeholders(p.graph))}
        written = set()
        for _, node in iter_nodes(p.graph):
            for i in mutated_args(node):
                targets = node.args[i] if i < len(node.args) else \
                    node.kwargs.get("out")
                for t in (targets if isinstance(targets, (list, tuple))
                          else [targets]):
                    root = storage_root(t) if isinstance(
                        t, torch.fx.Node) else None
                    if root is not None:
                        written.add(index[root])
        # parameters, gradients, both moments and the step counts: all
        # written, all declared; the batch and the learning rate untouched
        assert written == set(p.state_inputs)


# ---------------------------------------------------------------------------
# pass 2: padding-taint
# ---------------------------------------------------------------------------

class TestPaddingTaint:
    X = torch.zeros(8, 4)

    def test_fires_on_unmasked_logsumexp_over_padded_rows(self):
        p = prog("bad_lse", lse_rows, self.X, taints={0: {0: 5}})
        got = audit(p, "padding-taint")
        assert got and all(f.rule == "padding-taint" for f in got)

    def test_clean_when_arange_mask_discharges_the_taint(self):
        def masked(x):
            keep = torch.arange(8)[:, None] < 5
            return lse_rows(torch.where(keep, x, -math.inf))
        p = prog("good_lse", masked, self.X, taints={0: {0: 5}})
        assert audit(p, "padding-taint") == []

    def test_masked_fill_on_the_padded_rows_discharges(self):
        def filled(x):
            pad = torch.arange(8)[:, None] >= 5
            return lse_rows(x.masked_fill(pad, -math.inf))
        p = prog("filled", filled, self.X, taints={0: {0: 5}})
        assert audit(p, "padding-taint") == []

    def test_masked_fill_on_the_real_rows_does_not(self):
        def filled(x):
            real = torch.arange(8)[:, None] < 5
            return lse_rows(x.masked_fill(real, -math.inf))
        p = prog("filled_wrong", filled, self.X, taints={0: {0: 5}})
        assert rules_of(audit(p, "padding-taint")) != []

    def test_pad_seeds_taint_without_declaration(self):
        p = prog("pad_lse", lambda x: lse_rows(
            torch.nn.functional.pad(x, (0, 0, 0, 3))), self.X)
        assert rules_of(audit(p, "padding-taint")) != []

    def test_zero_padding_under_a_sum_is_exact(self):
        # the fixed-order plain versions pad a contraction with zeros on
        # both operands: a sum of exact zeros adds nothing
        p = prog("pad_sum", lambda x: torch.nn.functional.pad(
            x, (0, 0, 0, 3)).sum(0), self.X)
        assert audit(p, "padding-taint") == []

    def test_slice_off_the_padding_discharges(self):
        p = prog("pad_slice", lambda x: lse_rows(
            (torch.nn.functional.pad(x, (0, 0, 0, 3)) * 2)[:8]), self.X)
        assert audit(p, "padding-taint") == []

    def test_fires_on_contraction_over_padded_axis(self):
        p = prog("mm_contract", lambda x: x.t() @ x, self.X,
                 taints={0: {0: 5}})
        got = audit(p, "padding-taint")
        assert got and "aten.mm" in got[0].location

    def test_contraction_over_zero_padding_is_exact(self):
        w = torch.zeros(7, 3)

        def padded_k(x, w):
            xp = torch.nn.functional.pad(x, (0, 3))        # K 4 -> 7
            return (xp @ w).sum(1)
        p = prog("mm_zero_pad", padded_k, self.X, w)
        assert audit(p, "padding-taint") == []

    def test_inverted_arange_mask_does_not_discharge(self):
        def inverted(x):
            drop = torch.arange(8)[:, None] >= 5
            return lse_rows(torch.where(drop, x, -math.inf))
        p = prog("bad_mask", inverted, self.X, taints={0: {0: 5}})
        assert rules_of(audit(p, "padding-taint")) != []

    def test_uncompared_arange_does_not_discharge(self):
        def bogus(x):
            raw = torch.arange(8)[:, None].bool()
            return torch.where(raw, x, 0.0).sum(0)
        p = prog("raw_arange", bogus, self.X, taints={0: {0: 5}})
        assert rules_of(audit(p, "padding-taint")) != []

    def test_wrong_boundary_literal_mask_does_not_discharge(self):
        def overwide(x):
            keep = torch.arange(8)[:, None] < 8
            return lse_rows(torch.where(keep, x, -math.inf))
        p = prog("wide_mask", overwide, self.X, taints={0: {0: 5}})
        assert rules_of(audit(p, "padding-taint")) != []

    def test_tensor_mask_bound_discharges_on_trust(self):
        from iwae_replication_project_tpu_torch.analysis.audit.taint import (
            TaintEngine)

        def masked(x, n):
            keep = torch.arange(8)[:, None] < n
            return lse_rows(torch.where(keep, x, -math.inf))
        p = prog("traced_mask", masked, self.X, torch.tensor(5),
                 taints={0: {0: 5}})
        assert audit(p, "padding-taint") == []
        engine = TaintEngine(report=lambda loc, msg: None)
        engine.run(p.graph, p.taints, root=p.name)
        assert engine.stats.unverified_mask_discharges == 1

    def test_reverse_cumsum_poisons_the_real_rows(self):
        p = prog("rev_cum", lambda x: x.flip(0).cumsum(0).flip(0)[:5].sum(),
                 self.X, taints={0: {0: 5}})
        assert rules_of(audit(p, "padding-taint")) != []

    def test_forward_cumsum_keeps_the_unpad_discharge(self):
        p = prog("fwd_cum", lambda x: x.cumsum(0)[:5].sum(), self.X,
                 taints={0: {0: 5}})
        assert audit(p, "padding-taint") == []

    def test_reduction_along_clean_axis_stays_clean(self):
        p = prog("other_axis", lambda x: (x * 2.0).sum(1), self.X,
                 taints={0: {0: 5}})
        assert audit(p, "padding-taint") == []

    @pytest.mark.parametrize("rows,hazard", [(8, True), (5, False)])
    def test_row_by_row_sum_over_padded_rows(self, rows, hazard):
        # the unrolled form of a reduction: acc + x[r] for each row
        def unrolled(x):
            acc = torch.zeros(4)
            for r in range(rows):
                acc = acc + x[r]
            return acc
        p = prog(f"unrolled_{rows}", unrolled, self.X, taints={0: {0: 5}})
        assert bool(audit(p, "padding-taint")) is hazard

    def test_reshape_round_trip_keeps_the_row_axis(self):
        # [k, B, H] -> [k*B, H] @ W -> [k, B, N]: the matmul of a 3-D
        # operand; a logsumexp over k (not rows) stays clean
        w = torch.zeros(4, 6)

        def lse_k(x3, w):
            return torch.logsumexp((x3 @ w).sum(-1), dim=0)
        p = prog("k_lse", lse_k, torch.zeros(3, 8, 4), w,
                 taints={0: {1: 5}})
        assert audit(p, "padding-taint") == []

    def test_write_into_a_view_carries_the_taint(self):
        def copied(x):
            out = torch.zeros(8, 4)
            out[0:8] = x
            return out.sum(0)
        p = prog("view_copy", copied, self.X, taints={0: {0: 5}})
        assert rules_of(audit(p, "padding-taint")) != []

    def test_serving_rows_survive_the_fixed_order_plain_versions(self):
        # row_dense's plain version (zero-padded K, slab sums) and rowwise
        # over a padded bucket: rows never mix, so the score is clean
        from iwae_replication_project_tpu_torch.ops import row_invariant as ri
        w, b = torch.randn(50, 30), torch.zeros(30)

        def layer(x, w, b):
            y = ri.dense(x, w, b, tanh=True)
            return ri.fixed_sum(ri.rowwise(torch.sigmoid, y), -1)
        p = prog("row_ops", layer, torch.zeros(8, 50), w, b,
                 taints={0: {0: 5}})
        assert audit(p, "padding-taint") == []
        assert signature(p.graph)["kernels"] == {"row_dense": 1,
                                                 "row_sum": 1}


# ---------------------------------------------------------------------------
# pass 3: host-transfer
# ---------------------------------------------------------------------------

class TestHostTransfer:
    @staticmethod
    def _with_item(x):
        if x.sum().item() > 0:        # a host read: every dispatch stalls
            return x * 2
        return x * 3

    def test_fires_on_item_in_hot_program(self):
        p = prog("item", self._with_item, torch.zeros(3))
        got = audit(p, "host-transfer")
        assert rules_of(got) == ["host-transfer"]
        assert p.graph is None and "host read" in got[0].message

    def test_cold_programs_are_exempt(self):
        p = prog("item_cold", self._with_item, torch.zeros(3), hot=False)
        assert audit(p, "host-transfer") == []

    def test_fires_on_data_dependent_shape(self):
        p = prog("nonzero", lambda x: torch.nonzero(x), torch.ones(3))
        got = audit(p, "host-transfer")
        assert got and "aten.nonzero" in got[0].message

    def test_clean_pure_program(self):
        p = prog("pure", lambda x: torch.tanh(x).sum(), torch.zeros(3))
        assert audit(p, "host-transfer") == []


# ---------------------------------------------------------------------------
# pass 4: recompile-cardinality
# ---------------------------------------------------------------------------

CONST = torch.ones(3)


class TestRecompileCardinality:
    def test_fires_on_python_scalar_in_signature(self):
        x = torch.zeros(3)
        p = prog("scalar_sig", lambda x: x * 2, x, sig_args=((x, 0.75), {}))
        got = audit(p, "recompile-cardinality")
        assert rules_of(got) == ["recompile-cardinality"]
        assert "PER VALUE" in got[0].message

    @pytest.mark.parametrize("captured", [True, False])
    def test_closure_constant_in_a_captured_program(self, captured):
        p = prog("const", lambda x: x * CONST, torch.zeros(3),
                 captured=captured)
        got = audit(p, "recompile-cardinality")
        assert rules_of(got) == (["recompile-cardinality"] if captured
                                 else [])
        if captured:
            assert "_tensor_constant" in got[0].location

    def test_clean_on_tensors(self):
        x = torch.zeros(3)
        p = prog("clean_sig", lambda x: x * 2, x, sig_args=((x,), {}),
                 captured=True)
        assert audit(p, "recompile-cardinality") == []

    def test_store_keys_are_audited(self):
        from iwae_replication_project_tpu_torch.utils.compile_cache import (
            aot_call, executable_store, isolated_aot_registry)
        with isolated_aot_registry():
            # a python float rides the dispatch args: one entry per value
            aot_call("frag_prog", lambda x, s: x * s, (torch.zeros(2), 0.5))
            env = AuditEnv(device="cuda",
                           store_keys=executable_store().keys())
            p = prog("any", lambda x: x * 1, torch.zeros(1))
            got = run_audit([p], select_passes(["recompile-cardinality"]),
                            env)
        assert [f.program for f in got] == ["store:default/frag_prog"]

    def test_store_findings_run_once_and_ignore_program_waivers(self):
        from iwae_replication_project_tpu_torch.utils.compile_cache import (
            aot_call, executable_store, isolated_aot_registry)
        with isolated_aot_registry():
            aot_call("frag_prog", lambda x, s: x * s, (torch.zeros(2), 0.5))
            env = AuditEnv(device="cuda",
                           store_keys=executable_store().keys())
            p1 = prog("waived", lambda x: x * 1, torch.zeros(1),
                      waivers={"recompile-cardinality": "fixture program"})
            p2 = prog("plain", lambda x: x * 1, torch.zeros(1))
            got = run_audit([p1, p2],
                            select_passes(["recompile-cardinality"]), env)
        assert [f.program for f in got] == ["store:default/frag_prog"]

    def test_the_engines_signature_holds_tensors_only(self):
        # the serving entry keys on the payload and the noise alone; k and
        # the bucket are the build key's declared statics
        for p in build_programs(["serve_score", "serve_encode",
                                 "serve_decode", "serve_score_sharded"]):
            args, kwargs = p.sig_args
            assert all(isinstance(a, torch.Tensor) for a in args)
            assert kwargs == {}


# ---------------------------------------------------------------------------
# the real program suite + golden signatures
# ---------------------------------------------------------------------------

class TestRealProgramSuite:
    def test_tree_audits_clean(self):
        """THE acceptance gate: every pass over every real program
        (scripts/torch_check.py's audit stage)."""
        programs = build_programs()
        findings = run_audit(programs, all_passes(),
                             AuditEnv.current(include_store=False))
        assert findings == [], "\n".join(f.human() for f in findings)
        assert all(p.graph is not None for p in programs)

    @pytest.mark.parametrize("name,padded", [
        ("serve_score", 3), ("serve_encode", 3), ("serve_decode", 2),
        ("serve_score_fused", 3), ("serve_score_sharded", 1)])
    def test_serving_programs_declare_their_padding(self, name, padded):
        # the payload, and each layer's injected noise (the sharded
        # program draws its noise in the program)
        from iwae_replication_project_tpu_torch.analysis.audit.graphs import (
            placeholders, val)
        from iwae_replication_project_tpu_torch.analysis.audit.programs \
            import BUCKET, REAL_ROWS
        p = build_programs([name])[0]
        assert len(p.taints) == padded, \
            f"{p.name} lost its padded-row taint declaration"
        phs = placeholders(p.graph)
        for i, spec in p.taints.items():
            (axis, real), = spec.items()
            assert real == REAL_ROWS
            assert val(phs[i]).shape[axis] == BUCKET

    @pytest.mark.parametrize("name,kernels", [
        ("serve_score", {"hot_loop_fwd": 1, "row_dense": 12, "row_sum": 5}),
        ("serve_encode", {"row_dense": 8, "row_sum": 3}),
        ("serve_decode", {"row_dense": 7}),
        ("train_step", {"hot_loop_bwd": 1, "hot_loop_fwd": 1}),
        ("eval_scorer_k5000", {"hot_loop_fwd": 20, "latent_block": 40}),
        ("hot_loop_kernel", {"hot_loop_fwd": 1})])
    def test_programs_record_the_kernels_the_card_launches(self, name,
                                                           kernels):
        # the counts a replayed 64-row program launches on the card
        # (chip_smoke.py phase 12: row_dense 12 / 8 / 7 and row_sum 5 / 3
        # / 0 per score / encode / decode dispatch), one B1 and B2 per
        # step, one B1 and two latent blocks (q(h2|h1), p(h1|h2)) per
        # k=5000 chunk of 250
        p = build_programs([name])[0]
        assert signature(p.graph)["kernels"] == kernels

    def test_the_kernel_pin_holds_only_for_the_recording_thread(self):
        # the dispatcher refuses a kernel pin on the CPU; the recorder lets
        # it through on its own thread alone, and only while it records
        import threading

        from iwae_replication_project_tpu_torch.analysis.audit.graphs import (
            recording_kernels)
        from iwae_replication_project_tpu_torch.ops import hot_loop

        cpu = torch.device("cpu")

        def refused():
            try:
                hot_loop.select_path(cpu, "kernel")
            except ValueError as e:
                return "needs CUDA" in str(e)
            return False

        assert refused()
        seen = {}
        with recording_kernels():
            assert hot_loop.select_path(cpu, "kernel") == "kernel"
            assert hot_loop.select_path(cpu, "reference") == "reference"
            other = threading.Thread(
                target=lambda: seen.update(refused=refused()))
            other.start()
            other.join()
        assert seen == {"refused": True}
        assert refused()

    def test_golden_aten_signatures(self):
        """Program-drift tripwire: op count and histogram of the serving
        programs and the train step. An intended change regenerates with
        IWAE_UPDATE_GOLDENS=1 (and shows in the diff)."""
        with open(GOLDEN_PATH, encoding="utf-8") as f:
            golden = json.load(f)
        current = {p.name: signature(p.graph)
                   for p in build_programs(sorted(golden))}
        if os.environ.get("IWAE_UPDATE_GOLDENS"):
            with open(GOLDEN_PATH, "w", encoding="utf-8") as f:
                json.dump(current, f, indent=2, sort_keys=True)
                f.write("\n")
            golden = current
        assert current == golden, (
            "recorded program structure drifted from tests/golden/"
            "torch_aten_signatures.json — if intended, regenerate with "
            "IWAE_UPDATE_GOLDENS=1 pytest tests/test_torch_audit.py")

    def test_trace_in_fake_mode_matches_real_mode(self):
        from iwae_replication_project_tpu_torch.analysis.audit import programs
        real = programs.build_serving("decode")
        fake = programs.build_serving("decode", mode="fake")
        assert signature(fake.graph) == signature(real.graph)

    def test_the_package_imports_no_jax(self):
        code = ("import sys; sys.modules['jax'] = None; "
                "sys.modules['iwae_replication_project_tpu'] = None; "
                "import iwae_replication_project_tpu_torch.analysis.audit."
                "cost, iwae_replication_project_tpu_torch.analysis.audit."
                "cli; print('ok')")
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                           capture_output=True, text=True)
        assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_cli(*args):
    return subprocess.run(
        [sys.executable, "-m",
         "iwae_replication_project_tpu_torch.analysis.audit", *args],
        cwd=REPO, capture_output=True, text=True)


class TestCli:
    def test_list_passes(self):
        r = run_cli("--list-passes")
        assert r.returncode == 0
        for name in ("donation-safety", "padding-taint", "host-transfer",
                     "recompile-cardinality"):
            assert name in r.stdout

    def test_unknown_select_exits_2(self):
        r = run_cli("--select", "nope")
        assert r.returncode == 2
        assert "error" in r.stderr

    def test_self_audit_clean_json(self):
        """The CI invocation: full suite, JSON output, exit 0."""
        r = run_cli("--format", "json")
        assert r.returncode == 0, r.stdout + r.stderr
        payload = json.loads(r.stdout)
        assert payload["total"] == 0
        assert set(payload["programs"]) == set(PROGRAM_NAMES)


# ---------------------------------------------------------------------------
# scripts/torch_check.py
# ---------------------------------------------------------------------------

def _check_module():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import torch_check
    finally:
        sys.path.pop(0)
    return torch_check


class TestCheckSummary:
    @pytest.mark.parametrize("rc,status", [
        (0, "ok"), (1, "findings"), (2, "internal-error"),
        (139, "internal-error"), (-11, "internal-error")])
    def test_analyzer_rc_classification(self, rc, status):
        """An analyzer crash (exit 2, a signal) must never pass as a
        findings list, nor findings as a crash."""
        assert _check_module().classify_analyzer_rc(rc) == status

    def test_tests_stage_command(self):
        cmd = _check_module().test_command(("-x",))
        files = [c for c in cmd if c.startswith("tests/")]
        assert files and all(os.path.basename(f).startswith("test_torch_")
                             for f in files)
        assert "not slow and not cuda" in cmd and cmd[-1] == "-x"

    def test_lint_only_writes_summary(self, tmp_path):
        out = tmp_path / "summary.json"
        r = subprocess.run(
            [sys.executable, os.path.join("scripts", "torch_check.py"),
             "--lint-only", "--programs", "hot_loop_reference",
             "--summary", str(out)],
            cwd=REPO, capture_output=True, text=True)
        assert r.returncode == 0, r.stdout + r.stderr
        payload = json.loads(out.read_text())
        assert payload["ok"] is True
        assert [s["name"] for s in payload["stages"]] == \
            ["lint", "race", "audit", "cost"]
        for s in payload["stages"]:
            assert s["status"] == "ok" and s["findings"] == 0
            assert s["wall_seconds"] > 0
