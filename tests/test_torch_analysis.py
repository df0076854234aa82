"""The port's lint framework and concurrency rules (``analysis/``) against
the JAX package's: the registry, the suppression grammar (letter for letter
JAX's) with bare and useless suppressions, the config defaults that name
only the port's files and never read ``[tool.iwaelint]``, the four
concurrency rules on fixture sources (the same findings by rule, line and
column as JAX's analyzer on the same text), the port's own
``concurrency_paths`` and ``leak_paths`` clean, and the CLI's exit
contract."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import iwae_replication_project_tpu.analysis as janalysis
from iwae_replication_project_tpu.analysis import core as jcore
from iwae_replication_project_tpu_torch.analysis import (
    BARE_SUPPRESSION,
    USELESS_SUPPRESSION,
    LintConfig,
    all_rules,
    lint_paths,
    load_config,
)
from iwae_replication_project_tpu_torch.analysis import config as tconfig
from iwae_replication_project_tpu_torch.analysis import core as tcore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = "iwae_replication_project_tpu_torch"

CONCURRENCY_RULES = ["blocking-call-under-lock", "lock-order",
                     "swallowed-exception", "unlocked-shared-state"]
LEAK_RULES = ["leaked-future", "leaked-pin", "leaked-span"]
#: the torch counterparts of the JAX linter's idiom rules
#: (tests/test_torch_lint_rules.py)
IDIOM_RULES = ["cache-setup", "donated-after-call", "dtype-promotion",
               "fragile-import", "host-sync", "jit-in-loop", "key-reuse",
               "nonhashable-static"]


def lint_src(tmp_path, src, rel="conc/mod.py", **config_over):
    config_over.setdefault("concurrency_paths", ["conc"])
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    cfg = LintConfig(root=str(tmp_path), **config_over)
    return lint_paths([str(path)], cfg, root=str(tmp_path))


def rules_of(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# the framework and its config
# ---------------------------------------------------------------------------

class TestFramework:
    def test_the_ported_rules_are_registered(self):
        assert sorted(all_rules()) == sorted(CONCURRENCY_RULES + LEAK_RULES
                                             + IDIOM_RULES)
        # JAX's registry, rule for rule; the concurrency rules and the
        # leak pass summary for summary (the idiom rules say what they
        # mean in PyTorch instead)
        jrules = jcore.all_rules()
        assert sorted(jrules) == sorted(all_rules())
        for name in CONCURRENCY_RULES + LEAK_RULES:
            assert all_rules()[name].summary == jrules[name].summary, name

    def test_unknown_rule_in_config_raises(self, tmp_path):
        with pytest.raises(ValueError, match="unknown rule"):
            lint_src(tmp_path, "x = 1\n", select=["no-such-rule"])

    def test_syntax_error_is_a_finding(self, tmp_path):
        assert rules_of(lint_src(tmp_path, "def f(:\n")) == ["parse-error"]

    def test_defaults_name_only_the_port_files_and_they_exist(self):
        cfg = LintConfig()
        assert cfg.paths == [PORT_PKG]
        for p in cfg.concurrency_paths + cfg.leak_paths:
            assert p.startswith(PORT_PKG + "/"), p
            assert os.path.exists(os.path.join(REPO, p)), p
        # the JAX policy's counterparts (its pyproject table), plus the
        # port's threaded modules
        jcfg, _ = janalysis.load_config(REPO)
        ported = {p.replace("iwae_replication_project_tpu/", PORT_PKG + "/")
                  for p in jcfg.concurrency_paths}
        assert ported <= set(cfg.concurrency_paths)
        assert set(cfg.concurrency_paths) - ported == {
            f"{PORT_PKG}/serving/fleet", f"{PORT_PKG}/telemetry/spans.py",
            f"{PORT_PKG}/telemetry/profiling.py",
            f"{PORT_PKG}/telemetry/exporters.py"}
        assert {p.replace("iwae_replication_project_tpu/", PORT_PKG + "/")
                for p in jcfg.leak_paths} == set(cfg.leak_paths)

    def test_repo_pyproject_is_not_read(self):
        # the repo's pyproject holds [tool.iwaelint] (the JAX linter's
        # policy) and no [tool.iwaelint_torch]: the defaults apply
        cfg, src = load_config(REPO)
        assert src is None and cfg.root == REPO
        assert cfg == LintConfig(root=REPO)

    def test_iwaelint_torch_table_overrides_and_iwaelint_is_ignored(
            self, tmp_path):
        (tmp_path / "pyproject.toml").write_text(textwrap.dedent("""
            [tool.iwaelint]
            paths = ["jax_only"]
            hot_paths = ["x"]

            [tool.iwaelint_torch]
            paths = ["mine"]
            concurrency_paths = ["mine/conc"]
        """))
        cfg, src = load_config(str(tmp_path))
        assert src == str(tmp_path / "pyproject.toml")
        assert cfg.paths == ["mine"]
        assert cfg.concurrency_paths == ["mine/conc"]
        assert cfg.leak_paths == LintConfig().leak_paths
        assert cfg.root == str(tmp_path)

    def test_unknown_table_key_raises(self, tmp_path):
        (tmp_path / "pyproject.toml").write_text(
            "[tool.iwaelint_torch]\nno_such_key = ['x']\n")
        with pytest.raises(ValueError, match="unknown .tool.iwaelint_torch."):
            load_config(str(tmp_path))

    def test_config_fields_are_a_subset_of_jaxs(self):
        import dataclasses
        mine = {f.name for f in dataclasses.fields(tconfig.LintConfig)}
        theirs = {f.name for f in dataclasses.fields(janalysis.LintConfig)}
        assert mine <= theirs


# ---------------------------------------------------------------------------
# suppressions (the JAX grammar, on the concurrency rules)
# ---------------------------------------------------------------------------

SWALLOW = """
    class Conn:
        def tick(self):
            try:
                self.poll()
            except Exception:  # MARK
                pass
"""

LOCK_ORDER_AND_SWALLOW = """
    import threading

    class Pipeline:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def produce(self):
            with self._a:
                with self._b:
                    pass

        def consume(self):
            with self._b:
                with self._a:  # MARK
                    pass

        def tick(self):
            try:
                self.poll()
            except Exception:
                pass
"""


def _mark(src, comment):
    return src.replace("# MARK", comment)


class TestSuppression:
    def test_unsuppressed_fixture_fires(self, tmp_path):
        assert rules_of(lint_src(tmp_path, _mark(SWALLOW, ""))) == \
            ["swallowed-exception"]

    def test_justified_line_suppression_silences(self, tmp_path):
        src = _mark(SWALLOW, "# iwaelint: disable=swallowed-exception -- "
                             "best-effort poll, the next tick retries")
        assert lint_src(tmp_path, src) == []

    def test_bare_suppression_is_its_own_finding(self, tmp_path):
        src = _mark(SWALLOW, "# iwaelint: disable=swallowed-exception")
        assert rules_of(lint_src(tmp_path, src)) == [BARE_SUPPRESSION]

    def test_file_scope_suppression(self, tmp_path):
        src = ("# iwaelint: disable-file=swallowed-exception -- a probe "
               "module\n" + textwrap.dedent(_mark(SWALLOW, "")))
        assert lint_src(tmp_path, src) == []

    def test_suppression_is_per_rule(self, tmp_path):
        # suppressing an unrelated rule silences nothing (and is useless)
        src = _mark(SWALLOW, "# iwaelint: disable=lock-order -- wrong rule")
        assert sorted(rules_of(lint_src(tmp_path, src))) == \
            ["swallowed-exception", USELESS_SUPPRESSION]

    def test_grammar_is_jaxs_letter_for_letter(self):
        comments = [
            "x = 1  # iwaelint: disable=lock-order -- why",
            "x = 1  # iwaelint:disable=a,b--why",
            "x = 1  # iwaelint: disable = all -- because",
            "# iwaelint: disable-file=leaked-span -- file wide",
            "x = 1  # iwaelint: disable=lock-order",
            "x = 1  # iwaelint: disable=",
            "x = 1  # iwaelint enable=lock-order -- not the grammar",
            '"""# iwaelint: disable=lock-order -- inside a string"""',
        ]
        src = "\n".join(comments) + "\n"
        mine = [vars(s) for s in tcore.parse_suppressions(src)]
        theirs = [vars(s) for s in jcore.parse_suppressions(src)]
        assert mine == theirs
        assert [s["line"] for s in mine] == [1, 2, 3, 4, 5]


class TestUselessSuppression:
    def test_fires_when_the_rule_does_not_fire(self, tmp_path):
        src = """
            def fine(x):
                return x + 1  # iwaelint: disable=swallowed-exception -- leftover from a refactor
        """
        assert rules_of(lint_src(tmp_path, src)) == [USELESS_SUPPRESSION]

    def test_mixed_tokens_flag_only_the_dead_one(self, tmp_path):
        src = _mark(SWALLOW, "# iwaelint: disable=swallowed-exception,"
                             "lock-order -- the poll is best-effort")
        (f,) = lint_src(tmp_path, src)
        assert f.rule == USELESS_SUPPRESSION
        assert "lock-order" in f.message

    def test_stale_file_scope_suppression_fires(self, tmp_path):
        src = ("# iwaelint: disable-file=lock-order -- nothing nested "
               "left here\nx = 1\n")
        got = lint_src(tmp_path, src)
        assert rules_of(got) == [USELESS_SUPPRESSION]
        assert "file" in got[0].message

    def test_not_judged_for_unselected_rules(self, tmp_path):
        src = """
            def fine(x):
                return x + 1  # iwaelint: disable=swallowed-exception -- judged only when the rule runs
        """
        assert lint_src(tmp_path, src, select=["lock-order"]) == []

    def test_unknown_rule_token_fires_even_under_select(self, tmp_path):
        # a rule no registry holds: the port's files may not carry a
        # suppression no port rule can make live
        src = """
            def fine(x):
                return x + 1  # iwaelint: disable=no-such-rule -- a typo
        """
        got = lint_src(tmp_path, src, select=["lock-order"])
        assert rules_of(got) == [USELESS_SUPPRESSION]
        assert "unknown rule 'no-such-rule'" in got[0].message

    def test_useless_suppression_is_not_suppressible(self, tmp_path):
        src = """
            def fine(x):
                return x + 1  # iwaelint: disable=lock-order,useless-suppression -- silencing the meta-rule
        """
        assert USELESS_SUPPRESSION in rules_of(lint_src(tmp_path, src))

    def test_two_rules_on_one_fixture(self, tmp_path):
        src = _mark(LOCK_ORDER_AND_SWALLOW, "")
        assert sorted(rules_of(lint_src(tmp_path, src))) == \
            ["lock-order", "swallowed-exception"]


# ---------------------------------------------------------------------------
# the concurrency rules on fixture sources, against JAX's analyzer
# ---------------------------------------------------------------------------

BAD_LOCK_ORDER = """
    import threading

    class Pipeline:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()
            self.items = []

        def produce(self):
            with self._a:
                with self._b:
                    self.items.append(1)

        def consume(self):
            with self._b:
                with self._a:
                    return self.items.pop()
"""

CONSISTENT_ORDER = BAD_LOCK_ORDER.replace(
    "with self._b:\n                with self._a:",
    "with self._a:\n                with self._b:")

BAD_INDIRECT_ORDER = """
    import threading

    class Engine:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def outer(self):
            with self._a:
                self.inner()

        def inner(self):
            with self._b:
                pass

        def reverse(self):
            with self._b:
                with self._a:
                    pass
"""

CLEAN_CONDITION_ALIAS = """
    import threading

    class E:
        def __init__(self):
            self._lock = threading.Lock()
            self._cv = threading.Condition(self._lock)

        def f(self):
            with self._cv:
                with self._lock:
                    pass
"""

BAD_THREE_CYCLE = """
    import threading

    class Trio:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()
            self._c = threading.Lock()

        def ab(self):
            with self._a:
                with self._b:
                    pass

        def bc(self):
            with self._b:
                with self._c:
                    pass

        def ca(self):
            with self._c:
                with self._a:
                    pass
"""

BAD_UNLOCKED_STATE = """
    import threading

    class Window:
        def __init__(self):
            self._cv = threading.Condition()
            self._open = 0

        def acquire(self):
            with self._cv:
                self._open += 1

        def force(self):
            self._open += 1
"""

BAD_SWALLOW = """
    class Conn:
        def write(self, data):
            span = self.tracer.start_span("write")
            try:
                self.sock.sendall(data)
            except OSError:
                self.dead = True
            span.finish()

        def tick(self):
            try:
                self.poll()
            except Exception:
                pass
"""

EXEMPT_TEARDOWN_SWALLOW = """
    class Conn:
        def close(self):
            try:
                self.sock.shutdown(2)
            except OSError:
                pass
            self.sock.close()

        def write(self, data):
            try:
                self.sock.sendall(data)
            except OSError:
                self.dead = True
"""

CLEAN_SWALLOW = """
    class Conn:
        def write(self, data):
            try:
                self.sock.sendall(data)
            except OSError as e:
                self.complete(exc=e)

        def read(self):
            try:
                return self.sock.recv(1)
            except OSError:
                return None

        def serve(self):
            while True:
                try:
                    self.step()
                except OSError:
                    break
                except ValueError:
                    continue

        def probe(self):
            try:
                self.step()
            except Exception:
                raise
"""

BAD_BLOCKING = """
    import queue
    import threading
    import time

    class Stage:
        def __init__(self):
            self._lock = threading.Lock()
            self._stop = threading.Event()
            self._queue = queue.Queue()

        def wait_result(self, fut):
            with self._lock:
                return fut.result()

        def nap(self):
            with self._lock:
                time.sleep(0.1)

        def take(self):
            with self._lock:
                return self._queue.get()

        def reap(self, t):
            with self._lock:
                t.join()

        def park(self):
            with self._lock:
                self._stop.wait()

        def send(self, sock, b):
            with self._lock:
                sock.sendall(b)

        def outer(self):
            with self._lock:
                self.inner()

        def inner(self):
            time.sleep(1)
"""

CLEAN_BLOCKING = """
    import queue
    import threading

    class Stage:
        def __init__(self):
            self._lock = threading.Lock()
            self._cv = threading.Condition(self._lock)
            self._queue = queue.Queue()

        def bounded(self, fut):
            with self._lock:
                fut_done = fut.done()
                got = self._queue.get(timeout=1.0)
                more = self._queue.get(block=False)
                name = ",".join(["a", "b"])
            return fut_done, got, more, name

        def waits_on_its_condition(self):
            with self._cv:
                self._cv.wait()

        def outside(self, fut):
            with self._lock:
                snapshot = 1
            return fut.result(), snapshot
"""

SUPPRESSED_SWALLOW = """
    class Conn:
        def tick(self):
            try:
                self.poll()
            except Exception:  # iwaelint: disable=swallowed-exception -- best-effort poll: the caller's next tick retries, and there is no future/span to complete
                pass
"""

ESCAPING_NEVER_GUARDED = """
    import threading

    class Worker:
        def __init__(self):
            self.n = 0

        def start(self):
            self.t = threading.Thread(target=self._loop)
            self.t.start()

        def _loop(self):
            self.n = self.n + 1

        def read(self):
            return self.n
"""

#: fixture -> the rules it fires (in location order)
CASES = {
    "lock_order_inversion": (BAD_LOCK_ORDER, ["lock-order"]),
    "consistent_order": (CONSISTENT_ORDER, []),
    "indirect_inversion": (BAD_INDIRECT_ORDER, ["lock-order"]),
    "condition_alias": (CLEAN_CONDITION_ALIAS, []),
    "three_lock_cycle": (BAD_THREE_CYCLE, ["lock-order"] * 3),
    "unlocked_state": (BAD_UNLOCKED_STATE, ["unlocked-shared-state"]),
    "escaping_never_guarded": (ESCAPING_NEVER_GUARDED,
                               ["unlocked-shared-state"]),
    "swallow": (BAD_SWALLOW, ["swallowed-exception"] * 2),
    "teardown_swallow_exempt": (EXEMPT_TEARDOWN_SWALLOW, []),
    "clean_swallow": (CLEAN_SWALLOW, []),
    "suppressed_swallow": (SUPPRESSED_SWALLOW, []),
    "blocking_under_lock": (BAD_BLOCKING,
                            ["blocking-call-under-lock"] * 7),
    "clean_blocking": (CLEAN_BLOCKING, []),
}


def _jax_lint(tmp_path, src, rel="conc/mod.py", **config_over):
    path = tmp_path / rel
    cfg = janalysis.LintConfig(root=str(tmp_path), **config_over)
    return janalysis.lint_paths([str(path)], cfg, root=str(tmp_path))


class TestConcurrencyRules:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_fixture_findings_equal_jaxs(self, case, tmp_path):
        src, want = CASES[case]
        got = lint_src(tmp_path, src, select=CONCURRENCY_RULES)
        assert rules_of(got) == want
        theirs = _jax_lint(tmp_path, src, concurrency_paths=["conc"],
                           select=CONCURRENCY_RULES)
        assert [(f.rule, f.line, f.col) for f in got] == \
            [(f.rule, f.line, f.col) for f in theirs]
        assert [f.message for f in got] == [f.message for f in theirs]

    def test_messages_name_the_hazard(self, tmp_path):
        got = lint_src(tmp_path, BAD_THREE_CYCLE)
        assert "cyclic lock order" in got[0].message
        got = lint_src(tmp_path, BAD_UNLOCKED_STATE)
        assert "force" in got[0].message
        got = lint_src(tmp_path, BAD_SWALLOW)
        assert "swallows the error" in got[0].message
        whats = " ".join(f.message for f in lint_src(tmp_path, BAD_BLOCKING))
        for what in ("future .result()", "time.sleep()", "queue .get()",
                     "thread .join()", "event .wait()", "socket .sendall()",
                     "calls 'inner' while holding lock"):
            assert what in whats, what

    def test_outside_concurrency_paths_is_silent(self, tmp_path):
        assert lint_src(tmp_path, BAD_LOCK_ORDER, rel="other/m.py") == []
        assert lint_src(tmp_path, BAD_SWALLOW, rel="other/m.py") == []
        assert lint_src(tmp_path, BAD_BLOCKING, rel="other/m.py") == []


class TestThePortsOwnFiles:
    def test_concurrency_and_leak_paths_are_clean(self):
        """The port's thread fan passes its own checker and leak pass (its
        deliberate drops and frame serializers carry justified suppressions
        in place)."""
        cfg, _ = load_config(REPO)
        paths = sorted(set(cfg.concurrency_paths + cfg.leak_paths))
        assert lint_paths(paths, cfg, root=REPO) == []

    def test_the_whole_package_is_clean(self):
        cfg, _ = load_config(REPO)
        assert lint_paths(cfg.paths, cfg, root=REPO) == []


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

class TestCli:
    def _run(self, *args, cwd=REPO):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        return subprocess.run(
            [sys.executable, "-m", f"{PORT_PKG}.analysis", *args],
            cwd=cwd, env=env, capture_output=True, text=True, timeout=300)

    def test_bad_file_exits_1_with_json(self, tmp_path):
        rel = f"{PORT_PKG}/serving/engine.py"
        bad = tmp_path / rel
        bad.parent.mkdir(parents=True)
        bad.write_text(textwrap.dedent(BAD_LOCK_ORDER))
        r = self._run("--no-config", "--format", "json", rel, cwd=tmp_path)
        assert r.returncode == 1, r.stderr
        payload = json.loads(r.stdout)
        assert payload["total"] == 1
        assert payload["counts"] == {"lock-order": 1}

    def test_select_and_ignore(self, tmp_path):
        rel = f"{PORT_PKG}/serving/engine.py"
        bad = tmp_path / rel
        bad.parent.mkdir(parents=True)
        bad.write_text(textwrap.dedent(BAD_LOCK_ORDER))
        r = self._run("--no-config", "--ignore", "lock-order", rel,
                      cwd=tmp_path)
        assert r.returncode == 0 and "clean" in r.stdout
        r = self._run("--no-config", "--select", "nope", rel, cwd=tmp_path)
        assert r.returncode == 2 and "unknown rule" in r.stderr

    def test_unknown_path_exits_2(self):
        r = self._run("definitely/not/a/path.py")
        assert r.returncode == 2
        assert "error" in r.stderr

    def test_list_rules(self):
        r = self._run("--list-rules")
        assert r.returncode == 0
        for rule in CONCURRENCY_RULES + LEAK_RULES + [BARE_SUPPRESSION,
                                                     USELESS_SUPPRESSION]:
            assert rule in r.stdout

    def test_self_lint_clean(self):
        """The configured run over the port's package exits 0."""
        r = self._run()
        assert r.returncode == 0, r.stdout + r.stderr
        assert "clean" in r.stdout
