"""The torch counterparts of the JAX linter's idiom rules
(``analysis/rules/{host,dtype,imports,entrypoints,jit,prng}.py``) on
fixture sources that should and should not fire, beside JAX's rule on the
same fixture where the rule means the same in both packages; the port's
own package clean under every rule; and ``analysis/regress.py``
(``iwae-prof``) against JAX's on the committed benchmark artifacts.
"""

import copy
import json
import os
import subprocess
import sys
import textwrap

import pytest

from iwae_replication_project_tpu.analysis import LintConfig as JLintConfig
from iwae_replication_project_tpu.analysis import lint_paths as jlint_paths
from iwae_replication_project_tpu.analysis import regress as jregress
from iwae_replication_project_tpu_torch.analysis import (
    LintConfig,
    lint_paths,
    load_config,
)
from iwae_replication_project_tpu_torch.analysis import regress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "iwae_replication_project_tpu_torch"
IDIOM_RULES = ["cache-setup", "donated-after-call", "dtype-promotion",
               "fragile-import", "host-sync", "jit-in-loop", "key-reuse",
               "nonhashable-static"]


def _write(tmp_path, rel, src):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return path


def lint(tmp_path, src, rule, rel="pkg/hot/mod.py", **over):
    """The port's findings of `rule` on `src` at `rel`, as (rule, line)."""
    path = _write(tmp_path, rel, src)
    cfg = LintConfig(root=str(tmp_path), select=[rule], **over)
    return [(f.rule, f.line) for f in
            lint_paths([str(path)], cfg, root=str(tmp_path))]


def jlint(tmp_path, src, rule, rel="pkg/hot/mod.py", **over):
    path = _write(tmp_path, rel, src)
    cfg = JLintConfig(root=str(tmp_path), select=[rule], **over)
    return [(f.rule, f.line) for f in
            jlint_paths([str(path)], cfg, root=str(tmp_path))]


# --------------------------------------------------------------------------
# host-sync
# --------------------------------------------------------------------------

HOST_BAD = """
    import numpy as np
    import torch

    def step(x, loss):
        a = loss.item()
        b = np.asarray(x)
        c = x.cpu()
        d = x.tolist()
        e = x.numpy()
        f = float(torch.max(x))
        torch.cuda.synchronize()
        return a, b, c, d, e, f
"""

HOST_GOOD = """
    import torch

    def step(x, n):
        y = x.to("cpu", non_blocking=True)
        return float(n), int("3"), y.sum(dim=0), x.cpu(memory_format=None)
"""


class TestHostSync:
    def test_fires_on_each_sync_in_a_hot_path(self, tmp_path):
        got = lint(tmp_path, HOST_BAD, "host-sync", hot_paths=["pkg/hot"])
        assert [ln for _, ln in got] == list(range(6, 13))

    def test_silent_outside_hot_paths_and_on_async_copies(self, tmp_path):
        assert lint(tmp_path, HOST_BAD, "host-sync", rel="pkg/cold/m.py",
                    hot_paths=["pkg/hot"]) == []
        assert lint(tmp_path, HOST_GOOD, "host-sync",
                    hot_paths=["pkg/hot"]) == []

    def test_item_and_asarray_fire_as_in_jax(self, tmp_path):
        """The shapes both packages mean alike: ``.item()`` and
        ``np.asarray`` in a hot path."""
        src = """
            import numpy as np

            def step(x, loss):
                return loss.item(), np.asarray(x)
        """
        kw = dict(hot_paths=["pkg/hot"])
        assert lint(tmp_path, src, "host-sync", **kw) \
            == jlint(tmp_path, src, "host-sync", **kw) \
            == [("host-sync", 5), ("host-sync", 5)]


# --------------------------------------------------------------------------
# dtype-promotion
# --------------------------------------------------------------------------

DTYPE_BAD = """
    import numpy as np
    import torch

    a = torch.zeros(3, dtype=torch.float64)
    b = torch.ones(2).double()
    c = np.zeros(4, dtype=float)
    d = torch.tensor([1.0], dtype="float64")
    e = torch.from_numpy(np.random.randn(3))
    f = torch.from_numpy(np.ones(3).astype(np.float32).astype("float64"))
    torch.set_default_dtype(torch.float32)
"""

DTYPE_GOOD = """
    import numpy as np
    import torch

    a = torch.zeros(3, dtype=torch.float32)
    b = torch.from_numpy(np.random.randn(3).astype(np.float32))
    c = torch.from_numpy(np.zeros(4, dtype=np.float32))
    d = torch.ones(2).to(torch.bfloat16)
"""


class TestDtypePromotion:
    def test_fires_on_each_float64(self, tmp_path):
        got = lint(tmp_path, DTYPE_BAD, "dtype-promotion")
        assert sorted({ln for _, ln in got}) == [5, 6, 7, 8, 9, 10, 11]

    def test_silent_on_fp32_and_bf16(self, tmp_path):
        assert lint(tmp_path, DTYPE_GOOD, "dtype-promotion") == []

    def test_numpy_float64_and_dtype_float_fire_as_in_jax(self, tmp_path):
        src = """
            import numpy as np

            a = np.zeros(3, dtype=np.float64)
            b = np.ones(2, dtype=float)
            c = np.array([1.0], dtype="float64")
        """
        assert lint(tmp_path, src, "dtype-promotion") \
            == jlint(tmp_path, src, "dtype-promotion") \
            == [("dtype-promotion", 4), ("dtype-promotion", 5),
                ("dtype-promotion", 6)]


# --------------------------------------------------------------------------
# fragile-import
# --------------------------------------------------------------------------

class TestFragileImport:
    def test_private_and_listed_modules_fire(self, tmp_path):
        src = """
            import torch._dynamo
            from torch._C import _cuda_getCurrentRawStream
            from torch.utils import _pytree
            from torch.cuda.amp import autocast
            import functorch
        """
        got = lint(tmp_path, src, "fragile-import",
                   fragile_imports=["torch.cuda.amp", "functorch"],
                   import_shims=[])
        assert [ln for _, ln in got] == [2, 3, 4, 5, 6]

    def test_public_modules_and_the_shim_are_silent(self, tmp_path):
        src = """
            import torch
            import torch.nn.functional as F
            from torch.utils.checkpoint import checkpoint
            from torch.utils._python_dispatch import TorchDispatchMode
        """
        assert lint(tmp_path, src, "fragile-import",
                    import_shims=["pkg/hot/mod.py"]) == []
        assert lint(tmp_path, src, "fragile-import", import_shims=[]) \
            == [("fragile-import", 5)]


# --------------------------------------------------------------------------
# cache-setup
# --------------------------------------------------------------------------

class TestCacheSetup:
    def test_entry_point_must_set_the_build_dir(self, tmp_path):
        bad = "def main():\n    return 0\n"
        good = ("from pkg.ops import _kernels\n\ndef main():\n"
                "    _kernels.use_build_dir(None)\n")
        kw = dict(entry_points=["pkg/hot/mod.py"], cache_owners=[])
        assert lint(tmp_path, bad, "cache-setup", **kw) \
            == [("cache-setup", 1)]
        assert lint(tmp_path, good, "cache-setup", **kw) == []

    def test_only_the_owner_and_entry_points_set_it(self, tmp_path):
        src = """
            import os
            from pkg.ops import _kernels

            def f(d):
                _kernels.use_build_dir(d)
                os.environ["IWAE_COMPILE_CACHE"] = d
                os.environ.setdefault("IWAE_COMPILE_CACHE", d)
                _kernels._dir = d
                os.environ["OTHER"] = d
        """
        got = lint(tmp_path, src, "cache-setup", entry_points=[],
                   cache_owners=[])
        assert [ln for _, ln in got] == [6, 7, 8, 9]
        # the owner module sets it freely; so do the entry points
        assert lint(tmp_path, src, "cache-setup", entry_points=[],
                    cache_owners=["pkg/hot/mod.py"]) == []
        assert [ln for _, ln in lint(tmp_path, src, "cache-setup",
                                     entry_points=["pkg/hot/mod.py"],
                                     cache_owners=[])] == [7, 8, 9]


# --------------------------------------------------------------------------
# jit-in-loop, nonhashable-static, donated-after-call
# --------------------------------------------------------------------------

class TestJitInLoop:
    def test_builds_inside_loops_fire(self, tmp_path):
        src = """
            import torch
            from torch.utils.cpp_extension import load

            def f(fns, xs):
                for fn in fns:
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        fn()
                    c = torch.compile(fn)
                    lib = load(name="x", sources=["x.cu"])
                while xs:
                    @torch.compile
                    def h(v):
                        return v
                    xs.pop()
        """
        got = lint(tmp_path, src, "jit-in-loop")
        assert [ln for _, ln in got] == [7, 8, 10, 11, 13]

    def test_builds_outside_loops_are_silent(self, tmp_path):
        src = """
            import torch

            def f(fn, xs):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    fn()
                c = torch.compile(fn)
                for x in xs:
                    g.replay()
                    c(x)
        """
        assert lint(tmp_path, src, "jit-in-loop") == []


class TestNonHashableStatic:
    def test_unhashable_arguments_to_a_cached_function_fire(self, tmp_path):
        _write(tmp_path, "pkg/plans.py", """
            import functools

            @functools.lru_cache(maxsize=8)
            def tile(m, n):
                return m, n
        """)
        src = """
            import functools
            from pkg import plans
            from pkg.plans import tile

            @functools.cache
            def local(shape):
                return shape

            a = plans.tile([1, 2], 3)
            b = tile(1, n={3: 4})
            c = local({1, 2})
            d = local((1, 2))
            e = plans.tile(1, 2)
            f = len([1, 2])
        """
        got = lint(tmp_path, src, "nonhashable-static")
        assert [ln for _, ln in got] == [10, 11, 12]


class TestDonatedAfterCall:
    BAD = """
        import torch

        def serve(fn, x, batches):
            static = x.clone()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = fn(static)
            for b in batches:
                static = b
                g.replay()
            return out
    """
    GOOD = """
        import torch

        def serve(fn, x, batches):
            static = x.clone()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = fn(static)
            for b in batches:
                static.copy_(b)
                g.replay()
                result = out.clone()
            return result
    """

    def test_rebinding_a_static_input_fires(self, tmp_path):
        assert lint(tmp_path, self.BAD, "donated-after-call") \
            == [("donated-after-call", 10)]

    def test_copy_into_the_static_input_is_silent(self, tmp_path):
        assert lint(tmp_path, self.GOOD, "donated-after-call") == []


# --------------------------------------------------------------------------
# key-reuse
# --------------------------------------------------------------------------

class TestKeyReuse:
    def test_reseeding_with_a_used_seed_fires(self, tmp_path):
        src = """
            import torch

            def draws(seed, n):
                g = torch.Generator().manual_seed(seed)
                a = torch.randn(n, generator=g)
                h = torch.Generator().manual_seed(seed)
                b = torch.randn(n, generator=h)
                torch.manual_seed(0)
                c = torch.rand(n)
                torch.manual_seed(0)
                for _ in range(3):
                    g.manual_seed(7)
                return a, b, c
        """
        got = lint(tmp_path, src, "key-reuse")
        assert [ln for _, ln in got] == [7, 11, 13]

    def test_fresh_seeds_are_silent(self, tmp_path):
        src = """
            import torch

            def draws(seeds, n, seed):
                out = []
                for s in seeds:
                    g = torch.Generator().manual_seed(s)
                    out.append(torch.randn(n, generator=g))
                g2 = torch.Generator().manual_seed(seed + 1)
                if n:
                    torch.manual_seed(3)
                else:
                    torch.manual_seed(3)
                seed = seed * 2
                g3 = torch.Generator().manual_seed(seed)
                g4 = torch.Generator().manual_seed(hash((seed, 1)))
                return out, g2, g3, g4
        """
        assert lint(tmp_path, src, "key-reuse") == []


# --------------------------------------------------------------------------
# the port's own package and the CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rule", IDIOM_RULES)
def test_the_ports_package_is_clean_under_each_rule(rule):
    cfg, _ = load_config(REPO)
    cfg.select = [rule]
    assert lint_paths(cfg.paths, cfg, root=REPO) == []


def test_defaults_name_the_ports_files_and_they_exist():
    cfg = LintConfig()
    for p in (cfg.hot_paths + cfg.entry_points + cfg.cache_owners
              + cfg.import_shims):
        assert p.startswith(PKG + "/"), p
        assert os.path.exists(os.path.join(REPO, p)), p
    assert f"{PKG}/serving/programs.py" in cfg.hot_paths


def test_cli_selects_the_new_rules():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", f"{PKG}.analysis", "--select",
         ",".join(IDIOM_RULES)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0 and "clean" in r.stdout, r.stdout + r.stderr


# --------------------------------------------------------------------------
# iwae-prof
# --------------------------------------------------------------------------

def _bench_paths():
    res = os.path.join(REPO, "results")
    return sorted(os.path.join(res, f) for f in os.listdir(res)
                  if f.endswith("_bench.json"))


def _slower(doc, factor):
    """`doc` with every lower-better numeric leaf scaled by `factor`."""
    out = copy.deepcopy(doc)

    def walk(node, key=""):
        if isinstance(node, dict):
            for k, v in node.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool) \
                        and regress.direction_for(k) < 0:
                    node[k] = v * factor
                elif isinstance(v, list) and v and all(
                        isinstance(e, (int, float))
                        and not isinstance(e, bool) for e in v) \
                        and regress.direction_for(k) < 0:
                    node[k] = [e * factor for e in v]
                else:
                    walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v, key)

    walk(out)
    return out


def test_regress_has_no_jax_import():
    src = open(regress.__file__).read()
    assert "import jax" not in src and "iwae_replication_project_tpu." \
        not in src


@pytest.mark.parametrize("argv", [
    ["--diff", "results/perf_baseline.json", "*_bench"],
    ["--collect", "*_bench"],
])
def test_regress_equals_jaxs_on_the_committed_artifacts(argv, tmp_path,
                                                        capsys):
    """The same command through both packages: the same exit code and the
    same JSON document."""
    args = []
    for a in argv:
        args += _bench_paths() if a == "*_bench" else [
            a if a.startswith("--") else os.path.join(REPO, a)]
    outs = []
    for mod in (regress, jregress):
        rc = mod.main(args + ["--json"])
        outs.append((rc, json.loads(capsys.readouterr().out)))
    assert outs[0] == outs[1]
    assert outs[0][0] == 0 and outs[0][1]["ok"]


@pytest.mark.parametrize("factor", [1.5, 0.5])
def test_regress_findings_equal_jaxs_on_a_shifted_pair(factor, tmp_path):
    """Each committed artifact against a copy with its lower-better
    metrics scaled: regressions (1.5x) and improvements (0.5x), the same
    findings and statistics from both packages."""
    base = regress._load_side([os.path.join(REPO, "results",
                                            "perf_baseline.json")])
    shifted = {k: _slower(v, factor) for k, v in base.items()}
    got = regress.diff_bundles(base, shifted)
    want = jregress.diff_bundles(base, shifted)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    findings, stats = got
    assert all(f["kind"] == "perf/regression" for f in findings)
    if factor > 1:
        assert findings
    else:
        assert any(s.get("improvements")
                   for s in stats["per_artifact"].values())


def test_regress_cli_runs_as_a_module(tmp_path):
    old = tmp_path / "old.json"
    new = tmp_path / "new.json"
    old.write_text(json.dumps({"step_seconds": [1.0, 1.01, 0.99, 1.0, 1.02]}))
    new.write_text(json.dumps({"step_seconds": [2.0, 2.01, 1.99, 2.0, 2.02]}))
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", f"{PKG}.analysis.regress",
                        "--diff", str(old), str(new)], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "REGRESSION" in r.stdout, r.stdout
