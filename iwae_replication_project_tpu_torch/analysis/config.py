"""Lint configuration: the port's defaults and an optional
``[tool.iwaelint_torch]`` pyproject table (port of ``analysis/config.py``).

The defaults are the port's policy: the files of its serving control plane
and telemetry that the concurrency rules and the leak pass analyze. The
JAX package's ``[tool.iwaelint]`` table names the JAX package's files and
belongs to its linter; this module never reads it. A
``[tool.iwaelint_torch]`` table, where one exists, overrides the defaults
key by key.

The fields are those the rules read: the concurrency rules and the leak
pass (``concurrency_paths``, ``leak_paths``), and the torch counterparts
of the JAX linter's idiom rules (``hot_paths`` for ``host-sync``,
``entry_points`` and ``cache_owners`` for ``cache-setup``,
``import_shims`` and ``fragile_imports`` for ``fragile-import``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import tomllib

#: the pyproject table this linter reads
TABLE = "iwaelint_torch"

_PKG = "iwae_replication_project_tpu_torch"


def _default_paths() -> List[str]:
    return [_PKG]


def _default_hot_paths() -> List[str]:
    # the per-step and per-dispatch modules, where a host sync stalls the
    # captured graphs' queue (host-sync): the train step and epoch, the
    # ops and their kernel wrappers, the mesh, and the serving programs
    # the engines replay
    return [f"{_PKG}/training", f"{_PKG}/ops", f"{_PKG}/parallel",
            f"{_PKG}/serving/programs.py"]


def _default_entry_points() -> List[str]:
    # the entry points that load kernels, each setting the kernel build
    # directory through ops/_kernels.use_build_dir (cache-setup): the
    # staged driver (its CLI, the zoo and the facade run through
    # run_experiment), the serving CLI and the autotuner's CLI
    return [f"{_PKG}/experiment.py", f"{_PKG}/serving/cli.py",
            f"{_PKG}/ops/autotune.py"]


def _default_cache_owners() -> List[str]:
    # the one module that owns the build directory's state
    return [f"{_PKG}/ops/_kernels.py"]


def _default_import_shims() -> List[str]:
    # the modules allowed to import private or version-moving torch modules
    # (fragile-import): the kernel loader and launcher, the executable
    # store that reads the caching allocator's snapshot, the profiling
    # helpers' dispatch-mode tracer (torch.utils._python_dispatch), and the
    # program auditor's recorder (make_fx's proxy mode, a dispatch mode)
    return [f"{_PKG}/ops/_kernels.py", f"{_PKG}/utils/compile_cache.py",
            f"{_PKG}/utils/profiling.py",
            f"{_PKG}/analysis/audit/graphs.py"]


def _default_fragile_imports() -> List[str]:
    # torch modules that moved or are marked for removal across 2.x (any
    # private torch module is fragile as well, listed or not)
    return ["torch.distributed._tensor", "torch.cuda.amp",
            "torch.testing._internal", "torch.utils._pytree",
            "torch.ao.quantization.quantize_fx", "functorch"]


def _default_concurrency_paths() -> List[str]:
    # the files the concurrency rules (lock-order, unlocked-shared-state,
    # blocking-call-under-lock, swallowed-exception) analyze: the engine's
    # dispatcher/completion/scrape threads, the batcher, the tier's thread
    # fan (accept loop, connection readers, router callbacks, health
    # monitor), the registry, recorder and SLO windows every serving thread
    # reports to, the fault schedules, the executable store, and the port's
    # own threaded modules: the span sink, the dispatch profiler, the
    # metrics page's server thread and the fleet's controller
    return [f"{_PKG}/serving/engine.py",
            f"{_PKG}/serving/batcher.py",
            f"{_PKG}/serving/faults.py",
            f"{_PKG}/serving/frontend",
            f"{_PKG}/serving/fleet",
            f"{_PKG}/telemetry/registry.py",
            f"{_PKG}/telemetry/tracing.py",
            f"{_PKG}/telemetry/slo.py",
            f"{_PKG}/telemetry/spans.py",
            f"{_PKG}/telemetry/profiling.py",
            f"{_PKG}/telemetry/exporters.py",
            f"{_PKG}/utils/faults.py",
            f"{_PKG}/utils/compile_cache.py"]


def _default_leak_paths() -> List[str]:
    # the files the static leak pass (leaked-future / leaked-span /
    # leaked-pin, analysis/race/leaks.py) proves release shapes over: the
    # serving control plane that acquires futures, spans and store pins on
    # the request path, and the fleet that pins models per placement
    return [f"{_PKG}/serving/engine.py",
            f"{_PKG}/serving/batcher.py",
            f"{_PKG}/serving/sharded.py",
            f"{_PKG}/serving/frontend",
            f"{_PKG}/serving/fleet",
            f"{_PKG}/telemetry/tracing.py"]


@dataclasses.dataclass
class LintConfig:
    """Everything rule behavior can be steered by. Field names match the
    ``[tool.iwaelint_torch]`` TOML keys one-to-one."""

    #: default lint targets when the CLI gets no paths
    paths: List[str] = dataclasses.field(default_factory=_default_paths)
    #: substring patterns (root-relative posix) excluded from the walk
    exclude: List[str] = dataclasses.field(default_factory=list)
    #: run only these rules (empty = all registered)
    select: List[str] = dataclasses.field(default_factory=list)
    #: never run these rules
    disable: List[str] = dataclasses.field(default_factory=list)
    #: per-step / per-dispatch modules where host syncs are flagged
    hot_paths: List[str] = dataclasses.field(default_factory=_default_hot_paths)
    #: files that must set the kernel build directory (cache-setup rule)
    entry_points: List[str] = dataclasses.field(
        default_factory=_default_entry_points)
    #: files that own the kernel build directory's state
    cache_owners: List[str] = dataclasses.field(
        default_factory=_default_cache_owners)
    #: files allowed to import private or fragile torch modules
    import_shims: List[str] = dataclasses.field(
        default_factory=_default_import_shims)
    #: fragile module names (fragile-import rule)
    fragile_imports: List[str] = dataclasses.field(
        default_factory=_default_fragile_imports)
    #: files the lock-order / unlocked-shared-state rules analyze
    concurrency_paths: List[str] = dataclasses.field(
        default_factory=_default_concurrency_paths)
    #: files the static leak pass (leaked-future/span/pin) analyzes
    leak_paths: List[str] = dataclasses.field(
        default_factory=_default_leak_paths)
    #: repo root all relative paths above resolve against
    root: Optional[str] = None


def find_pyproject(start: str) -> Optional[str]:
    """Nearest pyproject.toml at or above `start` (a file or directory)."""
    d = os.path.abspath(start)
    if os.path.isfile(d):
        d = os.path.dirname(d)
    while True:
        cand = os.path.join(d, "pyproject.toml")
        if os.path.isfile(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def load_config(start: Optional[str] = None,
                pyproject: Optional[str] = None
                ) -> Tuple[LintConfig, Optional[str]]:
    """The defaults, with the nearest pyproject's ``[tool.iwaelint_torch]``
    table merged over them where it has one; ``root`` is that pyproject's
    directory. Returns ``(config, pyproject path or None)``: the path only
    when a table was read. Unknown keys raise: a typo'd policy knob must
    not silently revert to its default."""
    if pyproject is None:
        pyproject = find_pyproject(start or os.getcwd())
    cfg = LintConfig()
    if pyproject is None:
        return cfg, None
    with open(pyproject, "rb") as f:
        table = tomllib.load(f).get("tool", {}).get(TABLE)
    if table is None:
        cfg.root = os.path.dirname(os.path.abspath(pyproject))
        return cfg, None
    known = {f.name for f in dataclasses.fields(LintConfig)}
    unknown = set(table) - known
    if unknown:
        raise ValueError(
            f"unknown [tool.{TABLE}] key(s) in {pyproject}: "
            f"{sorted(unknown)}; known keys: {sorted(known)}")
    for key, value in table.items():
        setattr(cfg, key, value)
    if cfg.root is None:
        cfg.root = os.path.dirname(os.path.abspath(pyproject))
    return cfg, pyproject
