"""Rule ``cache-setup``: where the kernels' build directory is set (port of
``analysis/rules/entrypoints.py``).

What it means in PyTorch: JAX's warm path is its persistent compile
cache, which every entry point must enable through one helper. The
port's is the directory its hand-written kernels are built into and
loaded from: ``ops/_kernels.use_build_dir`` (the driver's
``--compile-cache-dir``, else ``$IWAE_COMPILE_CACHE``, else the package's
``_build/``). Two obligations:

1. every configured entry point (the config's ``entry_points``) calls
   ``use_build_dir`` before a kernel can load, so the process says which
   directory it builds into instead of taking whatever the first kernel
   call resolves;
2. no module but the owner (``cache_owners``, ``ops/_kernels.py``) and the
   entry points sets it: no other ``use_build_dir`` call, and no write of
   ``IWAE_COMPILE_CACHE`` into ``os.environ`` or of ``_kernels._dir``. A
   second place that sets the directory is how two processes of one run
   end up building the same library twice.
"""

from __future__ import annotations

import ast
from typing import Iterator

from iwae_replication_project_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    register,
)

#: the environment variable ``ops/_kernels`` reads
CACHE_ENV = "IWAE_COMPILE_CACHE"


def _sets_env(node: ast.AST) -> bool:
    """``os.environ[CACHE_ENV] = ...``, ``os.environ.setdefault(CACHE_ENV,
    ...)`` or ``os.environ.update({CACHE_ENV: ...})``."""
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        return any(isinstance(t, ast.Subscript)
                   and Rule.dotted(t.value).endswith("environ")
                   and isinstance(t.slice, ast.Constant)
                   and t.slice.value == CACHE_ENV for t in targets)
    if isinstance(node, ast.Call):
        name = Rule.call_name(node)
        if not name.endswith("environ.setdefault") and \
                not name.endswith("environ.update"):
            return False
        for a in node.args:
            if isinstance(a, ast.Constant) and a.value == CACHE_ENV:
                return True
            if isinstance(a, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == CACHE_ENV
                    for k in a.keys):
                return True
    return False


def _sets_dir_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Assign) and any(
        isinstance(t, ast.Attribute) and t.attr == "_dir"
        and Rule.terminal(Rule.dotted(t.value)) == "_kernels"
        for t in node.targets)


@register
class CacheSetupRule(Rule):
    name = "cache-setup"
    summary = ("entry point never calls ops/_kernels.use_build_dir(), or the "
               "kernel build directory set outside the entry points and "
               "ops/_kernels.py")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        is_entry = ctx.rel_path in ctx.config.entry_points
        if is_entry and not any(
                isinstance(n, ast.Call)
                and Rule.terminal(Rule.call_name(n)) == "use_build_dir"
                for n in ast.walk(ctx.tree)):
            yield Finding(
                path=ctx.rel_path, line=1, col=0, rule=self.name,
                message="entry point never calls ops/_kernels.use_build_dir()"
                        " — its kernels build into whatever directory the "
                        "first launch resolves")
        if ctx.rel_path in ctx.config.cache_owners:
            return
        for node in ast.walk(ctx.tree):
            if _sets_env(node) or _sets_dir_attr(node):
                yield ctx.finding(
                    self.name, node,
                    f"the kernel build directory ({CACHE_ENV} / "
                    f"_kernels._dir) set by hand — ops/_kernels.py owns it "
                    f"and the entry points set it through use_build_dir")
            elif not is_entry and isinstance(node, ast.Call) and \
                    Rule.terminal(Rule.call_name(node)) == "use_build_dir":
                yield ctx.finding(
                    self.name, node,
                    "use_build_dir() outside an entry point — only the "
                    "configured entry points set the build directory")
