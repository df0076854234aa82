"""Program-building discipline: graph static inputs, builds in loops,
unhashable cache keys (port of ``analysis/rules/jit.py``).

What each JAX rule means in PyTorch:

* ``donated-after-call`` — JAX's donated buffer is dead once the call is
  issued. The port's counterpart is a captured CUDA graph's static input:
  the graph reads the memory the tensor had at capture time, so feeding a
  replay means ``static.copy_(new)``. Rebinding the name
  (``static = new``) after the capture leaves the graph reading the old
  buffer while the code reads the new one: a silent stale replay. The rule
  flags, in one scope, a rebinding of a name read inside a ``with
  torch.cuda.graph(g)`` block (or the port's ``capture_graph``) when
  ``g.replay()`` follows the capture.
* ``jit-in-loop`` — building a program per iteration. In PyTorch that is a
  CUDA-graph capture (``torch.cuda.graph``, ``torch.cuda.CUDAGraph()``,
  ``make_graphed_callables``, the port's ``capture_graph``),
  ``torch.compile`` / ``torch.jit.script``/``trace``, or a
  ``torch.utils.cpp_extension`` ``load``/``load_inline`` inside a loop:
  each re-captures, re-compiles or re-builds where the executable store
  (``utils/compile_cache.py``) and ``ops/_kernels`` build once and reuse.
* ``nonhashable-static`` — JAX raises on an unhashable static argument.
  The port's counterpart is a ``functools.lru_cache``d function (the tile
  plans ``ops/row_invariant.dense_tile``, ``ops/hot_loop.library_limits``,
  ``ops/_kernels.entry``): a list, dict or set argument raises
  ``TypeError: unhashable type`` at call time. Calls are resolved within
  the file and through ``from``/``import`` of the package's modules.
"""

from __future__ import annotations

import ast
import os
from typing import Iterator, List, Optional, Set

from iwae_replication_project_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    register,
)

#: calls that capture a CUDA graph or build a program
_CAPTURES = {"torch.cuda.graph", "torch.cuda.CUDAGraph",
             "torch.cuda.make_graphed_callables", "capture_graph"}
_COMPILES = {"torch.compile", "torch.jit.script", "torch.jit.trace"}
_EXT_LOADS = {"load", "load_inline"}
_CACHE_DECORATORS = {"functools.lru_cache", "lru_cache", "functools.cache",
                     "cache"}
_NONHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                ast.SetComp, ast.GeneratorExp)


def _ext_aliases(tree: ast.Module) -> Set[str]:
    """Local names of ``torch.utils.cpp_extension`` and of its loaders."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if node.module == "torch.utils.cpp_extension":
                out |= {a.asname or a.name for a in node.names
                        if a.name in _EXT_LOADS}
            elif node.module == "torch.utils":
                out |= {f"{a.asname or a.name}.{fn}" for a in node.names
                        if a.name == "cpp_extension" for fn in _EXT_LOADS}
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.utils.cpp_extension" and a.asname:
                    out |= {f"{a.asname}.{fn}" for fn in _EXT_LOADS}
    out |= {f"torch.utils.cpp_extension.{fn}" for fn in _EXT_LOADS}
    return out


def _builds(name: str, ext: Set[str]) -> bool:
    return name in _COMPILES or name in ext or name in _CAPTURES \
        or Rule.terminal(name) == "capture_graph"


@register
class JitInLoopRule(Rule):
    name = "jit-in-loop"
    summary = ("CUDA-graph capture, torch.compile or a cpp_extension load "
               "inside a loop — builds per iteration instead of once")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        yield from self._visit(ctx, ctx.tree, 0, _ext_aliases(ctx.tree))

    def _visit(self, ctx: FileContext, node: ast.AST, loop_depth: int,
               ext: Set[str]) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # decorators evaluate at def time: a def inside a loop
                # re-runs its torch.compile decorator every iteration
                if loop_depth:
                    for dec in child.decorator_list:
                        d = dec.func if isinstance(dec, ast.Call) else dec
                        if Rule.dotted(d) in _COMPILES:
                            yield ctx.finding(
                                self.name, dec,
                                "torch.compile-decorated def inside a loop "
                                "re-compiles every iteration")
                yield from self._visit(ctx, child, 0, ext)
                continue
            depth = loop_depth + (1 if isinstance(
                child, (ast.For, ast.AsyncFor, ast.While)) else 0)
            if loop_depth and isinstance(child, ast.Call):
                name = Rule.call_name(child)
                if _builds(name, ext):
                    yield ctx.finding(
                        self.name, child,
                        f"'{name}' inside a loop — the graph, program or "
                        f"library is built every iteration; build once "
                        f"outside (the executable store, ops/_kernels)")
            yield from self._visit(ctx, child, depth, ext)


# --------------------------------------------------------------------------
# nonhashable-static
# --------------------------------------------------------------------------

def _cached_functions(tree: ast.Module) -> Set[str]:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                if Rule.dotted(d) in _CACHE_DECORATORS:
                    out.add(node.name)
    return out


def _module_file(root: str, module: str) -> Optional[str]:
    base = os.path.join(root, *module.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.isfile(cand):
            return cand
    return None


def _cached_in_module(root: str, module: str) -> Set[str]:
    """The lru_cache'd functions of the package module `module` (none for
    a module outside `root` or one that does not parse)."""
    path = _module_file(root, module)
    if path is None:
        return set()
    try:
        with open(path, encoding="utf-8") as f:
            return _cached_functions(ast.parse(f.read()))
    except (OSError, SyntaxError):
        return set()


def _cached_names(ctx: FileContext) -> Set[str]:
    """Call names (``f`` or ``alias.f``) that reach an lru_cached function:
    this file's, and the package modules' it imports."""
    names = _cached_functions(ctx.tree)
    root = ctx.config.root or os.getcwd()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            cached = _cached_in_module(root, node.module)
            for a in node.names:
                if a.name in cached:
                    names.add(a.asname or a.name)
                else:  # from pkg import module [as alias]
                    sub = _cached_in_module(root, f"{node.module}.{a.name}")
                    names |= {f"{a.asname or a.name}.{f}" for f in sub}
        elif isinstance(node, ast.Import):
            for a in node.names:
                names |= {f"{a.asname or a.name}.{f}"
                          for f in _cached_in_module(root, a.name)}
    return names


@register
class NonHashableStaticRule(Rule):
    name = "nonhashable-static"
    summary = ("list/dict/set passed to an lru_cache'd function — raises "
               "'unhashable type' at call time")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        cached = _cached_names(ctx)
        if not cached:
            return
        for call in [n for n in ast.walk(ctx.tree) if isinstance(n, ast.Call)]:
            fname = Rule.call_name(call)
            if fname not in cached:
                continue
            for i, arg in enumerate(call.args):
                if isinstance(arg, _NONHASHABLE):
                    yield ctx.finding(
                        self.name, arg,
                        f"unhashable literal at position {i} of the "
                        f"lru_cache'd '{fname}' — pass a tuple")
            for kw in call.keywords:
                if isinstance(kw.value, _NONHASHABLE):
                    yield ctx.finding(
                        self.name, kw.value,
                        f"unhashable literal for '{kw.arg}' of the "
                        f"lru_cache'd '{fname}' — pass a tuple")


# --------------------------------------------------------------------------
# donated-after-call: a captured graph's static input rebound
# --------------------------------------------------------------------------

def _scopes(tree: ast.Module) -> Iterator[List[ast.stmt]]:
    yield tree.body
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.body


def _walk_scope(body: List[ast.stmt]) -> Iterator[ast.stmt]:
    """Statements of one scope in source order, into compound statements
    but not into nested function or class scopes."""
    for stmt in body:
        yield stmt
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for field in ("body", "orelse", "finalbody"):
            yield from _walk_scope(getattr(stmt, field, []) or [])
        for handler in getattr(stmt, "handlers", []) or []:
            yield from _walk_scope(handler.body)


def _capture_graph(stmt: ast.stmt) -> Optional[str]:
    """The graph variable of ``with torch.cuda.graph(g[, ...]):`` (or
    ``capture_graph(g, ...)``), else None."""
    if not isinstance(stmt, (ast.With, ast.AsyncWith)):
        return None
    for item in stmt.items:
        e = item.context_expr
        if isinstance(e, ast.Call) and e.args \
                and isinstance(e.args[0], ast.Name) and (
                    Rule.call_name(e) == "torch.cuda.graph"
                    or Rule.terminal(Rule.call_name(e)) == "capture_graph"):
            return e.args[0].id
    return None


def _bound(stmt: ast.stmt) -> List[ast.Name]:
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    return [n for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


@register
class DonatedAfterCallRule(Rule):
    name = "donated-after-call"
    summary = ("a captured CUDA graph's static input rebound after the "
               "capture and the graph replayed — the replay reads the old "
               "buffer; update it with .copy_()")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for body in _scopes(ctx.tree):
            stmts = list(_walk_scope(body))
            for i, stmt in enumerate(stmts):
                graph = _capture_graph(stmt)
                if graph is None:
                    continue
                inside = {n.id for s in stmt.body for n in ast.walk(s)
                          if isinstance(n, ast.Name)
                          and isinstance(n.ctx, ast.Load)}
                inside -= {n.id for s in stmt.body for st in
                           _walk_scope([s]) for n in _bound(st)}
                before = {n.id for s in stmts[:i] for n in _bound(s)}
                if isinstance(body, list):
                    before |= {a.arg for node in ast.walk(ctx.tree)
                               if isinstance(node, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef))
                               and node.body is body
                               for a in node.args.args}
                static = (inside & before) - {graph}
                later = stmts[i + 1:]
                if not any(isinstance(n, ast.Call)
                           and Rule.call_name(n) == f"{graph}.replay"
                           for s in later for n in ast.walk(s)):
                    continue
                for s in later:
                    if s in stmt.body or any(s is b for b in
                                             _walk_scope(stmt.body)):
                        continue
                    for n in _bound(s):
                        if n.id in static:
                            yield ctx.finding(
                                self.name, n,
                                f"'{n.id}' was captured as a static input "
                                f"of graph '{graph}' and is rebound before "
                                f"'{graph}.replay()' — the replay reads the "
                                f"old buffer; write it with "
                                f"'{n.id}.copy_(...)'")
