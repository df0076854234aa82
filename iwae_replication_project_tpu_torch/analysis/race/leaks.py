"""Static leak pass: futures completed, spans finished, pins released.

The serving control plane's drain contract ("zero silence": every accepted
request is answered, every trace finalizes, every executable pin returns
to the store) has so far been *test-sampled* — the chaos smoke proves it
for the schedules it runs. This pass machine-checks the structural half:
every acquisition of a leakable resource in the ``leak_paths`` files —

* ``X = Future()``            (completed by ``set_result/set_exception``),
* ``X = ...start_span(...)``  (closed by ``X.finish(...)``),
* ``X = ...pin_prefix(...)``  (returned by ``X.release()``),

— must be **safely held** on every exception path. A site passes when:

* the value is stored/handed off at the acquisition itself (assigned into
  an attribute/container, passed as a call argument, returned) — the
  receiving structure owns the lifecycle (its own drain paths are in this
  pass's scope too); or
* the acquisition sits inside a ``try`` whose ``finally`` — or an
  except-all (``except``/``except Exception``/``except BaseException``)
  handler — *names* the resource (releasing it, completing it, or handing
  it to the completion helper), AND a success-path sink exists later in
  the function; or
* nothing that can raise (a call, a subscript, a raise/assert, a compound
  header) stands between the acquisition and the first sink.

The check is structural, not path-sensitive: it proves the release
*shape* exists; the runtime leak check of the fuzzed tier sweep
(``tests/test_torch_race.py``, ``chip_smoke.py``'s race phase: open-span
count, pinned-entry count, outstanding futures) proves the shape works
under fuzzed schedules.

Rules ``leaked-future`` / ``leaked-span`` / ``leaked-pin`` register with
the lint framework (suppression grammar, ``--select``), and the
``iwae-race`` CLI runs exactly this family as its static stage.

:func:`acquisitions_in` is also consumed by the ``swallowed-exception``
rule: a best-effort ``except OSError`` drop in a function this pass
proves acquisition-free cannot leak a future/span/pin, so it no longer
needs a waiver.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from iwae_replication_project_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    register,
)

__all__ = ["analyze_file", "acquisitions_in",
           "LeakedFutureRule", "LeakedSpanRule", "LeakedPinRule"]

#: acquisition call terminal -> (kind, release verbs)
_ACQUIRE = {
    "Future": ("future", {"set_result", "set_exception", "cancel"}),
    "start_span": ("span", {"finish"}),
    "pin_prefix": ("pin", {"release"}),
}

#: statement types that cannot raise between acquisition and sink
_SAFE_STMTS = (ast.Pass, ast.Global, ast.Nonlocal, ast.Break, ast.Continue)

_EXCEPT_ALL = {"", "Exception", "BaseException"}


def _terminal_of(call: ast.Call) -> str:
    return Rule.terminal(Rule.call_name(call))


def _acquisition_kind(value: ast.AST) -> Optional[str]:
    """kind when `value` is *top-level* an acquisition call (a nested
    acquisition is already in the enclosing expression's hands)."""
    if isinstance(value, ast.Call):
        term = _terminal_of(value)
        if term in _ACQUIRE:
            if term == "Future" and (value.args or value.keywords):
                return None
            return _ACQUIRE[term][0]
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_sink(stmt: ast.stmt, var: str, release_verbs: Set[str]) -> bool:
    """Whether `stmt` safely disposes of `var`: releases/completes it,
    hands it to a call, stores it, or returns/yields it."""
    for node in ast.walk(stmt):
        if isinstance(node, ast.Call):
            # var.release() / var.finish(...) / var.set_result(...)
            if isinstance(node.func, ast.Attribute) and \
                    isinstance(node.func.value, ast.Name) and \
                    node.func.value.id == var and \
                    node.func.attr in release_verbs:
                return True
            # var handed to any call (complete_future(var), _Pending(...,
            # span=var), pending.append(var)) — the callee owns it now
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if var in _names_in(arg):
                    return True
        elif isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            if node.value is not None and var in _names_in(node.value):
                return True
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if not isinstance(tgt, ast.Name) and var in _names_in(
                        node.value):
                    return True      # self.Y = var / d[k] = var
    return False


def _can_raise(stmt: ast.stmt) -> bool:
    if isinstance(stmt, _SAFE_STMTS):
        return False
    if isinstance(stmt, ast.AnnAssign):
        # the annotation itself (Optional[X] is a Subscript node) never
        # evaluates at runtime under lazy annotations — only the value
        # and a subscripted target can raise
        roots = [n for n in (stmt.value, stmt.target) if n is not None]
    else:
        roots = [stmt]
    for root in roots:
        for node in ast.walk(root):
            if isinstance(node, (ast.Call, ast.Raise, ast.Assert,
                                 ast.Subscript)):
                return True
    return False


def _handler_is_all(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    return Rule.terminal(Rule.dotted(handler.type) or "?") in _EXCEPT_ALL


def _try_protects(try_node: ast.Try, var: str) -> bool:
    """A try protects `var` when its finally, or an except-all handler,
    names the resource (release/complete/handoff all count via naming)."""
    for stmt in try_node.finalbody:
        if var in _names_in(stmt):
            return True
    for handler in try_node.handlers:
        if _handler_is_all(handler):
            for stmt in handler.body:
                if var in _names_in(stmt):
                    return True
    return False


class _Acquisition:
    __slots__ = ("var", "kind", "node", "protected")

    def __init__(self, var: Optional[str], kind: str, node: ast.AST,
                 protected: bool):
        self.var = var
        self.kind = kind
        self.node = node
        self.protected = protected


def _walk_function(func: ast.AST) -> List[_Acquisition]:
    """Acquisitions inside `func` (nested defs excluded — they are their
    own functions), each stamped with its enclosing-try protection."""
    out: List[_Acquisition] = []

    def visit(stmts: List[ast.stmt], tries: List[ast.Try]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                kind = _acquisition_kind(stmt.value)
                if kind is not None:
                    tgt = stmt.targets[0]
                    if isinstance(tgt, ast.Name):
                        protected = any(
                            _try_protects(t, tgt.id) for t in tries)
                        out.append(_Acquisition(tgt.id, kind, stmt.value,
                                                protected))
                    # non-Name target: stored at birth — a handoff sink
            elif isinstance(stmt, ast.Expr):
                kind = _acquisition_kind(stmt.value)
                if kind is not None:
                    out.append(_Acquisition(None, kind, stmt.value,
                                            protected=False))
            # recurse into compound bodies
            if isinstance(stmt, ast.Try):
                visit(stmt.body, tries + [stmt])
                for handler in stmt.handlers:
                    visit(handler.body, tries)
                visit(stmt.orelse, tries)
                visit(stmt.finalbody, tries)
            else:
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if sub:
                        visit(sub, tries)

    visit(getattr(func, "body", []), [])
    return out


def _flat_stmts(func: ast.AST) -> List[ast.stmt]:
    """Every statement in `func` (nested defs excluded), line order."""
    out: List[ast.stmt] = []

    def visit(stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            out.append(stmt)
            for field in ("body", "orelse", "finalbody", "handlers"):
                sub = getattr(stmt, field, None)
                if not sub:
                    continue
                for item in sub:
                    if isinstance(item, ast.ExceptHandler):
                        visit(item.body)
                    else:
                        visit([item])

    visit(getattr(func, "body", []))
    return sorted(out, key=lambda s: (s.lineno, s.col_offset))


def analyze_file(tree: ast.Module) -> List[Tuple[str, ast.AST, str]]:
    """All leak findings for one parsed file: ``(kind, node, message)``."""
    findings: List[Tuple[str, ast.AST, str]] = []
    for func in [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        acqs = _walk_function(func)
        if not acqs:
            continue
        stmts = _flat_stmts(func)
        for acq in acqs:
            verbs = next(v for k, (kind, v) in _ACQUIRE.items()
                         if kind == acq.kind)
            noun = {"future": "future", "span": "span",
                    "pin": "executable-store pin"}[acq.kind]
            if acq.var is None:
                findings.append((
                    acq.kind, acq.node,
                    f"{noun} created and dropped: the handle is never "
                    f"bound, so nothing can ever complete/close/release "
                    f"it — bind it and manage its lifecycle"))
                continue
            later = [s for s in stmts
                     if (s.lineno, s.col_offset) >
                     (acq.node.lineno, acq.node.col_offset)]
            sink_at = None
            for i, s in enumerate(later):
                if _is_sink(s, acq.var, verbs):
                    sink_at = i
                    break
            if sink_at is None:
                findings.append((
                    acq.kind, acq.node,
                    f"{noun} '{acq.var}' is never completed, handed off, "
                    f"or released after this acquisition — it leaks on "
                    f"every path through '{func.name}'"))
                continue
            if acq.protected:
                continue
            for s in later[:sink_at]:
                if _can_raise(s):
                    findings.append((
                        acq.kind, acq.node,
                        f"{noun} '{acq.var}' leaks if line {s.lineno} "
                        f"raises before the handoff/release at line "
                        f"{later[sink_at].lineno}: wrap the window in "
                        f"try/finally (or an except-all handler that "
                        f"completes '{acq.var}' and re-raises)"))
                    break
    return findings


def acquisitions_in(func: ast.AST) -> int:
    """How many leakable acquisitions `func` makes (0 = the leak pass
    proves an exception drop here cannot leak a future/span/pin)."""
    n = 0
    for node in ast.walk(func):
        if isinstance(node, ast.Call) and _terminal_of(node) in _ACQUIRE:
            if _terminal_of(node) == "Future" and (node.args or
                                                   node.keywords):
                continue
            n += 1
    return n


def _in_leak_paths(ctx: FileContext) -> bool:
    return any(ctx.rel_path == p or
               ctx.rel_path.startswith(p.rstrip("/") + "/")
               for p in ctx.config.leak_paths)


class _LeakRuleBase(Rule):
    kind = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _in_leak_paths(ctx):
            return
        for kind, node, message in analyze_file(ctx.tree):
            if kind == self.kind:
                yield ctx.finding(self.name, node, message)


@register
class LeakedFutureRule(_LeakRuleBase):
    name = "leaked-future"
    kind = "future"
    summary = ("a Future acquired in a leak_paths file is not provably "
               "completed/handed off on all exception paths — a leaked "
               "future is a request that never answers (the drain "
               "contract's 'zero silence')")


@register
class LeakedSpanRule(_LeakRuleBase):
    name = "leaked-span"
    kind = "span"
    summary = ("a tracing Span opened in a leak_paths file is not provably "
               "finished on all exception paths — a leaked span is a trace "
               "that can only expire as abandoned")


@register
class LeakedPinRule(_LeakRuleBase):
    name = "leaked-pin"
    kind = "pin"
    summary = ("an ExecutableStore pin taken in a leak_paths file is not "
               "provably released on all exception paths — a leaked pin "
               "permanently shrinks the store's evictable budget")
