"""Rule ``key-reuse``: one seed feeding two streams (port of
``analysis/rules/prng.py``).

What it means in PyTorch: a JAX key is a linear value that two samplers
must not share. Torch has no key values: a ``torch.Generator`` is a
stateful stream, and handing one generator to two samplers is the normal,
correct way to draw independent numbers. What correlates draws in torch
is *re-seeding*: calling ``manual_seed`` again with the same seed (on the
same generator, on another one, or on the global ``torch.manual_seed``)
restarts the same stream, so the consumer after the second seeding
repeats the first consumer's draws. For an IWAE bound that makes
"independent" samples identical, the JAX rule's failure exactly.

Detection, per function scope in statement order (no cross-function
dataflow): a ``manual_seed(s)`` call whose seed expression ``s`` is a
constant, or a name or attribute chain not rebound since an earlier
``manual_seed`` with the same expression in the scope, flags the second
seeding. A seeding inside a loop whose seed does not change with the
iteration flags too (the loop body is walked twice, as JAX's rule walks
it). ``if``/``else`` branches and ``try`` handlers are alternatives, not a
sequence. A deliberate replay of one stream (a parity check) suppresses
the finding in place with its reason.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Set, Tuple

from iwae_replication_project_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    register,
)


def _seed_key(node: ast.AST):
    """A hashable identity of a seed expression, or None when it is not a
    constant or a plain name/attribute chain (a call, an arithmetic mix of
    other values: a new seed each time as far as the rule can tell)."""
    if isinstance(node, ast.Constant):
        return ("const", repr(node.value))
    name = Rule.dotted(node)
    return ("name", name) if name else None


def _names_of(key) -> Set[str]:
    return {key[1].split(".")[0]} if key and key[0] == "name" else set()


def _assigned(target: ast.AST) -> List[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for e in target.elts for n in _assigned(e)]
    if isinstance(target, ast.Starred):
        return _assigned(target.value)
    return []


class _ScopeLinter:
    def __init__(self, ctx: FileContext, rule: str):
        self.ctx, self.rule = ctx, rule
        self.seeded: Dict[Tuple, int] = {}   # seed key -> seedings so far
        self.findings: List[Finding] = []

    def run(self, body: List[ast.stmt]) -> List[Finding]:
        self._block(body)
        return self.findings

    def _block(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _fork(self, bodies: List[List[ast.stmt]]) -> None:
        base = dict(self.seeded)
        merged: Dict[Tuple, int] = {}
        for body in bodies:
            self.seeded = dict(base)
            self._block(body)
            for k, v in self.seeded.items():
                merged[k] = max(merged.get(k, 0), v)
        self.seeded = merged

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.If):
            self._seedings(stmt.test)
            self._fork([stmt.body, stmt.orelse])
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._seedings(stmt.iter)
                self._rebind(_assigned(stmt.target))
            else:
                self._seedings(stmt.test)
            for _ in range(2):  # a second iteration repeats the seeding
                self._block(stmt.body)
                if isinstance(stmt, (ast.For, ast.AsyncFor)):
                    self._rebind(_assigned(stmt.target))
            self._block(stmt.orelse)
            return
        if isinstance(stmt, ast.Try):
            self._fork([stmt.body + stmt.orelse]
                       + [h.body for h in stmt.handlers])
            self._block(stmt.finalbody)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._seedings(item.context_expr)
            self._block(stmt.body)
            return
        self._seedings(stmt)
        if isinstance(stmt, ast.Assign):
            self._rebind([n for t in stmt.targets for n in _assigned(t)])
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            self._rebind(_assigned(stmt.target))

    def _rebind(self, names: List[str]) -> None:
        gone = set(names)
        self.seeded = {k: v for k, v in self.seeded.items()
                       if not (_names_of(k) & gone)}

    def _seedings(self, node: ast.AST) -> None:
        for call in self._calls(node):
            if not isinstance(call.func, ast.Attribute) \
                    or call.func.attr != "manual_seed" or len(call.args) != 1:
                continue
            key = _seed_key(call.args[0])
            if key is None:
                continue
            n = self.seeded.get(key, 0) + 1
            self.seeded[key] = n
            if n >= 2:
                self.findings.append(self.ctx.finding(
                    self.rule, call,
                    f"manual_seed({ast.unparse(call.args[0])}) seeds a "
                    f"stream with a seed already used in this scope — the "
                    f"consumers after it repeat the earlier draws"))

    def _calls(self, node: ast.AST) -> Iterator[ast.Call]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            yield from self._calls(child)
        if isinstance(node, ast.Call):
            yield node


@register
class KeyReuseRule(Rule):
    name = "key-reuse"
    summary = ("a generator re-seeded with a seed already used in the "
               "scope (or in a loop) — two consumers get the same draws")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        scopes: List[List[ast.stmt]] = [ctx.tree.body]
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node.body)
        for body in scopes:
            yield from _ScopeLinter(ctx, self.name).run(body)
