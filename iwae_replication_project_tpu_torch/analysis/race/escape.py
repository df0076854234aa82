"""Static thread-escape analysis: which ``self.X`` cross a thread boundary.

The ``unlocked-shared-state`` lint rule's original model was purely
lock-relative: an attribute written both under a lock and bare is flagged.
That model has two blind spots this pass closes:

* an attribute touched only by ONE internal thread (a dispatcher loop's
  private scratch) cannot race no matter how its writes mix with lock
  holds — flagging it forces waivers for code that is correct by
  construction (**thread-confined** state);
* an attribute shared between a thread body and the external API with no
  lock *anywhere* never trips the lock-relative rule at all — yet that is
  the barest possible race (**escaping** state, bare writes).

The reconstruction is per class, over three escape mechanisms:

* ``Thread(target=self.m)`` — ``m`` (and every same-class method reachable
  from it) runs on its own thread root;
* ``fut.add_done_callback(self.m)`` — ``m`` runs on whichever thread
  completes the future (a distinct root);
* **payload handoff** — ``self.X`` passed in ``Thread(..., args=...)``,
  ``put()`` on a queue, or ``set_result()`` of a future escapes to the
  receiving thread even though no method-reachability edge says so.

Everything not reachable from an internal root is the **external** root:
the public API, callable from arbitrary caller threads. An attribute is
*confined* when every access lands in exactly one internal root;
*escaping* when its accesses span two or more roots (or any handoff).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["ClassEscape", "classify_class"]

#: root name for the public API (arbitrary caller threads)
EXTERNAL = "external"
#: pseudo-root for queue/future/thread-args payload handoff
HANDOFF = "handoff"

#: method names that push their argument to another thread
_HANDOFF_CALLS = {"put", "put_nowait", "set_result"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


class _MethodWalk(ast.NodeVisitor):
    """One method's attr reads/writes and same-class calls."""

    def __init__(self):
        self.reads: Set[str] = set()
        self.writes: Set[str] = set()
        self.calls: Set[str] = set()

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr is not None:
            if isinstance(node.ctx, (ast.Store, ast.Del)):
                self.writes.add(attr)
            else:
                self.reads.add(attr)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # self.X[k] = v / del self.X[k] mutate X in place
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            attr = _self_attr(node.value)
            if attr is not None:
                self.writes.add(attr)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = _self_attr(node.target)
        if attr is not None:
            self.writes.add(attr)
            self.reads.add(attr)
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute):
            recv = node.func.value
            if isinstance(recv, ast.Name) and recv.id == "self":
                self.calls.add(node.func.attr)
            # in-place mutation of self.X counts as a write
            attr = _self_attr(recv)
            if attr is not None and node.func.attr in (
                    "append", "appendleft", "extend", "insert", "pop",
                    "popleft", "remove", "clear", "update", "add",
                    "discard", "setdefault", "sort", "reverse"):
                self.writes.add(attr)
        self.generic_visit(node)


def _thread_targets(cls: ast.ClassDef) -> Tuple[Set[str], Set[str]]:
    """(thread target methods, payload-handoff attrs) found anywhere in the
    class: Thread(target=self.m, args=(self.X,)), cb(self.m), put(self.X)."""
    targets: Set[str] = set()
    handoff: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        callee = node.func
        callee_name = callee.attr if isinstance(callee, ast.Attribute) \
            else (callee.id if isinstance(callee, ast.Name) else "")
        if callee_name == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    m = _self_attr(kw.value)
                    if m is not None:
                        targets.add(m)
                elif kw.arg == "args":
                    for sub in ast.walk(kw.value):
                        a = _self_attr(sub)
                        if a is not None:
                            handoff.add(a)
        elif callee_name == "add_done_callback":
            for arg in node.args:
                m = _self_attr(arg)
                if m is not None:
                    targets.add(m)
        elif callee_name in _HANDOFF_CALLS:
            for arg in node.args:
                for sub in ast.walk(arg):
                    a = _self_attr(sub)
                    if a is not None:
                        handoff.add(a)
    return targets, handoff


def _reachable(start: Set[str], calls: Dict[str, Set[str]]) -> Set[str]:
    seen = set(start)
    frontier = list(start)
    while frontier:
        m = frontier.pop()
        for callee in calls.get(m, ()):
            if callee not in seen:
                seen.add(callee)
                frontier.append(callee)
    return seen


@dataclasses.dataclass
class ClassEscape:
    """The escape classification of one class's attributes."""

    #: every root: EXTERNAL plus one ``thread:<m>`` per internal entry
    roots: Set[str]
    #: attr -> the roots whose reachable methods access it (plus HANDOFF)
    attr_roots: Dict[str, Set[str]]
    #: attrs written (incl. augmented/mutating) outside __init__
    written: Set[str]

    def roots_of(self, attr: str) -> Set[str]:
        return self.attr_roots.get(attr, {EXTERNAL})

    def confined(self, attr: str) -> bool:
        """Accessed from exactly one internal thread root: cannot race."""
        roots = self.roots_of(attr)
        return len(roots) == 1 and next(iter(roots)) != EXTERNAL

    def escaping(self, attr: str) -> bool:
        """Accessed from >= 2 roots, at least one internal/handoff — the
        attribute genuinely crosses a thread boundary."""
        roots = self.roots_of(attr)
        return len(roots) >= 2 and any(r != EXTERNAL for r in roots)


def classify_class(cls: ast.ClassDef,
                   skip_attrs: Optional[Set[str]] = None) -> ClassEscape:
    """Escape-classify `cls` (``skip_attrs``: lock attributes — they are
    synchronization, not shared data)."""
    skip = skip_attrs or set()
    walks: Dict[str, _MethodWalk] = {}
    init_names = {"__init__", "__post_init__"}
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            w = _MethodWalk()
            for stmt in item.body:
                w.visit(stmt)
            walks[item.name] = w

    calls = {m: w.calls for m, w in walks.items()}
    targets, handoff = _thread_targets(cls)
    targets &= set(walks)           # only same-class methods root a thread

    root_reach: Dict[str, Set[str]] = {}
    for m in sorted(targets):
        root_reach[f"thread:{m}"] = _reachable({m}, calls)
    external_entries = {m for m in walks
                        if m not in targets and m not in init_names}
    root_reach[EXTERNAL] = _reachable(external_entries, calls)

    attr_roots: Dict[str, Set[str]] = {}
    written: Set[str] = set()
    for root, methods in root_reach.items():
        for m in methods:
            w = walks.get(m)
            if w is None or m in init_names:
                continue
            for attr in (w.reads | w.writes) - skip:
                attr_roots.setdefault(attr, set()).add(root)
            for attr in w.writes - skip:
                written.add(attr)
    for attr in handoff - skip:
        attr_roots.setdefault(attr, set()).add(HANDOFF)

    return ClassEscape(roots=set(root_reach) | ({HANDOFF} if handoff
                                                else set()),
                       attr_roots=attr_roots, written=written)
