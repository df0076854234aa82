"""Rules ``lock-order``, ``unlocked-shared-state``,
``blocking-call-under-lock``, and ``swallowed-exception``: the serving
concurrency checker.

The serving engine is a three-thread system — the dispatcher coalesces and
enqueues, the completion thread fetches and completes, and metric scrapes
read from arbitrary threads (the metrics page, bench loops). The two
failure classes that matter there are classic: two locks taken in opposite
orders on two paths (deadlock under the right interleaving — which closed-
loop serving traffic will eventually find), and an attribute that is
guarded on one path and bare on another (a torn/stale publish under the
GIL's instruction-level interleaving). Both are *cross-function* properties
no unit test reliably catches, so they are checked statically over a small
CFG walk of the configured ``concurrency_paths`` (the serving engine,
batcher, tier and fleet, and the telemetry they report through).

Model (deliberately scoped to this codebase's locking idiom):

* a **lock attribute** is ``self.X`` assigned from
  ``threading.Lock/RLock/Condition/(Bounded)Semaphore`` anywhere in the
  class, or assigned from a parameter named ``lock`` (the registry's shared-
  lock pattern). ``threading.Condition(self.Y)`` ALIASES Y — the engine's
  ``_cv``/``_lock`` pair is one lock, not two;
* an **acquisition** is ``with self.X:`` (the only form these modules use);
* analysis is per class: edges ``held -> acquired`` from nested with-blocks
  plus one level of same-class method calls made while holding a lock; a
  cycle in that graph is a ``lock-order`` finding at each participating
  acquisition site;
* a write (``self.Y = ...``, ``self.Y op= ...``, ``self.Y[...] = ...``, or
  a mutating method call ``self.Y.append/pop/...(...)``) is **guarded** when
  it executes under any ``with self.<lock>``; an attribute with both guarded
  and bare writes outside ``__init__`` gets an ``unlocked-shared-state``
  finding at each bare site — UNLESS the thread-escape analysis
  (``analysis/race/escape.py``) proves the attribute **thread-confined**
  (every access lands in exactly one internal thread root), in which case
  the mixed regime cannot race and no waiver is needed;
* conversely, an attribute the escape analysis proves **escaping** (its
  accesses span two or more thread roots, or it is handed off through a
  queue/future/thread-args payload) whose writes are *never* guarded is
  flagged too — even in a class with no lock anywhere, which the
  lock-relative rule alone cannot see. Writes in lifecycle methods (those
  that call ``.start()`` or ``.join()``) are exempt: the thread start/join
  edge happens-before-orders them;
* ``blocking-call-under-lock``: a call that can block indefinitely —
  ``future.result()``, socket send/recv/accept/connect, ``queue.get/put``
  with no timeout, ``time.sleep``, a thread ``.join()``, an event
  ``.wait()`` — made while holding a ``with self.<lock>`` stalls every
  thread contending for that lock (and under the engine's completion/
  dispatch triangle, stalls the whole tier). Checked directly and one
  level through same-class calls made under a lock.

``swallowed-exception`` adds the third failure class of a callback-driven
serving stack: an ``except`` handler that drops the error on the floor. In
a request/response system every exception is somebody's *outcome* — a
future to error-complete, a typed response to write, a replica to mark
unhealthy — and a handler that does none of that turns a failure into
silence (the lost-future bug class the chaos harness exists to catch). A
handler counts as HANDLING when its body re-raises, returns, breaks or
continues (an explicit control-flow decision), or *uses the bound
exception value* (``except X as e`` with ``e`` flowing into a completion
call, a typed response, or a message). A deliberate best-effort drop
(``sock.shutdown`` on teardown) carries a justified suppression — the
inventory of intentional swallows stays reviewable in the diff.

One shape is exempt without a waiver: ``except OSError`` whose body only
sets a constant flag or passes, inside a function the static leak pass
(``analysis/race/leaks.py``) proves acquisition-free — such a teardown
drop cannot leak a future, span, or pin, so demanding a justification
adds review noise, not safety.
``contextlib.suppress(...)`` is the OTHER sanctioned idiom: it cannot
contain logic, so it is intentional by construction (and greppable); the
rule deliberately leaves it alone rather than demanding a second marker.
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
from iwae_replication_project_tpu_torch.analysis.race import escape as _escape
from iwae_replication_project_tpu_torch.analysis.race.leaks import acquisitions_in

#: threading factory callables whose result is a lockable
_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}

#: container methods that mutate their receiver in place
_MUTATORS = {"append", "appendleft", "extend", "insert", "pop", "popleft",
             "remove", "clear", "update", "add", "discard", "setdefault",
             "sort", "reverse"}

#: socket methods that block on the peer / the kernel
_SOCKET_BLOCKERS = {"send", "sendall", "recv", "recv_into", "accept",
                    "connect", "sendto", "recvfrom", "makefile"}

#: receiver spellings the queue get/put heuristic treats as queues
def _queueish(recv_name: str) -> bool:
    last = recv_name.rsplit(".", 1)[-1].lower().lstrip("_")
    return "queue" in last or last == "q" or last.endswith("_q")


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> ``"X"`` (None otherwise)."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _in_paths(ctx: FileContext, paths: List[str]) -> bool:
    return any(ctx.rel_path == p or ctx.rel_path.startswith(p.rstrip("/") + "/")
               for p in paths)


def _blocking_what(node: ast.Call, locks: Dict[str, str]) -> Optional[str]:
    """A short description when `node` is a potentially-unbounded blocking
    call, else None. Scoped to the blockers this codebase can actually
    reach: future results, socket I/O, un-timeouted queue ops, sleeps,
    thread joins, and event waits (a Condition's own wait releases the
    lock it is called under, so lock-attr receivers are exempt)."""
    if not isinstance(node.func, ast.Attribute):
        name = Rule.call_name(node)
        return "time.sleep()" if Rule.terminal(name) == "sleep" else None
    meth = node.func.attr
    dotted = Rule.call_name(node)          # '' for non-name receiver chains
    recv = dotted.rsplit(".", 1)[0] if "." in dotted else ""
    kwargs = {kw.arg for kw in node.keywords}
    if meth == "sleep":
        return "time.sleep()"
    if meth == "result":
        return "future .result()"
    if meth in _SOCKET_BLOCKERS:
        return f"socket .{meth}()"
    if meth == "join":
        numeric = (len(node.args) == 1 and
                   isinstance(node.args[0], ast.Constant) and
                   isinstance(node.args[0].value, (int, float)))
        if not node.args and (not kwargs or kwargs == {"timeout"}):
            return "thread .join()"
        if numeric:
            return "thread .join()"
        return None                        # str.join(iterable) etc.
    if meth in ("get", "put") and _queueish(recv):
        if "timeout" in kwargs or len(node.args) >= 2:
            return None
        for kw in node.keywords:
            if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return None
        if node.args and meth == "get" and \
                isinstance(node.args[0], ast.Constant) and \
                node.args[0].value is False:
            return None
        return f"queue .{meth}() with no timeout"
    if meth == "wait":
        attr = _self_attr(node.func.value)
        if attr is not None and attr not in locks:
            return "event .wait()"
    return None


def _lock_attrs(cls: ast.ClassDef) -> Dict[str, str]:
    """Lock attribute -> canonical lock name (Condition aliases collapse)."""
    canon: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        attr = _self_attr(node.targets[0])
        if attr is None:
            continue
        for call in [n for n in ast.walk(node.value)
                     if isinstance(n, ast.Call)]:
            name = Rule.terminal(Rule.call_name(call))
            if name in _LOCK_FACTORIES:
                alias = None
                if name == "Condition" and call.args:
                    alias = _self_attr(call.args[0])
                canon[attr] = canon.get(alias, alias) if alias else attr
                break
        else:
            if isinstance(node.value, ast.Name) and \
                    node.value.id.endswith("lock"):
                canon[attr] = attr  # shared-lock injection (registry pattern)
    return canon


class _FuncWalk(ast.NodeVisitor):
    """One function's lock behavior: acquisition edges, per-lock acquisition
    sites, writes (guarded or bare), and same-class calls under a lock."""

    def __init__(self, locks: Dict[str, str]):
        self.locks = locks
        self.held: List[str] = []
        #: (held_lock, acquired_lock, node) for nested acquisitions
        self.edges: List[Tuple[str, str, ast.AST]] = []
        #: canonical lock -> first acquisition node (for reporting)
        self.acquired: Dict[str, ast.AST] = {}
        #: attr -> [(guarded?, node)]
        self.writes: Dict[str, List[Tuple[bool, ast.AST]]] = {}
        #: (held_lock, method_name, call node) for one-level interprocedural
        self.calls_under_lock: List[Tuple[str, str, ast.AST]] = []
        #: (held?, node, what) for potentially-unbounded blocking calls
        self.blocking: List[Tuple[bool, ast.AST, str]] = []
        #: calls .start()/.join(): a thread lifecycle method — its bare
        #: writes are ordered by the start/join happens-before edge
        self.lifecycle = False

    def _record_write(self, attr: str, node: ast.AST) -> None:
        self.writes.setdefault(attr, []).append((bool(self.held), node))

    def visit_With(self, node: ast.With) -> None:
        entered: List[str] = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in self.locks and item.optional_vars is None:
                lock = self.locks[attr]
                self.acquired.setdefault(lock, item.context_expr)
                for held in self.held:
                    if held != lock:
                        self.edges.append((held, lock, item.context_expr))
                self.held.append(lock)
                entered.append(lock)
            else:
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in entered:
            self.held.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
            attr = _self_attr(base)
            if attr is not None and attr not in self.locks:
                self._record_write(attr, tgt)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        base = node.target.value if isinstance(node.target, ast.Subscript) \
            else node.target
        attr = _self_attr(base)
        if attr is not None and attr not in self.locks:
            self._record_write(attr, node.target)
        self.visit(node.value)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute):
            recv = node.func.value
            attr = _self_attr(recv)
            if attr is not None and node.func.attr in _MUTATORS and \
                    attr not in self.locks:
                self._record_write(attr, node)
            if isinstance(recv, ast.Name) and recv.id == "self" and self.held:
                for held in self.held:
                    self.calls_under_lock.append((held, node.func.attr, node))
            if node.func.attr in ("start", "join"):
                self.lifecycle = True
        what = _blocking_what(node, self.locks)
        if what is not None:
            self.blocking.append((bool(self.held), node, what))
        self.generic_visit(node)


def _path(adj: Dict[str, Set[str]], src: str, dst: str
          ) -> Optional[List[str]]:
    """BFS path ``src -> ... -> dst`` through held->acquired edges (None if
    unreachable); the caller prepends the edge that closes the cycle."""
    frontier, parents = [src], {src: None}
    while frontier:
        nxt: List[str] = []
        for n in frontier:
            if n == dst:
                path = []
                while n is not None:
                    path.append(n)
                    n = parents[n]
                return path[::-1]
            for m in adj.get(n, ()):
                if m not in parents:
                    parents[m] = n
                    nxt.append(m)
        frontier = nxt
    return None


def _analyze_class(cls: ast.ClassDef):
    locks = _lock_attrs(cls)
    walks: Dict[str, _FuncWalk] = {}
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            w = _FuncWalk(locks)
            for stmt in item.body:
                w.visit(stmt)
            walks[item.name] = w
    return locks, walks


@register
class LockOrderRule(Rule):
    name = "lock-order"
    summary = ("locks acquired in a cyclic order (direct inversion or a "
               "longer cycle) across paths of a concurrency_paths class — "
               "a deadlock under the right thread interleaving")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _in_paths(ctx, ctx.config.concurrency_paths):
            return
        for cls in [n for n in ast.walk(ctx.tree)
                    if isinstance(n, ast.ClassDef)]:
            locks, walks = _analyze_class(cls)
            if len(set(locks.values())) < 2:
                continue  # one canonical lock cannot invert
            # direct nested-with edges + one level of held-lock method calls
            edges: Dict[Tuple[str, str], ast.AST] = {}
            for w in walks.values():
                for held, got, node in w.edges:
                    edges.setdefault((held, got), node)
                for held, meth, _ in w.calls_under_lock:
                    callee = walks.get(meth)
                    if callee is None:
                        continue
                    for got, node in callee.acquired.items():
                        if got != held:
                            edges.setdefault((held, got), node)
            adj: Dict[str, Set[str]] = {}
            for a, b in edges:
                adj.setdefault(a, set()).add(b)
            for (a, b), node in sorted(edges.items()):
                cycle = _path(adj, b, a)  # edge on a cycle iff b reaches a
                if cycle is None:
                    continue
                if (b, a) in edges:
                    if a < b:  # report each direct inversion once
                        other = edges[(b, a)]
                        yield ctx.finding(
                            self.name, node,
                            f"'{cls.name}' acquires lock '{b}' while "
                            f"holding '{a}' here, but the opposite order at "
                            f"line {getattr(other, 'lineno', '?')} — two "
                            f"threads taking the pair concurrently deadlock;"
                            f" pick one global order")
                else:  # longer cycle: every edge inside it is a hold point
                    chain = " -> ".join([a] + cycle)
                    yield ctx.finding(
                        self.name, node,
                        f"'{cls.name}' acquires lock '{b}' while holding "
                        f"'{a}' here, closing the cyclic lock order "
                        f"{chain} — threads advancing around the cycle "
                        f"concurrently deadlock; pick one global order")


def _teardown_drop(handler: ast.ExceptHandler) -> bool:
    """An ``except OSError`` whose body only passes or sets a constant flag
    (``self._dead = True``) — the best-effort-teardown shape. Exempt from
    ``swallowed-exception`` when the enclosing function is acquisition-free
    per the static leak pass (nothing a dropped error could leak)."""
    if handler.type is None or \
            Rule.terminal(Rule.dotted(handler.type) or "?") != "OSError":
        return False
    for stmt in handler.body:
        if isinstance(stmt, ast.Pass):
            continue
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.value, ast.Constant) and \
                _self_attr(stmt.targets[0]) is not None:
            continue
        return False
    return True


def _handler_funcs(tree: ast.Module) -> Dict[ast.ExceptHandler, ast.AST]:
    """Each except handler -> its innermost enclosing function."""
    out: Dict[ast.ExceptHandler, ast.AST] = {}
    for func in [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        for node in ast.walk(func):
            if isinstance(node, ast.ExceptHandler):
                out[node] = func        # inner functions visited later win
    return out


def _handler_handles(handler: ast.ExceptHandler) -> bool:
    """Whether the handler's body re-raises, makes an explicit control-flow
    decision (return/continue/break), or uses the bound exception value —
    the three shapes that count as handling (module docstring)."""
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Raise, ast.Return, ast.Continue,
                                 ast.Break)):
                return True
            if handler.name is not None and isinstance(node, ast.Name) \
                    and node.id == handler.name \
                    and isinstance(node.ctx, ast.Load):
                return True
    return False


@register
class SwallowedExceptionRule(Rule):
    name = "swallowed-exception"
    summary = ("except-and-drop in a concurrency_paths file: the handler "
               "neither re-raises, returns/continues/breaks, nor uses the "
               "caught exception — a dropped error is a lost future / "
               "silent failure in a callback-driven serving stack")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _in_paths(ctx, ctx.config.concurrency_paths):
            return
        funcs = _handler_funcs(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _handler_handles(node):
                continue
            func = funcs.get(node)
            if func is not None and _teardown_drop(node) and \
                    acquisitions_in(func) == 0:
                continue    # leak-pass verdict: this drop cannot leak
            caught = (Rule.dotted(node.type) or "...") \
                if node.type is not None else "BaseException"
            yield ctx.finding(
                self.name, node,
                f"'except {caught}' swallows the error: complete a future "
                f"or typed response with it, re-raise, or make the drop an "
                f"explicit control-flow decision (return/continue/break) — "
                f"a deliberate best-effort drop needs a justified "
                f"suppression")


@register
class UnlockedSharedStateRule(Rule):
    name = "unlocked-shared-state"
    summary = ("attribute written bare in a concurrency_paths class where "
               "it can race: mixed guarded/bare writes, or never-guarded "
               "writes to state the escape analysis proves crosses a "
               "thread boundary")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _in_paths(ctx, ctx.config.concurrency_paths):
            return
        init_names = ("__init__", "__post_init__")
        for cls in [n for n in ast.walk(ctx.tree)
                    if isinstance(n, ast.ClassDef)]:
            locks, walks = _analyze_class(cls)
            esc = _escape.classify_class(cls, skip_attrs=set(locks))
            guarded: Set[str] = set()
            for name, w in walks.items():
                if name in init_names:
                    continue
                for attr, sites in w.writes.items():
                    if any(g for g, _ in sites):
                        guarded.add(attr)
            for name, w in walks.items():
                if name in init_names:
                    continue
                for attr, sites in w.writes.items():
                    # mixed regime: guarded elsewhere, bare here — unless
                    # the attribute never leaves one internal thread
                    if attr in guarded:
                        if esc.confined(attr):
                            continue
                        for g, node in sites:
                            if not g:
                                yield ctx.finding(
                                    self.name, node,
                                    f"'{cls.name}.{attr}' is written under "
                                    f"a lock elsewhere but bare in '{name}'"
                                    f" — either every write holds the lock "
                                    f"or none does; a mixed regime "
                                    f"publishes torn/stale state to the "
                                    f"guarded threads")
                        continue
                    # never guarded anywhere: flag only when the escape
                    # analysis proves the attribute crosses a thread
                    # boundary (lifecycle methods are start/join-ordered)
                    if w.lifecycle or not esc.escaping(attr):
                        continue
                    roots = ", ".join(sorted(esc.roots_of(attr)))
                    for g, node in sites:
                        yield ctx.finding(
                            self.name, node,
                            f"'{cls.name}.{attr}' is written in '{name}' "
                            f"with no lock held anywhere, but escapes to "
                            f"multiple thread roots ({roots}) — a bare "
                            f"write to thread-escaping state races every "
                            f"other root; guard it or confine it to one "
                            f"thread")


@register
class BlockingCallUnderLockRule(Rule):
    name = "blocking-call-under-lock"
    summary = ("a potentially-unbounded blocking call (future .result(), "
               "socket I/O, un-timeouted queue get/put, time.sleep, thread "
               ".join, event .wait) made while holding a lock in a "
               "concurrency_paths class — every thread contending for that "
               "lock stalls behind the peer/kernel/scheduler")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not _in_paths(ctx, ctx.config.concurrency_paths):
            return
        for cls in [n for n in ast.walk(ctx.tree)
                    if isinstance(n, ast.ClassDef)]:
            locks, walks = _analyze_class(cls)
            if not locks:
                continue
            for name, w in walks.items():
                for held, node, what in w.blocking:
                    if held:
                        yield ctx.finding(
                            self.name, node,
                            f"'{cls.name}.{name}' makes a blocking {what} "
                            f"while holding a lock — move the blocking op "
                            f"outside the critical section (snapshot under "
                            f"the lock, block outside), or bound it with a "
                            f"timeout")
                # one level interprocedural: a held-lock call into a method
                # that blocks (in its own unheld context) blocks here too
                for held, meth, node in w.calls_under_lock:
                    callee = walks.get(meth)
                    if callee is None:
                        continue
                    for c_held, _, what in callee.blocking:
                        if not c_held:
                            yield ctx.finding(
                                self.name, node,
                                f"'{cls.name}.{name}' calls '{meth}' while "
                                f"holding lock '{held}', and '{meth}' makes "
                                f"a blocking {what} — the lock is held "
                                f"across the block; move the call outside "
                                f"the critical section or bound it with a "
                                f"timeout")
                            break
