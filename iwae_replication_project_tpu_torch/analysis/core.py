"""Lint-framework core: findings, the rule registry, suppressions, the runner
(port of ``analysis/core.py``).

The port's serving stack is a system of threads (dispatcher, completion,
connection readers, router callbacks, the fleet's controller) around a
budgeted store of captured programs. Its hazards do not raise: two locks
taken in opposite orders deadlock only under the right interleaving, a
future that is never completed is a request that never answers, and a
dropped exception turns a failure into silence. Static rules over the AST
are the guard that runs before any schedule finds them.

Design:

* a **rule** is a subclass of :class:`Rule` registered via :func:`register`;
  its ``check(ctx)`` yields :class:`Finding`s for one parsed file;
* **suppression** is per-line, per-rule:
  ``# iwaelint: disable=rule-a,rule-b -- why this is safe`` on the flagged
  line (or ``disable-file=`` on its own line for whole-file scope), the
  JAX package's grammar letter for letter, so a suppression reads the same
  in both packages. The justification after ``--`` is mandatory: a
  suppression without one is itself a finding (``bare-suppression``), so
  every silenced hazard carries its argument in the diff;
* the **runner** (:func:`lint_paths`) walks files, parses once, runs every
  enabled rule, applies suppressions, and returns findings sorted by
  location; the CLI layers output formatting and exit codes on top.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import (
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    Type,
)

from iwae_replication_project_tpu_torch.analysis.config import LintConfig

#: suppression comment grammar (the `--` separator guards the justification)
_SUPPRESS_RE = re.compile(
    r"#\s*iwaelint:\s*disable(?P<scope>-file)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_,\s-]+?)"
    r"(?:\s*--\s*(?P<why>\S.*))?\s*$")

#: meta-rule id for suppressions missing a justification (not suppressible)
BARE_SUPPRESSION = "bare-suppression"
#: meta-rule id for suppressions whose rule would not have fired where they
#: sit (not suppressible) — keeps the justified-suppression inventory honest
#: as code moves: a stale suppression is a pre-authorized future hazard
USELESS_SUPPRESSION = "useless-suppression"
#: pseudo-rule id for files the parser rejects
PARSE_ERROR = "parse-error"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at one source location (1-based line, 0-based col)."""

    path: str
    line: int
    col: int
    rule: str
    message: str

    def human(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class FileContext:
    """Everything a rule may look at for one file: source, AST, config, and
    the file's path relative to the lint root (posix separators, so rule
    config like ``hot_paths`` matches identically on every OS)."""

    def __init__(self, path: str, rel_path: str, source: str,
                 tree: ast.Module, config: LintConfig):
        self.path = path
        self.rel_path = rel_path.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.config = config

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(path=self.rel_path, line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), rule=rule,
                       message=message)


class Rule:
    """Base class for lint rules. Subclasses set ``name`` (the registry id and
    the token used in suppression comments) and ``summary`` (one line for
    ``--list-rules``), and implement :meth:`check`."""

    name: str = ""
    summary: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    # -- shared AST helpers -------------------------------------------------

    @staticmethod
    def call_name(node: ast.Call) -> str:
        """Dotted name of a call's callee ('' when not a plain name chain):
        ``self._lock.acquire()`` -> ``"self._lock.acquire"``."""
        return Rule.dotted(node.func)

    @staticmethod
    def dotted(node: ast.AST) -> str:
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return ""

    @staticmethod
    def terminal(name: str) -> str:
        """Last attribute of a dotted name: ``a.b.c`` -> ``c``."""
        return name.rsplit(".", 1)[-1] if name else ""


_REGISTRY: Dict[str, Rule] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    """Class decorator adding a rule (by its ``name``) to the registry."""
    if not cls.name:
        raise ValueError(f"rule {cls.__name__} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate rule name {cls.name!r}")
    _REGISTRY[cls.name] = cls()
    return cls


def all_rules() -> Dict[str, Rule]:
    """Name -> rule instance for every registered rule (import side effect of
    the ``rules`` package registers the built-ins)."""
    import iwae_replication_project_tpu_torch.analysis.rules  # noqa: F401
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Suppression:
    line: int            # 1-based source line the comment sits on
    rules: List[str]     # rule names (or ["all"])
    file_scope: bool
    justified: bool

    def covers(self, rule: str) -> bool:
        return rule not in (BARE_SUPPRESSION, USELESS_SUPPRESSION) and \
            ("all" in self.rules or rule in self.rules)


def parse_suppressions(source: str) -> List[Suppression]:
    out: List[Suppression] = []
    for i, text in _comments(source):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        rules = [r.strip() for r in m.group("rules").split(",") if r.strip()]
        out.append(Suppression(line=i, rules=rules,
                               file_scope=m.group("scope") is not None,
                               justified=bool(m.group("why"))))
    return out


def _comments(source: str) -> List[Tuple[int, str]]:
    """``(lineno, text)`` for every real COMMENT token. Tokenizing (instead
    of a per-line regex) keeps suppression grammar shown inside docstrings —
    this module's own, for one — from parsing as live suppressions."""
    try:
        return [(tok.start[0], tok.string)
                for tok in tokenize.generate_tokens(io.StringIO(source)
                                                    .readline)
                if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # un-tokenizable source never reaches the rules either (parse-error);
        # fall back to the line scan so suppression *parsing* stays total
        return list(enumerate(source.splitlines(), start=1))


def apply_suppressions(findings: Iterable[Finding], sups: List[Suppression],
                       rel_path: str,
                       active_rules: Optional[set] = None,
                       complete_run: bool = False,
                       known_rules: Optional[set] = None) -> List[Finding]:
    """Drop suppressed findings; add a ``bare-suppression`` finding for every
    suppression comment with no ``-- justification`` tail, and a
    ``useless-suppression`` finding for every suppressed rule that did not
    actually fire at the suppression's scope.

    `active_rules` is the set of rule names that RAN on this file: a token
    is only judged useless when its rule had the chance to fire (a
    ``--select`` subset must not condemn the other rules' suppressions).
    An ``all`` token can only be judged when EVERY registered rule ran
    (`complete_run`): under any subset, a rule the subset skipped may be
    what the suppression exists for. A token naming NO registered rule at
    all (`known_rules`: misspelled, or the rule was renamed/removed) is
    reported unconditionally — it can never become live, so no run subset
    can vindicate it.
    """
    file_rules = [(i, s) for i, s in enumerate(sups) if s.file_scope]
    by_line: Dict[int, List[Tuple[int, Suppression]]] = {}
    for i, s in enumerate(sups):
        if not s.file_scope:
            by_line.setdefault(s.line, []).append((i, s))
    used: List[set] = [set() for _ in sups]

    kept: List[Finding] = []
    for f in findings:
        matched = False
        for i, s in file_rules:
            if s.covers(f.rule):
                used[i].add(f.rule)
                matched = True
        for i, s in by_line.get(f.line, []):
            if s.covers(f.rule):
                used[i].add(f.rule)
                matched = True
        if not matched:
            kept.append(f)
    for i, s in enumerate(sups):
        if not s.justified:
            kept.append(Finding(
                path=rel_path, line=s.line, col=0, rule=BARE_SUPPRESSION,
                message="suppression has no justification; write "
                        "'# iwaelint: disable=<rule> -- <why this is safe>'"))
        for token in s.rules:
            if token == "all":
                if complete_run and not used[i]:
                    kept.append(Finding(
                        path=rel_path, line=s.line, col=0,
                        rule=USELESS_SUPPRESSION,
                        message="'disable=all' suppresses nothing here — "
                                "no rule fires at this scope; remove it"))
            elif known_rules is not None and token not in known_rules:
                kept.append(Finding(
                    path=rel_path, line=s.line, col=0,
                    rule=USELESS_SUPPRESSION,
                    message=f"suppression names unknown rule '{token}' — "
                            f"misspelled or removed; it can never fire, so "
                            f"this suppression suppresses nothing"))
            elif active_rules is not None and token in active_rules \
                    and token not in used[i]:
                scope = "file" if s.file_scope else "line"
                kept.append(Finding(
                    path=rel_path, line=s.line, col=0,
                    rule=USELESS_SUPPRESSION,
                    message=f"suppression of '{token}' is useless: the rule "
                            f"does not fire on this {scope} — remove it (a "
                            f"stale suppression silently pre-authorizes the "
                            f"next real violation here)"))
    return kept


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def iter_python_files(paths: Sequence[str], config: LintConfig,
                      root: str) -> Iterator[str]:
    """Expand files/dirs into .py files, honoring config.exclude (matched
    against root-relative posix paths as substrings)."""
    def excluded(p: str) -> bool:
        rel = os.path.relpath(p, root).replace(os.sep, "/")
        return any(pat in rel for pat in config.exclude)

    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            if p.endswith(".py") and not excluded(p):
                yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__"
                                     and not d.startswith(".")
                                     and not excluded(os.path.join(dirpath, d)))
                for fname in sorted(filenames):
                    full = os.path.join(dirpath, fname)
                    if fname.endswith(".py") and not excluded(full):
                        yield full
        else:
            raise FileNotFoundError(f"lint target does not exist: {p}")


def lint_file(path: str, config: LintConfig, root: Optional[str] = None,
              rules: Optional[Dict[str, Rule]] = None) -> List[Finding]:
    root = root or config.root or os.getcwd()
    rel = os.path.relpath(os.path.abspath(path), root)
    with open(path, "r", encoding="utf-8") as f:
        source = f.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path=rel.replace(os.sep, "/"),
                        line=e.lineno or 1, col=(e.offset or 1) - 1,
                        rule=PARSE_ERROR, message=f"syntax error: {e.msg}")]
    ctx = FileContext(path, rel, source, tree, config)
    active = rules if rules is not None else enabled_rules(config)
    findings: List[Finding] = []
    for rule in active.values():
        findings.extend(rule.check(ctx))
    findings = apply_suppressions(
        findings, parse_suppressions(source), ctx.rel_path,
        active_rules=set(active),
        complete_run=set(active) == set(all_rules()),
        known_rules=(set(all_rules()) |
                     {BARE_SUPPRESSION, USELESS_SUPPRESSION, PARSE_ERROR}))
    # one finding per (rule, location): visitors that re-walk loop bodies to
    # model second iterations would otherwise duplicate
    return sorted(set(findings))


def enabled_rules(config: LintConfig) -> Dict[str, Rule]:
    rules = all_rules()
    unknown = (set(config.select or []) | set(config.disable)) - set(rules)
    if unknown:
        raise ValueError(f"unknown rule(s) in config: {sorted(unknown)}; "
                         f"known: {sorted(rules)}")
    if config.select:
        rules = {n: r for n, r in rules.items() if n in config.select}
    return {n: r for n, r in rules.items() if n not in config.disable}


def lint_paths(paths: Sequence[str], config: Optional[LintConfig] = None,
               root: Optional[str] = None) -> List[Finding]:
    """Lint files/directories; returns all findings sorted by location."""
    config = config or LintConfig()
    root = root or config.root or os.getcwd()
    rules = enabled_rules(config)
    findings: List[Finding] = []
    for path in iter_python_files(paths, config, root):
        findings.extend(lint_file(path, config, root=root, rules=rules))
    return sorted(findings)
