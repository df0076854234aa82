"""Audit-framework core: findings, the pass registry, waivers, the runner
(port of ``analysis/audit/core.py``).

The lint suite (``analysis/rules/``) guards the *source*; this framework
guards the *recorded programs*: the aten graphs (``graphs.trace``) of the
programs the port dispatches. The hazards are the JAX auditor's, read for
PyTorch (``passes.py``): a program that writes into a tensor it does not
own, padded rows reaching the IWAE ``logsumexp`` unmasked (a silently
biased bound, Burda et al. arXiv:1509.00519), a host round trip inside a
hot program, and call signatures that mint a CUDA graph per value.

It mirrors ``analysis/core.py``:

* a **pass** subclasses :class:`AuditPass`, registers via :func:`register`
  and yields :class:`AuditFinding`\\ s for one :class:`AuditProgram`;
* **waivers** are a program's suppressions, ``waivers={"pass-name": "why
  this is safe"}``; a waiver with an empty justification is itself a
  finding (``bare-waiver``), as the lint suite's mandatory ``-- why``;
* the **runner** (:func:`run_audit`) runs every pass over every program
  (JAX ``core.py:150-193``, without its telemetry: the CLIs report the
  findings and their counts themselves).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Type

#: finding id for a waiver with no justification text (not waivable itself)
BARE_WAIVER = "bare-waiver"


@dataclasses.dataclass(frozen=True, order=True)
class AuditFinding:
    """One pass violation in one recorded program (`location` is a node path
    like ``serve_score/aten.sum[41]``, or a named site such as
    ``signature`` / ``store:<name>``)."""

    program: str
    rule: str
    location: str
    message: str

    def human(self) -> str:
        return f"{self.program}: [{self.rule}] {self.location}: {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AuditProgram:
    """One recorded program under audit.

    `graph` is the ``torch.fx.GraphModule`` of ``graphs.trace``; `taints`
    maps placeholder index -> ``{axis: real_extent}`` (entries >= extent
    are padding); `sig_args` is the ``(args, kwargs)`` the caller hands the
    executable store's ``signature`` (the recompile-cardinality pass
    audits the key they make); `hot` marks per-step/per-dispatch programs
    (host-transfer scope); `captured` marks programs replayed from a CUDA
    graph on the card (the store's serving entries, the train step of
    ``training/epoch.py``), where a lifted tensor constant goes stale;
    `state_inputs` are the placeholder indices the program may write in
    place (the train step's parameters, gradients and Adam moments);
    `waivers` maps pass name ->
    justification; `error` holds why the program could not be recorded
    (``graph`` is then None and only the host-transfer pass reports).
    """

    name: str
    graph: object
    taints: Dict[int, Dict[int, Optional[int]]] = \
        dataclasses.field(default_factory=dict)
    sig_args: Optional[tuple] = None
    hot: bool = True
    captured: bool = False
    state_inputs: frozenset = frozenset()
    waivers: Dict[str, str] = dataclasses.field(default_factory=dict)
    error: Optional[str] = None


@dataclasses.dataclass
class AuditEnv:
    """Facts of the process the passes condition on (injectable, so
    fixtures audit counterfactual hosts)."""

    #: ``"cuda"`` or ``"cpu"``: where the port's programs would run
    device: str
    #: keys ``(model, name, build_key, signature)`` of the live executable
    #: store, or None to skip auditing them (fixture runs: the process
    #: store holds other tests' entries)
    store_keys: Optional[list] = None

    @staticmethod
    def current(include_store: bool = False) -> "AuditEnv":
        import torch

        from iwae_replication_project_tpu_torch.utils.compile_cache import (
            executable_store)
        return AuditEnv(
            device="cuda" if torch.cuda.is_available() else "cpu",
            store_keys=executable_store().keys() if include_store else None)


class AuditPass:
    """Base class. Subclasses set ``name``/``summary`` and implement
    :meth:`check`, yielding findings for one program. State across programs
    (the live store's keys) is audited in :meth:`check_env`, once per
    audit and outside the per-program waivers (one program's waiver must
    not silence a store-wide hazard)."""

    name: str = ""
    summary: str = ""

    def check(self, prog: AuditProgram, env: AuditEnv
              ) -> Iterator[AuditFinding]:
        raise NotImplementedError

    def check_env(self, env: AuditEnv) -> Iterator[AuditFinding]:
        return iter(())


_REGISTRY: Dict[str, AuditPass] = {}


def register(cls: Type[AuditPass]) -> Type[AuditPass]:
    if not cls.name:
        raise ValueError(f"pass {cls.__name__} has no name")
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate pass name {cls.name!r}")
    _REGISTRY[cls.name] = cls()
    return cls


def all_passes() -> Dict[str, AuditPass]:
    """Name -> pass instance (importing ``passes`` registers the built-ins)."""
    import iwae_replication_project_tpu_torch.analysis.audit.passes  # noqa: F401
    return dict(_REGISTRY)


def select_passes(select: Optional[Sequence[str]] = None
                  ) -> Dict[str, AuditPass]:
    passes = all_passes()
    if select:
        unknown = set(select) - set(passes)
        if unknown:
            raise ValueError(f"unknown pass(es): {sorted(unknown)}; "
                             f"known: {sorted(passes)}")
        passes = {n: p for n, p in passes.items() if n in select}
    return passes


def run_audit(programs: Sequence[AuditProgram],
              passes: Optional[Dict[str, AuditPass]] = None,
              env: Optional[AuditEnv] = None,
              progress: Optional[Callable[[str], None]] = None
              ) -> List[AuditFinding]:
    """Run every pass over every program; returns sorted findings.

    Waived findings are dropped; a waiver with no justification adds a
    ``bare-waiver`` finding instead.
    """
    passes = passes if passes is not None else all_passes()
    env = env or AuditEnv.current()
    findings: List[AuditFinding] = []

    for prog in programs:
        for pname, justification in prog.waivers.items():
            if pname in passes and not (justification or "").strip():
                findings.append(AuditFinding(
                    program=prog.name, rule=BARE_WAIVER, location="waivers",
                    message=f"waiver for pass '{pname}' has no justification"
                            f" — every silenced hazard must carry its "
                            f"argument"))

    for pname, p in passes.items():
        if progress:
            progress(pname)
        for prog in programs:
            got = list(p.check(prog, env))
            if not (prog.waivers.get(pname) or "").strip():
                findings.extend(got)
        # state across programs: once per pass, unwaivable per program
        findings.extend(p.check_env(env))

    return sorted(set(findings))


__all__ = ["BARE_WAIVER", "AuditEnv", "AuditFinding", "AuditPass",
           "AuditProgram", "all_passes", "register", "run_audit",
           "select_passes"]
