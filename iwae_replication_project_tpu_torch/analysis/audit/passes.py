"""The built-in audit passes (port of ``passes.py``). Importing this module
registers all four, under the JAX auditor's names; each docstring says
what the JAX hazard means for the port's programs.

* ``donation-safety``: the port donates no buffer. Its train step writes
  the new state into the old state's tensors in place
  (``utils/config.JAX_ONLY_FIELDS``), so the hazard is a program writing
  in place into an input it does not own (anything outside its declared
  ``state_inputs``: the payload, the injected noise, the weights of a
  serving program), or a program whose output is one of its inputs (the
  caller would hold its own argument, and a captured program's input
  buffer). ``GraphProgram.__call__`` clones a replay's output out of the
  graph's static buffer (``utils/compile_cache.py``), pinned by a test.
* ``padding-taint``: the IWAE bound is one unmasked padded weight away from
  silent bias (``taint.py``).
* ``host-transfer``: a value read to the host inside a hot program
  (``aten._local_scalar_dense``: ``.item()``, ``.tolist()``, a branch on a
  tensor), a copy between the host and the card, or an op whose output
  shape depends on data (``nonzero``, ``masked_select``, ``unique``)
  stalls the launch stream on every dispatch and cannot be captured in a
  CUDA graph: the graph-level twin of the ``host-sync`` lint rule
  (``analysis/rules/host.py``). A read on a traced tensor stops the
  recording itself, so such a program arrives with ``error`` set.
* ``recompile-cardinality``: a Python number in the executable store's
  signature (``utils/compile_cache.signature``) mints one capture per
  value (the declared statics, k and the bucket, live in the build key);
  and a tensor constant lifted into a captured program from a closure is
  baked into the CUDA graph by address, stale once the name is rebound.
  The live store's keys are audited once per audit (JAX ``passes.py``
  :150-156).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from iwae_replication_project_tpu_torch.analysis.audit.core import (
    AuditEnv,
    AuditFinding,
    AuditPass,
    AuditProgram,
    register,
)
from iwae_replication_project_tpu_torch.analysis.audit.graphs import (
    arg_value,
    iter_nodes,
    mutated_args,
    op_name,
    placeholders,
    schema_aliases,
    tensor_constants,
    val,
)
from iwae_replication_project_tpu_torch.analysis.audit.taint import (
    TaintEngine,
)

#: ops that read a device value on the host or size their output by data
HOST_OPS = frozenset({
    "aten._local_scalar_dense", "aten.item", "aten.nonzero",
    "aten.nonzero_static", "aten.masked_select", "aten.unique",
    "aten._unique", "aten._unique2", "aten.unique_consecutive",
    "aten.unique_dim", "aten.is_nonzero", "aten.equal",
    "aten.repeat_interleave",
})

#: ops that copy between devices when their output's device differs
_COPY_OPS = frozenset({"aten._to_copy", "aten.to", "aten.copy_",
                       "aten._copy_from", "aten._copy_from_and_resize"})


def storage_root(node):
    """The placeholder or ``get_attr`` node whose storage `node` aliases
    (through views and in-place ops), or None for a fresh tensor."""
    seen = set()
    while node is not None and node not in seen:
        seen.add(node)
        if node.op in ("placeholder", "get_attr"):
            return node
        if node.op != "call_function":
            return None
        if op_name(node) == "getitem":
            src = node.args[0]
            if not (isinstance(src, torch.fx.Node) and schema_aliases(src)[0]
                    is not None):
                return None
            node = src
            continue
        argi, _ = schema_aliases(node)
        if argi is None:
            return None
        nxt = arg_value(node, argi)
        if isinstance(nxt, (list, tuple)):
            return None
        node = nxt if isinstance(nxt, torch.fx.Node) else None
    return None


@register
class DonationSafetyPass(AuditPass):
    name = "donation-safety"
    summary = ("no program writes in place into an input it does not own, "
               "and no output aliases an input (the port's donation "
               "hazard: it writes new state into old tensors)")

    def check(self, prog: AuditProgram, env: AuditEnv
              ) -> Iterator[AuditFinding]:
        gm = prog.graph
        if gm is None:
            return
        index = {n: i for i, n in enumerate(placeholders(gm))}
        for loc, node in iter_nodes(gm, prog.name):
            for i in mutated_args(node):
                target = arg_value(node, i)
                targets = target if isinstance(target, (list, tuple)) \
                    else [target]
                for t in targets:
                    if not isinstance(t, torch.fx.Node):
                        continue
                    root = storage_root(t)
                    if root is None:
                        continue
                    if root.op == "get_attr":
                        yield AuditFinding(
                            program=prog.name, rule=self.name, location=loc,
                            message=f"'{op_name(node)}' writes in place into "
                                    f"the closure tensor '{root.target}' — a "
                                    f"program must own what it writes; pass "
                                    f"the tensor in as declared state")
                    elif index[root] not in prog.state_inputs:
                        yield AuditFinding(
                            program=prog.name, rule=self.name, location=loc,
                            message=f"'{op_name(node)}' writes in place into "
                                    f"input #{index[root]} ('{root.name}'), "
                                    f"which is not among the program's "
                                    f"declared state inputs — the caller's "
                                    f"tensor (a payload, the noise, the "
                                    f"weights) is overwritten")
        out = next(n for n in gm.graph.nodes if n.op == "output")
        outs = out.args[0] if isinstance(out.args[0], (list, tuple)) \
            else [out.args[0]]
        for j, o in enumerate(outs):
            if not isinstance(o, torch.fx.Node):
                continue
            root = storage_root(o)
            if root is None or (root.op == "placeholder"
                                and index[root] in prog.state_inputs):
                continue
            what = f"input #{index[root]} ('{root.name}')" \
                if root.op == "placeholder" else \
                f"the closure tensor '{root.target}'"
            yield AuditFinding(
                program=prog.name, rule=self.name, location=f"output[{j}]",
                message=f"output #{j} aliases {what} — the caller gets a view "
                        f"of a tensor the program does not own (for a "
                        f"captured program, of the graph's static buffer); "
                        f"return a fresh tensor")


@register
class PaddingTaintPass(AuditPass):
    name = "padding-taint"
    summary = ("padded rows (declared inputs + constant_pad_nd) provably "
               "never reach a reduce/logsumexp/contraction unmasked")

    def check(self, prog: AuditProgram, env: AuditEnv
              ) -> Iterator[AuditFinding]:
        if prog.graph is None:
            return
        findings: List[AuditFinding] = []
        engine = TaintEngine(report=lambda loc, msg: findings.append(
            AuditFinding(program=prog.name, rule=self.name, location=loc,
                         message=msg)))
        engine.run(prog.graph, prog.taints, root=prog.name)
        yield from findings


def _device(v) -> Optional[str]:
    return v.device.type if isinstance(v, torch.Tensor) else None


@register
class HostTransferPass(AuditPass):
    name = "host-transfer"
    summary = ("no host read, host<->card copy or data-dependent shape "
               "inside hot programs — the graph-level twin of the "
               "host-sync lint rule")

    def check(self, prog: AuditProgram, env: AuditEnv
              ) -> Iterator[AuditFinding]:
        if not prog.hot:
            return
        if prog.graph is None:
            if prog.error:
                yield AuditFinding(
                    program=prog.name, rule=self.name, location="trace",
                    message=f"the program reads a device value on the host "
                            f"and cannot be recorded ({prog.error}) — every "
                            f"dispatch would stall on the transfer; keep the "
                            f"value on the device or move the read to the "
                            f"driver layer")
            return
        for loc, node in iter_nodes(prog.graph, prog.name):
            name = op_name(node)
            if name in HOST_OPS:
                yield AuditFinding(
                    program=prog.name, rule=self.name, location=loc,
                    message=f"'{name}' inside a hot program reads device "
                            f"data on the host (or sizes its output by it) "
                            f"on every dispatch — it stalls the launch "
                            f"stream and cannot be captured in a CUDA graph")
            elif name in _COPY_OPS:
                ins = [_device(val(a)) for a in node.args
                       if isinstance(a, torch.fx.Node)]
                out = _device(val(node))
                if out is not None and any(d is not None and d != out
                                           for d in ins):
                    yield AuditFinding(
                        program=prog.name, rule=self.name, location=loc,
                        message=f"'{name}' copies between devices "
                                f"({', '.join(sorted(set(filter(None, ins))))}"
                                f" -> {out}) inside a hot program — stage the "
                                f"transfer outside the program")


#: the Python types whose values mint a capture each
_NUMERIC = ("int", "float", "bool", "complex")


def signature_scalars(sig) -> List[tuple]:
    """``(leaf index, type name, repr)`` of every Python number in a
    ``utils/compile_cache.signature`` (its leaf grammar: a tensor is
    ``(shape, dtype, device)``, a list/tuple ``(type, *children)``, a dict
    ``("dict", (key, child), ...)``, anything else ``(type, repr)``)."""
    out: List[tuple] = []

    def walk(s):
        if not isinstance(s, tuple) or not s:
            return
        if len(s) == 3 and isinstance(s[0], tuple) and \
                isinstance(s[1], str) and isinstance(s[2], str):
            out.append(None)        # a tensor leaf
            return
        head = s[0]
        if head in ("list", "tuple") and isinstance(head, str):
            for c in s[1:]:
                walk(c)
        elif head == "dict":
            for _, c in s[1:]:
                walk(c)
        elif len(s) == 2 and isinstance(head, str):
            out.append((head, s[1]))

    for part in sig if isinstance(sig, tuple) else ():
        walk(part)
    return [(i, leaf[0], leaf[1]) for i, leaf in enumerate(out)
            if leaf is not None and leaf[0] in _NUMERIC]


@register
class RecompileCardinalityPass(AuditPass):
    name = "recompile-cardinality"
    summary = ("no Python number in the store's signature and no lifted "
               "tensor constant in a captured program")

    def check(self, prog: AuditProgram, env: AuditEnv
              ) -> Iterator[AuditFinding]:
        if prog.sig_args is not None:
            from iwae_replication_project_tpu_torch.utils.compile_cache \
                import signature
            args, kwargs = prog.sig_args
            yield from self._check_signature(prog.name, "signature",
                                             signature(args, kwargs))
        if prog.graph is not None and prog.captured:
            for name, t in tensor_constants(prog.graph):
                yield AuditFinding(
                    program=prog.name, rule=self.name,
                    location=f"get_attr:{name}",
                    message=f"tensor constant {tuple(t.shape)} {t.dtype} "
                            f"lifted from a closure into a captured program "
                            f"— the CUDA graph bakes its address in, so a "
                            f"new value under the same name is never seen; "
                            f"pass it as an argument (a static buffer)")

    def check_env(self, env: AuditEnv) -> Iterator[AuditFinding]:
        # the live store's keys: once per audit, behind no program's waiver
        for model, name, build_key, sig in (env.store_keys or ()):
            yield from self._check_signature(f"store:{model}/{name}",
                                             "store", sig)

    def _check_signature(self, program: str, loc: str, sig
                         ) -> Iterator[AuditFinding]:
        for i, tname, rep in signature_scalars(sig):
            yield AuditFinding(
                program=program, rule=self.name,
                location=f"{loc}:leaf[{i}]",
                message=f"python {tname} scalar ({rep}) in the dispatch "
                        f"signature — the executable store captures one "
                        f"graph PER VALUE; make it a tensor or a declared "
                        f"static in the build key")


__all__ = ["HOST_OPS", "DonationSafetyPass", "HostTransferPass",
           "PaddingTaintPass", "RecompileCardinalityPass",
           "signature_scalars", "storage_root"]
