"""``iwae-cost`` for the port: memory, FLOP and collective cost of the
recorded programs (port of ``analysis/audit/cost.py``).

The auditor next door (``passes.py``) proves *safety* facts about the
recorded programs; this module computes their *cost* facts, statically,
from the same aten graphs (``graphs.trace``; ``mode="fake"`` records a
full-width program in seconds without allocating it). Three linked
passes per program:

1. **Live-range peak memory.** A linear scan over the nodes: the frame's
   inputs (placeholders and lifted constants) are resident for the whole
   call; a tensor's storage is born at the node that allocates it and dies
   after the last node that reads it or any of its views; a view or an
   in-place op (an aliasing schema, and ``_unsafe_view``, which reuses its
   fresh input) allocates nothing. Two figures:

   * ``peak_bytes`` counts what the card holds: each storage rounded up to
     the caching allocator's 512-byte blocks, and each kernel region
     (``graphs.trace`` stamps the ops of a kernel's plain version) charged
     as the card runs it, one kernel whose interior stays in registers and
     shared memory: only the storages it hands out allocate, plus its
     scratch (``scratch``: bytes per kernel, ``ops/_kernels.plan``'s on the
     card, else 0). This is JAX's ``pallas_call`` rule (VMEM-resident
     interiors), and the figure ``chip_smoke.py`` phase 19 holds against
     ``torch.cuda.max_memory_allocated``;
   * ``peak_bytes_plain`` counts every storage at its own size, as the
     plain versions run on the CPU.

   A ``memory-blowup`` finding fires when one intermediate (card model)
   exceeds ``DEFAULT_BLOWUP_FACTOR`` x the program's input bytes: the
   static form of the OOM class the k=5000 eval exists to avoid (O(chunk)
   memory, arXiv:1509.00519's evaluation).

2. **FLOPs and bytes.** ``mm``/``addmm``/``bmm``/``baddbmm``/``mv``/
   ``dot`` from their shapes (2 per multiply-add, ``utils/flops.py``'s
   convention), a kernel region with a declared ``flops`` (``row_dense``,
   whose plain version multiplies elementwise) at that count, elementwise
   ops and reductions one FLOP per element (an honest lower bound; data
   movement zero). ``bytes_accessed`` assumes no fusion (every op outside a
   kernel region round-trips memory; a region moves its own inputs and
   outputs once); ``bytes_accessed_fused`` counts program I/O only. The
   intensity interval against the card's ridge point
   (``utils/flops.peak_flops_for_card``/``peak_hbm_bytes_for_card``) gives
   the verdict; a card without a table row gives ``null``, never a guessed
   figure. Matmul FLOPs reconcile bit-exactly with ``utils/flops.py``
   (tests/test_torch_cost.py).

3. **Collectives** per mesh axis, from the recording mesh's nodes
   (``graphs.COLLECTIVE_OPS``): the sharded score's merge is one MAX and
   one SUM over sp, plus the SUM over the world that gathers the rows; a
   gather-shaped collective (``all_gather``, ``all_to_all``) is an
   ``accidental-allgather`` finding.

The CLI writes ``results/torch_cost_report.json``. Exit codes match the
lint and audit CLIs: **0** clean, **1** findings, **2** internal error.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.analysis.audit.core import (
    BARE_WAIVER,
    AuditFinding,
    AuditProgram,
)
from iwae_replication_project_tpu_torch.analysis.audit.graphs import (
    COLLECTIVE_OPS,
    NO_WORK,
    arg_value,
    op_name,
    schema_aliases,
    used_inputs,
    val,
)

#: gather-shaped collectives: each device materialises the gathered axis
_FLAGGED_COLLECTIVES = frozenset({
    "iwae_audit.all_gather", "_c10d_functional.all_gather_into_tensor",
    "c10d_functional.all_gather_into_tensor",
    "_c10d_functional.all_to_all_single",
})

RULE_MEMORY_BLOWUP = "memory-blowup"
RULE_ACCIDENTAL_GATHER = "accidental-allgather"

#: an intermediate this many times the program's inputs is a materialised
#: fan-out (the suite's honest worst case sits far below)
DEFAULT_BLOWUP_FACTOR = 16.0

#: the caching allocator's block: every allocation rounds up to it
BLOCK_BYTES = 512

#: the card the port targets, assumed (and said so) on a host without one
DEFAULT_CARD = "NVIDIA H100 80GB HBM3"

#: ops that move or alias data and compute nothing
_DATA_MOVEMENT = frozenset({
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.t",
    "aten.transpose", "aten.permute", "aten.unsqueeze", "aten.squeeze",
    "aten.expand", "aten.slice", "aten.select", "aten.alias",
    "aten.detach", "aten.clone", "aten.contiguous", "aten._to_copy",
    "aten.to", "aten.copy_", "aten.cat", "aten.stack", "aten.split",
    "aten.unbind", "aten.constant_pad_nd", "aten.new_zeros",
    "aten.zeros", "aten.zeros_like", "aten.full", "aten.full_like",
    "aten.empty", "aten.empty_like", "aten.ones", "aten.ones_like",
    "aten.lift_fresh_copy", "aten.scalar_tensor", "aten.arange",
    "aten.index_select", "aten.flip", "aten.movedim", "getitem",
    "aten.new_empty", "aten.new_full", "aten.new_ones",
    "aten._reshape_alias", "aten.as_strided", "aten.chunk",
})

_REDUCTIONS = frozenset({
    "aten.sum", "aten.mean", "aten.amax", "aten.amin", "aten.max",
    "aten.min", "aten.logsumexp", "aten.prod", "aten.argmax", "aten.argmin",
    "aten.var", "aten.std", "aten.norm", "aten.linalg_vector_norm",
})


@dataclasses.dataclass
class CostRecord:
    """Static cost facts of one recorded program (bytes of device memory)."""

    program: str
    input_bytes: int = 0
    #: the inputs as the card holds them (512-byte blocks)
    resident_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    peak_bytes_plain: int = 0
    largest_intermediate_bytes: int = 0
    largest_intermediate_site: str = ""
    flops: float = 0.0
    matmul_flops: float = 0.0
    bytes_accessed: float = 0.0        # no-fusion upper bound on traffic
    bytes_accessed_fused: float = 0.0  # perfect-fusion lower bound (I/O)
    #: op -> mesh axis -> {count, bytes}
    collectives: Dict[str, Dict[str, Dict[str, float]]] = \
        dataclasses.field(default_factory=dict)
    collective_bytes: float = 0.0
    #: kernel -> calls recorded (the kernel regions)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: the scratch charged for the largest kernel call
    scratch_bytes: int = 0

    @property
    def intensity(self) -> Optional[float]:
        """FLOPs per byte assuming no fusion (lower bound)."""
        return self.flops / self.bytes_accessed if self.bytes_accessed \
            else None

    @property
    def intensity_fused(self) -> Optional[float]:
        """FLOPs per byte at perfect fusion (upper bound)."""
        return self.flops / self.bytes_accessed_fused \
            if self.bytes_accessed_fused else None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["intensity"] = self.intensity
        d["intensity_fused"] = self.intensity_fused
        return d


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

def resolve_card(card: Optional[str] = None) -> Tuple[str, str]:
    """``(card name, source)`` for the roofline tables: ``--card`` wins; a
    host with a CUDA device contributes its name; any other host assumes
    the port's target card, with the assumption stamped."""
    if card:
        return card, "explicit --card"
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        return name, f"detected device {name!r}"
    return DEFAULT_CARD, (f"host has no CUDA device: assuming "
                          f"{DEFAULT_CARD!r} — pass --card to analyze for "
                          f"another card")


def roofline(record: CostRecord, card: str) -> dict:
    """The verdict: where the program's intensity interval sits against the
    card's ridge point, plus the matmul-FLOP ceiling the roofline admits."""
    from iwae_replication_project_tpu_torch.utils.flops import (
        peak_flops_for_card,
        peak_hbm_bytes_for_card,
    )

    peak, peak_src = peak_flops_for_card(card)
    bw, bw_src = peak_hbm_bytes_for_card(card)
    out = {"card": card, "peak_flops": peak, "hbm_bytes_per_s": bw}
    if peak is None or bw is None:
        out["verdict"] = None
        out["verdict_null_reason"] = peak_src if peak is None else bw_src
        return out
    ridge = peak / bw
    out["ridge_flops_per_byte"] = ridge
    lo, hi = record.intensity, record.intensity_fused
    if lo is not None and lo >= ridge:
        out["verdict"] = "compute-bound"
    elif hi is not None and hi <= ridge:
        out["verdict"] = "memory-bound"
    else:
        out["verdict"] = "fusion-dependent"
    denom = max(record.flops, record.bytes_accessed_fused * ridge)
    out["static_mfu_ceiling"] = record.matmul_flops / denom if denom else None
    return out


# ---------------------------------------------------------------------------
# graph helpers
# ---------------------------------------------------------------------------

def _tensors(v) -> List[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (list, tuple)):
        return [t for t in v if isinstance(t, torch.Tensor)]
    return []


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _blocks(n: int) -> int:
    """Bytes the caching allocator reserves for an `n`-byte tensor."""
    return max(BLOCK_BYTES, -(-n // BLOCK_BYTES) * BLOCK_BYTES) if n else 0


def _node_args(node) -> List[Any]:
    out = []
    for a in list(node.args) + list(node.kwargs.values()):
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.fx.Node))
    return out


def _shape(node) -> Tuple[int, ...]:
    v = val(node)
    return tuple(v.shape) if isinstance(v, torch.Tensor) else ()


def matmul_flops(node) -> float:
    """2 FLOPs per multiply-add of a contraction node (0 otherwise)."""
    name = op_name(node)
    if name in ("aten.mm", "aten.addmm"):
        a, b = (node.args[0], node.args[1]) if name == "aten.mm" \
            else (node.args[1], node.args[2])
        (m, k), n = _shape(a), _shape(b)[1]
        return 2.0 * m * k * n
    if name in ("aten.bmm", "aten.baddbmm"):
        a, b = (node.args[0], node.args[1]) if name == "aten.bmm" \
            else (node.args[1], node.args[2])
        bs, m, k = _shape(a)
        return 2.0 * bs * m * k * _shape(b)[2]
    if name in ("aten.mv", "aten.addmv"):
        a = node.args[0] if name == "aten.mv" else node.args[1]
        m, k = _shape(a)
        return 2.0 * m * k
    if name == "aten.dot":
        return 2.0 * _shape(node.args[0])[0]
    return 0.0


def _pointwise_flops(node) -> float:
    name = op_name(node)
    if name in _DATA_MOVEMENT or name in NO_WORK or \
            name in COLLECTIVE_OPS:
        return 0.0
    if name in _REDUCTIONS:
        return float(sum(t.numel() for a in node.args[:1]
                         if isinstance(a, torch.fx.Node)
                         for t in _tensors(val(a))))
    if name in ("aten.addmm", "aten.baddbmm", "aten.addmv"):
        return float(sum(t.numel() for t in _tensors(val(node))))
    if matmul_flops(node):
        return 0.0
    return float(sum(t.numel() for t in _tensors(val(node))))


class _Storages:
    """Storage identity over a graph (``key``: node -> its storages;
    ``size``: storage -> bytes; ``inputs``: the frame's)."""

    def __init__(self):
        self.key: Dict[Any, List[Tuple[Any, int]]] = {}
        self.size: Dict[Tuple[Any, int], int] = {}
        self.inputs: set = set()


def _storages(gm) -> _Storages:
    """A view, an in-place result and an ``_unsafe_view`` share their
    source's storage; every other tensor a node makes is a storage of its
    own, keyed ``(node, index)``."""
    st = _Storages()
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            v = val(node)
            if v is None and node.op == "get_attr":
                v = getattr(gm, str(node.target), None)
            ts = _tensors(v)
            st.key[node] = [(node, i) for i in range(len(ts))]
            for i, t in enumerate(ts):
                st.size[(node, i)] = _bytes(t)
                st.inputs.add((node, i))
            continue
        if node.op != "call_function":
            continue
        ts = _tensors(val(node))
        name = op_name(node)
        if name == "getitem":
            src, i = node.args
            keys = st.key.get(src, [])
            if schema_aliases(src)[0] is not None:
                st.key[node] = list(keys)       # a view of the split input
            else:
                st.key[node] = [keys[i]] if i < len(keys) else []
            continue
        if name == "aten._unsafe_view":
            st.key[node] = list(st.key.get(node.args[0], []))
            continue
        argi, _ = schema_aliases(node)
        src = arg_value(node, argi) if argi is not None else None
        if isinstance(src, torch.fx.Node):
            st.key[node] = list(st.key.get(src, []))
            continue
        if isinstance(src, (list, tuple)):
            st.key[node] = [k for s in src if isinstance(s, torch.fx.Node)
                            for k in st.key.get(s, [])]
            continue
        st.key[node] = [(node, i) for i in range(len(ts))]
        for i, t in enumerate(ts):
            st.size[(node, i)] = _bytes(t)
    return st


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------

class CostAnalyzer:
    """One analyzer = one configuration (blow-up threshold, scratch bytes
    per kernel); :meth:`analyze` is reusable across programs."""

    def __init__(self, blowup_factor: float = DEFAULT_BLOWUP_FACTOR,
                 scratch: Optional[Dict[str, int]] = None):
        self.blowup_factor = float(blowup_factor)
        self.scratch = dict(scratch or {})

    def analyze(self, prog: AuditProgram
                ) -> Tuple[CostRecord, List[AuditFinding]]:
        """Cost record + findings for one program, honouring its waivers
        with the audit framework's semantics (a justified waiver silences,
        a bare one is itself a finding)."""
        rec, findings = self.analyze_graph(prog.name, prog.graph)
        kept: List[AuditFinding] = []
        for rule, justification in prog.waivers.items():
            if rule in (RULE_MEMORY_BLOWUP, RULE_ACCIDENTAL_GATHER) and \
                    not (justification or "").strip():
                kept.append(AuditFinding(
                    program=prog.name, rule=BARE_WAIVER, location="waivers",
                    message=f"waiver for '{rule}' has no justification — "
                            f"every silenced hazard must carry its argument"))
        waived = {rule for rule, j in prog.waivers.items()
                  if (j or "").strip()}
        kept.extend(f for f in findings if f.rule not in waived)
        return rec, kept

    def analyze_graph(self, name: str, gm
                      ) -> Tuple[CostRecord, List[AuditFinding]]:
        """Analyze one recorded graph (no waiver filtering)."""
        rec = CostRecord(program=name)
        findings: List[AuditFinding] = []
        if gm is None:
            return rec, findings
        nodes = [n for n in gm.graph.nodes
                 if n.op in ("placeholder", "get_attr", "call_function",
                             "output")]
        st = _storages(gm)
        regions = self._regions(nodes)
        self._work(name, nodes, regions, st, rec, findings)
        rec.input_bytes = sum(st.size[k] for k in st.inputs)
        rec.resident_bytes = sum(_blocks(st.size[k]) for k in st.inputs)
        out = next(n for n in nodes if n.op == "output")
        outs = [o for o in _node_args(out)]
        rec.output_bytes = sum(_bytes(t) for o in outs
                               for t in _tensors(val(o)))
        # the traffic no schedule avoids: the inputs the program reads (a
        # weight it never reads is never fetched) and its outputs
        phs = [n for n in nodes if n.op == "placeholder"]
        used = {k for i in used_inputs(gm) for k in st.key.get(phs[i], [])}
        used |= {k for n in nodes if n.op == "get_attr" and n.users
                 for k in st.key.get(n, [])}
        rec.bytes_accessed_fused = float(sum(st.size[k] for k in used)
                                         + rec.output_bytes)
        rec.bytes_accessed = max(rec.bytes_accessed, rec.bytes_accessed_fused)
        rec.peak_bytes = self._peak(nodes, regions, st, rec, card=True)
        rec.peak_bytes_plain = self._peak(nodes, regions, st, rec,
                                          card=False)
        if rec.input_bytes and rec.largest_intermediate_bytes > \
                self.blowup_factor * rec.input_bytes:
            ratio = rec.largest_intermediate_bytes / rec.input_bytes
            findings.append(AuditFinding(
                program=name, rule=RULE_MEMORY_BLOWUP,
                location=rec.largest_intermediate_site,
                message=f"intermediate of "
                        f"{rec.largest_intermediate_bytes:,} bytes is "
                        f"{ratio:.1f}x the program's {rec.input_bytes:,} "
                        f"input bytes (threshold {self.blowup_factor:g}x) — "
                        f"a materialized fan-out this size is an OOM cliff "
                        f"at production k/batch; stream it through an "
                        f"online-logsumexp carry or a blocked kernel"))
        return rec, sorted(set(findings))

    # -- kernel regions -----------------------------------------------------

    @staticmethod
    def _regions(nodes) -> Dict[int, dict]:
        """``call id -> {kernel, meta, first, last}`` positions of each
        stamped kernel region."""
        regions: Dict[int, dict] = {}
        for i, n in enumerate(nodes):
            call = n.meta.get("kernel_call") if n.op == "call_function" \
                else None
            if call is None:
                continue
            r = regions.setdefault(call, {"kernel": n.meta["kernel"],
                                          "meta": n.meta.get("kernel_meta",
                                                             {}),
                                          "first": i, "last": i})
            r["last"] = i
        return regions

    # -- pass 2 + 3: flops, traffic, collectives -----------------------------

    def _work(self, name, nodes, regions, st, rec, findings) -> None:
        for r in regions.values():
            rec.kernel_calls[r["kernel"]] = \
                rec.kernel_calls.get(r["kernel"], 0) + 1
            flops = r["meta"].get("flops")
            if flops is not None:
                rec.flops += float(flops)
                rec.matmul_flops += float(flops)
            # a kernel moves its inputs and its outputs once
            inside = {n for n in nodes[r["first"]:r["last"] + 1]}
            io = set()
            for n in inside:
                for a in _node_args(n):
                    if a not in inside:
                        io.update(st.key.get(a, []))
                if any(u not in inside for u in n.users):
                    io.update(st.key.get(n, []))
            rec.bytes_accessed += float(sum(st.size.get(k, 0) for k in io))
        for i, node in enumerate(nodes):
            if node.op != "call_function":
                continue
            loc = f"{op_name(node)}[{i}]"
            oname = op_name(node)
            if oname in COLLECTIVE_OPS:
                self._collective(node, name, loc, rec, findings)
            call = node.meta.get("kernel_call")
            region = regions.get(call) if call is not None else None
            if region is not None and region["meta"].get("flops") is not None:
                continue        # counted at the region's declared FLOPs
            mm = matmul_flops(node)
            rec.flops += mm + _pointwise_flops(node)
            rec.matmul_flops += mm
            if region is None and oname not in _DATA_MOVEMENT \
                    and oname not in NO_WORK:
                rec.bytes_accessed += float(
                    sum(_bytes(t) for a in _node_args(node)
                        for t in _tensors(val(a)))
                    + sum(_bytes(t) for t in _tensors(val(node))))

    def _collective(self, node, name, loc, rec, findings) -> None:
        oname = op_name(node)
        if oname == "iwae_audit.all_reduce":
            key, axis = f"all_reduce.{node.args[1]}", str(node.args[2])
        elif oname == "iwae_audit.broadcast":
            key, axis = "broadcast", "world"
        elif oname == "iwae_audit.all_gather":
            key, axis = "all_gather", str(node.args[1])
        else:
            key, axis = oname.split(".", 1)[-1], "?"
        nbytes = float(sum(_bytes(t) for t in _tensors(val(node.args[0]))))
        slot = rec.collectives.setdefault(key, {}).setdefault(
            axis, {"count": 0.0, "bytes": 0.0})
        slot["count"] += 1.0
        slot["bytes"] += nbytes
        rec.collective_bytes += nbytes
        if oname in _FLAGGED_COLLECTIVES:
            findings.append(AuditFinding(
                program=name, rule=RULE_ACCIDENTAL_GATHER, location=loc,
                message=f"'{key}' over mesh axis ({axis}) materializes the "
                        f"gathered axis on every device ({int(nbytes):,} "
                        f"bytes per dispatch) — the sharded merge contract "
                        f"is reduction-shaped (one MAX and one SUM of "
                        f"per-row carries over sp); an accidental reshard "
                        f"here is a serving-latency cliff"))

    # -- pass 1: live-range peak memory -------------------------------------

    def timeline(self, prog: AuditProgram, card: bool = True
                 ) -> List[Tuple[str, int]]:
        """``(location, resident bytes)`` after each node: the live-bytes
        curve whose maximum (with the kernels' scratch) is the peak."""
        nodes = [n for n in prog.graph.graph.nodes
                 if n.op in ("placeholder", "get_attr", "call_function",
                             "output")]
        curve: List[Tuple[str, int]] = []
        self._peak(nodes, self._regions(nodes), _storages(prog.graph),
                   CostRecord(program=prog.name), card=card, curve=curve)
        return curve

    def _peak(self, nodes, regions, st, rec, card: bool,
              curve: Optional[list] = None) -> int:
        """Peak resident bytes over the frame (module docstring)."""
        size = (lambda k: _blocks(st.size[k])) if card \
            else (lambda k: st.size[k])
        inside: Dict[Any, int] = {}
        for call, r in regions.items():
            for n in nodes[r["first"]:r["last"] + 1]:
                inside[n] = call
        birth: Dict[Any, int] = {}
        last: Dict[Any, int] = {}
        escapes: set = set()
        pos = {n.name: i for i, n in enumerate(nodes)}
        meta = getattr(nodes[0].graph.owning_module, "meta", {}) \
            if nodes else {}
        deaths, watched = meta.get("deaths"), meta.get("watched", set())
        for i, n in enumerate(nodes):
            for k in st.key.get(n, []) if n.op == "call_function" else []:
                birth.setdefault(k, i)
            users = _node_args(n)
            for a in users:
                for k in st.key.get(a, []):
                    last[k] = max(last.get(k, -1), i)
                    # read outside the region that made it: it escapes
                    made = nodes[birth[k]] if k in birth else None
                    if made is not None and inside.get(made) is not None \
                            and inside.get(made) != inside.get(n):
                        escapes.add(k)
        if deaths is not None:
            # a storage lives until the program drops the last tensor on it
            # (graphs.trace's record), not only until its last read
            end = len(nodes) - 1
            for n in nodes:
                if n.op != "call_function" or n.name not in watched:
                    continue
                died = deaths.get(n.name)
                at = pos.get(died, end) if died is not None else end
                for k in st.key.get(n, []):
                    if k not in st.inputs:
                        last[k] = max(last.get(k, -1), at)
        charged = {k for k in birth if k not in st.inputs}
        if card:
            charged = {k for k in charged
                       if inside.get(nodes[birth[k]]) is None
                       or k in escapes}
        current = sum(size(k) for k in st.inputs)
        peak = current
        born_at: Dict[int, List[Any]] = {}
        dies_at: Dict[int, List[Any]] = {}
        for k in charged:
            born_at.setdefault(birth[k], []).append(k)
            dies_at.setdefault(max(last.get(k, birth[k]), birth[k]),
                               []).append(k)
        scratch_at: Dict[int, int] = {}
        if card:
            for r in regions.values():
                s = int(self.scratch.get(r["kernel"], 0))
                rec.scratch_bytes = max(rec.scratch_bytes, s)
                for i in range(r["first"], r["last"] + 1):
                    scratch_at[i] = max(scratch_at.get(i, 0), _blocks(s))
        largest, site = 0, ""
        for i in range(len(nodes)):
            new = born_at.get(i, [])
            current += sum(size(k) for k in new)
            for k in new:
                if st.size[k] > largest:
                    largest, site = st.size[k], \
                        f"{op_name(nodes[i])}[{i}]"
            peak = max(peak, current + scratch_at.get(i, 0))
            current -= sum(size(k) for k in dies_at.get(i, []))
            if curve is not None and nodes[i].op == "call_function":
                curve.append((f"{op_name(nodes[i])}[{i}]", current))
        if card:
            rec.largest_intermediate_bytes = largest
            rec.largest_intermediate_site = site
        return peak


# ---------------------------------------------------------------------------
# suite front door
# ---------------------------------------------------------------------------

def analyze_programs(include: Optional[List[str]] = None,
                     blowup_factor: float = DEFAULT_BLOWUP_FACTOR
                     ) -> Tuple[Dict[str, CostRecord], List[AuditFinding]]:
    """Cost records + findings for the audited suite (or a named subset;
    unknown names raise the suite's ValueError listing the valid ones)."""
    from iwae_replication_project_tpu_torch.analysis.audit.programs import (
        build_programs)

    analyzer = CostAnalyzer(blowup_factor=blowup_factor)
    records: Dict[str, CostRecord] = {}
    findings: List[AuditFinding] = []
    for prog in build_programs(include):
        rec, got = analyzer.analyze(prog)
        records[prog.name] = rec
        findings.extend(got)
    return records, findings


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m "
             "iwae_replication_project_tpu_torch.analysis.audit.cost",
        description="Cost analyzer over the port's recorded programs: "
                    "live-range peak memory as the card holds it, "
                    "FLOP/byte accounting with a roofline verdict, and "
                    "collectives per mesh axis (recorded on the CPU, "
                    "nothing run on the card).")
    p.add_argument("--format", choices=("human", "json"), default="human")
    p.add_argument("--programs", default=None,
                   help="comma-separated subset of the audited programs "
                        "(default: the full suite)")
    p.add_argument("--blowup-factor", type=float,
                   default=DEFAULT_BLOWUP_FACTOR,
                   help="memory-blowup threshold: flag any intermediate "
                        "larger than this multiple of the program's input "
                        "bytes (default %(default)s)")
    p.add_argument("--card", default=None,
                   help="card name for the roofline tables (default: this "
                        "host's card, or the H100 with the assumption "
                        "stamped)")
    p.add_argument("--out", default=None,
                   help="also write the per-program cost report JSON here "
                        "(the results/torch_cost_report.json artifact)")
    return p


def report_payload(records: Dict[str, CostRecord],
                   findings: List[AuditFinding], card: str,
                   card_source: str) -> dict:
    return {
        "card": {"name": card, "source": card_source},
        "programs": {
            name: {**rec.to_dict(), "roofline": roofline(rec, card)}
            for name, rec in records.items()},
        "findings": [f.to_dict() for f in findings],
        "counts": dict(Counter(f.rule for f in findings)),
        "total": len(findings),
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        include = [s.strip() for s in args.programs.split(",") if s.strip()] \
            if args.programs else None
        records, findings = analyze_programs(
            include, blowup_factor=args.blowup_factor)
        card, card_source = resolve_card(args.card)
        payload = report_payload(records, findings, card, card_source)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write("\n")
    except (ValueError, FileNotFoundError, OSError) as e:
        print(f"iwae-cost: error: {e}", file=sys.stderr)
        return 2
    except Exception:
        print("iwae-cost: internal error:", file=sys.stderr)
        traceback.print_exc()
        return 2

    if args.format == "json":
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.human())
        print(f"analyzed {len(records)} program(s) for {card} "
              f"({card_source})")
        print(f"  {'program':<24} {'peak MB':>9} {'plain MB':>9} "
              f"{'GFLOP':>9} {'matmul%':>8} {'AI (fus)':>9}  "
              f"verdict / collectives")
        for name, rec in records.items():
            rl = roofline(rec, card)
            coll = "; ".join(
                f"{op}[{ax}] x{int(c['count'])}"
                for op, axes in sorted(rec.collectives.items())
                for ax, c in sorted(axes.items())) or "-"
            pct = 100.0 * rec.matmul_flops / rec.flops if rec.flops else 0.0
            ai = rec.intensity_fused
            print(f"  {name:<24} {rec.peak_bytes / 1e6:>9.2f} "
                  f"{rec.peak_bytes_plain / 1e6:>9.2f} "
                  f"{rec.flops / 1e9:>9.3f} {pct:>7.1f}% "
                  f"{(ai if ai is not None else 0):>9.1f}  "
                  f"{rl.get('verdict')} / {coll}")
        if findings:
            tally = ", ".join(f"{rule}: {n}" for rule, n in
                              sorted(Counter(f.rule for f in findings)
                                     .items()))
            print(f"\n{len(findings)} finding(s) ({tally})")
        else:
            print("iwae-cost: clean")
    return 1 if findings else 0


__all__ = ["BLOCK_BYTES", "DEFAULT_BLOWUP_FACTOR", "DEFAULT_CARD",
           "RULE_ACCIDENTAL_GATHER", "RULE_MEMORY_BLOWUP", "CostAnalyzer",
           "CostRecord", "analyze_programs", "main", "matmul_flops",
           "report_payload", "resolve_card", "roofline"]


if __name__ == "__main__":
    sys.exit(main())
