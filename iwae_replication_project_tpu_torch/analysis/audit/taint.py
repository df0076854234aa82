"""Padding-taint dataflow over aten graphs (port of ``taint.py``).

The IWAE estimator is an average of ``K`` importance weights through a
``logsumexp`` (Burda et al., arXiv:1509.00519): ONE unmasked padded weight
entering that reduction biases the bound silently, since ``exp(0) = 1`` is
a plausible weight. The same holds for every padded axis the port makes:
the engines' bucket padding (rows of the payload and of the injected
noise) and the zero padding the fixed-order plain versions add to a
contraction (``ops/row_invariant.matmul_in_slabs``).

Model: a **taint** maps an axis to ``(extent, zero)``: indices ``>=
extent`` along the axis may be padding (``None``: the whole axis is
suspect), and ``zero`` says the padded entries are exact zeros. The key
:data:`WHOLE` marks a value that may be padding through and through (a row
selected past the real extent, the unit the row-by-row plain versions
work on). Taint enters a program two ways:

* declared on program inputs (the serving programs declare the payload
  and each layer's noise, ``serving/programs.PADDED_ROW_KWARGS``);
* seeded at every ``aten.constant_pad_nd`` (zero padding when the pad
  value is 0).

**Discharges**: ``aten.where`` whose condition compares an ``arange``
along the tainted axis with the real extent, with the polarity checked
(the case the padded region selects must be clean there), and
``masked_fill`` with a mask True on the padded region; a literal bound is
checked against the extent (``arange < padded_size`` keeps the padding
and discharges nothing), a tensor bound is trusted and counted
(``unverified-mask-discharges``); and a ``slice`` that cuts the padded
tail off.

A **finding** is a combining op over a still-tainted axis: a reduction
(``sum``/``mean``/``amax``/``logsumexp``/...; a sum over zero padding adds
exact zeros and passes), a contraction (``mm``/``addmm``/``bmm``: passes
when the padding it meets is zero on the operand that is padded
earliest), a reverse cumulation (``cumsum`` of a flipped axis folds the
padded tail into every real row), or an elementwise op that combines a
:data:`WHOLE` padded value with real data (the unrolled form of a
reduction, ``acc = acc + x[r]``; adding zero padding passes).

**Views and in-place writes.** A graph from ``make_fx`` is not
functional: ``out[a:b] = y`` records a ``slice`` view of ``out`` and a
``copy_`` into it, and later reads name ``out``. The engine therefore
keeps each view's parent: a view's taint is derived from its parent's at
every read, and an in-place write (``copy_``, ``add_``, an ``out=``
argument) carries the written taint back through the views into the
tensor that owns the storage (union, so a write never clears taint).

There is no opaque-kernel rule (JAX's ``pallas_call`` boundary): on CPU
tensors every kernel wrapper computes its plain version, so the graph
holds the kernels' arithmetic as aten ops and the engine follows it
exactly. Ops with no rule keep the taint of an input axis whose size
matches at the same position and otherwise make every axis suspect,
counted as ``default-propagation``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.analysis.audit.graphs import (
    arg_value,
    mutated_args,
    op_name,
    placeholders,
    schema_aliases,
    val,
)

#: the key of a taint that covers the whole value
WHOLE = "whole"

#: (extent, zero) of one axis, or a :class:`Split`
Entry = Any
#: axis (or WHOLE) -> entry
Taint = Dict[Any, Entry]

_ZERO_KEEP = {"aten.neg", "aten.clone", "aten._to_copy", "aten.to",
              "aten.contiguous", "aten.detach", "aten.alias", "aten.abs",
              "aten.relu", "aten.tanh", "aten.sin", "aten.sinh",
              "aten.atan", "aten.asin", "aten.sqrt", "aten.square",
              "aten.lift_fresh_copy", "aten.sign", "aten.sgn",
              "aten.expm1", "aten.log1p", "aten.erf", "aten.trunc",
              "aten.floor", "aten.ceil", "aten.round"}

#: elementwise ops (scalars ride along); the zero rule per kind
_ADDITIVE = {"aten.add", "aten.add_", "aten.sub", "aten.sub_",
             "aten.rsub", "aten.where", "aten.maximum", "aten.minimum",
             "aten.clamp", "aten.clamp_min", "aten.clamp_max",
             "aten.addcmul", "aten.addcdiv", "aten.lerp", "aten.fmax",
             "aten.fmin", "aten.copysign", "aten.hypot", "aten.atan2"}
_MULTIPLICATIVE = {"aten.mul", "aten.mul_", "aten.div", "aten.div_"}
_ELEMENTWISE = _ZERO_KEEP | _ADDITIVE | _MULTIPLICATIVE | {
    "aten.exp", "aten.log", "aten.sigmoid", "aten.softplus",
    "aten.tanh_backward", "aten.sigmoid_backward", "aten.reciprocal",
    "aten.rsqrt", "aten.pow", "aten.isfinite", "aten.isinf", "aten.isnan",
    "aten.logical_not", "aten.bitwise_not", "aten.logical_and",
    "aten.bitwise_and", "aten.logical_or", "aten.bitwise_or",
    "aten.eq", "aten.ne", "aten.lt", "aten.le", "aten.gt", "aten.ge",
    "aten.exp2", "aten.log2", "aten.log10", "aten.cos", "aten.cosh",
    "aten.neg_", "aten.tanh_", "aten.exp_", "aten.clamp_min_",
    "aten.fill", "aten.softplus_backward", "aten.threshold_backward",
    "aten.nan_to_num", "aten.xlogy", "aten.logaddexp", "aten.remainder",
    "aten.fmod", "aten.bitwise_xor", "aten.logical_xor",
    "aten.masked_fill", "aten.masked_fill_", "aten.where_",
    "iwae_audit.all_reduce", "iwae_audit.broadcast",
    "_c10d_functional.all_reduce", "_c10d_functional.broadcast",
    "_c10d_functional.wait_tensor"}

#: reductions: the reduced axes combine every index, the hazard this pass
#: exists for; a sum over exact-zero padding adds nothing and passes
_SUM_LIKE = {"aten.sum", "aten.nansum"}
_REDUCES = _SUM_LIKE | {"aten.mean", "aten.amax", "aten.amin", "aten.max",
                        "aten.min", "aten.logsumexp", "aten.prod",
                        "aten.argmax", "aten.argmin", "aten.var",
                        "aten.std", "aten.var_mean", "aten.std_mean",
                        "aten.norm", "aten.linalg_vector_norm",
                        "aten.any", "aten.all", "aten.median",
                        "aten.nanmean"}
_CUMULATIVE = {"aten.cumsum", "aten.cumprod", "aten.logcumsumexp",
               "aten.cummax", "aten.cummin"}
_CONTRACT = {"aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm",
             "aten.mv", "aten.dot", "aten.addmv"}

#: fresh tensors whose values depend on no tainted input
_FRESH = {"aten.zeros", "aten.ones", "aten.full", "aten.empty",
          "aten.empty_strided", "aten.zeros_like", "aten.ones_like",
          "aten.full_like", "aten.empty_like", "aten.new_zeros",
          "aten.new_ones", "aten.new_full", "aten.new_empty",
          "aten.randn", "aten.rand", "aten.randint", "aten.randn_like",
          "aten.rand_like", "aten.normal", "aten.normal_", "aten.uniform_",
          "aten.bernoulli", "aten.scalar_tensor", "aten.randperm",
          "aten.zero_", "aten.fill_", "aten.random_"}

#: comparisons that mint a polarity-carrying mask from an arange operand
_CMP = {"aten.lt", "aten.le", "aten.gt", "aten.ge"}
#: structural ops a raw arange mark rides through
_MARK_KEEP = {"aten._to_copy", "aten.to", "aten.clone", "aten.detach",
              "aten.alias", "aten.contiguous", "aten.lift_fresh_copy"}


@dataclasses.dataclass(frozen=True)
class Split:
    """The entry of an axis that merges several (a reshape of ``[k, B, H]``
    into ``[k*B, H]`` before a matmul): the merged axes' sizes, row-major,
    and the plain entry of each tainted one. A reshape back into the same
    sizes recovers the entries exactly."""

    sizes: Tuple[int, ...]
    subs: Tuple[Tuple[int, Optional[int], bool], ...]

    def plain(self) -> Tuple[Optional[int], bool]:
        """The first flat index that may be padding (row-major), which
        covers every padded index, and whether all padding is zeros."""
        flat, zero = None, True
        for sub, ext, z in self.subs:
            stride = math.prod(self.sizes[sub + 1:])
            start = 0 if ext is None else ext * stride
            flat = start if flat is None else min(flat, start)
            zero = zero and z
        if flat == 0 and any(ext is None for _, ext, _ in self.subs):
            return None, zero
        return flat, zero


def plain(e) -> Tuple[Optional[int], bool]:
    """``(extent, zero)`` of any entry."""
    return e.plain() if isinstance(e, Split) else e


def _lower(a: Optional[int], b: Optional[int]) -> bool:
    """Whether extent `a` starts the padding no later than `b`."""
    if a is None:
        return True
    return b is not None and a <= b


def _min_ext(a: Optional[int], b: Optional[int]) -> Optional[int]:
    return a if _lower(a, b) else b


def _merge(a, b, rule: str):
    """Union of two entries of one axis under a zero rule: ``mul`` (the
    product is zero where the earlier-padded operand is zero), ``add``
    (zero only where every operand is) or ``keep``."""
    if a is None or b is None:
        e = a if b is None else b
        if rule != "add":
            return e
        if isinstance(e, Split):
            return Split(e.sizes, tuple((s, x, False) for s, x, _ in e.subs))
        return e[0], False
    if isinstance(a, Split) and isinstance(b, Split) and a.sizes == b.sizes:
        subs = {s: (x, z) for s, x, z in a.subs}
        for s, x, z in b.subs:
            subs[s] = _merge(subs.get(s), (x, z), rule)
        return Split(a.sizes, tuple((s,) + tuple(subs[s])
                                    for s in sorted(subs)))
    a, b = plain(a), plain(b)
    ext = _min_ext(a[0], b[0])
    if rule == "mul" and a[0] != b[0]:
        zero = a[1] if _lower(a[0], b[0]) else b[1]
    elif rule == "mul":
        zero = a[1] or b[1]
    else:
        zero = a[1] and b[1]
    return ext, zero


def union(*taints: Taint, rule: str = "keep") -> Taint:
    """Axis-wise union of taints already aligned to one rank."""
    out: Taint = {}
    for key in set().union(*taints) if taints else set():
        entry, seen = None, False
        for t in taints:
            e = t.get(key)
            if not seen:
                entry, seen = e, True
                continue
            if entry is not None or e is not None:
                entry = _merge(entry, e, rule)
        if entry is not None:
            out[key] = entry
    return out


def _shift(t: Taint, by: int) -> Taint:
    """Taint of a value broadcast to `by` more leading axes."""
    return {(k + by if isinstance(k, int) else k): e for k, e in t.items()}


@dataclasses.dataclass
class TaintStats:
    """Honesty counters: how often the engine had to approximate."""

    default_propagation: int = 0
    #: mask discharges whose bound was a tensor the engine could not read
    #: statically: the runtime parity tests' jurisdiction, counted
    unverified_mask_discharges: int = 0


class TaintEngine:
    """One propagation over one graph.

    `report(location, message)` is called for every unmasked combine over a
    tainted axis, deduplicated by (location, message).
    """

    def __init__(self, report: Callable[[str, str], None]):
        self._seen: set = set()
        self._report = report
        self.stats = TaintStats()

    def finding(self, loc: str, msg: str) -> None:
        if (loc, msg) not in self._seen:
            self._seen.add((loc, msg))
            self._report(loc, msg)

    @staticmethod
    def _fmt(t: Taint, axis) -> str:
        ext, zero = plain(t[axis])
        what = "padding" if not zero else "zero padding"
        if axis == WHOLE:
            return "a value that may be padding throughout"
        return f"axis {axis} ({what} at indices >= {ext})" \
            if ext is not None else f"axis {axis} (padded region unknown)"

    # -- the walk -----------------------------------------------------------

    def run(self, gm, input_taints: Dict[int, Dict[int, Optional[int]]],
            root: str = "") -> List[Taint]:
        """Propagate; returns the taint of each output of the graph.
        `input_taints` maps placeholder index -> ``{axis: extent}``."""
        self._taint: Dict[Any, Taint] = {}
        self._marks: Dict[Any, set] = {}
        self._parent: Dict[Any, Any] = {}
        #: in-place results: the same tensor as their parent
        self._same: set = set()
        for i, ph in enumerate(placeholders(gm)):
            spec = input_taints.get(i)
            if spec:
                self._taint[ph] = {ax: (ext, False)
                                   for ax, ext in spec.items()}
        outputs: List[Taint] = []
        for idx, node in enumerate(gm.graph.nodes):
            if node.op == "call_function":
                loc = f"{op_name(node)}[{idx}]"
                self._node(node, f"{root}/{loc}" if root else loc)
            elif node.op == "output":
                outs = node.args[0]
                outs = outs if isinstance(outs, (list, tuple)) else [outs]
                outputs = [self.rd(o) if isinstance(o, torch.fx.Node)
                           else {} for o in outs]
        return outputs

    def rd(self, n) -> Taint:
        """The node's taint now (a view's from its parent's)."""
        if not isinstance(n, torch.fx.Node):
            return {}
        parent = self._parent.get(n)
        if parent is None:
            return self._taint.get(n, {})
        if n in self._same:
            return self.rd(parent)
        return self._view(n, self.rd(parent))

    # -- per-node transfer --------------------------------------------------

    def _node(self, node, loc: str) -> None:
        name = op_name(node)
        out = val(node)
        if name == "getitem":
            src, i = node.args
            got = self._taint.get(src)
            if isinstance(got, list) and i < len(got):
                self._taint[node] = got[i]
            return
        if name in ("aten.split", "aten.split_with_sizes", "aten.unbind",
                    "aten.chunk"):
            self._taint[node] = self._split(node, name)
            return
        argi, writes = schema_aliases(node)
        if argi is not None and not writes and isinstance(out, torch.Tensor):
            parent = arg_value(node, argi)
            if isinstance(parent, torch.fx.Node):
                self._parent[node] = parent
                self._marks[node] = self._view_marks(node,
                                                     self._rm(parent))
                return
        if isinstance(out, (list, tuple)) and (name in _REDUCES
                                               or name in _CUMULATIVE):
            t, _ = self._transfer(node, name, loc, [])
            self._taint[node] = [t] * len(out)
            return
        if not isinstance(out, torch.Tensor):
            if mutated_args(node):
                self._inplace_lists(node)
            return
        result, marks = self._transfer(node, name, loc, [
            self.rd(a) for a in self._tensor_args(node)])
        if marks:
            self._marks[node] = marks
        muts = mutated_args(node)
        if muts:
            target = arg_value(node, muts[0])
            if isinstance(target, torch.fx.Node):
                self._write(target, result)
                self._parent[node] = target
                self._same.add(node)
                return
        if result:
            self._taint[node] = result

    def _tensor_args(self, node) -> List[Any]:
        """Tensor arguments, an ``out=`` buffer left out."""
        out = []
        for key, a in [(None, a) for a in node.args] + list(
                node.kwargs.items()):
            if key == "out":
                continue
            if isinstance(a, torch.fx.Node) and isinstance(val(a),
                                                           torch.Tensor):
                out.append(a)
        return out

    def _rank(self, n) -> int:
        v = val(n)
        return v.dim() if isinstance(v, torch.Tensor) else 0

    def _aligned(self, node) -> List[Tuple[Any, Taint]]:
        """``(arg node, taint)`` of each tensor argument broadcast to the
        output's rank (trailing axes align)."""
        rank = self._rank(node)
        return [(a, _shift(self.rd(a), rank - self._rank(a)))
                for a in self._tensor_args(node)]

    def _transfer(self, node, name: str, loc: str, tin: List[Taint]
                  ) -> Tuple[Taint, set]:
        if name in _FRESH or name == "aten.arange":
            marks = {0} if name == "aten.arange" else set()
            return {}, marks
        if name in ("aten.where", "aten.masked_fill", "aten.masked_fill_"):
            return self._select(node, name, loc), set()
        if name in _CMP:
            return self._elementwise(node, name, loc), self._cmp_marks(node,
                                                                       name)
        if name in ("aten.logical_not", "aten.bitwise_not"):
            marks = {(ax, "high" if pol == "low" else "low", th)
                     for ax, pol, th in self._bool(self._rm(node.args[0]))}
            return self._elementwise(node, name, loc), marks
        if name in ("aten.logical_and", "aten.bitwise_and", "aten.logical_or",
                    "aten.bitwise_or"):
            return self._elementwise(node, name, loc), \
                self._bool_marks(node, name)
        if name in _MARK_KEEP:
            return self._elementwise(node, name, loc), \
                self._rm(node.args[0])
        if name in _ELEMENTWISE:
            return self._elementwise(node, name, loc), set()
        if name in _REDUCES:
            return self._reduce(node, name, loc), set()
        if name in _CUMULATIVE:
            t = dict(tin[0]) if tin else {}
            return t, set()
        if name == "aten.flip":
            dims = [d % self._rank(node) for d in node.args[1]]
            t = {k: ((None, plain(e)[1]) if k in dims else e)
                 for k, e in self.rd(node.args[0]).items()}
            return t, set()
        if name in _CONTRACT:
            return self._contract(node, name, loc), set()
        if name == "aten.constant_pad_nd":
            return self._pad(node), set()
        if name in ("aten.cat", "aten.stack"):
            return self._cat(node, name), set()
        if name == "aten.copy_":
            src = node.args[1]
            return _shift(self.rd(src), self._rank(node) - self._rank(src)), \
                set()
        if name in ("aten._unsafe_view", "aten.reshape", "aten.view_copy",
                    "aten._reshape_copy"):
            return self._reshape(node, self.rd(node.args[0])), set()
        if name == "iwae_audit.all_gather" or \
                name == "_c10d_functional.all_gather_into_tensor":
            return _shift(self.rd(node.args[0]), 1), set()
        if name == "aten.index_select":
            dim = node.args[1] % self._rank(node)
            t = dict(self.rd(node.args[0]))
            if dim in t:
                t[dim] = (None, plain(t[dim])[1])
            return t, set()
        return self._default(node, tin), set()

    # -- elementwise, reductions, contractions -------------------------------

    def _elementwise(self, node, name: str, loc: str) -> Taint:
        parts = self._aligned(node)
        if not parts:
            return {}
        rule = "mul" if name in _MULTIPLICATIVE else (
            "keep" if name in _ZERO_KEEP or len(parts) == 1 else "add")
        whole = [t for _, t in parts if WHOLE in t]
        real = [t for _, t in parts if WHOLE not in t]
        if whole and real:
            pad_whole = [t for t in whole if not plain(t[WHOLE])[1]]
            if rule == "add" and not pad_whole:
                # adding exact zeros: the real operands' taint alone
                return union(*real, rule="keep")
            if rule == "mul" and not pad_whole:
                return union(*[t for _, t in parts], rule="mul")
            if name not in ("aten.where", "aten.masked_fill"):
                self.finding(loc, f"{name} combines "
                                  f"{self._fmt(whole[0], WHOLE)} with real "
                                  f"data — a padded slice is folded into "
                                  f"real entries (an unrolled reduction "
                                  f"over a padded axis)")
        return union(*[t for _, t in parts], rule=rule)

    def _reduce(self, node, name: str, loc: str) -> Taint:
        src = node.args[0]
        t = self.rd(src)
        rank = self._rank(src)
        dims = arg_value(node, 1, "dim")
        if name in ("aten.max", "aten.min", "aten.argmax", "aten.argmin",
                    "aten.median") and not isinstance(dims, (int, list,
                                                             tuple)):
            dims = None
        if dims is None or (isinstance(dims, (list, tuple)) and not dims):
            axes = set(range(rank))
        elif isinstance(dims, int):
            axes = {dims % max(rank, 1)}
        else:
            axes = {d % max(rank, 1) for d in dims}
        keep = bool(arg_value(node, 2, "keepdim", False)) \
            if name not in ("aten.var", "aten.std") else \
            bool(node.kwargs.get("keepdim", False))
        for ax in sorted(axes):
            if ax not in t:
                continue
            if name in _SUM_LIKE and plain(t[ax])[1]:
                continue        # a sum of exact zeros
            self.finding(loc, f"{name} over tainted {self._fmt(t, ax)} — "
                              f"padded entries enter the reduction "
                              f"unmasked")
        out: Taint = {WHOLE: t[WHOLE]} if WHOLE in t else {}
        for ax, e in t.items():
            if ax == WHOLE or ax in axes:
                continue
            out[ax if keep else ax - sum(1 for r in axes if r < ax)] = e
        return out

    def _contract(self, node, name: str, loc: str) -> Taint:
        if name in ("aten.addmm", "aten.baddbmm", "aten.addmv"):
            bias, a, b = node.args[0], node.args[1], node.args[2]
        else:
            bias, a, b = None, node.args[0], node.args[1]
        ta, tb = self.rd(a), self.rd(b)
        ra, rb = self._rank(a), self._rank(b)
        ka = ra - 1
        kb = rb - 2 if rb >= 2 else 0
        ea, eb = ta.get(ka), tb.get(kb)
        pa = None if ea is None else plain(ea)
        pb = None if eb is None else plain(eb)
        if pa is not None or pb is not None:
            if pb is None or (pa is not None and pa[0] != pb[0]
                              and _lower(pa[0], pb[0])):
                side, t, ax, harmless = "lhs", ta, ka, pa[1]
            elif pa is None or pa[0] != pb[0]:
                side, t, ax, harmless = "rhs", tb, kb, pb[1]
            else:
                side, t, ax, harmless = "lhs", ta, ka, pa[1] or pb[1]
            if not harmless:
                self.finding(loc, f"{name} contracts tainted {side} "
                                  f"{self._fmt(t, ax)} — padded entries are "
                                  f"summed into every output element "
                                  f"unmasked")
        rank = self._rank(node)
        out: Taint = {}
        for t in (ta, tb):
            if WHOLE in t:
                out[WHOLE] = _merge(out.get(WHOLE), t[WHOLE], "keep")
        # free axes: lhs rows -> out[-2] (or out[0] for mv), rhs columns ->
        # out[-1]; bmm's batch axis 0 from either side
        if ra >= 2 and ra - 2 in ta:
            out[rank - 2 if rb >= 2 else rank - 1] = ta[ra - 2]
        if rb >= 2 and rb - 1 in tb:
            out[rank - 1] = _merge(out.get(rank - 1), tb[rb - 1], "keep")
        if ra == 3 and 0 in ta:
            out[0] = ta[0]
        if rb == 3 and 0 in tb:
            out[0] = _merge(out.get(0), tb[0], "keep")
        if bias is not None and isinstance(bias, torch.fx.Node):
            tbias = _shift(self.rd(bias), rank - self._rank(bias))
            out = union(out, tbias, rule="add")
        return out

    # -- masks --------------------------------------------------------------

    def _rm(self, n) -> set:
        return self._marks.get(n, set()) if isinstance(n, torch.fx.Node) \
            else set()

    @staticmethod
    def _raw(marks: set) -> set:
        return {m for m in marks if not isinstance(m, tuple)}

    @staticmethod
    def _bool(marks: set) -> set:
        return {m for m in marks if isinstance(m, tuple)}

    def _literal(self, x) -> Optional[int]:
        """An int bound: a Python number, or a 0-d tensor constant."""
        if isinstance(x, (int, float)) and not isinstance(x, bool):
            return int(math.ceil(x)) if isinstance(x, float) else x
        if isinstance(x, torch.fx.Node) and x.op == "call_function" and \
                op_name(x) in ("aten.lift_fresh_copy", "aten.scalar_tensor"):
            src = x.args[0]
            if op_name(x) == "aten.scalar_tensor":
                return self._literal(src)
            v = getattr(x.graph.owning_module, str(getattr(src, "target",
                                                           "")), None)
            if isinstance(v, torch.Tensor) and v.dim() == 0 and \
                    not v.is_floating_point():
                return int(v)
        return None

    def _cmp_marks(self, node, name: str) -> set:
        a, b = node.args[0], node.args[1]
        ma, mb = self._raw(self._rm(a)), self._raw(self._rm(b))
        rank = self._rank(node)
        ma = {m + rank - self._rank(a) for m in ma}
        mb = {m + rank - self._rank(b) for m in mb} \
            if isinstance(b, torch.fx.Node) else set()
        out = set()
        # arange on the lhs of lt/le is True on low indices; gt/ge flips;
        # an arange on the rhs flips again; le/ge move the threshold by one
        for axes, other, lhs in ((ma - mb, b, True), (mb - ma, a, False)):
            if not axes:
                continue
            low = (name in ("aten.lt", "aten.le")) == lhs
            pol = "low" if low else "high"
            thresh = self._literal(other)
            inclusive = name in ("aten.le", "aten.ge")
            if thresh is not None and (
                    (pol == "low" and inclusive) or
                    (pol == "high" and not inclusive)):
                thresh += 1
            out |= {(ax, pol, thresh) for ax in axes}
        return out

    def _bool_marks(self, node, name: str) -> set:
        ins = [self._bool(self._rm(a)) for a in node.args[:2]]
        if "and" in name:
            lows = set().union(*({m for m in s if m[1] == "low"}
                                 for s in ins))
            highs = {m for m in ins[0] if m[1] == "high"}
            for s in ins[1:]:
                highs &= s
            return lows | highs
        highs = set().union(*({m for m in s if m[1] == "high"} for s in ins))
        lows = {m for m in ins[0] if m[1] == "low"}
        for s in ins[1:]:
            lows &= s
        return highs | lows

    def _select(self, node, name: str, loc: str) -> Taint:
        rank = self._rank(node)
        if name == "aten.where":
            cond, cases = node.args[0], list(node.args[1:3])
        else:
            cond, cases = node.args[1], [node.args[0]]
        pred_t = _shift(self.rd(cond), rank - self._rank(cond))
        marks = {(m[0] + rank - self._rank(cond),) + m[1:]
                 for m in self._bool(self._rm(cond))}
        out = self._elementwise(node, name, loc)
        case_t = [_shift(self.rd(c), rank - self._rank(c))
                  if isinstance(c, torch.fx.Node) else {} for c in cases]
        for ax, pol, thresh in marks:
            if ax not in out or ax in pred_t:
                continue
            if name == "aten.where":
                # pred False (low masks) selects `other` in the padding
                padded_case = case_t[1] if pol == "low" else case_t[0]
            else:
                # masked_fill writes the value where the mask is True
                if pol != "high":
                    continue
                padded_case = {}
            if ax in padded_case or WHOLE in padded_case:
                continue
            ext = plain(out[ax])[0]
            if thresh is not None and ext is not None and thresh > ext:
                continue        # wrong bound: the mask keeps padded rows
            if thresh is None or ext is None:
                self.stats.unverified_mask_discharges += 1
            out.pop(ax, None)
        return out

    # -- structure ----------------------------------------------------------

    def _pad(self, node) -> Taint:
        src = node.args[0]
        t = dict(self.rd(src))
        pads = list(arg_value(node, 1, "pad"))
        value = arg_value(node, 2, "value", 0)
        zero = value == 0
        shp = tuple(val(src).shape)
        rank = len(shp)
        for j in range(len(pads) // 2):
            ax = rank - 1 - j
            lo, hi = pads[2 * j], pads[2 * j + 1]
            if lo == 0 and hi == 0:
                continue
            old = t.get(ax)
            if old is not None:
                old = t[ax] = plain(old)
            if lo > 0:
                t[ax] = (None, zero and (old is None or old[1]))
            elif lo < 0 and old is not None:
                t[ax] = (None if old[0] is None else max(old[0] + lo, 0),
                         old[1])
            if hi > 0 and lo <= 0:
                real = shp[ax] + min(lo, 0)
                if old is None:
                    t[ax] = (real, zero)
                else:
                    ext = _min_ext(t[ax][0], real)
                    t[ax] = (ext, t[ax][1] and zero)
        return t

    def _cat(self, node, name: str) -> Taint:
        pieces = node.args[0]
        rank = self._rank(node)
        dim = arg_value(node, 1, "dim", 0) % max(rank, 1)
        out: Taint = {}
        offset = 0
        first: Optional[int] = None     # where the padding may start
        zero = True
        for p in pieces:
            t = self.rd(p)
            size = 1 if name == "aten.stack" else val(p).shape[dim]
            start = None
            for ax, e in t.items():
                if ax == WHOLE:
                    start, z = offset, plain(e)[1]
                elif ax == dim and name == "aten.cat":
                    ext, z = plain(e)
                    start = None if ext is None else offset + ext
                    if ext is None:
                        start = offset
                else:
                    ax = ax + 1 if name == "aten.stack" and ax >= dim else ax
                    out[ax] = _merge(out.get(ax), e, "keep")
            if first is not None:
                # everything after the first padding is suspect: zeros
                # only where each later piece is zero padding throughout
                whole = t.get(WHOLE)
                zero = zero and whole is not None and plain(whole)[1]
            elif start is not None:
                first, zero = start, z
            offset += size
        if first is not None:
            out[dim] = (first, zero)
        return out

    def _split(self, node, name: str) -> List[Taint]:
        src = node.args[0]
        t = self.rd(src)
        pieces = val(node)
        rank = self._rank(src)
        dim = arg_value(node, 2 if name != "aten.unbind" else 1, "dim", 0)
        dim = dim % max(rank, 1)
        out, offset = [], 0
        for p in pieces:
            if name == "aten.unbind":
                out.append(self._select_index(t, dim, offset))
                offset += 1
                continue
            size = p.shape[dim]
            out.append(self._slice_taint(t, dim, offset, offset + size,
                                         1, val(src).shape[dim]))
            offset += size
        return out

    @staticmethod
    def _select_index(t: Taint, dim: int, index: int) -> Taint:
        out: Taint = {}
        for ax, e in t.items():
            if ax == dim:
                ext, zero = plain(e)
                if ext is None or index >= ext:
                    out[WHOLE] = _merge(out.get(WHOLE), (None, zero),
                                        "keep")
                continue
            if ax == WHOLE:
                out[WHOLE] = e
            else:
                out[ax - 1 if ax > dim else ax] = e
        return out

    @staticmethod
    def _slice_taint(t: Taint, dim: int, start: int, end: int, step: int,
                     size: int) -> Taint:
        out: Taint = {}
        for ax, e in t.items():
            if ax != dim or (start == 0 and step == 1 and end >= size):
                out[ax] = e
                continue
            ext, zero = plain(e)
            if step != 1 or ext is None:
                if start == 0 and step == 1 and end >= size:
                    out[ax] = e
                else:
                    out[ax] = (None, zero)
                continue
            if start == 0 and end <= ext:
                continue        # the unpad idiom: the padded tail cut off
            new = max(ext - start, 0)
            if end - start > new:
                out[ax] = (new, zero)
        return out

    def _reshape(self, node, t: Taint) -> Taint:
        if not t:
            return {}
        old = list(val(node.args[0]).shape)
        new = list(val(node).shape)
        return reshape_taint(t, old, new)

    def _view(self, node, t: Taint) -> Taint:
        """A view's taint from its parent's `t`."""
        name = op_name(node)
        if not t:
            return {}
        src = node.args[0]
        rank_in, rank = self._rank(src), self._rank(node)
        if name in ("aten.slice",):
            dim = arg_value(node, 1, "dim", 0) % max(rank_in, 1)
            size = val(src).shape[dim]
            start = arg_value(node, 2, "start", 0) or 0
            end = arg_value(node, 3, "end", size)
            end = size if end is None else min(end, size)
            start = start + size if start < 0 else start
            end = end + size if end < 0 else end
            step = arg_value(node, 4, "step", 1)
            return self._slice_taint(t, dim, start, end, step, size)
        if name == "aten.select":
            dim = node.args[1] % max(rank_in, 1)
            index = node.args[2]
            index = index + val(src).shape[dim] if index < 0 else index
            return self._select_index(t, dim, index)
        if name in ("aten.view", "aten._reshape_alias", "aten.reshape",
                    "aten.view_as"):
            return self._reshape(node, t)
        if name in ("aten.permute",):
            perm = [d % rank for d in node.args[1]]
            return {(perm.index(k) if isinstance(k, int) else k): e
                    for k, e in t.items()}
        if name in ("aten.t", "aten.transpose", "aten.swapaxes",
                    "aten.movedim"):
            if name == "aten.t":
                d0, d1 = 0, 1
            else:
                d0, d1 = node.args[1] % rank, node.args[2] % rank
            if name == "aten.movedim":
                perm = list(range(rank))
                perm.remove(d0)
                perm.insert(d1, d0)
                return {(perm.index(k) if isinstance(k, int) else k): e
                        for k, e in t.items()}
            swap = {d0: d1, d1: d0}
            return {(swap.get(k, k) if isinstance(k, int) else k): e
                    for k, e in t.items()}
        if name == "aten.unsqueeze":
            d = node.args[1] % rank
            return {(k + 1 if isinstance(k, int) and k >= d else k): e
                    for k, e in t.items()}
        if name == "aten.squeeze":
            dims = arg_value(node, 1, "dim", None)
            shp = val(src).shape
            if dims is None:
                dims = [i for i, s in enumerate(shp) if s == 1]
            elif isinstance(dims, int):
                dims = [dims]
            dims = {d % max(rank_in, 1) for d in dims
                    if shp[d % max(rank_in, 1)] == 1}
            out: Taint = {}
            for k, e in t.items():
                if isinstance(k, int) and k in dims:
                    out[WHOLE] = (None, plain(e)[1])
                elif isinstance(k, int):
                    out[k - sum(1 for d in dims if d < k)] = e
                else:
                    out[k] = e
            return out
        if name == "aten.expand":
            return _shift(t, rank - rank_in)
        if name in ("aten.alias", "aten.detach", "aten.contiguous",
                    "aten.view_as_real", "aten.lift_fresh"):
            return dict(t)
        if name in ("aten.split", "aten.unbind", "aten.chunk"):
            return {}
        # diagonal, as_strided, unfold, ...: every axis suspect
        self.stats.default_propagation += 1
        return {ax: (None, False) for ax in range(rank)}

    def _view_marks(self, node, marks: set) -> set:
        """Raw arange marks through a view (masks are recomputed from them;
        polarity marks do not ride through views)."""
        raw = self._raw(marks)
        bool_marks = self._bool(marks)
        if not raw and not bool_marks:
            return set()
        name = op_name(node)
        rank_in, rank = self._rank(node.args[0]), self._rank(node)
        if name == "aten.unsqueeze":
            d = node.args[1] % rank
            fix = lambda a: a + 1 if a >= d else a        # noqa: E731
        elif name == "aten.expand":
            fix = lambda a: a + rank - rank_in          # noqa: E731
        elif name in ("aten.alias", "aten.detach", "aten.contiguous"):
            fix = lambda a: a                           # noqa: E731
        elif name in ("aten.permute",):
            perm = [d % rank for d in node.args[1]]
            fix = perm.index
        elif name in ("aten.view", "aten._reshape_alias", "aten.reshape"):
            segs = _segments(list(val(node.args[0]).shape),
                             list(val(node).shape))
            one = {s[0][0]: s[1][0] for s in segs
                   if len(s[0]) == 1 and len(s[1]) == 1}
            fix = one.get
        else:
            return set()
        out = set()
        for m in raw:
            new = fix(m)
            if new is not None:
                out.add(new)
        for m in bool_marks:
            new = fix(m[0])
            if new is not None:
                out.add((new,) + m[1:])
        return out

    # -- in-place writes ----------------------------------------------------

    def _write(self, target, t: Taint) -> None:
        """Carry taint `t` written into `target` back to the tensor that owns
        the storage, through `target`'s views (union: a write never clears
        taint)."""
        parent = self._parent.get(target)
        if parent is None:
            merged = union(self._taint.get(target, {}), t, rule="keep")
            if merged:
                self._taint[target] = merged
            return
        if not t:
            return
        if target in self._same:
            self._write(parent, t)
        else:
            self._write(parent, self._unview(target, parent, t))

    def _unview(self, node, parent, t: Taint) -> Taint:
        """The taint a write of `t` into view `node` puts on `parent`."""
        name = op_name(node)
        rank_p = self._rank(parent)
        if name == "aten.slice":
            dim = arg_value(node, 1, "dim", 0) % max(rank_p, 1)
            start = arg_value(node, 2, "start", 0) or 0
            out: Taint = {}
            for k, e in t.items():
                ext, zero = plain(e)
                if k == dim and start == 0:
                    out[k] = e
                elif k == dim:
                    out[k] = (None if ext is None else start + ext, zero)
                elif k == WHOLE:
                    out[dim] = (start, zero)
                else:
                    out[k] = e
            return out
        if name == "aten.select":
            dim = node.args[1] % max(rank_p, 1)
            index = node.args[2] % val(parent).shape[dim]
            out = {}
            for k, e in t.items():
                if k == WHOLE:
                    out[dim] = (index, plain(e)[1])
                else:
                    out[k + 1 if k >= dim else k] = e
            return out
        if name in ("aten.view", "aten._reshape_alias", "aten.reshape"):
            return reshape_taint(t, list(val(node).shape),
                                 list(val(parent).shape))
        if name in ("aten.alias", "aten.detach", "aten.contiguous"):
            return dict(t)
        if name == "aten.unsqueeze":
            d = node.args[1] % max(self._rank(node), 1)
            return {(k - 1 if isinstance(k, int) and k > d else
                     (WHOLE if k == d else k)): e for k, e in t.items()}
        if name in ("aten.t", "aten.transpose", "aten.permute"):
            # the forward map of each parent axis, inverted
            back = {next(iter(self._view(node, {ax: (0, False)}))): ax
                    for ax in range(rank_p)}
            return {(back.get(k, k) if isinstance(k, int) else k): e
                    for k, e in t.items()}
        self.stats.default_propagation += 1
        return {ax: (None, False) for ax in range(rank_p)}

    def _inplace_lists(self, node) -> None:
        """An op writing lists of tensors in place (the fused optimizer):
        each written tensor takes the union of every input's taint."""
        ins = [self.rd(a) for a in self._tensor_args(node)]
        for lst in node.args:
            if isinstance(lst, (list, tuple)):
                for a in lst:
                    if isinstance(a, torch.fx.Node) and \
                            isinstance(val(a), torch.Tensor):
                        ins.append(self.rd(a))
        if not any(ins):
            return
        self.stats.default_propagation += 1
        for i in mutated_args(node):
            lst = arg_value(node, i)
            for a in (lst if isinstance(lst, (list, tuple)) else [lst]):
                if isinstance(a, torch.fx.Node):
                    self._write(a, {ax: (None, False)
                                    for ax in range(self._rank(a))})

    def _default(self, node, tin: List[Taint]) -> Taint:
        """Unknown op: keep an input axis's taint where the output has the
        same size at the same position, else every axis suspect."""
        out_shape = tuple(val(node).shape)
        t: Taint = {}
        conservative = False
        for a in self._tensor_args(node):
            shp = tuple(val(a).shape)
            for ax, e in self.rd(a).items():
                if ax == WHOLE:
                    t[WHOLE] = e
                elif ax < len(out_shape) and ax < len(shp) and \
                        out_shape[ax] == shp[ax]:
                    t[ax] = _merge(t.get(ax), e, "keep") if ax in t else e
                else:
                    conservative = True
        if conservative:
            self.stats.default_propagation += 1
            t = {ax: (None, False) for ax in range(len(out_shape))}
        return t


def _segments(old: List[int], new: List[int]
              ) -> List[Tuple[List[int], List[int]]]:
    """Factor a reshape into minimal (old axes, new axes) segments with equal
    element products (JAX ``_reshape_segments``)."""
    segs: List[Tuple[List[int], List[int]]] = []
    i = j = 0
    while i < len(old) and j < len(new):
        oi, nj = [i], [j]
        po, pn = old[i], new[j]
        i, j = i + 1, j + 1
        while po != pn:
            if po < pn:
                if i >= len(old):
                    break
                po *= old[i]
                oi.append(i)
                i += 1
            else:
                if j >= len(new):
                    break
                pn *= new[j]
                nj.append(j)
                j += 1
        segs.append((oi, nj))
    if i < len(old) or j < len(new):
        segs.append((list(range(i, len(old))), list(range(j, len(new)))))
    return segs


def reshape_taint(t: Taint, old: List[int], new: List[int]) -> Taint:
    """A taint through a reshape. An axis that maps 1:1 keeps its entry;
    axes that merge into one become a :class:`Split` of their entries; a
    :class:`Split` axis cut back into its own sizes gives each part its
    entry again; any other regrouping carries the first flat index that may
    be padding to the first axis of the new group, rounded down, which
    covers every padded index."""
    out: Taint = {WHOLE: t[WHOLE]} if WHOLE in t else {}
    for olds, news in _segments(old, new):
        hit = [ax for ax in olds if ax in t]
        if not hit or not news:
            continue
        if len(olds) == 1 and len(news) == 1:
            out[news[0]] = t[olds[0]]
            continue
        if len(news) == 1:
            subs = []
            for ax in hit:
                ext, zero = plain(t[ax])
                subs.append((olds.index(ax), ext, zero))
            out[news[0]] = Split(tuple(old[a] for a in olds), tuple(subs))
            continue
        e = t[olds[0]] if len(olds) == 1 else None
        if isinstance(e, Split) and e.sizes == tuple(new[a] for a in news):
            for sub, ext, zero in e.subs:
                out[news[sub]] = (ext, zero)
            continue
        flat, zero = None, True
        for ax in hit:
            ext, z = plain(t[ax])
            stride = math.prod(old[a] for a in olds if a > ax)
            start = 0 if ext is None else ext * stride
            flat = start if flat is None else min(flat, start)
            zero = zero and z
        stride_new = math.prod(new[a] for a in news[1:])
        out[news[0]] = (None if flat == 0 else flat // max(stride_new, 1),
                        zero)
    return out


__all__ = ["WHOLE", "Split", "TaintEngine", "TaintStats", "plain",
           "reshape_taint", "union"]
