"""Aten-graph plumbing shared by every audit pass (port of ``jaxprs.py``):
tracing, node iteration with location paths, the structural program
signature the golden snapshot tests pin, and the recording stand-ins for
the mesh's collectives.

The JAX auditor reads jaxprs from ``jax.make_jaxpr``; this one reads the
aten graphs (``torch.fx.GraphModule``) that
``torch.fx.experimental.proxy_tensor.make_fx`` records while a program runs
once: every op the dispatcher executes below autograd, the backward of a
``torch.autograd.grad`` or an optimizer step included, in program order.
``mode="real"`` runs the program on real tensors (the audit shapes);
``mode="fake"`` on fake tensors, which carry shapes and dtypes and no data,
so a full-width program traces in seconds and allocates nothing. A program
that reads a tensor's value on the host (``.item()``, ``.tolist()``, a
branch on a tensor) cannot be recorded: that is a ``host-transfer``
finding, reported by :func:`trace`'s caller, not a tracing bug.

What a jaxpr nests (``pjit``, ``scan``, ``pallas_call``), a graph holds
flat: Python loops unroll and functions inline. On CPU tensors each kernel
wrapper computes its plain version (``ops/_kernels.plain_region``), so the
graph holds the kernels' arithmetic as aten ops, and :func:`trace` stamps
each of those ops with the kernel's name (``node.meta["kernel"]``) and the
call it belongs to (``node.meta["kernel_call"]``): the cost analyzer
charges a stamped region as the card runs it, one kernel whose interior
stays on chip.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import operator
import threading
import weakref
from collections import Counter
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.parallel.mesh import Mesh

#: the recording collectives (:class:`RecordingMesh`) and torch's own
#: functional collectives, as :func:`op_name` spells them: the collective
#: sub-histogram of :func:`signature` and the cost analyzer's per-axis
#: accounting (analysis/audit/cost.py) share this one definition
COLLECTIVE_OPS = frozenset({
    "iwae_audit.all_reduce", "iwae_audit.broadcast",
    "iwae_audit.all_gather",
    "_c10d_functional.all_reduce", "_c10d_functional.broadcast",
    "_c10d_functional.all_gather_into_tensor",
    "_c10d_functional.reduce_scatter_tensor",
    "_c10d_functional.all_to_all_single",
    "c10d_functional.all_reduce", "c10d_functional.all_gather_into_tensor",
})

#: ops that record no work (profiler marks, the ``span`` of telemetry)
NO_WORK = frozenset({"profiler._record_function_enter_new",
                     "profiler._record_function_exit",
                     "profiler._record_function_enter"})


# --------------------------------------------------------------------------
# the recording collectives
# --------------------------------------------------------------------------

@torch.library.custom_op("iwae_audit::all_reduce", mutates_args=())
def _all_reduce(t: torch.Tensor, op: str, axis: str) -> torch.Tensor:
    """A recorded ``all_reduce`` of `t` with `op` over mesh axis `axis`
    (``"world"``: every rank); here a world of one, so the value is `t`."""
    return t.clone()


@_all_reduce.register_fake
def _(t, op, axis):
    return torch.empty_like(t)


@torch.library.custom_op("iwae_audit::broadcast", mutates_args=())
def _broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """A recorded ``broadcast`` of global rank `src`'s `t`."""
    return t.clone()


@_broadcast.register_fake
def _(t, src):
    return torch.empty_like(t)


@torch.library.custom_op("iwae_audit::all_gather", mutates_args=())
def _all_gather(t: torch.Tensor, axis: str, world: int) -> torch.Tensor:
    """A recorded ``all_gather`` over `axis`: `world` copies of `t` stacked
    on a new leading axis, every rank's value on every rank. The port's
    mesh has no gather and no program of the port gathers; the cost
    analyzer's fixtures seed the hazard with it."""
    return torch.stack([t] * world)


@_all_gather.register_fake
def _(t, axis, world):
    return t.new_empty((world,) + tuple(t.shape))


@dataclasses.dataclass(frozen=True, eq=False)
class RecordingMesh(Mesh):
    """A :class:`Mesh` of any shape in one process whose collectives are
    recorded into the traced graph (``iwae_audit.all_reduce``/``broadcast``
    nodes with their op and axis) instead of run: this process plays
    global rank `rank` of a ``(dp, sp)`` world, and every collective
    returns its input, as a world whose other ranks hold the same values
    would. The programs use the returned tensors, as
    :meth:`Mesh.all_reduce` allows."""

    device_mesh: Optional[object] = "recording"

    @property
    def backend(self) -> Optional[str]:
        return "recording"

    def group(self, axis: Optional[str]):
        return None

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   axis: Optional[str] = None) -> torch.Tensor:
        return torch.ops.iwae_audit.all_reduce(t, op, axis or "world")

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        return torch.ops.iwae_audit.broadcast(t, src)


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------

_calls = itertools.count()


@contextlib.contextmanager
def _stamp_region(name: str, meta: dict):
    """``ops/_kernels.plain_region``'s hook: stamp the nodes recorded inside
    the block with the kernel's name, a call id and `meta`. The outermost
    region wins (its stamps are written last)."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    mode = get_proxy_mode()
    if mode is None:
        yield
        return
    graph = mode.tracer.graph
    last = next(iter(reversed(graph.nodes)), None)
    yield
    call = next(_calls)
    node = last.next if last is not None else next(iter(graph.nodes), None)
    while node is not None and node.op != "root":
        if node.op == "call_function":
            node.meta["kernel"] = name
            node.meta["kernel_call"] = call
            node.meta["kernel_meta"] = dict(meta)
        node = node.next


@contextlib.contextmanager
def recording_kernels():
    """Install :func:`_stamp_region` as the kernels' region hook, and let a
    ``"kernel"`` pin take the kernel's wrapper on this thread's CPU
    tensors.

    ``ops/hot_loop.select_path`` refuses a kernel pin on the CPU, where no
    kernel runs. The recorder records the card's programs on CPU tensors,
    where each kernel wrapper computes its plain version, so for the
    recording thread alone the dispatcher is wrapped: a pin that resolves
    to ``kernel`` on a CPU device selects the kernel, every other call is
    the dispatcher's own. Other threads keep the refusal."""
    from iwae_replication_project_tpu_torch.ops import _kernels, hot_loop

    prev_hook, dispatch = _kernels._region_hook, hot_loop.select_path
    recorder = threading.get_ident()

    def select_path(device, force=None, widths=None, shape=None):
        if threading.get_ident() == recorder \
                and torch.device(device).type == "cpu" \
                and hot_loop._forced_path(force) == "kernel":
            return "kernel"
        return dispatch(device, force, widths=widths, shape=shape)

    _kernels._region_hook = _stamp_region
    hot_loop.select_path = select_path
    try:
        yield
    finally:
        _kernels._region_hook = prev_hook
        hot_loop.select_path = dispatch


class _Lifetimes:
    """Where each tensor a recorded op returns is dropped by the program:
    a weak reference on every output, whose callback notes the graph's last
    node when the program lets the tensor go (a local going out of scope, a
    name rebound, autograd releasing what it saved). The cost analyzer
    frees a storage there, as the card's caching allocator gets it back in
    the same Python program, rather than at its last read."""

    def __init__(self):
        #: node name -> the node after which the program dropped its output
        self.deaths: Dict[str, str] = {}
        #: names of the nodes whose outputs were watched
        self.watched: set = set()
        self.live = True

    def mode(self):
        from torch.fx.experimental.proxy_tensor import (
            get_proxy_mode,
            get_proxy_slot,
        )
        from torch.utils._python_dispatch import TorchDispatchMode

        life = self

        class _Watch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                proxy = get_proxy_mode()
                if proxy is None:
                    return out
                graph = proxy.tracer.graph
                for t in (out if isinstance(out, (list, tuple)) else [out]):
                    if not isinstance(t, torch.Tensor):
                        continue
                    slot = get_proxy_slot(t, proxy.tracer, None)
                    node = getattr(getattr(slot, "proxy", None), "node",
                                   None)
                    if node is None:
                        continue
                    life.watched.add(node.name)
                    weakref.finalize(t, life._dropped, node.name, graph)
                return out

        return _Watch()

    def _dropped(self, name: str, graph) -> None:
        if self.live:
            last = next(iter(reversed(graph.nodes)), None)
            if last is not None:
                self.deaths[name] = last.name


def trace(fn: Callable, *args, mode: str = "real") -> torch.fx.GraphModule:
    """The aten graph of ``fn(*args)``: ``make_fx`` in `mode` (``"real"``
    or ``"fake"``), with the kernels' plain versions stamped and the node
    after which the program drops each op's output in
    ``gm.meta["deaths"]`` (``{node name: node name}``;
    outputs still held when the program returns are absent; the watched
    nodes in ``gm.meta["watched"]``). Every tensor
    the program reads should be in `args` (a tensor reached through a
    closure is lifted into the graph as a ``_tensor_constant``, which the
    recompile-cardinality pass reports for captured programs)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if mode not in ("real", "fake"):
        raise ValueError(f"mode must be 'real' or 'fake', got {mode!r}")
    life = _Lifetimes()

    def watched(*a):
        with life.mode():
            return fn(*a)

    with recording_kernels():
        gm = make_fx(watched, tracing_mode=mode)(*args)
    life.live = False
    gm.meta["deaths"] = dict(life.deaths)
    gm.meta["watched"] = set(life.watched)
    return gm


# --------------------------------------------------------------------------
# reading a graph
# --------------------------------------------------------------------------

def op_name(node) -> str:
    """``aten.mm``, ``iwae_audit.all_reduce``, ``getitem``: the overload-free
    name of a call node's target."""
    target = node.target
    if target is operator.getitem:
        return "getitem"
    packet = getattr(target, "_overloadpacket", None)
    if packet is not None:
        return str(packet)
    return getattr(target, "__name__", str(target))


def calls(gm) -> List[Any]:
    """The graph's ``call_function`` nodes in program order."""
    return [n for n in gm.graph.nodes if n.op == "call_function"]


def iter_nodes(gm, root: str = "") -> Iterator[Tuple[str, Any]]:
    """Every call node with a location path like ``score_rows/aten.mm[12]``
    (the node's index in the graph; `root` names the program)."""
    for i, node in enumerate(gm.graph.nodes):
        if node.op != "call_function":
            continue
        here = f"{op_name(node)}[{i}]"
        yield (f"{root}/{here}" if root else here), node


def placeholders(gm) -> List[Any]:
    return [n for n in gm.graph.nodes if n.op == "placeholder"]


def tensor_constants(gm) -> List[Tuple[str, Any]]:
    """``(name, value)`` of every tensor the graph reads through
    ``get_attr``: closure tensors lifted in as constants."""
    out = []
    for n in gm.graph.nodes:
        if n.op == "get_attr":
            val = getattr(gm, str(n.target), None)
            if isinstance(val, torch.Tensor):
                out.append((str(n.target), val))
    return out


def used_inputs(gm) -> set:
    """Indices of the placeholders some node reads (or the output
    returns)."""
    return {i for i, n in enumerate(placeholders(gm)) if n.users}


def val(node):
    """The value a node recorded (a tensor, fake or real; a list of them;
    a number), or None."""
    return node.meta.get("val") if hasattr(node, "meta") else None


def input_metas(gm) -> List[Optional[Tuple[tuple, str, str]]]:
    """``(shape, dtype, device)`` per placeholder (None for non-tensors)."""
    out = []
    for n in placeholders(gm):
        v = val(n)
        out.append((tuple(v.shape), str(v.dtype), str(v.device))
                   if isinstance(v, torch.Tensor) else None)
    return out


def primitive_histogram(gm) -> Counter:
    """``{op name: count}`` over the program's call nodes."""
    return Counter(op_name(n) for n in calls(gm)
                   if op_name(n) not in NO_WORK)


def kernel_histogram(gm) -> Dict[str, int]:
    """``{kernel: calls}``: the kernel regions the graph records."""
    seen: Dict[int, str] = {}
    for n in calls(gm):
        if "kernel_call" in n.meta:
            seen[n.meta["kernel_call"]] = n.meta["kernel"]
    return dict(sorted(Counter(seen.values()).items()))


def signature(gm) -> dict:
    """Structural fingerprint for the golden snapshot tests: the node
    count, the op histogram, the collective sub-histogram on its own key
    (a sharded merge's extra collective reads as collective drift, not a
    mystery +1 in a long histogram), and the kernel regions. Shape-free:
    k and batch change extents, not structure, except where a Python loop
    over rows or slabs unrolls (the fixed-order plain versions), so the
    goldens are pinned at the audit shapes."""
    hist = primitive_histogram(gm)
    return {"node_count": int(sum(hist.values())),
            "ops": {name: int(n) for name, n in sorted(hist.items())},
            "collectives": {name: int(n) for name, n in sorted(hist.items())
                            if name in COLLECTIVE_OPS},
            "kernels": kernel_histogram(gm)}


def schema_aliases(node) -> Tuple[Optional[int], bool]:
    """``(argument index, writes)`` of the input the node's first output
    aliases per its schema (a view: ``writes`` False; an in-place or
    ``out=`` op: True), or ``(None, False)``."""
    schema = getattr(node.target, "_schema", None)
    if schema is None or not schema.returns:
        return None, False
    ret = schema.returns[0].alias_info
    if ret is None:
        return None, False
    for i, arg in enumerate(schema.arguments):
        info = arg.alias_info
        if info is not None and set(info.before_set) & set(ret.before_set):
            return i, bool(info.is_write)
    return None, False


def mutated_args(node) -> List[int]:
    """Indices of the arguments the node writes in place (schema
    ``Tensor(a!)``, lists of them included)."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return []
    return [i for i, arg in enumerate(schema.arguments)
            if arg.alias_info is not None and arg.alias_info.is_write]


def arg_value(node, i: int, name: Optional[str] = None, default=None):
    """The node's argument `i` (positional) or keyword `name`."""
    if i < len(node.args):
        return node.args[i]
    if name is not None and name in node.kwargs:
        return node.kwargs[name]
    schema = getattr(node.target, "_schema", None)
    if schema is not None and i < len(schema.arguments):
        key = schema.arguments[i].name
        if key in node.kwargs:
            return node.kwargs[key]
    return default


__all__ = ["COLLECTIVE_OPS", "NO_WORK", "RecordingMesh", "arg_value",
           "calls", "input_metas", "iter_nodes", "kernel_histogram",
           "mutated_args", "op_name", "placeholders", "primitive_histogram",
           "recording_kernels", "schema_aliases", "signature",
           "tensor_constants", "trace", "used_inputs", "val"]
