"""Rule ``dtype-promotion``: float64 in the port's numerics (port of
``analysis/rules/dtype.py``).

What it means in PyTorch: the port computes in fp32, with bf16 operands on
the production path, and its kernels take fp32 or bf16 only. A float64
tensor does not silently downcast as JAX's does under x64-off: it
promotes every expression it meets to float64 (and a kernel wrapper then
refuses it), runs the H100's float64 units at a small fraction of the fp32
rate, and doubles the bytes. So the rule flags ``torch.float64`` /
``torch.double`` (and ``complex128``), the ``.double()`` method,
``dtype="float64"`` and ``dtype=float`` (float64 to numpy and torch's
``torch.tensor``), ``torch.set_default_dtype`` (global promotion, JAX's
``jax_enable_x64``), and ``torch.from_numpy`` of an array made float64:
numpy's float constructors without a ``dtype`` (``np.zeros``,
``np.random.randn``, ...) or ``.astype`` to float64. ``np.float64`` is
flagged as JAX flags it; host-side statistics that mean to run in float64
suppress it in place with their reason.
"""

from __future__ import annotations

import ast
from typing import Iterator

from iwae_replication_project_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    register,
)

_F64_ATTRS = {"float64", "double", "complex128"}
_F64_NAMES = ("float64", "double", "complex128")
#: numpy constructors whose default dtype is float64
_NUMPY_F64 = {"zeros", "ones", "empty", "full", "linspace", "eye",
              "identity", "rand", "randn", "random", "uniform", "normal",
              "standard_normal", "arange"}


def _is_f64_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value in _F64_NAMES
    if isinstance(node, ast.Name):
        return node.id == "float"
    return isinstance(node, ast.Attribute) and node.attr in _F64_ATTRS


def _makes_f64_array(node: ast.AST) -> bool:
    """Whether `node` (``torch.from_numpy``'s argument) is visibly a
    float64 array: numpy's float constructors without ``dtype``, or
    ``.astype`` to float64."""
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Attribute) and node.func.attr == "astype" \
            and node.args:
        return _is_f64_dtype(node.args[0])
    name = Rule.call_name(node)
    root = name.split(".")[0]
    if root in ("np", "numpy") and Rule.terminal(name) in _NUMPY_F64:
        if Rule.terminal(name) == "arange":
            return any(isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  float)
                       for a in node.args) and not any(
                kw.arg == "dtype" for kw in node.keywords)
        return not any(kw.arg == "dtype" for kw in node.keywords)
    return False


@register
class DtypePromotionRule(Rule):
    name = "dtype-promotion"
    summary = ("float64 in the port's numerics (torch.float64, .double(), "
               "dtype=float, from_numpy of a float64 array) — the port "
               "computes in fp32/bf16")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Attribute) and node.attr in _F64_ATTRS:
                base = Rule.dotted(node.value)
                if base.split(".")[0] in ("np", "numpy", "torch", "onp"):
                    yield ctx.finding(
                        self.name, node,
                        f"'{base}.{node.attr}' in fp32/bf16 numerics: it "
                        f"promotes every expression it meets to float64 "
                        f"(and the kernels refuse it)")
            elif isinstance(node, ast.Call):
                yield from self._call(ctx, node)

    def _call(self, ctx: FileContext, node: ast.Call) -> Iterator[Finding]:
        name = Rule.call_name(node)
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "double" and not node.args:
            yield ctx.finding(self.name, node,
                              "'.double()' makes a float64 tensor — the "
                              "port computes in fp32/bf16")
        elif name == "torch.set_default_dtype":
            yield ctx.finding(self.name, node,
                              "torch.set_default_dtype changes promotion "
                              "for every module in the process — "
                              "production code must not toggle it")
        elif name == "torch.from_numpy" and node.args \
                and _makes_f64_array(node.args[0]):
            yield ctx.finding(self.name, node,
                              "torch.from_numpy of a float64 array gives a "
                              "float64 tensor — make the array float32 "
                              "(dtype=np.float32) first")
        for kw in node.keywords:
            if kw.arg != "dtype":
                continue
            if isinstance(kw.value, ast.Constant) and \
                    kw.value.value in _F64_NAMES:
                yield ctx.finding(self.name, kw.value,
                                  f"dtype={kw.value.value!r} is float64")
            elif isinstance(kw.value, ast.Name) and kw.value.id == "float":
                yield ctx.finding(self.name, kw.value,
                                  "dtype=float is float64 to numpy and to "
                                  "torch.tensor — spell the intended dtype "
                                  "(np.float32, torch.float32)")
