"""Rule ``host-sync``: implicit host synchronization in hot-path modules
(port of ``analysis/rules/host.py``).

What it means in PyTorch: a CUDA tensor's value reaches the host only by
waiting for every kernel queued before it. ``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()``, ``float()``/``int()``/``bool()`` of a torch
call and ``torch.cuda.synchronize()`` all block the host on the device.
In a driver that is a deliberate fetch (``experiment.py`` fetches one
tensor per stage); inside the per-step and per-dispatch modules (the
config's ``hot_paths``: ``training/``, ``ops/``, ``parallel/``,
``serving/programs.py``) it stalls the queue the captured CUDA graphs and
the pipelined engine keep full, and inside a graph capture it fails
outright. ``np.asarray``/``np.array`` of a tensor is the same sync; it is
flagged as JAX flags it. The JAX rule's ``jax.device_get`` has no torch
counterpart.
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

#: numpy-namespace callables that realize device values on the host
_NUMPY_SYNCS = {"asarray", "array"}
_NUMPY_MODULES = {"np", "numpy", "onp"}
#: tensor methods that copy to the host and wait for the device
_TENSOR_SYNCS = {"item", "cpu", "tolist", "numpy"}


def in_hot_path(ctx: FileContext) -> bool:
    return any(ctx.rel_path.startswith(hp.rstrip("/") + "/")
               or ctx.rel_path == hp for hp in ctx.config.hot_paths)


@register
class HostSyncRule(Rule):
    name = "host-sync"
    summary = ("implicit device->host sync (.item()/.cpu()/.tolist()/"
               ".numpy()/float() of a torch call/torch.cuda.synchronize()) "
               "inside a hot-path module")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not in_hot_path(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = Rule.call_name(node)
            parts = name.split(".")
            if len(parts) == 2 and parts[0] in _NUMPY_MODULES \
                    and parts[1] in _NUMPY_SYNCS:
                yield ctx.finding(
                    self.name, node,
                    f"'{name}' in a hot-path module copies a tensor to the "
                    f"host and waits for the device — keep data on the "
                    f"device or move the fetch to the driver layer")
            elif name == "torch.cuda.synchronize":
                yield ctx.finding(
                    self.name, node,
                    "'torch.cuda.synchronize()' in a hot-path module drains "
                    "the device queue — wait on an event in the driver "
                    "layer instead")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TENSOR_SYNCS and not node.args \
                    and not node.keywords:
                yield ctx.finding(
                    self.name, node,
                    f"'.{node.func.attr}()' blocks on the device and copies "
                    f"to the host — hot paths must stay asynchronous")
            elif name in ("float", "int", "bool") and node.args and \
                    isinstance(node.args[0], ast.Call) and \
                    Rule.call_name(node.args[0]).split(".")[0] == "torch":
                # float(torch.max(x)): scalarizing a device computation is
                # the implicit-sync shape; float(n) of a python value is not
                yield ctx.finding(
                    self.name, node,
                    f"'{name}(...)' of a torch computation blocks and "
                    f"copies to the host — keep it a tensor (or fetch in "
                    f"the driver layer)")
