"""Rule ``fragile-import``: private or version-moving torch APIs outside
the shims (port of ``analysis/rules/imports.py``).

What it means in PyTorch: JAX's incident was ``from jax import shard_map``
moving between releases. Torch's counterparts are its private modules
(``torch._C``, ``torch._dynamo``, ``torch._inductor``, ``torch._prims``,
``torch._subclasses``, anything under a leading-underscore component) and
the APIs that moved or are marked for removal across 2.x
(``torch.distributed._tensor``, ``torch.cuda.amp``, ``torch.testing._internal``,
``functorch``): the card's machine and the builders' host already run
different torch releases. Any import of a module on the config's
``fragile_imports`` list, or of a private ``torch`` module, is flagged
outside the config's ``import_shims`` files, so a dependence on one lives
in a shim where a version change is fixed once. Private *attributes*
reached through ``torch.`` (``torch._foreach_*``) are not imports and are
not flagged: they are documented kernels of torch's own optimizers.
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


def _private_torch(module: str) -> bool:
    parts = module.split(".")
    return parts[0] == "torch" and any(p.startswith("_") for p in parts[1:])


@register
class FragileImportRule(Rule):
    name = "fragile-import"
    summary = ("import of a private or version-moving torch module outside "
               "the configured shims")

    def _hit(self, module: str, fragile) -> bool:
        return _private_torch(module) or any(
            module == m or module.startswith(m + ".") for m in fragile)

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.rel_path in ctx.config.import_shims:
            return
        fragile = list(ctx.config.fragile_imports)
        shims = ", ".join(ctx.config.import_shims) or "a shim"
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if self._hit(alias.name, fragile):
                        yield ctx.finding(
                            self.name, node,
                            f"'import {alias.name}' is private or moves "
                            f"across torch releases — import it in {shims}")
            elif isinstance(node, ast.ImportFrom) and node.module:
                if self._hit(node.module, fragile):
                    yield ctx.finding(
                        self.name, node,
                        f"'from {node.module} import ...' is private or "
                        f"moves across torch releases — import it in "
                        f"{shims}")
                else:
                    for alias in node.names:
                        full = f"{node.module}.{alias.name}"
                        if self._hit(full, fragile):
                            yield ctx.finding(
                                self.name, node,
                                f"'from {node.module} import {alias.name}' "
                                f"is private or moves across torch "
                                f"releases — import it in {shims}")
