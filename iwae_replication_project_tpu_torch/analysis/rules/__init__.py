"""Built-in rule modules. Importing this package registers every rule with
the core registry (``core.all_rules`` triggers the import).

Registered so far: the concurrency rules and the leak pass. The JAX
linter's rules over JAX idioms (``host``, ``dtype``, ``imports``,
``entrypoints``, ``jit``, ``prng``) have no torch counterpart yet."""

from iwae_replication_project_tpu_torch.analysis.rules import (  # noqa: F401
    concurrency,
)
# the static leak pass (leaked-future / leaked-span / leaked-pin) lives in
# the race-detector package but registers with the same rule registry so
# suppressions and --select work alike in both command lines
from iwae_replication_project_tpu_torch.analysis.race import leaks  # noqa: F401,E402
