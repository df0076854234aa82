"""Built-in rule modules. Importing this package registers every rule with
the core registry (``core.all_rules`` triggers the import).

The concurrency rules (``concurrency``: lock-order, unlocked-shared-state,
blocking-call-under-lock, swallowed-exception), the leak pass
(``race/leaks.py``: leaked-future, leaked-span, leaked-pin), and the torch
counterparts of the JAX linter's idiom rules, each module's docstring
saying what its JAX rule means in PyTorch: ``host`` (host-sync),
``dtype`` (dtype-promotion), ``imports`` (fragile-import),
``entrypoints`` (cache-setup: the kernel build directory), ``jit``
(jit-in-loop, nonhashable-static, donated-after-call: a CUDA graph's
static inputs) and ``prng`` (key-reuse: a re-seeded generator)."""

from iwae_replication_project_tpu_torch.analysis.rules import (  # noqa: F401
    concurrency,
    dtype,
    entrypoints,
    host,
    imports,
    jit,
    prng,
)
# the static leak pass (leaked-future / leaked-span / leaked-pin) lives in
# the race-detector package but registers with the same rule registry so
# suppressions and --select work alike in both command lines
from iwae_replication_project_tpu_torch.analysis.race import leaks  # noqa: F401,E402
