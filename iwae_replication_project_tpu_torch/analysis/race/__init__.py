"""``iwae-race``: the port's race detector and leak prover (port of
``analysis/race/``).

The static lint rules (analysis/rules/concurrency.py) see *source*; this
package sees *interleavings*: it is the dynamic twin of the concurrency
checker.

* :mod:`model` — the detector core: an Eraser-style lockset algorithm
  hybridized with vector-clock happens-before (thread start/join, future
  completion, queue transfer, and event set are HB edges; lock
  acquire/release contributes locksets only, so accidental lock timing
  never hides a race);
* :mod:`instrument` — the injectable instrumented-sync layer: traced
  Lock/RLock/Condition/Event/Thread/Future/Queue swapped in at the
  ``concurrency_paths`` modules' import sites, plus per-class attribute
  tracing. Uninstalled, the production modules run the byte-identical
  pre-instrumentation code path (test-pinned);
* :mod:`fuzz` — deterministic schedule fuzzing: a seeded cooperative
  scheduler (fixtures: same seed => same interleaving => byte-identical
  report, every race report is a repro) and a seeded perturb mode for the
  real socket-threaded serving stack;
* :mod:`escape` — static thread-escape analysis (which ``self.X`` cross a
  thread boundary), consumed by the upgraded ``unlocked-shared-state``
  lint rule;
* :mod:`leaks` — the static future/span/pin leak pass: every
  ``Future()``/``start_span``/``pin_prefix`` acquisition in the serving
  control plane is proven completed/finished/released on all exception
  paths — the "zero silence" drain contract, machine-checked;
* :mod:`cli` — ``python -m iwae_replication_project_tpu_torch.analysis.race``
  (the 0/1/2 exit contract of the lint CLI).
"""

from iwae_replication_project_tpu_torch.analysis.race.model import (  # noqa: F401
    Access,
    RaceDetector,
    RaceReport,
    VectorClock,
)
from iwae_replication_project_tpu_torch.analysis.race.instrument import (  # noqa: F401
    Instrumentation,
)
from iwae_replication_project_tpu_torch.analysis.race.fuzz import (  # noqa: F401
    CooperativeScheduler,
    PerturbFuzzer,
    SchedulerDeadlock,
)
