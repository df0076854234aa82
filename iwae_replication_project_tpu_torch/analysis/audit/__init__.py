"""The program auditor and the cost analyzer over aten graphs (port of
``analysis/audit/``).

Where ``analysis/rules/`` checks the SOURCE, this package checks the
RECORDED PROGRAMS: the aten graphs ``make_fx`` records from the port's
real programs on CPU tensors (``graphs.py``), for the hazards that live
below the source (``passes.py``: a write into an input the program does
not own, padded rows reaching the IWAE ``logsumexp`` unmasked, a host read
inside a hot program, a signature that mints a CUDA graph per value). See
``core.py`` for the framework, ``taint.py`` for the padding dataflow
engine, ``programs.py`` for the audited suite, and ``cost.py`` for the
static cost analyzer (live-range peak memory as the card holds it,
FLOP/byte accounting against the card's roofline, collectives per mesh
axis) over the same graphs. The package imports torch only.

    python -m iwae_replication_project_tpu_torch.analysis.audit
    python -m iwae_replication_project_tpu_torch.analysis.audit.cost
"""

from iwae_replication_project_tpu_torch.analysis.audit.core import (
    BARE_WAIVER,
    AuditEnv,
    AuditFinding,
    AuditPass,
    AuditProgram,
    all_passes,
    register,
    run_audit,
    select_passes,
)
from iwae_replication_project_tpu_torch.analysis.audit.graphs import (
    iter_nodes,
    primitive_histogram,
    signature,
    trace,
)
from iwae_replication_project_tpu_torch.analysis.audit.programs import (
    PROGRAM_NAMES,
    build_programs,
)
from iwae_replication_project_tpu_torch.analysis.audit.taint import (
    TaintEngine,
)

__all__ = [
    "BARE_WAIVER", "AuditEnv", "AuditFinding", "AuditPass", "AuditProgram",
    "all_passes", "register", "run_audit", "select_passes",
    "iter_nodes", "primitive_histogram", "signature", "trace",
    "PROGRAM_NAMES", "build_programs", "TaintEngine",
]
