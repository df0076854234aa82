"""Static analysis of the port's serving stack: the lint framework, the
concurrency rules and the race detector (port of ``analysis/``).

``python -m iwae_replication_project_tpu_torch.analysis [paths]`` runs every
registered rule (``--list-rules``); ``python -m
iwae_replication_project_tpu_torch.analysis.race`` runs the leak pass and,
with ``--self-test``, the detector's battery. Library entry points below;
the policy is :class:`LintConfig`'s defaults, which name the port's files,
or a ``[tool.iwaelint_torch]`` pyproject table where one exists.
"""

from iwae_replication_project_tpu_torch.analysis.config import (
    LintConfig,
    load_config,
)
from iwae_replication_project_tpu_torch.analysis.core import (
    BARE_SUPPRESSION,
    USELESS_SUPPRESSION,
    Finding,
    Rule,
    all_rules,
    lint_file,
    lint_paths,
    register,
)

__all__ = [
    "BARE_SUPPRESSION",
    "USELESS_SUPPRESSION",
    "Finding",
    "LintConfig",
    "Rule",
    "all_rules",
    "lint_file",
    "lint_paths",
    "load_config",
    "register",
]
