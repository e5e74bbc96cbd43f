"""graftlint for the port: torch/CUDA-aware static analysis.

Usage: ``python -m cst_captioning_tpu_torch.tools.graftlint [paths]`` — see
:mod:`cst_captioning_tpu_torch.tools.graftlint.cli` for flags,
``--list-rules`` for the rule table, and the README "Static analysis of the
port" section for the rules, suppression syntax
(``# graftlint-torch: disable=GL00X``), the ``graftlint_torch.baseline`` workflow
and the ``--fix`` / ``--fix-check`` autofix modes (:mod:`fixes`).
"""

from cst_captioning_tpu_torch.tools.graftlint.core import (
    Baseline,
    Edit,
    FileContext,
    Finding,
    Fix,
    LintResult,
    ProjectRule,
    Rule,
    all_rules,
    find_repo_root,
    lint_paths,
    register,
)
from cst_captioning_tpu_torch.tools.graftlint.project import ProjectIndex

__all__ = [
    "Baseline",
    "Edit",
    "FileContext",
    "Finding",
    "Fix",
    "LintResult",
    "ProjectIndex",
    "ProjectRule",
    "Rule",
    "all_rules",
    "find_repo_root",
    "lint_paths",
    "register",
]
