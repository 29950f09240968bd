"""Static analysis of the port: program contracts on the ``meta`` device,
a PyTorch-hazard AST lint, and the steady-state guard.

Run everything over the registered algorithms with::

    PYTHONPATH=src python -m repro_torch.analysis

See ``python -m repro_torch.analysis --help`` for pass selection, the
negative fixtures (``--fixture RULE`` / ``--self-test``) and the rule list.
"""
from repro_torch.analysis.contracts import (
    CONTRACT_RULES,
    ProgramTrace,
    ScalingCurve,
    check_algorithms,
    stacking_concats,
    trace_program,
)
from repro_torch.analysis.lint_torch import LINT_RULES, lint_paths, lint_source
from repro_torch.analysis.recompile_guard import (
    CompilationCounter,
    RecompileBudgetExceeded,
    check_experiment_recompiles,
    recompile_guard,
)
from repro_torch.analysis.report import Violation, render_report
from repro_torch.analysis.trace import MetaRecorder, meta_like, run_on_meta

__all__ = [
    "CONTRACT_RULES",
    "LINT_RULES",
    "CompilationCounter",
    "MetaRecorder",
    "ProgramTrace",
    "RecompileBudgetExceeded",
    "ScalingCurve",
    "Violation",
    "check_algorithms",
    "check_experiment_recompiles",
    "lint_paths",
    "lint_source",
    "meta_like",
    "recompile_guard",
    "render_report",
    "run_on_meta",
    "stacking_concats",
    "trace_program",
]
