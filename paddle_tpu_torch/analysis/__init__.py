"""Static Program analysis (port of paddle_tpu/analysis/).

Abstract interpretation over a recorded Program, catching shape/dtype
mismatches, use-before-def, dead code, aliasing hazards, distributed
misconfigurations (the PT3xx sharding lints) and numerics hazards (the
PT4xx AMP lints) BEFORE the Executor runs an op, with the op's
ProgramDesc identity and creation callsite attached to every finding.
The codes, severities, messages and records are the reference's.

Usage::

    from paddle_tpu_torch import analysis
    result = analysis.check_program(main, fetch_names=[loss.name])
    print(result.render())        # PT1xx errors / PT2xx warnings

Executor integration: ``FLAGS_static_check=off|warn|error`` runs the
verifier (cached per program version) before the run; ``error`` raises
:class:`ProgramLintError`, ``warn`` emits a :class:`ProgramLintWarning`
once per program version, ``off`` (the default) costs one flag read.

Standalone CLI: ``python -m paddle_tpu_torch.tools.program_lint`` lints
serialized programs or the bundled static model zoo.
"""

import warnings as _warnings

from . import facts
from . import numerics
from . import sharding
from .diagnostics import (CODES, Diagnostic, LintResult,
                          ProgramLintError)
from .facts import infer_specs, live_op_mask, protected_names
from .numerics import NumericsAnalysis, numerics_class
from .shape_rules import (OPAQUE, ShapeError, VarSpec, has_shape_rule,
                          is_opaque, register_opaque, shape_rule)
from .sharding import (REPLICATED, MeshSpec, PartitionRules, ShardSpec,
                       ShardingAnalysis)
from .verifier import cached_check, check_program

__all__ = [
    "check_program", "cached_check", "CODES",
    "Diagnostic", "LintResult", "ProgramLintError",
    "ProgramLintWarning",
    "VarSpec", "OPAQUE", "ShapeError", "shape_rule", "register_opaque",
    "has_shape_rule", "is_opaque",
    "facts", "live_op_mask", "infer_specs", "protected_names",
    "sharding", "MeshSpec", "ShardSpec", "REPLICATED",
    "PartitionRules", "ShardingAnalysis",
    "numerics", "NumericsAnalysis", "numerics_class",
]


class ProgramLintWarning(UserWarning):
    """Category of FLAGS_static_check=warn reports (filterable with the
    stdlib warnings machinery)."""


def warn_result(result, stacklevel=2):
    """Emit one ProgramLintWarning for a non-clean LintResult."""
    if result.diagnostics:
        _warnings.warn(result.render(), ProgramLintWarning,
                       stacklevel=stacklevel)
