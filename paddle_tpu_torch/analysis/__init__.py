"""Program analysis (port of the fact layer of paddle_tpu/analysis/).

`shape_rules` (the per-op (shape, dtype) rules) and `facts` (liveness,
backward segments, the shape walk, protected names) are what the fusion
tier reads.  The verifier (`check_program`), the numerics analyzer and
the sharding analyzer are ROADMAP items 10 and 8.
"""

from . import facts, shape_rules  # noqa: F401
from .facts import infer_specs, live_op_mask, protected_names  # noqa: F401
from .shape_rules import (  # noqa: F401
    OPAQUE, ShapeError, VarSpec, has_shape_rule, is_opaque, register_opaque,
    shape_rule,
)

__all__ = [
    "facts", "shape_rules", "infer_specs", "live_op_mask",
    "protected_names", "VarSpec", "OPAQUE", "ShapeError", "shape_rule",
    "register_opaque", "has_shape_rule", "is_opaque",
]
