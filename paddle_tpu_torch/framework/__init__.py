"""The static-graph core (port of paddle_tpu/framework): Program and its
builders, append_backward, the Executor and its Scope, and
`CompiledProgram` with `BuildStrategy` and `ExecutionStrategy` (the
reference's multi-device wrappers: the data-parallel step and the GSPMD
tier, `with_sharding_rules`, run by `spmd.py`).
"""

from .program import (
    Program,
    Block,
    Variable,
    Parameter,
    Operator,
    BackwardSection,
    default_main_program,
    default_startup_program,
    program_guard,
    name_scope,
    data,
)
from .executor import Executor, Scope, global_scope, scope_guard
from .compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from .backward import append_backward, gradients
from .param_attr import ParamAttr
from . import initializer, unique_name

__all__ = [
    "Program", "Block", "Variable", "Parameter", "Operator",
    "BackwardSection", "default_main_program", "default_startup_program",
    "program_guard", "name_scope", "data", "Executor", "Scope",
    "CompiledProgram", "BuildStrategy", "ExecutionStrategy",
    "global_scope", "scope_guard", "append_backward", "gradients",
    "ParamAttr", "initializer", "unique_name",
]


def _not_ported(name, item):
    """A reference class the port does not have yet: constructing it
    raises NotImplementedError naming the ROADMAP item that brings it."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to paddle_tpu_torch yet (ROADMAP item "
            f"{item})")

    return type(name, (), {"__init__": __init__})

