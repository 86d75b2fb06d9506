"""`fluid.compiler` import-path compatibility (port of
paddle_tpu/compiler.py): the implementation is framework/compiler.py.
"""

from .framework.compiler import (BuildStrategy, CompiledProgram,
                                 ExecutionStrategy)  # noqa: F401

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]
