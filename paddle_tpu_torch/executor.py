"""`fluid.executor` import path (the implementation is
framework/executor.py)."""

from .framework.executor import (Executor, Scope, global_scope,  # noqa: F401
                                 scope_guard)

__all__ = ["Executor", "Scope", "global_scope", "scope_guard"]
