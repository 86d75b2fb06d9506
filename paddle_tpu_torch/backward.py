"""`fluid.backward` import path (the implementation is
framework/backward.py)."""

from .framework.backward import append_backward, gradients  # noqa: F401

__all__ = ["append_backward", "gradients"]
