"""`fluid.unique_name` import path (the implementation is
framework/unique_name.py)."""

from .framework.unique_name import (  # noqa: F401
    UniqueNameGenerator, generate, generate_with_ignorable_key, guard,
    switch)

__all__ = ["generate", "switch", "guard"]
