"""`fluid.initializer` import path (the implementation is
framework/initializer.py)."""

from .framework.initializer import (  # noqa: F401
    Bilinear, BilinearInitializer, Constant, ConstantInitializer,
    Initializer, MSRA, MSRAInitializer, Normal, NormalInitializer,
    NumpyArrayInitializer, TruncatedNormal, TruncatedNormalInitializer,
    Uniform, UniformInitializer, Xavier, XavierInitializer)

__all__ = [
    "Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
    "Bilinear", "MSRA", "NumpyArrayInitializer",
]
