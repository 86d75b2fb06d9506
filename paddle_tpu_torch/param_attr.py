"""`fluid.param_attr` import path (the implementation is
framework/param_attr.py)."""

from .framework.param_attr import (ParamAttr,  # noqa: F401
                                   WeightNormParamAttr)

__all__ = ["ParamAttr", "WeightNormParamAttr"]
