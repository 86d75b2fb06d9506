"""`fluid.layer_helper` import path (the implementation is
framework/layer_helper.py)."""

from .framework.layer_helper import LayerHelper  # noqa: F401

__all__ = ["LayerHelper"]
