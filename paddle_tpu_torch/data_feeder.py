"""`fluid.data_feeder` import-path compatibility (port of
paddle_tpu/data_feeder.py): the implementation is in reader/__init__.py.
"""

from .reader import DataFeeder  # noqa: F401

__all__ = ["DataFeeder"]
