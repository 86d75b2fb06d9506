"""`fluid.communicator` import-path compatibility (port of
paddle_tpu/communicator.py).

Parity: python/paddle/fluid/communicator.py — the PS Communicator lives
in distributed/ps.py (sync/async/half_async/geo modes).
"""

from .distributed.ps import Communicator  # noqa: F401

__all__ = ["Communicator"]
