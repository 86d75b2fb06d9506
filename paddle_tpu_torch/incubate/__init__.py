"""`fluid.incubate` surface (port of paddle_tpu/incubate/, its
data_generator).

Parity: python/paddle/fluid/incubate/ — data_generator is the ETL helper
emitting the MultiSlot text that QueueDataset / InMemoryDataset read
(`datasets.multislot`, on the native reader).  The rest of the
reference's incubate namespace (its fleet alias) is ROADMAP item 10 and
raises NotImplementedError naming it.
"""

from . import data_generator  # noqa: F401

__all__ = ["data_generator"]


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    raise NotImplementedError(
        f"incubate.{name} is not ported to paddle_tpu_torch yet (ROADMAP "
        f"item 10: the rest of incubate)")
