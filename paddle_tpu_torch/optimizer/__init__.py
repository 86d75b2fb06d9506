"""Optimizers (port of paddle_tpu/optimizer; this slice: the functional
optimizers the train step uses).

`functional` holds `SGD`, `Momentum`, `Adam`, `AdamW` and
`global_norm_clip` over the update ops in `ops/optimizer_ops.py`.  The
reference's static-graph optimizer zoo (`Optimizer.minimize` emitting
update ops into a Program) comes with the static-graph slice (ROADMAP
queue 1 item 3).
"""

from . import functional  # noqa: F401
from .functional import (  # noqa: F401
    SGD, Adam, AdamW, FunctionalOptimizer, Momentum, global_norm_clip,
)

__all__ = ["functional", "FunctionalOptimizer", "SGD", "Momentum", "Adam",
           "AdamW", "global_norm_clip"]
