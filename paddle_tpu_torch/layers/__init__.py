"""Layer function library, static graph builders (port of the nn, tensor,
loss, metric, control-flow and learning-rate slice of paddle_tpu/layers;
Paddle-Fluid's fluid/layers).

Every builder of the reference's `layers.nn`, `layers.tensor`,
`layers.loss`, `layers.metric_op`, `layers.control_flow` and
`layers.learning_rate_scheduler`, and `data`.  Any other public name of
the reference's `layers` namespace raises NotImplementedError naming
ROADMAP item 10: rnn, extended, sequence and detection layers and
distributions.
"""

from ..framework.program import data  # noqa: F401
from . import (  # noqa: F401
    control_flow, learning_rate_scheduler, loss, metric_op, nn, tensor,
)
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
# the reference re-exports the LR schedules at the layers namespace
from .learning_rate_scheduler import *  # noqa: F401,F403

__all__ = sorted(set(
    ["data"] + nn.__all__ + tensor.__all__ + loss.__all__
    + metric_op.__all__ + control_flow.__all__
    + learning_rate_scheduler.__all__))


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    raise NotImplementedError(
        f"layers.{name} is not ported to paddle_tpu_torch yet (ROADMAP item "
        f"10: rnn, extended, sequence and detection layers and "
        f"distributions)")
