"""Layer function library, static graph builders (port of the nn, tensor,
loss and metric slice of paddle_tpu/layers; Paddle-Fluid's fluid/layers).

Every builder of the reference's `layers.nn`, `layers.tensor`,
`layers.loss` and `layers.metric_op`, and `data`.  Any other public name
of the reference's `layers` namespace raises NotImplementedError naming
ROADMAP item 10: control flow, rnn, extended, sequence and detection
layers, distributions and the learning-rate schedules.
"""

from ..framework.program import data  # noqa: F401
from . import loss, metric_op, nn, tensor  # noqa: F401
from .loss import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

__all__ = (["data"] + nn.__all__ + tensor.__all__ + loss.__all__
           + metric_op.__all__)


def __getattr__(name):
    if name.startswith("_"):
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    raise NotImplementedError(
        f"layers.{name} is not ported to paddle_tpu_torch yet (ROADMAP item "
        f"10: control flow, rnn, extended, sequence and detection layers, "
        f"distributions and the learning-rate schedules)")
