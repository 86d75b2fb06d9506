"""Op kernels (port of paddle_tpu/ops: the GPT, ResNet and static-graph
slices, and the static DGC ops of misc_ops), each registered under its op
type in `registry`."""

from . import (  # noqa: F401
    fused_ops, math_ops, misc_ops, nn_ops, optimizer_ops, registry, rnn_ops,
    tensor_ops,
)
