"""Op kernels (port of paddle_tpu/ops: the GPT, ResNet and static-graph
slices), each registered under its op type in `registry`."""

from . import (  # noqa: F401
    fused_ops, math_ops, nn_ops, optimizer_ops, registry, rnn_ops,
    tensor_ops,
)
