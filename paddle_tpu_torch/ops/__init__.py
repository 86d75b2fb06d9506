"""Op kernels (port of paddle_tpu/ops: the GPT, ResNet and static-graph
slices, the static DGC ops and `print` of misc_ops, and the rank-table
ops of sequence_ops), each registered under its op type in
`registry`."""

from . import (  # noqa: F401
    fused_ops, math_ops, misc_ops, nn_ops, optimizer_ops, registry, rnn_ops,
    sequence_ops, tensor_ops,
)
