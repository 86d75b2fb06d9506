"""Op kernels (port of paddle_tpu/ops, the GPT slice)."""

from . import nn_ops, optimizer_ops  # noqa: F401
