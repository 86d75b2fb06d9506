"""Hand-written Hopper kernels and their dispatch.

K1 flash-attention forward, K2/K3 its backward, K6 flash decode and K7
the fused ResNet bottleneck block (forward and backward) are CUDA C++
(`paddle_tpu_torch/csrc/`, built by `backend`); K4/K5 LayerNorm forward
and backward are Triton.  Each wrapper sits beside its plain
PyTorch version and counts its launches in `backend.LAUNCHES`.
"""

from . import (  # noqa: F401
    attention, backend, flash_attention, fused_bottleneck, layer_norm,
)
