"""Hand-written Hopper kernels and their dispatch.

K1 flash-attention forward, K2/K3 its backward and K6 flash decode are
CUDA C++ (`paddle_tpu_torch/csrc/`, built by `backend`); K4/K5 LayerNorm
forward and backward are Triton.  Each wrapper sits beside its plain
PyTorch version and counts its launches in `backend.LAUNCHES`.
"""

from . import attention, backend, flash_attention, layer_norm  # noqa: F401
