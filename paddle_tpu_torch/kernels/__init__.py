"""Hand-written Hopper kernels and their dispatch.

K1 flash-attention forward, K2/K3 its backward, K5 the LayerNorm
backward, K6 flash decode, K7 the fused ResNet bottleneck block, K8 the
stride-2 transition block, K9 the ResNet stem's batch-norm, relu and
max-pool tail (each forward and backward), K10 the DGC top-k threshold's
histogram and the probes P1 (K7's 3x3 conv alone) and P2 (K7's 1x1 chain
alone) are CUDA C++ (`paddle_tpu_torch/csrc/`, built by `backend`); K4,
the LayerNorm forward, is Triton.  Each wrapper sits
beside its plain PyTorch version and counts its launches in
`backend.LAUNCHES`.
"""

from . import (  # noqa: F401
    attention, backend, flash_attention, fused_bottleneck, fused_probe,
    layer_norm, topk_threshold,
)
from .fused_bottleneck import (  # noqa: F401
    fused_bottleneck_down, fused_bottleneck_proj, fused_stem_tail,
)
