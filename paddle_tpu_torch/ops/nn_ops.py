"""Neural-network op kernels (port of the GPT slice of
paddle_tpu/ops/nn_ops.py: `layer_norm` :556, `dropout` :655 and
`lookup_table_v2` :677).

The ops keep the reference's `(ins, attrs) -> outs` signature.  The
reference's op registry is not ported; callers import the functions.
"""

import torch

from ..kernels.layer_norm import layer_norm_fused


def _use_kernel(x):
    # the port's gate: the tensor lies on the card
    return x.is_cuda


def layer_norm_y(x, scale, bias, eps=1e-5, begin_norm_axis=1):
    """The `Y` output of `layer_norm` alone.  On a CUDA tensor, a
    last-axis norm with D % 128 == 0 and both scale and bias goes through
    the fused LayerNorm Function (K4 forward, K5 backward; f32
    statistics), so gradients reach x, scale and bias through the
    kernels; everything else takes the reference's eager composition,
    computed in the input dtype.

    (The reference computes Mean/Variance beside Y and lets XLA drop
    them when unread; eager PyTorch has no such pass, so the hot path
    calls this function and skips them.)"""
    if (_use_kernel(x) and begin_norm_axis == x.dim() - 1
            and x.shape[-1] % 128 == 0 and scale is not None
            and bias is not None):
        return layer_norm_fused(x.contiguous(), scale.reshape(-1),
                                bias.reshape(-1), eps)
    axes = tuple(range(begin_norm_axis, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = torch.square(x - mean).mean(dim=axes, keepdim=True)
    y = (x - mean) * (1.0 / torch.sqrt(var + eps))
    norm_shape = x.shape[begin_norm_axis:]
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    return y


def layer_norm(ins, attrs):
    """operators/layer_norm_op.cc — normalize over dims >= begin_norm_axis;
    outputs Y, Mean and Variance."""
    x = ins["X"]
    eps = attrs.get("epsilon", 1e-5)
    axis = attrs.get("begin_norm_axis", 1)
    scale, bias = ins.get("Scale"), ins.get("Bias")
    y = layer_norm_y(x, scale, bias, eps, axis)
    axes = tuple(range(axis, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = torch.square(x - mean).mean(dim=axes, keepdim=True)
    return {
        "Y": y,
        "Mean": mean.reshape(x.shape[:axis]),
        "Variance": var.reshape(x.shape[:axis]),
    }


def dropout(ins, attrs):
    """operators/dropout_op.cc.  The random bits come from
    `attrs["_generator"]` (a torch.Generator on x's device, or None for
    the default one); they cannot match the reference's JAX bits."""
    x = ins["X"]
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        return {"Out": out, "Mask": torch.ones_like(x)}
    keep = torch.rand(x.shape, generator=attrs.get("_generator"),
                      device=x.device) < (1.0 - p)
    zero = torch.zeros_like(x)
    if impl == "upscale_in_train":
        out = torch.where(keep, x / max(1.0 - p, 1e-12), zero)
    else:
        out = torch.where(keep, x, zero)
    return {"Out": out, "Mask": keep.to(x.dtype)}


def lookup_table_v2(ins, attrs):
    """operators/lookup_table_op.cc.  Negative ids index from the end,
    as in the reference; ids past the table raise (the reference's
    `jnp.take` fills NaN rows) — entry points validate ids first."""
    ids, w = ins["Ids"], ins["W"]
    padding_idx = attrs.get("padding_idx", -1)
    out = w[ids.long()]
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return {"Out": out}
