"""Eager functional ops (port of the GPT and ResNet slices of
paddle_tpu/nn/functional.py).

Plain tensor functions over torch tensors that share the op kernels in
`paddle_tpu_torch/ops/`, as the reference's functional twins share
`paddle_tpu/ops/`.  `linear`, `conv2d`, `cross_entropy`, `softmax` and
`log_softmax` consult the AMP autocast context (`amp.auto_cast`) through
`_amp_cast`, as the reference's do.  The reference's dygraph tape is not
ported.
"""

import torch

from ..ops import nn_ops as _n
from .parameter import default_rng


def relu(x):
    return torch.relu(x)


def gelu(x, approximate=False):
    """Exact (erf) GELU by default, as `jax.nn.gelu(approximate=False)`."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def softmax(x, axis=-1):
    x = _amp_cast("softmax", x)
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1):
    x = _amp_cast("log_softmax", x)
    return torch.log_softmax(x, dim=axis)


def _amp_cast(op_type, *xs):
    """Autocast hook: list-aware dispatch under amp.auto_cast (white ops
    run in the compute dtype, black ops are protected back to f32)."""
    from ..amp import autocast_enabled, cast_for_op

    if not autocast_enabled():
        return xs if len(xs) > 1 else xs[0]
    return cast_for_op(op_type, *xs)


def linear(x, weight, bias=None):
    """x @ weight (+ bias); weight keeps the reference layout [in, out]."""
    x, weight = _amp_cast("matmul", x, weight)
    out = torch.matmul(x, weight)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _pair_list(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """The `conv2d` op; weight is OIHW in both layouts."""
    x, weight = _amp_cast("conv2d", x, weight)
    out = _n.conv2d({"Input": x, "Filter": weight}, {
        "strides": _pair_list(stride), "paddings": _pair_list(padding),
        "dilations": _pair_list(dilation), "groups": groups,
        "data_format": data_format})["Output"]
    if bias is not None:
        bshape = (1, -1, 1, 1) if data_format == "NCHW" else (1, 1, 1, -1)
        out = out + bias.to(out.dtype).reshape(bshape)
    return out


def _pool(x, ptype, kernel_size, stride, padding, data_format, **extra):
    stride = stride if stride is not None else kernel_size
    return _n.pool2d({"X": x}, {
        "ksize": _pair_list(kernel_size), "strides": _pair_list(stride),
        "paddings": _pair_list(padding), "pooling_type": ptype,
        "data_format": data_format, **extra})["Out"]


def max_pool2d(x, kernel_size, stride=None, padding=0, data_format="NCHW"):
    return _pool(x, "max", kernel_size, stride, padding, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, exclusive=True,
               data_format="NCHW"):
    return _pool(x, "avg", kernel_size, stride, padding, data_format,
                 exclusive=exclusive)


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               stats_sample=0):
    """The `batch_norm` op: returns (Y, MeanOut, VarianceOut)."""
    out = _n.batch_norm(
        {"X": x, "Scale": weight, "Bias": bias, "Mean": running_mean,
         "Variance": running_var},
        {"momentum": momentum, "epsilon": epsilon, "is_test": not training,
         "data_layout": data_format, "stats_sample": stats_sample})
    return out["Y"], out["MeanOut"], out["VarianceOut"]


def cross_entropy(input, label, soft_label=False, axis=-1, reduction="mean",
                  ignore_index=-100):
    """Logits-based CE (softmax fused), the reference's
    softmax_with_cross_entropy."""
    logits = _amp_cast("softmax_with_cross_entropy", input)
    out = _n.softmax_with_cross_entropy(
        {"Logits": logits, "Label": label},
        {"soft_label": soft_label, "axis": axis,
         "ignore_index": ignore_index})["Loss"]
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def layer_norm(x, normalized_shape=None, weight=None, bias=None, epsilon=1e-5):
    if normalized_shape is None:
        begin = x.dim() - 1
    else:
        ns = ([normalized_shape] if isinstance(normalized_shape, int)
              else list(normalized_shape))
        begin = x.dim() - len(ns)
    return _n.layer_norm_y(
        x, None if weight is None else weight.reshape(-1),
        None if bias is None else bias.reshape(-1), epsilon, begin)


def dropout(x, p=0.5, training=True, mode="upscale_in_train",
            generator=None):
    """Dropout drawing from `generator`, or, when None, from
    `default_rng` (the train step's generator inside its key context)."""
    if p == 0.0 or (not training and mode == "upscale_in_train"):
        return x
    if generator is None:
        generator = default_rng.generator(x.device)
    return _n.dropout({"X": x},
                      {"dropout_prob": p, "is_test": not training,
                       "dropout_implementation": mode,
                       "_generator": generator})["Out"]


def embedding(ids, weight, padding_idx=None):
    return _n.lookup_table_v2(
        {"Ids": ids, "W": weight},
        {"padding_idx": -1 if padding_idx is None else padding_idx})["Out"]


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, scale=None, training=True,
                                 generator=None):
    """Fused attention entry point: the flash kernels (K1 forward, K2/K3
    backward) on a CUDA device when the call is inside their envelope,
    else the eager composition.  Training dropout draws from `generator`
    or, when None, from `default_rng` (the train step's generator).

    q/k/v: [batch, heads, seq, head_dim]."""
    from ..kernels import attention as _attn

    if generator is None and dropout_p > 0.0 and training:
        generator = default_rng.generator(q.device)
    return _attn.dot_product_attention(
        q, k, v, mask=attn_mask, dropout_p=dropout_p, is_causal=is_causal,
        scale=scale, training=training, generator=generator)
