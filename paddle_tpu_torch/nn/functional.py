"""Eager functional ops (port of paddle_tpu/nn/functional.py).

Plain tensor functions over torch tensors that share the op kernels in
`paddle_tpu_torch/ops/`, as the reference's functional twins share
`paddle_tpu/ops/`.  `linear`, `conv2d`, `cross_entropy`, `softmax` and
`log_softmax` consult the AMP autocast context (`amp.auto_cast`) through
`_amp_cast`, as the reference's do.  The reference's dygraph tape is not
ported.
"""

import numpy as np
import torch

from ..ops import nn_ops as _n
from ..ops.registry import get_op
from .parameter import default_rng


def _op(op_type, ins, attrs=None, out="Out"):
    """One registered op of the port (the ops the reference's functional
    twin calls, shared with the static path)."""
    return get_op(op_type).fn(ins, attrs or {})[out]


# -- activations ------------------------------------------------------------

def relu(x):
    return torch.relu(x)


def relu6(x):
    return _op("relu6", {"X": x})


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def gelu(x, approximate=False):
    """Exact (erf) GELU by default, as `jax.nn.gelu(approximate=False)`."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01):
    return _op("leaky_relu", {"X": x}, {"alpha": negative_slope})


def elu(x, alpha=1.0):
    return torch.nn.functional.elu(x, alpha=alpha)


def softplus(x):
    """log(1 + e^x) as `jax.nn.softplus` (logaddexp(x, 0)), without
    torch's linear cut above 20."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def silu(x):
    return torch.nn.functional.silu(x)


def swish(x, beta=1.0):
    return _op("swish", {"X": x}, {"beta": beta})


def hard_swish(x):
    return _op("hard_swish", {"X": x})


def hard_sigmoid(x):
    return _op("hard_sigmoid", {"X": x})


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


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, dilation=1,
                     groups=1):
    """The `conv2d_transpose` op (NCHW); weight is [Cin, Cout / groups,
    kh, kw]."""
    out = _n.conv2d_transpose({"Input": x, "Filter": weight}, {
        "strides": _pair_list(stride), "paddings": _pair_list(padding),
        "dilations": _pair_list(dilation), "groups": groups})["Output"]
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
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


def adaptive_avg_pool2d(x, output_size):
    return _n.pool2d({"X": x}, {"ksize": _pair_list(output_size),
                                "pooling_type": "avg",
                                "adaptive": True})["Out"]


def adaptive_max_pool2d(x, output_size):
    return _n.pool2d({"X": x}, {"ksize": _pair_list(output_size),
                                "pooling_type": "max",
                                "adaptive": True})["Out"]


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


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def mse_loss(input, label, reduction="mean"):
    return _reduce(torch.square(input - label), reduction)


def binary_cross_entropy_with_logits(logit, label, reduction="mean"):
    out = _op("sigmoid_cross_entropy_with_logits",
              {"X": logit, "Label": label})
    return _reduce(out, reduction)


def nll_loss(log_probs, label, reduction="mean"):
    idx = label.to(torch.int64)
    out = -torch.gather(log_probs, -1, idx[..., None])[..., 0]
    return _reduce(out, reduction)


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


def one_hot(x, num_classes):
    """f32 one-hot rows, as `jax.nn.one_hot`: an id outside [0,
    num_classes) gives a row of zeros."""
    x = x.to(torch.int32)
    classes = torch.arange(num_classes, dtype=torch.int32, device=x.device)
    return (x[..., None] == classes).to(torch.float32)


def _pad_index(n, before, after, mode, device):
    """Source index of each padded position along one dim of size n, as
    numpy's `reflect`, `symmetric`, `edge` and `wrap`."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    # reflect (no edge repeat) and symmetric (edge repeated) fold the
    # index into one period of the mirrored sequence
    period = 2 * (n - 1) if mode == "reflect" else 2 * n
    if period == 0:
        return torch.zeros_like(i)
    j = torch.remainder(i, period)
    if mode == "reflect":
        return torch.where(j < n, j, period - j)
    return torch.where(j < n, j, period - 1 - j)


def pad(x, pad_width, mode="constant", value=0.0):
    """`jnp.pad`: pad_width an int, one (before, after) pair or a pair
    per dim; mode constant, reflect, symmetric, edge or wrap."""
    widths = np.broadcast_to(np.asarray(pad_width, dtype=np.int64),
                             (x.dim(), 2))
    if mode == "constant":
        flat = []
        for before, after in widths[::-1]:
            flat += [int(before), int(after)]
        return torch.nn.functional.pad(x, flat, value=value)
    if mode not in ("reflect", "symmetric", "edge", "wrap"):
        raise ValueError(f"pad mode {mode!r} is not supported")
    for d, (before, after) in enumerate(widths):
        if before or after:
            x = x.index_select(d, _pad_index(x.shape[d], int(before),
                                             int(after), mode, x.device))
    return x


def interpolate(x, size=None, scale_factor=None, mode="nearest"):
    """The `interpolate` op: jax.image's half-pixel resize (antialiased
    when shrinking), as the reference's."""
    attrs = {"interp_method": mode}
    if size is not None:
        attrs["out_h"], attrs["out_w"] = int(size[0]), int(size[1])
    if scale_factor is not None:
        attrs["scale"] = float(scale_factor)
    return _n.interpolate({"X": x}, attrs)["Out"]


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
