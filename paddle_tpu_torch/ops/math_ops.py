"""Math ops (port of the static-zoo slice of paddle_tpu/ops/math_ops.py:
`elementwise_add` :43, `scale` :54, `matmul` :70, `mul` :85,
`reduce_mean` :130 and `mean` :138).

The ops keep the reference's `(ins, attrs) -> outs` signature, its
attributes and its broadcast rule, and are registered under their op
types for the static-graph Executor.
"""

import math

import torch

from .registry import register_op


def _bcast_to(x, y, axis):
    """Paddle's elementwise broadcast (elementwise_op_function.h): Y's
    dims line up with X's starting at `axis`; axis -1 (or None) aligns
    trailing dims as numpy does."""
    if x.dim() == y.dim() or y.dim() == 0:
        return y
    if axis is None or axis == -1:
        return y
    # trailing singleton dims so y's first dim lines up with x[axis]
    return y.reshape(tuple(y.shape) + (1,) * (x.dim() - axis - y.dim()))


@register_op("elementwise_add")
def elementwise_add(ins, attrs):
    x, y = ins["X"], ins["Y"]
    return {"Out": x + _bcast_to(x, y, attrs.get("axis", -1))}


@register_op("scale")
def scale(ins, attrs):
    """out = scale * x + bias, or scale * (x + bias) when
    bias_after_scale is false (operators/scale_op.cc)."""
    x = ins["X"]
    s = attrs.get("scale", 1.0)
    b = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": x * s + b}
    return {"Out": (x + b) * s}


@register_op("matmul")
def matmul(ins, attrs):
    """operators/matmul_op.cc:521 — optional transposes of the last two
    dims, then a (batched) product scaled by alpha."""
    x, y = ins["X"], ins["Y"]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("mul")
def mul(ins, attrs):
    """operators/mul_op.cc — X flattened to 2-D at x_num_col_dims, Y at
    y_num_col_dims, one product, the result shaped X.shape[:xnc] +
    Y.shape[ync:]."""
    x, y = ins["X"], ins["Y"]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(math.prod(xs[:xnc]), -1) if x.dim() > 2 else x
    y2 = y.reshape(-1, math.prod(ys[ync:])) if y.dim() > 2 else y
    return {"Out": (x2 @ y2).reshape(xs[:xnc] + ys[ync:])}


def _float(x):
    # the reference's mean of an integer tensor is float32 (x64 off)
    return x if x.is_floating_point() else x.to(torch.float32)


@register_op("reduce_mean")
def reduce_mean(ins, attrs):
    """operators/reduce_ops/reduce_mean_op.cc: over `dim` (default [0]),
    or every dim with reduce_all; keep_dim keeps them as size 1."""
    x = _float(ins["X"])
    keep = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False):
        dim = tuple(range(x.dim()))
    else:
        dim = attrs.get("dim", [0])
        dim = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
    return {"Out": x.mean(dim=dim, keepdim=keep)}


@register_op("mean")
def mean(ins, attrs):
    """operators/mean_op.cc: the mean of every element, a 0-d tensor (the
    reference's shape)."""
    return {"Out": _float(ins["X"]).mean()}
