"""Math ops (port of the static-graph slice of paddle_tpu/ops/math_ops.py:
the `elementwise_*` family :43-51, `scale` :54, `pow` :65, `matmul` :70,
`mul` :85, `sum` :103, the `reduce_*` family :129-135, `mean` :138, the
unaries :147-169, `clip` :172, `clip_by_norm` :177, `squared_l2_norm`
:186, `cumsum` :191, `arg_max` / `arg_min` / `argsort` :214-228,
`increment` :255, the compares and logicals :268-276, `maximum` :279 and
`minimum` :284).

The ops keep the reference's `(ins, attrs) -> outs` signature, its
attributes and its broadcast rule, and are registered under their op
types for the static-graph Executor.  Where torch's nearest call differs
from the reference's jnp one, the op computes the reference's result:
`elementwise_mod` takes the divisor's sign (`torch.remainder`), `round`
rounds half to even, and a sum, product or cumulative sum of integers or
booleans is int32, as JAX's is with x64 off (torch's is int64).
"""

import math

import torch

from ..core.dtype import index_dtype
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


def _elementwise(fn):
    def kernel(ins, attrs):
        x, y = ins["X"], ins["Y"]
        return {"Out": fn(x, _bcast_to(x, y, attrs.get("axis", -1)))}

    return kernel


for _name, _fn in (("elementwise_add", torch.add),
                   ("elementwise_sub", torch.sub),
                   ("elementwise_mul", torch.mul),
                   ("elementwise_div", torch.true_divide),
                   ("elementwise_max", torch.maximum),
                   ("elementwise_min", torch.minimum),
                   ("elementwise_pow", torch.pow),
                   ("elementwise_mod", torch.remainder),
                   ("elementwise_floordiv", torch.floor_divide)):
    register_op(_name)(_elementwise(_fn))


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


def _promoted(x, y):
    """x, y in their promoted dtype when they differ: jnp.matmul promotes
    mixed operands (f32 @ bf16 -> f32), torch's product raises."""
    if x.dtype == y.dtype:
        return x, y
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


@register_op("matmul")
def matmul(ins, attrs):
    """operators/matmul_op.cc:521 — optional transposes of the last two
    dims, then a (batched) product scaled by alpha."""
    x, y = ins["X"], ins["Y"]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    x, y = _promoted(x, y)
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
    x2, y2 = _promoted(x2, y2)
    return {"Out": (x2 @ y2).reshape(xs[:xnc] + ys[ync:])}


@register_op("pow")
def pow_(ins, attrs):
    return {"Out": torch.pow(ins["X"], attrs.get("factor", 1.0))}


@register_op("sum")
def sum_(ins, attrs):
    """operators/sum_op.cc: the sum of the N tensors of X, added in
    order."""
    xs = ins["X"]
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


def _float(x):
    # the reference's mean of an integer tensor is float32 (x64 off)
    return x if x.is_floating_point() else x.to(torch.float32)


_BOOL_AND_INTS = (torch.bool, torch.int8, torch.int16, torch.int32, torch.int64)


def _int32(out, x):
    # JAX sums, multiplies and accumulates bools and signed ints in int32
    return out.to(torch.int32) if x.dtype in _BOOL_AND_INTS else out


def _reduce_dims(x, attrs):
    """The reduced dims of a `reduce_*` op, each in [0, ndim): `dim`
    (default [0]), or every dim with reduce_all."""
    if attrs.get("reduce_all", False) or x.dim() == 0:
        return tuple(range(x.dim()))
    dim = attrs.get("dim", [0])
    dim = dim if isinstance(dim, (list, tuple)) else (dim,)
    return tuple(sorted({d % x.dim() for d in dim}))


def _reduce(fn):
    """operators/reduce_ops/: `fn(x, dims, keep)` over `_reduce_dims`;
    keep_dim keeps them as size 1."""
    def kernel(ins, attrs):
        x = ins["X"]
        return {"Out": fn(x, _reduce_dims(x, attrs),
                          attrs.get("keep_dim", False))}

    return kernel


def _prod(x, dims, keep):
    out = x
    for d in reversed(dims):
        out = out.prod(dim=d, keepdim=keep)
    return _int32(out, x)


register_op("reduce_mean")(_reduce(
    lambda x, dims, keep: _float(x).mean(dim=dims, keepdim=keep)))
register_op("reduce_sum")(_reduce(
    lambda x, dims, keep: _int32(x.sum(dim=dims, keepdim=keep), x)))
for _name, _fn in (("reduce_max", torch.amax), ("reduce_min", torch.amin),
                   ("reduce_all", torch.all), ("reduce_any", torch.any)):
    register_op(_name)(_reduce(
        lambda x, dims, keep, fn=_fn: fn(x, dim=dims, keepdim=keep)))
register_op("reduce_prod")(_reduce(_prod))


@register_op("mean")
def mean(ins, attrs):
    """operators/mean_op.cc: the mean of every element, a 0-d tensor (the
    reference's shape)."""
    return {"Out": _float(ins["X"]).mean()}


# ---------------------------------------------------------------------------
# unaries (the activations with simple math, operators/activation_op.cc)
# ---------------------------------------------------------------------------

def _unary(name, fn):
    register_op(name)(lambda ins, attrs: {"Out": fn(ins["X"])})


for _name, _fn in (
        ("abs", torch.abs), ("exp", torch.exp), ("log", torch.log),
        ("log2", torch.log2), ("log10", torch.log10),
        ("log1p", torch.log1p), ("sqrt", torch.sqrt),
        ("rsqrt", torch.rsqrt), ("square", torch.square),
        ("sign", torch.sign), ("floor", torch.floor), ("ceil", torch.ceil),
        # half to even, as jnp.round
        ("round", torch.round), ("sin", torch.sin), ("cos", torch.cos),
        ("tan", torch.tan), ("asin", torch.asin), ("acos", torch.acos),
        ("atan", torch.atan), ("sinh", torch.sinh), ("cosh", torch.cosh),
        ("reciprocal", lambda x: 1.0 / x),
        ("logical_not", torch.logical_not)):
    _unary(_name, _fn)


@register_op("clip")
def clip(ins, attrs):
    return {"Out": torch.clamp(ins["X"], attrs.get("min"), attrs.get("max"))}


@register_op("clip_by_norm")
def clip_by_norm(ins, attrs):
    """x * min(max_norm / max(||x||, 1e-12), 1) (operators/clip_by_norm_op.h)."""
    x = ins["X"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    scale = torch.clamp(attrs["max_norm"] / torch.clamp(norm, min=1e-12),
                        max=1.0)
    return {"Out": x * scale}


@register_op("squared_l2_norm")
def squared_l2_norm(ins, attrs):
    """The sum of squares of every element, a 0-d tensor."""
    return {"Out": torch.sum(torch.square(ins["X"])).reshape(())}


@register_op("cumsum")
def cumsum(ins, attrs):
    """operators/cum_op.h: along `axis` (the flattened tensor with
    `flatten`), from the end with `reverse`, each sum without its own
    element with `exclusive`."""
    x = ins["X"]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x = x.reshape(-1)
        axis = 0
    reverse = attrs.get("reverse", False)
    work = torch.flip(x, (axis,)) if reverse else x
    out = _int32(torch.cumsum(work, dim=axis), work)
    if attrs.get("exclusive", False):
        # shift by one along axis, zero first
        out = torch.cat([torch.zeros_like(out.narrow(axis, 0, 1)),
                         out.narrow(axis, 0, out.shape[axis] - 1)], dim=axis)
    if reverse:
        out = torch.flip(out, (axis,))
    return {"Out": out}


@register_op("arg_max")
def arg_max(ins, attrs):
    """The first maximum's index along `axis`, in the index dtype."""
    return {"Out": torch.argmax(ins["X"], dim=attrs.get("axis", -1)).to(
        index_dtype())}


@register_op("arg_min")
def arg_min(ins, attrs):
    return {"Out": torch.argmin(ins["X"], dim=attrs.get("axis", -1)).to(
        index_dtype())}


@register_op("argsort")
def argsort(ins, attrs):
    """A stable sort along `axis` (of -x when descending, as the
    reference sorts): the sorted values and their indices."""
    x = ins["X"]
    axis = attrs.get("axis", -1)
    key = -x if attrs.get("descending", False) else x
    idx = torch.argsort(key, dim=axis, stable=True)
    return {"Out": torch.take_along_dim(x, idx, dim=axis),
            "Indices": idx.to(index_dtype())}


@register_op("increment")
def increment(ins, attrs):
    return {"Out": ins["X"] + attrs.get("step", 1.0)}


def _compare(name, fn):
    register_op(name)(lambda ins, attrs: {"Out": fn(ins["X"], ins["Y"])})


for _name, _fn in (("less_than", torch.lt), ("less_equal", torch.le),
                   ("greater_than", torch.gt), ("greater_equal", torch.ge),
                   ("equal", torch.eq), ("not_equal", torch.ne),
                   ("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_xor", torch.logical_xor)):
    _compare(_name, _fn)


@register_op("maximum")
def maximum(ins, attrs):
    return {"Out": torch.maximum(ins["X"], ins["Y"])}


@register_op("minimum")
def minimum(ins, attrs):
    return {"Out": torch.minimum(ins["X"], ins["Y"])}
