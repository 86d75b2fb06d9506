"""Tensor layer functions, static graph builders (port of the
static-zoo slice of paddle_tpu/layers/tensor.py; Paddle-Fluid's
fluid/layers/tensor.py and the math layers of fluid/layers/nn.py).
"""

from ..framework.layer_helper import LayerHelper
from ..framework.program import Variable

__all__ = [
    "fill_constant", "reshape", "flatten", "transpose", "scale",
    "elementwise_add", "reduce_mean", "mean", "elementwise_op_with_scalar",
    "create_global_var",
]


def _single_out(op_type, inputs, attrs=None, dtype=None, out_slot="Out",
                name=None, shape=None, same_shape=False):
    helper = LayerHelper(op_type, name=name)
    ref = None
    for v in inputs.values():
        vv = v[0] if isinstance(v, (list, tuple)) else v
        if isinstance(vv, Variable):
            ref = vv
            break
    if shape is None and same_shape and ref is not None:
        shape = ref.shape
    out = helper.create_variable_for_type_inference(
        dtype or (ref.dtype if ref is not None else "float32"), shape=shape)
    helper.append_op(op_type, inputs=inputs, outputs={out_slot: out},
                     attrs=attrs or {})
    return out


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, shape=shape)
    helper.append_op(
        "fill_constant", outputs={"Out": out},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)})
    return out


def reshape(x, shape, name=None, inplace=False, act=None):
    """reshape2; the declared shape copies x's dim where `shape` has a 0,
    as the reference declares it."""
    helper = LayerHelper("reshape2", name=name)
    new_shape = []
    for i, s_ in enumerate(shape):
        if s_ == 0 and x.shape is not None and i < len(x.shape):
            new_shape.append(x.shape[i])
        else:
            new_shape.append(s_)
    out = helper.create_variable_for_type_inference(x.dtype,
                                                    shape=tuple(new_shape))
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("reshape2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out_shape = None
    if x.shape is not None and all(s is not None and s != -1
                                   for s in x.shape[axis:]):
        rest = 1
        for s_ in x.shape[axis:]:
            rest *= int(s_)
        lead = x.shape[:axis]
        first = None
        if all(s is not None and s != -1 for s in lead):
            first = 1
            for s_ in lead:
                first *= int(s_)
        out_shape = (first, rest)
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("flatten2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": axis})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out_shape = (tuple(x.shape[p] for p in perm)
                 if x.shape is not None else None)
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    xshape = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("transpose2", inputs={"X": x},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axis": list(perm)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(
        "scale", inputs={"X": x}, outputs={"Out": out},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    """Paddle's broadcast: y's dims line up with x's from `axis`."""
    helper = LayerHelper("elementwise_add", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("elementwise_add", inputs={"X": x, "Y": y},
                     outputs={"Out": out}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def elementwise_op_with_scalar(x, other, op_type, reverse=False):
    """The Variable operator sugar (math_op_patch.py) over the ported
    ops: x + y of two Variables, and x + c, x - c, x * c, x / c, c + x,
    c - x, c * x of a Variable and a number, through `scale`."""
    if isinstance(other, Variable):
        if op_type == "elementwise_add":
            return elementwise_add(other, x) if reverse \
                else elementwise_add(x, other)
    else:
        val = float(other)
        if op_type == "elementwise_add":
            return scale(x, 1.0, val)
        if op_type == "elementwise_sub":
            return scale(x, -1.0, val) if reverse else scale(x, 1.0, -val)
        if op_type == "elementwise_mul":
            return scale(x, val, 0.0)
        if op_type == "elementwise_div" and not reverse:
            return scale(x, 1.0 / val, 0.0)
    raise NotImplementedError(
        f"Variable arithmetic needing the {op_type} op is not ported yet "
        f"(ROADMAP item 3, the rest of the static op set)")


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    """reduce_mean over `dim` (all dims when None).  The declared shape is
    left unknown, as the reference leaves it."""
    if dim is None:
        attrs = {"reduce_all": True, "keep_dim": keep_dim}
    else:
        d = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"dim": list(d), "keep_dim": keep_dim, "reduce_all": False}
    return _single_out("reduce_mean", {"X": input}, attrs, name=name)


def mean(x, name=None):
    return _single_out("mean", {"X": x}, name=name)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..framework import unique_name
    from ..framework.initializer import ConstantInitializer
    from ..framework.program import (default_main_program,
                                     default_startup_program)

    vname = name or unique_name.generate("global_var")
    block = default_main_program().global_block()
    var = block.create_var(name=vname, shape=shape, dtype=dtype,
                           persistable=persistable, stop_gradient=True)
    sb = default_startup_program().global_block()
    if vname not in sb.vars:
        sv = sb.create_var(name=vname, shape=shape, dtype=dtype,
                           persistable=persistable, stop_gradient=True)
        ConstantInitializer(value)(sv, sb)
    return var

