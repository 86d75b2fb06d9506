"""Tensor layer functions, static graph builders (port of
paddle_tpu/layers/tensor.py; Paddle-Fluid's fluid/layers/tensor.py and
the math layers of fluid/layers/nn.py: reduce_*, elementwise_*, cast,
concat, ...).
"""

import builtins
import numpy as np

from ..framework.layer_helper import LayerHelper
from ..framework.program import Variable

__all__ = [
    "cast", "concat", "sums", "assign", "fill_constant", "zeros", "ones",
    "zeros_like", "ones_like", "fill_constant_batch_size_like", "reshape",
    "squeeze", "unsqueeze", "flatten", "transpose", "split", "stack",
    "unstack", "expand", "expand_as", "gather", "gather_nd", "scatter",
    "slice", "strided_slice", "shape", "range", "linspace", "eye", "argmax",
    "argmin", "argsort", "where", "increment", "cumsum", "scale",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "reduce_sum", "reduce_mean",
    "reduce_max", "reduce_min", "reduce_prod", "reduce_all", "reduce_any",
    "mean", "abs", "exp", "log", "sqrt", "rsqrt", "square", "sign", "floor",
    "ceil", "round", "sin", "cos", "pow", "equal", "not_equal", "less_than",
    "less_equal", "greater_than", "greater_equal", "logical_and",
    "logical_or", "logical_not", "logical_xor", "elementwise_op_with_scalar",
    "create_global_var", "create_parameter", "maximum", "minimum",
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


def cast(x, dtype):
    return _single_out("cast", {"X": x}, {"out_dtype": dtype}, dtype=dtype,
                       same_shape=True)


def concat(input, axis=0, name=None):
    shapes = [v.shape for v in input]
    out_shape = None
    if all(sh is not None for sh in shapes):
        dims = [sh[axis] for sh in shapes]
        if all(d is not None and d != -1 for d in dims):
            out_shape = list(shapes[0])
            out_shape[axis] = sum(int(d) for d in dims)
            out_shape = tuple(out_shape)
    return _single_out("concat", {"X": list(input)}, {"axis": axis},
                       name=name, shape=out_shape)


def sums(input, name=None):
    return _single_out("sum", {"X": list(input)}, name=name)


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        # materialize as constant, dtype-faithfully: integers must not
        # round-trip through float32 (values above 2^24 would corrupt)
        out = output or helper.create_variable_for_type_inference(str(input.dtype))
        if np.issubdtype(input.dtype, np.integer):
            slot = "int64_values"
            vals = input.astype(np.int64).flatten().tolist()
        elif input.dtype == np.bool_:
            slot = "bool_values"
            vals = input.flatten().tolist()
        else:
            slot = "fp32_values"
            vals = input.astype(np.float32).flatten().tolist()
        helper.append_op(
            "assign_value", outputs={"Out": out},
            attrs={"shape": list(input.shape), "dtype": str(input.dtype),
                   slot: vals})
        return out
    out = output or helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("assign", inputs={"X": input}, outputs={"Out": out})
    return out


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, shape=shape)
    helper.append_op(
        "fill_constant", outputs={"Out": out},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)})
    return out


def zeros(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 0.0, name=name)


def ones(shape, dtype="float32", name=None):
    return fill_constant(shape, dtype, 1.0, name=name)


def zeros_like(x, name=None):
    return _single_out("fill_zeros_like", {"X": x}, name=name)


def ones_like(x, name=None):
    return _single_out("fill_any_like", {"X": x}, {"value": 1.0}, name=name)


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    return _single_out(
        "fill_constant_batch_size_like", {"Input": input},
        {"shape": list(shape), "dtype": dtype, "value": float(value),
         "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx},
        dtype=dtype)


def reshape(x, shape, name=None, inplace=False, act=None):
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


def squeeze(input, axes=None, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("squeeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": axes or []})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    xshape = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("unsqueeze2", inputs={"X": input},
                     outputs={"Out": out, "XShape": xshape},
                     attrs={"axes": list(axes)})
    return out


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


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim, "sections": []}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "axis": dim, "sections": list(num_or_sections)}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in builtins.range(n)]
    helper.append_op("split", inputs={"X": input}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def stack(x, axis=0, name=None):
    return _single_out("stack", {"X": list(x)}, {"axis": axis},
                       out_slot="Y", name=name)


def unstack(x, axis=0, num=None, name=None):
    helper = LayerHelper("unstack", name=name)
    n = num if num is not None else int(x.shape[axis])
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in builtins.range(n)]
    helper.append_op("unstack", inputs={"X": x}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": n})
    return outs


def expand(x, expand_times, name=None):
    return _single_out("expand", {"X": x}, {"expand_times": list(expand_times)},
                       name=name)


def expand_as(x, target_tensor, name=None):
    return _single_out("expand_as", {"X": x, "target_tensor": target_tensor},
                       name=name)


def gather(input, index, axis=0, name=None):
    return _single_out("gather", {"X": input, "Index": index},
                       {"axis": axis}, name=name)


def gather_nd(input, index, name=None):
    return _single_out("gather_nd", {"X": input, "Index": index}, name=name)


def scatter(input, index, updates, overwrite=True, name=None):
    return _single_out("scatter",
                       {"X": input, "Ids": index, "Updates": updates},
                       {"overwrite": overwrite}, name=name)


def slice(input, axes, starts, ends, name=None):
    return _single_out("slice", {"Input": input},
                       {"axes": list(axes), "starts": list(starts),
                        "ends": list(ends), "decrease_axis": []}, name=name)


def strided_slice(input, axes, starts, ends, strides, name=None):
    return _single_out("strided_slice", {"Input": input},
                       {"axes": list(axes), "starts": list(starts),
                        "ends": list(ends), "strides": list(strides)},
                       name=name)


def shape(input, name=None):
    return _single_out("shape", {"Input": input}, dtype="int32", name=name)


def range(start, end, step, dtype="float32"):
    helper = LayerHelper("range")
    s = fill_constant([1], dtype, start) if not isinstance(start, Variable) else start
    e = fill_constant([1], dtype, end) if not isinstance(end, Variable) else end
    st = fill_constant([1], dtype, step) if not isinstance(step, Variable) else step
    return _single_out("range", {"Start": s, "End": e, "Step": st}, dtype=dtype)


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")
    s = fill_constant([1], dtype, start) if not isinstance(start, Variable) else start
    e = fill_constant([1], dtype, stop) if not isinstance(stop, Variable) else stop
    n = fill_constant([1], "int32", num) if not isinstance(num, Variable) else num
    return _single_out("linspace", {"Start": s, "Stop": e, "Num": n},
                       {"dtype": dtype}, dtype=dtype)


def eye(num_rows, num_columns=None, dtype="float32"):
    return _single_out("eye", {}, {"num_rows": num_rows,
                                   "num_columns": num_columns or num_rows,
                                   "dtype": dtype}, dtype=dtype)


def argmax(x, axis=0, name=None):
    return _single_out("arg_max", {"X": x}, {"axis": axis}, dtype="int64",
                       name=name)


def argmin(x, axis=0, name=None):
    return _single_out("arg_min", {"X": x}, {"axis": axis}, dtype="int64",
                       name=name)


def argsort(input, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int64")
    helper.append_op("argsort", inputs={"X": input},
                     outputs={"Out": out, "Indices": idx},
                     attrs={"axis": axis, "descending": descending})
    return out, idx


def where(condition, x, y, name=None):
    return _single_out("where", {"Condition": condition, "X": x, "Y": y},
                       name=name)


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": x}, outputs={"Out": out},
                     attrs={"step": float(value)})
    return out


def cumsum(x, axis=-1, exclusive=False, reverse=False, name=None):
    return _single_out("cumsum", {"X": x},
                       {"axis": axis, "exclusive": exclusive,
                        "reverse": reverse}, name=name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(
        "scale", inputs={"X": x}, outputs={"Out": out},
        attrs={"scale": float(scale), "bias": float(bias),
               "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def _elementwise_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype,
                                                        shape=x.shape)
        helper.append_op(op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": out}, attrs={"axis": axis})
        return helper.append_activation(out, act)

    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise_layer("elementwise_add")
elementwise_sub = _elementwise_layer("elementwise_sub")
elementwise_mul = _elementwise_layer("elementwise_mul")
elementwise_div = _elementwise_layer("elementwise_div")
elementwise_max = _elementwise_layer("elementwise_max")
elementwise_min = _elementwise_layer("elementwise_min")
elementwise_pow = _elementwise_layer("elementwise_pow")
elementwise_mod = _elementwise_layer("elementwise_mod")


def elementwise_op_with_scalar(x, other, op_type, reverse=False):
    """Support `var + 1.0` sugar on Variables (math_op_patch.py parity)."""
    if isinstance(other, Variable):
        a, b = (other, x) if reverse else (x, other)
        return _elementwise_layer(op_type)(a, b)
    val = float(other)
    if op_type == "elementwise_add":
        return scale(x, 1.0, val)
    if op_type == "elementwise_sub":
        return scale(x, -1.0, val) if reverse else scale(x, 1.0, -val)
    if op_type == "elementwise_mul":
        return scale(x, val, 0.0)
    if op_type == "elementwise_div":
        if reverse:
            c = fill_constant([1], x.dtype or "float32", val)
            return _elementwise_layer(op_type)(c, x)
        return scale(x, 1.0 / val, 0.0)
    c = fill_constant([1], x.dtype or "float32", val)
    a, b = (c, x) if reverse else (x, c)
    return _elementwise_layer(op_type)(a, b)


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        if dim is None:
            attrs = {"reduce_all": True, "keep_dim": keep_dim}
        else:
            d = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"dim": list(d), "keep_dim": keep_dim, "reduce_all": False}
        return _single_out(op_type, {"X": input}, attrs, name=name)

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")
reduce_all = _reduce_layer("reduce_all")
reduce_any = _reduce_layer("reduce_any")


def mean(x, name=None):
    return _single_out("mean", {"X": x}, name=name)


def _unary_layer(op_type):
    def layer(x, name=None):
        return _single_out(op_type, {"X": x}, name=name, same_shape=True)

    layer.__name__ = op_type
    return layer


abs = _unary_layer("abs")
exp = _unary_layer("exp")
log = _unary_layer("log")
sqrt = _unary_layer("sqrt")
rsqrt = _unary_layer("rsqrt")
square = _unary_layer("square")
sign = _unary_layer("sign")
floor = _unary_layer("floor")
ceil = _unary_layer("ceil")
round = _unary_layer("round")
sin = _unary_layer("sin")
cos = _unary_layer("cos")
logical_not = _unary_layer("logical_not")


def pow(x, factor=1.0, name=None):
    return _single_out("pow", {"X": x}, {"factor": factor}, name=name)


def _compare_layer(op_type):
    def layer(x, y, cond=None, name=None):
        helper = LayerHelper(op_type, name=name)
        out = cond or helper.create_variable_for_type_inference("bool")
        helper.append_op(op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": out})
        return out

    layer.__name__ = op_type
    return layer


equal = _compare_layer("equal")
not_equal = _compare_layer("not_equal")
less_than = _compare_layer("less_than")
less_equal = _compare_layer("less_equal")
greater_than = _compare_layer("greater_than")
greater_equal = _compare_layer("greater_equal")
logical_and = _compare_layer("logical_and")
logical_or = _compare_layer("logical_or")
logical_xor = _compare_layer("logical_xor")


def maximum(x, y, name=None):
    return _single_out("maximum", {"X": x, "Y": y}, name=name,
                       same_shape=True)


def minimum(x, y, name=None):
    return _single_out("minimum", {"X": x, "Y": y}, name=name,
                       same_shape=True)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..framework import unique_name
    from ..framework.program import default_main_program, default_startup_program
    from ..framework.initializer import ConstantInitializer

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


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    from ..framework.param_attr import ParamAttr

    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)
