"""Neural-net layer functions, static graph builders (port of the
static-zoo slice of paddle_tpu/layers/nn.py; Paddle-Fluid's
fluid/layers/nn.py).

Each function appends recorded ops with the reference's op types, attrs
and declared shapes, so a Program built here serializes to the JAX
package's bytes.  The op functions live in `paddle_tpu_torch.ops`.
"""

from ..framework.initializer import ConstantInitializer
from ..framework.layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "softmax", "matmul", "relu", "gelu",
]


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("relu", inputs={"X": x}, outputs={"Out": out})
    return out


def gelu(x, approximate=False, name=None):
    helper = LayerHelper("gelu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("gelu", inputs={"X": x}, outputs={"Out": out},
                     attrs={"approximate": approximate})
    return out


def softmax(x, axis=-1, name=None, use_cudnn=False):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("softmax", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Flatten to 2-D at num_flatten_dims, multiply by W, add the bias
    from axis num_flatten_dims, then the activation (layers/nn.py fc)."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    if len(inputs) > 1:
        # the reference adds the products with a `sum` op
        raise NotImplementedError(
            "fc over several inputs needs the sum op (ROADMAP item 3, the "
            "rest of the static op set)")
    x = inputs[0]
    in_dim = 1
    for s in x.shape[num_flatten_dims:]:
        in_dim *= int(s)
    w = helper.create_parameter(
        param_attr, shape=[in_dim, size], dtype=helper.input_dtype(x))
    out_shape = (tuple(x.shape[:num_flatten_dims]) + (size,)
                 if x.shape is not None else None)
    pre_bias = helper.create_variable_for_type_inference(x.dtype,
                                                         shape=out_shape)
    helper.append_op(
        "mul", inputs={"X": x, "Y": w}, outputs={"Out": pre_bias},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[size],
                                    dtype=helper.input_dtype(x),
                                    is_bias=True)
        pre_act = helper.create_variable_for_type_inference(
            pre_bias.dtype, shape=pre_bias.shape)
        helper.append_op(
            "elementwise_add", inputs={"X": pre_bias, "Y": b},
            outputs={"Out": pre_act},
            attrs={"axis": num_flatten_dims})
        pre_bias = pre_act
    return helper.append_activation(pre_bias, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """lookup_table_v2 over a [vocab, dim] table.  is_sparse and
    is_distributed are recorded as attrs and change nothing here, as in
    the JAX package outside its parameter-server transpiler."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    out_shape = (tuple(input.shape) + (size[1],)
                 if input.shape is not None else None)
    out = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    helper.append_op(
        "lookup_table_v2", inputs={"Ids": input, "W": w},
        outputs={"Out": out},
        attrs={"padding_idx": -1 if padding_idx is None else padding_idx,
               "is_sparse": bool(is_sparse),
               "is_distributed": bool(is_distributed)})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           use_cudnn=True, data_format="NCHW", name=None):
    """operators/conv_op.cc; the bias adds along the channel dim."""
    helper = LayerHelper("conv2d", name=name)
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    padding = [padding, padding] if isinstance(padding, int) else list(padding)
    dilation = [dilation, dilation] if isinstance(dilation, int) else list(dilation)
    channels = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    w_shape = [num_filters, int(channels) // groups] + list(filter_size)
    w = helper.create_parameter(param_attr, shape=w_shape,
                                dtype=helper.input_dtype(input))
    out_shape = None
    if input.shape is not None:
        if data_format == "NCHW":
            n, _, h, wd = input.shape
        else:
            n, h, wd, _ = input.shape
        oh = ((int(h) + 2 * padding[0] - dilation[0] * (filter_size[0] - 1)
               - 1) // stride[0] + 1) if h is not None and h != -1 else None
        ow = ((int(wd) + 2 * padding[1] - dilation[1] * (filter_size[1] - 1)
               - 1) // stride[1] + 1) if wd is not None and wd != -1 else None
        out_shape = ((n, num_filters, oh, ow) if data_format == "NCHW"
                     else (n, oh, ow, num_filters))
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=out_shape)
    helper.append_op(
        "conv2d", inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups, "data_format": data_format})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=helper.input_dtype(input),
                                    is_bias=True)
        tmp = helper.create_variable_for_type_inference(out.dtype,
                                                        shape=out.shape)
        helper.append_op("elementwise_add", inputs={"X": out, "Y": b},
                         outputs={"Out": tmp},
                         attrs={"axis": 1 if data_format == "NCHW"
                                else -1})
        out = tmp
    return helper.append_activation(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCHW", name=None, use_cudnn=True):
    helper = LayerHelper("pool2d", name=name)
    ps = [pool_size, pool_size] if isinstance(pool_size, int) else list(pool_size)
    st = [pool_stride, pool_stride] if isinstance(pool_stride, int) else list(pool_stride)
    pd = [pool_padding, pool_padding] if isinstance(pool_padding, int) else list(pool_padding)
    out_shape = None
    if input.shape is not None:
        if data_format == "NCHW":
            n, c, h, wd = input.shape
        else:
            n, h, wd, c = input.shape
        if global_pooling:
            out_shape = ((n, c, 1, 1) if data_format == "NCHW"
                         else (n, 1, 1, c))
        elif h is not None and h != -1 and wd is not None and wd != -1:
            oh = (int(h) + 2 * pd[0] - ps[0]) // st[0] + 1
            ow = (int(wd) + 2 * pd[1] - ps[1]) // st[1] + 1
            out_shape = ((n, c, oh, ow) if data_format == "NCHW"
                         else (n, oh, ow, c))
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=out_shape)
    helper.append_op(
        "pool2d", inputs={"X": input}, outputs={"Out": out},
        attrs={"ksize": ps, "pooling_type": pool_type, "strides": st,
               "paddings": pd, "global_pooling": global_pooling,
               "exclusive": exclusive, "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False, name=None):
    """operators/batch_norm_op.cc; the moving mean and variance are
    persistable, non-trainable vars filled by the startup program."""
    helper = LayerHelper("batch_norm", name=name)
    c = int(input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    dtype = helper.input_dtype(input)
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    block = helper.main_program.global_block()
    sb = helper.startup_program.global_block()

    def _moving(name_hint, init_val):
        from ..framework import unique_name

        vname = name_hint or unique_name.generate(helper.name + ".moving")
        if vname not in block.vars:
            v = block.create_var(name=vname, shape=[c], dtype=dtype,
                                 persistable=True, stop_gradient=True)
        else:
            v = block.vars[vname]
        if vname not in sb.vars:
            sv = sb.create_var(name=vname, shape=[c], dtype=dtype,
                               persistable=True, stop_gradient=True)
            ConstantInitializer(init_val)(sv, sb)
        return v

    mean = _moving(moving_mean_name, 0.0)
    variance = _moving(moving_variance_name, 1.0)

    out = helper.create_variable_for_type_inference(dtype,
                                                    shape=input.shape)
    saved_mean = helper.create_variable_for_type_inference(dtype)
    saved_var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias,
                "Mean": mean, "Variance": variance},
        outputs={"Y": out, "MeanOut": mean, "VarianceOut": variance,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """operators/layer_norm_op.cc.  On the card a last-axis norm with D %
    128 == 0 and both scale and shift runs K4 forward and K5 backward
    (`ops.nn_ops.layer_norm_y`)."""
    helper = LayerHelper("layer_norm", name=name)
    dtype = helper.input_dtype(input)
    norm_size = 1
    for s in input.shape[begin_norm_axis:]:
        norm_size *= int(s)
    inputs = {"X": input}
    if scale:
        s_p = helper.create_parameter(
            param_attr, shape=[norm_size], dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = s_p
    if shift:
        b_p = helper.create_parameter(bias_attr, shape=[norm_size],
                                      dtype=dtype, is_bias=True)
        inputs["Bias"] = b_p
    out = helper.create_variable_for_type_inference(dtype,
                                                    shape=input.shape)
    mean = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "layer_norm", inputs=inputs,
        outputs={"Y": out, "Mean": mean, "Variance": var},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out, act)




def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out_shape = None
    if x.shape is not None and y.shape is not None:
        xs = list(x.shape)
        ys = list(y.shape)
        if transpose_x and len(xs) >= 2:
            xs[-1], xs[-2] = xs[-2], xs[-1]
        if transpose_y and len(ys) >= 2:
            ys[-1], ys[-2] = ys[-2], ys[-1]
        if len(xs) >= 2 and len(ys) >= 2:
            out_shape = tuple(xs[:-1] + [ys[-1]])
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    helper.append_op(
        "matmul", inputs={"X": x, "Y": y}, outputs={"Out": out},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": alpha})
    return out
