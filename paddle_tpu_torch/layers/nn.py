"""Neural-net layer functions, static graph builders (port of
paddle_tpu/layers/nn.py; Paddle-Fluid's fluid/layers/nn.py).

Each function appends recorded ops with the reference's op types, attrs
and declared shapes, so a Program built here serializes to the JAX
package's bytes.  The op functions live in `paddle_tpu_torch.ops`.  On
the card a `layer_norm` over the last axis with D % 128 == 0 and both
scale and shift runs K4 forward and K5 backward
(`ops.nn_ops.layer_norm_y`).
"""

from ..framework.layer_helper import LayerHelper
from ..framework.initializer import ConstantInitializer

__all__ = [
    "fc", "embedding", "conv2d", "conv2d_transpose", "depthwise_conv2d",
    "pool2d", "adaptive_pool2d", "batch_norm", "layer_norm", "group_norm",
    "instance_norm", "dropout", "softmax", "log_softmax", "matmul", "mul",
    "topk", "one_hot", "clip", "clip_by_norm", "l2_normalize", "pad",
    "pad2d", "label_smooth", "relu", "sigmoid", "tanh", "gelu", "relu6",
    "leaky_relu", "elu", "swish", "hard_swish", "hard_sigmoid", "prelu",
    "softplus", "softsign", "resize_nearest", "resize_bilinear", "lstm_unit",
]


def _unary_layer(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype,
                                                        shape=x.shape)
        helper.append_op(op_type, inputs={"X": x}, outputs={"Out": out})
        return out

    layer.__name__ = op_type
    return layer


relu = _unary_layer("relu")
sigmoid = _unary_layer("sigmoid")
tanh = _unary_layer("tanh")
relu6 = _unary_layer("relu6")
softplus = _unary_layer("softplus")
softsign = _unary_layer("softsign")


def gelu(x, approximate=False, name=None):
    helper = LayerHelper("gelu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("gelu", inputs={"X": x}, outputs={"Out": out},
                     attrs={"approximate": approximate})
    return out


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("leaky_relu", inputs={"X": x}, outputs={"Out": out},
                     attrs={"alpha": alpha})
    return out


def elu(x, alpha=1.0, name=None):
    helper = LayerHelper("elu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("elu", inputs={"X": x}, outputs={"Out": out},
                     attrs={"alpha": alpha})
    return out


def swish(x, beta=1.0, name=None):
    helper = LayerHelper("swish", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("swish", inputs={"X": x}, outputs={"Out": out},
                     attrs={"beta": beta})
    return out


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    helper = LayerHelper("hard_swish", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("hard_swish", inputs={"X": x}, outputs={"Out": out},
                     attrs={"threshold": threshold, "scale": scale,
                            "offset": offset})
    return out


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    helper = LayerHelper("hard_sigmoid", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("hard_sigmoid", inputs={"X": x}, outputs={"Out": out},
                     attrs={"slope": slope, "offset": offset})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    helper = LayerHelper("prelu", name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = [int(s) for s in x.shape[1:]]
    alpha = helper.create_parameter(
        param_attr, alpha_shape, x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("prelu", inputs={"X": x, "Alpha": alpha},
                     outputs={"Out": out}, attrs={"mode": mode})
    return out


def softmax(x, axis=-1, name=None, use_cudnn=False):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("softmax", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def log_softmax(x, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("log_softmax", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Parity: layers/nn.py fc — flatten to 2-D, W matmul, bias, act."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_outs = []
    for i, x in enumerate(inputs):
        in_dim = 1
        for s in x.shape[num_flatten_dims:]:
            in_dim *= int(s)
        w = helper.create_parameter(
            param_attr, shape=[in_dim, size], dtype=helper.input_dtype(x))
        out_shape = (tuple(x.shape[:num_flatten_dims]) + (size,)
                     if x.shape is not None else None)
        tmp = helper.create_variable_for_type_inference(x.dtype,
                                                        shape=out_shape)
        helper.append_op(
            "mul", inputs={"X": x, "Y": w}, outputs={"Out": tmp},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
        mul_outs.append(tmp)
    if len(mul_outs) == 1:
        pre_bias = mul_outs[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            inputs[0].dtype, shape=mul_outs[0].shape)
        helper.append_op("sum", inputs={"X": mul_outs},
                         outputs={"Out": pre_bias})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[size],
                                    dtype=helper.input_dtype(inputs[0]),
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
    the JAX package outside its parameter-server transpiler; the
    gradient is one dense accumulate into the table."""
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
    """Parity: layers/nn.py conv2d (operators/conv_op.cc)."""
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
        # spatial dims sit at (2, 3) for NCHW, (1, 2) for NHWC
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
        # bias broadcasts over the CHANNEL dim: 1 for NCHW, trailing
        # for NHWC (axis=-1 aligns y's dims to x's trailing dims)
        helper.append_op("elementwise_add", inputs={"X": out, "Y": b},
                         outputs={"Out": tmp},
                         attrs={"axis": 1 if data_format == "NCHW"
                                else -1})
        out = tmp
    return helper.append_activation(out, act)


def depthwise_conv2d(input, num_filters, filter_size, **kwargs):
    kwargs["groups"] = int(
        input.shape[1] if kwargs.get("data_format", "NCHW") == "NCHW"
        else input.shape[-1])
    return conv2d(input, num_filters, filter_size, **kwargs)


def conv2d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv2d_transpose", name=name)
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    padding = [padding, padding] if isinstance(padding, int) else list(padding)
    dilation = [dilation, dilation] if isinstance(dilation, int) else list(dilation)
    if filter_size is None:
        raise ValueError("filter_size required")
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    channels = int(input.shape[1])
    w_shape = [channels, num_filters // groups] + list(filter_size)
    w = helper.create_parameter(param_attr, shape=w_shape,
                                dtype=helper.input_dtype(input))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        "conv2d_transpose", inputs={"Input": input, "Filter": w},
        outputs={"Output": out},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation,
               "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=helper.input_dtype(input), is_bias=True)
        tmp = helper.create_variable_for_type_inference(out.dtype)
        helper.append_op("elementwise_add", inputs={"X": out, "Y": b},
                         outputs={"Out": tmp}, attrs={"axis": 1})
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


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    helper = LayerHelper("adaptive_pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ps = [pool_size, pool_size] if isinstance(pool_size, int) else list(pool_size)
    helper.append_op(
        "pool2d", inputs={"X": input}, outputs={"Out": out},
        attrs={"ksize": ps, "pooling_type": pool_type, "adaptive": True})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats=False, name=None):
    """Parity: layers/nn.py batch_norm (operators/batch_norm_op.cc)."""
    helper = LayerHelper("batch_norm", name=name)
    c = int(input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    dtype = helper.input_dtype(input)
    scale = helper.create_parameter(
        param_attr, shape=[c], dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    # moving stats: persistable non-trainable
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


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, name=None):
    helper = LayerHelper("group_norm", name=name)
    c = int(input.shape[1])
    dtype = helper.input_dtype(input)
    inputs = {"X": input}
    if param_attr is not False:
        inputs["Scale"] = helper.create_parameter(
            param_attr, [c], dtype,
            default_initializer=ConstantInitializer(1.0))
    if bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(bias_attr, [c], dtype,
                                                 is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    helper.append_op("group_norm", inputs=inputs,
                     outputs={"Y": out, "Mean": mean, "Variance": var},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(out, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", name=name)
    c = int(input.shape[1])
    dtype = helper.input_dtype(input)
    inputs = {"X": input}
    if param_attr is not False:
        inputs["Scale"] = helper.create_parameter(
            param_attr, [c], dtype,
            default_initializer=ConstantInitializer(1.0))
    if bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(bias_attr, [c], dtype,
                                                 is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    sm = helper.create_variable_for_type_inference(dtype)
    sv = helper.create_variable_for_type_inference(dtype)
    helper.append_op("instance_norm", inputs=inputs,
                     outputs={"Y": out, "SavedMean": sm, "SavedVariance": sv},
                     attrs={"epsilon": epsilon})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None,
            dropout_implementation="downgrade_in_infer", name=None):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    mask = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(
        "dropout", inputs={"X": x}, outputs={"Out": out, "Mask": mask},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "dropout_implementation": dropout_implementation})
    return out


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


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out_shape = None
    if x.shape is not None and y.shape is not None:
        out_shape = tuple(x.shape[:x_num_col_dims]) + tuple(y.shape[y_num_col_dims:])
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    helper.append_op(
        "mul", inputs={"X": x, "Y": y}, outputs={"Out": out},
        attrs={"x_num_col_dims": x_num_col_dims,
               "y_num_col_dims": y_num_col_dims})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op("top_k", inputs={"X": input},
                     outputs={"Out": values, "Indices": indices},
                     attrs={"k": k})
    return values, indices


def one_hot(input, depth, name=None):
    helper = LayerHelper("one_hot", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("one_hot", inputs={"X": input}, outputs={"Out": out},
                     attrs={"depth": depth})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("clip", inputs={"X": x}, outputs={"Out": out},
                     attrs={"min": min, "max": max})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op("clip_by_norm", inputs={"X": x}, outputs={"Out": out},
                     attrs={"max_norm": max_norm})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("norm", inputs={"X": x},
                     outputs={"Out": out, "Norm": norm},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pad", inputs={"X": x}, outputs={"Out": out},
                     attrs={"paddings": paddings, "pad_value": pad_value})
    return out


def pad2d(x, paddings, mode="constant", pad_value=0.0, name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("pad2d", inputs={"X": x}, outputs={"Out": out},
                     attrs={"paddings": paddings, "mode": mode,
                            "pad_value": pad_value})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(label.dtype)
    inputs = {"X": label}
    if prior_dist is not None:
        inputs["PriorDist"] = prior_dist
    helper.append_op("label_smooth", inputs=inputs, outputs={"Out": out},
                     attrs={"epsilon": epsilon})
    return out


def _resize(method):
    def layer(input, out_shape=None, scale=None, name=None):
        helper = LayerHelper(f"resize_{method}", name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        attrs = {"interp_method": method}
        if out_shape is not None:
            attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
        if scale is not None:
            attrs["scale"] = float(scale)
        helper.append_op("interpolate", inputs={"X": input},
                         outputs={"Out": out}, attrs=attrs)
        return out

    return layer


resize_nearest = _resize("nearest")
resize_bilinear = _resize("bilinear")


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """Single LSTM step built from primitive ops (parity: layers/nn.py
    lstm_unit)."""
    from . import tensor as tlayers

    helper = LayerHelper("lstm_unit", name=name)
    size = int(cell_t_prev.shape[-1])
    concat_in = tlayers.concat([x_t, hidden_t_prev], axis=-1)
    gates = fc(concat_in, 4 * size, param_attr=param_attr,
               bias_attr=bias_attr)
    splits = tlayers.split(gates, num_or_sections=4, dim=-1)
    i, f, c_hat, o = splits
    f_b = tlayers.scale(f, bias=forget_bias) if forget_bias else f
    new_cell = sigmoid(f_b) * cell_t_prev + sigmoid(i) * tanh(c_hat)
    new_hidden = sigmoid(o) * tanh(new_cell)
    return new_hidden, new_cell
