"""Neural-network op kernels (port of the GPT and ResNet slices of
paddle_tpu/ops/nn_ops.py: `softmax_with_cross_entropy` :161, `conv2d`
:281, `pool2d` :422, `batch_norm` :488, `layer_norm` :556, `dropout`
:655 and `lookup_table_v2` :677).

The ops keep the reference's `(ins, attrs) -> outs` signature.  The
reference's op registry is not ported; callers import the functions.
"""

import torch
import torch.nn.functional as TF

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


def softmax_with_cross_entropy(ins, attrs):
    """operators/softmax_with_cross_entropy_op.cc: log-softmax over
    `axis`, then the picked (hard label) or weighted (soft label) negative
    log-probability, kept as a size-1 axis; ignore_index rows give 0."""
    logits, label = ins["Logits"], ins["Label"]
    axis = attrs.get("axis", -1)
    logp = torch.log_softmax(logits, dim=axis)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        idx = label.long()
        if idx.dim() == logits.dim():
            idx = idx.squeeze(axis)
        ignore = attrs.get("ignore_index", -100)
        skip = (idx == ignore).unsqueeze(axis)
        picked = torch.gather(logp, axis,
                              torch.where(skip, 0, idx.unsqueeze(axis)))
        loss = torch.where(skip, torch.zeros_like(picked), -picked)
    return {"Softmax": torch.exp(logp), "Loss": loss}


# ---------------------------------------------------------------------------
# convolution and pooling
# ---------------------------------------------------------------------------

def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,) * n


def _conv_pad(paddings, algo, n):
    """The reference padding attr (+ padding_algorithm SAME/VALID) as
    [(before, after)] * n, or "SAME"."""
    if algo == "VALID":
        return [(0, 0)] * n
    if algo == "SAME":
        return "SAME"
    p = _pair(paddings, n)
    if len(p) == n:
        return [(int(pi), int(pi)) for pi in p]
    return [(int(p[2 * i]), int(p[2 * i + 1])) for i in range(n)]


def _same_pads(sizes, ksize, strides, dilations):
    """XLA's SAME padding: output ceil(in / stride), the extra row or
    column after."""
    pads = []
    for size, k, s, d in zip(sizes, ksize, strides, dilations):
        eff = (k - 1) * d + 1
        total = max((-(-size // s) - 1) * s + eff - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_hw(x, pads, value=0.0):
    """Pad the two spatial dims (the last two of an NCHW tensor)."""
    (t, b), (l, r) = pads
    if t == b == l == r == 0:
        return x
    return TF.pad(x, (l, r, t, b), value=value)


def _to_nchw(x, data_format):
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(x, data_format):
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


def conv2d(ins, attrs):
    """operators/conv_op.cc: NCHW or NHWC input, OIHW filter; explicit,
    SAME or VALID padding, strides, dilations and groups.  The product is
    `torch.nn.functional.conv2d` (the reference leaves it to XLA); NHWC
    is permuted around the call, so the op keeps the reference's layout
    at its boundary.  The output keeps x's dtype."""
    x, w = ins["Input"], ins["Filter"]
    strides = _pair(attrs.get("strides", [1, 1]))
    dilations = _pair(attrs.get("dilations", [1, 1]))
    groups = attrs.get("groups", 1)
    fmt = "NHWC" if attrs.get("data_format", "NCHW") == "NHWC" else "NCHW"
    pads = _conv_pad(attrs.get("paddings", [0, 0]),
                     attrs.get("padding_algorithm", "EXPLICIT"), 2)
    xc = _to_nchw(x, fmt)
    if pads == "SAME":
        pads = _same_pads(xc.shape[2:], w.shape[2:], strides, dilations)
    if all(lo == hi for lo, hi in pads):
        out = TF.conv2d(xc, w, stride=strides, padding=[p[0] for p in pads],
                        dilation=dilations, groups=groups)
    else:
        out = TF.conv2d(_pad_hw(xc, pads), w, stride=strides,
                        dilation=dilations, groups=groups)
    return {"Output": _from_nchw(out.to(x.dtype), fmt)}


def pool2d(ins, attrs):
    """operators/pool_op.cc: max or average pooling, global, adaptive
    (divisible sizes, as the reference) or windowed with explicit, SAME
    or VALID padding; average pooling is exclusive of padding by default.

    Max pooling pads with -inf and takes the window max; its gradient
    goes to the FIRST maximum of each window in row-major order, as XLA's
    select_and_scatter and the reference's `_maxpool_first_match` give
    it, so FLAGS_maxpool_mask_bwd (the reference's recompute-mask
    backward, the same tie semantics) changes nothing here."""
    x = ins["X"]
    ptype = attrs.get("pooling_type", "max")
    fmt = "NHWC" if attrs.get("data_format", "NCHW") == "NHWC" else "NCHW"
    spatial = (1, 2) if fmt == "NHWC" else (2, 3)
    adaptive = attrs.get("adaptive", False)
    ksize = _pair(attrs.get("ksize", [2, 2]))
    if attrs.get("global_pooling", False) or (adaptive
                                              and tuple(ksize) == (1, 1)):
        if ptype == "max":
            return {"Out": x.amax(dim=spatial, keepdim=True)}
        return {"Out": x.mean(dim=spatial, keepdim=True)}
    xc = _to_nchw(x, fmt)
    if adaptive:
        in_h, in_w = xc.shape[2], xc.shape[3]
        oh, ow = ksize
        sh, sw = in_h // oh, in_w // ow
        strides = (sh, sw)
        ksize = (in_h - (oh - 1) * sh, in_w - (ow - 1) * sw)
        pads = [(0, 0), (0, 0)]
    else:
        strides = _pair(attrs.get("strides", [1, 1]))
        pads = _conv_pad(attrs.get("paddings", [0, 0]),
                         attrs.get("padding_algorithm", "EXPLICIT"), 2)
        if pads == "SAME":
            pads = _same_pads(xc.shape[2:], ksize, strides, (1, 1))
    if ptype == "max":
        out = TF.max_pool2d(_pad_hw(xc, pads, float("-inf")), ksize,
                            strides)
    else:
        window = ksize[0] * ksize[1]
        summed = TF.avg_pool2d(_pad_hw(xc, pads), ksize, strides) * window
        has_pad = any(p != (0, 0) for p in pads)
        if attrs.get("exclusive", True) and has_pad:
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=xc.dtype,
                              device=xc.device)
            counts = TF.avg_pool2d(_pad_hw(ones, pads), ksize,
                                   strides) * window
            out = summed / counts
        else:
            out = summed / window
    return {"Out": _from_nchw(out.to(x.dtype), fmt)}


# ---------------------------------------------------------------------------
# batch norm
# ---------------------------------------------------------------------------

def batch_norm_stats(x, mean_in, var_in, momentum, epsilon, c_axis,
                     stats_sample=0):
    """The batch statistics of `batch_norm` in training: two-pass mean
    and biased variance in acc_t = promote(x, Mean), over the first
    `stats_sample` samples when 0 < stats_sample < N, and the running
    stats updated the reference's way, `running * m + batch * (1 - m)`.
    Returns (mean, var, mean_out, var_out)."""
    acc_t = torch.promote_types(x.dtype, mean_in.dtype)
    reduce_axes = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    xs = x[:stats_sample] if 0 < stats_sample < x.shape[0] else x
    xs = xs.to(acc_t)
    mean = xs.mean(dim=reduce_axes)
    var = torch.square(xs - mean.reshape(bshape)).mean(dim=reduce_axes)
    mean_out = mean_in * momentum + mean * (1 - momentum)
    var_out = var_in * momentum + var * (1 - momentum)
    return mean, var, mean_out, var_out


def batch_norm(ins, attrs):
    """operators/batch_norm_op.cc, as the reference computes it (not
    `F.batch_norm`): statistics in f32 by `batch_norm_stats` (biased
    variance, Paddle's momentum, `stats_sample`), or the running stats
    under `is_test` / `use_global_stats`; then Y = x * a + b in x's own
    dtype with a = scale / sqrt(var + eps) and b = bias - mean * a cast
    to it.  MeanOut / VarianceOut are the updated running stats;
    SavedMean / SavedVariance the batch mean and 1 / sqrt(var + eps)
    (zeros with global stats)."""
    x = ins["X"]
    scale, bias = ins["Scale"], ins["Bias"]
    mean_in, var_in = ins["Mean"], ins["Variance"]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    use_global = (attrs.get("use_global_stats", False)
                  or attrs.get("is_test", False))
    layout = attrs.get("data_layout", "NCHW")
    c_axis = 1 if layout in ("NCHW", "AnyLayout") else x.dim() - 1
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]
    acc_t = torch.promote_types(x.dtype, mean_in.dtype)
    if use_global:
        mean, var, mean_out, var_out = mean_in, var_in, mean_in, var_in
    else:
        mean, var, mean_out, var_out = batch_norm_stats(
            x, mean_in, var_in, momentum, eps, c_axis,
            int(attrs.get("stats_sample", 0) or 0))
    inv = 1.0 / torch.sqrt(var + eps)
    if use_global:
        saved_mean, saved_var = torch.zeros_like(mean_in), \
            torch.zeros_like(var_in)
    else:
        saved_mean, saved_var = mean, inv
    a = (inv * scale.to(acc_t)).to(x.dtype)
    b = (bias.to(acc_t) - mean * inv * scale.to(acc_t)).to(x.dtype)
    y = x * a.reshape(bshape) + b.reshape(bshape)
    return {"Y": y, "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": saved_mean, "SavedVariance": saved_var}
