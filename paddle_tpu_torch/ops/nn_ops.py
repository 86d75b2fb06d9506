"""Neural-network op kernels (port of the GPT, ResNet and static-graph
slices of paddle_tpu/ops/nn_ops.py: the activations :32-75, `prelu`
:120, `softmax` :129, `log_softmax` :134, `cross_entropy` :143,
`softmax_with_cross_entropy` :161, the losses :178-243, `conv2d` :281,
`depthwise_conv2d` :310, `conv2d_transpose` :319, `pool2d` :422,
`batch_norm` :488, `layer_norm` :556, `instance_norm` :604, `group_norm`
:622, `norm` :642, `dropout` :655, `lookup_table_v2` :677, `one_hot`
:703, `top_k` :711, `accuracy` :737, `pad` / `pad2d` :753-762 and
`interpolate` :775).

The ops keep the reference's `(ins, attrs) -> outs` signature and are
registered under their op types (`ops/registry.py`) for the static-graph
Executor; the dygraph modules call the functions directly.
"""

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.dtype import index_dtype
from ..kernels.layer_norm import layer_norm_fused
from .registry import register_op


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


# ---------------------------------------------------------------------------
# activations, softmax, losses and metrics of the static zoo
# ---------------------------------------------------------------------------

@register_op("relu")
def relu(ins, attrs):
    return {"Out": torch.relu(ins["X"])}


def _unary(name, fn):
    register_op(name)(lambda ins, attrs: {"Out": fn(ins["X"])})


for _name, _fn in (("sigmoid", torch.sigmoid), ("tanh", torch.tanh),
                   ("softplus", TF.softplus), ("softsign", TF.softsign),
                   ("relu6", lambda x: torch.clamp(x, 0.0, 6.0))):
    _unary(_name, _fn)


@register_op("leaky_relu")
def leaky_relu(ins, attrs):
    x = ins["X"]
    return {"Out": torch.where(x >= 0, x, attrs.get("alpha", 0.02) * x)}


@register_op("elu")
def elu(ins, attrs):
    return {"Out": TF.elu(ins["X"], alpha=attrs.get("alpha", 1.0))}


@register_op("hard_sigmoid")
def hard_sigmoid(ins, attrs):
    return {"Out": torch.clamp(attrs.get("slope", 0.2) * ins["X"]
                               + attrs.get("offset", 0.5), 0.0, 1.0)}


@register_op("hard_swish")
def hard_swish(ins, attrs):
    x = ins["X"]
    return {"Out": x * torch.clamp(x + attrs.get("offset", 3.0), 0.0,
                                   attrs.get("threshold", 6.0))
            / attrs.get("scale", 6.0)}


@register_op("swish")
def swish(ins, attrs):
    x = ins["X"]
    return {"Out": x * torch.sigmoid(attrs.get("beta", 1.0) * x)}


@register_op("prelu")
def prelu(ins, attrs):
    """x where x >= 0, alpha * x elsewhere; alpha one value ("all"), one
    per channel ("channel", on dim 1) or one per element."""
    x, alpha = ins["X"], ins["Alpha"]
    if attrs.get("mode", "all") == "channel" and alpha.dim() == 1:
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": torch.where(x >= 0, x, alpha * x)}


@register_op("gelu")
def gelu(ins, attrs):
    """The erf form, or the tanh form when `approximate` (as
    jax.nn.gelu)."""
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": TF.gelu(ins["X"], approximate=approximate)}


@register_op("softmax")
def softmax(ins, attrs):
    return {"Out": torch.softmax(ins["X"], dim=attrs.get("axis", -1))}


@register_op("log_softmax")
def log_softmax(ins, attrs):
    return {"Out": torch.log_softmax(ins["X"], dim=attrs.get("axis", -1))}


@register_op("cross_entropy")
def cross_entropy(ins, attrs):
    """operators/cross_entropy_op.cc: X holds probabilities (after a
    softmax); -log of the picked (hard label) or label-weighted (soft)
    probability, floored at 1e-20, kept as a size-1 last axis;
    ignore_index rows give 0."""
    x, label = ins["X"], ins["Label"]
    if attrs.get("soft_label", False):
        out = -(label * torch.log(torch.clamp(x, min=1e-20))).sum(
            dim=-1, keepdim=True)
        return {"Y": out}
    idx = label.long()
    if idx.dim() == x.dim():
        idx = idx.squeeze(-1)
    skip = (idx == attrs.get("ignore_index", -100)).unsqueeze(-1)
    picked = torch.gather(x, -1, torch.where(skip, 0, idx.unsqueeze(-1)))
    logp = -torch.log(torch.clamp(picked, min=1e-20))
    return {"Y": torch.where(skip, torch.zeros_like(logp), logp)}


@register_op("square_error_cost")
def square_error_cost(ins, attrs):
    return {"Out": torch.square(ins["X"] - ins["Y"])}


@register_op("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(ins, attrs):
    """max(x, 0) - x * label + log1p(exp(-|x|)), 0 where the label is
    `ignore_index`; with `normalize`, divided by the count of the other
    labels (at least 1)."""
    x, label = ins["X"], ins["Label"]
    loss = (torch.clamp(x, min=0) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    ignore = attrs.get("ignore_index", -100)
    keep = label != ignore
    loss = torch.where(keep, loss, torch.zeros_like(loss))
    if attrs.get("normalize", False):
        loss = loss / torch.clamp(keep.sum(dtype=torch.int32), min=1)
    return {"Out": loss}


@register_op("smooth_l1_loss")
def smooth_l1_loss(ins, attrs):
    """Per row: the sum of 0.5 sigma^2 d^2 where |d| < 1 / sigma^2, else
    |d| - 0.5 / sigma^2, over d = X - Y; Out [N, 1], Diff d."""
    s2 = attrs.get("sigma", 1.0) ** 2
    diff = ins["X"] - ins["Y"]
    ad = torch.abs(diff)
    out = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    out = out.sum(dim=tuple(range(1, out.dim()))) if out.dim() > 1 else out
    return {"Out": out.reshape(-1, 1), "Diff": diff}


@register_op("huber_loss")
def huber_loss(ins, attrs):
    delta = attrs.get("delta", 1.0)
    r = ins["Y"] - ins["X"]
    ar = torch.abs(r)
    out = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Out": out, "Residual": r}


@register_op("bce_loss")
def bce_loss(ins, attrs):
    """The binary cross entropy of X clipped to [1e-12, 1 - 1e-12] (not
    F.binary_cross_entropy, whose log clamps at -100)."""
    x, label = ins["X"], ins["Label"]
    x = torch.clamp(x, 1e-12, 1.0 - 1e-12)
    return {"Out": -(label * torch.log(x)
                     + (1 - label) * torch.log(1 - x))}


@register_op("log_loss")
def log_loss(ins, attrs):
    eps = attrs.get("epsilon", 1e-4)
    p, label = ins["Predicted"], ins["Labels"]
    return {"Loss": -label * torch.log(p + eps)
            - (1 - label) * torch.log(1 - p + eps)}


@register_op("label_smooth")
def label_smooth(ins, attrs):
    eps = attrs.get("epsilon", 0.0)
    x = ins["X"]
    prior = ins.get("PriorDist")
    if prior is not None:
        return {"Out": (1 - eps) * x + eps * prior}
    return {"Out": (1 - eps) * x + eps / x.shape[-1]}


@register_op("kldiv_loss")
def kldiv_loss(ins, attrs):
    """target * (log target - x) where target > 0, else 0; reduced by
    `reduction` (mean, sum, batchmean, or none)."""
    x, target = ins["X"], ins["Target"]
    pos = target > 0
    safe = torch.where(pos, target, torch.ones_like(target))
    loss = torch.where(pos, target * (torch.log(safe) - x),
                       torch.zeros_like(x))
    red = attrs.get("reduction", "mean")
    if red == "mean":
        loss = loss.mean()
    elif red == "sum":
        loss = loss.sum()
    elif red == "batchmean":
        loss = loss.sum() / x.shape[0]
    return {"Loss": loss}


@register_op("one_hot_v2")
def one_hot_v2(ins, attrs):
    """float32 rows of `depth`, 1 at each id (all 0 for an id outside
    [0, depth), as jax.nn.one_hot)."""
    x = ins["X"]
    depth = attrs.get("depth")
    hot = x.long().unsqueeze(-1) == torch.arange(depth, device=x.device)
    return {"Out": hot.to(torch.float32)}


@register_op("one_hot")
def one_hot(ins, attrs):
    """one_hot_v2 of the ids, a trailing size-1 dim dropped first."""
    x = ins["X"]
    if x.dim() > 1 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    return one_hot_v2({"X": x}, attrs)


@register_op("top_k")
def top_k(ins, attrs):
    """The k largest along the last axis, sorted; indices in the
    reference's (narrowed) index dtype."""
    vals, idx = torch.topk(ins["X"], attrs.get("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx.to(index_dtype())}


@register_op("accuracy")
def accuracy(ins, attrs):
    """operators/metrics/accuracy_op.cc: the share of rows whose label is
    among their top-k `Indices`; Accuracy float32, Correct and Total
    int32, each 0-d as in the reference."""
    idx, label = ins["Indices"], ins["Label"]
    if label.dim() < idx.dim():
        label = label[..., None]
    correct = (idx == label.to(idx.dtype)).any(dim=-1)
    total = correct.shape[0]
    num_correct = correct.to(torch.float32).sum()
    return {
        "Accuracy": num_correct / total,
        "Correct": num_correct.to(torch.int32),
        "Total": torch.tensor(total, dtype=torch.int32,
                              device=idx.device),
    }


@register_op("pad")
def pad(ins, attrs):
    """operators/pad_op.cc: `paddings` [before0, after0, before1, ...]
    of every dim, filled with `pad_value`."""
    x = ins["X"]
    p = attrs.get("paddings")
    flat = []
    for i in reversed(range(x.dim())):
        flat += [int(p[2 * i]), int(p[2 * i + 1])]
    return {"Out": TF.pad(x, flat, value=attrs.get("pad_value", 0.0))}


@register_op("pad2d")
def pad2d(ins, attrs):
    """operators/pad2d_op.cc on NCHW: `paddings` [top, bottom, left,
    right], constant, reflect or edge."""
    x = ins["X"]
    t, b, l, r = (int(v) for v in attrs.get("paddings", [0, 0, 0, 0]))
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": TF.pad(x, (l, r, t, b),
                              value=attrs.get("pad_value", 0.0))}
    mode = {"reflect": "reflect", "edge": "replicate"}[mode]
    return {"Out": TF.pad(x, (l, r, t, b), mode=mode)}


@register_op("norm")
def norm(ins, attrs):
    """l2_normalize: x / sqrt(sum(x^2, axis) + epsilon), and that norm."""
    x = ins["X"]
    n = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                             keepdim=True) + attrs.get("epsilon", 1e-10))
    return {"Out": x / n, "Norm": n}


def _affine_c(y, ins, c, ndim):
    """y * Scale + Bias along dim 1 (either may be absent)."""
    bshape = (1, c) + (1,) * (ndim - 2)
    scale, bias = ins.get("Scale"), ins.get("Bias")
    if scale is not None:
        y = y * scale.reshape(bshape)
    if bias is not None:
        y = y + bias.reshape(bshape)
    return y


def _moments(x, axes):
    mean = x.mean(dim=axes, keepdim=True)
    return mean, torch.square(x - mean).mean(dim=axes, keepdim=True)


@register_op("instance_norm")
def instance_norm(ins, attrs):
    """Normalize each (sample, channel) over its spatial dims (biased
    variance); SavedMean / SavedVariance keep the reduced dims."""
    x = ins["X"]
    mean, var = _moments(x, tuple(range(2, x.dim())))
    y = (x - mean) / torch.sqrt(var + attrs.get("epsilon", 1e-5))
    return {"Y": _affine_c(y, ins, x.shape[1], x.dim()),
            "SavedMean": mean, "SavedVariance": var}


@register_op("group_norm")
def group_norm(ins, attrs):
    """Normalize each (sample, group of C / groups channels) over its
    channels and spatial dims; Mean / Variance are [N, groups]."""
    x = ins["X"]
    groups = attrs.get("groups", 1)
    n, c = x.shape[0], x.shape[1]
    g = x.reshape((n, groups, c // groups) + tuple(x.shape[2:]))
    mean, var = _moments(g, tuple(range(2, g.dim())))
    y = ((g - mean) / torch.sqrt(var + attrs.get("epsilon", 1e-5))).reshape(
        x.shape)
    return {"Y": _affine_c(y, ins, c, x.dim()),
            "Mean": mean.reshape(n, groups),
            "Variance": var.reshape(n, groups)}


def depthwise_conv2d(ins, attrs):
    """conv2d with one group per input channel."""
    x = ins["Input"]
    c = x.shape[-1] if attrs.get("data_format", "NCHW") == "NHWC" \
        else x.shape[1]
    return conv2d(ins, dict(attrs, groups=c))


def conv2d_transpose(ins, attrs):
    """operators/conv_transpose_op.cc on NCHW with the filter
    [Cin, Cout / groups, kh, kw], as the reference computes it: the input
    dilated by the strides, padded by dilation * (k - 1) - padding on
    each side (cropped where that is negative), then a stride-1 conv
    with the filter regrouped to [Cout, Cin / groups, kh, kw] and
    flipped.  SAME padding counts as 0, as in the reference."""
    x, w = ins["Input"], ins["Filter"]
    strides = _pair(attrs.get("strides", [1, 1]))
    dilations = _pair(attrs.get("dilations", [1, 1]))
    groups = attrs.get("groups", 1)
    pad = _conv_pad(attrs.get("paddings", [0, 0]),
                    attrs.get("padding_algorithm", "EXPLICIT"), 2)
    if pad == "SAME":
        pad = [(0, 0), (0, 0)]
    cin, cout_g, kh, kw = w.shape
    pads = [(dilations[i] * (k - 1) - pad[i][0],
             dilations[i] * (k - 1) - pad[i][1])
            for i, k in enumerate((kh, kw))]
    if groups > 1:
        w_t = w.reshape(groups, cin // groups, cout_g, kh, kw).transpose(
            1, 2).reshape(groups * cout_g, cin // groups, kh, kw)
    else:
        w_t = w.transpose(0, 1)
    w_t = torch.flip(w_t, (2, 3))
    n, c, h, wd = x.shape
    sh, sw = strides
    if (sh, sw) != (1, 1):
        xd = x.new_zeros((n, c, (h - 1) * sh + 1, (wd - 1) * sw + 1))
        xd[:, :, ::sh, ::sw] = x
        x = xd
    (t, b), (l, r) = pads
    x = TF.pad(x, (l, r, t, b))
    out = TF.conv2d(x, w_t, dilation=dilations, groups=groups)
    return {"Output": out}


def _keys_cubic(x):
    # R. G. Keys' cubic kernel (a = -0.5), as jax.image
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _resize_weights(m, n, kernel, device):
    """jax.image's [m, n] weights from input size m to output size n:
    half-pixel centres, the kernel widened by m / n when shrinking (the
    antialias filter), each column normalized, 0 for a sample outside
    the input."""
    inv = 1.0 / (n / m)        # the reference's 1 / scale, rounded as it
    kscale = max(inv, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(
        m, dtype=torch.float32, device=device)[:, None]) / kscale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize(x, shape, method):
    """jax.image.resize(x, shape, method) with its default antialias:
    nearest takes the input pixel under each output pixel's centre;
    linear and cubic contract each resized dim with `_resize_weights`."""
    for d in range(x.dim()):
        m, n = x.shape[d], shape[d]
        if m == n:
            continue
        if method == "nearest":
            off = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5)
                              * m / n).long()
            x = x.index_select(d, off)
            continue
        kernel = _triangle if method == "linear" else _keys_cubic
        w = _resize_weights(m, n, kernel, x.device).to(
            x.dtype if x.is_floating_point() else torch.float32)
        if not x.is_floating_point():
            x = x.to(torch.float32)
        x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x


def interpolate(ins, attrs):
    """operators/interpolate_op.cc, as the reference's jax.image.resize:
    NCHW nearest / bilinear / bicubic and NCDHW trilinear, sized by the
    out_* attrs or by `scale`."""
    x = ins["X"]
    scale = attrs.get("scale", 0.0)
    method = attrs.get("interp_method", "nearest")

    def _dim(name, axis):
        v = attrs.get(name, -1)
        if (v is None or v <= 0) and scale:
            return int(x.shape[axis] * scale)
        return int(v)

    if x.dim() == 5 or method == "trilinear":
        shape = (x.shape[0], x.shape[1], _dim("out_d", 2), _dim("out_h", 3),
                 _dim("out_w", 4))
        return {"Out": _resize(x, shape, "linear")}
    shape = (x.shape[0], x.shape[1], _dim("out_h", 2), _dim("out_w", 3))
    method = {"nearest": "nearest", "bilinear": "linear",
              "bicubic": "cubic"}[method]
    return {"Out": _resize(x, shape, method)}


# the ops of earlier slices, under their op types
register_op("layer_norm")(layer_norm)
register_op("dropout", needs_rng=True)(dropout)
register_op("lookup_table_v2")(lookup_table_v2)
register_op("softmax_with_cross_entropy")(softmax_with_cross_entropy)
register_op("conv2d")(conv2d)
register_op("depthwise_conv2d")(depthwise_conv2d)
register_op("conv2d_transpose")(conv2d_transpose)
register_op("interpolate")(interpolate)
register_op("pool2d")(pool2d)
register_op("batch_norm", stateful=True)(batch_norm)
