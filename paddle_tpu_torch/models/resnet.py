"""ResNet family (port of paddle_tpu/models/resnet.py: `ConvBNLayer`,
`BasicBlock`, `BottleneckBlock`, `ResNet`, `set_bn_stats_sample`,
`resnet18`, `resnet34`, `resnet50`).

Module and parameter names are the reference's, so `interop` maps
weights and batch-norm buffers one to one.  `data_format="NHWC"` runs
the conv stack channels-last; the input stays NCHW with one transpose at
the stem.

`fused=True` (NHWC) sends the stride-1 bottleneck blocks through K7
(`kernels/fused_bottleneck.py`, CUDA C++ on the card): the batch-norm
statistics are resolved OUTSIDE the kernel on a ghost-batch slice (the
slice convs re-run on `bn_stats_sample` of the N samples; grads through
the stats reach the weights by autograd, through the kernel Function's
affine grads), then the whole block runs as one kernel.  The port has K7
only: the stride-2 transition blocks (K8) and the fused stem tail (K9)
are not ported (ROADMAP queue 2), so `fused=True` needs
PADDLE_TPU_FUSED_SUBSET=id (the 12 identity blocks) or `id_early` (the
identity blocks with Cm <= 128), the reference's subsets that engage
neither; any other subset raises NotImplementedError where the
reference would engage K8 or K9.  SE-ResNeXt is not ported yet (ROADMAP
queue 1).
"""

import os

import torch

from .. import nn
from ..ops import nn_ops

_NEEDS_K8_K9 = ("fused=True with PADDLE_TPU_FUSED_SUBSET={!r} would run the "
                "{} kernel (K8/K9), which is not ported yet (ROADMAP queue "
                "2); set PADDLE_TPU_FUSED_SUBSET=id or id_early")


class ConvBNLayer(nn.Layer):
    def __init__(self, in_ch, out_ch, filter_size, stride=1, groups=1,
                 act=None, data_format="NCHW", **kw):
        super().__init__(**kw)
        sub = self.sub_kwargs()
        self.conv = nn.Conv2D(in_ch, out_ch, filter_size, stride=stride,
                              padding=(filter_size - 1) // 2, groups=groups,
                              bias_attr=False, data_format=data_format, **sub)
        self.bn = nn.BatchNorm(out_ch, act=act, data_format=data_format,
                               **sub)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, in_ch, ch, stride=1, data_format="NCHW", **kw):
        super().__init__(**kw)
        sub = dict(data_format=data_format, **self.sub_kwargs())
        self.conv0 = ConvBNLayer(in_ch, ch, 3, stride=stride, act="relu",
                                 **sub)
        self.conv1 = ConvBNLayer(ch, ch, 3, **sub)
        self.short = (None if stride == 1 and in_ch == ch else
                      ConvBNLayer(in_ch, ch, 1, stride=stride, **sub))
        self.relu = nn.ReLU(**self.sub_kwargs())

    def forward(self, x):
        y = self.conv1(self.conv0(x))
        s = x if self.short is None else self.short(x)
        return self.relu(y + s)


def _fused_subset():
    """The reference's PADDLE_TPU_FUSED_SUBSET: `id` restricts the fused
    path to the identity bottleneck blocks, `id_early` further to those
    with Cm <= 128 (stages 1-2)."""
    return os.environ.get("PADDLE_TPU_FUSED_SUBSET", "")


def _bn_affine(bn, conv_out, training):
    """One BatchNorm resolved to a per-channel (a, b) affine: in training
    from the batch statistics of the (already ghost-sliced) conv output,
    updating the running stats, by the `batch_norm` op's own statistics
    (`batch_norm_stats`); in eval from the running stats.  (a, b) are
    cast to the activation dtype, so the fused kernel applies the same
    affines as the unfused ConvBN path."""
    eps = bn._epsilon
    if training:
        mean, var, mean_out, var_out = nn_ops.batch_norm_stats(
            conv_out, bn._buffers["_mean"], bn._buffers["_variance"],
            bn._momentum, eps, conv_out.dim() - 1)
        bn._buffers["_mean"] = mean_out.detach()
        bn._buffers["_variance"] = var_out.detach()
    else:
        mean, var = bn._buffers["_mean"], bn._buffers["_variance"]
    inv = 1.0 / torch.sqrt(var + eps)
    a = inv * bn.weight.float()
    b = bn.bias.float() - mean * a
    dt = conv_out.dtype if conv_out is not None else bn.weight.dtype
    return a.to(dt), b.to(dt)


def _relu0(t):
    # jnp.maximum(t, 0): the gradient splits at a tie, as torch.maximum's
    return torch.maximum(t, torch.zeros((), dtype=t.dtype, device=t.device))


def _w1x1(conv):
    """A 1x1 OIHW conv weight as the kernel's [Cin, Cout] matrix."""
    return conv.weight[:, :, 0, 0].t().contiguous()


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, in_ch, ch, stride=1, data_format="NCHW", fused=False,
                 **kw):
        super().__init__(**kw)
        sub = dict(data_format=data_format, **self.sub_kwargs())
        self.conv0 = ConvBNLayer(in_ch, ch, 1, act="relu", **sub)
        self.conv1 = ConvBNLayer(ch, ch, 3, stride=stride, act="relu", **sub)
        self.conv2 = ConvBNLayer(ch, ch * 4, 1, **sub)
        self.short = (None if stride == 1 and in_ch == ch * 4 else
                      ConvBNLayer(in_ch, ch * 4, 1, stride=stride, **sub))
        self.relu = nn.ReLU(**self.sub_kwargs())
        # the reference's gate (models/resnet.py:128), subset included
        subset = _fused_subset()
        id_only = subset in ("id", "id_early")
        self._stride = stride
        self._fused = (fused and data_format == "NHWC"
                       and (stride == 1
                            or (stride == 2 and self.short is not None))
                       and not (id_only
                                and (self.short is not None or stride != 1))
                       and not (subset == "id_early" and ch > 128))
        if self._fused and stride == 2:
            raise NotImplementedError(_NEEDS_K8_K9.format(
                subset, "fused_bottleneck_down"))

    def _forward_fused(self, x):
        """The whole block as one K7 launch, the batch-norm affines from
        a ghost-batch slice (training) or the running stats (eval)."""
        from ..kernels.fused_bottleneck import (
            fused_bottleneck, fused_bottleneck_proj)

        w1 = _w1x1(self.conv0.conv)                               # [Cin, Cm]
        w2 = self.conv1.conv.weight.permute(2, 3, 1, 0).contiguous()  # HWIO
        w3 = _w1x1(self.conv2.conv)                               # [Cm, Cout]
        if self.training:
            ss = self.conv0.bn._stats_sample
            xs = x if not (0 < ss < x.shape[0]) else x[:ss]
            c0s = self.conv0.conv(xs)
            a1, b1 = _bn_affine(self.conv0.bn, c0s, True)
            h0s = _relu0(c0s * a1 + b1)
            c1s = self.conv1.conv(h0s)
            a2, b2 = _bn_affine(self.conv1.bn, c1s, True)
            h1s = _relu0(c1s * a2 + b2)
            c2s = self.conv2.conv(h1s)
            a3, b3 = _bn_affine(self.conv2.bn, c2s, True)
            if self.short is not None:
                c4s = self.short.conv(xs)
                a4, b4 = _bn_affine(self.short.bn, c4s, True)
        else:
            a1, b1 = _bn_affine(self.conv0.bn, None, False)
            a2, b2 = _bn_affine(self.conv1.bn, None, False)
            a3, b3 = _bn_affine(self.conv2.bn, None, False)
            if self.short is not None:
                a4, b4 = _bn_affine(self.short.bn, None, False)
        x = x.contiguous()
        if self.short is None:
            return fused_bottleneck(x, w1, w2, w3, a1, b1, a2, b2, a3, b3)
        w4 = _w1x1(self.short.conv)                               # [Cin, Cout]
        return fused_bottleneck_proj(x, w1, w2, w3, w4, a1, b1, a2, b2, a3,
                                     b3, a4, b4)

    def forward(self, x):
        # training with full-batch stats (ss = 0) would run every conv
        # twice (stats chain + kernel): the reference routes it to the
        # per-conv path, and so does the port
        ss = self.conv0.bn._stats_sample
        if (self._fused and self._stride == 1
                and (not self.training or 0 < ss < x.shape[0])):
            return self._forward_fused(x)
        y = self.conv2(self.conv1(self.conv0(x)))
        s = x if self.short is None else self.short(x)
        return self.relu(y + s)


class ResNet(nn.Layer):
    """data_format="NHWC" runs the conv stack channels-last; the input
    stays NCHW with one transpose at the stem."""

    def __init__(self, block, depths, num_classes=1000, in_ch=3,
                 data_format="NCHW", fused=False, **kw):
        super().__init__(**kw)
        self._data_format = data_format
        sub = self.sub_kwargs()
        self.stem = ConvBNLayer(in_ch, 64, 7, stride=2, act="relu",
                                data_format=data_format, **sub)
        self.pool = nn.MaxPool2D(3, 2, padding=1, data_format=data_format,
                                 **sub)
        chans = [64, 128, 256, 512]
        blocks = []
        prev = 64
        for stage, (ch, depth) in enumerate(zip(chans, depths)):
            for i in range(depth):
                stride = 2 if i == 0 and stage > 0 else 1
                extra = {"fused": True} if fused else {}
                blocks.append(block(prev, ch, stride=stride,
                                    data_format=data_format, **extra, **sub))
                prev = ch * block.expansion
        self.blocks = nn.LayerList(blocks, **sub)
        self.global_pool = nn.Pool2D(pool_type="avg", global_pooling=True,
                                     data_format=data_format, **sub)
        self.fc = nn.Linear(prev, num_classes, **sub)
        # the reference's fused stem tail (K9) engages unless the subset
        # is one of the identity subsets
        if (fused and data_format == "NHWC"
                and _fused_subset() not in ("id", "id_early")):
            raise NotImplementedError(_NEEDS_K8_K9.format(
                _fused_subset(), "fused_stem_tail"))

    def forward(self, x):
        if self._data_format == "NHWC":
            x = x.permute(0, 2, 3, 1).contiguous()  # NCHW API -> NHWC core
        x = self.pool(self.stem(x))
        for b in self.blocks:
            x = b(x)
        x = self.global_pool(x)
        return self.fc(x.reshape(x.shape[0], -1))


def set_bn_stats_sample(model, stats_sample):
    """Ghost-batch BN statistics from the first `stats_sample` samples on
    every BatchNorm in the model."""
    for layer in model.modules():
        if isinstance(layer, nn.BatchNorm):
            layer._stats_sample = stats_sample
    return model


def resnet18(num_classes=1000, data_format="NCHW", dtype="float32",
             bn_stats_sample=0, **kw):
    return set_bn_stats_sample(
        ResNet(BasicBlock, [2, 2, 2, 2], num_classes,
               data_format=data_format, dtype=dtype, **kw), bn_stats_sample)


def resnet34(num_classes=1000, data_format="NCHW", dtype="float32",
             bn_stats_sample=0, **kw):
    return set_bn_stats_sample(
        ResNet(BasicBlock, [3, 4, 6, 3], num_classes,
               data_format=data_format, dtype=dtype, **kw), bn_stats_sample)


def resnet50(num_classes=1000, data_format="NCHW", dtype="float32",
             bn_stats_sample=0, fused=False, **kw):
    """fused=True routes the stride-1 bottleneck blocks through K7 (NHWC
    only; needs PADDLE_TPU_FUSED_SUBSET=id or id_early, see the module
    docstring); a win needs bn_stats_sample > 0 or eval mode.  `kw` takes
    `device` and `generator`."""
    return set_bn_stats_sample(
        ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes,
               data_format=data_format, dtype=dtype, fused=fused, **kw),
        bn_stats_sample)
