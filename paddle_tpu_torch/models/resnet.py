"""ResNet family (port of paddle_tpu/models/resnet.py: `ConvBNLayer`,
`BasicBlock`, `BottleneckBlock`, `ResNet`, `set_bn_stats_sample`,
`resnet18`, `resnet34`, `resnet50`, `SEBlock`, `SEResNeXtBlock`,
`SEResNeXt`).

Module and parameter names are the reference's, so `interop` maps
weights and batch-norm buffers one to one.  `data_format="NHWC"` runs
the conv stack channels-last; the input stays NCHW with one transpose at
the stem.

`fused=True` (NHWC) runs the reference's fused program
(`kernels/fused_bottleneck.py`, CUDA C++ on the card): K7 on the
stride-1 bottleneck blocks (identity and projection), K8 on the stride-2
transition blocks (for even H and W; odd sides take the per-conv path)
and K9 on the stem's batch-norm, relu and max-pool tail.  The batch-norm
statistics are resolved OUTSIDE the kernels on a ghost-batch slice (the
slice convs re-run on `bn_stats_sample` of the N samples; grads through
the stats reach the weights by autograd, through the kernel Functions'
affine grads), then each block runs as one kernel.  Training with
full-batch statistics (`bn_stats_sample` 0) takes the per-conv path, as
in the reference.  PADDLE_TPU_FUSED_SUBSET=id restricts the fused path
to the 12 identity blocks, `id_early` further to those with Cm <= 128
(stages 1-2); either leaves the stem unfused.

SE-ResNeXt-50 32x4d is NCHW only, as in the reference: its grouped 3x3
convs (groups=32) are library convs (`ops/nn_ops.py` `conv2d`, cuDNN on
the card) and the SE gate (global pool, two Linears, the broadcast
multiply) is eager, so it launches no kernel of the port.
"""

import os

import torch

from .. import nn
from ..ops import nn_ops


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

    def _forward_fused(self, x):
        """The whole block as one K7 (stride 1) or K8 (stride 2) launch,
        the batch-norm affines from a ghost-batch slice (training) or the
        running stats (eval)."""
        from ..kernels.fused_bottleneck import (
            fused_bottleneck, fused_bottleneck_down, fused_bottleneck_proj)

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
        if self._stride == 2:
            return fused_bottleneck_down(x, w1, w2, w3, w4, a1, b1, a2, b2,
                                         a3, b3, a4, b4)
        return fused_bottleneck_proj(x, w1, w2, w3, w4, a1, b1, a2, b2, a3,
                                     b3, a4, b4)

    def forward(self, x):
        # training with full-batch stats (ss = 0) would run every conv
        # twice (stats chain + kernel): the reference routes it to the
        # per-conv path, and so does the port; K8 needs even sides
        ss = self.conv0.bn._stats_sample
        if (self._fused and (not self.training or 0 < ss < x.shape[0])
                and (self._stride == 1
                     or (x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0))):
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
        # the fused stem tail (K9: batch-norm affine, relu and the
        # max-pool in one kernel; the 7x7 conv stays a library conv)
        # engages unless the subset is one of the identity subsets
        self._fused_stem = (fused and data_format == "NHWC"
                            and _fused_subset() not in ("id", "id_early"))

    def _stem_pool(self, x):
        """The stem conv on the full batch, then either K9 with the stem
        batch norm resolved on the ghost-batch slice (or the running
        stats in eval), or the per-op batch norm, relu and max-pool (ss 0
        in training, or odd sides), as the reference's `_stem_pool`."""
        ss = self.stem.bn._stats_sample
        c = self.stem.conv(x)
        if (self._fused_stem
                and (not self.training or 0 < ss < x.shape[0])
                and c.shape[1] % 2 == 0 and c.shape[2] % 2 == 0):
            from ..kernels.fused_bottleneck import fused_stem_tail

            cs = c[:ss] if self.training else None
            a, b = _bn_affine(self.stem.bn, cs, self.training)
            return fused_stem_tail(c.contiguous(), a, b)
        return self.pool(self.stem.bn(c))

    def forward(self, x):
        if self._data_format == "NHWC":
            x = x.permute(0, 2, 3, 1).contiguous()  # NCHW API -> NHWC core
        x = self._stem_pool(x)
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
    """fused=True (NHWC only) runs all 16 bottleneck blocks through K7 and
    K8 and the stem tail through K9, or the identity blocks alone under
    PADDLE_TPU_FUSED_SUBSET=id or id_early (see the module docstring); it
    engages with bn_stats_sample > 0 or in eval mode.  `kw` takes
    `device` and `generator`."""
    return set_bn_stats_sample(
        ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes,
               data_format=data_format, dtype=dtype, fused=fused, **kw),
        bn_stats_sample)


class SEBlock(nn.Layer):
    """Squeeze-and-excitation gate."""

    def __init__(self, ch, reduction=16, **kw):
        super().__init__(**kw)
        sub = self.sub_kwargs()
        self.squeeze = nn.Pool2D(pool_type="avg", global_pooling=True, **sub)
        self.fc1 = nn.Linear(ch, ch // reduction, act="relu", **sub)
        self.fc2 = nn.Linear(ch // reduction, ch, act="sigmoid", **sub)

    def forward(self, x):
        s = self.squeeze(x).reshape(x.shape[0], -1)
        s = self.fc2(self.fc1(s))
        return x * s.reshape(s.shape[0], s.shape[1], 1, 1)


class SEResNeXtBlock(nn.Layer):
    def __init__(self, in_ch, ch, stride=1, cardinality=32, reduction=16,
                 **kw):
        super().__init__(**kw)
        sub = self.sub_kwargs()
        self.conv0 = ConvBNLayer(in_ch, ch, 1, act="relu", **sub)
        self.conv1 = ConvBNLayer(ch, ch, 3, stride=stride,
                                 groups=cardinality, act="relu", **sub)
        self.conv2 = ConvBNLayer(ch, ch * 2, 1, **sub)
        self.se = SEBlock(ch * 2, reduction, **sub)
        self.short = (None if stride == 1 and in_ch == ch * 2 else
                      ConvBNLayer(in_ch, ch * 2, 1, stride=stride, **sub))
        self.relu = nn.ReLU(**sub)

    def forward(self, x):
        y = self.se(self.conv2(self.conv1(self.conv0(x))))
        s = x if self.short is None else self.short(x)
        return self.relu(y + s)


class SEResNeXt(nn.Layer):
    """SE-ResNeXt-50 32x4d (NCHW).  `SEResNeXt(num_classes, depths,
    dtype, device=None, generator=None)`."""

    def __init__(self, num_classes=1000, depths=(3, 4, 6, 3),
                 dtype="float32", **kw):
        super().__init__(dtype=dtype, **kw)
        sub = self.sub_kwargs()
        self.stem = ConvBNLayer(3, 64, 7, stride=2, act="relu", **sub)
        self.pool = nn.MaxPool2D(3, 2, padding=1, **sub)
        chans = [128, 256, 512, 1024]
        blocks = []
        prev = 64
        for stage, (ch, depth) in enumerate(zip(chans, depths)):
            for i in range(depth):
                stride = 2 if i == 0 and stage > 0 else 1
                blocks.append(SEResNeXtBlock(prev, ch, stride=stride, **sub))
                prev = ch * 2
        self.blocks = nn.LayerList(blocks, **sub)
        self.global_pool = nn.Pool2D(pool_type="avg", global_pooling=True,
                                     **sub)
        self.fc = nn.Linear(prev, num_classes, **sub)

    def forward(self, x):
        x = self.pool(self.stem(x))
        for b in self.blocks:
            x = b(x)
        x = self.global_pool(x)
        return self.fc(x.reshape(x.shape[0], -1))
