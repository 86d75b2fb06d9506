"""Eager layers (port of the GPT and ResNet slices of
paddle_tpu/nn/__init__.py).

Every layer takes `dtype`, `device` (default `cuda`) and `generator`
(the host torch.Generator its parameters are drawn from).
"""

import torch

from . import functional as F
from .functional import scaled_dot_product_attention
from .layers import (
    Layer, buffer_dict, functional_call, functional_call_with_state,
    load_param_dict, param_dict,
)
from .parameter import default_rng, make_generator, seed

__all__ = [
    "Layer", "functional_call", "functional_call_with_state", "param_dict",
    "buffer_dict", "load_param_dict", "make_generator", "default_rng",
    "seed", "functional", "Linear", "Conv2D", "Pool2D", "MaxPool2D",
    "AvgPool2D", "BatchNorm", "ReLU",
    "LayerNorm", "Embedding", "Dropout", "LayerList",
    "MultiHeadAttention", "scaled_dot_product_attention",
]

functional = F


def _apply_act(x, act):
    if act is None:
        return x
    return getattr(F, act)(x)


class Linear(Layer):
    """Parity: dygraph/nn.py Linear.  weight is [in, out]."""

    def __init__(self, input_dim, output_dim, bias_attr=None, act=None,
                 **kw):
        super().__init__(**kw)
        self.weight = self.create_parameter([input_dim, output_dim])
        if bias_attr is not False:
            self.bias = self.create_parameter([output_dim], is_bias=True)
        else:
            self.register_parameter("bias", None)
        self._act = act

    def forward(self, x):
        return _apply_act(F.linear(x, self.weight, self.bias), self._act)


class Conv2D(Layer):
    """Parity: dygraph/nn.py Conv2D.  weight is OIHW ([num_filters,
    num_channels // groups, kh, kw]) in both data formats."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None, act=None,
                 data_format="NCHW", **kw):
        super().__init__(**kw)
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups] + F._pair_list(filter_size))
        if bias_attr is not False:
            self.bias = self.create_parameter([num_filters], is_bias=True)
        else:
            self.register_parameter("bias", None)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._act = act
        self._data_format = data_format

    def forward(self, x):
        out = F.conv2d(x, self.weight, self.bias, self._stride,
                       self._padding, self._dilation, self._groups,
                       data_format=self._data_format)
        return _apply_act(out, self._act)


class Pool2D(Layer):
    """Parity: dygraph/nn.py Pool2D."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, data_format="NCHW",
                 **kw):
        super().__init__(**kw)
        self._pool_size = pool_size
        self._pool_type = pool_type
        self._pool_stride = pool_stride
        self._pool_padding = pool_padding
        self._global = global_pooling
        self._data_format = data_format

    def forward(self, x):
        if self._global:
            axis = (2, 3) if self._data_format == "NCHW" else (1, 2)
            if self._pool_type == "max":
                return x.amax(dim=axis, keepdim=True)
            return x.mean(dim=axis, keepdim=True)
        if self._pool_type == "max":
            return F.max_pool2d(x, self._pool_size, self._pool_stride,
                                self._pool_padding,
                                data_format=self._data_format)
        return F.avg_pool2d(x, self._pool_size, self._pool_stride,
                            self._pool_padding,
                            data_format=self._data_format)


class MaxPool2D(Pool2D):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", **kw):
        super().__init__(kernel_size, "max", stride or kernel_size, padding,
                         data_format=data_format, **kw)


class AvgPool2D(Pool2D):
    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", **kw):
        super().__init__(kernel_size, "avg", stride or kernel_size, padding,
                         data_format=data_format, **kw)


class BatchNorm(Layer):
    """Parity: dygraph/nn.py BatchNorm.  The running stats are f32
    buffers `_mean` (zeros) and `_variance` (ones); a training call
    replaces them with the `batch_norm` op's MeanOut / VarianceOut
    (detached), so `functional_call_with_state` and the train step carry
    them.  `_stats_sample` > 0 takes the batch stats from the first
    samples only (ghost batch norm)."""

    def __init__(self, num_channels, momentum=0.9, epsilon=1e-5, act=None,
                 data_format="NCHW", stats_sample=0, **kw):
        super().__init__(**kw)
        self.weight = self.create_parameter([num_channels], constant=1.0)
        self.bias = self.create_parameter([num_channels], is_bias=True)
        self.register_buffer("_mean", torch.zeros(
            num_channels, dtype=torch.float32, device=self._device))
        self.register_buffer("_variance", torch.ones(
            num_channels, dtype=torch.float32, device=self._device))
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._act = act
        self._stats_sample = stats_sample

    def forward(self, x):
        y, new_mean, new_var = F.batch_norm(
            x, self._buffers["_mean"], self._buffers["_variance"],
            self.weight, self.bias, training=self.training,
            momentum=self._momentum, epsilon=self._epsilon,
            data_format=self._data_format, stats_sample=self._stats_sample)
        if self.training:
            self._buffers["_mean"] = new_mean.detach()
            self._buffers["_variance"] = new_var.detach()
        return _apply_act(y, self._act)


class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, **kw):
        super().__init__(**kw)
        ns = ([normalized_shape] if isinstance(normalized_shape, int)
              else list(normalized_shape))
        self._normalized_shape = ns
        self.weight = self.create_parameter(ns, constant=1.0)
        self.bias = self.create_parameter(ns, is_bias=True)
        self._epsilon = epsilon

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class Embedding(Layer):
    """Parity: dygraph/nn.py Embedding (Xavier-initialized table)."""

    def __init__(self, size, padding_idx=None, **kw):
        super().__init__(**kw)
        self.weight = self.create_parameter(list(size))
        self._padding_idx = padding_idx

    def forward(self, ids):
        return F.embedding(ids, self.weight, self._padding_idx)


class Dropout(Layer):
    """Draws its mask from `default_rng`: the train step's generator
    inside its key context, else the per-device default generator."""

    def __init__(self, p=0.5, mode="upscale_in_train", **kw):
        super().__init__(**kw)
        self._p = p
        self._mode = mode

    def forward(self, x):
        return F.dropout(x, self._p, training=self.training, mode=self._mode)


class LayerList(Layer):
    """Sub-layers named "0", "1", ... as in the reference."""

    def __init__(self, layers=None, **kw):
        super().__init__(**kw)
        for i, layer in enumerate(layers or []):
            self.add_module(str(i), layer)

    def append(self, layer):
        self.add_module(str(len(self._modules)), layer)
        return self

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


class MultiHeadAttention(Layer):
    """Self/cross attention through `scaled_dot_product_attention` (the
    K1 kernel on the card inside its envelope)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, bias_attr=None,
                 **kw):
        super().__init__(**kw)
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.embed_dim = embed_dim
        sub = self.sub_kwargs()
        self.q_proj = Linear(embed_dim, embed_dim, bias_attr=bias_attr, **sub)
        self.k_proj = Linear(embed_dim, embed_dim, bias_attr=bias_attr, **sub)
        self.v_proj = Linear(embed_dim, embed_dim, bias_attr=bias_attr, **sub)
        self.out_proj = Linear(embed_dim, embed_dim, bias_attr=bias_attr,
                               **sub)
        self._dropout = dropout

    def forward(self, query, key=None, value=None, attn_mask=None,
                is_causal=False):
        key = key if key is not None else query
        value = value if value is not None else query
        b, sq, _ = query.shape
        sk = key.shape[1]
        q = self.q_proj(query).reshape(b, sq, self.num_heads, self.head_dim)
        k = self.k_proj(key).reshape(b, sk, self.num_heads, self.head_dim)
        v = self.v_proj(value).reshape(b, sk, self.num_heads, self.head_dim)
        out = scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=attn_mask,
            dropout_p=self._dropout if self.training else 0.0,
            is_causal=is_causal, training=self.training)
        out = out.transpose(1, 2).reshape(b, sq, self.embed_dim)
        return self.out_proj(out)
