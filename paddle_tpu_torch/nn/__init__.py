"""Eager layers (port of paddle_tpu/nn/__init__.py).

Every layer takes `dtype`, `device` (default `cuda`) and `generator`
(the host torch.Generator its parameters are drawn from).  Parameter
names and layouts are the reference's (Linear [in, out], Conv2D OIHW,
Conv2DTranspose [Cin, Cout / groups, kh, kw], the LSTM and GRU cells'
fused gate matrices), so `interop.load_jax_param_dict` carries weights
across unchanged.

The reference's op-backed layers (Conv3D, Conv3DTranspose, GRUUnit,
NCE, PRelu, BilinearTensorProduct, SequenceConv, RowConv, SpectralNorm,
TreeConv) stand on the op corpus of ROADMAP item 10; constructing one
raises NotImplementedError naming it.
"""

import torch

from ..framework import _not_ported

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
    "seed", "functional", "Linear", "Conv2D", "Conv2DTranspose", "Pool2D",
    "MaxPool2D", "AvgPool2D", "BatchNorm", "LayerNorm", "GroupNorm",
    "Embedding", "Dropout", "Sequential", "LayerList", "ParameterList",
    "ReLU", "GELU", "Sigmoid", "Tanh", "Softmax", "MultiHeadAttention",
    "TransformerEncoderLayer", "TransformerEncoder",
    "scaled_dot_product_attention", "LSTMCell", "GRUCell", "RNN", "Conv3D",
    "Conv3DTranspose", "GRUUnit", "NCE", "PRelu", "BilinearTensorProduct",
    "SequenceConv", "RowConv", "SpectralNorm", "TreeConv",
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


class Conv2DTranspose(Layer):
    """Parity: dygraph/nn.py Conv2DTranspose (NCHW).  weight is [Cin,
    Cout / groups, kh, kw]."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, bias_attr=None, act=None,
                 **kw):
        super().__init__(**kw)
        self.weight = self.create_parameter(
            [num_channels, num_filters // groups]
            + F._pair_list(filter_size))
        if bias_attr is not False:
            self.bias = self.create_parameter([num_filters], is_bias=True)
        else:
            self.register_parameter("bias", None)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._act = act

    def forward(self, x):
        out = F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                 self._padding, self._dilation, self._groups)
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


class GELU(Layer):
    def __init__(self, approximate=False, **kw):
        super().__init__(**kw)
        self._approx = approximate

    def forward(self, x):
        return F.gelu(x, self._approx)


class Sigmoid(Layer):
    def forward(self, x):
        return F.sigmoid(x)


class Tanh(Layer):
    def forward(self, x):
        return F.tanh(x)


class Softmax(Layer):
    def __init__(self, axis=-1, **kw):
        super().__init__(**kw)
        self._axis = axis

    def forward(self, x):
        return F.softmax(x, self._axis)


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


class GroupNorm(Layer):
    """The `group_norm` op over NCHW (or any N, C, ...) input."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5, **kw):
        super().__init__(**kw)
        self.weight = self.create_parameter([num_channels], constant=1.0)
        self.bias = self.create_parameter([num_channels], is_bias=True)
        self._groups = num_groups
        self._epsilon = epsilon

    def forward(self, x):
        return F._op("group_norm", {"X": x, "Scale": self.weight,
                                    "Bias": self.bias},
                     {"groups": self._groups, "epsilon": self._epsilon},
                     out="Y")


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


class Sequential(Layer):
    """Parity: nn.Sequential.  Sub-layers are named "0", "1", ... (or by
    the name of a (name, layer) pair) and run in order.  It lives on its
    first sub-layer's device."""

    def __init__(self, *layers):
        subs = [l[1] if isinstance(l, tuple) else l for l in layers]
        super().__init__(device=subs[0]._device if subs else "cpu")
        for i, l in enumerate(layers):
            name, l = l if isinstance(l, tuple) else (str(i), l)
            self.add_module(name, l)

    def forward(self, x):
        for l in self._modules.values():
            x = l(x)
        return x

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


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


class ParameterList(Layer):
    """Indexed parameter container (parity: dygraph/container.py
    ParameterList): parameters named "0", "1", ...."""

    def __init__(self, parameters=None, **kw):
        super().__init__(**kw)
        for p in parameters or []:
            self.append(p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __setitem__(self, idx, param):
        self.register_parameter(str(idx), param)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        if not isinstance(parameter, torch.nn.Parameter):
            parameter = torch.nn.Parameter(torch.as_tensor(parameter))
        self.register_parameter(str(len(self._parameters)), parameter)
        return self


class MultiHeadAttention(Layer):
    """Self/cross attention through `scaled_dot_product_attention` (the
    K1 kernel on the card inside its envelope).  Inside
    `distributed.tensor_parallel.tensor_parallel(mesh)` it runs this
    rank's heads: q, k and v column-parallel, out_proj row-parallel, the
    attention over sp through the ring."""

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
        from ..distributed.tensor_parallel import current

        par = current()
        query = par.copy_to_tp(query)
        key = query if key is None else par.copy_to_tp(key)
        value = query if value is None else par.copy_to_tp(value)
        b, sq, _ = query.shape
        sk = key.shape[1]
        # -1: this rank's heads under tensor parallelism
        q = self.q_proj(query).reshape(b, sq, -1, self.head_dim)
        k = self.k_proj(key).reshape(b, sk, -1, self.head_dim)
        v = self.v_proj(value).reshape(b, sk, -1, self.head_dim)
        out = par.attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=attn_mask,
            dropout_p=self._dropout if self.training else 0.0,
            is_causal=is_causal, training=self.training)
        out = out.transpose(1, 2).reshape(b, sq, -1)
        return par.row_parallel(self.out_proj, out)


class TransformerEncoderLayer(Layer):
    """Post-norm encoder layer (pre-norm with `normalize_before`): self
    attention through `MultiHeadAttention` (K1-K3 on the card inside the
    flash envelope: no mask, no training dropout), then the FFN; the
    LayerNorms (epsilon 1e-5, as the reference's) are K4/K5 there."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="gelu", normalize_before=False, **kw):
        super().__init__(**kw)
        sub = self.sub_kwargs()
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout=dropout,
                                            **sub)
        self.linear1 = Linear(d_model, dim_feedforward, **sub)
        self.linear2 = Linear(dim_feedforward, d_model, **sub)
        self.norm1 = LayerNorm(d_model, **sub)
        self.norm2 = LayerNorm(d_model, **sub)
        self.dropout1 = Dropout(dropout, **sub)
        self.dropout2 = Dropout(dropout, **sub)
        self._activation = activation
        self._pre_norm = normalize_before

    def forward(self, src, src_mask=None):
        residual = src
        if self._pre_norm:
            src = self.norm1(src)
        src = self.self_attn(src, attn_mask=src_mask)
        src = residual + self.dropout1(src)
        if not self._pre_norm:
            src = self.norm1(src)
        residual = src
        if self._pre_norm:
            src = self.norm2(src)
        src = self.linear2(_apply_act(self.linear1(src), self._activation))
        src = residual + self.dropout2(src)
        if not self._pre_norm:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """`num_layers` layers from `encoder_layer_fn()`, named layers.0, ...."""

    def __init__(self, encoder_layer_fn, num_layers):
        layers = [encoder_layer_fn() for _ in range(num_layers)]
        super().__init__(device=layers[0]._device if layers else "cpu")
        self.layers = LayerList(layers, device=self._device)

    def forward(self, src, src_mask=None):
        for layer in self.layers:
            src = layer(src, src_mask)
        return src


class LSTMCell(Layer):
    """The reference's LSTM cell: one [I, 4H] and one [H, 4H] weight, one
    bias, gates split i, f, g, o, `forget_bias` added to f (not
    torch.nn.LSTMCell's layout).

    call(x [B, I], (h [B, H], c [B, H])) -> (h', (h', c'))."""

    def __init__(self, input_size, hidden_size, forget_bias=0.0, **kw):
        super().__init__(**kw)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.forget_bias = forget_bias
        self.weight_ih = self.create_parameter([input_size, 4 * hidden_size])
        self.weight_hh = self.create_parameter([hidden_size,
                                                4 * hidden_size])
        self.bias = self.create_parameter([4 * hidden_size], is_bias=True)

    def forward(self, x, state):
        h, c = state
        gates = x @ self.weight_ih + h @ self.weight_hh + self.bias
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i = F.sigmoid(i)
        f = F.sigmoid(f + self.forget_bias)
        g = torch.tanh(g)
        o = F.sigmoid(o)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        return h_new, (h_new, c_new)

    def zero_state(self, batch):
        from ..core.dtype import to_torch_dtype

        z = torch.zeros((batch, self.hidden_size),
                        dtype=to_torch_dtype(self._dtype),
                        device=self.weight_ih.device)
        return (z, z)


class GRUCell(Layer):
    """The reference's GRU cell: gates split r, z, n, the input bias only,
    n = tanh(x W_in + b_n + r * (h W_hn))."""

    def __init__(self, input_size, hidden_size, **kw):
        super().__init__(**kw)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter([input_size, 3 * hidden_size])
        self.weight_hh = self.create_parameter([hidden_size,
                                                3 * hidden_size])
        self.bias = self.create_parameter([3 * hidden_size], is_bias=True)

    def forward(self, x, state):
        h = state
        xr, xz, xn = torch.chunk(x @ self.weight_ih + self.bias, 3, dim=-1)
        hr, hz, hn = torch.chunk(h @ self.weight_hh, 3, dim=-1)
        r = F.sigmoid(xr + hr)
        z = F.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1 - z) * n + z * h
        return h_new, h_new

    def zero_state(self, batch):
        from ..core.dtype import to_torch_dtype

        return torch.zeros((batch, self.hidden_size),
                           dtype=to_torch_dtype(self._dtype),
                           device=self.weight_ih.device)


def _tree_map(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


class RNN(Layer):
    """Runs a cell over [B, T, I] (time_major: [T, B, I]) in a Python loop
    (the reference's lax.scan).  With `length` [B], past each sequence's
    end the state is frozen and the output is 0."""

    def __init__(self, cell, time_major=False):
        super().__init__(device=cell._device)
        self.cell = cell
        self.time_major = time_major

    def forward(self, x, initial_state=None, length=None):
        if not self.time_major:
            x = x.transpose(0, 1)                       # [T, B, I]
        batch = x.shape[1]
        state = (initial_state if initial_state is not None
                 else self.cell.zero_state(batch))
        outs = []
        for t in range(x.shape[0]):
            out, new_state = self.cell(x[t], state)
            if length is not None:
                alive = (t < length).reshape(batch, 1)
                new_state = _tree_map(lambda n, o: torch.where(alive, n, o),
                                      new_state, state)
                out = torch.where(alive, out, torch.zeros_like(out))
            state = new_state
            outs.append(out)
        outs = torch.stack(outs, dim=0)
        if not self.time_major:
            outs = outs.transpose(0, 1)                 # [B, T, H]
        return outs, state


_OP_CORPUS = "10, the op corpus these layers stand on"
Conv3D = _not_ported("Conv3D", _OP_CORPUS)
Conv3DTranspose = _not_ported("Conv3DTranspose", _OP_CORPUS)
GRUUnit = _not_ported("GRUUnit", _OP_CORPUS)
NCE = _not_ported("NCE", _OP_CORPUS)
PRelu = _not_ported("PRelu", _OP_CORPUS)
BilinearTensorProduct = _not_ported("BilinearTensorProduct", _OP_CORPUS)
SequenceConv = _not_ported("SequenceConv", _OP_CORPUS)
RowConv = _not_ported("RowConv", _OP_CORPUS)
SpectralNorm = _not_ported("SpectralNorm", _OP_CORPUS)
TreeConv = _not_ported("TreeConv", _OP_CORPUS)
