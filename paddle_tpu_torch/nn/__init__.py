"""Eager layers (port of the GPT slice of paddle_tpu/nn/__init__.py).

Every layer takes `dtype`, `device` (default `cuda`) and `generator`
(the host torch.Generator its parameters are drawn from).
"""

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
    "seed", "functional", "Linear",
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
