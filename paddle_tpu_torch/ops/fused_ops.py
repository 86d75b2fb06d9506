"""The fusion-tier ops (port of paddle_tpu/ops/fused_ops.py:350-496).

The op types `passes.fuse` emits when it pattern-matches a Program,
registered under the reference's names.  A user never writes them: the
fusion pass rewrites matched subgraphs into them.

- `fused_attention`: the heads split when `head_number > 0`, then
  `kernels.attention.dot_product_attention(..., training=False)`.  On the
  card inside the flash envelope (no mask, self-attention,
  seq % 128 == 0, head_dim 64/128/256) that is K1 forward, with K2/K3 in
  the backward through the flash autograd Function.  Decode-shaped
  matches (one query over a longer K/V) go to `decode_attention`.
  Everything else takes the eager composition, softmax in f32.
- `fused_layer_norm`: the residual add, then the `layer_norm` op (K4
  forward and K5 backward on the card, `ops/nn_ops.py layer_norm_y`).
- `fused_bias_act`: the unfused `elementwise_add` and activation ops.
- `fused_bottleneck` (stateful): the unfused conv2d + batch_norm (+ act)
  ops; MeanOut/VarianceOut alias Mean/Variance as batch_norm's do.
"""

import torch

from ..core.dtype import to_torch_dtype
from .registry import get_op, register_op


def _compute_cast(x, compute_dtype):
    if not compute_dtype or x is None:
        return x
    return x.to(to_torch_dtype(compute_dtype))


@register_op("fused_attention")
def fused_attention_op(ins, attrs):
    """matmul(Q,K^T)·scale[·+mask]·softmax·matmul(·,V), optionally with
    the zoo's split-heads reshape/transpose ring absorbed, as ONE op.

    attrs:
      scale          — the logit scale (matmul alpha × the scale op).
      head_number    — > 0: Q/K/V are the pre-split [B, T, H*D]
                       projections; the op splits the heads and merges
                       them back.  0: Q/K/V arrive head-split (rank 4
                       [B, H, S, D] takes dot_product_attention, other
                       ranks the generic composition).
      compute_dtype  — "" = the inputs' own dtype; "bfloat16" when the
                       matcher absorbed AMP's white-list casts (the op
                       re-applies the cast it swallowed).
      softmax_axis   — the last axis; kept for provenance.
    The softmax reduces in f32 (flash-attention convention)."""
    from ..kernels.attention import (_eager_attention, decode_attention,
                                     dot_product_attention)

    compute = attrs.get("compute_dtype", "")
    q = _compute_cast(ins["Q"], compute)
    k = _compute_cast(ins["K"], compute)
    v = _compute_cast(ins["V"], compute)
    # a shared (multi-consumer) AMP cast may have fed only SOME inputs
    # pre-cast: unify on the promoted dtype so the products never mix
    ct = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                             v.dtype)
    q, k, v = q.to(ct), k.to(ct), v.to(ct)
    mask = ins.get("Mask")
    scale = float(attrs.get("scale", 1.0))
    heads = int(attrs.get("head_number", 0))

    def _attend(q4, k4, v4):
        # decode-shaped dispatch: a single query attending a longer K/V
        # prefix goes to the single-query path
        if q4.shape[-2] == 1 and k4.shape[-2] > 1:
            return decode_attention(q4, k4, v4, mask=mask, scale=scale)
        return dot_product_attention(q4, k4, v4, mask=mask, scale=scale,
                                     training=False)

    if heads > 0:
        b, t, d = q.shape
        hd = d // heads

        def split(z):
            # z's OWN seq length: decode-shaped matches have q at seq 1
            # with K/V at the full cache depth
            return z.reshape(b, z.shape[1], heads, hd).permute(0, 2, 1, 3)

        out = _attend(split(q), split(k), split(v))
        return {"Out": out.permute(0, 2, 1, 3).reshape(b, t, d)}
    if q.dim() == 4:
        return {"Out": _attend(q, k, v)}
    # other ranks: the eager composition, which serves any rank
    return {"Out": _eager_attention(q, k, v, mask, scale, False, 0.0,
                                    False, None)}


@register_op("fused_bias_act")
def fused_bias_act_op(ins, attrs):
    """bias-add + activation (the fc/conv epilogue) as one op, through
    the exact unfused primitives (elementwise_add's reference axis
    broadcast, then the registered activation op)."""
    add = get_op("elementwise_add")
    h = add.fn({"X": ins["X"], "Y": ins["Bias"]},
               {"axis": attrs.get("axis", -1)})["Out"]
    act = attrs.get("act", "relu")
    return {"Out": get_op(act).fn({"X": h},
                                  dict(attrs.get("act_attrs")
                                       or {}))["Out"]}


@register_op("fused_layer_norm")
def fused_layer_norm_op(ins, attrs):
    """residual-add + layer_norm as one op (the transformer block's
    `layer_norm(x + sublayer(x))`), through the registered layer_norm op:
    K4/K5 on the card for a last-axis norm inside their envelope."""
    x = ins["X"]
    res = ins.get("Residual")
    if res is not None:
        x = x + res
    ln_ins = {"X": x}
    for slot in ("Scale", "Bias"):
        if ins.get(slot) is not None:
            ln_ins[slot] = ins[slot]
    return get_op("layer_norm").fn(ln_ins, attrs)


@register_op("fused_bottleneck", stateful=True)
def fused_bottleneck_op(ins, attrs):
    """conv2d + batch_norm (+ activation) as one op, training-capable: the
    batch-norm half keeps its running-stat updates (MeanOut/VarianceOut
    alias Mean/Variance).  attrs carry the source ops' attr dicts under
    conv_attrs / bn_attrs, the absorbed activation under act ("" = none)
    and the AMP compute_dtype the matcher swallowed."""
    compute = attrs.get("compute_dtype", "")
    conv = get_op("conv2d")
    x = _compute_cast(ins["Input"], compute)
    w = _compute_cast(ins["Filter"], compute)
    if w.dtype != x.dtype:
        # a shared AMP cast may have fed only one side pre-cast; the
        # convolution needs matching dtypes — follow the input
        w = w.to(x.dtype)
    y = conv.fn({"Input": x, "Filter": w},
                dict(attrs.get("conv_attrs") or {}))["Output"]
    bn = get_op("batch_norm")
    out = bn.fn({"X": y, "Scale": ins["Scale"], "Bias": ins["Bias"],
                 "Mean": ins["Mean"], "Variance": ins["Variance"]},
                dict(attrs.get("bn_attrs") or {}))
    act = attrs.get("act", "")
    if act:
        out["Y"] = get_op(act).fn({"X": out["Y"]},
                                  dict(attrs.get("act_attrs")
                                       or {}))["Out"]
    return out
