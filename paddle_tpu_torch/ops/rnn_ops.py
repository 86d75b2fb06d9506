"""Recurrent-cell ops (port of paddle_tpu/ops/rnn_ops.py: `lstm_unit`
:197).  The rest of the module (the sequence RNNs, gru_unit, row_conv)
is ROADMAP item 10."""

import torch

from .registry import register_op


@register_op("lstm_unit")
def lstm_unit(ins, attrs):
    """operators/lstm_unit_op.h:61-71: one LSTM step; X [B, 4D] holds the
    gate pre-activations in the order [i, f, o, g], and forget_bias is
    added to f before its sigmoid."""
    x, c_prev = ins["X"], ins["C_prev"]
    fb = float(attrs.get("forget_bias", 0.0))
    d = c_prev.shape[-1]
    i = torch.sigmoid(x[:, :d])
    f = torch.sigmoid(x[:, d:2 * d] + fb)
    o = torch.sigmoid(x[:, 2 * d:3 * d])
    g = torch.tanh(x[:, 3 * d:])
    c = f * c_prev + i * g
    return {"C": c, "H": o * torch.tanh(c)}
