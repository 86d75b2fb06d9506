"""Simple MLP (port of paddle_tpu/models/mlp.py: the fit_a_line /
recognize_digits `mlp` fixture)."""

from .. import nn


class MLP(nn.Layer):
    def __init__(self, input_dim, hidden_dims=(128, 64), num_classes=10,
                 act="relu", dtype="float32", **kw):
        super().__init__(dtype=dtype, **kw)
        sub = self.sub_kwargs()
        dims = [input_dim] + list(hidden_dims)
        self.hidden = nn.LayerList([
            nn.Linear(dims[i], dims[i + 1], act=act, **sub)
            for i in range(len(dims) - 1)
        ], **sub)
        self.out = nn.Linear(dims[-1], num_classes, **sub)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for fc in self.hidden:
            x = fc(x)
        return self.out(x)
