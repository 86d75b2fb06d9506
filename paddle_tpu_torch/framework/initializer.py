"""Parameter initializers (port of paddle_tpu/framework/initializer.py).

Paddle-Fluid's fluid/initializer.py: each initializer appends an init op
for a parameter into the *startup program*, with the reference's op types
and attrs (ConstantInitializer, UniformInitializer, NormalInitializer,
TruncatedNormalInitializer, XavierInitializer, MSRAInitializer,
NumpyArrayInitializer).  The port's executor runs their ops,
`fill_constant`, `uniform_random`, `gaussian_random`,
`truncated_gaussian_random` and `assign_value`, drawing from its own
generator: the random values cannot match the reference's JAX bits.
"""

import math

import numpy as np


class Initializer:
    """Base of the initializers: a subclass's `__call__(param, block)`
    appends the init op of `param` to `block`."""


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, param, block):
        block.append_op(
            "fill_constant",
            outputs={"Out": param.name},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "value": float(self.value)},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, param, block):
        block.append_op(
            "uniform_random",
            outputs={"Out": param.name},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "min": self.low, "max": self.high, "seed": self.seed},
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, param, block):
        block.append_op(
            "gaussian_random",
            outputs={"Out": param.name},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed},
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, param, block):
        block.append_op(
            "truncated_gaussian_random",
            outputs={"Out": param.name},
            attrs={"shape": list(param.shape), "dtype": param.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed},
        )


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot init (initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out = fan_in, fan_out
        self.seed = seed

    def __call__(self, param, block):
        fi, fo = _fan_in_out(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(param, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(param, block)


class MSRAInitializer(Initializer):
    """Kaiming/He init (initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, param, block):
        fi, _ = _fan_in_out(param.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(param, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(param, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, param, block):
        block.append_op(
            "assign_value",
            outputs={"Out": param.name},
            attrs={"shape": list(self.value.shape), "dtype": param.dtype,
                   "fp32_values": self.value.astype(np.float32).flatten().tolist()},
        )


class BilinearInitializer(Initializer):
    """Bilinear-upsample kernel init for transposed conv weights
    (parity: reference initializer.py BilinearInitializer :766-775) —
    a Conv2DTranspose with this weight, stride s, kernel 2s-s%2 and
    groups=C performs bilinear interpolation.  Weight shape must be
    [C_in, f_out, H, W] with H == W."""

    def __call__(self, param, block):
        shape = list(param.shape)
        if len(shape) != 4:
            raise ValueError(
                f"BilinearInitializer needs a 4-D weight, got {shape}")
        if shape[2] != shape[3]:
            raise ValueError(
                f"BilinearInitializer needs a square kernel, got {shape}")
        k = shape[3]
        # exactly the reference's formula: f = ceil(k/2),
        # c = (2f - 1 - f%2) / (2f); the center's half-pixel shift keys
        # on the parity of f, NOT of k (review catch — they differ for
        # k % 4 in {2, 3})
        f = (k + 1) // 2
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:k, :k]
        filt = ((1 - np.abs(og[0] / f - c))
                * (1 - np.abs(og[1] / f - c)))
        # each (in-channel, out-filter) slot gets the same bilinear
        # kernel; emission delegates to NumpyArrayInitializer so the
        # assign_value encoding lives once
        weight = np.broadcast_to(filt, shape).astype(np.float32)
        NumpyArrayInitializer(weight)(param, block)


# Reference-compatible aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
Bilinear = BilinearInitializer
MSRA = MSRAInitializer
