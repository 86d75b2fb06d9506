"""Tensor manipulation and creation ops (port of the static-zoo slice of
paddle_tpu/ops/tensor_ops.py: `reshape2` :75, `transpose2` :98,
`flatten2` :143, `fill_constant` :283, `uniform_random` :331).

The ops keep the reference's `(ins, attrs) -> outs` signature and are
registered under their op types.  `XShape` is the reference's empty
[0, *x.shape] tensor.  An op with no tensor input makes its output on
`attrs["_device"]`, and `uniform_random` draws from
`attrs["_generator"]`; the Executor passes both (its device and its
generator).  The random bits cannot match the reference's JAX bits.
"""

import torch

from ..core.dtype import to_torch_dtype
from .registry import register_op

# Paddle's VarType dtype enum (framework.proto:107-125), for programs
# written with numeric dtype attrs
_PROTO_DTYPE = {
    0: "bool", 1: "int16", 2: "int32", 3: "int64", 4: "float16",
    5: "float32", 6: "float64", 20: "uint8", 21: "int8", 22: "bfloat16",
}


def resolve_dtype(d):
    if isinstance(d, int):
        d = _PROTO_DTYPE[d]
    return to_torch_dtype(d)


def _xshape(x):
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device)


def _shape_attr(ins, attrs):
    """The `shape` attr, or the ShapeTensor input's values (a list of
    ints or of size-1 tensors) when one is given."""
    st = ins.get("ShapeTensor")
    if st is None:
        return list(attrs.get("shape", []))
    if isinstance(st, torch.Tensor):
        return [int(v) for v in st.reshape(-1).tolist()]
    return [int(v) for v in st]


@register_op("reshape2")
def reshape2(ins, attrs):
    """operators/reshape_op.cc: a 0 in `shape` copies the input's dim at
    that position, a -1 is inferred."""
    x = ins["X"]
    shape = _shape_attr(ins, attrs)
    new_shape = [x.shape[i] if s == 0 else int(s)
                 for i, s in enumerate(shape)]
    return {"Out": x.reshape(new_shape), "XShape": _xshape(x)}


@register_op("transpose2")
def transpose2(ins, attrs):
    x = ins["X"]
    return {"Out": x.permute(*attrs["axis"]), "XShape": _xshape(x)}


@register_op("flatten2")
def flatten2(ins, attrs):
    """operators/flatten_op.cc: dims before `axis` into the first dim,
    the rest into the second."""
    x = ins["X"]
    axis = attrs.get("axis", 1)
    first = 1
    for s in x.shape[:axis]:
        first *= s
    return {"Out": x.reshape(first, -1), "XShape": _xshape(x)}


@register_op("fill_constant")
def fill_constant(ins, attrs):
    value = attrs.get("value", 0.0)
    if isinstance(value, str):
        value = float(value)
    return {"Out": torch.full(_shape_attr(ins, attrs), value,
                              dtype=resolve_dtype(attrs.get("dtype",
                                                            "float32")),
                              device=attrs["_device"])}


@register_op("uniform_random", needs_rng=True)
def uniform_random(ins, attrs):
    """Uniform in [min, max) (operators/uniform_random_op.cc), drawn in
    float32 from the executor's generator and cast to `dtype`; the op's
    own `seed` attr is ignored, as the reference ignores it."""
    gen = attrs["_generator"]
    lo = attrs.get("min", -1.0)
    hi = attrs.get("max", 1.0)
    u = torch.rand(_shape_attr(ins, attrs), generator=gen,
                   device=gen.device, dtype=torch.float32)
    out = u * (hi - lo) + lo
    return {"Out": out.to(resolve_dtype(attrs.get("dtype", "float32")))}
