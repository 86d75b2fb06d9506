"""Tensor manipulation and creation ops (port of the static-graph slice
of paddle_tpu/ops/tensor_ops.py: `cast` :29, `concat` :34, `split` :42,
`stack` / `unstack` :60-68, `reshape2` :75, `transpose2` :98, `squeeze2`
/ `unsqueeze2` :112-129, `flatten2` :143, `slice` / `strided_slice`
:169-187, `gather` / `gather_nd` / `scatter` :196-212, `expand` /
`expand_as` :238-245, `fill_constant` :283, the `fill_*_like` ops
:294-311, the random init ops :319-343, `range` / `linspace` / `eye`
:368-386, `shape` :401, `assign` / `assign_value` :412-417 and `where`
:430).

The ops keep the reference's `(ins, attrs) -> outs` signature and are
registered under their op types.  `XShape` is the reference's empty
[0, *x.shape] tensor.  An op with no tensor input makes its output on
`attrs["_device"]`, and the random ops draw from `attrs["_generator"]`;
the Executor passes both (its device and its generator).  The random
bits cannot match the reference's JAX bits.
"""

import math

import numpy as np
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


@register_op("cast")
def cast(ins, attrs):
    return {"Out": ins["X"].to(resolve_dtype(attrs["out_dtype"]))}


def _list(xs):
    return list(xs) if isinstance(xs, (list, tuple)) else [xs]


@register_op("concat")
def concat(ins, attrs):
    return {"Out": torch.cat(_list(ins["X"]), dim=attrs.get("axis", 0))}


@register_op("split")
def split(ins, attrs):
    """Into `sections` sizes along `axis`, or `num` equal parts."""
    x = ins["X"]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        sizes = list(sections)
    else:
        num = attrs.get("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {x.shape[axis]} of axis {axis} "
                             f"does not divide into {num} parts")
        sizes = x.shape[axis] // num
    return {"Out": list(torch.split(x, sizes, dim=axis))}


@register_op("stack")
def stack(ins, attrs):
    return {"Y": torch.stack(_list(ins["X"]), dim=attrs.get("axis", 0))}


@register_op("unstack")
def unstack(ins, attrs):
    return {"Y": list(torch.unbind(ins["X"], dim=attrs.get("axis", 0)))}


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


@register_op("squeeze2")
def squeeze2(ins, attrs):
    """The size-1 dims of `axes` dropped (the others kept), or every
    size-1 dim when `axes` is empty."""
    x = ins["X"]
    axes = attrs.get("axes", [])
    if axes:
        axes = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
        out = x.squeeze(axes) if axes else x
    else:
        out = x.squeeze()
    return {"Out": out, "XShape": _xshape(x)}


@register_op("unsqueeze2")
def unsqueeze2(ins, attrs):
    x = ins["X"]
    out = x
    for a in sorted(attrs.get("axes", [])):
        out = out.unsqueeze(a)
    return {"Out": out, "XShape": _xshape(x)}


@register_op("slice")
def slice_(ins, attrs):
    """operators/slice_op.cc: [start, end) on each of `axes`, negative
    bounds from the end, both clamped to the dim; then the
    `decrease_axis` dims dropped."""
    x = ins["Input"]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(int(s), int(e))
    out = x[tuple(idx)]
    for a in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(a)
    return {"Out": out}


@register_op("strided_slice")
def strided_slice(ins, attrs):
    """Python's slice(start, end, stride) on each of `axes`; a negative
    stride (which torch's slicing lacks) gathers the indices Python's
    slice gives."""
    x = ins["Input"]
    out = x
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                           attrs["strides"]):
        sl = slice(int(s), int(e), int(st))
        if st > 0:
            idx = [slice(None)] * x.dim()
            idx[a] = sl
            out = out[tuple(idx)]
        else:
            pick = torch.arange(*sl.indices(out.shape[a]), device=x.device)
            out = out.index_select(a, pick)
    return {"Out": out}


def _index_1d(idx):
    # an [N, 1] index is an [N] one, as in the reference
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx.squeeze(1)
    return idx.long()


@register_op("gather")
def gather(ins, attrs):
    """jnp.take along `axis`: the output is x.shape[:axis] + Index.shape
    + x.shape[axis + 1:]."""
    x = ins["X"]
    idx = _index_1d(ins["Index"])
    axis = attrs.get("axis", 0) % x.dim()
    out = x.index_select(axis, idx.reshape(-1))
    return {"Out": out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                               + tuple(x.shape[axis + 1:]))}


@register_op("gather_nd")
def gather_nd(ins, attrs):
    """x indexed by the last dim of Index (its leading coordinates)."""
    idx = ins["Index"].long()
    return {"Out": ins["X"][tuple(idx.movedim(-1, 0))]}


@register_op("scatter")
def scatter(ins, attrs):
    """Updates written into the rows `Ids` of X (overwrite), or added to
    them (overwrite=False); which of several updates of one row wins
    under overwrite is unspecified, as in the reference."""
    x, updates = ins["X"], ins["Updates"]
    idx = _index_1d(ins["Ids"])
    return {"Out": x.index_put((idx,), updates.to(x.dtype),
                               accumulate=not attrs.get("overwrite", True))}


@register_op("expand")
def expand(ins, attrs):
    """operators/expand_op.cc: X tiled `expand_times` along each dim."""
    return {"Out": torch.tile(ins["X"], tuple(attrs["expand_times"]))}


@register_op("expand_as")
def expand_as(ins, attrs):
    return {"Out": ins["X"].broadcast_to(ins["target_tensor"].shape)}


@register_op("fill_constant")
def fill_constant(ins, attrs):
    value = attrs.get("value", 0.0)
    if isinstance(value, str):
        value = float(value)
    return {"Out": torch.full(_shape_attr(ins, attrs), value,
                              dtype=resolve_dtype(attrs.get("dtype",
                                                            "float32")),
                              device=attrs["_device"])}


@register_op("fill_constant_batch_size_like")
def fill_constant_batch_size_like(ins, attrs):
    """`shape` with its dim `output_dim_idx` taken from Input's dim
    `input_dim_idx`, filled with `value`."""
    ref = ins["Input"]
    shape = list(attrs["shape"])
    shape[attrs.get("output_dim_idx", 0)] = ref.shape[
        attrs.get("input_dim_idx", 0)]
    return {"Out": torch.full(shape, attrs.get("value", 0.0),
                              dtype=resolve_dtype(attrs.get("dtype",
                                                            "float32")),
                              device=ref.device)}


@register_op("fill_zeros_like")
def fill_zeros_like(ins, attrs):
    return {"Out": torch.zeros_like(ins["X"])}


@register_op("fill_any_like")
def fill_any_like(ins, attrs):
    x = ins["X"]
    dtype = attrs.get("dtype", -1)
    dt = x.dtype if dtype in (-1, None) else resolve_dtype(dtype)
    return {"Out": torch.full_like(x, attrs.get("value", 0.0), dtype=dt)}


@register_op("gaussian_random", needs_rng=True)
def gaussian_random(ins, attrs):
    """Normal(mean, std) (operators/gaussian_random_op.cc), drawn in
    float32 from the executor's generator and cast to `dtype`."""
    gen = attrs["_generator"]
    z = torch.randn(_shape_attr(ins, attrs), generator=gen,
                    device=gen.device, dtype=torch.float32)
    out = z * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": out.to(resolve_dtype(attrs.get("dtype", "float32")))}


# the standard normal's CDF at -2 and at 2
_CDF_LO = 0.5 * math.erfc(2.0 / math.sqrt(2.0))
_CDF_HI = 1.0 - _CDF_LO


@register_op("truncated_gaussian_random", needs_rng=True)
def truncated_gaussian_random(ins, attrs):
    """Normal(mean, std) truncated at two standard deviations, as the
    reference's `jax.random.truncated_normal(key, -2, 2)`: a uniform draw
    mapped through the inverse CDF on [cdf(-2), cdf(2)]."""
    gen = attrs["_generator"]
    u = torch.rand(tuple(attrs.get("shape", [])), generator=gen,
                   device=gen.device, dtype=torch.float32)
    p = _CDF_LO + u * (_CDF_HI - _CDF_LO)
    z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0), -2.0, 2.0)
    out = z * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": out.to(resolve_dtype(attrs.get("dtype", "float32")))}


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


def _scalar(t):
    return t.reshape(()).item()


@register_op("range")
def range_(ins, attrs):
    """[Start, End) by Step, float32 (the reference's arange of Python
    floats)."""
    return {"Out": torch.arange(float(_scalar(ins["Start"])),
                                float(_scalar(ins["End"])),
                                float(_scalar(ins["Step"])),
                                dtype=torch.float32,
                                device=ins["Start"].device)}


@register_op("linspace")
def linspace(ins, attrs):
    return {"Out": torch.linspace(
        float(_scalar(ins["Start"])), float(_scalar(ins["Stop"])),
        int(_scalar(ins["Num"])),
        dtype=resolve_dtype(attrs.get("dtype", "float32")),
        device=ins["Start"].device)}


@register_op("eye")
def eye(ins, attrs):
    rows = attrs["num_rows"]
    cols = attrs.get("num_columns", -1)
    if cols is None or cols < 0:
        cols = rows
    return {"Out": torch.eye(rows, cols,
                             dtype=resolve_dtype(attrs.get("dtype",
                                                           "float32")),
                             device=attrs["_device"])}


@register_op("shape")
def shape_(ins, attrs):
    x = ins["Input"]
    return {"Out": torch.tensor(tuple(x.shape), dtype=torch.int32,
                                device=x.device)}


@register_op("assign")
def assign(ins, attrs):
    return {"Out": ins["X"]}


@register_op("assign_value")
def assign_value(ins, attrs):
    """The first non-empty value list of the attrs, shaped; zeros when
    every list is empty."""
    dtype = resolve_dtype(attrs.get("dtype", "float32"))
    shape = attrs.get("shape")
    for key in ("fp32_values", "int32_values", "int64_values",
                "bool_values"):
        vals = attrs.get(key)
        if vals:
            return {"Out": torch.as_tensor(
                np.array(vals).reshape(shape)).to(device=attrs["_device"],
                                                  dtype=dtype)}
    return {"Out": torch.zeros(shape, dtype=dtype, device=attrs["_device"])}


@register_op("where")
def where(ins, attrs):
    return {"Out": torch.where(ins["Condition"], ins["X"], ins["Y"])}
