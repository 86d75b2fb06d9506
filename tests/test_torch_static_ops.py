"""The port's static-graph ops against the JAX package's registered ops.

Each of the 18 ops the static zoo's families added to the port
(`paddle_tpu_torch/ops/{math,tensor,nn}_ops.py`) runs on the same numpy
inputs (seeded) as the reference's op function
(`paddle_tpu.ops.registry.get_op(name).fn`), with the same attrs, and
every output is compared: shape and dtype equal, then the values.

Tolerances (atol = rtol):
- shape ops (reshape2, transpose2, flatten2, fill_constant) and integer
  outputs (top_k's indices, accuracy's counts): exact;
- float32 math: 1e-6 (the same elementwise math; products and means of
  at most 16 terms summed in another order);
- bfloat16 math: 3e-2 (one bf16 rounding of the result, taken at other
  places).

`uniform_random` cannot match the reference's JAX bits: its outputs are
held to the reference's shape and dtype, the [min, max) range, the
sample mean, and repeatability under a seeded generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
from paddle_tpu.ops import registry as jreg

from paddle_tpu_torch.ops import registry as treg
from torch_threads import torch_threads  # noqa: F401

NEW_OPS = (
    "elementwise_add", "scale", "matmul", "mul", "reduce_mean", "mean",
    "reshape2", "transpose2", "flatten2", "fill_constant",
    "uniform_random", "relu", "gelu", "softmax", "cross_entropy",
    "square_error_cost", "top_k", "accuracy",
)
SHAPE_OPS = {"reshape2", "transpose2", "flatten2", "fill_constant"}
TOL = {"float32": 1e-6, "bfloat16": 3e-2}


def _rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _probs(shape, seed):
    e = np.exp(_rnd(shape, seed))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _distinct(shape, seed):
    """Values without ties (a permutation), so top_k's order is unique."""
    n = int(np.prod(shape))
    perm = np.random.default_rng(seed).permutation(n)
    return (perm.reshape(shape) / n).astype(np.float32)


def _labels(shape, k, seed):
    return np.random.default_rng(seed).integers(0, k, shape).astype(
        np.int64)


# (id, op, inputs {slot: np array}, attrs); float inputs run in each
# dtype of the case's dtypes
CASES = [
    # elementwise_add: Paddle's axis rule (Y lines up with X from axis)
    ("add_axis-1", "elementwise_add",
     {"X": _rnd((2, 3, 4, 5), 1), "Y": _rnd((4, 5), 2)}, {"axis": -1}),
    ("add_axis0", "elementwise_add",
     {"X": _rnd((2, 3, 4, 5), 3), "Y": _rnd((2, 3), 4)}, {"axis": 0}),
    ("add_axis1", "elementwise_add",
     {"X": _rnd((2, 3, 4, 5), 5), "Y": _rnd((3, 4), 6)}, {"axis": 1}),
    ("add_axis2", "elementwise_add",
     {"X": _rnd((2, 3, 4, 5), 7), "Y": _rnd((4,), 8)}, {"axis": 2}),
    ("add_same", "elementwise_add",
     {"X": _rnd((3, 4), 9), "Y": _rnd((3, 4), 10)}, {"axis": -1}),
    ("add_scalar_y", "elementwise_add",
     {"X": _rnd((3, 4), 11), "Y": _rnd((), 12)}, {"axis": 1}),
    ("scale_after", "scale", {"X": _rnd((3, 5), 13)},
     {"scale": 2.5, "bias": -0.5, "bias_after_scale": True}),
    ("scale_before", "scale", {"X": _rnd((3, 5), 14)},
     {"scale": 2.5, "bias": -0.5, "bias_after_scale": False}),
    ("matmul", "matmul",
     {"X": _rnd((2, 3, 4, 5), 15), "Y": _rnd((2, 3, 5, 6), 16)}, {}),
    ("matmul_tx", "matmul",
     {"X": _rnd((2, 3, 5, 4), 17), "Y": _rnd((2, 3, 5, 6), 18)},
     {"transpose_X": True}),
    ("matmul_ty_alpha", "matmul",
     {"X": _rnd((2, 3, 4, 5), 19), "Y": _rnd((2, 3, 6, 5), 20)},
     {"transpose_Y": True, "alpha": 0.125}),
    ("matmul_txy", "matmul",
     {"X": _rnd((3, 5, 4), 21), "Y": _rnd((3, 6, 5), 22)},
     {"transpose_X": True, "transpose_Y": True, "alpha": 2.0}),
    ("matmul_2d", "matmul", {"X": _rnd((4, 8), 23), "Y": _rnd((8, 3), 24)},
     {}),
    ("mul_xnc2", "mul", {"X": _rnd((2, 3, 4), 25), "Y": _rnd((4, 5), 26)},
     {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    ("mul_xnc1", "mul", {"X": _rnd((2, 3, 4), 27), "Y": _rnd((12, 5), 28)},
     {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    ("mul_y3d", "mul", {"X": _rnd((2, 3, 4), 29), "Y": _rnd((2, 2, 5), 30)},
     {"x_num_col_dims": 2, "y_num_col_dims": 2}),
    ("reduce_mean_dim1", "reduce_mean", {"X": _rnd((2, 6, 4), 31)},
     {"dim": [1], "keep_dim": False, "reduce_all": False}),
    ("reduce_mean_keep", "reduce_mean", {"X": _rnd((2, 6, 4), 32)},
     {"dim": [0, 2], "keep_dim": True, "reduce_all": False}),
    ("reduce_mean_all", "reduce_mean", {"X": _rnd((2, 6, 4), 33)},
     {"reduce_all": True, "keep_dim": False}),
    ("reduce_mean_all_keep", "reduce_mean", {"X": _rnd((2, 6, 4), 34)},
     {"reduce_all": True, "keep_dim": True}),
    ("reduce_mean_int_dim", "reduce_mean", {"X": _rnd((2, 6, 4), 35)},
     {"dim": -1}),
    ("mean", "mean", {"X": _rnd((3, 7), 36)}, {}),
    ("reshape_0_-1", "reshape2", {"X": _rnd((2, 3, 4), 37)},
     {"shape": [0, -1]}),
    ("reshape_-1_4", "reshape2", {"X": _rnd((2, 3, 4), 38)},
     {"shape": [-1, 4]}),
    ("reshape_0_2_-1", "reshape2", {"X": _rnd((2, 6, 4), 39)},
     {"shape": [0, 2, -1]}),
    ("reshape_mid0", "reshape2", {"X": _rnd((2, 3, 4), 40)},
     {"shape": [2, 0, 2, 2]}),
    ("transpose_0213", "transpose2", {"X": _rnd((2, 3, 4, 5), 41)},
     {"axis": [0, 2, 1, 3]}),
    ("transpose_10", "transpose2", {"X": _rnd((3, 4), 42)}, {"axis": [1, 0]}),
    ("flatten_1", "flatten2", {"X": _rnd((2, 3, 4, 5), 43)}, {"axis": 1}),
    ("flatten_2", "flatten2", {"X": _rnd((2, 3, 4, 5), 44)}, {"axis": 2}),
    ("flatten_0", "flatten2", {"X": _rnd((2, 3, 4), 45)}, {"axis": 0}),
    ("fill_f32", "fill_constant", {},
     {"shape": [2, 3], "dtype": "float32", "value": 1.5}),
    ("fill_int64", "fill_constant", {},
     {"shape": [4], "dtype": "int64", "value": 3.0}),
    ("fill_proto5", "fill_constant", {},
     {"shape": [1], "dtype": 5, "value": 0.9}),
    ("fill_bool", "fill_constant", {},
     {"shape": [2, 2], "dtype": "bool", "value": 1.0}),
    ("relu", "relu", {"X": _rnd((4, 6), 46)}, {}),
    ("gelu_erf", "gelu", {"X": _rnd((4, 6), 47, 2.0)}, {}),
    ("gelu_tanh", "gelu", {"X": _rnd((4, 6), 48, 2.0)},
     {"approximate": True}),
    ("softmax_last", "softmax", {"X": _rnd((3, 4, 5), 49, 3.0)}, {}),
    ("softmax_axis1", "softmax", {"X": _rnd((3, 4, 5), 50, 3.0)},
     {"axis": 1}),
    ("ce_hard", "cross_entropy",
     {"X": _probs((6, 10), 51), "Label": _labels((6, 1), 10, 52)}, {}),
    ("ce_hard_flat_label", "cross_entropy",
     {"X": _probs((6, 10), 53), "Label": _labels((6,), 10, 54)}, {}),
    ("ce_hard_3d", "cross_entropy",
     {"X": _probs((2, 3, 7), 55), "Label": _labels((2, 3, 1), 7, 56)}, {}),
    ("ce_ignore", "cross_entropy",
     {"X": _probs((4, 5), 57),
      "Label": np.array([[1], [3], [3], [0]], np.int64)},
     {"ignore_index": 3}),
    ("ce_soft", "cross_entropy",
     {"X": _probs((4, 5), 58), "Label": _probs((4, 5), 59)},
     {"soft_label": True}),
    ("square_error_cost", "square_error_cost",
     {"X": _rnd((5, 1), 60), "Y": _rnd((5, 1), 61)}, {}),
    ("top_k1", "top_k", {"X": _distinct((6, 10), 62)}, {"k": 1}),
    ("top_k5", "top_k", {"X": _distinct((6, 10), 63)}, {"k": 5}),
    ("top_k5_3d", "top_k", {"X": _distinct((2, 3, 8), 64)}, {"k": 5}),
]

# accuracy takes top_k's outputs: both sides from the reference's top_k
for _k, _lshape in ((1, (8, 1)), (5, (8, 1)), (5, (8,))):
    _x = _distinct((8, 10), 70 + _k)
    _vals, _idx = jax.lax.top_k(jnp.asarray(_x), _k)
    _lab = np.asarray(_idx)[:, 0].astype(np.int64)   # a hit on each row,
    _lab[::3] = (_lab[::3] + 7) % 10                 # then some misses
    CASES.append((f"accuracy_k{_k}_{len(_lshape)}d", "accuracy",
                  {"Out": np.asarray(_vals), "Indices": np.asarray(_idx),
                   "Label": _lab.reshape(_lshape)}, {}))

# float math that also runs in bfloat16
BF16_OPS = {"elementwise_add", "scale", "matmul", "mul", "reduce_mean",
            "mean", "relu", "gelu", "softmax", "square_error_cost"}


def _params():
    out = []
    for cid, op, ins, attrs in CASES:
        out.append(pytest.param(op, ins, attrs, "float32", id=cid))
        if op in BF16_OPS:
            out.append(pytest.param(op, ins, attrs, "bfloat16",
                                    id=cid + "-bf16"))
    return out


def _jax_in(a, dtype):
    if a.dtype.kind == "f" and dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16)
    if a.dtype == np.int64:
        return jnp.asarray(a.astype(np.int32))
    return jnp.asarray(a)


def _torch_in(a, dtype):
    t = torch.from_numpy(np.array(a))
    if a.dtype.kind == "f" and dtype == "bfloat16":
        return t.to(torch.bfloat16)
    if a.dtype == np.int64:
        return t.to(torch.int32)
    return t


def _np_of(v):
    if isinstance(v, torch.Tensor):
        name = str(v.dtype).replace("torch.", "")
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy(), name
    a = np.asarray(v)
    name = a.dtype.name
    if name == "bfloat16":
        a = a.astype(np.float32)
    return a, name


def test_new_ops_are_registered_with_the_reference_flags():
    for name in NEW_OPS + ("batch_norm", "conv2d", "layer_norm",
                           "lookup_table_v2", "pool2d",
                           "softmax_with_cross_entropy", "dropout", "sgd",
                           "momentum", "adam", "adamw"):
        mine, ref = treg.get_op(name), jreg.get_op(name)
        assert (mine.needs_rng, mine.stateful) == (ref.needs_rng,
                                                   ref.stateful), name
    # an op of the corpus not ported yet names its item
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        treg.get_op("sequence_pool")
    with pytest.raises(ValueError, match="already registered"):
        treg.register_op("relu")(lambda ins, attrs: {})


@pytest.mark.parametrize("op,ins,attrs,dtype", _params())
def test_op_matches_reference(op, ins, attrs, dtype):
    want = jreg.get_op(op).fn(
        {k: _jax_in(v, dtype) for k, v in ins.items()}, dict(attrs))
    got = treg.get_op(op).fn(
        {k: _torch_in(v, dtype) for k, v in ins.items()},
        dict(attrs, _device=torch.device("cpu")))
    assert set(got) == set(want), (sorted(got), sorted(want))
    for slot in want:
        g, g_dt = _np_of(got[slot])
        w, w_dt = _np_of(want[slot])
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        assert g_dt == w_dt, (slot, g_dt, w_dt)
        if slot == "XShape":
            continue
        if op in SHAPE_OPS or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=slot)
        else:
            tol = TOL[dtype]
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                       err_msg=slot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uniform_random_shape_dtype_range_and_seed(dtype):
    attrs = {"shape": [64, 64], "dtype": dtype, "min": -0.25, "max": 0.75,
             "seed": 0}
    want = jreg.get_op("uniform_random").fn(
        {}, dict(attrs, _rng=jax.random.PRNGKey(0)))["Out"]
    opdef = treg.get_op("uniform_random")
    assert opdef.needs_rng

    def draw(seed):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return opdef.fn({}, dict(attrs, _generator=gen,
                                 _device=torch.device("cpu")))["Out"]

    got = draw(7)
    g, g_dt = _np_of(got)
    w, w_dt = _np_of(want)
    assert g.shape == w.shape and g_dt == w_dt
    assert g.min() >= -0.25 and g.max() <= 0.75
    # 4096 draws: the mean's standard error is 0.29 / 64
    assert abs(float(g.mean()) - 0.25) < 0.02
    assert abs(float(w.mean()) - 0.25) < 0.02
    assert torch.equal(draw(7), got)
    assert not torch.equal(draw(8), got)
