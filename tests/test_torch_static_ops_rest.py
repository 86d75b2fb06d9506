"""The rest of the port's static-graph ops against the JAX package's.

Each op that the reference's `layers.nn`, `layers.tensor` and
`layers.loss` builders, its initializers, `clip.py`, `regularizer.py` and
static `Adagrad` emit, and that an earlier slice had not ported
(`paddle_tpu_torch/ops/{math,tensor,nn,optimizer,rnn}_ops.py`), runs on
the same seeded numpy inputs as the reference's op function
(`paddle_tpu.ops.registry.get_op(name).fn`), with the same attrs, and
every output is compared: shape and dtype equal, then the values.  The
float ops that train also compare their vector-Jacobian products
(`jax.grad` against `torch.autograd.grad`) with a seeded cotangent, at
atol = rtol = 1e-5.

Tolerances (atol = rtol):
- shape and index ops (cast, concat, split, slice, gather, pad, ...)
  and integer or boolean outputs: exact;
- float32 math: 1e-6 (the same elementwise math; sums of at most 72
  terms in another order);
- bfloat16 math: 3e-2 (one bf16 rounding of the result, taken at other
  places).

The random init ops cannot match the reference's JAX bits: they are held
to the reference's shape and dtype, their range, sample mean and
standard deviation, and repeatability under a seeded generator.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
from paddle_tpu.ops import registry as jreg

from paddle_tpu_torch.ops import registry as treg
from torch_threads import torch_threads  # noqa: F401

TOL = {"float32": 1e-6, "bfloat16": 3e-2}
CPU = torch.device("cpu")


def _rnd(shape, seed, scale=1.0, lo=None):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    if lo is not None:
        a = np.abs(a) + lo
    return a.astype(np.float32)


def _uni(shape, seed, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _int(shape, seed, lo, hi):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int64)


def _bool(shape, seed):
    return np.random.default_rng(seed).random(shape) < 0.5


def _perm(n, seed):
    return np.random.default_rng(seed).permutation(n).astype(np.int64)


# (id, op, inputs {slot: np array or list of them}, attrs, kind)
# kind: "f" float math (f32 and bf16, grads in f32), "f32" float math
# in f32 only, "exact" shape/index/integer ops compared exactly
CASES = []


def case(cid, op, ins, attrs=None, kind="f"):
    CASES.append((cid, op, ins, attrs or {}, kind))


# -- math_ops: the elementwise family, Paddle's axis rule -------------------
X4 = (2, 3, 4, 5)
for name in ("sub", "mul", "max", "min"):
    op = "elementwise_" + name
    case(f"{name}_same", op, {"X": _rnd((3, 4), 1), "Y": _rnd((3, 4), 2)})
    case(f"{name}_axis1", op, {"X": _rnd(X4, 3), "Y": _rnd((3, 4), 4)},
         {"axis": 1})
    case(f"{name}_trailing", op, {"X": _rnd(X4, 5), "Y": _rnd((4, 5), 6)})
case("div_same", "elementwise_div",
     {"X": _rnd((3, 4), 7), "Y": _rnd((3, 4), 8, lo=0.5)})
case("div_axis0", "elementwise_div",
     {"X": _rnd(X4, 9), "Y": _rnd((2, 3), 10, lo=0.5)}, {"axis": 0})
case("pow_same", "elementwise_pow",
     {"X": _rnd((3, 4), 11, lo=0.2), "Y": _rnd((3, 4), 12)})
case("pow_axis2", "elementwise_pow",
     {"X": _rnd(X4, 13, lo=0.2), "Y": _rnd((4,), 14)}, {"axis": 2})
# mod takes the divisor's sign (jnp.mod); floordiv rounds down
_num = _rnd((4, 6), 15, 3.0)
_den = _rnd((4, 6), 16, lo=0.5) * np.where(_rnd((4, 6), 17) < 0, -1, 1)
_den = _den.astype(np.float32)
case("mod_signs", "elementwise_mod", {"X": _num, "Y": _den}, kind="f32")
case("mod_int", "elementwise_mod",
     {"X": _int((4, 6), 18, -20, 20), "Y": _int((4, 6), 19, 1, 7)
      * np.where(_rnd((4, 6), 20) < 0, -1, 1)}, kind="exact")
case("floordiv_signs", "elementwise_floordiv", {"X": _num, "Y": _den},
     kind="f32")
case("floordiv_int", "elementwise_floordiv",
     {"X": _int((4, 6), 21, -20, 20), "Y": _int((4, 6), 22, 1, 7)},
     kind="exact")
case("pow_factor2", "pow", {"X": _rnd((3, 5), 23)}, {"factor": 2.0})
case("pow_factor_half", "pow", {"X": _rnd((3, 5), 24, lo=0.1)},
     {"factor": 0.5})
case("sum3", "sum", {"X": [_rnd((3, 4), 25), _rnd((3, 4), 26),
                           _rnd((3, 4), 27)]})
case("sum1", "sum", {"X": [_rnd((3, 4), 28)]})

# -- reductions ------------------------------------------------------------
for name in ("sum", "max", "min", "prod"):
    op = "reduce_" + name
    case(f"{name}_dim1", op, {"X": _rnd((2, 6, 4), 30)},
         {"dim": [1], "keep_dim": False, "reduce_all": False})
    case(f"{name}_keep02", op, {"X": _rnd((2, 6, 4), 31)},
         {"dim": [0, 2], "keep_dim": True, "reduce_all": False})
    case(f"{name}_all", op, {"X": _rnd((2, 6, 4), 32)},
         {"reduce_all": True, "keep_dim": False})
    case(f"{name}_neg", op, {"X": _rnd((2, 6, 4), 33)}, {"dim": -1})
case("sum_int", "reduce_sum", {"X": _int((3, 5), 34, -9, 9)},
     {"dim": [1]}, kind="exact")
case("sum_all_keep", "reduce_sum", {"X": _rnd((3, 5), 35)},
     {"reduce_all": True, "keep_dim": True})
case("prod_int", "reduce_prod", {"X": _int((3, 4), 36, -3, 4)},
     {"reduce_all": True}, kind="exact")
for name in ("all", "any"):
    case(f"{name}_dim", "reduce_" + name, {"X": _bool((4, 5), 37)},
         {"dim": [1]}, kind="exact")
    case(f"{name}_all", "reduce_" + name, {"X": _bool((4, 5), 38)},
         {"reduce_all": True, "keep_dim": True}, kind="exact")

# -- unaries ---------------------------------------------------------------
_POS = ("log", "log2", "log10", "sqrt", "rsqrt", "reciprocal")
for i, name in enumerate((
        "abs", "exp", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
        "square", "sin", "cos", "tan", "atan", "sinh", "cosh",
        "reciprocal")):
    x = _rnd((4, 6), 40 + i, lo=0.1) if name in _POS else \
        _uni((4, 6), 40 + i, -0.9, 3.0) if name == "log1p" else \
        _rnd((4, 6), 40 + i)
    case(name, name, {"X": x})
for i, name in enumerate(("asin", "acos")):
    case(name, name, {"X": _uni((4, 6), 60 + i, -0.9, 0.9)})
# floor, ceil, round and sign: integers, ties at .5 (round half to even)
_steps = np.concatenate([np.arange(-3.5, 3.6, 0.5),
                         _rnd((9,), 62, 3.0)]).astype(np.float32)
for name in ("floor", "ceil", "round", "sign"):
    case(name, name, {"X": _steps.reshape(4, 6)}, kind="exact")
case("sign_zero", "sign", {"X": np.array([-2.0, 0.0, 3.0], np.float32)},
     kind="exact")
case("logical_not", "logical_not", {"X": _bool((3, 4), 63)}, kind="exact")

# -- clips and norms -------------------------------------------------------
case("clip", "clip", {"X": _rnd((4, 6), 64, 2.0)}, {"min": -0.5, "max": 1.0})
case("clip_by_norm_cuts", "clip_by_norm", {"X": _rnd((4, 6), 65)},
     {"max_norm": 1.0})
case("clip_by_norm_keeps", "clip_by_norm", {"X": _rnd((4, 6), 66, 0.01)},
     {"max_norm": 1.0})
case("squared_l2_norm", "squared_l2_norm", {"X": _rnd((4, 6), 67)})

# -- cumsum, arg ops, increment, compares ------------------------------------
for cid, attrs in (("axis1", {"axis": 1}), ("axis0", {"axis": 0}),
                   ("exclusive", {"axis": 1, "exclusive": True}),
                   ("reverse", {"axis": 1, "reverse": True}),
                   ("excl_rev", {"axis": 0, "exclusive": True,
                                 "reverse": True}),
                   ("flatten", {"flatten": True})):
    case(f"cumsum_{cid}", "cumsum", {"X": _rnd((3, 5), 68)}, attrs)
case("cumsum_int", "cumsum", {"X": _int((3, 5), 69, -5, 5)}, {"axis": 1},
     kind="exact")
# ties (a value repeated along the axis): the first index wins, and
# argsort is stable on both sides
_ties = _int((4, 7), 70, 0, 4).astype(np.float32)
for op in ("arg_max", "arg_min"):
    case(f"{op}_ax1", op, {"X": _ties}, {"axis": 1}, kind="exact")
    case(f"{op}_ax0", op, {"X": _rnd((4, 7), 71)}, {"axis": 0}, kind="exact")
case("argsort_asc", "argsort", {"X": _ties}, {"axis": -1}, kind="exact")
case("argsort_desc", "argsort", {"X": _ties},
     {"axis": 1, "descending": True}, kind="exact")
case("argsort_ax0", "argsort", {"X": _rnd((5, 3), 72)}, {"axis": 0},
     kind="exact")
case("increment", "increment", {"X": _rnd((3,), 73)}, {"step": 2.5})
case("increment_int", "increment", {"X": np.array([4], np.int64)}, {},
     kind="exact")
_a = _int((4, 5), 74, 0, 3).astype(np.float32)
_b = _int((4, 5), 75, 0, 3).astype(np.float32)
for op in ("less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal"):
    case(op, op, {"X": _a, "Y": _b}, kind="exact")
    case(op + "_bcast", op, {"X": _a, "Y": _b[0]}, kind="exact")
for op in ("logical_and", "logical_or", "logical_xor"):
    case(op, op, {"X": _bool((4, 5), 76), "Y": _bool((4, 5), 77)},
         kind="exact")
case("maximum", "maximum", {"X": _rnd((3, 4), 78), "Y": _rnd((3, 4), 79)})
case("minimum", "minimum", {"X": _rnd((3, 4), 80), "Y": _rnd((4,), 81)})

# -- tensor_ops ------------------------------------------------------------
for cid, dt in (("f32_int", "int32"), ("f32_int64", "int64"),
                ("f32_bool", "bool"), ("f32_bf16", "bfloat16"),
                ("f32_proto6", 6)):
    case(f"cast_{cid}", "cast", {"X": _rnd((3, 4), 82, 3.0)},
         {"out_dtype": dt}, kind="exact")
case("cast_int_f32", "cast", {"X": _int((3, 4), 83, -9, 9)},
     {"out_dtype": "float32"}, kind="exact")
case("cast_bool_f32", "cast", {"X": _bool((3, 4), 84)},
     {"out_dtype": "float32"}, kind="exact")
for axis in (0, 1, -1):
    case(f"concat_{axis}", "concat",
         {"X": [_rnd((2, 3, 4), 85), _rnd((2, 3, 4), 86)]}, {"axis": axis},
         kind="exact")
case("concat_sizes", "concat",
     {"X": [_rnd((2, 3), 87), _rnd((2, 1), 88), _rnd((2, 2), 89)]},
     {"axis": 1}, kind="exact")
case("split_num", "split", {"X": _rnd((4, 6), 90)},
     {"num": 3, "axis": 1, "sections": []}, kind="exact")
case("split_sections", "split", {"X": _rnd((4, 6), 91)},
     {"num": 0, "axis": -1, "sections": [1, 2, 3]}, kind="exact")
case("split_axis0", "split", {"X": _rnd((4, 6), 92)},
     {"num": 2, "axis": 0, "sections": []}, kind="exact")
case("stack_0", "stack", {"X": [_rnd((3, 4), 93), _rnd((3, 4), 94)]},
     {"axis": 0}, kind="exact")
case("stack_-1", "stack", {"X": [_rnd((3, 4), 95), _rnd((3, 4), 96)]},
     {"axis": -1}, kind="exact")
case("unstack_1", "unstack", {"X": _rnd((2, 3, 4), 97)}, {"axis": 1},
     kind="exact")
case("squeeze_axes", "squeeze2", {"X": _rnd((1, 3, 1, 4), 98)},
     {"axes": [0, -2, 1]}, kind="exact")
case("squeeze_all", "squeeze2", {"X": _rnd((1, 3, 1, 4), 99)},
     {"axes": []}, kind="exact")
case("unsqueeze", "unsqueeze2", {"X": _rnd((3, 4), 100)},
     {"axes": [0, 2]}, kind="exact")
case("unsqueeze_neg", "unsqueeze2", {"X": _rnd((3, 4), 101)},
     {"axes": [-1]}, kind="exact")
case("slice", "slice", {"Input": _rnd((4, 6, 5), 102)},
     {"axes": [0, 2], "starts": [1, -3], "ends": [3, 100],
      "decrease_axis": []}, kind="exact")
case("slice_decrease", "slice", {"Input": _rnd((4, 6, 5), 103)},
     {"axes": [1], "starts": [2], "ends": [3], "decrease_axis": [1]},
     kind="exact")
case("strided_slice", "strided_slice", {"Input": _rnd((6, 8), 104)},
     {"axes": [0, 1], "starts": [0, 1], "ends": [6, 8],
      "strides": [2, 3]}, kind="exact")
case("strided_slice_neg", "strided_slice", {"Input": _rnd((6, 8), 105)},
     {"axes": [1], "starts": [7], "ends": [0], "strides": [-2]},
     kind="exact")
case("gather_0", "gather",
     {"X": _rnd((6, 4), 106), "Index": _int((5,), 107, 0, 6)},
     {"axis": 0}, kind="exact")
case("gather_col", "gather",
     {"X": _rnd((6, 4), 108), "Index": _int((5, 1), 109, 0, 6)}, {},
     kind="exact")
case("gather_axis1", "gather",
     {"X": _rnd((3, 6, 4), 110), "Index": _int((2, 3), 111, 0, 6)},
     {"axis": 1}, kind="exact")
case("gather_nd", "gather_nd",
     {"X": _rnd((4, 5, 3), 112), "Index": np.stack(
         [_int((6,), 113, 0, 4), _int((6,), 114, 0, 5)], -1)}, {},
     kind="exact")
case("gather_nd_full", "gather_nd",
     {"X": _rnd((4, 5), 115), "Index": np.stack(
         [_int((2, 3), 116, 0, 4), _int((2, 3), 117, 0, 5)], -1)}, {},
     kind="exact")
# unique indices: under overwrite, which duplicate wins is unordered
case("scatter_overwrite", "scatter",
     {"X": _rnd((6, 3), 118), "Ids": _perm(6, 119)[:4],
      "Updates": _rnd((4, 3), 120)}, {"overwrite": True}, kind="exact")
case("scatter_add", "scatter",
     {"X": _rnd((6, 3), 121), "Ids": _perm(6, 122)[:4, None],
      "Updates": _rnd((4, 3), 123)}, {"overwrite": False})
case("expand", "expand", {"X": _rnd((2, 1, 3), 124)},
     {"expand_times": [1, 4, 2]}, kind="exact")
case("expand_as", "expand_as",
     {"X": _rnd((1, 3), 125), "target_tensor": _rnd((4, 3), 126)}, {},
     kind="exact")
case("fill_bsl", "fill_constant_batch_size_like",
     {"Input": _rnd((5, 2), 127)},
     {"shape": [-1, 3], "dtype": "float32", "value": 0.5,
      "input_dim_idx": 0, "output_dim_idx": 0}, kind="exact")
case("fill_bsl_int", "fill_constant_batch_size_like",
     {"Input": _rnd((5, 2), 128)},
     {"shape": [4, -1], "dtype": "int64", "value": 3.0,
      "input_dim_idx": 1, "output_dim_idx": 1}, kind="exact")
case("fill_zeros_like", "fill_zeros_like", {"X": _rnd((3, 4), 129)}, {},
     kind="exact")
case("fill_any_like", "fill_any_like", {"X": _rnd((3, 4), 130)},
     {"value": 1.0}, kind="exact")
case("fill_any_like_int", "fill_any_like", {"X": _rnd((3, 4), 131)},
     {"value": 7.0, "dtype": "int32"}, kind="exact")
case("range", "range",
     {"Start": np.array([0.5], np.float32), "End": np.array([7.0],
                                                            np.float32),
      "Step": np.array([0.75], np.float32)}, {}, kind="f32")
case("range_int", "range",
     {"Start": np.array([2], np.int64), "End": np.array([11], np.int64),
      "Step": np.array([3], np.int64)}, {}, kind="f32")
case("linspace", "linspace",
     {"Start": np.array([-1.0], np.float32),
      "Stop": np.array([2.0], np.float32), "Num": np.array([7], np.int64)},
     {"dtype": "float32"}, kind="f32")
case("eye_square", "eye", {}, {"num_rows": 4, "num_columns": -1,
                               "dtype": "float32"}, kind="exact")
case("eye_rect_int", "eye", {}, {"num_rows": 3, "num_columns": 5,
                                 "dtype": "int64"}, kind="exact")
case("shape", "shape", {"Input": _rnd((2, 3, 4), 132)}, {}, kind="exact")
case("assign", "assign", {"X": _rnd((3, 4), 133)}, {}, kind="exact")
case("assign_value_fp32", "assign_value", {},
     {"shape": [2, 3], "dtype": "float32",
      "fp32_values": [0.5, -1.0, 2.25, 3.0, 4.5, -6.0]}, kind="exact")
case("assign_value_int64", "assign_value", {},
     {"shape": [3], "dtype": "int64", "int64_values": [1, -2, 3]},
     kind="exact")
case("assign_value_bool", "assign_value", {},
     {"shape": [2, 2], "dtype": "bool",
      "bool_values": [True, False, False, True]}, kind="exact")
case("assign_value_empty", "assign_value", {},
     {"shape": [2, 2], "dtype": "float32", "fp32_values": []},
     kind="exact")
case("where", "where", {"Condition": _bool((3, 4), 134),
                        "X": _rnd((3, 4), 135), "Y": _rnd((3, 4), 136)})

# -- nn_ops: activations ------------------------------------------------------
_act = _rnd((4, 6), 137, 4.0)
for name in ("sigmoid", "tanh", "softplus", "softsign", "relu6"):
    case(name, name, {"X": _act})
case("relu6_high", "relu6", {"X": _rnd((4, 6), 138, 5.0) + 4.0})
case("leaky_relu", "leaky_relu", {"X": _act}, {"alpha": 0.1})
case("elu", "elu", {"X": _act}, {"alpha": 0.7})
case("hard_sigmoid", "hard_sigmoid", {"X": _act},
     {"slope": 0.2, "offset": 0.5})
case("hard_swish", "hard_swish", {"X": _act},
     {"threshold": 6.0, "scale": 6.0, "offset": 3.0})
case("swish", "swish", {"X": _act}, {"beta": 1.5})
case("prelu_all", "prelu", {"X": _rnd((2, 3, 4), 139),
                            "Alpha": np.array([0.25], np.float32)},
     {"mode": "all"})
case("prelu_channel", "prelu", {"X": _rnd((2, 3, 4, 2), 140),
                                "Alpha": _rnd((3,), 141)},
     {"mode": "channel"})
case("prelu_element", "prelu", {"X": _rnd((2, 3, 4), 142),
                                "Alpha": _rnd((3, 4), 143)},
     {"mode": "element"})
case("log_softmax", "log_softmax", {"X": _rnd((3, 4, 5), 144, 3.0)})
case("log_softmax_ax1", "log_softmax", {"X": _rnd((3, 4, 5), 145, 3.0)},
     {"axis": 1})

# -- losses ------------------------------------------------------------------
_lab01 = (_rnd((6, 3), 146) > 0).astype(np.float32)
case("sigmoid_ce", "sigmoid_cross_entropy_with_logits",
     {"X": _rnd((6, 3), 147, 3.0), "Label": _lab01})
_lab_ign = _lab01.copy()
_lab_ign[::2, 1] = -1.0
case("sigmoid_ce_ignore_norm", "sigmoid_cross_entropy_with_logits",
     {"X": _rnd((6, 3), 148, 3.0), "Label": _lab_ign},
     {"ignore_index": -1, "normalize": True})
case("sigmoid_ce_soft", "sigmoid_cross_entropy_with_logits",
     {"X": _rnd((6, 3), 149, 3.0), "Label": _uni((6, 3), 150, 0, 1)})
case("smooth_l1", "smooth_l1_loss",
     {"X": _rnd((5, 3, 2), 151), "Y": _rnd((5, 3, 2), 152)}, {"sigma": 1.5})
case("smooth_l1_2d", "smooth_l1_loss",
     {"X": _rnd((5, 4), 153), "Y": _rnd((5, 4), 154)}, {})
case("huber", "huber_loss", {"X": _rnd((6, 1), 155, 2.0),
                             "Y": _rnd((6, 1), 156, 2.0)}, {"delta": 1.0})
# probabilities at and near 0 and 1 (the 1e-12 clip)
_p = _uni((8, 1), 157, 0.0, 1.0)
_p[:3, 0] = [0.0, 1.0, 1e-9]
case("bce", "bce_loss", {"X": _p, "Label": (_rnd((8, 1), 158) > 0).astype(
    np.float32)}, kind="f32")
case("bce_mid", "bce_loss", {"X": _uni((8, 1), 159, 0.05, 0.95),
                             "Label": _uni((8, 1), 160, 0, 1)})
case("log_loss", "log_loss",
     {"Predicted": _uni((8, 1), 161, 0.01, 0.99),
      "Labels": (_rnd((8, 1), 162) > 0).astype(np.float32)},
     {"epsilon": 1e-4})
case("label_smooth", "label_smooth",
     {"X": np.eye(5, dtype=np.float32)[_int((6,), 163, 0, 5)]},
     {"epsilon": 0.1})
case("label_smooth_prior", "label_smooth",
     {"X": np.eye(5, dtype=np.float32)[_int((6,), 164, 0, 5)],
      "PriorDist": _uni((1, 5), 165, 0.1, 0.3)}, {"epsilon": 0.2})
_target = _uni((4, 5), 166, 0.0, 1.0)
_target[0, :2] = 0.0
for red in ("mean", "sum", "batchmean", "none"):
    case(f"kldiv_{red}", "kldiv_loss",
         {"X": _rnd((4, 5), 167), "Target": _target}, {"reduction": red})

# -- one_hot, pad, norms -----------------------------------------------------
case("one_hot_col", "one_hot", {"X": _int((6, 1), 168, 0, 5)},
     {"depth": 5}, kind="exact")
case("one_hot_flat", "one_hot", {"X": _int((2, 3), 169, 0, 4)},
     {"depth": 4}, kind="exact")
case("one_hot_v2", "one_hot_v2", {"X": _int((2, 3), 169, -1, 5)},
     {"depth": 4}, kind="exact")
case("pad", "pad", {"X": _rnd((2, 3), 170)},
     {"paddings": [1, 0, 2, 3], "pad_value": 0.5}, kind="exact")
case("pad2d_constant", "pad2d", {"X": _rnd((1, 2, 3, 4), 171)},
     {"paddings": [1, 2, 0, 1], "mode": "constant", "pad_value": -1.0},
     kind="exact")
case("pad2d_reflect", "pad2d", {"X": _rnd((1, 2, 3, 4), 172)},
     {"paddings": [1, 2, 2, 1], "mode": "reflect"}, kind="exact")
case("pad2d_edge", "pad2d", {"X": _rnd((1, 2, 3, 4), 173)},
     {"paddings": [2, 0, 1, 3], "mode": "edge"}, kind="exact")
case("norm_last", "norm", {"X": _rnd((3, 5), 174)},
     {"axis": -1, "epsilon": 1e-12})
case("norm_axis1", "norm", {"X": _rnd((2, 4, 3), 175)},
     {"axis": 1, "epsilon": 1e-10})
case("instance_norm", "instance_norm",
     {"X": _rnd((2, 3, 4, 5), 176), "Scale": _rnd((3,), 177),
      "Bias": _rnd((3,), 178)}, {"epsilon": 1e-5})
case("instance_norm_plain", "instance_norm", {"X": _rnd((2, 3, 6), 179)},
     {})
case("group_norm", "group_norm",
     {"X": _rnd((2, 6, 3, 4), 180), "Scale": _rnd((6,), 181),
      "Bias": _rnd((6,), 182)}, {"groups": 3, "epsilon": 1e-5})
case("group_norm_plain", "group_norm", {"X": _rnd((2, 4, 5), 183)},
     {"groups": 2})

# -- convolutions ------------------------------------------------------------
_img = _rnd((2, 4, 6, 5), 184, 0.5)
case("depthwise", "depthwise_conv2d",
     {"Input": _img, "Filter": _rnd((4, 1, 3, 3), 185, 0.5)},
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 1}, kind="f32")
case("depthwise_mult", "depthwise_conv2d",
     {"Input": _img, "Filter": _rnd((8, 1, 3, 3), 186, 0.5)},
     {"strides": [2, 1], "paddings": [0, 1], "dilations": [1, 1]},
     kind="f32")
for cid, w_shape, attrs in (
        ("s1", (4, 3, 3, 3), {"strides": [1, 1], "paddings": [0, 0]}),
        ("s2p1", (4, 3, 3, 3), {"strides": [2, 2], "paddings": [1, 1]}),
        ("s2_asym", (4, 2, 3, 2), {"strides": [2, 3], "paddings": [1, 0]}),
        ("dil2", (4, 2, 3, 3), {"strides": [1, 2], "paddings": [2, 1],
                                "dilations": [2, 1]}),
        ("groups2", (4, 3, 3, 3), {"strides": [2, 2], "paddings": [1, 0],
                                   "groups": 2}),
        ("pad4", (4, 2, 3, 3), {"strides": [2, 2],
                                "paddings": [1, 0, 0, 2]}),
        ("same", (4, 2, 3, 3), {"strides": [2, 2],
                                "padding_algorithm": "SAME"})):
    case(f"conv2d_transpose_{cid}", "conv2d_transpose",
         {"Input": _img, "Filter": _rnd(w_shape, 187, 0.5)}, attrs,
         kind="f32")

# -- interpolate (jax.image.resize: half-pixel centres, antialias when a
# linear or cubic resize shrinks) ----------------------------------------------
_grid = _rnd((2, 3, 6, 8), 188)
for method in ("nearest", "bilinear", "bicubic"):
    case(f"resize_{method}_up", "interpolate", {"X": _grid},
         {"interp_method": method, "out_h": 9, "out_w": 13})
    case(f"resize_{method}_down", "interpolate", {"X": _grid},
         {"interp_method": method, "out_h": 4, "out_w": 3})
    case(f"resize_{method}_mixed", "interpolate", {"X": _grid},
         {"interp_method": method, "out_h": 11, "out_w": 5})
case("resize_scale", "interpolate", {"X": _grid},
     {"interp_method": "bilinear", "scale": 1.5})
case("resize_trilinear", "interpolate", {"X": _rnd((1, 2, 4, 5, 6), 189)},
     {"interp_method": "trilinear", "out_d": 6, "out_h": 3, "out_w": 7})

# -- adagrad, lstm_unit ------------------------------------------------------
case("adagrad", "adagrad",
     {"Param": _rnd((4, 3), 190), "Grad": _rnd((4, 3), 191),
      "Moment": _uni((4, 3), 192, 0.0, 2.0),
      "LearningRate": np.array([0.05], np.float32)}, {"epsilon": 1e-6})
case("adagrad_zero_moment", "adagrad",
     {"Param": _rnd((6,), 193), "Grad": _rnd((6,), 194),
      "Moment": np.zeros((6,), np.float32),
      "LearningRate": np.array([0.1], np.float32)}, {})
case("lstm_unit", "lstm_unit",
     {"X": _rnd((3, 8), 195), "C_prev": _rnd((3, 2), 196)},
     {"forget_bias": 1.0})
case("lstm_unit_nofb", "lstm_unit",
     {"X": _rnd((3, 12), 197), "C_prev": _rnd((3, 3), 198)}, {})

RANDOM_OPS = ("gaussian_random", "truncated_gaussian_random")
NEW_OPS = tuple(sorted({op for _, op, _, _, _ in CASES} | set(RANDOM_OPS)))
# ops whose float outputs have gradients worth holding (the rest are
# piecewise constant, integer or boolean)
NO_GRAD_OPS = {"elementwise_mod", "elementwise_floordiv", "floor", "ceil",
               "round", "sign", "arg_max", "arg_min", "argsort", "adagrad",
               "one_hot", "shape", "eye", "fill_zeros_like",
               "fill_any_like", "fill_constant_batch_size_like", "range",
               "linspace", "assign_value", "cast"}


def _params():
    out = []
    for cid, op, ins, attrs, kind in CASES:
        out.append(pytest.param(op, ins, attrs, kind, "float32", id=cid))
        if kind == "f":
            out.append(pytest.param(op, ins, attrs, kind, "bfloat16",
                                    id=cid + "-bf16"))
    return out


def _map(ins, fn):
    return {k: [fn(a) for a in v] if isinstance(v, list) else fn(v)
            for k, v in ins.items()}


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
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy(), name
    a = np.asarray(v)
    name = a.dtype.name
    if name == "bfloat16":
        a = a.astype(np.float32)
    return a, name


def _flat(outs):
    """(slot, index, value) of every output, list slots expanded."""
    items = []
    for slot in sorted(outs):
        v = outs[slot]
        vs = v if isinstance(v, (list, tuple)) else [v]
        items += [(slot, i, x) for i, x in enumerate(vs)]
    return items


def _run_both(op, ins, attrs, dtype):
    want = jreg.get_op(op).fn(_map(ins, lambda a: _jax_in(a, dtype)),
                              dict(attrs))
    got = treg.get_op(op).fn(_map(ins, lambda a: _torch_in(a, dtype)),
                             dict(attrs, _device=CPU))
    return got, want


# the ops of the earlier slices (tests/test_torch_static_ops.py)
EARLIER_OPS = {
    "elementwise_add", "scale", "matmul", "mul", "reduce_mean", "mean",
    "reshape2", "transpose2", "flatten2", "fill_constant", "uniform_random",
    "relu", "gelu", "softmax", "cross_entropy", "square_error_cost", "top_k",
    "accuracy", "batch_norm", "conv2d", "layer_norm", "lookup_table_v2",
    "pool2d", "softmax_with_cross_entropy", "dropout", "sgd", "momentum",
    "adam", "adamw"}


# the fusion-tier ops (ops/fused_ops.py), held by tests/test_torch_fuse.py
FUSION_TIER_OPS = {"fused_attention", "fused_bias_act", "fused_layer_norm",
                   "fused_bottleneck"}

# the static DGC ops (ops/misc_ops.py), held by tests/test_torch_static_dgc.py
DGC_OPS = {"dgc_clip_by_norm", "dgc", "dgc_momentum"}

# the ops of the control-flow layers and the learning-rate schedules,
# held by tests/test_torch_control_flow.py and test_torch_lr_scheduler.py
CONTROL_FLOW_LAYER_OPS = {"print", "lod_rank_table", "max_sequence_len",
                          "shrink_memory", "piecewise_decay_lr",
                          "linear_warmup_lr"}


def test_new_ops_are_registered_with_the_reference_flags():
    # every op the port registers is held here, by the earlier file, by
    # the fusion tier's, the static DGC's or the control-flow slice's
    assert set(treg._OPS) - EARLIER_OPS - FUSION_TIER_OPS - DGC_OPS \
        - CONTROL_FLOW_LAYER_OPS == set(NEW_OPS)
    for name in NEW_OPS + tuple(sorted(CONTROL_FLOW_LAYER_OPS)):
        mine, ref = treg.get_op(name), jreg.get_op(name)
        assert (mine.needs_rng, mine.stateful) == (ref.needs_rng,
                                                   ref.stateful), name


@pytest.mark.parametrize("op,ins,attrs,kind,dtype", _params())
def test_op_matches_reference(op, ins, attrs, kind, dtype):
    got, want = _run_both(op, ins, attrs, dtype)
    assert set(got) == set(want), (sorted(got), sorted(want))
    g_items, w_items = _flat(got), _flat(want)
    assert [(s, i) for s, i, _ in g_items] == [(s, i) for s, i, _ in w_items]
    for (slot, i, g), (_, _, w) in zip(g_items, w_items):
        g, g_dt = _np_of(g)
        w, w_dt = _np_of(w)
        tag = f"{slot}[{i}]"
        assert g.shape == w.shape, (tag, g.shape, w.shape)
        assert g_dt == w_dt, (tag, g_dt, w_dt)
        if slot == "XShape":
            continue
        if kind == "exact" or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=tag)
        else:
            tol = TOL[dtype]
            np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                       err_msg=tag)


def _grad_params():
    return [pytest.param(op, ins, attrs, id=cid)
            for cid, op, ins, attrs, kind in CASES
            if kind in ("f", "f32") and op not in NO_GRAD_OPS]


# the target of kldiv_loss is data: the reference's gradient with respect
# to it is NaN where it is 0 (log 0), the port's 0
NO_GRAD_SLOTS = {"Target"}


@pytest.mark.parametrize("op,ins,attrs", _grad_params())
def test_op_gradients_match_reference(op, ins, attrs):
    """The vector-Jacobian product of each float output against a seeded
    cotangent, with respect to every float input (each tensor of a list
    input too), f32."""
    leaves = [(k, i) for k, v in sorted(ins.items())
              if k not in NO_GRAD_SLOTS
              for i, a in (enumerate(v) if isinstance(v, list) else
                           [(None, v)]) if a.dtype.kind == "f"]

    def assemble(cvt, xs):
        out = _map(ins, cvt)
        for (k, i), x in zip(leaves, xs):
            if i is None:
                out[k] = x
            else:
                out[k][i] = x
        return out

    def leaf(k, i):
        return ins[k] if i is None else ins[k][i]

    jfn, tfn = jreg.get_op(op).fn, treg.get_op(op).fn
    jcvt = lambda a: _jax_in(a, "float32")  # noqa: E731
    outs = jfn(_map(ins, jcvt), dict(attrs))
    slots = [s for s, v in sorted(outs.items())
             if not isinstance(v, (list, tuple))
             and jnp.issubdtype(v.dtype, jnp.floating)]
    cots = {s: np.random.default_rng(7).standard_normal(
        np.shape(outs[s])).astype(np.float32) for s in slots}

    def jloss(*xs):
        o = jfn(assemble(jcvt, xs), dict(attrs))
        return sum(jnp.sum(o[s] * cots[s]) for s in slots)

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(len(leaves)))))(
        *[jcvt(leaf(k, i)) for k, i in leaves])
    xs = [_torch_in(leaf(k, i), "float32").requires_grad_(True)
          for k, i in leaves]
    o = tfn(assemble(lambda a: _torch_in(a, "float32"), xs),
            dict(attrs, _device=CPU))
    loss = sum((o[s] * torch.from_numpy(cots[s])).sum() for s in slots)
    got = torch.autograd.grad(loss, xs, allow_unused=True)
    for (k, i), g, w in zip(leaves, got, want):
        g = np.zeros(np.shape(w), np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=f"{k}[{i}]")


@pytest.mark.parametrize("op,dtype,mean,std", [
    ("gaussian_random", "float32", 0.5, 2.0),
    ("gaussian_random", "bfloat16", 0.0, 0.02),
    ("truncated_gaussian_random", "float32", 0.1, 0.2),
    ("truncated_gaussian_random", "bfloat16", 0.0, 1.0),
])
def test_random_init_ops_shape_dtype_moments_and_seed(op, dtype, mean, std):
    attrs = {"shape": [64, 64], "dtype": dtype, "mean": mean, "std": std,
             "seed": 0}
    want = jreg.get_op(op).fn({}, dict(attrs, _rng=jax.random.PRNGKey(0)))
    opdef = treg.get_op(op)
    assert opdef.needs_rng

    def draw(seed):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        return opdef.fn({}, dict(attrs, _generator=gen,
                                 _device=CPU))["Out"]

    got = draw(7)
    g, g_dt = _np_of(got)
    w, w_dt = _np_of(want["Out"])
    assert g.shape == w.shape == (64, 64) and g_dt == w_dt == dtype
    # a normal truncated at 2 sigma has std 0.8796 sigma
    truncated = op.startswith("truncated")
    s = std * (0.8796 if truncated else 1.0)
    for a in (g, w):
        a = a.astype(np.float64)
        # 4096 draws: the mean's standard error is s / 64
        assert abs(a.mean() - mean) < 5 * s / 64
        assert abs(a.std() / s - 1.0) < 0.05
        if truncated:
            assert np.all(np.abs(a - mean) <= 2 * std * (1 + 1e-2))
    assert torch.equal(draw(7), got)
    assert not torch.equal(draw(8), got)


def test_gaussian_random_takes_its_shape_tensor():
    gen = torch.Generator(device="cpu").manual_seed(0)
    out = treg.get_op("gaussian_random").fn(
        {"ShapeTensor": torch.tensor([3, 5], dtype=torch.int32)},
        {"shape": [1], "_generator": gen, "_device": CPU})["Out"]
    want = jreg.get_op("gaussian_random").fn(
        {"ShapeTensor": jnp.asarray([3, 5], jnp.int32)},
        {"shape": [1], "_rng": jax.random.PRNGKey(0)})["Out"]
    assert tuple(out.shape) == tuple(want.shape) == (3, 5)


def test_scatter_overwrite_false_adds_every_duplicate():
    """overwrite=False accumulates (the reference's .at[].add), so
    duplicate ids are well defined and add up."""
    x = _rnd((4, 3), 200)
    ids = np.array([1, 3, 1, 1], np.int64)
    upd = _rnd((4, 3), 201)
    got, want = _run_both("scatter", {"X": x, "Ids": ids, "Updates": upd},
                          {"overwrite": False}, "float32")
    np.testing.assert_allclose(got["Out"].numpy(), np.asarray(want["Out"]),
                               atol=1e-6, rtol=1e-6)
    expect = x.copy()
    np.add.at(expect, ids, upd)
    np.testing.assert_allclose(got["Out"].numpy(), expect, atol=1e-6)


def test_truncation_cdf_constants():
    from paddle_tpu_torch.ops import tensor_ops

    assert math.isclose(tensor_ops._CDF_LO, 0.022750131948179195,
                        rel_tol=1e-12)
    assert math.isclose(tensor_ops._CDF_HI, 1 - tensor_ops._CDF_LO)
