"""Abstract shape/dtype inference rules — the verifier's InferShape layer.

A copy of paddle_tpu/analysis/shape_rules.py (pure Python, no JAX): the
port keeps its own so that it imports nothing of the JAX package.  The
fusion tier reads these rules through `facts.infer_specs`.

Parity: the per-op ``InferShape`` / ``InferVarType`` passes every Fluid
OperatorWithKernel runs at Program build time (framework/operator.h).
Each rule abstractly interprets ONE op family over a (shape, dtype)
lattice:

- a shape is a tuple whose entries are ints or ``None`` (unknown dim);
  ``None`` in place of the tuple means fully-unknown rank;
- a dtype is a canonical name string or ``None`` (unknown);
- :data:`OPAQUE` is the lattice top: nothing known.

Rules are registered per op type alongside the kernel registry
(``ops/registry.py`` OpDefs) and NEVER crash the verifier: a rule
raises :class:`ShapeError` for a genuine inconsistency (the verifier
turns it into a PT101/PT102 diagnostic) and anything else degrades the
op's outputs to OPAQUE — unknown ops produce warnings, never false
errors.  Op types with no useful static rule are *explicitly* marked
opaque with :func:`register_opaque`, so the registry-drift test can
distinguish "known-uninferable" from "someone forgot a rule".
"""

import math


class VarSpec:
    """Abstract value: (shape, dtype), either part possibly unknown."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape=None, dtype=None):
        if shape is not None:
            shape = tuple(None if (d is None or (isinstance(d, int)
                                                 and d < 0)) else int(d)
                          for d in shape)
        self.shape = shape
        self.dtype = dtype

    @property
    def rank(self):
        return None if self.shape is None else len(self.shape)

    def numel(self):
        """Static element count, or None if any dim is unknown."""
        if self.shape is None or any(d is None for d in self.shape):
            return None
        return math.prod(self.shape) if self.shape else 1

    def with_dtype(self, dtype):
        return VarSpec(self.shape, dtype)

    def __repr__(self):
        return f"VarSpec(shape={self.shape}, dtype={self.dtype})"


OPAQUE = VarSpec(None, None)


class ShapeError(ValueError):
    """A genuine static inconsistency (shapes/dtypes cannot compose).
    `kind` selects the diagnostic code: "shape" -> PT101, "dtype" ->
    PT102."""

    def __init__(self, message, kind="shape"):
        super().__init__(message)
        self.kind = kind


_RULES = {}        # op type -> fn(op, ins, attrs) -> {slot: VarSpec|list}
_OPAQUE_OPS = set()


def shape_rule(*names):
    """Register one inference rule under op type name(s)."""

    def deco(fn):
        for n in names:
            if n in _RULES:
                raise ValueError(f"shape rule for '{n}' already registered")
            _RULES[n] = fn
        return fn

    return deco


def register_opaque(*names):
    """Explicitly mark op types as statically uninferable: their outputs
    are OPAQUE *by design* (no PT204 'missing rule' warning)."""
    _OPAQUE_OPS.update(names)


def stale_opaque_entries():
    """Audit: register_opaque entries that now have a REAL shape rule.
    An op family in both tables means someone wrote the rule but
    forgot to retire the opaque marker — the rule wins at lookup time
    (``infer_specs`` checks ``is_opaque`` first, so the new rule would
    silently never run).  The registry-drift test fails on any entry
    here, not just on missing coverage."""
    return sorted(_OPAQUE_OPS & set(_RULES))


def has_shape_rule(op_type):
    return op_type in _RULES


def is_opaque(op_type):
    return op_type in _OPAQUE_OPS


def get_rule(op_type):
    return _RULES.get(op_type)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def one(ins, slot):
    """First spec of a slot (OPAQUE when the slot is absent/empty)."""
    vs = ins.get(slot)
    if not vs:
        return OPAQUE
    return vs[0]


def _known(shape):
    return shape is not None


def _dim_eq(a, b):
    """Dims compatible? (unknown matches anything)."""
    return a is None or b is None or a == b


def _merge_dim(a, b):
    return a if b is None else b


def broadcast(xs, ys, axis=-1, op_name=""):
    """Paddle elementwise broadcast (elementwise_op_function.h): align
    Y's dims to X starting at `axis` (axis=-1 => numpy trailing)."""
    if xs is None or ys is None:
        return None
    if len(ys) == 0:
        return tuple(xs)
    if len(ys) > len(xs):
        # numpy-style: the LONGER operand's rank wins
        return broadcast(ys, xs, -1, op_name)
    if axis is None or axis == -1:
        ys = (1,) * (len(xs) - len(ys)) + tuple(ys)
    else:
        # y occupies x's dims [axis, axis+rank(y)); singletons elsewhere
        ys = (1,) * axis + tuple(ys) \
            + (1,) * (len(xs) - axis - len(ys))
        if len(ys) != len(xs):
            raise ShapeError(
                f"{op_name}: Y rank {len(ys) - axis} does not fit X "
                f"{tuple(xs)} at axis {axis}")
    out = []
    for a, b in zip(xs, ys):
        if b == 1:
            out.append(a)
        elif a == 1:
            out.append(b)
        elif a is None:
            out.append(b)
        elif b is None:
            out.append(a)
        elif a == b:
            out.append(a)
        else:
            raise ShapeError(
                f"{op_name}: cannot broadcast {tuple(xs)} with "
                f"{tuple(ys)} (dims {a} vs {b})")
    return tuple(out)


_FLOATS = {"float16", "bfloat16", "float32", "float64"}
_INTS = {"int8", "uint8", "int16", "int32", "int64", "bool"}


def _require_int_dtype(spec, what, op_name):
    if spec.dtype is not None and spec.dtype in _FLOATS:
        raise ShapeError(
            f"{op_name}: {what} must be an integer dtype, got "
            f"{spec.dtype}", kind="dtype")


def _require_same_dtype(a, b, op_name):
    if a.dtype is not None and b.dtype is not None and a.dtype != b.dtype:
        # integer-width mixes are device-canonicalized; flag only
        # float-vs-int and float-width mixes
        fa, fb = a.dtype in _FLOATS, b.dtype in _FLOATS
        if fa != fb or (fa and fb and a.dtype != b.dtype):
            raise ShapeError(
                f"{op_name}: operand dtypes differ ({a.dtype} vs "
                f"{b.dtype})", kind="dtype")


def _pair(v):
    if isinstance(v, (list, tuple)):
        return list(v) if len(v) == 2 else [v[0], v[0]]
    return [v, v]


def _pad_pairs(paddings, algo):
    """Per-side (before, after) padding pairs, mirroring the runtime's
    _conv_pad (ops/nn_ops.py): VALID zeroes the attr, the 4-element
    [b0, a0, b1, a1] form is asymmetric, 2-element/scalar is symmetric.
    Returns None for SAME (handled by the caller's ceil-div path)."""
    if algo == "VALID":
        return [(0, 0), (0, 0)]
    if algo == "SAME":
        return None
    p = paddings if isinstance(paddings, (list, tuple)) else [paddings]
    if len(p) == 4:
        return [(p[0], p[1]), (p[2], p[3])]
    p = _pair(p)
    return [(p[0], p[0]), (p[1], p[1])]


# ---------------------------------------------------------------------------
# elementwise family
# ---------------------------------------------------------------------------

def _elementwise_rule(op, ins, attrs):
    x, y = one(ins, "X"), one(ins, "Y")
    # either operand unknown -> output unknown: broadcasting against an
    # OPAQUE operand can change rank/dims, so guessing the known side's
    # shape would manufacture false PT101s downstream
    shape = broadcast(x.shape, y.shape, attrs.get("axis", -1), op.type) \
        if _known(x.shape) and _known(y.shape) else None
    return {"Out": VarSpec(shape, x.dtype or y.dtype)}


for _n in ("elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
           # maximum/minimum are the numpy-broadcast binary kernels
           # (X, Y), NOT unary: Out must broadcast both operands
           "maximum", "minimum"):
    shape_rule(_n)(_elementwise_rule)


def _compare_rule(op, ins, attrs):
    x, y = one(ins, "X"), one(ins, "Y")
    shape = broadcast(x.shape, y.shape, attrs.get("axis", -1), op.type) \
        if _known(x.shape) and _known(y.shape) else None
    return {"Out": VarSpec(shape, "bool")}


for _n in ("equal", "not_equal", "less_than", "less_equal",
           "greater_than", "greater_equal", "logical_and", "logical_or",
           "logical_xor"):
    shape_rule(_n)(_compare_rule)


def _unary_rule(op, ins, attrs):
    x = one(ins, "X")
    return {"Out": VarSpec(x.shape, x.dtype)}


# shape/dtype-preserving unary ops (activations + pointwise math + the
# normalizers whose primary output keeps X's shape)
for _n in ("relu", "relu6", "sigmoid", "tanh", "exp", "log", "log2",
           "log10", "log1p", "sqrt", "rsqrt", "square", "abs", "ceil",
           "floor", "round", "reciprocal", "sign", "sin", "cos", "tan",
           "sinh", "cosh", "asin", "acos", "atan", "erf", "gelu", "elu",
           "selu", "silu", "swish", "mish", "softplus", "softsign",
           "softshrink", "hard_shrink", "hard_sigmoid", "hard_swish",
           "leaky_relu", "logsigmoid", "tanh_shrink", "thresholded_relu",
           "prelu", "softmax", "log_softmax", "sequence_softmax",
           "scale", "pow", "clip",
           "logical_not", "assign", "label_smooth"):
    if _n not in _RULES:
        shape_rule(_n)(_unary_rule)


@shape_rule("cast")
def _cast_rule(op, ins, attrs):
    x = one(ins, "X")
    return {"Out": VarSpec(x.shape, attrs.get("out_dtype")
                           or attrs.get("dtype") or x.dtype)}


@shape_rule("dropout")
def _dropout_rule(op, ins, attrs):
    x = one(ins, "X")
    return {"Out": VarSpec(x.shape, x.dtype),
            "Mask": VarSpec(x.shape, "uint8")}


# ---------------------------------------------------------------------------
# matmul family
# ---------------------------------------------------------------------------

@shape_rule("mul")
def _mul_rule(op, ins, attrs):
    x, y = one(ins, "X"), one(ins, "Y")
    _require_same_dtype(x, y, op.type)
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    if not _known(x.shape) or not _known(y.shape):
        return {"Out": VarSpec(None, x.dtype or y.dtype)}
    xs, ys = x.shape, y.shape
    kx = (math.prod(d for d in xs[xnc:] if d is not None)
          if all(d is not None for d in xs[xnc:]) else None)
    ky = (math.prod(d for d in ys[:ync] if d is not None)
          if all(d is not None for d in ys[:ync]) else None)
    if kx is not None and ky is not None and kx != ky:
        raise ShapeError(
            f"mul: inner dims do not match — X{tuple(xs)} flattened at "
            f"{xnc} gives K={kx}, Y{tuple(ys)} flattened at {ync} "
            f"gives K={ky}")
    return {"Out": VarSpec(xs[:xnc] + ys[ync:], x.dtype or y.dtype)}


@shape_rule("matmul", "quantized_matmul")
def _matmul_rule(op, ins, attrs):
    x, y = one(ins, "X"), one(ins, "Y")
    _require_same_dtype(x, y, op.type)
    if not _known(x.shape) or not _known(y.shape) \
            or len(x.shape) < 1 or len(y.shape) < 1:
        return {"Out": VarSpec(None, x.dtype or y.dtype)}
    xs, ys = list(x.shape), list(y.shape)
    if attrs.get("transpose_X", False) and len(xs) > 1:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if attrs.get("transpose_Y", False) and len(ys) > 1:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) == 1 and len(ys) == 1:
        if not _dim_eq(xs[0], ys[0]):
            raise ShapeError(f"matmul: vector dims {xs[0]} vs {ys[0]}")
        return {"Out": VarSpec((1,), x.dtype or y.dtype)}
    k_x = xs[-1]
    k_y = ys[-2] if len(ys) > 1 else ys[0]
    if not _dim_eq(k_x, k_y):
        raise ShapeError(
            f"matmul: contracting dims do not match — "
            f"X{tuple(x.shape)} (K={k_x}) vs Y{tuple(y.shape)} "
            f"(K={k_y})")
    bx, by = xs[:-2], ys[:-2]
    if bx and by:
        # numpy-style batch broadcasting: right-align, 1s stretch
        try:
            batch = list(broadcast(bx, by, -1, "matmul"))
        except ShapeError:
            raise ShapeError(
                f"matmul: batch dims {tuple(bx)} do not broadcast "
                f"with {tuple(by)}")
    else:
        batch = list(bx or by)
    m = [xs[-2]] if len(xs) > 1 else []
    n = [ys[-1]] if len(ys) > 1 else []
    return {"Out": VarSpec(tuple(batch) + tuple(m) + tuple(n),
                           x.dtype or y.dtype)}


@shape_rule("fc")
def _fc_rule(op, ins, attrs):
    x, w = one(ins, "Input"), one(ins, "W")
    num_flatten = attrs.get("in_num_col_dims", 1)
    size = None
    if _known(w.shape) and len(w.shape) >= 2:
        size = w.shape[-1]
    if not _known(x.shape):
        return {"Out": VarSpec(None, x.dtype)}
    return {"Out": VarSpec(x.shape[:num_flatten] + (size,), x.dtype)}


# ---------------------------------------------------------------------------
# conv / pool
# ---------------------------------------------------------------------------

def _conv_out_dim(i, k, pad, stride, dilation):
    """pad is a (before, after) pair."""
    if i is None or k is None:
        return None
    return (i + pad[0] + pad[1] - dilation * (k - 1) - 1) // stride + 1


@shape_rule("conv2d", "depthwise_conv2d", "conv2d_fusion")
def _conv2d_rule(op, ins, attrs):
    x, w = one(ins, "Input"), one(ins, "Filter")
    data_format = attrs.get("data_format", "NCHW")
    nchw = data_format in ("NCHW", "AnyLayout")
    groups = attrs.get("groups", 1) or 1
    strides = _pair(attrs.get("strides", [1, 1]))
    algo = attrs.get("padding_algorithm", "EXPLICIT")
    pads = _pad_pairs(attrs.get("paddings", [0, 0]), algo)
    dils = _pair(attrs.get("dilations", [1, 1]))
    if not _known(x.shape) or len(x.shape) != 4:
        return {"Output": VarSpec(None, x.dtype)}
    if nchw:
        n, c, h, wd = x.shape
    else:
        n, h, wd, c = x.shape
    co = kh = kw = None
    if _known(w.shape) and len(w.shape) == 4:
        co, ci, kh, kw = w.shape
        if c is not None and ci is not None and c != ci * groups:
            raise ShapeError(
                f"conv2d: input channels {c} != filter in-channels "
                f"{ci} * groups {groups} (filter {tuple(w.shape)})")
    if pads is None:                     # SAME
        oh = None if h is None else -(-h // strides[0])
        ow = None if wd is None else -(-wd // strides[1])
    else:
        oh = _conv_out_dim(h, kh, pads[0], strides[0], dils[0])
        ow = _conv_out_dim(wd, kw, pads[1], strides[1], dils[1])
    if (oh is not None and oh <= 0) or (ow is not None and ow <= 0):
        raise ShapeError(
            f"conv2d: output spatial dims ({oh}, {ow}) not positive for "
            f"input {tuple(x.shape)}, filter {tuple(w.shape or ())}")
    shape = (n, co, oh, ow) if nchw else (n, oh, ow, co)
    return {"Output": VarSpec(shape, x.dtype)}


@shape_rule("pool2d")
def _pool2d_rule(op, ins, attrs):
    x = one(ins, "X")
    if not _known(x.shape) or len(x.shape) != 4:
        return {"Out": VarSpec(None, x.dtype)}
    data_format = attrs.get("data_format", "NCHW")
    nchw = data_format in ("NCHW", "AnyLayout")
    n, c, h, wd = x.shape if nchw else (
        x.shape[0], x.shape[3], x.shape[1], x.shape[2])
    if attrs.get("global_pooling", False):
        oh = ow = 1
    elif attrs.get("adaptive", False):
        oh, ow = _pair(attrs.get("ksize", [1, 1]))
    else:
        ks = _pair(attrs.get("ksize", [2, 2]))
        strides = _pair(attrs.get("strides", [1, 1]))
        pads = _pad_pairs(attrs.get("paddings", [0, 0]),
                          attrs.get("padding_algorithm", "EXPLICIT"))
        if pads is None:                 # SAME
            oh = None if h is None else -(-h // strides[0])
            ow = None if wd is None else -(-wd // strides[1])
        else:
            ceil = attrs.get("ceil_mode", False)

            def _o(i, k, p, s):
                if i is None or k is None:
                    return None
                num = i + p[0] + p[1] - k
                return (-(-num // s) if ceil else num // s) + 1

            oh = _o(h, ks[0], pads[0], strides[0])
            ow = _o(wd, ks[1], pads[1], strides[1])
    if (oh is not None and oh <= 0) or (ow is not None and ow <= 0):
        raise ShapeError(
            f"pool2d: output spatial dims ({oh}, {ow}) not positive "
            f"for input {tuple(x.shape)}")
    shape = (n, c, oh, ow) if nchw else (n, oh, ow, c)
    return {"Out": VarSpec(shape, x.dtype)}


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _reduce_rule(op, ins, attrs):
    x = one(ins, "X")
    dtype = "bool" if op.type in ("reduce_all", "reduce_any") else x.dtype
    if not _known(x.shape):
        return {"Out": VarSpec(None, dtype)}
    rank = len(x.shape)
    if attrs.get("reduce_all", False) or rank == 0:
        dims = tuple(range(rank))
    else:
        d = attrs.get("dim", [0])
        d = tuple(d) if isinstance(d, (list, tuple)) else (d,)
        for i in d:
            if i >= rank or i < -rank:
                raise ShapeError(
                    f"{op.type}: dim {i} out of range for rank "
                    f"{rank} input {tuple(x.shape)}")
        dims = tuple(i % rank for i in d)
    keep = attrs.get("keep_dim", False)
    if keep:
        shape = tuple(1 if i in dims else d
                      for i, d in enumerate(x.shape))
    else:
        shape = tuple(d for i, d in enumerate(x.shape) if i not in dims)
    return {"Out": VarSpec(shape, dtype)}


for _n in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
           "reduce_prod", "reduce_all", "reduce_any"):
    shape_rule(_n)(_reduce_rule)


@shape_rule("mean")
def _mean_rule(op, ins, attrs):
    x = one(ins, "X")
    return {"Out": VarSpec((), x.dtype)}


@shape_rule("sum")
def _sum_rule(op, ins, attrs):
    xs = ins.get("X") or [OPAQUE]
    shape, dtype = None, None
    for s in xs:
        if _known(s.shape):
            if shape is not None and len(s.shape) == len(shape):
                if any(not _dim_eq(a, b) for a, b in zip(shape, s.shape)):
                    raise ShapeError(
                        f"sum: operand shapes differ ({shape} vs "
                        f"{s.shape})")
            shape = shape or s.shape
        dtype = dtype or s.dtype
    return {"Out": VarSpec(shape, dtype)}


# ---------------------------------------------------------------------------
# reshape / transpose / concat / slice family
# ---------------------------------------------------------------------------

def _reshape_shape(x, target):
    if target is None:
        return None
    target = list(target)
    # Paddle semantics: 0 copies the input dim, one -1 is inferred
    for i, d in enumerate(target):
        if d == 0:
            target[i] = (x.shape[i] if _known(x.shape)
                         and i < len(x.shape) else None)
    if sum(1 for d in target if d == -1) > 1:
        raise ShapeError(f"reshape: more than one -1 in {target}")
    if -1 in target:
        n = x.numel()
        rest = 1
        ok = True
        for d in target:
            if d == -1:
                continue
            if d is None:
                ok = False
                break
            rest *= d
        i = target.index(-1)
        if ok and n is not None:
            if rest == 0 or n % rest != 0:
                raise ShapeError(
                    f"reshape: cannot infer -1 — {n} elements do not "
                    f"divide by {rest} (target {target}, input "
                    f"{x.shape})")
            target[i] = n // rest
        else:
            target[i] = None
    else:
        n = x.numel()
        if n is not None and all(isinstance(d, int) for d in target):
            m = math.prod(target) if target else 1
            if m != n:
                raise ShapeError(
                    f"reshape: element count mismatch — input "
                    f"{x.shape} has {n} elements, target {target} "
                    f"wants {m}")
    return tuple(target)


@shape_rule("reshape", "reshape2")
def _reshape_rule(op, ins, attrs):
    x = one(ins, "X")
    if "ShapeTensor" in op.inputs and op.inputs.get("ShapeTensor"):
        out = {"Out": VarSpec(None, x.dtype)}
    else:
        out = {"Out": VarSpec(_reshape_shape(x, attrs.get("shape")),
                              x.dtype)}
    if "XShape" in op.outputs:
        out["XShape"] = OPAQUE
    return out


@shape_rule("transpose", "transpose2")
def _transpose_rule(op, ins, attrs):
    x = one(ins, "X")
    perm = attrs.get("axis")
    out = {"XShape": OPAQUE} if "XShape" in op.outputs else {}
    if not _known(x.shape) or perm is None:
        out["Out"] = VarSpec(None, x.dtype)
        return out
    if len(perm) != len(x.shape) or sorted(
            p % len(x.shape) for p in perm) != list(range(len(x.shape))):
        raise ShapeError(
            f"transpose: perm {list(perm)} is not a permutation of "
            f"rank-{len(x.shape)} input {tuple(x.shape)}")
    out["Out"] = VarSpec(tuple(x.shape[p] for p in perm), x.dtype)
    return out


@shape_rule("concat")
def _concat_rule(op, ins, attrs):
    xs = ins.get("X") or [OPAQUE]
    axis = attrs.get("axis", 0)
    known = [s for s in xs if _known(s.shape)]
    dtype = next((s.dtype for s in xs if s.dtype), None)
    if not known:
        return {"Out": VarSpec(None, dtype)}
    rank = len(known[0].shape)
    if any(len(s.shape) != rank for s in known):
        raise ShapeError(
            f"concat: operand ranks differ "
            f"({[s.shape for s in known]})")
    ax = axis % rank if rank else 0
    total = 0
    out = list(known[0].shape)
    for s in known:
        for i in range(rank):
            if i == ax:
                continue
            if not _dim_eq(out[i], s.shape[i]):
                raise ShapeError(
                    f"concat: non-axis dim {i} differs — "
                    f"{tuple(out)} vs {tuple(s.shape)} (axis={ax})")
            out[i] = _merge_dim(out[i], s.shape[i])
        total = (None if total is None or s.shape[ax] is None
                 else total + s.shape[ax])
    out[ax] = total if len(known) == len(xs) else None
    return {"Out": VarSpec(tuple(out), dtype)}


@shape_rule("stack")
def _stack_rule(op, ins, attrs):
    xs = ins.get("X") or [OPAQUE]
    axis = attrs.get("axis", 0)
    base = next((s for s in xs if _known(s.shape)), OPAQUE)
    if not _known(base.shape):
        return {"Y": OPAQUE, "Out": OPAQUE}
    shape = list(base.shape)
    shape.insert(axis % (len(shape) + 1), len(xs))
    spec = VarSpec(tuple(shape), base.dtype)
    return {"Y": spec, "Out": spec}


@shape_rule("split")
def _split_rule(op, ins, attrs):
    x = one(ins, "X")
    n = len(op.outputs.get("Out", ()))
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections")
    if not _known(x.shape):
        return {"Out": [OPAQUE] * n}
    shape = list(x.shape)
    ax = axis % len(shape)
    outs = []
    if sections:
        for s in sections:
            sh = list(shape)
            sh[ax] = s if s >= 0 else None
            outs.append(VarSpec(tuple(sh), x.dtype))
    else:
        d = shape[ax]
        if d is not None and n and d % n != 0:
            raise ShapeError(
                f"split: dim {d} not divisible into {n} parts")
        sh = list(shape)
        sh[ax] = None if d is None else d // max(n, 1)
        outs = [VarSpec(tuple(sh), x.dtype)] * n
    return {"Out": outs}


@shape_rule("flatten", "flatten2")
def _flatten_rule(op, ins, attrs):
    x = one(ins, "X")
    axis = attrs.get("axis", 1)
    out = {"XShape": OPAQUE} if "XShape" in op.outputs else {}
    if not _known(x.shape):
        out["Out"] = VarSpec(None, x.dtype)
        return out
    lead = x.shape[:axis]
    tail = x.shape[axis:]
    a = (math.prod(lead) if all(d is not None for d in lead) else None) \
        if lead else 1
    b = (math.prod(tail) if all(d is not None for d in tail) else None) \
        if tail else 1
    out["Out"] = VarSpec((a, b), x.dtype)
    return out


@shape_rule("squeeze", "squeeze2")
def _squeeze_rule(op, ins, attrs):
    x = one(ins, "X")
    axes = attrs.get("axes", [])
    out = {"XShape": OPAQUE} if "XShape" in op.outputs else {}
    if not _known(x.shape):
        out["Out"] = VarSpec(None, x.dtype)
        return out
    rank = len(x.shape)
    drop = {a % rank for a in axes} if axes else {
        i for i, d in enumerate(x.shape) if d == 1}
    out["Out"] = VarSpec(tuple(d for i, d in enumerate(x.shape)
                               if i not in drop), x.dtype)
    return out


@shape_rule("unsqueeze", "unsqueeze2")
def _unsqueeze_rule(op, ins, attrs):
    x = one(ins, "X")
    axes = attrs.get("axes", [])
    out = {"XShape": OPAQUE} if "XShape" in op.outputs else {}
    if not _known(x.shape):
        out["Out"] = VarSpec(None, x.dtype)
        return out
    shape = list(x.shape)
    for a in axes:
        shape.insert(a % (len(shape) + 1), 1)
    out["Out"] = VarSpec(tuple(shape), x.dtype)
    return out


@shape_rule("shape")
def _shape_rule_op(op, ins, attrs):
    x = one(ins, "X")
    return {"Out": VarSpec((x.rank,), "int32")}


@shape_rule("slice")
def _slice_rule(op, ins, attrs):
    x = one(ins, "Input")
    axes = attrs.get("axes", [])
    starts = attrs.get("starts", [])
    ends = attrs.get("ends", [])
    if not _known(x.shape):
        return {"Out": VarSpec(None, x.dtype)}
    shape = list(x.shape)
    for ax, st, en in zip(axes, starts, ends):
        d = shape[ax % len(shape)]
        if d is None:
            continue
        st2 = st + d if st < 0 else min(st, d)
        en2 = en + d if en < 0 else min(en, d)
        shape[ax % len(shape)] = max(en2 - st2, 0)
    dec = sorted({a % len(shape) for a in
                  (attrs.get("decrease_axis") or [])}, reverse=True)
    for a in dec:
        del shape[a]
    return {"Out": VarSpec(tuple(shape), x.dtype)}


@shape_rule("expand")
def _expand_rule(op, ins, attrs):
    x = one(ins, "X")
    times = attrs.get("expand_times")
    if not _known(x.shape) or not times:
        return {"Out": VarSpec(None, x.dtype)}
    shape = tuple(None if d is None else d * t
                  for d, t in zip(x.shape, times))
    return {"Out": VarSpec(shape, x.dtype)}


@shape_rule("fill_constant")
def _fill_constant_rule(op, ins, attrs):
    return {"Out": VarSpec(tuple(attrs.get("shape", ())),
                           attrs.get("dtype", "float32"))}


@shape_rule("fill_constant_batch_size_like")
def _fill_like_rule(op, ins, attrs):
    x = one(ins, "Input")
    shape = list(attrs.get("shape", ()))
    idx = attrs.get("output_dim_idx", 0)
    in_idx = attrs.get("input_dim_idx", 0)
    if shape and _known(x.shape) and in_idx < len(x.shape):
        shape[idx] = x.shape[in_idx]
    return {"Out": VarSpec(tuple(shape), attrs.get("dtype", "float32"))}


@shape_rule("uniform_random", "gaussian_random",
            "truncated_gaussian_random")
def _random_rule(op, ins, attrs):
    return {"Out": VarSpec(tuple(attrs.get("shape", ())),
                           attrs.get("dtype", "float32"))}


@shape_rule("one_hot", "one_hot_v2")
def _one_hot_rule(op, ins, attrs):
    x = one(ins, "X")
    depth = attrs.get("depth")
    _require_int_dtype(x, "input indices", op.type)
    if not _known(x.shape):
        return {"Out": VarSpec(None, "float32")}
    shape = x.shape
    if op.type == "one_hot" and shape and shape[-1] == 1:
        shape = shape[:-1]
    return {"Out": VarSpec(shape + (depth,), "float32")}


# ---------------------------------------------------------------------------
# normalizers with stats outputs / lookup / losses
# ---------------------------------------------------------------------------

@shape_rule("batch_norm", "sync_batch_norm")
def _batch_norm_rule(op, ins, attrs):
    x = one(ins, "X")
    mean, var = one(ins, "Mean"), one(ins, "Variance")
    return {
        "Y": VarSpec(x.shape, x.dtype),
        "MeanOut": VarSpec(mean.shape, mean.dtype),
        "VarianceOut": VarSpec(var.shape, var.dtype),
        "SavedMean": VarSpec(mean.shape, mean.dtype),
        "SavedVariance": VarSpec(var.shape, var.dtype),
    }


@shape_rule("layer_norm")
def _layer_norm_rule(op, ins, attrs):
    x = one(ins, "X")
    axis = attrs.get("begin_norm_axis", 1)
    lead = x.shape[:axis] if _known(x.shape) else None
    return {
        "Y": VarSpec(x.shape, x.dtype),
        "Mean": VarSpec(lead, x.dtype),
        "Variance": VarSpec(lead, x.dtype),
    }


# ---------------------------------------------------------------------------
# fusion-tier ops: real shape rules, not opaque entries —
# the fused program must lint exactly as strictly as its source
# subgraph did
# ---------------------------------------------------------------------------

@shape_rule("fused_attention")
def _fused_attention_rule(op, ins, attrs):
    # NO same-dtype requirement: a shared (multi-consumer) AMP cast
    # may legitimately leave one of Q/K/V bf16 while the others'
    # sole-consumed casts were absorbed — the kernel unifies on the
    # promoted dtype, so mixed declared widths are not a lint error
    q, v = one(ins, "Q"), one(ins, "V")
    if not _known(q.shape) or not _known(v.shape) \
            or len(q.shape) < 2 or len(v.shape) < 2:
        return {"Out": VarSpec(None, q.dtype or v.dtype)}
    heads = int(attrs.get("head_number", 0) or 0)
    if heads and q.shape[-1] is not None and q.shape[-1] % heads != 0:
        raise ShapeError(
            f"fused_attention: feature dim {q.shape[-1]} not divisible "
            f"by head_number {heads}")
    # both layouts: Out keeps Q's leading dims and takes V's last dim
    return {"Out": VarSpec(tuple(q.shape[:-1]) + (v.shape[-1],),
                           q.dtype or v.dtype)}


@shape_rule("fused_bias_act")
def _fused_bias_act_rule(op, ins, attrs):
    x, b = one(ins, "X"), one(ins, "Bias")
    if _known(x.shape) and _known(b.shape) and b.shape \
            and x.shape and x.shape[-1] is not None \
            and len(b.shape) == 1 and b.shape[0] is not None:
        axis = attrs.get("axis", -1)
        at = (len(x.shape) - 1) if axis in (-1, None) else int(axis)
        if 0 <= at < len(x.shape) and x.shape[at] is not None \
                and x.shape[at] != b.shape[0]:
            raise ShapeError(
                f"fused_bias_act: bias length {b.shape[0]} does not "
                f"match X dim {x.shape[at]} at axis {at}")
    return {"Out": VarSpec(x.shape, x.dtype)}


@shape_rule("fused_layer_norm")
def _fused_layer_norm_rule(op, ins, attrs):
    x = one(ins, "X")
    res = ins.get("Residual")
    if res is not None:
        r = res[0] if isinstance(res, list) else res
        if _known(x.shape) and _known(r.shape) \
                and len(x.shape) == len(r.shape) \
                and any(a is not None and b is not None and a != b
                        for a, b in zip(x.shape, r.shape)):
            raise ShapeError(
                f"fused_layer_norm: residual shape {tuple(r.shape)} "
                f"does not match X {tuple(x.shape)}")
    axis = attrs.get("begin_norm_axis", 1)
    lead = x.shape[:axis] if _known(x.shape) else None
    return {
        "Y": VarSpec(x.shape, x.dtype),
        "Mean": VarSpec(lead, x.dtype),
        "Variance": VarSpec(lead, x.dtype),
    }


@shape_rule("fused_bottleneck")
def _fused_bottleneck_rule(op, ins, attrs):
    # the conv half prices exactly like conv2d (same slots, the
    # absorbed conv op's attrs ride under conv_attrs); the bn half
    # mirrors batch_norm's stat outputs
    conv_out = _conv2d_rule(op, ins, dict(attrs.get("conv_attrs")
                                          or {}))["Output"]
    mean, var = one(ins, "Mean"), one(ins, "Variance")
    return {
        "Y": conv_out,
        "MeanOut": VarSpec(mean.shape, mean.dtype),
        "VarianceOut": VarSpec(var.shape, var.dtype),
        "SavedMean": VarSpec(mean.shape, mean.dtype),
        "SavedVariance": VarSpec(var.shape, var.dtype),
    }


@shape_rule("lookup_table", "lookup_table_v2")
def _lookup_rule(op, ins, attrs):
    ids, w = one(ins, "Ids"), one(ins, "W")
    _require_int_dtype(ids, "Ids", op.type)
    emb = w.shape[-1] if _known(w.shape) and w.shape else None
    shape = ids.shape
    if shape is not None and op.type == "lookup_table" \
            and shape and shape[-1] == 1:
        shape = shape[:-1]      # v1 squeezes the trailing [..., 1]
    return {"Out": VarSpec(None if shape is None else shape + (emb,),
                           w.dtype or "float32")}


def _check_label_batch(x, label, op_name):
    if _known(x.shape) and _known(label.shape) and x.shape and label.shape:
        if not _dim_eq(x.shape[0], label.shape[0]):
            raise ShapeError(
                f"{op_name}: batch dims differ — input "
                f"{tuple(x.shape)} vs label {tuple(label.shape)}")


@shape_rule("cross_entropy", "cross_entropy2")
def _cross_entropy_rule(op, ins, attrs):
    x, label = one(ins, "X"), one(ins, "Label")
    if not attrs.get("soft_label", False):
        _require_int_dtype(label, "Label", op.type)
    _check_label_batch(x, label, op.type)
    if not _known(x.shape):
        return {"Out": OPAQUE, "XShape": OPAQUE, "MatchX": OPAQUE}
    shape = x.shape[:-1] + (1,)
    return {"Out": VarSpec(shape, x.dtype), "XShape": OPAQUE,
            "MatchX": OPAQUE}


@shape_rule("softmax_with_cross_entropy")
def _swce_rule(op, ins, attrs):
    logits, label = one(ins, "Logits"), one(ins, "Label")
    if not attrs.get("soft_label", False):
        _require_int_dtype(label, "Label", op.type)
    _check_label_batch(logits, label, op.type)
    if not _known(logits.shape):
        return {"Softmax": OPAQUE, "Loss": OPAQUE}
    axis = attrs.get("axis", -1) % len(logits.shape)
    loss_shape = tuple(1 if i == axis else d
                       for i, d in enumerate(logits.shape))
    return {"Softmax": VarSpec(logits.shape, logits.dtype),
            "Loss": VarSpec(loss_shape, logits.dtype)}


@shape_rule("square_error_cost")
def _sec_rule(op, ins, attrs):
    x, y = one(ins, "X"), one(ins, "Y")
    shape = broadcast(x.shape, y.shape, -1, op.type) \
        if _known(x.shape) and _known(y.shape) else None
    return {"Out": VarSpec(shape, x.dtype or y.dtype)}


@shape_rule("sigmoid_cross_entropy_with_logits")
def _scel_rule(op, ins, attrs):
    x, label = one(ins, "X"), one(ins, "Label")
    if _known(x.shape) and _known(label.shape) \
            and len(x.shape) == len(label.shape):
        for a, b in zip(x.shape, label.shape):
            if not _dim_eq(a, b):
                raise ShapeError(
                    f"{op.type}: X {tuple(x.shape)} vs Label "
                    f"{tuple(label.shape)}")
    return {"Out": VarSpec(x.shape, x.dtype)}


@shape_rule("center_loss")
def _center_loss_rule(op, ins, attrs):
    x, centers = one(ins, "X"), one(ins, "Centers")
    loss_shape = (x.shape[:-1] + (1,)) if _known(x.shape) else None
    return {"Loss": VarSpec(loss_shape, x.dtype),
            "SampleCenterDiff": VarSpec(x.shape, x.dtype),
            "CentersOut": VarSpec(centers.shape, centers.dtype)}


@shape_rule("accuracy")
def _accuracy_rule(op, ins, attrs):
    out = one(ins, "Out")
    return {"Accuracy": VarSpec((1,), "float32"),
            "Correct": VarSpec((1,), "int32"),
            "Total": VarSpec((1,), "int32")}


@shape_rule("top_k", "top_k_v2")
def _topk_rule(op, ins, attrs):
    x = one(ins, "X")
    k = attrs.get("k", 1)
    if not _known(x.shape):
        return {"Out": OPAQUE, "Indices": OPAQUE}
    shape = x.shape[:-1] + (k if isinstance(k, int) else None,)
    return {"Out": VarSpec(shape, x.dtype),
            "Indices": VarSpec(shape, "int64")}


@shape_rule("arg_max", "arg_min")
def _argminmax_rule(op, ins, attrs):
    x = one(ins, "X")
    if not _known(x.shape):
        return {"Out": OPAQUE}
    axis = attrs.get("axis", -1) % max(len(x.shape), 1)
    keep = attrs.get("keepdims", False)
    if keep:
        shape = tuple(1 if i == axis else d
                      for i, d in enumerate(x.shape))
    else:
        shape = tuple(d for i, d in enumerate(x.shape) if i != axis)
    return {"Out": VarSpec(shape, "int64")}


# ---------------------------------------------------------------------------
# optimizer family — ParamOut mirrors Param; Grad must match Param
# ---------------------------------------------------------------------------

# output slot -> input slot whose spec it mirrors (the aliasing pairs
# the donation-hazard pass also checks at the PROGRAM level)
_OPTIMIZER_MIRRORS = {
    "ParamOut": "Param", "VelocityOut": "Velocity",
    "Moment1Out": "Moment1", "Moment2Out": "Moment2",
    "MomentOut": "Moment", "InfNormOut": "InfNorm",
    "Beta1PowOut": "Beta1Pow", "Beta2PowOut": "Beta2Pow",
    "AvgSquaredGradOut": "AvgSquaredGrad",
    "AvgSquaredUpdateOut": "AvgSquaredUpdate",
    "MeanSquareOut": "MeanSquare", "MeanGradOut": "MeanGrad",
    "SquaredAccumOut": "SquaredAccumulator",
    "LinearAccumOut": "LinearAccumulator",
}

OPTIMIZER_OPS = ("sgd", "momentum", "lars_momentum", "adam", "adamw",
                 "adagrad", "decayed_adagrad", "adadelta", "rmsprop",
                 "adamax", "ftrl", "dpsgd", "lamb", "proximal_gd",
                 "proximal_adagrad", "sgd_sparse", "adagrad_sparse",
                 "dgc_momentum")


def _optimizer_rule(op, ins, attrs):
    p, g = one(ins, "Param"), one(ins, "Grad")
    if _known(p.shape) and _known(g.shape) \
            and len(p.shape) == len(g.shape):
        for a, b in zip(p.shape, g.shape):
            if not _dim_eq(a, b):
                raise ShapeError(
                    f"{op.type}: Grad shape {tuple(g.shape)} does not "
                    f"match Param shape {tuple(p.shape)}")
    out = {}
    for oslot in op.outputs:
        islot = _OPTIMIZER_MIRRORS.get(oslot)
        src = one(ins, islot) if islot else OPAQUE
        out[oslot] = VarSpec(src.shape, src.dtype)
    return out


for _n in OPTIMIZER_OPS:
    shape_rule(_n)(_optimizer_rule)


# ---------------------------------------------------------------------------
# explicitly-opaque families: known statically-uninferable (or not worth
# a rule) — no PT204 warning, the drift test accepts them
# ---------------------------------------------------------------------------

register_opaque(
    # control flow + tensor arrays (sub-block ops get a reduced
    # shape-only pass — verifier pass 3b; def-use across the loop-carry
    # binding is unsound statically, so it is never attempted)
    "cond", "switch", "while_loop", "while_block", "static_rnn",
    "create_array", "array_write", "array_read", "array_length",
    "lod_tensor_to_array", "array_to_lod_tensor", "lod_rank_table",
    "max_sequence_len", "reorder_by_rank", "shrink_memory",
    "tensor_array_to_tensor",
    # data-dependent output shapes (impossible under XLA static shapes)
    "where_index", "masked_select", "unique", "unique_with_counts",
    # sequence/LoD family: row counts ride LoD metadata, not shapes
    "sequence_concat", "sequence_conv", "sequence_enumerate",
    "sequence_erase", "sequence_expand", "sequence_expand_as",
    "sequence_mask", "sequence_pad", "sequence_pool",
    "sequence_reshape", "sequence_reverse", "sequence_scatter",
    "sequence_slice", "sequence_topk_avg_pooling", "sequence_unpad",
    "im2sequence", "filter_by_instag", "edit_distance", "warpctc",
    "linear_chain_crf", "crf_decoding", "chunk_eval", "ctc_align",
    "gru", "lstm", "lstmp", "gru_unit", "lstm_unit", "attention_lstm",
    "fusion_gru", "fusion_lstm", "row_conv", "var_conv_2d",
    "match_matrix_tensor", "tree_conv", "pyramid_hash", "hash",
    # detection / proposal ops (box counts are data-dependent)
    "multiclass_nms", "multiclass_nms2", "locality_aware_nms",
    "generate_proposals", "generate_proposal_labels",
    "generate_mask_labels", "distribute_fpn_proposals",
    "collect_fpn_proposals", "rpn_target_assign",
    "retinanet_target_assign", "retinanet_detection_output",
    "mine_hard_examples", "bipartite_match", "target_assign",
    "detection_map", "yolo_box", "yolov3_loss", "box_coder",
    "box_clip", "box_decoder_and_assign", "density_prior_box",
    "prior_box", "anchor_generator", "iou_similarity",
    "polygon_box_transform", "roi_align", "roi_pool", "prroi_pool",
    "psroi_pool", "roi_perspective_transform",
    "deformable_conv", "deformable_conv_v1",
    "deformable_psroi_pooling",
    # sampling / decode (beam widths, sampled counts)
    "beam_search", "beam_search_decode", "gather_tree",
    "sampling_id", "sample_logits", "random_crop", "shuffle_batch",
    "nce", "hierarchical_sigmoid",
    # distributed / PS plumbing
    "allreduce", "broadcast", "c_allgather", "c_allreduce_max",
    "c_allreduce_min", "c_allreduce_prod", "c_allreduce_sum",
    "c_broadcast", "c_comm_init", "c_reducescatter",
    "c_sync_calc_stream", "c_sync_comm_stream", "merge_ids",
    "split_ids", "shard_index", "merge_selected_rows",
    "get_tensor_from_selected_rows", "lookup_table_dequant",
    "distributed_lookup_table", "get_places",
    # misc side-effect / bookkeeping
    "print", "seed", "increment", "is_empty", "isfinite",
    "isfinite_v2", "isinf_v2", "isnan_v2", "average_accumulates",
    "moving_average_abs_max_scale", "dgc", "dgc_clip_by_norm",
)
