"""Automatic mixed precision (port of paddle_tpu/amp/__init__.py).

The reference's lists, its static-graph rewrite and its loss scaler, on
torch:

- the white, black, gray and unsupported op lists (verbatim) and
  `AutoMixedPrecisionLists`;
- eager autocast: `auto_cast` is the context the dygraph functional ops
  consult (`nn.functional._amp_cast` → `cast_for_op`): white ops cast f32
  inputs down to the compute dtype, black ops cast low-precision inputs
  up to f32;
- the static rewrite: `rewrite_program` / `rewrite_train_program` insert
  `cast` ops in front of white and black ops (`_insert_casts`), so the
  rewritten Program is `to_json` byte-equal to the reference's;
  `decorate` wraps a static optimizer with loss scaling;
- the dynamic loss scaler (`scaler_init` … `scaler_update`) as a dict of
  0-dim tensors updated with `torch.where`, with no host sync, and
  `make_amp_train_step`, whose overflowing step commits nothing.

bf16 (FLAGS_amp_dtype, the default) needs no loss scaling: it has f32's
exponent range.  float16 keeps the reference's scaling machinery.
"""

import torch

from .. import flags
from ..resilience.guard import all_finite

__all__ = ["AutoMixedPrecisionLists", "decorate", "auto_cast",
           "amp_dtype", "CustomOpLists", "autocast_enabled",
           "maybe_cast_to_compute", "cast_for_op", "rewrite_program",
           "rewrite_train_program", "OptimizerWithMixedPrecision",
           "all_finite", "scaler_init", "scale_loss", "unscale_grads",
           "scaler_update", "make_amp_train_step"]

# fp16_lists.py parity (full reference sets + the reference's additions).
# WHITE: matrix-unit ops — always worth running in the compute dtype.
WHITE_LIST = {
    "conv2d", "matmul", "mul", "fc",
    "conv2d_transpose", "depthwise_conv2d", "conv3d", "matmul_v2",
    "fused_multihead_matmul",
}
# BLACK: numerically fragile reductions/transcendentals — keep fp32.
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim",
    "softmax", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "cross_entropy2",
    "reduce_mean", "reduce_sum", "log_softmax", "logsumexp",
    "layer_norm_grad",
}
# GRAY: follow their inputs (reference fp16_lists.py gray_list, full)
GRAY_LIST = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
    "batch_norm", "layer_norm", "tanh", "sigmoid", "lookup_table",
    "top_k", "pool2d", "pool3d", "dropout", "relu", "relu6",
    "leaky_relu", "soft_relu", "flatten2", "stack", "unstack",
    "uniform_random_batch_size_like", "gaussian_random",
    "gaussian_random_batch_size_like", "slice", "rank", "scale",
    "transpose2", "reshape2", "gather", "fill_constant",
    "get_tensor_from_selected_rows", "sign", "cast", "concat", "split",
}
# ops with no meaningful fp16 kernel (reference unsupported_fp16_list):
# control flow, IO/distributed transport, integer comparisons, CRF/RNN
# fusions — never cast, whatever the lists say
UNSUPPORTED_FP16_LIST = {
    "send", "send_barrier", "recv", "fetch_barrier", "create_py_reader",
    "create_double_buffer_reader", "read", "load",
    "increment", "less_than", "less_equal", "greater_than",
    "greater_equal", "equal", "not_equal", "read_from_array",
    "shrink_rnn_memory", "lod_array_length", "logical_and", "logical_or",
    "logical_xor", "logical_not", "print", "conditional_block", "while",
    "ifelse", "is_empty",
    "lstm", "cudnn_lstm", "lstmp", "gru", "gru_unit",
    "linear_chain_crf", "crf_decoding", "bpr_loss",
}


class AutoMixedPrecisionLists:
    """Parity: fp16_lists.py AutoMixedPrecisionLists — custom entries
    move ops between lists with the reference's precedence (a custom
    white op leaves black/gray; overlap between the custom lists is an
    error)."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        self.gray_list = set(GRAY_LIST)
        self.unsupported_list = set(UNSUPPORTED_FP16_LIST)
        self.black_varnames = set(custom_black_varnames or ())
        overlap = set(custom_white_list or ()) & set(
            custom_black_list or ())
        if overlap:
            raise ValueError(
                f"Custom white list overlaps custom black list: "
                f"{sorted(overlap)}")
        for op in custom_white_list or ():
            if op in self.unsupported_list:
                raise ValueError(
                    f"op {op!r} has no fp16 kernel (unsupported list) "
                    f"and cannot be white-listed")
            self.black_list.discard(op)
            self.gray_list.discard(op)
            self.white_list.add(op)
        for op in custom_black_list or ():
            self.white_list.discard(op)
            self.gray_list.discard(op)
            self.black_list.add(op)


CustomOpLists = AutoMixedPrecisionLists


def amp_dtype():
    """The AMP compute dtype (FLAGS_amp_dtype) as a torch dtype."""
    return (torch.bfloat16 if flags.flag("amp_dtype") == "bfloat16"
            else torch.float16)


def _dest_name():
    return ("bfloat16" if flags.flag("amp_dtype") == "bfloat16"
            else "float16")


# -- eager auto_cast context -------------------------------------------------

_autocast_state = {"enabled": False, "lists": None}


class auto_cast:
    """Eager AMP context: nn.functional consults this to run white-list
    ops in the compute dtype with f32 master params.  Nests: leaving an
    inner context restores the outer one's state."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None):
        self._enable = enable
        self._lists = AutoMixedPrecisionLists(custom_white_list,
                                              custom_black_list)

    def __enter__(self):
        self._old = dict(_autocast_state)
        _autocast_state["enabled"] = self._enable
        _autocast_state["lists"] = self._lists
        return self

    def __exit__(self, *exc):
        _autocast_state.update(self._old)
        return False


def autocast_enabled():
    return _autocast_state["enabled"]


def maybe_cast_to_compute(x):
    """Cast one f32 value to the AMP compute dtype when autocast is on."""
    if not _autocast_state["enabled"]:
        return x
    if hasattr(x, "dtype") and x.dtype == torch.float32:
        return x.to(amp_dtype())
    return x


def cast_for_op(op_type, *xs):
    """List-aware autocast dispatch, called by the eager functional ops:
    white ops cast f32 inputs down to the compute dtype, black ops cast
    low-precision inputs UP to f32, gray/unsupported pass through.
    Honors auto_cast(custom_white_list=..., custom_black_list=...)."""
    st = _autocast_state
    if not st["enabled"]:
        return xs if len(xs) > 1 else xs[0]
    lists = st["lists"] or AutoMixedPrecisionLists()
    lo = amp_dtype()

    def down(x):
        if hasattr(x, "dtype") and x.dtype == torch.float32:
            return x.to(lo)
        return x

    def up(x):
        if hasattr(x, "dtype") and x.dtype in (torch.float16,
                                               torch.bfloat16):
            return x.to(torch.float32)
        return x

    if op_type in lists.unsupported_list:
        out = xs                       # never cast, whatever the lists say
    elif op_type in lists.white_list:
        out = tuple(down(x) for x in xs)
    elif op_type in lists.black_list:
        out = tuple(up(x) for x in xs)
    else:
        out = xs
    return out if len(out) > 1 else out[0]


# -- static-graph rewrite (fp16_utils.py:51 rewrite_program parity) ----------

def _fusion_tier_applied(program):
    """True when the fusion tier already ran over this program (marker
    set by passes.fuse_program, or fusion-tier op types present — a
    clone keeps the ops but not necessarily the marker)."""
    from ..passes.fuse import FUSED_TIER_TYPES

    if getattr(program, "_fusion_applied", False):
        return True
    return any(op.type in FUSED_TIER_TYPES
               for b in program.blocks for op in b.ops)


def _check_canonical_order(program):
    """The canonical optimization order is AMP rewrite → fusion tier: the
    fusion matcher sees THROUGH AMP's casts, but AMP's list-driven
    rewrite knows nothing about fused op types — casting around them
    would split patterns the kernels already own."""
    if _fusion_tier_applied(program):
        raise ValueError(
            "canonical order violated: this program already carries "
            "fusion-tier ops (FLAGS_graph_opt_fuse), but AMP must be "
            "rewritten FIRST (AMP rewrite -> fusion -> structural "
            "passes).  Leave FLAGS_amp=train/on so the executor "
            "applies both in order, or call amp.rewrite_program / "
            "amp.rewrite_train_program before passes.fuse_program.")


def _insert_casts(program, lists, dest):
    """Shared cast-insertion core: rewire white/black-list ops' float
    inputs through cast ops, keeping the ORIGINAL op objects (their
    callsite/folded_from provenance must survive — the fusion matcher
    reads it).  Handles programs WITH backward sections by remapping each
    section's `pos` past the inserted casts and resetting the cast memo
    at every section boundary (each segment runs under its own autograd
    call, so a cast produced in one segment must not be referenced from
    another)."""
    from ..framework.program import Block, Operator

    block = program.global_block()
    ops = block.ops
    boundaries = {bs.pos for bs in program.backward_sections}
    new_ops = []
    pos_map = {}
    casted = {}       # (var, dtype) -> cast-output name
    n = [0]

    def cast_in(name, to):
        # NO declared-dtype short-circuit: intermediate vars are
        # declared float32 while their run-time tensors may be bf16
        # (white-op outputs flow through gray ops untouched), so the
        # only sound pin is an explicit cast op
        key = (name, to)
        if key not in casted:
            n[0] += 1
            out = f"{name}.cast_{to}_{n[0]}"
            block.create_var(name=out, dtype=to)
            # _amp_inserted marks this as a required static pin, not
            # churn; underscore attrs stay out of the canonical form and
            # the op ignores them
            cast_op = Operator(block, "cast", {"X": [name]},
                               {"Out": [out]},
                               {"in_dtype": None, "out_dtype": to,
                                "_amp_inserted": True})
            new_ops.append(cast_op)
            casted[key] = out
        return casted[key]

    for i, op in enumerate(ops):
        pos_map[i] = len(new_ops)
        if i in boundaries:
            casted.clear()
        if op.type in lists.unsupported_list or any(
                isinstance(v, Block) for v in op.attrs.values()):
            new_ops.append(op)         # never cast these
            continue
        if op.type in lists.white_list:
            to = dest
        elif op.type in lists.black_list:
            to = "float32"
        else:
            new_ops.append(op)
            continue
        ins = {}
        for slot, names in op.inputs.items():
            out_names = []
            for vn in names:
                v = block._find_var_recursive(vn)
                is_float = v is not None and str(
                    getattr(v, "dtype", "")).endswith(
                        ("float32", "float16", "bfloat16"))
                if is_float and vn not in lists.black_varnames:
                    out_names.append(cast_in(vn, to))
                else:
                    out_names.append(vn)
            ins[slot] = out_names
        op.inputs = ins
        new_ops.append(op)
        # downstream consumers see the op's declared output dtype; the
        # executor propagates actual tensor dtypes, so no output cast is
        # needed until a black op pins f32 again
    pos_map[len(ops)] = len(new_ops)
    block.ops = new_ops
    for bs in program.backward_sections:
        bs.pos = pos_map[min(bs.pos, len(ops))]
    program.amp_enabled = True
    # provenance: which low-precision dtype this rewrite targeted
    program._amp_dest = dest
    program._bump()
    return program


def rewrite_program(program, amp_lists=None, dest_dtype=None):
    """Insert cast ops so white-list ops compute in the AMP dtype and
    black-list ops stay f32 (the reference's rewrite_program,
    fp16_utils.py:51/156, on this Program IR).  Parameters feeding white
    ops are cast at use (f32 master weights stay in scope).  Apply BEFORE
    minimize()/append_backward; for an already-minimized program use
    :func:`rewrite_train_program`.  Idempotent: a program whose
    ``amp_enabled`` flag is already set passes through."""
    if program.amp_enabled:
        return program
    _check_canonical_order(program)
    if program.backward_sections:
        raise ValueError(
            "apply amp.rewrite_program before minimize()/"
            "append_backward (or use amp.rewrite_train_program — the "
            "FLAGS_amp executor path — which remaps the backward "
            "sections past the inserted casts)")
    lists = amp_lists or AutoMixedPrecisionLists()
    return _insert_casts(program, lists, dest_dtype or _dest_name())


def rewrite_train_program(program, amp_lists=None, dest_dtype=None):
    """AMP-rewrite a program that ALREADY has backward sections (built
    through minimize()/append_backward) — the executor's FLAGS_amp path.
    The casts are inserted exactly like :func:`rewrite_program`; each
    BackwardSection's position is remapped past them, so autograd
    differentiates through the casts (f32 master params, low-precision
    compute, f32 grads).  Idempotent, and refuses fused programs like
    the public rewrite (canonical order: AMP → fusion)."""
    if program.amp_enabled:
        return program
    _check_canonical_order(program)
    lists = amp_lists or AutoMixedPrecisionLists()
    return _insert_casts(program, lists, dest_dtype or _dest_name())


# -- static-graph decorate ---------------------------------------------------

class OptimizerWithMixedPrecision:
    """Parity: decorator.py:27 — wraps a static-graph optimizer: scaled
    loss backward and f32 master updates.  With bf16 (the default) the
    loss scaling is the identity (init_loss_scaling=1) and no scale ops
    are added."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=2.0**15,
                 use_dynamic_loss_scaling=True, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._loss_scaling = (1.0 if flags.flag("amp_dtype") == "bfloat16"
                              else init_loss_scaling)
        self._use_dynamic = (use_dynamic_loss_scaling and
                             flags.flag("amp_dtype") != "bfloat16")

    def backward(self, loss, **kw):
        from ..layers import tensor as T

        loss.block.program.amp_enabled = True
        scaled = T.scale(loss, scale=self._loss_scaling) \
            if self._loss_scaling != 1.0 else loss
        params_grads = self._optimizer.backward(scaled, **kw)
        if self._loss_scaling != 1.0:
            inv = 1.0 / self._loss_scaling
            params_grads = [(p, T.scale(g, scale=inv))
                            for p, g in params_grads]
        return params_grads

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, **kw):
        params_grads = self.backward(loss)
        opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0**15,
             use_dynamic_loss_scaling=True, **kw):
    """Parity: mixed_precision/decorator.py:218."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        **kw)


# -- dynamic loss scaling ----------------------------------------------------
#
# Parity: contrib/mixed_precision/fp16_utils.py:283 update_loss_scaling op.
# The state is a dict of 0-dim tensors on one device; the skip-update
# branch is a torch.where select, not a host round trip.

def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def scaler_init(init_scale=2.0 ** 15, incr_every_n_steps=1000,
                decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5,
                device=None):
    """The scaler state on `device` (None: cuda, as every entry point)."""
    from ..core.place import resolve_device

    dev = resolve_device(device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return {
        "scale": f32(init_scale),
        "good_steps": i32(0),
        "bad_steps": i32(0),
        "incr_every": i32(incr_every_n_steps),
        "decr_every": i32(decr_every_n_nan_or_inf),
        "incr_ratio": f32(incr_ratio),
        "decr_ratio": f32(decr_ratio),
    }


def scale_loss(scaler, loss):
    return loss * scaler["scale"].to(loss.dtype)


def unscale_grads(scaler, grads):
    inv = 1.0 / scaler["scale"]
    return _tree_map(lambda g: None if g is None else g.float() * inv,
                     grads)


def scaler_update(scaler, grads_finite):
    """Advance the scale per the reference's counters: grow the scale
    after incr_every consecutive finite steps; shrink it (floor 1.0)
    after decr_every overflowing steps.  Both branches are computed and
    `grads_finite` (a 0-dim bool tensor) selects."""
    s = scaler
    zero = torch.zeros_like(s["good_steps"])
    finite = torch.as_tensor(grads_finite, device=s["scale"].device)
    good = s["good_steps"] + 1
    grow = good >= s["incr_every"]
    bad = s["bad_steps"] + 1
    shrink = bad >= s["decr_every"]
    scale_good = torch.where(grow, s["scale"] * s["incr_ratio"], s["scale"])
    scale_bad = torch.where(
        shrink, torch.clamp(s["scale"] * s["decr_ratio"], min=1.0),
        s["scale"])
    return {**s,
            "scale": torch.where(finite, scale_good, scale_bad),
            "good_steps": torch.where(
                finite, torch.where(grow, zero, good), zero),
            "bad_steps": torch.where(
                finite, zero, torch.where(shrink, zero, bad))}


def make_amp_train_step(model, optimizer, loss_fn=None, donate=True,
                        **scaler_kw):
    """Train step with dynamic loss scaling and skip-on-overflow.

    Returns (step, make_state): state = (TrainState, scaler_state);
    step(state, *batch) -> (state, loss, grads_finite).  An overflowing
    step leaves params, optimizer state and buffers as they were and
    shrinks the scale (OptimizerWithMixedPrecision semantics for eager
    training); its TrainState.step still advances, as the reference's.
    The commit is a `torch.where` select per tensor: no host sync.

    The port runs eagerly: the reference's `jit` is not taken.
    donate=True writes the committed values into the state's
    own tensors and returns the same TrainState.  The scaler lives on
    the params' device.  Wrap `loss_fn` in `auto_cast` for low-precision
    compute; the step alone only scales the loss.
    """
    from ..models.train import (TrainState, _loss_with_buffers,
                                init_train_state)

    if loss_fn is None:
        loss_fn = lambda m, *b: m.loss(*b)
    model.train()

    def make_state(rng_seed=0):
        ts = init_train_state(model, optimizer, rng_seed=rng_seed)
        return ts, scaler_init(device=ts.step.device, **scaler_kw)

    def step(state, *batch):
        ts, sc = state
        rng = ts.rng
        if not donate:
            rng = torch.Generator(device=rng.device)
            rng.set_state(ts.rng.get_state())
        names = list(ts.params)
        with torch.enable_grad():
            leaves = [ts.params[k].detach().requires_grad_() for k in names]
            loss, new_buffers = _loss_with_buffers(
                model, dict(zip(names, leaves)), ts.buffers, rng, loss_fn,
                batch)
            grads = torch.autograd.grad(scale_loss(sc, loss), leaves,
                                        allow_unused=True)
        loss = loss.detach()
        grads = unscale_grads(sc, {k: g for k, g in zip(names, grads)
                                   if g is not None})
        finite = all_finite(grads)
        sc = scaler_update(sc, finite)
        params, opt_state = optimizer.update(ts.params, grads, ts.opt_state,
                                             inplace=False)

        def keep(new, old):
            # an overflow step commits NOTHING: buffers from the
            # overflowed forward (batch-norm running stats) may carry
            # NaN/Inf too
            return torch.where(finite, new, old)

        with torch.no_grad():
            params = _tree_map(keep, params, ts.params)
            opt_state = _tree_map(keep, opt_state, ts.opt_state)
            buffers = _tree_map(keep, new_buffers, ts.buffers)
            if donate:
                for new, old in ((params, ts.params),
                                 (opt_state, ts.opt_state),
                                 (buffers, ts.buffers)):
                    _tree_map(lambda n, o: o.copy_(n), new, old)
                ts.step.add_(1)
                return (ts, sc), loss, finite
        new_ts = TrainState(params=params, opt_state=opt_state,
                            buffers=buffers, step=ts.step + 1, rng=rng)
        return (new_ts, sc), loss, finite

    return step, make_state
