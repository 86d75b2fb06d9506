"""Static-graph control flow: cond / while_loop / StaticRNN / Switch (port
of paddle_tpu/layers/control_flow.py).

Parity surface: the reference's control-flow ops
(paddle/fluid/operators/controlflow/conditional_block_op.cc, while_op.cc
and python/paddle/fluid/layers/control_flow.py: While:1032, cond,
Switch:2669, StaticRNN:420, increment:1308, array ops:1383-1566).

Design: sub-blocks are recorded into child Blocks and one control-flow op
names them, with the same op records as the reference (`to_json` equal).
The port's Executor runs such an op eagerly (framework/executor.py
`_run_cond` / `_run_while` / `_run_static_rnn` ...): it reads the
predicate on the host once per branch, case or loop trip (one device
sync each, as Fluid's while_op reads its condition on the CPU) and
interprets the chosen sub-block against a copy of the outer env.
"""

import numpy as np

from ..framework import program as prog_mod
from ..framework.layer_helper import LayerHelper

__all__ = ["cond", "while_loop", "StaticRNN", "Switch", "increment",
           "case", "switch_case", "While", "IfElse", "DynamicRNN", "Print",
           "less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal", "logical_and", "logical_or",
    "logical_not", "array_write", "array_read", "array_length",
    "create_array", "lod_rank_table", "max_sequence_len",
    "lod_tensor_to_array", "array_to_lod_tensor", "shrink_memory"]


def _helper(name):
    return LayerHelper(name)


def _compare(op_type, x, y):
    h = _helper(op_type)
    out = h.create_variable_for_type_inference(dtype="bool")
    h.append_op(op_type, inputs={"X": x, "Y": y}, outputs={"Out": out})
    return out


def less_than(x, y):
    return _compare("less_than", x, y)


def less_equal(x, y):
    return _compare("less_equal", x, y)


def greater_than(x, y):
    return _compare("greater_than", x, y)


def greater_equal(x, y):
    return _compare("greater_equal", x, y)


def equal(x, y):
    return _compare("equal", x, y)


def not_equal(x, y):
    return _compare("not_equal", x, y)


def logical_and(x, y):
    return _compare("logical_and", x, y)


def logical_or(x, y):
    return _compare("logical_or", x, y)


def logical_not(x):
    h = _helper("logical_not")
    out = h.create_variable_for_type_inference(dtype="bool")
    h.append_op("logical_not", inputs={"X": x}, outputs={"Out": out})
    return out


from .tensor import increment  # noqa: F401 — single implementation


def _captured_names(blocks, exclude=()):
    """Outer variable names a sub-block reads (inputs not produced inside
    the block and not bound loop/step vars). Recorded as an explicit
    "Captured" input slot on the control-flow op so the executor's
    dead-op pruning keeps their producers."""
    exclude = set(exclude)
    captured, produced = [], set()
    for block in blocks:
        for op in block.ops:
            for n in op.input_names():
                if (n not in produced and n not in exclude
                        and n not in captured):
                    captured.append(n)
            produced |= set(op.output_names())
    return captured


def _record_sub_block(program, build_fn, inner_vars):
    """Run build_fn with append_op redirected into a fresh child block.
    Returns (block, result_of_build_fn)."""
    block = program.create_block()
    try:
        result = build_fn(*inner_vars)
    finally:
        program.rollback()
    return block, result


def _clone_var_in(block, v, name=None):
    return block.create_var(name=name, shape=v.shape, dtype=v.dtype)


def cond(pred, true_fn, false_fn, name=None):
    """Conditional (parity: layers.cond / the
    conditional_block op pair). true_fn/false_fn take no args and return
    a Variable or (nested) list of Variables with matching shapes."""
    program = pred.block.program
    tb, t_out = _record_sub_block(program, lambda: true_fn(), ())
    fb, f_out = _record_sub_block(program, lambda: false_fn(), ())

    t_list = t_out if isinstance(t_out, (list, tuple)) else [t_out]
    f_list = f_out if isinstance(f_out, (list, tuple)) else [f_out]
    if len(t_list) != len(f_list):
        raise ValueError("cond branches must return the same arity")

    h = _helper("cond")
    outs = [h.create_variable_for_type_inference(v.dtype) for v in t_list]
    for o, v in zip(outs, t_list):
        o.shape = v.shape
    h.append_op(
        "cond",
        inputs={"Pred": pred,
                "Captured": _captured_names([tb, fb])},
        outputs={"Out": outs},
        attrs={
            "true_block": tb.idx,
            "false_block": fb.idx,
            "true_outs": [v.name for v in t_list],
            "false_outs": [v.name for v in f_list],
        })
    return outs[0] if not isinstance(t_out, (list, tuple)) else outs


def while_loop(cond_fn, body_fn, loop_vars, maximum_trip_count=None,
               name=None):
    """While loop (parity: layers.while_loop / while_op.cc).

    cond_fn(*vars) -> bool scalar Variable; body_fn(*vars) -> updated
    vars (same arity/shapes).

    maximum_trip_count: a bound on the trips, REQUIRED if gradients must
    flow through the loop (the reference lowers a bounded loop onto a
    scan it can differentiate; the port runs at most that many trips and
    stops at the first false predicate, and a backward through an
    unbounded loop raises, as in the reference).
    """
    loop_vars = list(loop_vars)
    program = loop_vars[0].block.program

    cb = program.create_block()
    try:
        c_inner = [_clone_var_in(cb, v) for v in loop_vars]
        c_out = cond_fn(*c_inner)
    finally:
        program.rollback()

    bb = program.create_block()
    try:
        b_inner = [_clone_var_in(bb, v) for v in loop_vars]
        b_out = body_fn(*b_inner)
    finally:
        program.rollback()
    b_out = b_out if isinstance(b_out, (list, tuple)) else [b_out]
    if len(b_out) != len(loop_vars):
        raise ValueError("body must return one value per loop var")

    h = _helper("while_loop")
    outs = [h.create_variable_for_type_inference(v.dtype)
            for v in loop_vars]
    for o, v in zip(outs, loop_vars):
        o.shape = v.shape
    captured = _captured_names(
        [cb, bb], exclude=[v.name for v in c_inner + b_inner])
    h.append_op(
        "while_loop",
        inputs={"LoopVars": loop_vars, "Captured": captured},
        outputs={"Out": outs},
        attrs={
            "max_iters": (int(maximum_trip_count)
                          if maximum_trip_count else None),
            "cond_block": cb.idx,
            "body_block": bb.idx,
            "cond_inner": [v.name for v in c_inner],
            "body_inner": [v.name for v in b_inner],
            "cond_out": c_out.name,
            "body_outs": [v.name for v in b_out],
        })
    return outs


class Switch:
    """Parity: control_flow.py:2669 — chained case()/default() blocks.

    Used as a context manager; on exit it emits one "switch" op that the
    executor runs as a case chain (first true case
    wins, else default, else the written variables keep their prior
    values). Case bodies communicate by writing outer variables (the
    reference pattern: layers.assign into a persistable var, e.g. the
    learning-rate schedule in learning_rate_scheduler.py).
    """

    def __init__(self, name=None):
        self._cases = []          # (pred, block)
        self._default = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is not None:
            return False
        self._lower()
        return False

    class _CaseCtx:
        def __init__(self, switch, pred):
            self.switch = switch
            self.pred = pred

        def __enter__(self):
            sw = self.switch
            sw._program = prog_mod.default_main_program()
            sw._block = sw._program.create_block()
            return self

        def __exit__(self, *exc):
            self.switch._program.rollback()
            entry = (self.pred, self.switch._block)
            if self.pred is None:
                self.switch._default = entry
            else:
                self.switch._cases.append(entry)
            return False

    def case(self, pred):
        return Switch._CaseCtx(self, pred)

    def default(self):
        return Switch._CaseCtx(self, None)

    def _lower(self):
        blocks = [b for _, b in self._cases]
        if self._default is not None:
            blocks.append(self._default[1])
        if not blocks:
            return
        # outer variables any case writes = the switch outputs
        out_names = []
        for b in blocks:
            for op in b.ops:
                for n in op.output_names():
                    if n not in b.vars and n not in out_names:
                        out_names.append(n)
        if not out_names:
            return
        h = _helper("switch")
        h.append_op(
            "switch",
            inputs={
                "Preds": [p for p, _ in self._cases],
                "Captured": _captured_names(
                    blocks, exclude=out_names),
            },
            # outputs keep the SAME outer names: the switch result
            # becomes the new value of each written variable
            outputs={"Out": out_names},
            attrs={
                "case_preds": [p.name for p, _ in self._cases],
                "case_blocks": [b.idx for _, b in self._cases],
                "default_block": (self._default[1].idx
                                  if self._default else None),
                "out_names": out_names,
            })


class StaticRNN:
    """RNN over a static sequence axis (one body run per step).

    Parity: control_flow.py:420 StaticRNN (step_input / memory /
    update_memory / step_output), with the time axis first:
    step_input expects [T, ...] and the result of rnn() is [T, ...].
    """

    def __init__(self, name=None):
        self._program = None
        self._block = None
        self._step_inputs = []    # (outer, inner)
        self._memories = []       # [outer_init, inner, updated_name]
        self._outputs = []        # inner step outputs
        self._built = False

    class _StepCtx:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            r = self.rnn
            r._program = prog_mod.default_main_program()
            r._block = r._program.create_block()
            return self

        def __exit__(self, *exc):
            self.rnn._program.rollback()
            if exc[0] is None:
                self.rnn._finalize()
            return False

    def step(self):
        return StaticRNN._StepCtx(self)

    def _in_step(self):
        if self._block is None:
            raise RuntimeError("call inside `with rnn.step():`")

    def step_input(self, x):
        self._in_step()
        inner = self._block.create_var(shape=(None,) + tuple(x.shape[1:]),
                                       dtype=x.dtype)
        inner.shape = tuple(x.shape[1:])
        self._step_inputs.append((x, inner))
        return inner

    def memory(self, init):
        self._in_step()
        inner = self._block.create_var(shape=init.shape, dtype=init.dtype)
        self._memories.append([init, inner, None])
        return inner

    def update_memory(self, mem, new_val):
        self._in_step()
        for m in self._memories:
            if m[1] is mem:
                m[2] = new_val.name
                return
        raise ValueError("update_memory: unknown memory variable")

    def step_output(self, o):
        self._in_step()
        self._outputs.append(o)

    def output(self, *outs):
        for o in outs:
            self.step_output(o)

    def _finalize(self):
        for m in self._memories:
            if m[2] is None:
                raise RuntimeError("memory was never update_memory'd")
        if not self._outputs:
            raise RuntimeError("StaticRNN needs at least one step_output")
        self._built = True

    def __call__(self):
        if not self._built:
            raise RuntimeError("StaticRNN used before its step block closed")
        h = _helper("static_rnn")
        outs = [h.create_variable_for_type_inference(o.dtype)
                for o in self._outputs]
        exclude = ([i.name for _, i in self._step_inputs]
                   + [m[1].name for m in self._memories])
        h.append_op(
            "static_rnn",
            inputs={
                "StepInputs": [x for x, _ in self._step_inputs],
                "InitMemories": [m[0] for m in self._memories],
                "Captured": _captured_names([self._block], exclude=exclude),
            },
            outputs={"Out": outs},
            attrs={
                "block": self._block.idx,
                "input_inner": [i.name for _, i in self._step_inputs],
                "memory_inner": [m[1].name for m in self._memories],
                "memory_update": [m[2] for m in self._memories],
                "step_outs": [o.name for o in self._outputs],
            })
        return outs[0] if len(outs) == 1 else outs


# -- TensorArray (LoDTensorArray parity, Python-list semantics) -----------

def create_array(dtype="float32"):
    """Parity: control_flow.py:1383 create_array. Arrays live in the env
    as Python lists of tensors; each index is read on the host."""
    h = _helper("array")
    out = h.create_variable_for_type_inference(dtype=dtype)
    out.is_tensor_array = True
    h.append_op("create_array", inputs={}, outputs={"Out": out}, attrs={})
    return out


def array_write(x, i, array):
    h = _helper("array_write")
    h.append_op("array_write", inputs={"X": x, "I": i, "Array": array},
                outputs={"Out": array}, attrs={})
    return array


def array_read(array, i):
    h = _helper("array_read")
    out = h.create_variable_for_type_inference(array.dtype)
    h.append_op("array_read", inputs={"Array": array, "I": i},
                outputs={"Out": out}, attrs={})
    return out


def array_length(array):
    h = _helper("array_length")
    out = h.create_variable_for_type_inference("int64")
    h.append_op("array_length", inputs={"Array": array},
                outputs={"Out": out}, attrs={})
    return out


def lod_rank_table(x, level=0, lengths=None):
    """Parity: control_flow.py:1046 — sort sequences by length (desc,
    stable) for length-bucketed dynamic-RNN batching.  The reference
    reads lengths from x's LoD level; the padded+lengths contract passes
    them explicitly (`lengths` [B] — required; `level` is accepted for
    signature parity but the nested hierarchy is already flattened to
    the lengths vector by lod.create_lod_tensor)."""
    if lengths is None:
        raise ValueError(
            "lod_rank_table needs the lengths vector (padded+lengths "
            "contract; see paddle_tpu.lod.create_lod_tensor)")
    h = _helper("lod_rank_table")
    out = h.create_variable_for_type_inference("int64")
    h.append_op("lod_rank_table", inputs={"X": lengths},
                outputs={"Out": out}, attrs={"level": level})
    out.is_rank_table = True
    return out


def max_sequence_len(rank_table):
    """Parity: control_flow.py:1125 — the longest length in the table."""
    h = _helper("max_sequence_len")
    out = h.create_variable_for_type_inference("int64")
    h.append_op("max_sequence_len", inputs={"RankTable": rank_table},
                outputs={"Out": out}, attrs={})
    return out


def lod_tensor_to_array(x, table):
    """Parity: control_flow.py:1132 — split padded [B, T, ...] into a
    tensor array of per-timestep slices covering only the sequences
    still active at each step, in rank-table order.  Row counts are
    value-dependent: the port's eager executor runs it as it is (the
    reference only under FLAGS_eager_executor)."""
    h = _helper("lod_tensor_to_array")
    out = h.create_variable_for_type_inference(x.dtype)
    out.is_tensor_array = True
    h.append_op("lod_tensor_to_array", inputs={"X": x, "RankTable": table},
                outputs={"Out": out}, attrs={})
    return out


def array_to_lod_tensor(x, table):
    """Parity: control_flow.py:1174 — inverse of lod_tensor_to_array:
    reassemble the padded batch in the original row order."""
    h = _helper("array_to_lod_tensor")
    out = h.create_variable_for_type_inference(x.dtype)
    h.append_op("array_to_lod_tensor", inputs={"X": x, "RankTable": table},
                outputs={"Out": out}, attrs={})
    return out


def shrink_memory(x, i, table):
    """Parity: control_flow.py:1660 — drop the memory rows of sequences
    that already finished at step i (rows in rank-table order, so the
    active ones are a prefix)."""
    h = _helper("shrink_memory")
    out = h.create_variable_for_type_inference(x.dtype)
    h.append_op("shrink_memory",
                inputs={"X": x, "I": i, "RankTable": table},
                outputs={"Out": out}, attrs={})
    return out


def case(pred_fn_pairs, default=None, name=None):
    """control_flow.py case (:3036) — first true predicate wins; lowers
    to a chain of cond ops."""
    pairs = list(pred_fn_pairs)
    if not pairs:
        raise ValueError("case needs at least one (pred, fn) pair")

    def build(i):
        pred, fn = pairs[i]
        if i == len(pairs) - 1 and default is None:
            # reference: last fn is the fallback when nothing matched
            return cond(pred, fn, fn, name=name)
        fallback = (default if i == len(pairs) - 1
                    else (lambda: build(i + 1)))
        return cond(pred, fn, fallback, name=name)

    return build(0)


def switch_case(branch_index, branch_fns, default=None, name=None):
    """control_flow.py switch_case (:3132) — integer dispatch over
    branch functions; lowers to the Switch chain."""
    if isinstance(branch_fns, dict):
        items = sorted(branch_fns.items())
    else:
        items = list(enumerate(branch_fns))
    from .tensor import fill_constant

    pairs = []
    for idx, fn in items:
        pred = equal(branch_index,
                     fill_constant([1], branch_index.dtype, idx))
        pairs.append((pred, fn))
    if default is None:
        default = items[-1][1]
    return case(pairs, default=default, name=name)


class While:
    """Block-style while (control_flow.py:1038 While) over the
    while_loop machinery: the block body writes updated loop variables
    in place via layers.assign, matching reference usage:

        i = fluid.layers.fill_constant([1], 'int64', 0)
        loop = fluid.layers.While(cond)
        with loop.block():
            ... assign(new_i, i); assign(new_cond, cond)
    """

    def __init__(self, cond, is_test=False, name=None, max_iters=None):
        """max_iters: optional bound — when set, the loop lowers to a
        bound on the trips, REQUIRED for gradients through the loop (a
        backward through an unbounded loop raises, as in the
        reference)."""
        self._cond = cond
        self._name = name
        self._max_iters = max_iters
        self._program = cond.block.program

    def block(self):
        import contextlib

        program = self._program
        outer_block = program.current_block()

        @contextlib.contextmanager
        def guard():
            blk = program.create_block()
            try:
                yield
            finally:
                program.rollback()
            # outer variables the body assigns form the loop state; they
            # are declared as op outputs so liveness analysis keeps the
            # loop when any of them is fetched
            written = []
            for o in blk.ops:
                for n in o.output_names():
                    if (n not in written
                            and outer_block._find_var_recursive(n)
                            is not None):
                        written.append(n)
            h = _helper("while")
            h.append_op(
                "while_block",
                inputs={"Cond": self._cond,
                        "Captured": _captured_names([blk])},
                outputs={"Out": written},
                attrs={"body_block": blk.idx,
                       "cond_name": self._cond.name,
                       "max_iters": (int(self._max_iters)
                                     if self._max_iters else None)})

        return guard()


class IfElse:
    """Block-style conditional (control_flow.py:1525 IfElse): record
    true/false branch blocks, merge outputs positionally.

        ie = fluid.layers.IfElse(cond_bool)
        with ie.true_block():
            ie.output(x1)
        with ie.false_block():
            ie.output(x2)
        out, = ie()
    """

    def __init__(self, cond, name=None):
        self._cond = cond
        self._program = cond.block.program
        self._true = None          # (block, [outputs])
        self._false = None
        self._current = None

    def _branch(self, which):
        import contextlib

        program = self._program

        @contextlib.contextmanager
        def guard():
            blk = program.create_block()
            outs = []
            self._current = outs
            try:
                yield
            finally:
                program.rollback()
                self._current = None
            if which == "true":
                self._true = (blk, outs)
            else:
                self._false = (blk, outs)

        return guard()

    def true_block(self):
        return self._branch("true")

    def false_block(self):
        return self._branch("false")

    def output(self, *outs):
        if self._current is None:
            raise RuntimeError("IfElse.output() outside a branch block")
        self._current.extend(outs)

    def input(self, x):
        """The reference slices inputs by condition; here, as in the
        JAX package, both branches see the full tensor."""
        return x

    def __call__(self):
        if self._true is None or self._false is None:
            raise RuntimeError("IfElse needs both true and false blocks")
        tb, t_outs = self._true
        fb, f_outs = self._false
        if len(t_outs) != len(f_outs):
            raise ValueError("IfElse branches must output the same arity")
        h = _helper("ifelse")
        outs = [h.create_variable_for_type_inference(v.dtype)
                for v in t_outs]
        for o, v in zip(outs, t_outs):
            o.shape = v.shape
        h.append_op(
            "cond",
            inputs={"Pred": self._cond,
                    "Captured": _captured_names([tb, fb])},
            outputs={"Out": outs},
            attrs={"true_block": tb.idx, "false_block": fb.idx,
                   "true_outs": [v.name for v in t_outs],
                   "false_outs": [v.name for v in f_outs]})
        return outs


class DynamicRNN(StaticRNN):
    """control_flow.py:1717 DynamicRNN — in the padded+lengths contract
    ragged per-step slicing collapses into StaticRNN over the padded
    time axis; consumers mask by lengths (the repo-wide sequence
    design, layers/sequence_ops.py:1-11).

    API adapters for reference usage: `block()` is the step context
    (`with drnn.block():`), `step_input` accepts batch-major [B, T, ...]
    (transposed to StaticRNN's time-major contract), and `memory`
    supports the (shape=..., value=...) form."""

    def block(self):
        return self.step()

    import contextlib as _contextlib

    @_contextlib.contextmanager
    def _outer_block(self):
        """Build ops in the OUTER block while inside the step block
        (step_input transposes and memory inits are outer-scope ops)."""
        prog = self._program
        saved = prog.current_block_idx
        prog.current_block_idx = self._block.parent_idx
        try:
            yield
        finally:
            prog.current_block_idx = saved

    def step_input(self, x, level=0):
        from .tensor import transpose

        with self._outer_block():
            tm = transpose(x, [1, 0] + list(range(2, len(x.shape))))
        return super().step_input(tm)

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        if init is None:
            if shape is None:
                raise ValueError("memory() needs init or shape")
            if not self._step_inputs:
                raise RuntimeError(
                    "memory(shape=...) must follow step_input (the batch "
                    "dim comes from it)")
            from .tensor import fill_constant_batch_size_like

            outer_x = self._step_inputs[0][0]    # time-major [T, B, ...]
            with self._outer_block():
                init = fill_constant_batch_size_like(
                    outer_x, [-1] + list(shape), dtype, value,
                    input_dim_idx=1)
        return super().memory(init)

    def __call__(self):
        """Reference drnn() yields batch-major outputs; StaticRNN's are
        time-major — transpose back."""
        from .tensor import transpose

        outs = super().__call__()
        outs_list = outs if isinstance(outs, (list, tuple)) else [outs]
        # outer result rank = per-step rank + time axis (outer shapes are
        # inferred lazily, so derive the permutation from the step vars)
        bm = []
        for o, inner in zip(outs_list, self._outputs):
            rank = len(inner.shape) + 1
            bm.append(transpose(o, [1, 0] + list(range(2, rank))))
        return bm[0] if len(bm) == 1 else bm


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """control_flow.py Print (:281) — runtime tensor peek via the print
    op (a host print of the value)."""
    from .tensor import _single_out

    return _single_out("print", {"In": input},
                       {"message": message or "", "first_n": first_n,
                        "summarize": summarize}, same_shape=True)


# --- reference fluid/layers/control_flow.py __all__ parity -----------------------
# These names are implemented in sibling modules of the reference's layers
# package; a PEP 562 module __getattr__ resolves them through the
# aggregate namespace so 1.x submodule imports (`from
# paddle.fluid.layers.control_flow import reorder_lod_tensor_by_rank`)
# work without circular imports.  A name the port's namespace lacks
# raises naming its ROADMAP item.
_REF_PARITY_NAMES = ['is_empty', 'reorder_lod_tensor_by_rank']


def __getattr__(name):
    if name in _REF_PARITY_NAMES:
        from .. import layers as _agg

        return getattr(_agg, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_REF_PARITY_NAMES))
