"""Executor + Scope (port of the core of paddle_tpu/framework/executor.py).

Paddle-Fluid's Executor (fluid/executor.py:437; the C++ hot loop
framework/executor.cc:449) runs a Program's ops in order against a
Scope of persistable variables.  The JAX package traces the op list
into one jitted step; the port interprets it op by op with eager
PyTorch on the executor's device:

- each BackwardSection (framework/backward.py) runs its forward segment
  with the section's params as fresh leaf tensors that require grad,
  takes `torch.autograd.grad` of the summed loss with respect to them
  (zeros for a param the loss does not reach, as `jax.value_and_grad`
  gives), and binds `<name>@GRAD`;
- a section with checkpoints (`RecomputeOptimizer`) splits its segment
  at the ops that produce them (`_checkpoint_chunks`) and runs each chunk
  up to a checkpoint under non-reentrant `torch.utils.checkpoint`, which
  recomputes the chunk in the backward with the executor's generator
  rewound to where the chunk began (and put back after);
- the ops after the last section (the optimizer updates) run under
  `torch.no_grad()`;
- every persistable variable is written back to the scope, detached.

The train tier (the reference's `_train_tier_modes` /
`_resolve_train_optimized`): with FLAGS_amp or FLAGS_graph_opt_fuse
"on", `run` swaps a train program for its AMP-rewritten and fused clone
(`amp.rewrite_train_program`, then `passes.fuse_program`) before it
plans the run.  Their "train" default fires only in train_from_dataset.

The data-parallel branch (the reference's dp step): running a
`CompiledProgram(...).with_data_parallel(...)` runs the same plan once per
dp rank (`_run_dp`): each rank takes its shard of every feed (in one
process, 1/W of the feed's leading dim; over a process group, the feed
its process was given), runs the forward and backward sections with a
generator of its own, all-reduces the gradients between each section
and the update ops (`transpiler.collective.sync_gradients`, bucketed by
FLAGS_dp_bucket_bytes), runs the updates, and averages the float
persistables that ranks change differently (batch-norm running stats;
`_rank_varying`).  Fetches of rank >= 1 come back concatenated over the
ranks, rank-0 fetches averaged.

The GSPMD branch: running a `CompiledProgram(...).with_sharding_rules(
rules, execute=True)` lowers the rules over the program it runs
(`analysis.sharding.lower`, memoized per program version, rule
fingerprint, mesh and feed shapes) and runs the plan on the rule mesh
(`_run_spmd`, `framework/spmd.py`): each rank holds its shards of the
state, runs every op on its local tensors with the collectives the plan
implies, and the dp axis runs the data-parallel step above.

Static verification: with FLAGS_static_check "warn" or "error", `run`
lints the program it is about to run (the AMP + fused substitute when
the train tier is on) with `analysis.cached_check` before any op: "warn"
emits one `ProgramLintWarning` per program version, "error" raises
`ProgramLintError`.

Control flow (`cond`, `switch`, `while_loop`, `while_block`,
`static_rnn` and the tensor arrays) runs eagerly through the runners of
`_CONTROL_FLOW_OPS`: a predicate, loop condition or array index is read
on the host once (counted in `kernels.backend.HOST_SYNCS`) and the
chosen sub-block runs against a copy of the outer env.  A bounded loop
stops at the first false condition; a backward section that reaches an
unbounded loop raises, as the reference cannot differentiate one.

The anomaly guard (`resilience.enable_anomaly_guard`): each section's
summed loss and gradients join one all-finite flag, read on the host
once before the update ops; when it is down the step runs no update op
and writes nothing back, and `_apply_guard_policy` skips, raises or rolls
back.  With a fault plan armed (`resilience.faultinject`) each run's feed
may be NaN-tainted and a transient error injected inside the retried
region (`resilience.enable_retry`).

`train_from_dataset` / `infer_from_dataset`: the reference's dataset
loop over any iterable of feed dicts (see its docstring): prefetch,
print_period fetches, the Downpour sparse loop, checkpoint cadence,
preemption, auto-resume and the guard's rollback replay.

Not ported here: telemetry and goodput (the lint's monitor and
flight-recorder records among them), the elastic loop, the fleet-skew
record and the structural graph-optimizer substitution
(FLAGS_graph_opt), ROADMAP item 10.  They raise NotImplementedError, or
are not there.
"""

import contextlib

import numpy as np
import torch
import torch.utils.checkpoint

from .. import flags
from ..core.dtype import to_torch_dtype
from ..core.place import resolve_device
from ..interop import from_numpy_exact
from ..kernels.backend import count_host_sync
from ..ops.registry import get_op
from .program import Variable, default_main_program

# the single definition shared with the verifier's PT201 lint and the
# DCE pass (analysis/facts.py): an op type there survives _live_ops too
from ..analysis.facts import SIDE_EFFECT_TYPES as _SIDE_EFFECT_OPS  # noqa


def _materialize(fetches):
    """Copy device fetches to host numpy arrays: the one sync point of
    the dispatch path (the reference's `_materialize`); each call counts
    one host sync of kind "fetch"."""
    count_host_sync("fetch")
    return [_to_numpy(f) for f in fetches]


class Scope:
    """name -> tensor store for persistable variables."""

    def __init__(self):
        self.vars = {}

    def find_var(self, name):
        return self.vars.get(name)

    def var(self, name):
        return self.vars.setdefault(name, None)

    def set_var(self, name, value):
        self.vars[name] = value

    def drop_kids(self):
        self.vars.clear()

    def local_var_names(self):
        return list(self.vars)


_global_scope = Scope()


def global_scope():
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old


def _resolve_slot(env, names):
    vals = []
    for n in names:
        if n not in env:
            raise KeyError(
                f"variable '{n}' has no value: not fed, not initialized "
                f"(did you run the startup program?)"
            )
        vals.append(env[n])
    if len(vals) == 1:
        return vals[0]
    return vals


def _checkpoint_chunks(seg, checkpoint_names):
    """Split a forward segment at the ops producing each checkpoint var:
    [(ops, remat?)], the chunks up to each checkpoint recomputed, the
    rest after the last one not (the reference's `_checkpoint_chunks`,
    backward.py:639's recompute segments)."""
    if not checkpoint_names:
        return [(seg, False)]
    ckpts = set(checkpoint_names)
    boundaries = [i + 1 for i, op in enumerate(seg)
                  if set(op.output_names()) & ckpts]
    if not boundaries:
        return [(seg, False)]
    chunks = []
    start = 0
    for b in boundaries:
        if seg[start:b]:
            chunks.append((seg[start:b], True))
        start = b
    if seg[start:]:
        chunks.append((seg[start:], False))
    return chunks


def _run_recomputed(chunk, env, generator, needed_after):
    """One chunk under `torch.utils.checkpoint`: its inputs are the env
    values it reads, its outputs the names it produces that a later op,
    fetch or persistable needs; the recompute draws from the generator
    rewound to the chunk's start (`nn.parameter.rewound`)."""
    from ..nn.parameter import rewound

    produced, reads = set(), []
    for op in chunk:
        for n in op.input_names():
            if n not in produced and n in env and n not in reads:
                reads.append(n)
        produced.update(op.output_names())
    outs = [n for n in sorted(produced) if n in needed_after]

    def run(*vals):
        e = dict(zip(reads, vals))
        interpret(chunk, e, generator)
        return tuple(e[n] for n in outs)

    vals = torch.utils.checkpoint.checkpoint(
        rewound(run, generator), *[env[n] for n in reads],
        use_reentrant=False, preserve_rng_state=False)
    env.update(zip(outs, vals))


def run_op(op, env, generator):
    """Execute one recorded op against `env` (name -> tensor).  Every op
    gets the executor's device as `attrs["_device"]` (creation ops make
    their outputs there); ops that draw random bits get `generator`, a
    torch.Generator on that device, as `attrs["_generator"]`.  (The
    reference's `run_op` wraps `_run_op` in a JAX named scope; the port
    has one function.)  A control-flow op runs through its runner in
    `_CONTROL_FLOW_OPS`."""
    runner = _CONTROL_FLOW_OPS.get(op.type)
    if runner is not None:
        runner(op, env, generator)
        return
    opdef = get_op(op.type)
    ins = {}
    for slot, names in op.inputs.items():
        if not names:
            continue
        ins[slot] = _resolve_slot(env, names)
    attrs = dict(op.attrs)
    attrs["_device"] = generator.device
    if opdef.needs_rng:
        attrs["_generator"] = generator
    if flags.flag("executor_log_ops"):
        print(f"[paddle_tpu_torch.executor] {op.type} {list(op.inputs)} -> "
              f"{list(op.outputs)}")
    try:
        outs = opdef.fn(ins, attrs)
    except Exception as e:
        # decorate with the op identity + creation site (the reference
        # attaches the Python stack to op errors, op_call_stack.cc)
        where = getattr(op, "callsite", None)
        note = (f"[operator '{op.type}' "
                f"(inputs {list(op.inputs)}, outputs {list(op.outputs)})"
                + (f", created at {where}" if where else "") + "]")
        if hasattr(e, "add_note"):
            e.add_note(note)
            raise
        try:
            decorated = type(e)(f"{e} {note}")
        except Exception:
            # exception classes with non-str __init__ can't be rebuilt
            # from a message — re-raise as-is
            raise e
        raise decorated from e
    for slot, names in op.outputs.items():
        if slot not in outs:
            continue
        vals = outs[slot]
        if len(names) == 1 and not isinstance(vals, (list, tuple)):
            env[names[0]] = vals
        else:
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            for n, v in zip(names, vals):
                env[n] = v


def interpret(ops, env, generator):
    """Run `ops` in order against `env`."""
    for op in ops:
        run_op(op, env, generator)


# -- control flow (the reference's executor.py:272-565) ----------------------
#
# The reference lowers each control-flow op onto lax.cond / lax.while_loop
# / lax.scan at trace time.  The port runs them eagerly: a predicate, a
# loop condition or an array index is read on the host, once, with
# `.item()` on a 0-dim tensor (one device sync each, counted in
# kernels.backend.HOST_SYNCS), and the chosen sub-block is interpreted
# against a copy of the outer env.  Autograd flows through the trips the
# run took.


def _branch_env(env):
    # tensor arrays are Python lists: a sub-block must not mutate the
    # outer list (the reference traces both branches of a cond)
    return {k: (list(v) if isinstance(v, list) else v)
            for k, v in env.items()}


def _run_block(ops, env, generator, bound, out_names):
    """Interpret a sub-block against a copy of the outer env with `bound`
    ({inner name: value}) over it; the named results."""
    benv = _branch_env(env)
    benv.update(bound)
    interpret(ops, benv, generator)
    return tuple(benv[n] for n in out_names)


def _host_item(value, kind):
    """The one element of a predicate or index tensor, read on the
    host: one device sync, counted under `kind`."""
    count_host_sync(kind)
    return value.reshape(()).item()


def _as_dtype(value, like):
    """A loop body's output in its carry's dtype (the reference casts
    each body output to the init value's dtype)."""
    if isinstance(value, torch.Tensor) and isinstance(like, torch.Tensor) \
            and value.dtype != like.dtype:
        return value.to(like.dtype)
    return value


def _check_differentiable_loop(op, values):
    """A backward section may not reach an unbounded loop: the reference
    differentiates a loop only through its bounded scan lowering, so the
    port refuses the same programs."""
    if torch.is_grad_enabled() and any(
            isinstance(v, torch.Tensor) and v.requires_grad
            for v in values):
        raise ValueError(
            f"gradients cannot flow through the unbounded '{op.type}' op: "
            f"set maximum_trip_count (layers.while_loop) or max_iters "
            f"(layers.While) to bound it, as the reference requires")


def _captured_values(op, env):
    return [env[n] for n in op.inputs.get("Captured", ()) if n in env]


def _run_cond(op, env, generator):
    """conditional_block pair: the taken branch alone runs."""
    program = op.block.program
    a = op.attrs
    if _host_item(env[op.inputs["Pred"][0]], "cond"):
        blk, names = a["true_block"], a["true_outs"]
    else:
        blk, names = a["false_block"], a["false_outs"]
    outs = _run_block(program.blocks[blk].ops, env, generator, {}, names)
    for n, v in zip(op.outputs["Out"], outs):
        env[n] = v


def _run_switch(op, env, generator):
    """Switch: the first true case wins, else the default, else the
    written variables keep their values (one predicate read per case
    tried)."""
    program = op.block.program
    a = op.attrs
    out_names = a["out_names"]
    for n in out_names:
        if n not in env:
            raise KeyError(
                f"Switch writes '{n}' but it has no value before the "
                f"switch (cases only run conditionally)")
    result = tuple(env[n] for n in out_names)
    blk = a.get("default_block")
    for pred, case_blk in zip(a["case_preds"], a["case_blocks"]):
        if _host_item(env[pred], "switch"):
            blk = case_blk
            break
    if blk is not None:
        result = _run_block(program.blocks[blk].ops, env, generator, {},
                            out_names)
    for n, v in zip(op.outputs["Out"], result):
        env[n] = v


def _run_while(op, env, generator):
    """while_op.cc: one condition read per trip.  With `max_iters` (the
    layer's maximum_trip_count) the loop runs at most that many trips
    and stops at the first false condition; the reference runs exactly
    max_iters trips and freezes the carry once the condition is false,
    which gives the same values and gradients wherever the body stays
    finite past the end (ROADMAP section 3)."""
    program = op.block.program
    a = op.attrs
    carry = [env[n] for n in op.inputs["LoopVars"]]
    init = list(carry)
    max_iters = a.get("max_iters")
    if not max_iters:
        _check_differentiable_loop(op, carry + _captured_values(op, env))
    c_ops = program.blocks[a["cond_block"]].ops
    b_ops = program.blocks[a["body_block"]].ops
    trips = 0
    while not max_iters or trips < int(max_iters):
        (c,) = _run_block(c_ops, env, generator,
                          dict(zip(a["cond_inner"], carry)),
                          [a["cond_out"]])
        if not _host_item(c, "while"):
            break
        outs = _run_block(b_ops, env, generator,
                          dict(zip(a["body_inner"], carry)),
                          a["body_outs"])
        carry = [_as_dtype(o, i) for o, i in zip(outs, init)]
        trips += 1
    for n, v in zip(op.outputs["Out"], carry):
        env[n] = v


def _run_while_block(op, env, generator):
    """Block-style While (layers.While): the loop state is every outer
    variable the body assigns plus the condition variable; the loop ends
    when the body's assign to the condition goes false (read on the
    host before each trip).  `max_iters` bounds it as `_run_while`."""
    program = op.block.program
    a = op.attrs
    body = program.blocks[a["body_block"]]
    cond_name = a["cond_name"]
    written = set()
    for o in body.ops:
        written.update(o.output_names())
    carry_names = sorted({cond_name} | {n for n in written if n in env})
    carry = {n: env[n] for n in carry_names}
    init = dict(carry)
    max_iters = a.get("max_iters")
    if not max_iters:
        _check_differentiable_loop(
            op, list(carry.values()) + _captured_values(op, env))
    trips = 0
    while (not max_iters or trips < int(max_iters)) \
            and _host_item(carry[cond_name], "while"):
        local = _branch_env(env)
        local.update(carry)
        interpret(body.ops, local, generator)
        carry = {n: _as_dtype(local[n], init[n]) for n in carry_names}
        trips += 1
    env.update(carry)


def _run_static_rnn(op, env, generator):
    """StaticRNN: the step block once per step of the leading (time)
    axis, the memories carried, the step outputs stacked.  The step
    count is a shape, so no host read."""
    program = op.block.program
    a = op.attrs
    ops = program.blocks[a["block"]].ops
    xs = [env[n] for n in op.inputs["StepInputs"]]
    init = [env[n] for n in op.inputs["InitMemories"]]
    mems = list(init)
    n_mem = len(a["memory_update"])
    names = list(a["memory_update"]) + list(a["step_outs"])
    steps = []
    for t in range(xs[0].shape[0]):
        bound = dict(zip(a["memory_inner"], mems))
        bound.update(zip(a["input_inner"], [x[t] for x in xs]))
        outs = _run_block(ops, env, generator, bound, names)
        mems = [_as_dtype(o, i) for o, i in zip(outs[:n_mem], init)]
        steps.append(outs[n_mem:])
    for j, n in enumerate(op.outputs["Out"]):
        env[n] = torch.stack([s[j] for s in steps])


def _rank_table(env, name):
    """A rank table ([B, 2] int32: row order, length) on the host."""
    count_host_sync("rank_table")
    table = env[name].detach().cpu().numpy()
    return table[:, 0].astype(np.int64), table[:, 1]


def _run_array_op(op, env, generator):
    """LoDTensorArray ops over Python lists of tensors; each index is
    read on the host."""
    t = op.type
    if t == "create_array":
        env[op.outputs["Out"][0]] = []
        return
    if t == "array_write":
        arr = env[op.inputs["Array"][0]]
        i = int(_host_item(env[op.inputs["I"][0]], "array_index"))
        x = env[op.inputs["X"][0]]
        if i == len(arr):
            arr.append(x)
        elif i < len(arr):
            arr[i] = x
        else:
            raise IndexError(f"array_write index {i} > length {len(arr)}")
        return
    if t == "array_read":
        arr = env[op.inputs["Array"][0]]
        i = int(_host_item(env[op.inputs["I"][0]], "array_index"))
        env[op.outputs["Out"][0]] = arr[i]
        return
    if t == "array_length":
        arr = env[op.inputs["Array"][0]]
        env[op.outputs["Out"][0]] = torch.tensor(
            len(arr), dtype=torch.int32, device=generator.device)
        return
    if t == "lod_tensor_to_array":
        # control_flow.py:1132 parity: split [B, T, ...] into per-step
        # slices over the rank table's still-active prefix
        x = env[op.inputs["X"][0]]
        order, lengths = _rank_table(env, op.inputs["RankTable"][0])
        max_len = int(lengths[0]) if len(lengths) else 0
        idx = torch.from_numpy(order).to(x.device)
        env[op.outputs["Out"][0]] = [
            x[idx[:int((lengths > s).sum())], s] for s in range(max_len)]
        return
    if t == "array_to_lod_tensor":
        # control_flow.py:1174 parity: the inverse, restoring the row
        # order and right-padding the short rows with zeros
        arr = env[op.inputs["X"][0]]
        order, lengths = _rank_table(env, op.inputs["RankTable"][0])
        b, max_len = len(order), len(arr)
        feat = tuple(arr[0].shape[1:]) if arr else ()
        dtype = arr[0].dtype if arr else torch.float32
        out = torch.zeros((b, max_len) + feat, dtype=dtype,
                          device=generator.device)
        idx = torch.from_numpy(order).to(out.device)
        for s, rows in enumerate(arr):
            active = rows.shape[0]
            out = out.index_put(
                (idx[:active], torch.full((active,), s, dtype=torch.long,
                                          device=out.device)),
                rows.to(dtype))
        env[op.outputs["Out"][0]] = out
        return
    raise NotImplementedError(f"array op '{t}'")


_CONTROL_FLOW_OPS = {
    "cond": _run_cond,
    "switch": _run_switch,
    "while_loop": _run_while,
    "while_block": _run_while_block,
    "static_rnn": _run_static_rnn,
    "create_array": _run_array_op,
    "array_write": _run_array_op,
    "array_read": _run_array_op,
    "array_length": _run_array_op,
    "lod_tensor_to_array": _run_array_op,
    "array_to_lod_tensor": _run_array_op,
}


def op_scopes(ops, sections):
    """Deterministic per-op scope names for one live-op list:
    "{section}/{op_type}_{idx}" with idx the op's position in the list
    and section fwd<k> for ops feeding backward section k, update for
    ops after the last section (optimizer/stats), main when the
    program has no backward sections.  Derived from program structure
    alone, so names are stable across runs of the same program; the
    fusion tier records them as `folded_from` provenance."""
    section_ends = [(bs.pos, f"fwd{k}") for k, bs in enumerate(sections)]
    tail = "update" if sections else "main"
    names = []
    for i, op in enumerate(ops):
        prefix = tail
        for pos, name in section_ends:
            if i < pos:
                prefix = name
                break
        names.append(f"{prefix}/{op.type}_{i}")
    return names


def op_scope_names(program, fetch_names=(), train_loop=False):
    """[(scope, op)] in execution order for one program.  With the train
    tier on (FLAGS_amp / FLAGS_graph_opt_fuse "on", or their "train"
    default with `train_loop=True`, as a train_from_dataset dispatch
    would resolve it) the map goes through the AMP + fusion substitute:
    fused ops appear under their own scopes and carry `op.folded_from`,
    the scopes of the source ops they absorbed."""
    do_amp, do_fuse = Executor._train_tier_modes(program, train_loop)
    if do_amp or do_fuse:
        program = Executor._resolve_train_optimized(
            program, list(fetch_names), do_amp, do_fuse)
    ops = Executor._live_ops(program, list(fetch_names))
    sections = [] if program._is_test else list(program.backward_sections)
    return list(zip(op_scopes(ops, sections), ops))


def _rank_varying(ops, feeds):
    """The names whose values may differ between dp ranks after one step:
    what the ops compute from a feed (each rank's shard) or from random
    bits (each rank's generator), passed on through every op that reads
    them.  The gradients bound after a section are all-reduced, so what
    the updates compute from them and from the replicated state agrees
    on every rank."""
    varying = set(feeds)
    for op in ops:
        if get_op(op.type).needs_rng or any(
                n in varying for n in op.input_names()):
            varying.update(op.output_names())
    return varying


class _RunPlan:
    """One (program, version)'s analysis, computed once per program
    mutation and kept on the Program (program._run_plan_cache), as in the
    reference: the persistable names, the names the ops and backward
    sections (their `<name>@GRAD`) produce, the names the ops read, and
    each feed var's declared torch dtype."""

    __slots__ = ("program", "version", "persist_names", "produced",
                 "read_names", "_feed_dtypes")

    def __init__(self, program):
        self.program = program
        self.version = program._version
        self.persist_names = tuple(sorted(
            v.name for v in program.list_vars() if v.persistable))
        produced, read = set(), set()
        for op in program.global_block().ops:
            produced.update(op.output_names())
            read.update(op.input_names())
        for bs in program.backward_sections:
            produced.update(n + "@GRAD" for n in bs.param_names)
        self.produced = produced
        self.read_names = read
        self._feed_dtypes = {}

    def feed_dtype(self, name):
        """The declared torch dtype of a feed var (64-bit narrowed, as the
        reference's device dtype), None when undeclared."""
        try:
            return self._feed_dtypes[name]
        except KeyError:
            v = self.program.global_block()._find_var_recursive(name)
            dt = to_torch_dtype(v.dtype) if v is not None and v.dtype \
                else None
            self._feed_dtypes[name] = dt
            return dt


def feed_tensor(value, dtype, device):
    """One feed value (array, tensor or Python value) as a tensor on
    `device` in `dtype` (None: its device dtype, 64-bit narrowed); a
    tensor already there in that dtype is used as it is, one on the card
    is moved without a trip through the host."""
    t = value if isinstance(value, torch.Tensor) else from_numpy_exact(value)
    if dtype is None:
        dtype = to_torch_dtype(t.dtype)
    return t.to(device=device, dtype=dtype)


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16; the widening is exact
        t = t.float()
    return t.cpu().numpy()


class Executor:
    """Parity: fluid.Executor (executor.py:437).

    `place` is a Place, a device string or a torch.device; None means
    `cuda`, and raises on a host without one.  The executor's generator
    (seeded from FLAGS_global_seed) feeds the random ops."""

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._generator = torch.Generator(device=self.device).manual_seed(
            int(flags.flag("global_seed")))

    def close(self):
        pass

    @staticmethod
    def _get_plan(program):
        plan = getattr(program, "_run_plan_cache", None)
        if plan is None or plan.program is not program \
                or plan.version != program._version:
            plan = _RunPlan(program)
            program._run_plan_cache = plan
        return plan

    def _feed_tensor(self, value, dtype):
        return feed_tensor(value, dtype, self.device)

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, _train_loop=False):
        from .. import resilience as res
        from .spmd import ShardedValue

        program = program if program is not None else default_main_program()
        compiled = None
        spmd = False
        if hasattr(program, "_get_executable_program"):
            compiled = program
            program = compiled._get_executable_program()
            spmd = compiled._is_spmd
            if not (compiled._is_data_parallel or spmd):
                compiled = None
        feed = feed or {}
        fetch_list = fetch_list or []
        scope = scope if scope is not None else _global_scope
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list]
        # the train tier (AMP rewrite, then the fusion passes) on a
        # private clone, cached on the program; with FLAGS_amp and
        # FLAGS_graph_opt_fuse at their "train" defaults it fires only
        # in train_from_dataset (`_train_loop`), so a bare run costs two
        # flag reads
        do_amp, do_fuse = self._train_tier_modes(program, _train_loop)
        if do_amp or do_fuse:
            tier = self._resolve_train_optimized(
                program, fetch_names, do_amp, do_fuse)
            # mirror the CURRENT rule attachment: a re-attached or
            # removed rule set must not keep linting (or running) a
            # cached substitute against stale rules
            rules = getattr(program, "_sharding_rules", None)
            if getattr(tier, "_sharding_rules", None) is not rules:
                tier._sharding_rules = rules
            program = tier
        check_mode = flags.flag("static_check")
        if check_mode and check_mode != "off":
            self._static_check(program, fetch_names, feed, check_mode,
                               self._dp_ndev(compiled, spmd))
        plan = self._get_plan(program)

        env = {}
        missing = []
        folded = self._folded_constants(program)
        for n in plan.persist_names:
            val = scope.find_var(n)
            if val is None:
                val = folded.get(n)
            if isinstance(val, ShardedValue) and not spmd:
                val = val.full()
            if val is None:
                missing.append(n)
            else:
                env[n] = val
        # vars never written before and not produced by this program are
        # an error only if some op reads them
        for n in missing:
            if n not in plan.produced and n in plan.read_names:
                raise RuntimeError(
                    f"persistable variable '{n}' is uninitialized; run "
                    f"the startup program first")
        for n in fetch_names:
            if n not in env and n not in feed and n not in plan.produced:
                raise KeyError(
                    f"fetch variable '{n}' is neither fed, persistable nor "
                    f"produced by the program"
                    + program.global_block()._did_you_mean(n))

        ops = self._live_ops(program, fetch_names)
        sections = [] if program._is_test else list(program.backward_sections)
        keep = set(fetch_names) | set(plan.persist_names)
        guard = res.active_guard()
        guard_on = guard is not None and bool(sections)
        if guard_on and compiled is not None:
            raise NotImplementedError(
                "the anomaly guard over a data-parallel or GSPMD run is not "
                "ported to paddle_tpu_torch yet (ROADMAP item 10)")
        if res.faultinject.is_armed():
            # may hand back a NaN-tainted COPY of the feed dict (the
            # caller's arrays are never touched, so a rollback replay of
            # the same batch sees clean data)
            feed = res.faultinject.on_step_feed(feed)
        ok = None
        if compiled is not None:
            from .compiler import apply_precision_policy, resolve_precision

            run_dp = apply_precision_policy(
                self._run_spmd if spmd else self._run_dp,
                resolve_precision(compiled))
            env, fetches = run_dp(compiled, program, plan, env, feed,
                                  fetch_names, ops, sections, keep)
        else:
            for name, value in feed.items():
                env[name] = self._feed_tensor(value, plan.feed_dtype(name))
            retry = res.active_retry()
            state = env

            def attempt():
                # an injected transient error fires before any op, inside
                # the retried region; each attempt runs on its own copy
                # of the step's inputs
                if res.faultinject.is_armed():
                    res.faultinject.check_transient()
                e = dict(state)
                return e, self._step(ops, sections, e, keep,
                                     guard=guard_on)

            if retry is not None:
                env, ok = res.call_with_retry(attempt, retry)
            else:
                env, ok = attempt()
            fetches = [env[n].detach() for n in fetch_names]
        if guard_on:
            if ok:
                guard.note_ok()
            else:
                # the step ran no update op and commits nothing
                self._apply_guard_policy(res, guard, plan, scope)

        if ok is not False:
            for n in plan.persist_names:
                if n in env:
                    v = env[n]
                    scope.set_var(n, v if isinstance(v, ShardedValue)
                                  else v.detach())
        if return_numpy:
            return _materialize(fetches)
        return fetches

    def _generator_extras(self):
        """The executor generator's state for a checkpoint's extras (the
        reference saves its PRNG root key as `executor_rng_key`)."""
        return {"executor_generator_state":
                self._generator.get_state().numpy()}

    def _restore_generator(self, extras):
        """Resume the generator's stream from a checkpoint's extras, so a
        replay of a program with dropout draws what the uninterrupted run
        drew.  A reference checkpoint's `executor_rng_key` does not cross
        (ROADMAP section 3): the generator is left as it is."""
        state = extras.get("executor_generator_state")
        if state is not None:
            self._generator.set_state(torch.from_numpy(
                np.ascontiguousarray(state, dtype=np.uint8)))

    def _apply_guard_policy(self, res, guard, plan, scope):
        """Host side of the anomaly guard after a step whose finite flag
        was down (the step ran no update op and wrote nothing back): the
        reference's policies.  skip_step returns; raise raises
        AnomalyError; rollback restores the newest complete checkpoint
        into the scope and raises RollbackPerformed so the training loop
        rewinds its data cursor."""
        from .. import monitor as mon
        from ..monitor import flight_recorder

        if mon.is_enabled():
            mon.counter("resilience.anomaly_steps").add(1)
        fr = flight_recorder.get()
        if fr.enabled:
            fr.note_event("anomaly", policy=guard.policy)
        guard.note_anomaly()         # escalates past max_consecutive
        guard.last_skipped = False
        if guard.policy == "raise":
            raise res.AnomalyError(
                "anomaly guard: non-finite loss/gradients in guarded "
                "step (policy=raise)")
        if guard.policy == "skip_step":
            guard.last_skipped = True
            if mon.is_enabled():
                mon.counter("resilience.skipped_steps").add(1)
            return
        guard.note_rollback()        # escalates past max_rollbacks
        template = {}
        for n in plan.persist_names:
            v = scope.find_var(n)
            if v is not None:
                template[n] = v
        try:
            state, ck_step = guard.manager.restore_latest(template)
        except FileNotFoundError as e:
            raise res.AnomalyError(
                "rollback policy hit an anomaly before any complete "
                "checkpoint existed; save one up front (train_from_"
                "dataset does this automatically) or use "
                "policy='skip_step'") from e
        for n, v in state.items():
            scope.set_var(n, v)
        loader = getattr(guard.manager, "load_extras", None)
        self._restore_generator(loader(ck_step) if loader is not None
                                else {})
        if mon.is_enabled():
            mon.counter("resilience.rollbacks").add(1)
        if fr.enabled:
            fr.note_event("rollback", checkpoint_step=ck_step)
        raise res.RollbackPerformed(ck_step)

    def _rank_generator(self, rank, device):
        """The generator of dp rank `rank` on `device`: rank 0's is the
        executor's own (a one-rank run draws as a plain run does), the
        others' are seeded from FLAGS_global_seed and the rank, made once."""
        if rank == 0 and device == self.device:
            return self._generator
        gens = self.__dict__.setdefault("_rank_generators", {})
        key = (rank, str(device))
        if key not in gens:
            seed = (int(flags.flag("global_seed"))
                    + 0x9E3779B97F4A7C15 * rank) % (1 << 63)
            gens[key] = torch.Generator(device=device).manual_seed(seed)
        return gens[key]

    def _spmd_generator(self, world_rank, dp_index, device):
        """The generator of spmd rank `world_rank`: seeded from
        FLAGS_global_seed and the rank's dp coordinate, so the ranks of
        one data shard draw alike (a replicated random op stays
        replicated), one object a rank (the ranks run at once)."""
        gens = self.__dict__.setdefault("_spmd_generators", {})
        key = (world_rank, dp_index, str(device))
        if key not in gens:
            seed = (int(flags.flag("global_seed"))
                    + 0x9E3779B97F4A7C15 * (dp_index + 1)) % (1 << 63)
            gens[key] = torch.Generator(device=device).manual_seed(seed)
        return gens[key]

    def _dp_ndev(self, compiled, spmd):
        """The data-parallel width the verifier's PT107 checks feeds
        against: the rule mesh's dp axis, the dp tier's rank count, or
        None for a plain run."""
        import torch.distributed as dist

        if compiled is None:
            return None
        if spmd:
            return int(compiled._spmd_rules.mesh.size("dp"))
        mode, meshes = compiled._dp_meshes(self.device)
        return dist.get_world_size() if mode == "process" else len(meshes)

    @staticmethod
    def _static_check(program, fetch_names, feed, mode, dp_ndev=None):
        """Run the static verifier before any op (the reference's
        build-time InferShape parity point).  A fresh analysis emits ONE
        ProgramLintWarning (warn mode, or error mode with warnings only);
        a cache hit re-raises in error mode but never re-reports, so a
        training loop lints each program version once."""
        from .. import analysis

        key = "prog%x:v%d" % (id(program), program._version)
        result, fresh = analysis.cached_check(
            program, fetch_names=fetch_names,
            feed_names=list(feed or ()), dp_ndev=dp_ndev,
            program_key=key)
        if fresh and result.diagnostics and (mode != "error" or result.ok):
            analysis.warn_result(result, stacklevel=4)
        if mode == "error" and not result.ok:
            raise analysis.ProgramLintError(result)

    def _get_spmd_plan(self, program, rules, fetch_names, feed_shapes,
                       mesh_key):
        """The memoized ShardingPlan of the GSPMD tier: one
        `analysis.sharding.lower` per (program, version, rule
        fingerprint, mesh, feed shapes, fetches); entries hold the
        program, so a recycled id() cannot serve a stale plan."""
        from ..analysis import sharding as _sh

        shapes = {n: tuple(s) for n, s in feed_shapes.items()}
        key = (id(program), program._version, rules.fingerprint(),
               mesh_key, tuple(sorted(shapes.items())), tuple(fetch_names))
        plans = self.__dict__.setdefault("_spmd_plans", {})
        ent = plans.get(key)
        if ent is not None and ent[0] is program:
            return ent[1]
        splan = _sh.lower(program, rules, fetch_names=fetch_names,
                          feed_names=sorted(shapes), feed_shapes=shapes)
        if len(plans) >= 8:
            plans.clear()
        plans[key] = (program, splan)
        return splan

    def _run_spmd(self, compiled, program, plan, state, feed, fetch_names,
                  ops, sections, keep):
        """One step of the GSPMD tier (the module docstring and
        `framework/spmd.py`): returns ({persistable: ShardedValue}, the
        merged fetches)."""
        from ..distributed import collective as C
        from ..distributed import inprocess
        from ..distributed.mesh import mesh_key
        from ..transpiler import collective as coll
        from . import spmd as S

        rules = compiled._spmd_rules
        mode, meshes = compiled._spmd_meshes(self.device)
        first = meshes[0]
        if "dp" not in first.names or rules.data_axis != "dp":
            raise ValueError(
                "executable sharding rules need a 'dp' data axis on the "
                "mesh (size 1 is fine); got axes "
                f"{tuple(first.names)} with data axis "
                f"{rules.data_axis!r}")
        dp = first.axis_size("dp")
        parts = dp if mode == "threads" else 1
        for n, value in feed.items():
            shape = tuple(getattr(value, "shape", np.shape(value)))
            if not shape or shape[0] % parts != 0:
                raise ValueError(
                    f"data-parallel feed '{n}' needs a leading batch dim "
                    f"divisible by {parts} ranks, got {shape}")
        feeds = {n: feed_tensor(v, plan.feed_dtype(n), first.device)
                 for n, v in feed.items()}
        # the plan prices the GLOBAL batch: a process holds its dp shard
        scale = dp if mode == "process" else 1
        shapes = {n: (t.shape[0] * scale,) + tuple(t.shape[1:])
                  for n, t in feeds.items()}
        splan = self._get_spmd_plan(program, rules, fetch_names, shapes,
                                    mesh_key(meshes))
        index_of = {id(op): i
                    for i, op in enumerate(program.global_block().ops)}
        varying = _rank_varying(ops, feeds)
        params = {n for bs in sections for n in bs.param_names}

        def rank_step(r, mesh):
            rt = S.RankRuntime(splan, mesh, index_of)
            me = mesh.world_index()
            env = {}
            for n, v in state.items():
                want = S._body(splan, splan.state_specs.get(n))
                if isinstance(v, S.ShardedValue) and v.spec == want \
                        and v.coords.get(me) == mesh.coords():
                    env[n] = v.local(me)
                else:
                    env[n] = S.shard_state(S.whole(v), splan, n,
                                           mesh)
                rt.layout[n] = want
            di = mesh.axis_index("dp")
            for name, t in feeds.items():
                blk = t.shape[0] // parts
                shard = t[di * blk:(di + 1) * blk] if parts > 1 else t
                env[name] = shard.to(mesh.device)

            def sync(grads):
                for n in grads:
                    rt.layout[n + "@GRAD"] = rt.spec_of(n)
                return coll.sync_gradients(grads, "dp", mesh=mesh)

            grad_fn = None
            group = getattr(mesh, "model_group", None)
            if group is not None and group[0] is not None:
                def grad_fn(loss, leaves):
                    return group[0].exchange(
                        group[2], (loss, leaves),
                        lambda xs: inprocess.joint_grad(
                            [x[0] for x in xs], [x[1] for x in xs]))

            self._step(ops, sections, env, keep,
                       generator=self._spmd_generator(me, di, mesh.device),
                       sync=sync, runner=rt.run_op, grad_fn=grad_fn,
                       loss_fn=rt.loss_value)
            for n in plan.persist_names:
                v = env.get(n)
                if n in varying and n not in params and v is not None \
                        and v.is_floating_point():
                    env[n] = C.all_reduce(v.detach(), "dp", "mean", mesh)
            fetches = []
            for n in fetch_names:
                v = rt.fetch(n, env[n].detach())
                if v.dim() == 0:
                    v = C.all_reduce(v, "dp", "mean", mesh)
                else:
                    v = C.all_gather(v, "dp", axis=0, tiled=True, mesh=mesh)
                fetches.append(v)
            return env, fetches, rt

        if mode == "process":
            results = [rank_step(0, first)]
        else:
            try:
                results = inprocess.run_ranks(meshes, rank_step)
            except BaseException:
                # a failed rank breaks the ranks' barriers for good
                compiled._spmd_mesh_cache = None
                raise
        out = {}
        for n in plan.persist_names:
            if n not in results[0][0]:
                continue
            spec = S._body(splan, splan.state_specs.get(n))
            vs = splan.shapes.get(n)
            shape = (tuple(vs.shape) if vs is not None and vs.shape
                     is not None else tuple(results[0][0][n].shape))
            out[n] = S.ShardedValue(
                {m.world_index(): res[0][n].detach()
                 for m, res in zip(meshes, results)},
                spec, {m.world_index(): m.coords() for m in meshes}, shape)
        rt0 = results[0][2]
        coll.note_model_sync(rt0.records)
        coll._LAST_SYNC["fetch"] = list(rt0.fetch_records)
        return out, results[0][1]

    def _run_dp(self, compiled, program, plan, state, feed, fetch_names,
                ops, sections, keep):
        """One data-parallel step (see the module docstring): returns
        (rank 0's env, the merged fetches)."""
        from ..distributed import collective as C
        from ..distributed import inprocess
        from ..transpiler import collective as coll

        mode, meshes = compiled._dp_meshes(self.device)
        parts = len(meshes) if mode == "threads" else 1
        for n, value in feed.items():
            shape = tuple(getattr(value, "shape", np.shape(value)))
            if not shape or shape[0] % parts != 0:
                raise ValueError(
                    f"data-parallel feed '{n}' needs a leading batch dim "
                    f"divisible by {parts} ranks, got {shape}")
        feeds = {n: feed_tensor(v, plan.feed_dtype(n), meshes[0].device)
                 for n, v in feed.items()}
        varying = _rank_varying(ops, feeds)
        params = {n for bs in sections for n in bs.param_names}

        def rank_step(r, mesh):
            env = {n: v.to(mesh.device) for n, v in state.items()}
            for name, t in feeds.items():
                blk = t.shape[0] // parts
                shard = t[r * blk:(r + 1) * blk] if parts > 1 else t
                env[name] = shard.to(mesh.device)
            rank = mesh.rank if mode == "process" else r

            def sync(grads):
                return coll.sync_gradients(grads, "dp", mesh=mesh)

            self._step(ops, sections, env, keep,
                       generator=self._rank_generator(rank, mesh.device),
                       sync=sync)
            # the state ranks change differently (batch-norm running
            # stats), averaged; the params and what the updates wrote
            # from the synced grads agree already, and integer state is
            # left alone
            for n in plan.persist_names:
                v = env.get(n)
                if n in varying and n not in params and v is not None \
                        and v.is_floating_point():
                    env[n] = C.all_reduce(v.detach(), "dp", "mean", mesh)
            fetches = []
            for n in fetch_names:
                v = env[n].detach()
                if v.dim() == 0:
                    v = C.all_reduce(v, "dp", "mean", mesh)
                else:
                    v = C.all_gather(v, "dp", axis=0, tiled=True, mesh=mesh)
                fetches.append(v)
            return env, fetches

        if len(meshes) == 1:
            return rank_step(0, meshes[0])
        try:
            return inprocess.run_ranks(meshes, rank_step)[0]
        except BaseException:
            # a failed rank breaks the ranks' barriers for good
            compiled._dp_mesh_cache = None
            raise

    def _folded_constants(self, program):
        """The program's optimize-time constants (`passes.const_fold`,
        `fold_batch_norm`; `Program._folded_constants`) as tensors on the
        executor's device, made once per (program version, device) and
        kept on the program: they serve as initialized persistables where
        the scope has no value, and are written to the scope after the run
        like any persistable (the reference seeds its scope with them)."""
        fc = getattr(program, "_folded_constants", None)
        if not fc:
            return {}
        key = (program._version, self.device)
        held = getattr(program, "_folded_tensors", None)
        if held is None or held[0] != key:
            held = (key, {n: from_numpy_exact(v).to(
                device=self.device, dtype=to_torch_dtype(np.asarray(v).dtype))
                for n, v in fc.items()})
            program._folded_tensors = held
        return held[1]

    def _step(self, ops, sections, env, keep=(), generator=None,
              sync=None, runner=None, grad_fn=None, loss_fn=None,
              guard=False):
        """Run `ops` against `env`, realizing each BackwardSection with
        torch autograd (see the module docstring); `keep` names the
        values a recomputed chunk must hand on (fetches, persistables)
        beside those later ops read.  `generator` (default: the
        executor's) feeds the random ops; `sync`, {name: grad} -> {name:
        grad}, runs on each section's gradients before they are bound
        (the data-parallel all_reduce).  The GSPMD tier passes `runner`
        (in place of `run_op`; no chunk is recomputed under it),
        `grad_fn(loss, leaves)` (in place of `torch.autograd.grad`) and
        `loss_fn(name, value)` (the section's loss as the ranks take it).

        With `guard` (an active anomaly guard), each section's summed
        loss and raw gradients join one all-finite flag, read on the host
        once before the update ops: when it is down no update op runs
        and `_step` returns False (True otherwise; None unguarded)."""
        gen = self._generator if generator is None else generator
        if runner is None:
            run_ops = interpret
        else:
            def run_ops(chunk, env_, gen_):
                for op in chunk:
                    runner(op, env_, gen_)
        pos = 0
        finite = []
        for bs in sections:
            params = {n: env[n].detach().requires_grad_(True)
                      for n in bs.param_names if n in env}
            env.update(params)
            start = pos
            with torch.enable_grad():
                for chunk, remat in _checkpoint_chunks(
                        ops[pos:bs.pos], bs.checkpoint_names):
                    start += len(chunk)
                    if not remat or runner is not None:
                        run_ops(chunk, env, gen)
                        continue
                    needed = set(keep) | {bs.loss_name}
                    for op in ops[start:]:
                        needed.update(op.input_names())
                    _run_recomputed(chunk, env, gen, needed)
                loss = env[bs.loss_name]
                if loss_fn is not None:
                    loss = loss_fn(bs.loss_name, loss)
                loss = loss.sum()
            leaves = list(params.values())
            if loss.requires_grad and leaves:
                grads = (grad_fn or (lambda l, x: torch.autograd.grad(
                    l, x, allow_unused=True)))(loss, leaves)
            else:
                grads = [None] * len(leaves)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
            if guard:
                from ..resilience.guard import all_finite

                finite.append(all_finite([loss.detach()]
                                         + list(grads.values())))
            if sync is not None:
                # in sorted order, as the reference's gradient dict is
                # (jax returns a dict pytree with sorted keys), so the
                # buckets' packing order is the reference's
                grads = sync({n: grads[n] for n in sorted(grads)})
            for n, g in grads.items():
                env[n + "@GRAD"] = g
            pos = bs.pos
        if guard and finite and not _host_item(
                torch.stack(finite).all(), "guard"):
            return False
        with torch.no_grad():
            run_ops(ops[pos:], env, gen)
        return True if guard else None

    @staticmethod
    def _train_tier_modes(program, train_loop):
        """(do_amp, do_fuse) for one dispatch: the tier applies only to
        train programs (backward sections, not a test clone); "train"
        mode further requires the dataset train loop
        (train_from_dataset passes `train_loop` True), "on" covers every
        Executor.run.  AMP is skipped for programs the user already
        rewrote (amp_enabled)."""
        if program._is_test or not program.backward_sections:
            return False, False
        amp_mode = flags.flag("amp")
        fuse_mode = flags.flag("graph_opt_fuse")
        do_amp = (amp_mode == "on"
                  or (amp_mode == "train" and train_loop)) \
            and not program.amp_enabled
        do_fuse = (fuse_mode == "on"
                   or (fuse_mode == "train" and train_loop))
        return do_amp, do_fuse

    @staticmethod
    def _resolve_train_optimized(program, fetch_names, do_amp, do_fuse):
        """The AMP + fusion substitute of a train program, built once per
        (version, fetch set, amp dtype, fusion config) and cached in the
        program's `_opt_cache` (`_bump()` clears it).  Canonical order
        inside: the AMP rewrite first, fusion second, on one clone."""
        from .. import passes as _passes

        try:
            fuse_names = (_passes.enabled_fusion_passes()
                          if do_fuse else ())
        except KeyError as e:
            raise ValueError(
                f"FLAGS_graph_opt_fuse_disable names an unknown "
                f"fusion pass: {e}") from e
        key = ("train_tier", program._version, tuple(fetch_names),
               flags.flag("amp_dtype") if do_amp else None, fuse_names)
        cache = getattr(program, "_opt_cache", None)
        if cache:
            hit = cache.get(key)
            if hit is not None:
                return hit
        opt = program.clone()
        if do_amp:
            from .. import amp as _amp

            _amp.rewrite_train_program(opt)
        if do_fuse:
            _passes.fuse_program(opt, fetch_names=fetch_names,
                                 clone=False)
        # provenance: which train-tier config produced this substitute
        # (a cached substitute outlives the flag state that built it)
        opt._train_tier = {
            "amp": flags.flag("amp_dtype") if do_amp else None,
            "fuse": list(fuse_names)}
        if cache is None:
            cache = program._opt_cache = {}
        elif len(cache) >= 8:
            cache.clear()
        cache[key] = opt
        return opt

    @staticmethod
    def _live_ops(program, fetch_names):
        """Run-time dead-op elimination (the reference's feed/fetch
        pruning, executor.py:236/274): keep the ops that reach a fetch or
        a persistable update.  Programs with backward sections run
        unpruned — everything feeds the update."""
        ops = list(program.global_block().ops)
        if program.backward_sections and not program._is_test:
            return ops
        persist = {v.name for v in program.list_vars() if v.persistable}
        needed = set(fetch_names)
        keep = [False] * len(ops)
        for i in range(len(ops) - 1, -1, -1):
            outs = set(ops[i].output_names())
            if outs & needed or outs & persist \
                    or ops[i].type in _SIDE_EFFECT_OPS:
                keep[i] = True
                needed |= set(ops[i].input_names())
        return [op for i, op in enumerate(ops) if keep[i]]

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           sparse_config=None, _sparse_push=True,
                           prefetch=None, checkpoint=None,
                           auto_resume=False, elastic=None):
        """Dataset-driven training loop (the reference's
        executor.py:1755; Fluid's executor.py:1187 train_from_dataset ->
        MultiTrainer / HogwildWorker::TrainFiles).

        `dataset`: any iterable of feed dicts ({name: array}): a
        QueueDataset / InMemoryDataset over MultiSlot files
        (`datasets.multislot`), a list, a generator.  Keys the program
        does not declare are dropped.  Each batch runs through
        `Executor.run` with the train tier on (FLAGS_amp /
        FLAGS_graph_opt_fuse at their "train" defaults rewrite the
        program with AMP and fusion, as in the reference) and fetches
        kept on the device: they reach the host only at `print_period`
        boundaries (with `debug` or `fetch_info`) and for the last
        batch.  Returns the last batch's fetches as numpy (None when
        `fetch_list` is empty or no batch ran).

        sparse_config (or the program's `_ps_sparse_config`, which the
        DistributeTranspiler attaches): the Downpour pull -> step -> push
        loop: {"table": SparseEmbedding or Communicator, "ids_var": the
        feed with ids, "emb_var": the data var fed with the pulled rows}
        or a list of them; `emb_var@GRAD` is fetched and pushed after
        each step (the program lists emb_var in append_backward's
        parameter_list).

        prefetch: a producer thread keeps prepared batches in flight
        (dataset iteration and sparse pulls overlap the step), and on
        the dense single-device path `reader.device_prefetch(size=2)`
        copies batch N+1 to the device while step N runs.  None: on for
        dense programs and for async / half_async communicators, off for
        synchronous pushes (whose pull -> step -> push order is strict).

        checkpoint: a CheckpointManager, a directory or a kwargs dict for
        one.  The loop saves the persistables every save_interval_steps
        with the executor generator's state in the extras, force-saves
        at the next step boundary when a preemption was requested
        (resilience.PreemptionHandler / request_preemption) and exits;
        under an anomaly guard with policy ``rollback`` it keeps the
        prepared batches since the last save (host arrays, never device
        tensors) and replays them after the guard's restore.

        auto_resume: restore the newest complete checkpoint first and
        skip the batches it consumed, so a relaunch of the same command
        continues the run.

        elastic=, FLAGS_goodput and the fleet-skew record of a
        data-parallel program under the monitor raise
        NotImplementedError (ROADMAP item 10)."""
        from .. import monitor as mon
        from .. import resilience as res
        from ..monitor import exporter as _exporter
        from ..monitor import flight_recorder

        if elastic is not None:
            raise NotImplementedError(
                "train_from_dataset(elastic=...) is not ported to "
                "paddle_tpu_torch yet (ROADMAP item 10: "
                "resilience/elastic.py)")
        if flags.flag("goodput"):
            raise NotImplementedError(
                "the goodput ledger (FLAGS_goodput) is not ported to "
                "paddle_tpu_torch yet (ROADMAP item 10: monitor/goodput.py)")
        program = program if program is not None else default_main_program()
        real_prog = program
        if hasattr(real_prog, "_get_executable_program"):
            real_prog = real_prog._get_executable_program()
        if mon.is_enabled() and flags.flag("fleet_skew") and getattr(
                program, "_is_data_parallel", False):
            raise NotImplementedError(
                "the fleet-skew record of a data-parallel train_from_"
                "dataset is not ported to paddle_tpu_torch yet (ROADMAP "
                "item 10: monitor/fleet.py); set FLAGS_fleet_skew=False")
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset")
        fetch_list = list(fetch_list or [])
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in fetch_list]
        fetch_info = list(fetch_info or fetch_names)
        blk = real_prog.global_block()

        _exporter.ensure_started()
        fr = flight_recorder.get()
        mgr = checkpoint
        if mgr is not None and not hasattr(mgr, "restore_latest"):
            from ..checkpoint import CheckpointManager

            if isinstance(mgr, str):
                mgr = CheckpointManager(mgr)
            elif isinstance(mgr, dict):
                mgr = CheckpointManager(**mgr)
            else:
                raise TypeError(
                    f"checkpoint= wants a CheckpointManager, path, or "
                    f"kwargs dict, got {type(checkpoint).__name__}")
        ckpt_scope = scope if scope is not None else _global_scope
        persist_names = sorted(v.name for v in real_prog.list_vars()
                               if v.persistable)

        def _ckpt_state():
            return {n: ckpt_scope.find_var(n) for n in persist_names
                    if ckpt_scope.find_var(n) is not None}

        guard = res.active_guard()
        # an eval drain (infer_from_dataset, a test clone) is never
        # guarded: adopting the guard's manager for it would save EVAL
        # vars into the TRAINING store
        is_train_prog = (not real_prog._is_test
                         and bool(real_prog.backward_sections))
        keep_replay = (guard is not None and guard.policy == "rollback"
                       and is_train_prog)
        if keep_replay:
            if mgr is None:
                mgr = guard.manager
            elif mgr is not guard.manager:
                raise ValueError(
                    "checkpoint= and the rollback guard's manager are "
                    "different CheckpointManagers; pass the same one so "
                    "rollback steps line up with the loop's saves")

        if auto_resume and mgr is None:
            raise ValueError(
                "auto_resume=True needs a checkpoint store (pass "
                "checkpoint=...); silently retraining from step 0 "
                "would re-consume data")
        start_step = 0
        if mgr is not None and auto_resume:
            template = _ckpt_state()
            if template:
                try:
                    restored, start_step = mgr.restore_latest(template)
                except FileNotFoundError:
                    start_step = 0      # cold start: nothing to resume
                else:
                    for n, v in restored.items():
                        ckpt_scope.set_var(n, v)
                    # resume the generator's stream, not just the params
                    self._restore_generator(mgr.load_extras(start_step))
                    if mon.is_enabled():
                        mon.counter("resilience.auto_resume").add(1)
                        mon.counter("resilience.batches_skipped").add(
                            start_step)
        if start_step:
            import itertools

            # skip the consumed RAW batches (before prepare: no wasted
            # sparse pulls)
            dataset = itertools.islice(iter(dataset), start_step, None)

        sp = sparse_config
        if sp is None:
            sp = getattr(program, "_ps_sparse_config", None) \
                or getattr(real_prog, "_ps_sparse_config", None)
        entries = list(sp) if isinstance(sp, (list, tuple)) \
            else ([sp] if sp else [])
        entries = [dict(e) for e in entries
                   if e and e.get("table") is not None]
        if keep_replay and entries and _sparse_push:
            raise ValueError(
                "anomaly-guard rollback cannot be combined with sparse "
                "gradient push: pushed rows can't be unwound by a "
                "checkpoint restore (use policy='skip_step' or drop the "
                "sparse tables)")
        for e in entries:
            # a Communicator wraps a table: pull reads through, push goes
            # through the communicator's mode
            e["_pull"] = getattr(e["table"], "table", e["table"])
            e["_grad"] = e["emb_var"] + "@GRAD"

        if prefetch is None:
            prefetch = (not _sparse_push
                        or all(getattr(e["table"], "mode", None)
                               in ("async", "half_async") for e in entries))

        def prepare(batch):
            feed = {k: v for k, v in batch.items()
                    if blk._find_var_recursive(k) is not None}
            fl = list(fetch_names)
            batch_ids = {}
            for e in entries:
                ids = np.asarray(batch[e["ids_var"]])
                batch_ids[e["emb_var"]] = ids
                feed[e["emb_var"]] = e["_pull"].pull(ids)
                if _sparse_push:
                    fl.append(e["_grad"])
            return feed, fl, batch_ids

        producer = stop = None
        if prefetch:
            import queue as _queue
            import threading as _threading

            q = _queue.Queue(maxsize=2)
            stop = _threading.Event()
            _END, _ERR = object(), object()

            def _offer(item):
                # a bounded put that gives up once the consumer is gone,
                # so a raising loop cannot strand this thread
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except _queue.Full:
                        continue
                return False

            def produce():
                try:
                    for b in dataset:
                        if not _offer(prepare(b)):
                            return
                    _offer(_END)
                except BaseException as exc:   # propagate to consumer
                    _offer((_ERR, exc))

            producer = _threading.Thread(target=produce, daemon=True)
            producer.start()

            def _host_batches():
                try:
                    while True:
                        item = q.get()
                        if item is _END:
                            return
                        if isinstance(item, tuple) and item[0] is _ERR:
                            raise item[1]
                        yield item
                finally:
                    stop.set()        # unblock and retire the producer

            def prepared_batches():
                gen = _host_batches()
                if not entries and not keep_replay and \
                        not getattr(program, "_is_data_parallel", False):
                    # the dense single-device path: the device double
                    # buffer on top of the producer thread.  The sparse
                    # path keeps host batches (its ids are pushed from
                    # the host), the data-parallel path lets each rank
                    # take its shard, and the rollback replay buffer must
                    # not pin a save interval of batches on the card.
                    from .. import reader as _reader

                    gen = _reader.device_prefetch(gen, size=2,
                                                  device=self.device)
                return gen
        else:
            def prepared_batches():
                for b in dataset:
                    yield prepare(b)

        if keep_replay and mgr.latest_step() is None:
            # rollback needs a restore point covering the whole loop
            initial = _ckpt_state()
            if initial:
                mgr.save(initial, start_step, force=True,
                         extras=self._generator_extras())
        last = None
        step_i = start_step
        replay = []          # [(step_no, feed, fl)] since the last save
        batches = prepared_batches()
        try:
            for feed, fl, batch_ids in batches:
                if res.preemption_requested():
                    # preemption-safe exit at this STEP BOUNDARY
                    if mon.is_enabled():
                        mon.counter("resilience.preempt_requested").add(1)
                    if fr.enabled:
                        fr.note_event("preemption", step=step_i,
                                      checkpointed=mgr is not None)
                    if mgr is None:
                        import warnings

                        warnings.warn(
                            "preemption requested but this train_from_"
                            "dataset has no checkpoint= store; stopping "
                            "WITHOUT saving.  Pass checkpoint=<dir|"
                            "CheckpointManager> (with auto_resume=True to "
                            "continue on relaunch) to make this exit "
                            "durable.  The flag stays set for an enclosing "
                            "checkpointed loop — call resilience.clear_"
                            "preemption() if none exists.",
                            RuntimeWarning, stacklevel=2)
                    else:
                        if mgr.latest_step() != step_i:
                            # a boundary already durable is not rewritten
                            mgr.save(_ckpt_state(), step_i, force=True,
                                     extras=self._generator_extras())
                        if mon.is_enabled():
                            mon.counter(
                                "resilience.preempt_checkpoint").add(1)
                        # handled: a later loop in this process trains
                        res.clear_preemption()
                    break
                if keep_replay:
                    # a RollbackPerformed restored checkpoint step S:
                    # re-run the buffered batches S+1.. in order, the
                    # failing one included
                    pending = [(step_i + 1, feed, fl)]
                    while pending:
                        sno, f, flx = pending.pop(0)
                        try:
                            out = self.run(program, feed=f, fetch_list=flx,
                                           scope=scope, return_numpy=False,
                                           _train_loop=True)
                        except res.RollbackPerformed as rb:
                            redo = [it for it in replay if it[0] > rb.step]
                            replay = [it for it in replay
                                      if it[0] <= rb.step]
                            pending = redo + [(sno, f, flx)] + pending
                            continue
                        replay.append((sno, f, flx))
                else:
                    out = self.run(program, feed=feed, fetch_list=fl,
                                   scope=scope, return_numpy=False,
                                   _train_loop=True)
                if entries and _sparse_push:
                    n = len(entries)
                    if guard is not None and guard.last_skipped:
                        # a skipped step commits NOTHING, its sparse half
                        # included
                        out = out[:-n]
                    else:
                        grads = _materialize(out[-n:])
                        for e, g in zip(entries, grads):
                            e["table"].push(batch_ids[e["emb_var"]], g)
                        out = out[:-n]
                last = out
                step_i += 1
                if mgr is not None and mgr.should_save(step_i):
                    # interval-gated before the state dict is built
                    saved = mgr.save(_ckpt_state(), step_i,
                                     extras=self._generator_extras())
                    if saved is not None:
                        replay = [it for it in replay if it[0] > step_i]
                if (debug or fetch_info) and fetch_names \
                        and step_i % print_period == 0:
                    vals = _materialize(out)
                    msg = ", ".join(
                        f"{info}={v.mean():.6f}"
                        for info, v in zip(fetch_info, vals))
                    print(f"[train_from_dataset] step {step_i}: {msg}")
        finally:
            # the producer stops whether the loop ended, broke or raised
            if stop is not None:
                stop.set()
                producer.join(timeout=5)
        if not fetch_names or last is None:
            return None
        return _materialize(last)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           prefetch=None):
        """executor.py:2342 parity: the same drain loop, read-only on the
        sparse tables (rows are pulled to feed the program, gradients are
        neither fetched nor pushed, so prefetch is on by default)."""
        return self.train_from_dataset(
            program=program, dataset=dataset, scope=scope, thread=thread,
            debug=debug, fetch_list=fetch_list, fetch_info=fetch_info,
            print_period=print_period, _sparse_push=False,
            prefetch=prefetch)
