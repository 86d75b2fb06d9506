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

Not ported here: the guard, telemetry, goodput and fault-injection
branches (the lint's monitor and flight-recorder records among them),
the structural graph-optimizer substitution (FLAGS_graph_opt), the
control-flow ops and `train_from_dataset` (ROADMAP item 10).  They raise
NotImplementedError, or are not there.
"""

import contextlib

import numpy as np
import torch
import torch.utils.checkpoint

from .. import flags
from ..core.dtype import to_torch_dtype
from ..core.place import resolve_device
from ..interop import from_numpy_exact
from ..ops.registry import get_op
from .program import Variable, default_main_program

# the reference's control-flow runners (conditional blocks, while loops,
# static rnn, tensor arrays) and the ops whose output IS a side effect
_CONTROL_FLOW_OPS = frozenset((
    "cond", "switch", "while_loop", "while_block", "static_rnn",
    "create_array", "array_write", "array_read", "array_length",
    "lod_tensor_to_array", "array_to_lod_tensor"))
_SIDE_EFFECT_OPS = frozenset(("print",))


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
    has one function.)"""
    if op.type in _CONTROL_FLOW_OPS:
        raise NotImplementedError(
            f"control-flow op '{op.type}' is not ported to paddle_tpu_torch "
            f"yet (ROADMAP item 10)")
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
            return_numpy=True):
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
        # in train_from_dataset, so a bare run costs two flag reads
        do_amp, do_fuse = self._train_tier_modes(program, False)
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
            self._step(ops, sections, env, keep)
            fetches = [env[n].detach() for n in fetch_names]

        for n in plan.persist_names:
            if n in env:
                v = env[n]
                scope.set_var(n, v if isinstance(v, ShardedValue)
                              else v.detach())
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

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
              sync=None, runner=None, grad_fn=None, loss_fn=None):
        """Run `ops` against `env`, realizing each BackwardSection with
        torch autograd (see the module docstring); `keep` names the
        values a recomputed chunk must hand on (fetches, persistables)
        beside those later ops read.  `generator` (default: the
        executor's) feeds the random ops; `sync`, {name: grad} -> {name:
        grad}, runs on each section's gradients before they are bound
        (the data-parallel all_reduce).  The GSPMD tier passes `runner`
        (in place of `run_op`; no chunk is recomputed under it),
        `grad_fn(loss, leaves)` (in place of `torch.autograd.grad`) and
        `loss_fn(name, value)` (the section's loss as the ranks take it)."""
        gen = self._generator if generator is None else generator
        if runner is None:
            run_ops = interpret
        else:
            def run_ops(chunk, env_, gen_):
                for op in chunk:
                    runner(op, env_, gen_)
        pos = 0
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
            if sync is not None:
                # in sorted order, as the reference's gradient dict is
                # (jax returns a dict pytree with sorted keys), so the
                # buckets' packing order is the reference's
                grads = sync({n: grads[n] for n in sorted(grads)})
            for n, g in grads.items():
                env[n + "@GRAD"] = g
            pos = bs.pos
        with torch.no_grad():
            run_ops(ops[pos:], env, gen)

    @staticmethod
    def _train_tier_modes(program, train_loop):
        """(do_amp, do_fuse) for one dispatch: the tier applies only to
        train programs (backward sections, not a test clone); "train"
        mode further requires the dataset train loop
        (train_from_dataset, ROADMAP item 10: `train_loop` is False on
        every path the port has), "on" covers every Executor.run.  AMP
        is skipped for programs the user already rewrote
        (amp_enabled)."""
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

    def train_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.train_from_dataset is not ported to paddle_tpu_torch "
            "yet (ROADMAP item 10; its readers are paddle_tpu_torch.reader)")

    def infer_from_dataset(self, *args, **kwargs):
        raise NotImplementedError(
            "Executor.infer_from_dataset is not ported to paddle_tpu_torch "
            "yet (ROADMAP item 10; its readers are paddle_tpu_torch.reader)")
