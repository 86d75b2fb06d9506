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
- the ops after the last section (the optimizer updates) run under
  `torch.no_grad()`;
- every persistable variable is written back to the scope, detached.

The train tier (the reference's `_train_tier_modes` /
`_resolve_train_optimized`): with FLAGS_amp or FLAGS_graph_opt_fuse
"on", `run` swaps a train program for its AMP-rewritten and fused clone
(`amp.rewrite_train_program`, then `passes.fuse_program`) before it
plans the run.  Their "train" default fires only in train_from_dataset.

Not ported here: the data-parallel, GSPMD, guard, telemetry, goodput and
fault-injection branches (ROADMAP items 8 and 10), the structural
graph-optimizer substitution (FLAGS_graph_opt, item 10), the
control-flow ops and `train_from_dataset` (item 10).  They raise
NotImplementedError, or are not there.
"""

import contextlib

import numpy as np
import torch

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
        program = program if program is not None else default_main_program()
        if hasattr(program, "_get_executable_program"):
            raise NotImplementedError(
                "running a CompiledProgram (data parallel, sharding rules) "
                "is not ported to paddle_tpu_torch yet (ROADMAP item 8)")
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
            program = self._resolve_train_optimized(
                program, fetch_names, do_amp, do_fuse)
        plan = self._get_plan(program)

        env = {}
        missing = []
        folded = self._folded_constants(program)
        for n in plan.persist_names:
            val = scope.find_var(n)
            if val is None:
                val = folded.get(n)
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
        for name, value in feed.items():
            env[name] = self._feed_tensor(value, plan.feed_dtype(name))
        for n in fetch_names:
            if n not in env and n not in plan.produced:
                raise KeyError(
                    f"fetch variable '{n}' is neither fed, persistable nor "
                    f"produced by the program"
                    + program.global_block()._did_you_mean(n))

        ops = self._live_ops(program, fetch_names)
        sections = [] if program._is_test else list(program.backward_sections)
        self._step(ops, sections, env)

        for n in plan.persist_names:
            if n in env:
                scope.set_var(n, env[n].detach())
        fetches = [env[n].detach() for n in fetch_names]
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

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

    def _step(self, ops, sections, env):
        """Run `ops` against `env`, realizing each BackwardSection with
        torch autograd (see the module docstring)."""
        gen = self._generator
        pos = 0
        for bs in sections:
            params = {n: env[n].detach().requires_grad_(True)
                      for n in bs.param_names if n in env}
            env.update(params)
            with torch.enable_grad():
                interpret(ops[pos:bs.pos], env, gen)
                loss = env[bs.loss_name].sum()
            leaves = list(params.values())
            if loss.requires_grad and leaves:
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            else:
                grads = [None] * len(leaves)
            for (n, p), g in zip(params.items(), grads):
                env[n + "@GRAD"] = torch.zeros_like(p) if g is None else g
            pos = bs.pos
        with torch.no_grad():
            interpret(ops[pos:], env, gen)

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
