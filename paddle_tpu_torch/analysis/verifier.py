"""Static Program verifier — abstract interpretation over ProgramDesc
(port of paddle_tpu/analysis/verifier.py).

The build-time validation layer the reference ran as per-op
``InferShape``/``InferVarType`` (framework/operator.h OperatorWithKernel)
plus the graph sanity checks of executor prepare: here ONE pass walks a
recorded :class:`~paddle_tpu_torch.framework.program.Program` WITHOUT
running it and reports everything that would otherwise die deep inside
an op as an error with no ProgramDesc provenance.

Passes (see diagnostics.py for the full code table):

1. **shape/dtype inference** — per-op-family rules (shape_rules.py)
   propagate a (shape, dtype) lattice; unknown ops degrade to OPAQUE
   with a warning, never a false error.
2. **def-use / liveness** — use-before-def, dead ops/vars, WAW,
   missing fetch targets, unregistered op types.
3. **donation/aliasing hazards** — stateful ops whose ``*Out`` slot
   doesn't alias its input; fetches of donated persistable vars.
4. **distributed lints** — dp batch-dim divisibility, collectives
   outside a dp mesh, backward-section consistency.

`check_program` is pure analysis; `cached_check` memoizes per
(program, ``_version``) — ``_bump()`` invalidates — so the executor's
steady-state dispatch fast path pays one dict probe.
"""

import time

from ..ops.registry import _OPS
from . import facts
from . import shape_rules as sr
from .diagnostics import Diagnostic, LintResult

# op types executed by the interpreter's control-flow table, not the
# kernel registry — single-sourced in analysis/facts.py (shared with
# the graph optimizer's passes).
_control_flow = facts.control_flow_types

_COLLECTIVE_TYPES = frozenset((
    "allreduce", "broadcast", "c_allgather", "c_allreduce_max",
    "c_allreduce_min", "c_allreduce_prod", "c_allreduce_sum",
    "c_broadcast", "c_reducescatter",
))

_SIDE_EFFECT_TYPES = facts.SIDE_EFFECT_TYPES

# how many analyses actually ran (cache misses) — pinned by the
# caching tests; monotone over the process lifetime
analysis_runs = 0


# shared analysis facts (facts.py is the single source: grad naming,
# spec construction, output binding — lint and optimizer legality must
# apply identical rules)
_grad_name = facts.grad_name
_var_spec = facts.var_spec
_bind_outputs = facts.bind_outputs


def _diag(diags, code, message, op=None, op_index=None, var=None):
    diags.append(Diagnostic(
        code, message,
        op_type=None if op is None else op.type,
        op_index=op_index,
        callsite=None if op is None else getattr(op, "callsite", None),
        var=var))


def check_program(program, fetch_names=None, feed_names=(),
                  dp_ndev=None, program_key=None, sharding=None,
                  feed_shapes=None):
    """Lint one Program.  `fetch_names=None` means "fetches unknown":
    the fetch-dependent lints (PT104/PT201/PT202/PT208) are skipped so
    a standalone lint of an inference program doesn't flag its leaf
    outputs as dead.  `sharding` is a
    :class:`~paddle_tpu_torch.analysis.sharding.PartitionRules` (default: the
    set attached to the program via ``sharding.attach`` /
    ``CompiledProgram.with_sharding_rules``, if any) — when present,
    the static sharding analyzer runs and its PT3xx diagnostics merge
    into the result; the full :class:`ShardingAnalysis` rides on
    ``result.sharding``.  Returns a :class:`LintResult`."""
    global analysis_runs
    analysis_runs += 1
    t0 = time.perf_counter()
    diags = []
    blk = program.global_block()
    ops = list(blk.ops)
    sections = ([] if program._is_test
                else list(program.backward_sections))
    feed_names = set(feed_names or ())

    control_flow = _control_flow()
    declared = {}
    for b in program.blocks:
        for n, v in b.vars.items():
            declared.setdefault(n, v)
    persist = {n for n, v in declared.items() if v.persistable}
    data_vars = {n for n, v in declared.items() if v.is_data}

    # ---- pass 0: unregistered op types (all blocks) -------------------
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            if op.type not in _OPS and op.type not in control_flow:
                _diag(diags, "PT105",
                      f"op type '{op.type}' has no registered TPU "
                      f"kernel (would raise NotImplementedError "
                      f"mid-trace)", op=op,
                      op_index=i if b is blk else None)

    # ---- pass 1: def-use over the global block ------------------------
    defined = set(persist) | data_vars | set(feed_names)
    produced_at = {}                  # name -> first producing op index
    for i, op in enumerate(ops):
        for n in op.output_names():
            produced_at.setdefault(n, i)
    section_at = {}
    for bs in sections:
        section_at.setdefault(bs.pos, []).append(bs)

    last_write = {}                   # name -> (op_index, read_since)
    use_before_def = set()            # report once per var name

    def _note_reads(names):
        for n in names:
            if n in last_write:
                last_write[n] = (last_write[n][0], True)

    for i, op in enumerate(ops):
        for bs in section_at.get(i, ()):
            if bs.loss_name not in defined:
                _diag(diags, "PT108",
                      f"backward section at op #{i} differentiates "
                      f"loss '{bs.loss_name}' which is undefined at "
                      f"that position", var=bs.loss_name)
            for p in bs.param_names:
                defined.add(_grad_name(p))
                last_write.pop(_grad_name(p), None)
            _note_reads([bs.loss_name] + list(bs.param_names))
        reads = op.input_names()
        for n in reads:
            if n in defined or n in use_before_def:
                continue
            use_before_def.add(n)
            if n in produced_at and produced_at[n] > i:
                msg = (f"variable '{n}' is read before the op that "
                       f"produces it (op #{produced_at[n]})")
            elif n in declared:
                msg = (f"non-persistable variable '{n}' is read but "
                       f"never produced, fed, or initialized")
            else:
                msg = f"variable '{n}' is not declared in any block"
            _diag(diags, "PT103", msg, op=op, op_index=i, var=n)
        _note_reads(reads)
        for n in op.output_names():
            prev = last_write.get(n)
            if prev is not None and not prev[1]:
                _diag(diags, "PT203",
                      f"variable '{n}' written at op #{i} overwrites "
                      f"the value written at op #{prev[0]} that was "
                      f"never read", op=op, op_index=i, var=n)
            last_write[n] = (i, False)
            defined.add(n)

    # trailing sections (pos == len(ops)) never hit the walk above:
    # run their loss check here so an undefined loss is still caught
    for bs in sections:
        if bs.pos >= len(ops) and bs.loss_name not in defined:
            _diag(diags, "PT108",
                  f"backward section at op #{bs.pos} differentiates "
                  f"loss '{bs.loss_name}' which is undefined at that "
                  f"position", var=bs.loss_name)

    # grad names a section will materialize count as defined for the
    # end-of-program view even when no op at that pos exists yet
    section_grads = {_grad_name(p) for bs in sections
                     for p in bs.param_names}

    # ---- pass 2: fetch-dependent lints --------------------------------
    if fetch_names is not None:
        produced = set(produced_at)
        for f in fetch_names:
            if f in defined or f in section_grads:
                if f in persist and f in produced:
                    _diag(diags, "PT208",
                          f"fetch '{f}' names a persistable variable "
                          f"the compiled step updates and donates; "
                          f"the executor must device-copy it to keep "
                          f"the fetched buffer valid", var=f)
                continue
            _diag(diags, "PT104",
                  f"fetch target '{f}' is never produced by this "
                  f"program" + (" (did you mean a declared var? it is "
                                "neither fed nor persistable)"
                                if f in declared else ""), var=f)

        # dead ops: backward sweep from fetches + loss/grads +
        # persistable updates + side effects (the SAME liveness fact
        # the DCE pass of paddle_tpu.passes consumes — facts.py is the
        # single definition, so "lint says dead" and "DCE deletes"
        # can never disagree).  Train programs run unpruned; dead work
        # still burns device time, hence the lint.
        keep = facts.live_op_mask(ops, sections, fetch_names, persist,
                                  control_flow_types=control_flow,
                                  side_effect_types=_SIDE_EFFECT_TYPES)
        for i, op in enumerate(ops):
            if not keep[i]:
                _diag(diags, "PT201",
                      f"dead op: outputs {op.output_names()} are never "
                      f"read, fetched, or persisted", op=op, op_index=i)

        # dead vars: declared in the global block, touched by nothing
        touched = set(produced_at) | set(feed_names) | set(fetch_names) \
            | section_grads
        for op in ops:
            touched.update(op.input_names())
        for bs in sections:
            touched.add(bs.loss_name)
            touched.update(bs.param_names)
        for n, v in blk.vars.items():
            if n in touched or v.persistable or v.is_data:
                continue
            if n.endswith("@GRAD"):
                # framework-made grad slots survive clone(for_test=True)
                # with their backward sections stripped — clone
                # artifacts, not user mistakes
                continue
            _diag(diags, "PT202",
                  f"variable '{n}' is declared but never produced, "
                  f"read, or fetched", var=n)

    # ---- pass 3: shape/dtype inference --------------------------------
    # THE rule walk lives in facts.infer_specs (shared with the graph
    # optimizer's rewrite-legality checks, so "what the lint infers"
    # and "what a pass believes" cannot diverge); the verifier layers
    # its diagnostics on top through the event callback.
    warned_opaque = set()

    def _spec_event(kind, op, i, err):
        if kind == "no_rule":
            if op.type not in warned_opaque:
                warned_opaque.add(op.type)
                _diag(diags, "PT204",
                      f"no shape-inference rule for op type "
                      f"'{op.type}'; its outputs are treated as "
                      f"opaque", op=op, op_index=i)
        elif kind == "shape_error":
            code = "PT102" if err.kind == "dtype" else "PT101"
            _diag(diags, code, str(err), op=op, op_index=i)
        else:            # rule_crash: degrade, never false-error
            _diag(diags, "PT209",
                  f"shape rule for '{op.type}' crashed "
                  f"({type(err).__name__}: {err}); outputs treated as "
                  f"opaque", op=op, op_index=i)

    specs = facts.infer_specs(program, feed_names=feed_names,
                              on_event=_spec_event)

    # ---- pass 3b: shape/dtype inside sub-blocks (control-flow bodies)
    # REDUCED pass: rule-based inference only.  Def-use/liveness/WAW
    # are unsound across the interpreter's runtime binding of loop
    # carries (cond_inner/body_inner names bind at trace time), so a
    # sub-block reports only genuine PT101/PT102 inconsistencies;
    # anything uncertain stays silent rather than false-positive.
    for b in program.blocks:
        if b is blk:
            continue
        local = {}
        for i, op in enumerate(b.ops):
            if op.type in control_flow or sr.is_opaque(op.type) \
                    or op.type not in _OPS:
                _bind_outputs(local, op, None)
                continue
            rule = sr.get_rule(op.type)
            if rule is None:
                _bind_outputs(local, op, None)
                continue
            ins = {}
            for slot, names in op.inputs.items():
                ins[slot] = [local.get(n) or specs.get(n)
                             or _var_spec(b._find_var_recursive(n))
                             for n in names]
            try:
                outs = rule(op, ins, op.attrs)
            except sr.ShapeError as e:
                code = "PT102" if e.kind == "dtype" else "PT101"
                _diag(diags, code, f"block {b.idx}: {e}", op=op,
                      op_index=i)
                outs = None
            except Exception:
                outs = None     # weaker context: degrade quietly
            _bind_outputs(local, op, outs)

    # ---- pass 4: donation / aliasing hazards --------------------------
    for i, op in enumerate(ops):
        opdef = _OPS.get(op.type)
        if opdef is None or not opdef.stateful:
            continue
        for oslot, onames in op.outputs.items():
            if not oslot.endswith("Out"):
                continue
            islot = oslot[:-3]
            inames = op.inputs.get(islot)
            if not inames:
                continue
            for oname, iname in zip(onames, inames):
                if oname != iname:
                    _diag(diags, "PT106",
                          f"stateful op writes {oslot}='{oname}' "
                          f"which does not alias {islot}='{iname}': "
                          f"the in-place update would land in a "
                          f"different variable and '{iname}' would "
                          f"never advance", op=op, op_index=i,
                          var=iname)

    # ---- pass 5: distributed / backward-section lints -----------------
    if dp_ndev is not None and dp_ndev > 1:
        read_names = {n for op in ops for n in op.input_names()}
        for n in sorted(data_vars & read_names):
            spec = specs.get(n) or _var_spec(declared.get(n))
            if spec.shape and spec.shape[0] is not None \
                    and spec.shape[0] % dp_ndev != 0:
                _diag(diags, "PT107",
                      f"data-parallel feed '{n}' has a static batch "
                      f"dim {spec.shape[0]} not divisible by the "
                      f"{dp_ndev}-device mesh", var=n)
    if not dp_ndev or dp_ndev <= 1:
        for i, op in enumerate(ops):
            if op.type in _COLLECTIVE_TYPES:
                _diag(diags, "PT207",
                      f"collective op '{op.type}' in a program run "
                      f"without a data-parallel mesh (needs "
                      f"with_data_parallel or a multi-process group)",
                      op=op, op_index=i)

    producers = {}
    for i, op in enumerate(ops):
        for n in op.output_names():
            producers.setdefault(n, []).append(i)
    for bs in sections:
        loss_spec = specs.get(bs.loss_name)
        if loss_spec is not None and loss_spec.numel() not in (None, 1):
            _diag(diags, "PT205",
                  f"backward-section loss '{bs.loss_name}' has shape "
                  f"{loss_spec.shape} (executor sums it; reduce to a "
                  f"scalar first if that is not intended)",
                  var=bs.loss_name)
        # reachability: walk the dataflow backwards from the loss
        # through ops before the section position
        reachable = {bs.loss_name}
        frontier = [bs.loss_name]
        while frontier:
            name = frontier.pop()
            for pi in producers.get(name, ()):
                if pi >= bs.pos:
                    continue
                for n in ops[pi].input_names():
                    if n not in reachable:
                        reachable.add(n)
                        frontier.append(n)
        for p in bs.param_names:
            if p not in reachable:
                _diag(diags, "PT206",
                      f"parameter '{p}' is not reachable from loss "
                      f"'{bs.loss_name}': its gradient is identically "
                      f"zero", var=p)

    # ---- pass 6: static sharding analysis (PT3xx) ---------------------
    # only when a rule set is in play — a program without partition
    # rules has nothing to lint here, and the pass costs nothing
    sharding_analysis = None
    if sharding is None:
        from . import sharding as _sh

        sharding = _sh.attached(program)
    if sharding is not None:
        from . import sharding as _sh

        # feed_shapes pin the symbolic batch dim: divisibility checks
        # become decidable and the cost/memory models byte-exact —
        # and the resulting diagnostics flow into THIS result, so the
        # CLI's exit-code contract sees them
        sharding_analysis = _sh.analyze(
            program, sharding, fetch_names=fetch_names,
            feed_names=feed_names, feed_shapes=feed_shapes,
            program_key=program_key)
        diags.extend(sharding_analysis.diagnostics)

    # ---- pass 7: numerics / AMP-safety analysis (PT4xx) ---------------
    # dtype-flow over the SAME specs pass 3 computed: fragile ops in
    # low precision, broken fp32 master chains, cast churn, fusion
    # near-misses.  On the executor path this program IS the AMP+fused
    # substitute (_resolve_train_optimized runs before _static_check),
    # so the analysis sees the casts the dispatch actually traces.
    from . import numerics as _nu

    numerics_analysis = _nu.analyze(
        program, fetch_names=fetch_names, feed_names=feed_names,
        specs=specs, program_key=program_key)
    diags.extend(numerics_analysis.diagnostics)

    order = {"error": 0, "warning": 1}
    diags.sort(key=lambda d: (order[d.severity],
                              -1 if d.op_index is None else d.op_index,
                              d.code))
    result = LintResult(diags, program_key=program_key,
                        wall_ms=(time.perf_counter() - t0) * 1e3)
    result.sharding = sharding_analysis
    result.numerics = numerics_analysis
    return result


# ---------------------------------------------------------------------------
# cached entry point (the executor's hook)
# ---------------------------------------------------------------------------

_CACHE_CAP = 8


def cached_check(program, fetch_names=None, feed_names=(), dp_ndev=None,
                 program_key=None):
    """`check_program` memoized on the program per
    (``_version``, fetches, feeds, dp, amp dtype, fusion config) — the
    same invalidation contract as the executor's run-plan cache: any
    graph mutation bumps ``_version`` and the next check re-analyzes,
    and a flag flip changing the AMP dtype or the enabled fusion
    passes re-keys (the PT4xx numerics pass reads both, and the
    executor builds a DIFFERENT substitute under them).  Returns
    (result, fresh): `fresh` is False on a cache hit so the caller can
    avoid double-reporting."""
    from .. import flags
    from . import sharding as _sh

    rules = _sh.attached(program)
    key = (program._version,
           None if fetch_names is None else tuple(fetch_names),
           frozenset(feed_names or ()),
           dp_ndev,
           None if rules is None else rules.fingerprint(),
           flags.flag("amp_dtype"),
           (flags.flag("graph_opt_fuse"),
            flags.flag("graph_opt_fuse_disable")),
           flags.flag("numerics_reduce_elems"))
    cache = getattr(program, "_lint_cache", None)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return hit, False
    result = check_program(program, fetch_names=fetch_names,
                           feed_names=feed_names, dp_ndev=dp_ndev,
                           program_key=program_key)
    if cache is None:
        cache = {}
        program._lint_cache = cache
    elif len(cache) >= _CACHE_CAP:
        # drop stale versions first, then oldest insertion
        stale = [k for k in cache if k[0] != program._version]
        for k in stale or [next(iter(cache))]:
            cache.pop(k, None)
    cache[key] = result
    return result, True
