"""Exported program facts — the analysis results other subsystems reuse.

Port of paddle_tpu/analysis/facts.py (pure Python).  It reads the
port's op registry (`ops.registry._OPS`) and the Executor's
`_CONTROL_FLOW_OPS`; in the port only the fusion tier consumes it (the
verifier and the numerics and sharding analyzers are ROADMAP items 10
and 8).

The verifier (PT201/202 liveness, shape/dtype inference) and the graph
optimizer (``passes``) must agree on what is live and what
shape a variable has: a pass that deletes an op the verifier considers
live (or vice versa) would make "optimize then lint" inconsistent.  This
module holds the SHARED facts both consume:

- :func:`live_op_mask` — the backward liveness sweep seeded from the
  fetch set (the PT201 rule and the DCE pass are the same computation).
- :func:`infer_specs` — a quiet (shape, dtype) lattice walk over the
  global block using the per-op-family rules of ``shape_rules``;
  unknown ops degrade to OPAQUE, never an error (the verifier's pass 3
  reports diagnostics on top of the same rules).
- :func:`protected_names` — names referenced from control-flow
  sub-blocks: the interpreter binds those at trace time through the
  captured environment, outside the global block's def-use chains, so
  neither liveness nor renaming may touch them.
"""

from ..ops.registry import _OPS
from . import shape_rules as sr

__all__ = ["live_op_mask", "infer_specs", "protected_names",
           "grad_name", "SIDE_EFFECT_TYPES", "control_flow_types",
           "var_spec", "bind_outputs", "backward_segments",
           "multi_written_names"]

# ops whose output IS the side effect: liveness keeps them
# unconditionally.  The single definition the verifier's PT201 sweep,
# Executor._live_ops-style pruning and the DCE pass all import — a set
# updated in one place but not another would make "lint says dead" and
# "DCE deletes" diverge.
SIDE_EFFECT_TYPES = frozenset(("print",))

# op types executed by the interpreter's control-flow table, not the
# kernel registry.  The executor's _CONTROL_FLOW_OPS dict is the single
# source of truth; it is resolved lazily (importing the analysis
# package does not import the Executor) with a static fallback for
# import-less contexts.
_CONTROL_FLOW_FALLBACK = frozenset((
    "cond", "switch", "while_loop", "while_block", "static_rnn",
    "create_array", "array_write", "array_read", "array_length",
    "lod_tensor_to_array", "array_to_lod_tensor",
))
_control_flow_types = None


def control_flow_types():
    global _control_flow_types
    if _control_flow_types is None:
        try:
            from ..framework.executor import _CONTROL_FLOW_OPS

            _control_flow_types = (frozenset(_CONTROL_FLOW_OPS)
                                   | _CONTROL_FLOW_FALLBACK)
        except Exception:
            _control_flow_types = _CONTROL_FLOW_FALLBACK
    return _control_flow_types


def grad_name(name):
    return name + "@GRAD"


def backward_segments(num_ops, sections):
    """``seg_of[i]``: which backward segment op *i* belongs to —
    segment k covers the ops before the k-th BackwardSection position
    (sorted), the tail after the last.  Ops in different segments
    trace into different ``value_and_grad`` closures, so this is the
    ONE boundary definition the CSE pass's dedup scope, the fusion
    matchers' ``same_seg`` guard, and the numerics analyzer's
    cast-churn memo all share."""
    positions = sorted(bs.pos for bs in sections)
    seg_of = []
    k = 0
    for i in range(num_ops):
        while k < len(positions) and positions[k] <= i:
            k += 1
        seg_of.append(k)
    return seg_of


def live_op_mask(ops, sections, fetch_names, persist,
                 control_flow_types=(), side_effect_types=(),
                 extra_roots=()):
    """Backward liveness sweep over one op list: ``keep[i]`` is True
    when op *i* contributes to a fetch, a section loss/grad, a
    persistable-variable update, or is a side-effecting / control-flow
    op (whose reads the sweep cannot see through).  This is the single
    definition PT201 (dead-op lint), ``Executor._live_ops`` pruning and
    the DCE pass share."""
    needed = set(fetch_names) | set(extra_roots)
    for bs in sections:
        needed.add(bs.loss_name)
        needed.update(grad_name(p) for p in bs.param_names)
        # checkpoint vars split the remat segments; dropping their
        # producer would silently change the recompute boundaries
        needed.update(bs.checkpoint_names)
    keep = [False] * len(ops)
    for i in range(len(ops) - 1, -1, -1):
        outs = set(ops[i].output_names())
        if (outs & needed or outs & persist
                or ops[i].type in side_effect_types
                or ops[i].type in control_flow_types):
            keep[i] = True
            needed |= set(ops[i].input_names())
    return keep


def multi_written_names(ops, pre_defined):
    """Names with more than one DEFINITION over `ops` — WAW barriers.
    `pre_defined` holds names that carry a value BEFORE the program
    runs (feeds, persistables, data vars): their FIRST in-program
    write is already the second definition.  The ONE definition the
    graph passes' legality checks (ProgramRewriter.multi_written) and
    the numerics analyzer's churn guards share — a cast the lint
    calls removable must be one the passes may actually remove."""
    seen = set(pre_defined)
    multi = set()
    for op in ops:
        for n in op.output_names():
            if n in seen:
                multi.add(n)
            seen.add(n)
    return multi


def var_spec(var):
    """(shape, dtype) spec of a declared Variable (OPAQUE for None)."""
    if var is None:
        return sr.OPAQUE
    return sr.VarSpec(var.shape, var.dtype)


_var_spec = var_spec


def bind_outputs(specs, op, outs):
    """Bind a rule's output specs (or OPAQUE when `outs` is None) to
    the op's output variable names — zip truncation, OPAQUE padding
    for extra names, single-value-to-first-name.  The ONE binding rule
    both the verifier (main + sub-block passes) and the optimizer's
    legality walk apply."""
    for slot, names in op.outputs.items():
        if not names:
            continue
        vals = None if outs is None else outs.get(slot)
        if vals is None:
            for n in names:
                specs[n] = sr.OPAQUE
        elif isinstance(vals, (list, tuple)):
            for n, v in zip(names, vals):
                specs[n] = v
            for n in names[len(vals):]:
                specs[n] = sr.OPAQUE
        else:
            specs[names[0]] = vals
            for n in names[1:]:
                specs[n] = sr.OPAQUE


def infer_specs(program, feed_names=(), on_event=None, overrides=None):
    """THE (shape, dtype) rule walk over the global block — shared by
    the verifier's pass 3 (which layers PT101/102/204/209 diagnostics
    on top via `on_event`), the graph optimizer's rewrite-legality
    checks, and the sharding analyzer's propagation (which both run it
    quietly): one walk, so "what the lint infers" and "what a pass
    believes" can never diverge.

    `overrides` maps var names to concrete shapes that replace the
    declared ones at the walk's start — the sharding analyzer's
    memory/cost models pin the symbolic batch dim to a real feed batch
    this way without mutating the program.

    `on_event(kind, op, op_index, error)` is called for each failure
    mode before the op's outputs degrade to OPAQUE:

    - ``"no_rule"``     — registered, non-opaque op without a rule
    - ``"shape_error"`` — the rule raised :class:`sr.ShapeError`
    - ``"rule_crash"``  — the rule raised anything else
    """
    blk = program.global_block()
    ops = list(blk.ops)
    sections = ([] if program._is_test
                else list(program.backward_sections))
    control_flow = control_flow_types()
    declared = {}
    for b in program.blocks:
        for n, v in b.vars.items():
            declared.setdefault(n, v)
    specs = {}
    for n, v in declared.items():
        if v.persistable or v.is_data or n in feed_names:
            specs[n] = _var_spec(v)
    for n, shape in (overrides or {}).items():
        base = declared.get(n)
        specs[n] = sr.VarSpec(shape,
                              base.dtype if base is not None else None)
    section_at = {}
    for bs in sections:
        section_at.setdefault(bs.pos, []).append(bs)

    def bind(op, outs):
        bind_outputs(specs, op, outs)

    for i, op in enumerate(ops):
        for bs in section_at.get(i, ()):
            for p in bs.param_names:
                specs[grad_name(p)] = specs.get(p, sr.OPAQUE)
        if op.type in control_flow or sr.is_opaque(op.type):
            bind(op, None)
            continue
        rule = sr.get_rule(op.type)
        if rule is None:
            if on_event is not None and op.type in _OPS:
                on_event("no_rule", op, i, None)
            bind(op, None)
            continue
        ins = {}
        for slot, names in op.inputs.items():
            ins[slot] = [specs.get(n) or _var_spec(declared.get(n))
                         for n in names]
        try:
            outs = rule(op, ins, op.attrs)
        except sr.ShapeError as e:
            if on_event is not None:
                on_event("shape_error", op, i, e)
            outs = None
        except Exception as e:
            if on_event is not None:
                on_event("rule_crash", op, i, e)
            outs = None
        bind(op, outs)
    # trailing sections (pos == len(ops))
    for bs in sections:
        if bs.pos >= len(ops):
            for p in bs.param_names:
                specs[grad_name(p)] = specs.get(p, sr.OPAQUE)
    return specs


def protected_names(program):
    """Every variable name referenced by an op OUTSIDE the global block
    (control-flow bodies), plus names listed in control-flow op attrs
    (cond/body inner-outer bindings).  Sub-block ops read outer names
    through the captured trace environment — invisible to global-block
    def-use — so rewrites must neither rename nor delete them."""
    names = set()
    blk = program.global_block()
    for b in program.blocks:
        if b is blk:
            continue
        for op in b.ops:
            names.update(op.input_names())
            names.update(op.output_names())
    control_flow = control_flow_types()
    for op in blk.ops:
        if op.type not in control_flow:
            # only control-flow attrs carry variable names
            # (cond_inner/body_outs bindings); sweeping every op's
            # string attrs would protect vars that merely share a
            # spelling with 'NCHW' / an act name / a reduce type
            continue
        for v in op.attrs.values():
            if isinstance(v, str):
                names.add(v)
            elif isinstance(v, (list, tuple)) and v \
                    and all(isinstance(x, str) for x in v):
                names.update(v)
    return names
