"""Structural graph passes: constant folding, CSE, identity
elimination, dead-op/dead-var elimination (port of
paddle_tpu/passes/common.py).

All four are value-free — they rewrite from program structure and the
analysis package's shape/liveness facts alone, so they are safe on any
program (train or inference).  The value-based inference folds live in
``fold.py``.
"""

import itertools

import numpy as np
import torch

from ..analysis import facts
from ..interop import from_numpy_exact
from ..ops.registry import _OPS
from .rewriter import canonical_attrs, is_pure

__all__ = ["const_fold", "cse", "identity_elim", "dce"]

_SIDE_EFFECT_TYPES = facts.SIDE_EFFECT_TYPES

# a folded constant above this many bytes would bloat the program more
# than recomputing it costs
_CONST_FOLD_CAP_BYTES = 1 << 20

# process-global id for folded-constant names: auto-generated var names
# repeat across unique_name.guard() blocks, and two programs sharing a
# scope must never seed DIFFERENT constants under the SAME name
_FOLD_ID = itertools.count()


def _resolve_ins(op, values):
    ins = {}
    for slot, names in op.inputs.items():
        if not names:
            continue
        vals = [from_numpy_exact(values[n]) for n in names]
        ins[slot] = vals[0] if len(vals) == 1 else vals
    return ins


def _eval_const(op, values):
    """Run one op on the CPU over numpy constants (the op functions take
    tensors and the device as `attrs["_device"]`); its outputs come back
    as the op function returns them."""
    attrs = dict(op.attrs)
    attrs["_device"] = torch.device("cpu")
    with torch.no_grad():
        return _OPS[op.type].fn(_resolve_ins(op, values), attrs)


def _const_value(v):
    """An op output as the numpy constant it folds to (bfloat16 widened
    to float32, which is exact)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


def const_fold(rw):
    """Evaluate ops whose inputs are all optimize-time constants and
    replace the results read by non-constant ops with initialized
    persistables (reference: constant_folding_pass.cc).  Sources are
    pure zero-input ops (fill_constant, assign_value); persistable and
    feed variables are never constants — their values change between
    runs."""
    ops = rw.ops
    persist = rw.persist_names()
    multi = rw.multi_written()
    values = {}            # const var name -> np value
    const_ops = []         # indices evaluated successfully
    for i, op in enumerate(ops):
        if not is_pure(op):
            continue
        in_names = op.input_names()
        # multi-written inputs are WAW barriers: `values` tracks names,
        # not writes, so a redefined name's constant may be stale here
        if any(n not in values or n in multi for n in in_names):
            continue
        out_names = op.output_names()
        if any(n in persist or n in rw.feed_names or n in multi
               for n in out_names):
            continue       # a write to state/feed/WAW slots: not foldable
        try:
            outs = _eval_const(op, values)
        except Exception:
            continue
        ok = True
        bound = {}
        for slot, names in op.outputs.items():
            if slot not in outs:
                continue
            vals = outs[slot]
            if len(names) == 1 and not isinstance(vals, (list, tuple)):
                vals = [vals]
            for n, v in zip(names, vals):
                v = _const_value(v)
                if v.nbytes > _CONST_FOLD_CAP_BYTES:
                    ok = False
                bound[n] = v
        if not ok or not bound:
            continue
        values.update(bound)
        const_ops.append(i)
    if not const_ops:
        return {"folded": 0}
    const_idx = set(const_ops)
    # boundary vars: constants read by a surviving op or fetched
    boundary = set()
    for i, op in enumerate(ops):
        if i in const_idx:
            continue
        boundary.update(n for n in op.input_names() if n in values)
    boundary.update(n for n in rw.fetch_names if n in values)
    # protected names include control-flow sub-block reads AND
    # backward-section loss/checkpoint names — consumers invisible to
    # global-block def-use: their constant must be materialized, not
    # vanish with its producer
    boundary.update(n for n in rw.protected if n in values)
    rename = {}
    for n in sorted(boundary):
        if n in rw.protected:
            # a fetched name must keep its identity; protected names
            # are user-chosen, so the collision risk unique renaming
            # guards against does not apply
            rw.make_constant(n, values[n])
            continue
        # non-protected constants get a process-unique name: the
        # executor seeds them into (possibly shared, possibly global)
        # scopes, where a colliding auto-generated name from another
        # program would otherwise serve the wrong value
        u = "%s.folded_%d" % (n, next(_FOLD_ID))
        rename[n] = u
        rw.make_constant(u, values[n])
        rw.block.vars.pop(n, None)      # the old declaration is dead
    rw.apply(remove=const_idx, rename=rename)
    return {"folded": len(const_idx), "constants": len(boundary)}


def cse(rw):
    """Common-subexpression elimination (reference parity: the
    framework/ir dedup passes): two pure ops in the SAME backward
    segment with identical type, resolved inputs, and attrs compute the
    same values — keep the first, rewire readers of the second.
    Segment-scoped because ops on opposite sides of a BackwardSection
    position run in different autograd sections."""
    ops = rw.ops
    seg_of = facts.backward_segments(len(ops), rw.sections())
    persist = rw.persist_names()
    multi = rw.multi_written()
    rename = {}
    remove = set()
    folded_into = {}
    seen = {}

    def resolve(n):
        while n in rename:
            n = rename[n]
        return n

    for i, op in enumerate(ops):
        if not is_pure(op):
            continue
        attrs_key = canonical_attrs(op)
        if attrs_key is None:
            continue
        out_names = op.output_names()
        # multi-written names are WAW barriers: two ops reading the
        # same NAME may see different writes, and an output that is
        # rewritten later can't be deduped away
        if any(n in multi for n in out_names) \
                or any(n in multi for n in op.input_names()):
            continue
        if any(n in rw.protected or n in persist for n in out_names):
            continue
        key = (seg_of[i], op.type, attrs_key,
               tuple((slot, tuple(resolve(n) for n in names))
                     for slot, names in sorted(op.inputs.items())))
        first = seen.get(key)
        if first is None:
            seen[key] = i
            continue
        first_op = ops[first]
        slots_match = (
            sorted(op.outputs) == sorted(first_op.outputs)
            and all(len(op.outputs[s]) == len(first_op.outputs[s])
                    for s in op.outputs))
        if not slots_match:
            continue
        for slot, names in op.outputs.items():
            for n, fn_ in zip(names, first_op.outputs[slot]):
                if n != fn_:
                    rename[n] = fn_
        remove.add(i)
        folded_into.setdefault(first, []).append(i)
    removed = rw.apply(remove=remove, rename=rename,
                       folded_into=folded_into)
    return {"deduped": removed}


def _identity_reshape(op, specs):
    if op.inputs.get("ShapeTensor"):
        # the kernel prefers the RUNTIME ShapeTensor value over the
        # static attr — the attr alone proves nothing
        return False
    x = op.inputs.get("X", [None])[0]
    spec = specs.get(x)
    if spec is None or spec.shape is None:
        return False
    xs = tuple(spec.shape)
    target = op.attrs.get("shape")
    if not target or len(target) != len(xs):
        return False
    wild = 0
    for i, t in enumerate(target):
        if t == 0:
            continue
        if t == -1:
            wild += 1
            continue
        if xs[i] is None or int(xs[i]) != int(t):
            return False
    # with every explicit dim matching, a single -1 must resolve to the
    # input's own dim (element-count conservation) — identity even when
    # that dim is the symbolic batch
    return wild <= 1


def _identity_transpose(op, specs):
    perm = op.attrs.get("axis")
    return perm is not None and list(perm) == sorted(range(len(perm)))


def _identity_cast(op, specs):
    x = op.inputs.get("X", [None])[0]
    spec = specs.get(x)
    if spec is None or spec.dtype is None:
        return False
    out_dtype = op.attrs.get("out_dtype") or op.attrs.get("dtype")
    return out_dtype is not None and str(spec.dtype) == str(out_dtype)


def _identity_scale(op, specs):
    return (float(op.attrs.get("scale", 1.0)) == 1.0
            and float(op.attrs.get("bias", 0.0)) == 0.0)


def _identity_dropout(op, specs):
    if not op.attrs.get("is_test"):
        return False
    impl = op.attrs.get("dropout_implementation", "downgrade_in_infer")
    return (impl == "upscale_in_train"
            or float(op.attrs.get("dropout_prob", 0.5)) == 0.0)


def _identity_pad(op, specs):
    pads = op.attrs.get("paddings")
    return pads is not None and all(int(p) == 0 for p in pads)


# op type -> (predicate, passthrough input slot, primary output slot)
_IDENTITY_RULES = {
    "reshape": (_identity_reshape, "X", "Out"),
    "reshape2": (_identity_reshape, "X", "Out"),
    "transpose": (_identity_transpose, "X", "Out"),
    "transpose2": (_identity_transpose, "X", "Out"),
    "cast": (_identity_cast, "X", "Out"),
    "scale": (_identity_scale, "X", "Out"),
    "dropout": (_identity_dropout, "X", "Out"),
    "pad": (_identity_pad, "X", "Out"),
    "assign": (lambda op, specs: True, "X", "Out"),
}


def identity_elim(rw):
    """Remove ops that provably compute the identity of their input —
    no-op reshapes/transposes/casts, scale(1.0, +0.0), test-mode
    upscale dropout, zero pads, bare assigns — rewiring readers to the
    input (the scale/elementwise chain-collapse half of the reference's
    inference passes).  Secondary outputs (XShape markers, dropout
    masks) must be unconsumed and unfetched."""
    ops = rw.ops
    specs = rw.specs()
    persist = rw.persist_names()
    consumers = rw.consumers()
    producer = rw.producers()
    multi = rw.multi_written()
    rename = {}
    remove = set()
    folded_into = {}
    for i, op in enumerate(ops):
        rule = _IDENTITY_RULES.get(op.type)
        if rule is None:
            continue
        pred, in_slot, out_slot = rule
        in_names = op.inputs.get(in_slot) or []
        out_names = op.outputs.get(out_slot) or []
        if len(in_names) != 1 or len(out_names) != 1:
            continue
        out = out_names[0]
        if out in rw.protected or out in persist or out in rename:
            continue
        # WAW barriers: aliasing `out` to a name that is rewritten
        # later would hand post-rewrite readers the WRONG write, and an
        # `out` that is itself rewritten can't be renamed away
        if out in multi or in_names[0] in multi:
            continue
        side_outs = [n for slot, names in op.outputs.items()
                     if slot != out_slot for n in names]
        if any(consumers.get(n) or n in rw.protected or n in persist
               for n in side_outs):
            continue
        if not pred(op, specs):
            continue
        rename[out] = in_names[0]
        remove.add(i)
        src = producer.get(in_names[0])
        if src is not None and src not in remove:
            folded_into.setdefault(src, []).append(i)
    removed = rw.apply(remove=remove, rename=rename,
                       folded_into=folded_into)
    return {"eliminated": removed}


def dce(rw):
    """Dead-op + dead-var elimination seeded from the fetch set — the
    executable twin of the PT201/PT202 lints, sharing their liveness
    fact (analysis.facts.live_op_mask) so "lint says dead" and "DCE
    deletes" can never diverge."""
    ops = rw.ops
    keep = facts.live_op_mask(
        ops, rw.sections(), rw.fetch_names, rw.persist_names(),
        control_flow_types=facts.control_flow_types(),
        side_effect_types=_SIDE_EFFECT_TYPES,
        extra_roots=rw.protected)
    removed = rw.apply(remove={i for i, k in enumerate(keep) if not k})
    dead_vars = rw.sweep_dead_vars()
    return {"dead_ops": removed, "dead_vars": dead_vars}
