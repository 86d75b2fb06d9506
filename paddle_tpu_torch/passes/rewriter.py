"""ProgramRewriter — the mutation substrate every graph pass shares.

Port of paddle_tpu/passes/rewriter.py (pure Python), shared by the
fusion tier (`fuse.py`) and the structural passes (`common.py`,
`fold.py`).

A pass never edits ``block.ops`` directly: it computes a plan (ops to
remove, output names to alias, ops to insert) against the CURRENT op
list and hands it to :meth:`ProgramRewriter.apply`, which performs the
whole rewrite as one transaction — downstream input names rewired
through the alias map, ``BackwardSection`` positions remapped, the
``folded_from`` provenance annotations attached, and ``Program._bump()``
called once so the executor's run-plan / compiled-step / lint caches
all invalidate together.

Safety rails (shared by every pass):

- names in ``protected`` (fetch targets, control-flow sub-block
  references) are never aliased away;
- ops that are stateful, rng-consuming, side-effecting, control-flow,
  or dynamic-shaped are never treated as pure;
- variables that are persistable or feed data are never constants.
"""

import time

import numpy as np

from ..analysis import facts
from ..ops.registry import _OPS

__all__ = ["ProgramRewriter", "is_pure", "canonical_attrs"]

_SIDE_EFFECT_TYPES = facts.SIDE_EFFECT_TYPES
# data-dependent output shapes: never fold/evaluate at optimize time
_DYNAMIC_TYPES = frozenset(("where_index", "masked_select", "unique",
                            "shrink_memory", "lod_tensor_to_array",
                            "array_to_lod_tensor"))


def is_pure(op):
    """True when the op is a pure function of its inputs/attrs: safe to
    deduplicate (CSE) or evaluate at optimize time (const fold)."""
    if op.type in _SIDE_EFFECT_TYPES or op.type in _DYNAMIC_TYPES \
            or op.type in facts.control_flow_types():
        return False
    opdef = _OPS.get(op.type)
    if opdef is None or opdef.stateful or opdef.needs_rng:
        return False
    # block-valued attrs mean hidden sub-graph semantics
    from ..framework.program import Block

    return not any(isinstance(v, Block) for v in op.attrs.values())


def _canon(v):
    if isinstance(v, np.ndarray):
        return ("__nd__", v.shape, str(v.dtype), v.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _canon(x)) for k, x in v.items()))
    return v


def canonical_attrs(op):
    """Hashable canonical form of an op's attrs (None when an attr
    resists canonicalization — the op then never CSEs)."""
    try:
        return tuple(sorted((k, _canon(v)) for k, v in op.attrs.items()
                            if not k.startswith("_")))
    except TypeError:
        return None


class ProgramRewriter:
    """One optimization run over (a clone of) a Program."""

    def __init__(self, program, fetch_names=(), feed_names=(),
                 params=None):
        self.program = program
        self.block = program.global_block()
        self.fetch_names = tuple(fetch_names)
        self.feed_names = tuple(feed_names)
        # param VALUES (inference-folding mode): name -> ndarray.
        # Fold passes read and REPLACE entries; None disables the
        # value-based folds entirely.
        self.params = params
        self.protected = (facts.protected_names(program)
                          | set(self.fetch_names))
        # BackwardSection references are consumers no consumer map can
        # see: the executor resolves loss/checkpoint names by NAME at
        # trace time, so their producers must neither vanish nor be
        # renamed (param names are persistables, guarded already)
        for bs in program.backward_sections:
            self.protected.add(bs.loss_name)
            self.protected.update(bs.checkpoint_names)
        self._specs = None
        # op-identity -> tuple of source scope descriptors: how a
        # rewritten op remembers the ops it absorbed (op-profile
        # attribution maps a fused op back through this)
        self._source_scope = {}

    # -- shared facts ---------------------------------------------------
    @property
    def ops(self):
        return self.block.ops

    def sections(self):
        if self.program._is_test:
            return []
        return list(self.program.backward_sections)

    def specs(self):
        """(shape, dtype) facts for rewrite legality, recomputed after
        every apply() (op removal can only LOSE information, so a stale
        read would be unsound in the other direction)."""
        if self._specs is None:
            self._specs = facts.infer_specs(self.program,
                                            feed_names=self.feed_names)
        return self._specs

    def persist_names(self):
        return {v.name for v in self.program.list_vars() if v.persistable}

    def consumers(self):
        """name -> [op index] over the global block (current op list)."""
        cons = {}
        for i, op in enumerate(self.ops):
            for n in op.input_names():
                cons.setdefault(n, []).append(i)
        return cons

    def producers(self):
        """name -> FIRST producing op index (current op list)."""
        prod = {}
        for i, op in enumerate(self.ops):
            for n in op.output_names():
                prod.setdefault(n, i)
        return prod

    def multi_written(self):
        """Names with more than one DEFINITION — WAW barriers.
        Rewrites reason about NAMES, not SSA values: a reader after the
        second write of `a` sees a different value than a reader before
        it, so deduping, aliasing-away, or const-evaluating anything
        that reads or writes such a name would silently pick the wrong
        write.  Names holding a value BEFORE the program runs
        (persistables, feed/data vars) count as already-defined: their
        FIRST in-program write — an optimizer update, a moving-stat
        refresh — is already the second definition, and a pre-update
        read must not be rewired across it.  Every pass treats these
        names as untouchable.  (facts.multi_written_names is the
        single definition; the numerics analyzer's churn guards share
        it.)"""
        pre = set(self.feed_names)
        for v in self.program.list_vars():
            if v.persistable or v.is_data:
                pre.add(v.name)
        return facts.multi_written_names(self.ops, pre)

    def source_scopes(self, op):
        return self._source_scope.get(id(op), ())

    def all_scope_names(self):
        """The attribution scopes each op would get TODAY —
        recorded as provenance before a rewrite moves or removes
        them."""
        from ..framework.executor import op_scopes

        return op_scopes(self.ops, self.sections())

    # -- the transaction ------------------------------------------------
    def apply(self, remove=(), rename=None, folded_into=None):
        """Apply one pass's plan:

        remove:       op indices (current list) to delete.
        rename:       {old_name: new_name} — downstream reads of
                      old_name rewire to new_name (applied transitively;
                      protected names are never renamed).
        folded_into:  {surviving_op_index: [removed_op_index, ...]} —
                      provenance: the surviving op absorbs the removed
                      ops' scope names into its ``folded_from``.

        Returns the number of ops removed.  No-op plans skip the bump.
        """
        remove = set(remove)
        rename = dict(rename or {})
        for k in list(rename):
            if k in self.protected:
                del rename[k]
        if not remove and not rename:
            return 0

        def resolve(n):
            seen = set()
            while n in rename and n not in seen:
                seen.add(n)
                n = rename[n]
            return n

        scopes = self.all_scope_names()
        for keep_i, gone in (folded_into or {}).items():
            op = self.ops[keep_i]
            prior = self._source_scope.get(id(op), ())
            extra = tuple(scopes[g] for g in gone)
            self._source_scope[id(op)] = prior + extra
            op.folded_from = self._source_scope[id(op)]

        old_ops = self.ops
        new_ops = []
        kept_before = []              # kept-op count at each old index
        kept = 0
        for i, op in enumerate(old_ops):
            kept_before.append(kept)
            if i in remove:
                continue
            if rename:
                op.inputs = {slot: [resolve(n) for n in names]
                             for slot, names in op.inputs.items()}
            new_ops.append(op)
            kept += 1
        kept_before.append(kept)
        self.block.ops = new_ops
        for bs in self.program.backward_sections:
            bs.pos = kept_before[min(bs.pos, len(old_ops))]
            bs.loss_name = resolve(bs.loss_name)
            bs.checkpoint_names = [resolve(n)
                                   for n in bs.checkpoint_names]
        self._specs = None
        self.program._bump()
        return len(remove)

    def sweep_dead_vars(self):
        """PT202 analogue: drop global-block variable declarations that
        nothing touches any more (not persistable/data/parameter, not a
        grad slot, not read/written by any op in any block, not a
        fetch/feed/section name, not protected)."""
        touched = set(self.fetch_names) | set(self.feed_names) \
            | self.protected
        for b in self.program.blocks:
            for op in b.ops:
                touched.update(op.input_names())
                touched.update(op.output_names())
        for bs in self.program.backward_sections:
            touched.add(bs.loss_name)
            touched.update(bs.param_names)
            touched.update(facts.grad_name(p) for p in bs.param_names)
            touched.update(bs.checkpoint_names)
        dead = [n for n, v in self.block.vars.items()
                if n not in touched and not v.persistable
                and not v.is_data and not v.is_parameter
                and not n.endswith("@GRAD")]
        for n in dead:
            del self.block.vars[n]
        if dead:
            self.program._bump()
        return len(dead)

    def timed(self, fn):
        """Run one pass callable, returning its stats dict extended
        with the before/after op counts and wall time the compile
        ledger records per pass."""
        before = len(self.ops)
        t0 = time.perf_counter()
        stats = fn(self) or {}
        wall_ms = (time.perf_counter() - t0) * 1e3
        stats.update(before_ops=before, after_ops=len(self.ops),
                     wall_ms=round(wall_ms, 3))
        return stats

    def make_constant(self, name, value):
        """Turn `name` into an initialized persistable: the var flips
        persistable and the concrete value lands in
        ``program._folded_constants`` (the Predictor serves it as a
        parameter; io/serialization round-trips it)."""
        var = self.block.vars.get(name)
        if var is None:
            var = self.block.create_var(name=name,
                                        shape=np.shape(value) or None,
                                        dtype=str(value.dtype))
        var.persistable = True
        var.stop_gradient = True
        if var.shape is None:
            var.shape = tuple(np.shape(value))
        fc = getattr(self.program, "_folded_constants", None)
        if fc is None:
            fc = self.program._folded_constants = {}
        fc[name] = np.asarray(value)
        self.program._bump()
