"""Static sharding analyzer — partition rules, spec propagation, costs
(port of paddle_tpu/analysis/sharding.py).

The GSPMD tier's static half: everything a rule-driven
model-parallel run can get wrong is knowable BEFORE any trace — a rule
set that misses a parameter, a replicated giant embedding, a reshard on
a hot edge, a sharded contraction whose pending psum never lands.  This
module answers those questions from the recorded Program alone:

1. **Partition-rule engine** — an ordered list of ``(regex,
   partition-spec)`` rules matched over the program's param / optimizer
   / persistable vars, first-match-wins (the ``match_partition_rules``
   idiom of the pjit training stacks); :func:`match_report` names which
   rule claimed each var and which vars fell through to replicated.
2. **Spec propagation** — per-op-family propagation rules layered on
   the same shape walk the verifier uses (``facts.infer_specs``):
   matmul contracts a sharded axis into a *pending-psum* marker,
   elementwise joins operand specs, reshape/transpose permute them,
   conv/BN/reduce/concat/split each get rules, and unknown families
   degrade to replicated with a note — never a false error.
3. **Diagnostics** — the PT3xx sharding lints (diagnostics.py table):
   PT301 rule-miss, PT302 replicated giant param, PT303 hot-edge
   reshard, PT304 divisibility, PT305 conflicting join, PT306 missing
   pending psum.
4. **Cost models** — a static collective-cost table (bytes x mesh axis
   per implied all-reduce / all-gather / reshard edge, with the dp
   gradient sync planned through the SAME ``transpiler.collective``
   bucket planner the runtime emission uses, so predicted and executed
   collective counts/bytes agree exactly), and a static per-shard
   peak-memory estimate over ``facts`` liveness (a pre-trace analogue
   of monitor.mem_profile's per-scope table).

Everything here is pure analysis over ProgramDesc: importable and
runnable without a device or a run.  The records (`to_record`, `render`,
the collective and per-var tables, the diagnostics) are the reference's
for the same Program.  Two things are the port's own: `local_slice`
(a rank's shard of a global tensor, where the reference hands a
`PartitionSpec` to its compiler) and `ShardingPlan.op_records`, the
per-op consumption record the executor's runtime tier follows
(`_OpTrace`).
"""

import json
import math
import re

from . import facts
from . import shape_rules as sr
from .diagnostics import Diagnostic, LintResult

__all__ = [
    "MeshSpec", "ShardSpec", "REPLICATED", "PartitionRules",
    "match_report", "propagate", "analyze", "ShardingAnalysis",
    "attach", "attached", "load_rules_file",
    "ShardingPlan", "lower", "OpRecord", "local_slice",
]

_DTYPE_BYTES = {
    "bool": 1, "int8": 1, "uint8": 1, "float16": 2, "bfloat16": 2,
    "int16": 2, "float32": 4, "int32": 4, "float64": 8, "int64": 8,
}


def _itemsize(dtype):
    return _DTYPE_BYTES.get(dtype, 4)


class MeshSpec:
    """A named logical device mesh: ordered ``{axis_name: size}``.

    Purely descriptive — a mesh without devices.  ``{"dp": 2}`` is the executor's data-parallel
    mesh; ``{"dp": 2, "mp": 4}`` a 2D data x tensor mesh."""

    def __init__(self, axes):
        if isinstance(axes, MeshSpec):
            axes = dict(axes.axes)
        self.axes = {str(k): int(v) for k, v in dict(axes).items()}
        for name, size in self.axes.items():
            if size < 1:
                raise ValueError(f"mesh axis '{name}' has size {size}")

    def size(self, axis):
        return self.axes.get(axis, 1)

    @property
    def total(self):
        return math.prod(self.axes.values()) if self.axes else 1

    def __contains__(self, axis):
        return axis in self.axes

    def __eq__(self, other):
        return isinstance(other, MeshSpec) and self.axes == other.axes

    def __repr__(self):
        inner = ", ".join(f"{k}={v}" for k, v in self.axes.items())
        return f"MeshSpec({inner})"

    def to_dict(self):
        return dict(self.axes)


class ShardSpec:
    """Abstract per-variable sharding: one mesh-axis name (or None) per
    tensor dim, plus a set of axes the value is a *pending partial sum*
    over (a sharded contraction happened; an all-reduce is owed).

    ``dims=None`` means replicated at any rank (the lattice bottom for
    sharding, matching ``shape_rules.OPAQUE`` for shapes)."""

    __slots__ = ("dims", "partial")

    def __init__(self, dims=None, partial=()):
        if dims is not None:
            dims = tuple(None if d in (None, "", "-") else str(d)
                         for d in dims)
        self.dims = dims
        self.partial = frozenset(partial)

    # -- predicates -----------------------------------------------------

    @property
    def is_replicated(self):
        return (not self.partial
                and (self.dims is None
                     or all(d is None for d in self.dims)))

    def sharded_axes(self):
        if self.dims is None:
            return []
        return [d for d in self.dims if d is not None]

    def axis_of(self, dim):
        if self.dims is None or dim >= len(self.dims) or dim < 0:
            return None
        return self.dims[dim]

    # -- construction helpers ------------------------------------------

    def at_rank(self, rank):
        """This spec aligned to `rank` dims.  PartitionSpec semantics:
        a spec names LEADING dims, so padding is replicated on the
        RIGHT (``P('dp')`` on a rank-2 array shards dim 0); truncation
        keeps the leading dims."""
        if rank is None:
            return self
        dims = self.dims or ()
        if len(dims) < rank:
            dims = tuple(dims) + (None,) * (rank - len(dims))
        elif len(dims) > rank:
            dims = tuple(dims[:rank])
        return ShardSpec(dims, self.partial)

    def with_partial(self, axes):
        return ShardSpec(self.dims, self.partial | frozenset(axes))

    def clear_partial(self):
        return ShardSpec(self.dims, ())

    def replace_dim(self, dim, axis):
        dims = list(self.dims or ())
        while len(dims) <= dim:
            dims.append(None)
        dims[dim] = axis
        return ShardSpec(dims, self.partial)

    # -- arithmetic -----------------------------------------------------

    def shard_factor(self, mesh):
        """Product of the mesh-axis sizes this spec shards over (how
        many ways one shard divides the full tensor)."""
        f = 1
        for a in self.sharded_axes():
            f *= mesh.size(a)
        return f

    def __eq__(self, other):
        if not isinstance(other, ShardSpec):
            return NotImplemented
        a = tuple(d for d in (self.dims or ()) )
        b = tuple(d for d in (other.dims or ()))
        # replicated padding is identity: [None, 'mp'] == ['mp'] is
        # False (different dims), but all-None == None IS equal
        if self.dims is None or other.dims is None:
            return (self.is_replicated and other.is_replicated
                    and self.partial == other.partial)
        return a == b and self.partial == other.partial

    def __hash__(self):
        # canonical form: every all-None dims tuple hashes like
        # dims=None, matching __eq__'s replicated-equality
        dims = self.dims
        if dims is not None and all(d is None for d in dims):
            dims = None
        return hash((dims, self.partial))

    def render(self):
        if self.dims is None:
            body = "*"
        else:
            body = ", ".join(d if d is not None else "-"
                             for d in self.dims) or "-"
        tail = ""
        if self.partial:
            tail = " partial(" + ",".join(sorted(self.partial)) + ")"
        return f"[{body}]{tail}"

    def __repr__(self):
        return f"ShardSpec{self.render()}"



REPLICATED = ShardSpec(None)


def shard_bytes(var_spec, spec, mesh, default_dim=None):
    """Per-shard byte size of one var under `spec`, or None when any
    dim is statically unknown and no `default_dim` substitute is
    given."""
    if var_spec is None or var_spec.shape is None:
        return None
    n = 1
    for d in var_spec.shape:
        if d is None:
            if default_dim is None:
                return None
            d = default_dim
        n *= d
    return (n // max(spec.shard_factor(mesh), 1)) \
        * _itemsize(var_spec.dtype)


def full_bytes(var_spec, default_dim=None):
    return shard_bytes(var_spec, REPLICATED, MeshSpec({}),
                       default_dim=default_dim)


# ---------------------------------------------------------------------------
# partition-rule engine
# ---------------------------------------------------------------------------

class PartitionRules:
    """Ordered ``(regex, ShardSpec)`` rules over a mesh — the
    ``match_partition_rules`` contract: rules are tried in order
    against each var name with ``re.search``, FIRST match wins, and a
    var no rule claims falls through to replicated (reported, and for
    trainable params linted as PT301)."""

    def __init__(self, rules, mesh, data_axis="dp"):
        self.mesh = mesh if isinstance(mesh, MeshSpec) else MeshSpec(mesh)
        self.rules = []
        for pattern, spec in rules:
            if not isinstance(spec, ShardSpec):
                spec = ShardSpec(spec)
            for a in list(spec.sharded_axes()) + list(spec.partial):
                if a not in self.mesh:
                    raise ValueError(
                        f"rule {pattern!r} names mesh axis '{a}' not in "
                        f"{self.mesh!r}")
            self.rules.append((str(pattern), re.compile(str(pattern)),
                               spec))
        # feed/data vars shard their leading (batch) dim over this axis
        # when the mesh has it — the executor's dp convention
        self.data_axis = data_axis if data_axis in self.mesh else None

    def match(self, name):
        """(rule_index, pattern, ShardSpec) of the first matching rule,
        or None on fallthrough."""
        for i, (pattern, cre, spec) in enumerate(self.rules):
            if cre.search(name) is not None:
                return i, pattern, spec
        return None

    def fingerprint(self):
        """Stable hashable identity for cache keys (the verifier's
        cached_check must re-lint when the rule set changes)."""
        return (tuple((p, s.dims, s.partial) for p, _, s in self.rules),
                tuple(sorted(self.mesh.axes.items())), self.data_axis)

    def to_dict(self):
        return {
            "mesh": self.mesh.to_dict(),
            "data_axis": self.data_axis,
            "rules": [[p, list(s.dims or [])] for p, _, s in self.rules],
        }

    @staticmethod
    def from_dict(doc):
        return PartitionRules(
            [(p, ShardSpec(d)) for p, d in doc.get("rules", ())],
            MeshSpec(doc.get("mesh", {})),
            data_axis=doc.get("data_axis", "dp"))

    def __repr__(self):
        return (f"PartitionRules({len(self.rules)} rules, "
                f"{self.mesh!r})")


def load_rules_file(path):
    """Parse a rule file: JSON ``{"mesh": {...}, "rules": [[regex,
    [axis|null, ...]], ...], "data_axis": "dp"}`` — the format
    ``tools/program_lint.py --sharding-rules`` reads and the README
    documents."""
    with open(path) as f:
        doc = json.load(f)
    return PartitionRules.from_dict(doc)


def attach(program, rules):
    """Attach a rule set to a Program so the executor's cached verifier
    pass lints sharding alongside everything else
    (``CompiledProgram.with_sharding_rules`` lands here).  Attachment
    is NOT a graph mutation — it doesn't bump the program version; the
    lint cache keys on the rule fingerprint instead."""
    program._sharding_rules = rules
    return program


def attached(program):
    return getattr(program, "_sharding_rules", None)


def _var_classes(program):
    """{name: class} over every declared var: "param" (trainable
    Parameter), "optimizer" (non-parameter persistable — moments,
    stats), "persist" (frozen parameters and other persistables),
    "data" (feed vars)."""
    out = {}
    for b in program.blocks:
        for n, v in b.vars.items():
            if n in out:
                continue
            if getattr(v, "is_parameter", False):
                out[n] = ("param" if getattr(v, "trainable", True)
                          else "persist")
            elif v.persistable:
                out[n] = "optimizer"
            elif v.is_data:
                out[n] = "data"
    return out


def match_report(program, rules, classes=None):
    """Apply the rule set over the program's param/optimizer/persist
    (and data) vars.  Returns::

        {"claimed":   {var: {"rule", "pattern", "spec", "class"}},
         "fallthrough": [var, ...],          # replicated by default
         "unmatched_rules": [{"pattern", "suggestion"}, ...],
         "specs":     {var: ShardSpec}}

    ``unmatched_rules`` lists rules that claimed NOTHING — a typo'd
    rule regex gets the same difflib did-you-mean treatment a typo'd
    ``Block.var()`` name does.  ``classes`` lets a caller that already
    ran :func:`_var_classes` share the walk."""
    from ..framework.program import did_you_mean

    if classes is None:
        classes = _var_classes(program)
    claimed, fallthrough, specs = {}, [], {}
    hit_rules = set()
    for name, cls in sorted(classes.items()):
        if cls == "data":
            # feed vars are not part of the param/optimizer pytree the
            # rules partition; they shard their leading (batch) dim
            # over the mesh's data axis — the executor's dp convention
            specs[name] = (ShardSpec((rules.data_axis,))
                           if rules.data_axis is not None
                           else REPLICATED)
            continue
        m = rules.match(name)
        if m is not None:
            idx, pattern, spec = m
            hit_rules.add(idx)
            var = None
            for b in program.blocks:
                var = b.vars.get(name)
                if var is not None:
                    break
            numel = facts.var_spec(var).numel()
            if numel is not None and numel <= 1:
                # "don't partition scalar values" (the
                # match_partition_rules contract): a substring-matched
                # beta-pow/step accumulator stays replicated instead
                # of tripping PT304
                spec = REPLICATED
            claimed[name] = {"rule": idx, "pattern": pattern,
                             "spec": spec.render(), "class": cls}
            specs[name] = spec
            continue
        specs[name] = REPLICATED
        fallthrough.append(name)
    unmatched = []
    for i, (pattern, _cre, _spec) in enumerate(rules.rules):
        if i in hit_rules:
            continue
        # strip the regex metacharacters for the fuzzy probe: the
        # candidates are literal var names
        literal = re.sub(r"[\\^$.|?*+()\[\]{}]", "", pattern)
        unmatched.append({
            "pattern": pattern,
            "suggestion": did_you_mean(literal, classes) or "",
        })
    return {"claimed": claimed, "fallthrough": fallthrough,
            "unmatched_rules": unmatched, "specs": specs}


# ---------------------------------------------------------------------------
# spec propagation
# ---------------------------------------------------------------------------

def _scope_names(ops, sections):
    """The executor's op_scopes naming formula ({section}/{op_type}_{i}
    — executor.op_scopes), restated here so the analyzer stays
    importable without the executor.  Same strings by construction; the
    conformance tests pin it."""
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


class _Ctx:
    """Propagation state: the evolving {var: ShardSpec} env plus the
    two products every handler feeds — the implied-collective list and
    the PT3xx diagnostics."""

    def __init__(self, mesh, shapes, scopes, fwd_limit, default_dim):
        self.mesh = mesh
        self.shapes = shapes          # {name: sr.VarSpec}
        self.scopes = scopes          # [scope name per op index]
        self.fwd_limit = fwd_limit    # ops before this index are fwd
        self.default_dim = default_dim
        self.env = {}                 # {name: ShardSpec}
        self.collectives = []         # implied collective records
        self.diags = []               # Diagnostic list
        self.notes = []               # non-coded degradation notes
        self.classes = None           # {name: class} (propagate fills)
        # the port's per-op consumption log: (op index, kind, var, src,
        # dst) for every resolved partial and every reshard, in order
        self.events = []

    def hot(self, i):
        return i < self.fwd_limit

    def bytes_of(self, name, spec):
        return shard_bytes(self.shapes.get(name), spec, self.mesh,
                           default_dim=self.default_dim)

    def add_collective(self, kind, axes, name, bytes_, op_index,
                       scope=None):
        self.collectives.append({
            "kind": kind,
            "axes": sorted(axes) if not isinstance(axes, str)
            else [axes],
            "var": name,
            "bytes": int(bytes_ or 0),
            "op_index": op_index,
            "scope": scope if scope is not None
            else (self.scopes[op_index]
                  if 0 <= op_index < len(self.scopes) else "main"),
        })

    def diag(self, code, message, op=None, op_index=None, var=None):
        self.diags.append(Diagnostic(
            code, message,
            op_type=None if op is None else op.type,
            op_index=op_index,
            callsite=None if op is None
            else getattr(op, "callsite", None),
            var=var))

    def resolve_partial(self, name, op, i):
        """A pending-psum value is being consumed: imply the owed
        all-reduce HERE (what GSPMD would insert), clear the marker on
        the var so later consumers see the resolved value, and return
        the cleared spec."""
        spec = self.env.get(name, REPLICATED)
        if not spec.partial:
            return spec
        resolved = spec.clear_partial()
        self.add_collective("all_reduce", spec.partial, name,
                            self.bytes_of(name, resolved), i)
        self.events.append((i, "resolve", name, spec, resolved))
        self.env[name] = resolved
        return resolved

    def reshard(self, name, src, dst, op, i, why=""):
        """Record the implied spec change src -> dst on one edge.
        replicated -> sharded is a free local slice (no collective);
        sharded -> replicated implies an all-gather; sharded ->
        differently-sharded an all-to-all.  A costly reshard on a
        fwd edge of a train program is the PT303 hot-edge lint."""
        if src == dst:
            return dst
        self.events.append((i, "reshard", name, src, dst))
        src_ax = set(src.sharded_axes())
        dst_ax = set(dst.sharded_axes())
        gone = src_ax - dst_ax
        if not src_ax or (src.dims == dst.dims):
            return dst                # pure slice or partial change
        if gone:
            # axes removed: an all-gather over them (partial gathers
            # included — a ['dp','mp'] -> ['dp', -] edge gathers mp
            # at the per-dp-shard size, NOT the per-shard source size)
            kind = "all_gather"
            bytes_ = self.bytes_of(name, dst)      # gathered size
        elif src.dims != dst.dims:
            # same axis set, different placement: an all-to-all
            kind = "all_to_all"
            bytes_ = self.bytes_of(name, src)      # per-shard traffic
        else:
            return dst
        self.add_collective(kind, gone or src_ax, name, bytes_, i)
        if self.hot(i):
            self.diag(
                "PT303",
                f"resharding '{name}' {src.render()} -> {dst.render()}"
                f" on a forward (hot) edge{': ' + why if why else ''} — "
                f"this {kind} runs in the forward AND its mirrored "
                f"backward every step",
                op=op, op_index=i, var=name)
        return dst

    def degrade(self, op, i, names, why):
        """Unknown/unmodeled family: sharded inputs are gathered, the
        op computes replicated.  A note, never a false error."""
        for n in names:
            spec = self.env.get(n)
            if spec is not None and not spec.is_replicated:
                self.reshard(n, spec, REPLICATED, op, i, why=why)
                self.env[n] = REPLICATED
        self.notes.append(
            f"op '{op.type}' #{i}: {why}; outputs treated replicated")


def _aligned(spec, rank):
    return spec.at_rank(rank) if rank is not None else spec


def _broadcast_dims(ctx, name, out_rank):
    """An operand's dims list aligned to the JOIN's rank: first
    right-padded to the operand's OWN rank (PartitionSpec semantics),
    then left-padded for the numpy broadcast (a rank-1 bias aligns to
    the TRAILING dim of a rank-2 activation)."""
    r = _rank(ctx, name)
    spec = ctx.env.get(name, REPLICATED)
    dims = list((spec.at_rank(r) if r is not None else spec).dims
                or ())
    if out_rank is None:
        return dims
    if len(dims) < out_rank:
        dims = [None] * (out_rank - len(dims)) + dims
    elif len(dims) > out_rank:
        dims = dims[len(dims) - out_rank:]
    return dims


def _merge_dims_pair(dims_a, dims_b):
    """Per-dim merge of two aligned dims lists: the sharded side wins
    over replicated; two DIFFERENT axes on one dim, or one axis
    claimed by two dims of the merge result, is a conflict (first
    operand's layout kept).  Returns ``(dims, conflict)`` with
    conflict ``(dim, axis_a, axis_b)`` or None."""
    dims = []
    conflict = None
    for d in range(max(len(dims_a), len(dims_b))):
        a = dims_a[d] if d < len(dims_a) else None
        b = dims_b[d] if d < len(dims_b) else None
        if a is not None and b is not None and a != b:
            conflict = (d, a, b)
            dims.append(a)
        else:
            dims.append(a if a is not None else b)
    # one mesh axis may shard only one dim of the join result
    seen = {}
    for d, a in enumerate(dims):
        if a is None:
            continue
        if a in seen:
            conflict = conflict or (d, a, a)
            dims[d] = None
        seen[a] = d
    return dims, conflict


def _join_elementwise(ctx, op, i, x_name, y_name, out_rank):
    """Broadcast join of two operand specs; a conflict is the PT305
    lint, resolved by resharding Y to X's layout."""
    xs = ctx.resolve_partial(x_name, op, i) if x_name else REPLICATED
    ys = ctx.resolve_partial(y_name, op, i) if y_name else REPLICATED
    xa = ShardSpec(_broadcast_dims(ctx, x_name, out_rank)) \
        if x_name else REPLICATED
    ya = ShardSpec(_broadcast_dims(ctx, y_name, out_rank)) \
        if y_name else REPLICATED
    if out_rank is None:
        if xa.is_replicated and ya.is_replicated:
            return REPLICATED
        return xa if not xa.is_replicated else ya
    dims, conflict = _merge_dims_pair(list(xa.dims or ()),
                                      list(ya.dims or ()))
    out = ShardSpec(dims)
    if conflict is not None:
        d, a, b = conflict
        ctx.diag(
            "PT305",
            f"conflicting sharding join at '{op.type}': operands "
            f"'{x_name}' {xs.render()} and '{y_name}' {ys.render()} "
            f"disagree on dim {d} (axes {a!r} vs {b!r}); resolved to "
            f"{out.render()} with an implied reshard",
            op=op, op_index=i, var=y_name)
        if y_name:
            ctx.reshard(y_name, ys, out, op, i,
                        why="conflicting-join resolution")
    return out


# op families whose single output keeps its single input's layout
_PASS_THROUGH = frozenset((
    "relu", "relu6", "sigmoid", "tanh", "exp", "log", "log2", "log10",
    "log1p", "sqrt", "rsqrt", "square", "abs", "ceil", "floor", "round",
    "reciprocal", "sign", "sin", "cos", "tan", "sinh", "cosh", "asin",
    "acos", "atan", "erf", "gelu", "elu", "selu", "silu", "swish",
    "mish", "softplus", "softsign", "softshrink", "hard_shrink",
    "hard_sigmoid", "hard_swish", "leaky_relu", "logsigmoid",
    "tanh_shrink", "thresholded_relu", "prelu", "scale", "pow", "clip",
    "logical_not", "assign", "label_smooth", "cast", "dropout",
))

_ELEMENTWISE = frozenset((
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
    "maximum", "minimum", "equal", "not_equal", "less_than",
    "less_equal", "greater_than", "greater_equal", "logical_and",
    "logical_or", "logical_xor", "square_error_cost",
    "sigmoid_cross_entropy_with_logits",
))

_REDUCES = frozenset((
    "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "reduce_all", "reduce_any",
))


def _first(op, slot):
    names = op.inputs.get(slot) or ()
    return names[0] if names else None


def _rank(ctx, name):
    vs = ctx.shapes.get(name)
    if vs is None or vs.shape is None:
        return None
    return len(vs.shape)


def _dims_at(ctx, name, rank):
    spec = ctx.env.get(name, REPLICATED)
    return list(_aligned(spec, rank).dims or (None,) * (rank or 0))


def _bind_specs(ctx, op, mapping):
    """Write handler results to every output name; slots the handler
    didn't speak for are replicated (never an error)."""
    for slot, names in op.outputs.items():
        vals = mapping.get(slot)
        if isinstance(vals, ShardSpec):
            vals = [vals] * len(names)
        for j, n in enumerate(names):
            ctx.env[n] = (vals[j] if vals is not None and j < len(vals)
                          else REPLICATED)


def _dedupe_axes(dims, partial=()):
    """One mesh axis shards at most one dim; later duplicates drop to
    replicated (the join already diagnosed the conflict)."""
    seen = set(partial)
    out = []
    for d in dims:
        if d is not None and d in seen:
            out.append(None)
        else:
            out.append(d)
            if d is not None:
                seen.add(d)
    return out


def _map_dims(in_shape, out_shape, in_dims):
    """Carry sharded dims through a reshape by prefix-product factor
    alignment: a sharded input dim survives when it is preserved
    verbatim, or is the MAJOR dim of a split/merge group whose major
    output dim keeps its size divisible.  Returns the output dims list,
    or None when a sharded dim cannot be mapped (caller gathers).
    ``None`` sizes (symbolic batch) only match ``None``."""
    if in_shape is None or out_shape is None:
        return None if any(d is not None for d in in_dims) else \
            [None] * len(out_shape or ())
    out_dims = [None] * len(out_shape)
    ii = oi = 0
    while ii < len(in_shape) or oi < len(out_shape):
        di = in_shape[ii] if ii < len(in_shape) else 1
        do = out_shape[oi] if oi < len(out_shape) else 1
        if di is None or do is None:
            if di is None and do is None:
                if in_dims[ii] is not None:
                    out_dims[oi] = in_dims[ii]
                ii += 1
                oi += 1
                continue
            return None if any(d is not None for d in in_dims[ii:]) \
                else out_dims
        # close one factor group [ii, i1) x [oi, o1)
        pi, po = di, do
        i1, o1 = ii + 1, oi + 1
        while pi != po:
            if pi < po:
                if i1 >= len(in_shape) or in_shape[i1] is None:
                    return None
                pi *= in_shape[i1]
                i1 += 1
            else:
                if o1 >= len(out_shape) or out_shape[o1] is None:
                    return None
                po *= out_shape[o1]
                o1 += 1
        sharded = [j for j in range(ii, i1) if in_dims[j] is not None]
        if sharded:
            if sharded != [ii]:
                return None        # minor-dim shard: cannot map
            out_dims[oi] = in_dims[ii]
        ii, oi = i1, o1
    return out_dims


def _propagate_op(ctx, op, i):
    t = op.type
    attrs = op.attrs

    if t in _PASS_THROUGH:
        xn = _first(op, "X")
        spec = ctx.resolve_partial(xn, op, i) if xn else REPLICATED
        out = {"Out": spec}
        if "Mask" in op.outputs:
            out["Mask"] = spec.clear_partial()
        _bind_specs(ctx, op, out)
        return

    if t in ("softmax", "log_softmax", "sequence_softmax"):
        xn = _first(op, "X")
        spec = ctx.resolve_partial(xn, op, i)
        r = _rank(ctx, xn)
        if r:
            ax = attrs.get("axis", -1) % r
            if _dims_at(ctx, xn, r)[ax] is not None:
                dst = _aligned(spec, r).replace_dim(ax, None)
                spec = ctx.reshard(xn, spec, dst, op, i,
                                   why="softmax normalizes a sharded "
                                       "axis")
        _bind_specs(ctx, op, {"Out": spec})
        return

    if t in _ELEMENTWISE:
        xn, yn = _first(op, "X"), _first(op, "Y")
        out_name = (op.outputs.get("Out") or [None])[0]
        out = _join_elementwise(ctx, op, i, xn, yn,
                                _rank(ctx, out_name))
        _bind_specs(ctx, op, {"Out": out})
        return

    if t == "sum":
        # multi-operand elementwise accumulate (autodiff's gradient
        # accumulation op): fold operands through the SAME pairwise
        # merge binary elementwise uses, so a conflicting later
        # operand is a PT305, not silently dropped
        names = op.inputs.get("X") or []
        out_name = (op.outputs.get("Out") or [None])[0]
        r = _rank(ctx, out_name)
        acc = None
        acc_name = None
        for n in names:
            ctx.resolve_partial(n, op, i)
            dims = _broadcast_dims(ctx, n, r)
            if acc is None:
                acc, acc_name = dims, n
                continue
            merged, conflict = _merge_dims_pair(acc, dims)
            if conflict is not None:
                d, a, b = conflict
                ctx.diag(
                    "PT305",
                    f"conflicting sharding join at 'sum': operands "
                    f"'{acc_name}' and '{n}' disagree on dim {d} "
                    f"(axes {a!r} vs {b!r}); '{n}' is "
                    f"implied-resharded to "
                    f"{ShardSpec(merged).render()}",
                    op=op, op_index=i, var=n)
                ctx.reshard(n, ctx.env.get(n, REPLICATED),
                            ShardSpec(merged), op, i,
                            why="conflicting-join resolution")
            acc = merged
        _bind_specs(ctx, op, {"Out": ShardSpec(acc)
                              if acc is not None else REPLICATED})
        return

    if t in ("matmul", "quantized_matmul", "mul"):
        _h_matmul(ctx, op, i)
        return

    if t == "fc":
        _h_fc(ctx, op, i)
        return

    if t in ("conv2d", "depthwise_conv2d", "conv2d_fusion"):
        _h_conv(ctx, op, i)
        return

    if t == "pool2d":
        xn = _first(op, "X")
        spec = ctx.resolve_partial(xn, op, i)
        r = _rank(ctx, xn)
        if r == 4 and not attrs.get("global_pooling", False):
            nchw = attrs.get("data_format", "NCHW") in ("NCHW",
                                                        "AnyLayout")
            spatial = (2, 3) if nchw else (1, 2)
            dims = _dims_at(ctx, xn, 4)
            if any(dims[d] is not None for d in spatial):
                dst = ShardSpec([None if d in spatial else a
                                 for d, a in enumerate(dims)])
                spec = ctx.reshard(xn, spec, dst, op, i,
                                   why="windowed pooling over a "
                                       "sharded spatial dim")
        elif r == 4:
            # global pooling reduces the spatial dims entirely
            dims = _dims_at(ctx, xn, 4)
            nchw = attrs.get("data_format", "NCHW") in ("NCHW",
                                                        "AnyLayout")
            spatial = (2, 3) if nchw else (1, 2)
            part = {dims[d] for d in spatial if dims[d] is not None}
            spec = ShardSpec([None if d in spatial else a
                              for d, a in enumerate(dims)],
                             spec.partial | part)
        _bind_specs(ctx, op, {"Out": spec})
        return

    if t in ("batch_norm", "sync_batch_norm"):
        xn = _first(op, "X")
        spec = ctx.resolve_partial(xn, op, i)
        out = {"Y": spec}
        for oslot, islot in (("MeanOut", "Mean"),
                             ("VarianceOut", "Variance")):
            n = _first(op, islot)
            if n:
                out[oslot] = ctx.env.get(n, REPLICATED)
        _bind_specs(ctx, op, out)
        return

    if t == "layer_norm":
        xn = _first(op, "X")
        spec = ctx.resolve_partial(xn, op, i)
        r = _rank(ctx, xn)
        ax = attrs.get("begin_norm_axis", 1)
        if r:
            dims = _dims_at(ctx, xn, r)
            if any(dims[d] is not None for d in range(ax, r)):
                dst = ShardSpec(dims[:ax] + [None] * (r - ax))
                spec = ctx.reshard(xn, spec, dst, op, i,
                                   why="layer_norm normalizes sharded "
                                       "trailing dims")
        lead = ShardSpec((spec.dims or ())[:ax]) if spec.dims else \
            REPLICATED
        _bind_specs(ctx, op, {"Y": spec, "Mean": lead,
                              "Variance": lead})
        return

    if t in _REDUCES or t == "mean":
        _h_reduce(ctx, op, i)
        return

    if t in ("reshape", "reshape2", "flatten", "flatten2", "squeeze",
             "squeeze2", "unsqueeze", "unsqueeze2"):
        _h_reshape(ctx, op, i)
        return

    if t in ("transpose", "transpose2"):
        xn = _first(op, "X")
        spec = ctx.resolve_partial(xn, op, i)
        perm = attrs.get("axis")
        r = _rank(ctx, xn)
        out = {}
        if "XShape" in op.outputs:
            out["XShape"] = REPLICATED
        if perm is not None and r is not None and len(perm) == r:
            dims = _dims_at(ctx, xn, r)
            out["Out"] = ShardSpec([dims[p % r] for p in perm])
        else:
            out["Out"] = REPLICATED if not spec.is_replicated else spec
        _bind_specs(ctx, op, out)
        return

    if t == "concat":
        _h_concat(ctx, op, i)
        return

    if t == "split":
        xn = _first(op, "X")
        spec = ctx.resolve_partial(xn, op, i)
        r = _rank(ctx, xn)
        n_out = len(op.outputs.get("Out") or ())
        if r:
            ax = attrs.get("axis", 0) % r
            dims = _dims_at(ctx, xn, r)
            if dims[ax] is not None:
                dst = ShardSpec([None if d == ax else a
                                 for d, a in enumerate(dims)])
                spec = ctx.reshard(xn, spec, dst, op, i,
                                   why="split along a sharded axis")
        _bind_specs(ctx, op, {"Out": [spec] * n_out})
        return

    if t == "stack":
        names = op.inputs.get("X") or []
        base = REPLICATED
        for n in names:
            s = ctx.resolve_partial(n, op, i)
            if not s.is_replicated:
                base = s
                break
        r = _rank(ctx, names[0]) if names else None
        if r is not None and base.dims is not None:
            dims = list(_aligned(base, r).dims)
            dims.insert(attrs.get("axis", 0) % (r + 1), None)
            base = ShardSpec(dims)
        spec = base
        _bind_specs(ctx, op, {"Y": spec, "Out": spec})
        return

    if t in ("lookup_table", "lookup_table_v2"):
        _h_lookup(ctx, op, i)
        return

    if t in ("cross_entropy", "cross_entropy2",
             "softmax_with_cross_entropy"):
        _h_loss(ctx, op, i)
        return

    if t in ("slice",):
        xn = _first(op, "Input")
        spec = ctx.resolve_partial(xn, op, i)
        r = _rank(ctx, xn)
        if r:
            dims = _dims_at(ctx, xn, r)
            touched = {a % r for a in (attrs.get("axes") or ())}
            if any(dims[d] is not None for d in touched):
                dst = ShardSpec([None if d in touched else a
                                 for d, a in enumerate(dims)])
                spec = ctx.reshard(xn, spec, dst, op, i,
                                   why="slicing a sharded dim")
                dims = list(dst.dims)
            dec = sorted({a % r for a in
                          (attrs.get("decrease_axis") or ())},
                         reverse=True)
            for a in dec:
                del dims[a]
            spec = ShardSpec(dims, spec.partial)
        _bind_specs(ctx, op, {"Out": spec})
        return

    if t == "expand":
        xn = _first(op, "X")
        spec = ctx.resolve_partial(xn, op, i)
        times = attrs.get("expand_times") or ()
        r = _rank(ctx, xn)
        if r:
            dims = _dims_at(ctx, xn, r)
            bad = [d for d, tm in enumerate(times)
                   if d < r and tm != 1 and dims[d] is not None]
            if bad:
                dst = ShardSpec([None if d in bad else a
                                 for d, a in enumerate(dims)])
                spec = ctx.reshard(xn, spec, dst, op, i,
                                   why="expanding a sharded dim")
        _bind_specs(ctx, op, {"Out": spec})
        return

    if t in ("one_hot", "one_hot_v2"):
        xn = _first(op, "X")
        spec = ctx.resolve_partial(xn, op, i)
        dims = list(spec.dims or ()) + [None]
        _bind_specs(ctx, op, {"Out": ShardSpec(dims)})
        return

    if t in ("top_k", "top_k_v2", "arg_max", "arg_min", "accuracy",
             "shape", "fill_constant", "fill_constant_batch_size_like",
             "uniform_random", "gaussian_random",
             "truncated_gaussian_random"):
        # outputs carry no useful layout (tiny / freshly materialized)
        for n in op.input_names():
            ctx.resolve_partial(n, op, i)
        _bind_specs(ctx, op, {})
        return

    if t in sr.OPTIMIZER_OPS:
        _h_optimizer(ctx, op, i)
        return

    if t == "fused_attention":
        # per-head attention is independent: the output carries the
        # joined Q/K/V layout (for the zoo's Megatron TP rules the
        # head/feature dim rides the mp axis, batch rides dp; the
        # contraction axes — head_dim and seq — are unsharded there)
        qn = _first(op, "Q")
        out_name = (op.outputs.get("Out") or [None])[0]
        r = _rank(ctx, out_name)
        acc = _broadcast_dims(ctx, qn, r)
        ctx.resolve_partial(qn, op, i)
        for slot in ("K", "V", "Mask"):
            n = _first(op, slot)
            if not n:
                continue
            ctx.resolve_partial(n, op, i)
            merged, conflict = _merge_dims_pair(
                acc, _broadcast_dims(ctx, n, r))
            if conflict is not None:
                d, a, b = conflict
                ctx.diag(
                    "PT305",
                    f"conflicting sharding join at 'fused_attention': "
                    f"'{qn}' and '{n}' disagree on dim {d} "
                    f"(axes {a!r} vs {b!r}); '{n}' is "
                    f"implied-resharded to "
                    f"{ShardSpec(merged).render()}",
                    op=op, op_index=i, var=n)
                ctx.reshard(n, ctx.env.get(n, REPLICATED),
                            ShardSpec(merged), op, i,
                            why="conflicting-join resolution")
            acc = merged
        _bind_specs(ctx, op, {"Out": ShardSpec(acc)
                              if acc is not None else REPLICATED})
        return

    if t == "fused_bias_act":
        xn, bn = _first(op, "X"), _first(op, "Bias")
        out_name = (op.outputs.get("Out") or [None])[0]
        out = _join_elementwise(ctx, op, i, xn, bn,
                                _rank(ctx, out_name))
        _bind_specs(ctx, op, {"Out": out})
        return

    if t == "fused_layer_norm":
        # residual join first (elementwise semantics), then the
        # layer_norm trailing-dim reshard
        xn, rn = _first(op, "X"), _first(op, "Residual")
        r = _rank(ctx, xn)
        if rn:
            spec = _join_elementwise(ctx, op, i, xn, rn, r)
        else:
            spec = ctx.resolve_partial(xn, op, i)
        ax = attrs.get("begin_norm_axis", 1)
        if r:
            dims = list((_aligned(spec, r).dims or [None] * r))
            if any(dims[d] is not None for d in range(ax, r)):
                dst = ShardSpec(dims[:ax] + [None] * (r - ax))
                spec = ctx.reshard(xn, spec, dst, op, i,
                                   why="fused_layer_norm normalizes "
                                       "sharded trailing dims")
        lead = ShardSpec((spec.dims or ())[:ax]) if spec.dims else \
            REPLICATED
        _bind_specs(ctx, op, {"Y": spec, "Mean": lead,
                              "Variance": lead})
        return

    if t == "fused_bottleneck":
        # conv half priced through the SAME conv2d rule (out-channel
        # filter shards propagate, in-channel contraction pends a psum
        # — the fused program lints exactly as strictly as its source
        # subgraph); the bn half resolves that partial immediately
        # (batch stats need the true sums, like the unfused bn
        # consuming the conv output) and passes the running stats
        # through like batch_norm
        _h_conv(ctx, op, i, attrs=attrs.get("conv_attrs") or {},
                out_slot="Y")
        yn = (op.outputs.get("Y") or [None])[0]
        if yn:
            ctx.resolve_partial(yn, op, i)
        out = {}
        for oslot, islot in (("MeanOut", "Mean"),
                             ("VarianceOut", "Variance")):
            n = _first(op, islot)
            if n:
                out[oslot] = ctx.env.get(n, REPLICATED)
        _bind_specs(ctx, op, out)
        return

    # unknown family: degrade to replicated with a note, never a
    # false error (the PT204-for-sharding contract)
    sharded_ins = [n for n in op.input_names()
                   if not ctx.env.get(n, REPLICATED).is_replicated]
    if sharded_ins:
        ctx.degrade(op, i, sharded_ins,
                    "no sharding propagation rule for this family")
    _bind_specs(ctx, op, {})


# -- structured families ----------------------------------------------------

def _h_matmul(ctx, op, i):
    """matmul/mul: contracting a sharded axis turns the output into a
    pending partial sum over that axis (the GSPMD einsum rule); batch
    dims broadcast-join, m comes from X, n from Y."""
    xn, yn = _first(op, "X"), _first(op, "Y")
    xs = ctx.resolve_partial(xn, op, i)
    ys = ctx.resolve_partial(yn, op, i)
    rx, ry = _rank(ctx, xn), _rank(ctx, yn)
    if rx is None or ry is None:
        _bind_specs(ctx, op, {})
        return
    xd = _dims_at(ctx, xn, rx)
    yd = _dims_at(ctx, yn, ry)
    if op.type == "mul":
        xnc = op.attrs.get("x_num_col_dims", 1)
        ync = op.attrs.get("y_num_col_dims", 1)
        kx = {a for a in xd[xnc:] if a is not None}
        ky = {a for a in yd[:ync] if a is not None}
        if kx and ky and kx != ky:
            # mismatched k-slices: each device would contract the
            # WRONG slices — garbage no all-reduce repairs (same
            # diagnosis the matmul branch makes)
            ctx.diag(
                "PT305",
                f"mul contracting dims sharded over DIFFERENT axes — "
                f"X '{xn}' {xs.render()} contracts {sorted(kx)}, Y "
                f"'{yn}' {ys.render()} contracts {sorted(ky)}; Y is "
                f"implied-gathered and the contraction stays partial "
                f"over {sorted(kx)}",
                op=op, op_index=i, var=yn)
            ctx.reshard(yn, ys, REPLICATED, op, i,
                        why="contraction-axis mismatch")
            k_axes = kx
        else:
            k_axes = kx | ky
        out_dims = xd[:xnc] + yd[ync:]
        out = ShardSpec(_dedupe_axes(out_dims, k_axes), k_axes)
        _bind_specs(ctx, op, {"Out": out})
        return
    if op.attrs.get("transpose_X", False) and rx > 1:
        xd[-1], xd[-2] = xd[-2], xd[-1]
    if op.attrs.get("transpose_Y", False) and ry > 1:
        yd[-1], yd[-2] = yd[-2], yd[-1]
    k_x = xd[-1]
    k_y = yd[-2] if ry > 1 else yd[0]
    partial = set()
    if k_x is not None and k_y is not None and k_x != k_y:
        ctx.diag(
            "PT305",
            f"matmul contracting dim sharded over DIFFERENT axes — "
            f"X '{xn}' {xs.render()} contracts {k_x!r}, Y '{yn}' "
            f"{ys.render()} contracts {k_y!r}; Y is implied-gathered "
            f"and the contraction stays partial over {k_x!r}",
            op=op, op_index=i, var=yn)
        ctx.reshard(yn, ys, REPLICATED, op, i,
                    why="contraction-axis mismatch")
        partial.add(k_x)
    elif k_x is not None or k_y is not None:
        # one-sided shard: the other operand is locally sliced (free)
        partial.add(k_x if k_x is not None else k_y)
    bx = xd[:-2] if rx > 1 else []
    by = yd[:-2] if ry > 1 else []
    batch = []
    width = max(len(bx), len(by))
    bx = [None] * (width - len(bx)) + bx
    by = [None] * (width - len(by)) + by
    for a, b in zip(bx, by):
        batch.append(a if a is not None else b)
    m = [xd[-2]] if rx > 1 else []
    n = [yd[-1]] if ry > 1 else []
    out_dims = _dedupe_axes(batch + m + n, partial)
    _bind_specs(ctx, op, {"Out": ShardSpec(out_dims, partial)})


def _h_fc(ctx, op, i):
    """fc(Input, W[k, n]): W column-sharded => output feature dim
    sharded (column parallel); W row-sharded (or Input's flattened
    trailing dims sharded) => output pending-psum (row parallel)."""
    xn, wn = _first(op, "Input"), _first(op, "W")
    bn = _first(op, "Bias")
    xs = ctx.resolve_partial(xn, op, i)
    ws = ctx.env.get(wn, REPLICATED)
    nf = op.attrs.get("in_num_col_dims", 1)
    rx = _rank(ctx, xn)
    wd = _dims_at(ctx, wn, 2)
    xd = _dims_at(ctx, xn, rx) if rx is not None else []
    xk = {a for a in xd[nf:] if a is not None}
    wk = {wd[0]} if wd[0] is not None else set()
    if xk and wk and xk != wk:
        ctx.diag(
            "PT305",
            f"fc contracting dims sharded over DIFFERENT axes — "
            f"input '{xn}' {xs.render()} contracts {sorted(xk)}, "
            f"weight '{wn}' {ws.render()} contracts {sorted(wk)}; the "
            f"weight rows are implied-gathered and the contraction "
            f"stays partial over {sorted(xk)}",
            op=op, op_index=i, var=wn)
        ctx.reshard(wn, ws, ShardSpec((None, wd[1])), op, i,
                    why="contraction-axis mismatch")
        wd = [None, wd[1]]
        partial = set(xk)
    else:
        partial = xk | wk
    n_axis = wd[1]
    if n_axis is not None and n_axis in partial:
        ctx.diag(
            "PT305",
            f"fc weight '{wn}' {ws.render()} shards rows AND columns "
            f"over the same mesh axis {n_axis!r}; the column shard is "
            f"dropped", op=op, op_index=i, var=wn)
        n_axis = None
    out_dims = _dedupe_axes((xd[:nf] if xd else [None] * nf)
                            + [n_axis], partial)
    if bn:
        bs = ctx.env.get(bn, REPLICATED)
        b_axis = _dims_at(ctx, bn, 1)[0]
        if b_axis is not None and b_axis != n_axis:
            ctx.diag(
                "PT305",
                f"fc bias '{bn}' {bs.render()} is sharded over "
                f"{b_axis!r} but the output feature dim is sharded "
                f"over {n_axis!r}; bias is implied-resharded",
                op=op, op_index=i, var=bn)
            ctx.reshard(bn, bs, ShardSpec((n_axis,)), op, i,
                        why="bias/output layout mismatch")
    _bind_specs(ctx, op, {"Out": ShardSpec(out_dims, partial)})


def _h_conv(ctx, op, i, attrs=None, out_slot="Output"):
    """conv2d: batch sharding passes through; filter out-channel
    sharding shards the output channel dim; in-channel (contraction)
    sharding pends a psum; sharded spatial dims gather (halo exchange
    is not modeled).  `attrs`/`out_slot` let fused_bottleneck price its
    conv half through the SAME rule (its conv attrs ride nested, its
    conv output slot is Y)."""
    xn, wn = _first(op, "Input"), _first(op, "Filter")
    xs = ctx.resolve_partial(xn, op, i)
    if attrs is None:
        attrs = op.attrs
    nchw = attrs.get("data_format", "NCHW") in ("NCHW", "AnyLayout")
    rx = _rank(ctx, xn)
    if rx != 4:
        _bind_specs(ctx, op, {})
        return
    xd = _dims_at(ctx, xn, 4)
    wd = _dims_at(ctx, wn, 4)
    b_dim, c_dim = (0, 1) if nchw else (0, 3)
    spatial = (2, 3) if nchw else (1, 2)
    if any(xd[d] is not None for d in spatial):
        dst = ShardSpec([None if d in spatial else a
                         for d, a in enumerate(xd)])
        xs = ctx.reshard(xn, xs, dst, op, i,
                         why="conv over a sharded spatial dim "
                             "(halo exchange not modeled)")
        xd = list(dst.dims)
    partial = set()
    if wd[1] is not None:
        partial.add(wd[1])          # contraction over in-channels
    if xd[c_dim] is not None:
        partial.add(xd[c_dim])
    co_axis = wd[0]
    if co_axis is not None and co_axis in partial:
        co_axis = None
    out_dims = [None] * 4
    out_dims[b_dim] = xd[b_dim]
    out_dims[c_dim] = co_axis
    _bind_specs(ctx, op, {out_slot: ShardSpec(
        _dedupe_axes(out_dims, partial), partial)})


def _h_reduce(ctx, op, i):
    """Reducing over a sharded dim produces a pending partial sum —
    the edge PT306 exists for when it never lands."""
    xn = _first(op, "X")
    spec = ctx.resolve_partial(xn, op, i)
    r = _rank(ctx, xn)
    if r is None:
        _bind_specs(ctx, op, {})
        return
    dims = _dims_at(ctx, xn, r)
    if op.type == "mean" or op.attrs.get("reduce_all", False) or r == 0:
        red = set(range(r))
    else:
        d = op.attrs.get("dim", [0])
        d = tuple(d) if isinstance(d, (list, tuple)) else (d,)
        red = {x % r for x in d if -r <= x < r}
    partial = {dims[d] for d in red if dims[d] is not None} \
        | set(spec.partial)
    keep = op.attrs.get("keep_dim", False)
    if op.type == "mean":
        out_dims = []
    elif keep:
        out_dims = [None if d in red else a for d, a in enumerate(dims)]
    else:
        out_dims = [a for d, a in enumerate(dims) if d not in red]
    _bind_specs(ctx, op, {"Out": ShardSpec(
        _dedupe_axes(out_dims, partial), partial)})


def _h_reshape(ctx, op, i):
    """reshape/flatten/squeeze/unsqueeze: carry sharded dims through
    the prefix-product factor mapping; an unmappable sharded dim
    gathers (with PT303 when hot)."""
    xn = _first(op, "X")
    spec = ctx.resolve_partial(xn, op, i)
    out = {}
    if "XShape" in op.outputs:
        out["XShape"] = REPLICATED
    out_name = (op.outputs.get("Out") or [None])[0]
    in_vs = ctx.shapes.get(xn)
    out_vs = ctx.shapes.get(out_name)
    r = _rank(ctx, xn)
    if spec.is_replicated:
        out["Out"] = REPLICATED
        _bind_specs(ctx, op, out)
        return
    in_shape = None if in_vs is None else in_vs.shape
    out_shape = None if out_vs is None else out_vs.shape
    mapped = _map_dims(list(in_shape or ()), list(out_shape or ()),
                       _dims_at(ctx, xn, r)) \
        if in_shape is not None and out_shape is not None else None
    if mapped is None:
        dst = REPLICATED
        ctx.reshard(xn, spec, dst, op, i,
                    why=f"{op.type} cannot carry the sharded dim "
                        f"through this shape change")
        out["Out"] = dst
    else:
        # a split dim must still divide evenly on the new major size
        ok = True
        for d, a in enumerate(mapped):
            if a is None or out_shape[d] is None:
                continue
            if out_shape[d] % max(ctx.mesh.size(a), 1) != 0:
                ok = False
        if not ok:
            dst = REPLICATED
            ctx.reshard(xn, spec, dst, op, i,
                        why=f"{op.type} splits a sharded dim below "
                            f"the mesh-axis size")
            out["Out"] = dst
        else:
            out["Out"] = ShardSpec(mapped, spec.partial)
    _bind_specs(ctx, op, out)


def _h_concat(ctx, op, i):
    """Concat: the concat axis itself cannot stay sharded (each
    device's local concat would interleave wrong); the remaining dims
    fold through the SAME pairwise merge elementwise uses, so a
    later operand's conflicting layout is a PT305, not silently
    dropped."""
    names = op.inputs.get("X") or []
    out_name = (op.outputs.get("Out") or [None])[0]
    r = _rank(ctx, out_name)
    ax = op.attrs.get("axis", 0) % r if r else 0
    acc = None
    acc_name = None
    for n in names:
        spec = ctx.resolve_partial(n, op, i)
        dims = _broadcast_dims(ctx, n, r)
        if r and dims[ax] is not None:
            dst = ShardSpec([None if d == ax else a
                             for d, a in enumerate(dims)])
            ctx.reshard(n, spec, dst, op, i,
                        why="concat along a sharded axis")
            ctx.env[n] = dst
            dims = list(dst.dims)
        if acc is None:
            acc, acc_name = dims, n
            continue
        merged, conflict = _merge_dims_pair(acc, dims)
        if conflict is not None:
            d, a, b = conflict
            ctx.diag(
                "PT305",
                f"conflicting sharding join at 'concat': operands "
                f"'{acc_name}' and '{n}' disagree on dim {d} (axes "
                f"{a!r} vs {b!r}); '{n}' is implied-resharded to "
                f"{ShardSpec(merged).render()}",
                op=op, op_index=i, var=n)
            ctx.reshard(n, ctx.env.get(n, REPLICATED),
                        ShardSpec(merged), op, i,
                        why="conflicting-join resolution")
        acc = merged
    _bind_specs(ctx, op, {"Out": ShardSpec(acc) if acc is not None
                          else REPLICATED})


def _h_lookup(ctx, op, i):
    """Embedding lookup: vocab-sharded tables produce the masked-
    lookup partial sum of TP embeddings (pending psum over the vocab
    axis); embedding-dim sharding just shards the output feature
    dim."""
    ids_n, wn = _first(op, "Ids"), _first(op, "W")
    ids = ctx.resolve_partial(ids_n, op, i)
    wd = _dims_at(ctx, wn, 2)
    out_name = (op.outputs.get("Out") or [None])[0]
    r = _rank(ctx, out_name)
    id_dims = list(_aligned(ids, (r - 1) if r else None).dims or ())
    partial = set()
    if wd[0] is not None:
        partial.add(wd[0])
    dims = id_dims + [wd[1]]
    _bind_specs(ctx, op, {"Out": ShardSpec(
        _dedupe_axes(dims, partial), partial)})


def _h_loss(ctx, op, i):
    """CE losses: a class-axis shard must gather (the fused softmax
    normalizes over it); batch dims pass through to the loss."""
    xslot = "Logits" if op.type == "softmax_with_cross_entropy" else "X"
    xn = _first(op, xslot)
    spec = ctx.resolve_partial(xn, op, i)
    r = _rank(ctx, xn)
    if r:
        dims = _dims_at(ctx, xn, r)
        ax = (op.attrs.get("axis", -1) % r
              if op.type == "softmax_with_cross_entropy" else r - 1)
        if dims[ax] is not None:
            dst = ShardSpec([None if d == ax else a
                             for d, a in enumerate(dims)])
            spec = ctx.reshard(xn, spec, dst, op, i,
                               why="cross-entropy normalizes the "
                                   "sharded class axis")
            dims = list(dst.dims)
        loss = ShardSpec([None if d == ax else a
                          for d, a in enumerate(dims)])
    else:
        loss = REPLICATED
    out = {"Loss": loss, "Out": loss}
    if op.type == "softmax_with_cross_entropy":
        out["Softmax"] = spec
    _bind_specs(ctx, op, out)


def _h_optimizer(ctx, op, i):
    """Optimizer update: every *Out mirrors its input slot's layout
    (sr._OPTIMIZER_MIRRORS — the same aliasing pairs PT106 checks); a
    still-partial gradient is resolved here as a final safety net (the
    dp grad sync normally resolved it at the section boundary)."""
    pn, gn = _first(op, "Param"), _first(op, "Grad")
    p_spec = ctx.env.get(pn, REPLICATED)
    if gn:
        g_spec = ctx.resolve_partial(gn, op, i)
        if g_spec.dims != p_spec.dims and not g_spec.is_replicated \
                and not p_spec.is_replicated:
            ctx.reshard(gn, g_spec, p_spec, op, i,
                        why="gradient layout differs from its param")
    out = {}
    for oslot in op.outputs:
        islot = sr._OPTIMIZER_MIRRORS.get(oslot)
        n = _first(op, islot) if islot else None
        out[oslot] = ctx.env.get(n, REPLICATED) if n else REPLICATED
    _bind_specs(ctx, op, out)


# ---------------------------------------------------------------------------
# the port's per-op consumption record (what the runtime tier executes)
# ---------------------------------------------------------------------------

class OpRecord:
    """How op `index` consumes and produces layouts: ``steps`` {input:
    [(kind, src, dst)]} the analyzer's transitions on that edge in order
    ("resolve" a pending partial, "reshard" src -> dst), ``consumed``
    {input: the spec the op computes on}, which adds to the last step the
    free local slices the family implies (a replicated operand joining a
    sharded one, the other side of a one-sided contraction), ``kept``
    {input: the var's spec after the op}, ``outputs`` {output: spec}.
    Nothing here changes the analyzer's records."""

    __slots__ = ("index", "type", "steps", "consumed", "kept", "outputs")

    def __init__(self, index, type_, steps, consumed, kept, outputs):
        self.index = index
        self.type = type_
        self.steps = steps
        self.consumed = consumed
        self.kept = kept
        self.outputs = outputs

    def __repr__(self):
        ins = ", ".join(f"{n}@{s.render()}"
                        for n, s in self.consumed.items())
        outs = ", ".join(f"{n}@{s.render()}"
                         for n, s in self.outputs.items())
        return f"OpRecord(#{self.index} {self.type}: {ins} -> {outs})"


def _shape(ctx, name):
    vs = ctx.shapes.get(name)
    return None if vs is None or vs.shape is None else list(vs.shape)


def _project_from(out_spec, out_shape, in_shape, in_spec, offset):
    """`in_spec` with the free local slices an output layout implies:
    input dim k faces output dim ``offset + k``; where the input is
    unsharded on k, has the output's static size there (no broadcast)
    and the output dim is sharded over an axis the input does not use
    yet, the input is sliced there."""
    r = len(in_shape)
    dims = list(_aligned(in_spec, r).dims or (None,) * r)
    odims = list(_aligned(out_spec, len(out_shape)).dims
                 or (None,) * len(out_shape))
    used = {a for a in dims if a is not None} | set(in_spec.partial)
    for k in range(r):
        d = offset + k
        if dims[k] is not None or not 0 <= d < len(odims):
            continue
        a = odims[d]
        if a is None or a in used or in_shape[k] is None \
                or in_shape[k] != out_shape[d]:
            continue
        dims[k] = a
        used.add(a)
    return ShardSpec(dims, in_spec.partial)


def _slice_contraction(spec, shape, dim, partial):
    """A one-sided contraction: the operand whose contraction dim `dim`
    is unsharded takes the slice of the axis the other side contracts
    over (the partial the output carries)."""
    if shape is None or not 0 <= dim < len(shape):
        return spec
    dims = list(_aligned(spec, len(shape)).dims or (None,) * len(shape))
    if dims[dim] is not None:
        return spec
    free = sorted(a for a in partial if a not in dims)
    if not free:
        return spec
    dims[dim] = free[0]
    return ShardSpec(dims, spec.partial)


def _implied_consumption(ctx, op, consumed, outputs):
    t = op.type
    a = op.attrs

    def out_of(slot):
        n = (op.outputs.get(slot) or [None])[0]
        return n, outputs.get(n)

    def project(slot, out_slot, offset=None):
        on, ospec = out_of(out_slot)
        oshape = _shape(ctx, on)
        for n in op.inputs.get(slot) or ():
            ishape = _shape(ctx, n)
            if ospec is None or oshape is None or ishape is None \
                    or n not in consumed:
                continue
            off = len(oshape) - len(ishape) if offset is None else offset
            consumed[n] = _project_from(ospec, oshape, ishape,
                                        consumed[n], off)

    if t in _ELEMENTWISE or t == "fused_bias_act":
        yslot = "Bias" if t == "fused_bias_act" else "Y"
        project("X", "Out")
        axis = a.get("axis", -1)
        project(yslot, "Out", None if axis is None or axis < 0 else axis)
    elif t in ("sum", "concat"):
        project("X", "Out")
    elif t == "fused_layer_norm":
        project("X", "Y")
        project("Residual", "Y")
    elif t == "fused_attention":
        for slot in ("Q", "K", "V", "Mask"):
            project(slot, "Out")
    elif t in ("lookup_table", "lookup_table_v2"):
        project("Ids", "Out", 0)
    elif t in ("softmax_with_cross_entropy", "cross_entropy",
               "cross_entropy2"):
        project("Label", "Loss" if "Loss" in op.outputs else "Y", 0)
    elif t == "mul":
        xn, yn = _first(op, "X"), _first(op, "Y")
        _, ospec = out_of("Out")
        if ospec is not None and ospec.partial and xn in consumed \
                and yn in consumed:
            consumed[xn] = _slice_contraction(
                consumed[xn], _shape(ctx, xn),
                a.get("x_num_col_dims", 1), ospec.partial)
            consumed[yn] = _slice_contraction(
                consumed[yn], _shape(ctx, yn), 0, ospec.partial)
    elif t in ("matmul", "quantized_matmul"):
        xn, yn = _first(op, "X"), _first(op, "Y")
        on, ospec = out_of("Out")
        xs, ys = _shape(ctx, xn), _shape(ctx, yn)
        if ospec is None or xs is None or ys is None \
                or xn not in consumed or yn not in consumed:
            return consumed
        if ospec.partial:
            cx = len(xs) - (2 if a.get("transpose_X") and len(xs) > 1
                            else 1)
            cy = (0 if len(ys) == 1 else
                  len(ys) - (1 if a.get("transpose_Y") else 2))
            consumed[xn] = _slice_contraction(consumed[xn], xs, cx,
                                              ospec.partial)
            consumed[yn] = _slice_contraction(consumed[yn], ys, cy,
                                              ospec.partial)
        oshape = _shape(ctx, on)
        if oshape is not None and len(oshape) > 2:
            # the batch dims join by broadcast: a replicated side takes
            # the slice of the other's sharded batch dim
            ob = oshape[:-2]
            ospec_b = ShardSpec(list(_aligned(ospec, len(oshape)).dims
                                     or (None,) * len(oshape))[:-2])
            for n, sh in ((xn, xs), (yn, ys)):
                if len(sh) <= 2:
                    continue
                spec = consumed[n]
                dims = list(_aligned(spec, len(sh)).dims
                            or (None,) * len(sh))
                b = _project_from(ospec_b, ob, sh[:-2],
                                  ShardSpec(dims[:-2]),
                                  len(ob) - (len(sh) - 2))
                consumed[n] = ShardSpec(list(b.dims) + dims[-2:],
                                        spec.partial)
    return consumed


def _op_record(ctx, op, i, before, events):
    steps = {}
    consumed = dict(before)
    for _i, kind, name, src, dst in events:
        if name not in before:
            continue
        steps.setdefault(name, []).append((kind, src, dst))
        consumed[name] = dst
    outputs = {n: ctx.env.get(n, REPLICATED) for n in op.output_names()}
    kept = {n: ctx.env.get(n, REPLICATED) for n in before
            if n not in outputs}
    consumed = _implied_consumption(ctx, op, consumed, outputs)
    return OpRecord(i, op.type, steps, consumed, kept, outputs)


def local_slice(tensor, spec, coords):
    """This rank's shard of a global `tensor` (numpy or torch) under
    `spec`: `coords` maps each mesh axis to (this rank's index on it, the
    axis size); a dim sharded over axis `a` keeps block ``index`` of
    ``size`` equal blocks.  Axes missing from `coords` (the data axis of
    a body spec, say) leave their dim whole."""
    if spec is None or spec.dims is None:
        return tensor
    index = []
    for d, a in enumerate(_aligned(spec, len(tensor.shape)).dims):
        if a is None or a not in coords:
            index.append(slice(None))
            continue
        pos, size = coords[a]
        n = tensor.shape[d]
        if n % size:
            raise ValueError(
                f"dim {d} of size {n} does not split into {size} blocks "
                f"over mesh axis {a!r}")
        blk = n // size
        index.append(slice(pos * blk, (pos + 1) * blk))
    return tensor[tuple(index)]


# ---------------------------------------------------------------------------
# the propagation entry point
# ---------------------------------------------------------------------------

def _check_divisibility(ctx, name, spec, op=None, op_index=None):
    """PT304: a sharded dim's static size must divide by its mesh-axis
    size, and the spec may not name more dims than the var has."""
    vs = ctx.shapes.get(name)
    if vs is None or spec.dims is None:
        return
    shape = vs.shape
    # right-pad semantics: a spec longer than the var's rank drops its
    # TRAILING entries — naming a mesh axis there is the user error
    if shape is not None and len(spec.dims) > len(shape) \
            and any(d is not None for d in spec.dims[len(shape):]):
        ctx.diag("PT304",
                 f"partition spec {spec.render()} names "
                 f"{len(spec.dims)} dims but '{name}' has rank "
                 f"{len(shape)} (shape {shape})", op=op,
                 op_index=op_index, var=name)
        return
    if shape is None:
        return
    dims = _aligned(spec, len(shape)).dims or ()
    for d, a in enumerate(dims):
        if a is None or shape[d] is None:
            continue
        size = ctx.mesh.size(a)
        if size > 1 and shape[d] % size != 0:
            ctx.diag("PT304",
                     f"dim {d} of '{name}' has static size {shape[d]} "
                     f"not divisible by mesh axis {a!r} (size {size})",
                     op=op, op_index=op_index, var=name)


def _plan_section_sync(ctx, k, bs, data_axes):
    """The dp gradient sync, planned STATICALLY through the same
    ``transpiler.collective`` bucket planner the executor's trace-time
    emission uses (reversed param order, dtype-segregated fixed-
    capacity buckets) — so the predicted psum count and bytes match the
    executed ``last_sync_stats`` exactly, by construction.  Seeds the
    post-sync grad specs into the env (grads mirror their param's
    layout once the owed psum over the data axes has landed)."""
    from ..transpiler import collective as coll

    entries = []
    for p in reversed(bs.param_names):
        vs = ctx.shapes.get(p)
        spec = ctx.env.get(p, REPLICATED)
        gname = facts.grad_name(p)
        ctx.env[gname] = spec
        if gname not in ctx.shapes and vs is not None:
            ctx.shapes[gname] = vs
        if vs is None or vs.shape is None \
                or any(d is None for d in vs.shape):
            continue
        numel = math.prod(vs.shape) if vs.shape else 1
        numel //= max(spec.shard_factor(ctx.mesh), 1)
        entries.append((gname, numel, _itemsize(vs.dtype),
                        vs.dtype or "float32"))
    if not data_axes or not entries:
        return
    scope = f"fwd{k}/dp_grad_sync_{k}"
    for rec in coll.implied_collective_plan(entries,
                                            axes=sorted(data_axes)):
        ctx.add_collective("all_reduce", data_axes, rec["var"],
                           rec["bytes"], bs.pos, scope=scope)


def propagate(program, rules, fetch_names=None, feed_names=(),
              feed_shapes=None):
    """Run the rule match + the per-op spec walk over the global
    block.  Returns ``(report, ctx)``: the match report and the
    propagation context holding the final per-edge specs (``ctx.env``),
    the implied-collective list, the PT3xx diagnostics, and the
    degradation notes."""
    mesh = rules.mesh
    blk = program.global_block()
    ops = list(blk.ops)
    sections = ([] if program._is_test
                else list(program.backward_sections))
    shapes = {}
    for b in program.blocks:
        for n, v in b.vars.items():
            shapes.setdefault(n, facts.var_spec(v))
    shapes.update(facts.infer_specs(program, feed_names=feed_names,
                                    overrides=feed_shapes))
    classes = _var_classes(program)   # ONE walk, shared with analyze()
    report = match_report(program, rules, classes=classes)
    scopes = _scope_names(ops, sections)
    fwd_limit = max((bs.pos for bs in sections), default=0)
    ctx = _Ctx(mesh, shapes, scopes, fwd_limit, None)
    ctx.classes = classes
    ctx.env.update(report["specs"])
    for name, spec in report["specs"].items():
        if not spec.is_replicated:
            _check_divisibility(ctx, name, spec)
    data_axes = set()
    for name, cls in classes.items():
        if cls == "data":
            data_axes |= set(ctx.env.get(name, REPLICATED)
                             .sharded_axes())
    control_flow = facts.control_flow_types()
    section_at = {}
    for k, bs in enumerate(sections):
        section_at.setdefault(bs.pos, []).append((k, bs))
    ctx.op_records = {}
    for i, op in enumerate(ops):
        for k, bs in section_at.get(i, ()):
            _plan_section_sync(ctx, k, bs, data_axes)
        before = {n: ctx.env.get(n, REPLICATED) for n in op.input_names()}
        mark = len(ctx.events)
        if op.type in control_flow:
            ctx.degrade(op, i, op.input_names(),
                        "control flow binds sub-block carries at "
                        "trace time")
            _bind_specs(ctx, op, {})
        else:
            _propagate_op(ctx, op, i)
        ctx.op_records[i] = _op_record(ctx, op, i, before,
                                       ctx.events[mark:])
    for k, bs in enumerate(sections):
        if bs.pos >= len(ops):
            _plan_section_sync(ctx, k, bs, data_axes)
    # PT306: a pending partial sum reaching a fetch.  One legitimate
    # resolver exists at the program boundary: the executor's fetch
    # merge pmeans RANK-0 fetches over the data axis
    # (update/dp_fetch_sync_0), so a scalar loss partial over dp is
    # resolved there — modeled as an implied collective.  Anything
    # else (a non-data mesh axis, or a rank>=1 fetch that would be
    # CONCATENATED, not reduced) is the real bug: the fetched value
    # would be one shard's partial sum.
    producer = {}
    for i, op in enumerate(ops):
        for n in op.output_names():
            producer.setdefault(n, (op, i))
    for f in list(fetch_names or ()):
        spec = ctx.env.get(f)
        if spec is None or not spec.partial:
            continue
        vs = ctx.shapes.get(f)
        rank0 = vs is not None and vs.shape is not None \
            and len(vs.shape) == 0
        data_only = spec.partial <= data_axes
        if rank0 and data_only and data_axes:
            ctx.add_collective("all_reduce", spec.partial, f,
                               ctx.bytes_of(f, spec.clear_partial()),
                               len(ops), scope="update/dp_fetch_sync_0")
            ctx.env[f] = spec.clear_partial()
            continue
        src_op, src_i = producer.get(f, (None, None))
        ctx.diag(
            "PT306",
            f"fetch '{f}' carries a pending partial sum over "
            f"{sorted(spec.partial)} — a sharded contraction/"
            f"reduction fed it and nothing downstream (not even the "
            f"executor's rank-0 fetch sync) implies the owed "
            f"all-reduce; the fetched value would be one shard's "
            f"partial, not the result", op=src_op, op_index=src_i,
            var=f)
    return report, ctx


# ---------------------------------------------------------------------------
# static per-shard peak-memory estimate (pre-trace mem_profile analogue)
# ---------------------------------------------------------------------------

def estimate_memory(program, ctx, fetch_names=None):
    """Per-shard peak-memory estimate from ``facts``-style liveness:
    every produced intermediate lives from its producing op to its
    last read — extended to the backward-section boundary for forward
    activations (the backward replays over them) and from the section
    to their optimizer consumer for gradients.  Persistable state is
    reported separately (the step updates it in place, so it does not
    stack on the temp peak).

    Returns the per-scope table in monitor.mem_profile's style —
    ``peak_bytes``/``timeline``/``per_scope``/``top_buffers`` — but
    computed BEFORE any trace, from shapes x shard specs alone."""
    blk = program.global_block()
    ops = list(blk.ops)
    sections = ([] if program._is_test
                else list(program.backward_sections))
    fetch_names = set(fetch_names or ())
    persist = {n for b in program.blocks for n, v in b.vars.items()
               if v.persistable}
    data = {n for b in program.blocks for n, v in b.vars.items()
            if v.is_data}
    scopes = ctx.scopes or _scope_names(ops, sections)
    sec_end = {k: bs.pos for k, bs in enumerate(sections)}
    state_bytes = 0
    for n in sorted(persist):
        b = ctx.bytes_of(n, ctx.env.get(n, REPLICATED))
        state_bytes += b or 0

    # def/last-use intervals over produced intermediates; last_read
    # covers EVERY name in one pass (grads look their consumer up here
    # instead of rescanning the op list per gradient)
    produced_at = {}
    last_use = {}
    last_read = {}
    for i, op in enumerate(ops):
        for n in op.output_names():
            if n in persist or n in data:
                continue
            produced_at.setdefault(n, i)
        for n in op.input_names():
            last_read[n] = i
            if n in produced_at:
                last_use[n] = i
    grads = {}
    for k, bs in enumerate(sections):
        for p in bs.param_names:
            grads[facts.grad_name(p)] = bs.pos
    for n, i in produced_at.items():
        if n in fetch_names:
            last_use[n] = len(ops)
        # forward activations are re-read by the section backward
        for k, bs in enumerate(sections):
            if i < bs.pos:
                last_use[n] = max(last_use.get(n, i), bs.pos)
                break
    events = {}            # pos -> byte delta
    buffers = []
    for n, i in produced_at.items():
        bts = ctx.bytes_of(n, ctx.env.get(n, REPLICATED))
        if not bts:
            continue
        end = last_use.get(n, i)
        events[i] = events.get(i, 0) + bts
        events[end + 1] = events.get(end + 1, 0) - bts
        buffers.append((n, i, end, bts))
    for g, pos in grads.items():
        bts = ctx.bytes_of(g, ctx.env.get(g, REPLICATED))
        if not bts:
            continue
        end = max(last_read.get(g, pos), pos)
        events[pos] = events.get(pos, 0) + bts
        events[end + 1] = events.get(end + 1, 0) - bts
        buffers.append((g, pos, end, bts))
    timeline = []
    live = 0
    peak, peak_pos = 0, 0
    for pos in sorted(events):
        live += events[pos]
        timeline.append((pos, live))
        if live > peak:
            peak, peak_pos = live, pos
    per_scope = {}
    top = []
    for n, i, end, bts in buffers:
        if i <= peak_pos <= end:
            scope = scopes[i] if i < len(scopes) else "update"
            per_scope[scope] = per_scope.get(scope, 0) + bts
            top.append({"var": n, "scope": scope, "bytes": bts,
                        "spec": ctx.env.get(n, REPLICATED).render()})
    top.sort(key=lambda d: -d["bytes"])
    return {
        "peak_bytes": peak,
        "peak_pos": peak_pos,
        "state_bytes": state_bytes,
        "total_bytes": peak + state_bytes,
        "per_scope": dict(sorted(per_scope.items(),
                                 key=lambda kv: -kv[1])),
        "top_buffers": top[:16],
        "timeline": timeline[:240],
        "per_shard": True,
    }


# ---------------------------------------------------------------------------
# the analyzer entry point
# ---------------------------------------------------------------------------

class ShardingAnalysis:
    """One full analyzer run: match report + per-edge specs + PT3xx
    diagnostics + implied-collective plan + static memory estimate."""

    def __init__(self, program, rules, report, ctx, memory,
                 program_key=None):
        self.program = program
        self.rules = rules
        self.report = report
        self.specs = dict(ctx.env)
        self.diagnostics = list(ctx.diags)
        self.collectives = list(ctx.collectives)
        self.notes = list(ctx.notes)
        self.memory = memory
        self.program_key = program_key

    def result(self):
        return LintResult(self.diagnostics,
                          program_key=self.program_key)

    def collective_table(self):
        """Aggregate cost table: {(kind, axes-tuple): {"count",
        "bytes"}} — the bytes-x-mesh-axis view per implied collective
        class."""
        out = {}
        for rec in self.collectives:
            key = (rec["kind"], tuple(rec["axes"]))
            d = out.setdefault(key, {"count": 0, "bytes": 0})
            d["count"] += 1
            d["bytes"] += rec["bytes"]
        return out

    def dp_sync_plan(self, axis="dp"):
        """The predicted dp gradient-sync collectives (the records
        planned through transpiler.collective's bucket planner): what
        the conformance harness compares against the executed
        ``last_sync_stats`` / ``dp_grad_sync`` scopes."""
        recs = [r for r in self.collectives
                if "dp_grad_sync" in (r.get("scope") or "")
                and axis in r["axes"]]
        return {"count": len(recs),
                "bytes": sum(r["bytes"] for r in recs),
                "records": recs}

    def to_record(self):
        table = {f"{kind}@{'x'.join(axes)}": dict(v)
                 for (kind, axes), v in self.collective_table().items()}
        return {
            "kind": "sharding",
            "key": self.program_key,
            "mesh": self.rules.mesh.to_dict(),
            "rules": len(self.rules.rules),
            "claimed": len(self.report["claimed"]),
            "fallthrough": len(self.report["fallthrough"]),
            "unmatched_rules": self.report["unmatched_rules"],
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "collectives": table,
            "notes": self.notes[:8],
            "peak_bytes": (self.memory or {}).get("peak_bytes"),
            "state_bytes": (self.memory or {}).get("state_bytes"),
        }

    def render(self):
        lines = [f"sharding analysis ({self.rules.mesh!r}, "
                 f"{len(self.rules.rules)} rules): "
                 f"{len(self.report['claimed'])} vars claimed, "
                 f"{len(self.report['fallthrough'])} fell through"]
        for d in self.diagnostics:
            lines.append("  " + d.render())
        for (kind, axes), v in sorted(self.collective_table().items()):
            lines.append(f"  implied {kind} over {'x'.join(axes)}: "
                         f"{v['count']} x, {v['bytes']} bytes")
        if self.memory:
            lines.append(f"  static per-shard peak: "
                         f"{self.memory['peak_bytes']} bytes (+ state "
                         f"{self.memory['state_bytes']})")
        return "\n".join(lines)


def analyze(program, rules, fetch_names=None, feed_names=(),
            feed_shapes=None, program_key=None):
    """THE static sharding analysis: rule match -> PT301/302 ->
    propagation (PT303/304/305 + implied collectives) -> PT306 ->
    static memory estimate.  Pure ProgramDesc analysis; no run, no
    device."""
    from .. import flags

    report, ctx = propagate(program, rules, fetch_names=fetch_names,
                            feed_names=feed_names,
                            feed_shapes=feed_shapes)
    # PT301 — a TRAINABLE param no rule claimed (frozen params and
    # optimizer state fall through quietly: replicated is the safe
    # default there; a trainable miss is almost always a typo'd rule)
    classes = ctx.classes if ctx.classes is not None \
        else _var_classes(program)

    def _var_callsite(name):
        for b in program.blocks:
            v = b.vars.get(name)
            if v is not None:
                return getattr(v, "callsite", None)
        return None

    pre = []
    for name in report["fallthrough"]:
        if classes.get(name) != "param":
            continue
        d = Diagnostic(
            "PT301",
            f"trainable parameter '{name}' matched no partition rule "
            f"and fell through to replicated; add a rule (a final "
            f"('.*', []) catch-all makes replication explicit)",
            callsite=_var_callsite(name), var=name)
        pre.append(d)
    # PT302 — replicated param above the byte threshold (the giant
    # embedding the rule set forgot to shard)
    threshold = int(flags.flag("replicated_param_bytes"))
    if threshold > 0:
        for name, cls in sorted(classes.items()):
            if cls not in ("param", "persist"):
                continue
            spec = ctx.env.get(name, REPLICATED)
            if not spec.is_replicated:
                continue
            bts = ctx.bytes_of(name, REPLICATED)
            if bts and bts > threshold:
                pre.append(Diagnostic(
                    "PT302",
                    f"parameter '{name}' ({bts} bytes) is replicated "
                    f"on every device — above "
                    f"FLAGS_replicated_param_bytes={threshold}; shard "
                    f"it (or raise the threshold if intentional)",
                    callsite=_var_callsite(name), var=name))
    ctx.diags[:0] = pre
    memory = estimate_memory(program, ctx, fetch_names=fetch_names)
    return ShardingAnalysis(program, rules, report, ctx, memory,
                            program_key=program_key)


# ---------------------------------------------------------------------------
# spec -> NamedSharding lowering (the GSPMD runtime tier's static half)
# ---------------------------------------------------------------------------

def _inherit_optimizer_specs(specs, classes, shapes):
    """Optimizer accumulators mirror their parameter's layout (the
    ``shard_train_state`` contract): an accumulator named
    ``{param}_{opt}_{slot}`` with the PARAMETER's shape inherits the
    parameter's (partial-cleared) spec; shape-mismatched slots
    (beta-pow scalars) stay replicated.  A rule that explicitly shards
    an accumulator wins — only replicated accumulators inherit.
    Returns the {name: spec} overrides only."""
    params = sorted(
        (n for n, c in classes.items() if c in ("param", "persist")),
        key=len, reverse=True)
    out = {}
    for name, cls in classes.items():
        if cls != "optimizer":
            continue
        if not specs.get(name, REPLICATED).is_replicated:
            continue
        vs = shapes.get(name)
        for p in params:
            if not (name.startswith(p) and len(name) > len(p)
                    and name[len(p)] in "._"):
                continue
            pspec = specs.get(p, REPLICATED)
            if not pspec.is_replicated:
                pvs = shapes.get(p)
                if vs is not None and pvs is not None \
                        and vs.shape is not None \
                        and tuple(vs.shape) == tuple(pvs.shape):
                    out[name] = pspec.clear_partial()
            break
    return out


class ShardingPlan:
    """The concrete lowering of one rule set over one program: what the
    executor's SPMD tier places, pins, and prices.

    - ``state_specs`` — per-persistable ShardSpec for device placement
      (donated optimizer state inherits its parameter's layout);
    - ``constraints`` — ``[(op_index, var, ShardSpec)]`` activation
      pins at the edges the propagator marked (attention qkv/out, ffn
      up/down, the vocab-sharded embedding): the executor inserts
      ``with_sharding_constraint`` exactly there;
    - ``model_collectives`` — the implied-collective records over
      NON-data mesh axes (the mp psums): the table the executed
      ``last_sync_stats`` must reproduce;
    - ``memory`` — the static per-shard estimate re-run WITH the
      optimizer-state inheritance, so the number the runtime
      mem-profile is compared against prices the layout that actually
      executes.

    ``op_records`` is the port's per-op record: for each op index, the
    spec each input is consumed at, the collectives implied on those
    edges, and the spec of each output (see ``_OpTrace``)."""

    def __init__(self, program, rules, report, ctx, state_specs,
                 constraints, model_collectives, memory):
        self.program = program
        self.rules = rules
        self.report = report
        self.specs = dict(ctx.env)
        self.classes = dict(ctx.classes or {})
        self.shapes = ctx.shapes
        self.mesh_axes = dict(rules.mesh.axes)
        self.data_axis = rules.data_axis
        self.state_specs = state_specs
        self.constraints = constraints
        self.model_collectives = model_collectives
        self.memory = memory
        self.op_records = dict(getattr(ctx, "op_records", None) or {})
        self.scopes = list(ctx.scopes)
        self._mesh = rules.mesh

    def fingerprint(self):
        """Cache identity: rule set + mesh + data axis (the executor's
        compiled-step cache key includes this, so re-attaching a
        different rule set retraces instead of serving a stale
        layout)."""
        return self.rules.fingerprint()

    def body_spec(self, spec):
        """`spec` with the data axis STRIPPED: inside a dp rank the
        arrays are per-dp-shard locals (the data-parallel tier splits
        the feeds), so the specs there may only name model axes."""
        if spec.dims is None:
            return ShardSpec(None)
        return ShardSpec(
            tuple(None if d == self.data_axis else d
                  for d in spec.dims))

    def model_sync_records(self):
        """The predicted model-parallel collective records (kind,
        axes, var, bytes, op_index, scope) — what the executor notes
        into ``last_sync_stats`` at trace time, making predicted ==
        executed true by construction (the dp bucket-planner
        philosophy extended to mp)."""
        return [dict(r) for r in self.model_collectives]

    def collective_table(self):
        """{(kind, axes): {count, bytes}} over the model collectives."""
        out = {}
        for rec in self.model_collectives:
            key = (rec["kind"], tuple(rec["axes"]))
            d = out.setdefault(key, {"count": 0, "bytes": 0})
            d["count"] += 1
            d["bytes"] += rec["bytes"]
        return out

    def per_var_table(self):
        """[{var, class, spec, full_bytes, shard_bytes}] over every
        persistable (and data) var — the ``--lower`` CLI's plan print
        and the per-leaf placement assertion's expected set."""
        rows = []
        for name in sorted(self.state_specs):
            spec = self.state_specs[name]
            vs = self.shapes.get(name)
            rows.append({
                "var": name,
                "class": self.classes.get(name, "persist"),
                "spec": spec.render(),
                "partition_spec": list(spec.dims or []),
                "full_bytes": full_bytes(vs, default_dim=1),
                "shard_bytes": shard_bytes(vs, spec, self._mesh,
                                           default_dim=1),
            })
        return rows

    def to_record(self):
        table = {f"{kind}@{'x'.join(axes)}": dict(v)
                 for (kind, axes), v in self.collective_table().items()}
        sharded = [r for r in self.per_var_table()
                   if r["partition_spec"]
                   and any(d for d in r["partition_spec"])]
        return {
            "kind": "sharding_plan",
            "mesh": dict(self.mesh_axes),
            "data_axis": self.data_axis,
            "state_vars": len(self.state_specs),
            "sharded_state_vars": len(sharded),
            "constraints": len(self.constraints),
            "model_collectives": table,
            "static_peak_bytes": (self.memory or {}).get("peak_bytes"),
            "static_state_bytes": (self.memory or {}).get("state_bytes"),
        }

    def render(self):
        mesh = ", ".join(f"{k}={v}" for k, v in self.mesh_axes.items())
        lines = [f"sharding plan on mesh {{{mesh}}} "
                 f"(data axis {self.data_axis!r}):"]
        for r in self.per_var_table():
            sb = r["shard_bytes"]
            fb = r["full_bytes"]
            lines.append(
                f"  {r['var']:<40s} {r['spec']:<16s} "
                f"{'' if sb is None else sb} / "
                f"{'' if fb is None else fb} bytes/shard"
                f" [{r['class']}]")
        lines.append(f"  {len(self.constraints)} activation constraint"
                     f"{'s' if len(self.constraints) != 1 else ''}")
        for (kind, axes), v in sorted(self.collective_table().items()):
            lines.append(f"  implied {kind} over {'x'.join(axes)}: "
                         f"{v['count']} x, {v['bytes']} bytes")
        if self.memory:
            lines.append(f"  static per-shard peak: "
                         f"{self.memory['peak_bytes']} bytes (+ state "
                         f"{self.memory['state_bytes']})")
        return "\n".join(lines)


def lower(program, rules, fetch_names=None, feed_names=(),
          feed_shapes=None):
    """Lower a rule set over a program into a :class:`ShardingPlan`:
    run the propagation, inherit optimizer-state layouts from
    their parameters, collect the activation-edge constraint set and
    the model-axis collective records, and re-price the static
    per-shard memory for the layout that will actually execute.  Pure
    analysis — no run; the executor (and the ``--lower``
    CLI) consume the result."""
    report, ctx = propagate(program, rules, fetch_names=fetch_names,
                            feed_names=feed_names,
                            feed_shapes=feed_shapes)
    classes = ctx.classes or _var_classes(program)
    persist = {n for n, c in classes.items()
               if c in ("param", "persist", "optimizer")}
    model_axes = set(rules.mesh.axes) - {rules.data_axis}

    # state placement: the var's final propagated spec (partial
    # markers cleared — placement is a layout, not a pending psum),
    # optimizer slots inheriting their parameter's layout
    state_specs = {}
    for n in sorted(persist):
        state_specs[n] = ctx.env.get(n, REPLICATED).clear_partial()
    inherited = _inherit_optimizer_specs(state_specs, classes,
                                         ctx.shapes)
    state_specs.update(inherited)

    # activation pins: every forward-op output whose propagated spec
    # names a model axis — exactly the edges the propagator marked
    # (qkv/ffn column outputs and their reshapes/transposes, the
    # vocab-sharded embedding's sharded head).  Partial-only specs are
    # NOT pinned: the owed psum is GSPMD's to place at the dot.
    constraints = []
    blk = program.global_block()
    ops = list(blk.ops)
    for i, op in enumerate(ops):
        if not ctx.hot(i) and ctx.fwd_limit:
            break
        for o in op.output_names():
            if o in persist:
                continue
            spec = ctx.env.get(o)
            if spec is None or spec.dims is None:
                continue
            if not (set(spec.sharded_axes()) & model_axes):
                continue
            constraints.append((i, o, spec.clear_partial()))

    model_collectives = [
        r for r in ctx.collectives
        if set(r["axes"]) & model_axes]

    # re-price the static memory with the INHERITED optimizer layout:
    # this is the estimate the runtime conformance compares against,
    # so it must price the state the executor actually places
    for n, spec in inherited.items():
        ctx.env[n] = spec
    # the per-op records follow the placed layout too: an optimizer op
    # consumes and writes its moments where they are held
    for rec in ctx.op_records.values():
        for table in (rec.consumed, rec.kept, rec.outputs):
            for n in table:
                if n in inherited:
                    table[n] = inherited[n]
    memory = estimate_memory(program, ctx, fetch_names=fetch_names)
    return ShardingPlan(program, rules, report, ctx, state_specs,
                        constraints, model_collectives, memory)
