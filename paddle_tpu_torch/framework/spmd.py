"""The GSPMD runtime tier: a Program run under its partition rules
(port of the spmd branch of paddle_tpu/framework/executor.py).

The reference lowers `CompiledProgram(...).with_sharding_rules(rules,
execute=True)` to one step whose data axis is manual and whose model
axes its compiler partitions (GSPMD).  The port executes the same
`analysis.sharding.lower` plan by hand, rank by rank:

- **state** — the startup runs replicated; at the first run each rank of
  the model axes keeps only its block of every persistable the plan
  shards (`plan.state_specs`, optimizer moments with their parameter),
  held in the scope as a :class:`ShardedValue`, so a rank's resident
  state is the plan's per-shard figure;
- **ops** — each rank runs every op on its local tensors, following the
  plan's per-op record (`ShardingPlan.op_records`).  Before op i each
  input goes from its current layout to the one op i consumes it at: a
  pending partial is all-reduced, a sharded dim that must be whole is
  all-gathered, a changed placement is an all-to-all, and a replicated
  input the op takes sharded is sliced locally (no collective).
  Attributes that hold global shapes (`reshape2`'s shape, the fused
  attention's head count) are made local from the record, never
  guessed from tensor sizes; a vocab-sharded lookup masks the ids
  outside its block; a mean over a sharded dim divides by the global
  count.  Each output's local shape is checked against the plan;
- **autograd** — every rank computes the same loss, and each collective
  has the backward the multi-process collective has (tensor
  parallelism's rules, `distributed/tensor_parallel.py`): an all-reduce
  that resolves a partial passes its cotangent through, an all-gather
  gives back the rank's block, an all-to-all the reverse exchange; a
  replicated input of an op whose outputs differ between the ranks of
  an axis (`sum_grad`, Megatron's f) sums its cotangent over that axis.
  The grads are then the unsharded program's, block by block.  Ranks
  held in one process take one backward over the ranks of their data
  coordinate (`inprocess.joint_grad`);
- **counts** — every collective a rank executes is counted;
  `transpiler.collective.last_sync_stats()["model"]` holds rank 0's
  (`note_model_sync`), so executed and planned tables can be compared;
- **fetches** — come back replicated over the model axes (the gather
  or all-reduce this takes is counted apart, under "fetch"), then
  merged over dp as the data-parallel tier merges them.

The data axis must be "dp" and runs the data-parallel tier unchanged:
feed shards, the bucketed gradient sync, the state sync and the fetch
merge.  Recompute checkpoints run without recompute here.
"""

import math

import torch

from ..analysis import sharding as sh
from ..distributed import collective as C
from . import executor as _ex

__all__ = ["ShardedValue", "RankRuntime", "shard_state", "whole"]


class ShardedValue:
    """A persistable held over a rule mesh: `shards` {global rank: local
    tensor} (every rank of an in-process mesh; this rank alone over a
    process group), `spec` its layout (a body spec: model axes only),
    `coords` {global rank: {axis: (index, size)}} and the global shape.
    `full()` assembles the global tensor from the shards it holds."""

    __slots__ = ("shards", "spec", "coords", "shape")

    def __init__(self, shards, spec, coords, shape):
        self.shards = dict(shards)
        self.spec = spec
        self.coords = dict(coords)
        self.shape = tuple(shape)

    @property
    def dtype(self):
        return next(iter(self.shards.values())).dtype

    def local(self, rank):
        return self.shards[rank]

    def nbytes(self, rank):
        t = self.shards[rank]
        return t.numel() * t.element_size()

    def full(self):
        """The global tensor (on the first shard's device).  Raises when
        the shards held do not cover every block."""
        first = next(iter(self.shards.values()))
        dims = list(sh._aligned(self.spec, len(self.shape)).dims
                    or (None,) * len(self.shape))
        if all(a is None for a in dims):
            return first
        out = torch.empty(self.shape, dtype=first.dtype,
                          device=first.device)
        seen = set()
        for r, t in self.shards.items():
            index, key = [], []
            for d, a in enumerate(dims):
                if a is None:
                    index.append(slice(None))
                    continue
                pos, size = self.coords[r][a]
                blk = self.shape[d] // size
                index.append(slice(pos * blk, (pos + 1) * blk))
                key.append((d, pos))
            key = tuple(key)
            if key not in seen:
                seen.add(key)
                out[tuple(index)] = t.to(out.device)
        blocks = math.prod(self.coords[next(iter(self.coords))][a][1]
                           for a in dims if a is not None)
        if len(seen) != blocks:
            raise RuntimeError(
                f"sharded value of shape {self.shape} under "
                f"{self.spec.render()}: this process holds {len(seen)} "
                f"of its {blocks} blocks; gather it on the mesh instead")
        return out

    def __repr__(self):
        return (f"ShardedValue({self.spec.render()}, shape={self.shape}, "
                f"ranks={sorted(self.shards)})")


def _body(plan, spec):
    """`spec` over the model axes only: the data axis stripped (the dp
    tier splits the feeds), partial markers over it too."""
    if spec is None:
        return sh.REPLICATED
    dims = None if spec.dims is None else tuple(
        None if d == plan.data_axis else d for d in spec.dims)
    return sh.ShardSpec(dims, spec.partial - {plan.data_axis})


def _dims(spec, rank):
    return list(sh._aligned(spec, rank).dims or (None,) * rank)


def _nbytes(t):
    return t.numel() * t.element_size()


def shard_state(value, plan, name, mesh):
    """This rank's block of a replicated persistable under the plan."""
    spec = _body(plan, plan.state_specs.get(name))
    local = sh.local_slice(value, spec, mesh.coords())
    return local.to(mesh.device).clone()


class RankRuntime:
    """One rank's executor of a `ShardingPlan` (see the module
    docstring): `run_op` stands in for `executor.run_op`, `layout` maps
    each value of the rank's env to its body spec, `records` lists the
    collectives the rank executed on op edges and `fetch_records` those
    of the fetch merge."""

    def __init__(self, plan, mesh, index_of):
        self.plan = plan
        self.mesh = mesh
        self.index_of = index_of
        self.model_axes = [a for a in mesh.names
                           if a != plan.data_axis and mesh.axis_size(a) > 1]
        self.layout = {}
        self.records = []
        self.fetch_records = []

    # -- layouts and transitions ----------------------------------------
    def spec_of(self, name):
        return self.layout.get(name, sh.REPLICATED)

    def _size(self, a):
        return self.mesh.axis_size(a)

    def _model(self, axes):
        return sorted(a for a in axes if a in self.model_axes)

    def _note(self, out, kind, axes, name, t, i):
        out.append({"kind": kind, "axes": axes, "var": name,
                    "bytes": _nbytes(t), "op_index": i,
                    "scope": self.plan.scopes[i]
                    if i is not None and i < len(self.plan.scopes)
                    else "update/fetch"})

    def resolve(self, name, t, spec, i, out=None):
        """All-reduce a pending partial over its model axes (the
        backward passes the cotangent through)."""
        axes = self._model(spec.partial)
        if not axes:
            return t, spec.clear_partial()
        for a in axes:
            t = C.reduce_sum(t, a, mesh=self.mesh)
        self._note(self.records if out is None else out, "all_reduce",
                   axes, name, t, i)
        return t, spec.clear_partial()

    def transition(self, name, t, src, dst, i, out=None):
        """`t` (laid out as `src`) laid out as `dst`, both without
        partials: all-to-all for an axis that changes dims, all-gather
        for an axis that goes, a local slice (its cotangent summed over
        the axis) for an axis that comes."""
        r = t.dim()
        sd = [a if a in self.model_axes else None for a in _dims(src, r)]
        dd = [a if a in self.model_axes else None for a in _dims(dst, r)]
        if sd == dd:
            return t
        moved, gone = [], []
        for i_src, a in enumerate(sd):
            if a is None:
                continue
            if a in dd:
                j = dd.index(a)
                if j != i_src:
                    t = C.all_to_all(t, a, split_axis=j, concat_axis=i_src,
                                     mesh=self.mesh)
                    moved.append(a)
            else:
                t = C.all_gather(t, a, axis=i_src, tiled=True,
                                 mesh=self.mesh, grad="slice")
                gone.append(a)
        for j, a in enumerate(dd):
            if a is None or a in sd:
                continue
            n = t.shape[j]
            size = self._size(a)
            if n % size:
                raise RuntimeError(
                    f"'{name}': dim {j} of local size {n} does not split "
                    f"over mesh axis {a!r} of size {size}")
            blk = n // size
            t = C.sum_grad(t, a, mesh=self.mesh)
            t = t.narrow(j, self.mesh.axis_index(a) * blk, blk)
        if gone or moved:
            # an all-to-all moves as many bytes as it returns
            self._note(self.records if out is None else out,
                       "all_gather" if gone else "all_to_all",
                       sorted(set(gone + moved)), name, t, i)
        return t

    # -- one op ------------------------------------------------------------
    def run_op(self, op, env, generator):
        i = self.index_of.get(id(op))
        rec = self.plan.op_records.get(i) if i is not None else None
        if rec is None:
            raise RuntimeError(
                f"op '{op.type}' has no record in the sharding plan; the "
                f"GSPMD tier runs the program the plan was lowered on")
        local = {}
        consumed = {}
        for n, want in rec.consumed.items():
            if n not in env:
                continue
            t = env[n]
            spec = self.spec_of(n)
            for kind, _src, dst in rec.steps.get(n, ()):
                if spec.partial:
                    t, spec = self.resolve(n, t, spec, i)
                if kind == "reshard":
                    body = _body(self.plan, dst).clear_partial()
                    t = self.transition(n, t, spec, body, i)
                    spec = body
            if spec.partial:
                t, spec = self.resolve(n, t, spec, i)
            stepped, stepped_spec = t, spec
            want = _body(self.plan, want).clear_partial()
            t = self.transition(n, t, spec, want, i)
            local[n], consumed[n] = t, want
            kept = _body(self.plan, rec.kept.get(n, want))
            if kept == want:
                env[n], self.layout[n] = t, want
            elif kept == stepped_spec:
                env[n], self.layout[n] = stepped, stepped_spec
        if op.type in _REPLICATED_OUT:
            # the analyzer gives these replicated outputs without a
            # collective; on a sharded input the op needs the whole
            # tensor (counted: the plan does not price it)
            for n, spec in list(consumed.items()):
                if spec.sharded_axes() and set(spec.sharded_axes()) \
                        & set(self.model_axes):
                    local[n] = self.transition(n, local[n], spec,
                                               sh.REPLICATED, i)
                    consumed[n] = sh.REPLICATED
        outs = {n: _body(self.plan, s) for n, s in rec.outputs.items()}
        self._sum_grads(local, consumed, outs)
        lop = _LocalOp(op, self._local_attrs(op, consumed, outs))
        if op.type in ("lookup_table", "lookup_table_v2"):
            self._lookup(op, lop, local, consumed, generator)
        else:
            _ex.run_op(lop, local, generator)
        if op.type in ("mean", "reduce_mean"):
            self._mean_scale(op, local, consumed, outs)
        for n, spec in outs.items():
            if n in local:
                env[n] = local[n]
                self.layout[n] = spec
                self._check(op, i, n, local[n], rec.outputs[n])

    def _sum_grads(self, local, consumed, outs):
        """Megatron's f: an input replicated over an axis the op's
        outputs (or other inputs) differ over sums its cotangent over
        that axis."""
        if not torch.is_grad_enabled():
            return
        diverge = set()
        for spec in list(consumed.values()) + list(outs.values()):
            diverge |= set(spec.sharded_axes()) | set(spec.partial)
        diverge &= set(self.model_axes)
        if not diverge:
            return
        for n, spec in consumed.items():
            t = local[n]
            if not (isinstance(t, torch.Tensor) and t.requires_grad):
                continue
            for a in sorted(diverge - set(spec.sharded_axes())):
                t = C.sum_grad(t, a, mesh=self.mesh)
            local[n] = t

    def _local_attrs(self, op, consumed, outs):
        attrs = dict(op.attrs)
        if op.type in ("reshape", "reshape2") and attrs.get("shape"):
            out = (op.outputs.get("Out") or [None])[0]
            spec = outs.get(out, sh.REPLICATED)
            shape = list(attrs["shape"])
            for d, a in enumerate(_dims(spec, len(shape))):
                if a in self.model_axes and shape[d] > 0:
                    shape[d] //= self._size(a)
            attrs["shape"] = shape
        elif op.type == "fused_attention" \
                and int(attrs.get("head_number", 0)) > 0:
            q = (op.inputs.get("Q") or [None])[0]
            a = _dims(consumed.get(q, sh.REPLICATED), 3)[2]
            if a in self.model_axes:
                attrs["head_number"] = int(attrs["head_number"]) \
                    // self._size(a)
        return attrs

    def _lookup(self, op, lop, local, consumed, generator):
        """A vocab-sharded table: this rank's block of rows looks up the
        ids that fall in it, the rest give zero rows (the partial the
        plan resolves with one all-reduce)."""
        ids_n = (op.inputs.get("Ids") or [None])[0]
        w_n = (op.inputs.get("W") or [None])[0]
        a = _dims(consumed.get(w_n, sh.REPLICATED), 2)[0]
        if a not in self.model_axes:
            _ex.run_op(lop, local, generator)
            return
        ids, w = local[ids_n], local[w_n]
        rows = w.shape[0]
        vocab = rows * self._size(a)
        lo = self.mesh.axis_index(a) * rows
        ids = torch.where(ids < 0, ids + vocab, ids)
        inside = (ids >= lo) & (ids < lo + rows)
        attrs = dict(lop.attrs)
        pad = attrs.get("padding_idx", -1)
        if pad is not None and pad >= 0:
            attrs["padding_idx"] = pad - lo if lo <= pad < lo + rows else -1
        sub = dict(local)
        sub[ids_n] = torch.where(inside, ids - lo, torch.zeros_like(ids))
        _ex.run_op(_LocalOp(op, attrs), sub, generator)
        for n in op.output_names():
            y = sub[n]
            local[n] = y * inside.unsqueeze(-1).to(y.dtype)

    def _mean_scale(self, op, local, consumed, outs):
        """A mean over a sharded dim: the local mean over the block
        divided by the blocks' count, so the pending partial sums to the
        global mean."""
        xn = (op.inputs.get("X") or [None])[0]
        out = (op.outputs.get("Out") or [None])[0]
        new = set(outs.get(out, sh.REPLICATED).partial) \
            - set(consumed.get(xn, sh.REPLICATED).partial)
        k = math.prod(self._size(a) for a in new if a in self.model_axes)
        if k > 1 and out in local:
            local[out] = local[out] / k

    def _check(self, op, i, name, t, spec):
        """Each model-sharded (and dp-sharded) dim of an output has the
        local size the plan implies."""
        vs = self.plan.shapes.get(name)
        if vs is None or vs.shape is None or not isinstance(t, torch.Tensor):
            return
        shape = list(vs.shape)
        if len(shape) != t.dim() or any(s is None for s in shape):
            return
        for d, a in enumerate(_dims(spec, len(shape))):
            if a is None:
                continue
            size = (self._size(a) if a in self.model_axes
                    else self.mesh.axis_size(a) if a in self.mesh.names
                    else 1)
            if shape[d] // size != t.shape[d]:
                raise RuntimeError(
                    f"op '{op.type}' #{i}: output '{name}' has local shape "
                    f"{tuple(t.shape)}, but {spec.render()} over global "
                    f"{tuple(shape)} makes dim {d} {shape[d] // size}")

    # -- the section's loss and the fetches -------------------------------
    def loss_value(self, name, t):
        """The section's loss, all-reduced first if it is still a
        partial over a model axis."""
        spec = self.spec_of(name)
        if set(spec.partial) & set(self.model_axes):
            t, spec = self.resolve(name, t, spec, None)
            self.layout[name] = spec
        return t

    def fetch(self, name, t):
        """A fetched value replicated over the model axes."""
        spec = self.spec_of(name)
        if set(spec.partial) & set(self.model_axes):
            t, spec = self.resolve(name, t, spec, None,
                                   out=self.fetch_records)
        return self.transition(name, t, spec.clear_partial(),
                               sh.REPLICATED, None, out=self.fetch_records)


# op families the analyzer binds replicated outputs to with no collective
_REPLICATED_OUT = frozenset((
    "top_k", "top_k_v2", "arg_max", "arg_min", "accuracy", "shape",
    "fill_constant_batch_size_like"))


class _LocalOp:
    """An op with this rank's attributes (the recorded op is shared by
    the ranks and the plan, so it is never edited)."""

    __slots__ = ("type", "inputs", "outputs", "attrs", "callsite")

    def __init__(self, op, attrs):
        self.type = op.type
        self.inputs = op.inputs
        self.outputs = op.outputs
        self.attrs = attrs
        self.callsite = getattr(op, "callsite", None)

    def input_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    def output_names(self):
        return [n for ns in self.outputs.values() for n in ns]


def whole(value):
    """A `ShardedValue` (or a tensor) as one tensor."""
    return value.full() if isinstance(value, ShardedValue) else value
