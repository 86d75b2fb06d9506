"""Collective communication (port of paddle_tpu/distributed/collective.py).

Two forms, as in the reference:
- the in-step collectives (`all_reduce`, `psum`, `all_gather`,
  `ppermute`, `all_to_all`, ...) take this rank's tensor, as the
  reference's take a shard inside shard_map, and return a new tensor;
  the input is left as it was.  `axis_name` picks the mesh axis whose
  process group they run on: "pp", "dp", "sp", "tp" or "ep", or an axis
  of a rule mesh (`mesh.build_rule_mesh`, "mp" say);
- the `eager_*` forms take a global array, as the reference's take one
  sharded over an axis: rank r works on the r-th 1/size block of dim 0,
  and a result sharded over the axis comes back as the global array
  again (concatenated over the ranks).

All run on the mesh's group for the axis (`mesh=None`: the default
mesh); on an axis of size 1 they are the identity.  On a mesh of ranks
held in one process (`inprocess.local_meshes`) the group is a
`LocalGroup` and the same calls exchange the ranks' tensors in memory,
with the same forward and backward.  A mean is a SUM
followed by a division by the group's size, on both backends
(`ReduceOp.AVG` is NCCL-only).  `all_gather`, `ppermute` and
`all_to_all` are differentiable, with the transposes of the reference's
`lax` collectives: a reduce-scatter (sum), the inverse permutation, and
the reverse exchange; `sum_grad` (the identity, its backward a sum) and
`reduce_sum` (a sum, its backward the identity) are the conjugate pair
of tensor parallelism.
"""

from functools import partial

import torch
import torch.distributed as dist

from . import inprocess
from .inprocess import LocalGroup

__all__ = [
    "all_reduce", "all_gather", "reduce_scatter", "broadcast", "ppermute",
    "all_to_all", "psum", "pmean", "pmax", "pmin",
    "eager_all_reduce", "eager_all_gather", "eager_broadcast",
    "eager_reduce_scatter", "sum_grad", "reduce_sum", "barrier",
    "all_reduce_", "all_reduce_many_",
]

_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "prod": dist.ReduceOp.PRODUCT}
_AXES = ("pp", "dp", "sp", "tp", "ep")


class _Axis:
    """One mesh axis as this rank sees it: group, size, index, ranks."""

    def __init__(self, mesh, name):
        self.group = mesh.axis_group(name)
        self.size = mesh.axis_size(name)
        self.index = mesh.axis_index(name)
        self.ranks = mesh.axis_ranks(name)
        self.local = self.group is None
        self.inproc = isinstance(self.group, LocalGroup)


def _mesh(mesh, axis_name):
    from .mesh import default_mesh

    names = getattr(mesh, "names", _AXES)
    if axis_name not in names:
        raise ValueError(f"unknown mesh axis {axis_name!r}; axes are "
                         f"{names}")
    return mesh or default_mesh()


def _axis(mesh, axis_name):
    return _Axis(_mesh(mesh, axis_name), axis_name)


def all_reduce_(x, op="sum", mesh=None, axis_name="dp"):
    """In-place all_reduce of `x` over the mesh axis; returns `x`."""
    if op not in _OPS:
        raise ValueError(f"unknown reduce op {op}")
    ax = _axis(mesh, axis_name)
    if ax.inproc:
        red = _LOCAL_OPS[op]
        y = inprocess.collective(
            ax, x.detach(), lambda xs: [r.clone() for r in [red(xs)] * len(xs)])
        with torch.no_grad():
            x.copy_(y)
    elif not ax.local:
        dist.all_reduce(x, _OPS[op], group=ax.group)
    if op == "mean":
        x.div_(ax.size)
    return x


def all_reduce_many_(xs, op="sum", mesh=None, axis_name="dp"):
    """In-place all_reduce of each tensor of `xs` (one dtype) over the
    mesh axis, each reduced on its own: on a process group the
    collectives are issued as one coalesced launch (NCCL's grouped
    calls; a process group pays its per-call host cost once), over an
    in-process group one exchange carries them all (each tensor summed in
    rank order, as `all_reduce_` sums it).  Returns `xs`."""
    if op not in _OPS:
        raise ValueError(f"unknown reduce op {op}")
    ax = _axis(mesh, axis_name)
    if not ax.inproc:
        if ax.local or len(xs) < 2:
            return [all_reduce_(x, op, mesh, axis_name) for x in xs]
        with dist._coalescing_manager(group=ax.group):
            for x in xs:
                dist.all_reduce(x, _OPS[op], group=ax.group)
        if op == "mean":
            for x in xs:
                x.div_(ax.size)
        return xs
    red = _LOCAL_OPS[op]

    def combine(per_rank):
        # read-only results: every rank copies them into its own tensors
        out = [red([p[i] for p in per_rank]) for i in range(len(xs))]
        return [out] * len(per_rank)

    ys = inprocess.collective(ax, [x.detach() for x in xs], combine)
    with torch.no_grad():
        for x, y in zip(xs, ys):
            x.copy_(y)
            if op == "mean":
                x.div_(ax.size)
    return xs


def _stacked(fn):
    return lambda xs: fn(torch.stack(xs), 0)


_LOCAL_OPS = {"sum": inprocess.total, "mean": inprocess.total,
              "max": _stacked(lambda t, d: t.amax(d)),
              "min": _stacked(lambda t, d: t.amin(d)),
              "prod": _stacked(torch.prod)}


def all_reduce(x, axis_name="dp", op="sum", mesh=None):
    """c_allreduce_{sum,max,min,prod} parity, and the mean."""
    _mesh(mesh, axis_name)
    y = x.clone()
    if op == "mean" and not y.is_floating_point():
        y = y.float()
    return all_reduce_(y, op, mesh, axis_name)


psum = partial(all_reduce, op="sum")
pmean = partial(all_reduce, op="mean")
pmax = partial(all_reduce, op="max")
pmin = partial(all_reduce, op="min")


def _gather(x, ax, axis, tiled):
    if ax.local:
        return x.clone() if tiled else x.unsqueeze(axis).clone()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x.contiguous(), group=ax.group)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def _my_block(g, ax, axis, tiled):
    if not tiled:
        return g.select(axis, ax.index).contiguous()
    blk = g.shape[axis] // ax.size
    return g.narrow(axis, ax.index * blk, blk).contiguous()


class _AllGather(torch.autograd.Function):
    """all_gather whose backward is either the transpose of the
    reference's `lax.all_gather` (`grad="sum"`: a reduce-scatter, each
    rank's block summed over the group) or, where every rank of the
    group computes the same loss from the gathered tensor
    (`grad="slice"`), this rank's block of its own cotangent: summing
    the group's identical cotangents would count the loss `size`
    times."""

    @staticmethod
    def forward(ctx, x, ax, axis, tiled, grad):
        ctx.ax, ctx.axis, ctx.tiled, ctx.grad = ax, axis, tiled, grad
        return _gather(x, ax, axis, tiled)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        if ctx.grad == "sum" and not ax.local:
            g = g.contiguous().clone()
            dist.all_reduce(g, dist.ReduceOp.SUM, group=ax.group)
        return _my_block(g, ax, ctx.axis, ctx.tiled), None, None, None, None


def _local_gather(ax, x, axis, tiled, grad):
    def fwd(xs):
        y = torch.cat(xs, axis) if tiled else torch.stack(xs, axis)
        return [y.clone() for _ in xs]

    def bwd(gs):
        if grad == "sum":
            s = inprocess.total(gs)
            return [_my_block(s, _Pos(ax, i), axis, tiled)
                    for i in range(len(gs))]
        return [_my_block(g, _Pos(ax, i), axis, tiled)
                for i, g in enumerate(gs)]

    return inprocess.collective(ax, x.contiguous(), fwd, bwd)


class _Pos:
    """An axis seen from rank `index` of its group (in-process
    backwards give every rank its block)."""

    def __init__(self, ax, index):
        self.size, self.index = ax.size, index


def all_gather(x, axis_name="dp", axis=0, tiled=True, mesh=None,
               grad="sum"):
    """c_allgather parity: every rank's x, concatenated along `axis`
    (tiled) or stacked on a new `axis`.  Differentiable; see
    `_AllGather` for `grad`."""
    ax = _axis(mesh, axis_name)
    if ax.inproc:
        return _local_gather(ax, x, axis, tiled, grad)
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, ax, axis, tiled, grad)
    return _gather(x, ax, axis, tiled)


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the cotangent over the group:
    the input is the same on every rank, and each rank's loss reaches it
    through its own share of the work."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.ax.local:
            return g, None
        g = g.contiguous().clone()
        dist.all_reduce(g, dist.ReduceOp.SUM, group=ctx.ax.group)
        return g, None


def sum_grad(x, axis_name, mesh=None):
    """`x` unchanged; its gradient is summed over the axis's group
    (tensor parallelism's f: before a product split over the group)."""
    ax = _axis(mesh, axis_name)
    if not (torch.is_grad_enabled() and x.requires_grad) or ax.local:
        return x
    if ax.inproc:
        return inprocess.collective(
            ax, x, lambda xs: [t.clone() for t in xs],
            lambda gs: [s.clone() for s in [inprocess.total(gs)] * len(gs)])
    return _SumGrad.apply(x, ax)


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        y = x.contiguous().clone()
        dist.all_reduce(y, dist.ReduceOp.SUM, group=ax.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_sum(x, axis_name, mesh=None):
    """The sum of x over the axis's group, whose backward is the
    identity: every rank of the group computes the same loss from the
    sum, so each rank's cotangent is already the whole one (tensor
    parallelism's g: after a product split over the group)."""
    ax = _axis(mesh, axis_name)
    if ax.local:
        return x
    if ax.inproc:
        return inprocess.collective(
            ax, x.contiguous(),
            lambda xs: [s.clone() for s in [inprocess.total(xs)] * len(xs)],
            lambda gs: gs)
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceSum.apply(x, ax)
    y = x.contiguous().clone()
    dist.all_reduce(y, dist.ReduceOp.SUM, group=ax.group)
    return y


def barrier(mesh):
    """Every rank of the mesh's world waits for the others."""
    world = getattr(mesh, "world", None)
    if world is not None:
        world.group.exchange(mesh.world_rank, None,
                             lambda xs: [None] * len(xs))
    elif dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def reduce_scatter(x, axis_name="dp", scatter_axis=0, mesh=None):
    """c_reducescatter parity (tiled): the sum over the ranks of x,
    split into `size` blocks along `scatter_axis`; rank r keeps block r.
    It is an all_reduce and a slice, which gloo and NCCL both run."""
    ax = _axis(mesh, axis_name)
    n = x.shape[scatter_axis]
    if n % ax.size:
        raise ValueError(f"reduce_scatter: dim {scatter_axis} of size {n} "
                         f"does not split into {ax.size} blocks")
    total = all_reduce(x, axis_name, "sum", mesh)
    return _my_block(total, ax, scatter_axis, True)


def broadcast(x, axis_name="dp", root=0, mesh=None):
    """c_broadcast parity: every rank of the axis gets root's value."""
    ax = _axis(mesh, axis_name)
    if ax.inproc:
        return inprocess.collective(
            ax, x.detach(), lambda xs: [xs[root].clone() for _ in xs])
    y = x.clone()
    if not ax.local:
        dist.broadcast(y, ax.ranks[root], group=ax.group)
    return y


def _permute(x, ax, perm):
    """This rank's result of the permutation `perm` ((src, dst) pairs of
    axis indices): the tensor of the rank whose pair names this one as
    destination, zeros where none does (as `lax.ppermute` gives)."""
    me = ax.index
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for d in dsts:
        if d == me:
            out.copy_(x)
        else:
            ops.append(dist.P2POp(dist.isend, x, ax.ranks[d], ax.group))
    for s in srcs:
        if s != me:
            ops.append(dist.P2POp(dist.irecv, out, ax.ranks[s], ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _check_perm(perm, size):
    perm = [(int(s), int(d)) for s, d in perm]
    for s, d in perm:
        if not (0 <= s < size and 0 <= d < size):
            raise ValueError(f"ppermute: pair {(s, d)} outside the axis "
                             f"of size {size}")
    if len({s for s, _ in perm}) < len(perm) or \
            len({d for _, d in perm}) < len(perm):
        raise ValueError(f"ppermute: {perm} is not a permutation (a "
                         "source or a destination repeats)")
    return perm


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, perm):
        ctx.ax, ctx.perm = ax, perm
        return _permute(x, ax, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(g, ctx.ax, inverse), None, None


def ppermute(x, axis_name, perm, mesh=None):
    """`lax.ppermute` parity over the axis's group: for each (src, dst)
    pair of axis indices, rank dst gets rank src's x; a rank that is no
    one's destination gets zeros.  Point-to-point sends and receives in
    one batch; a pair onto itself is a local copy.  Differentiable: the
    backward sends the cotangent along the inverse permutation."""
    ax = _axis(mesh, axis_name)
    perm = _check_perm(perm, ax.size)
    if ax.inproc:
        def move(ts, pairs):
            out = [torch.zeros_like(t) for t in ts]
            for s, d in pairs:
                out[d] = ts[s].clone()
            return out

        inverse = [(d, s) for s, d in perm]
        return inprocess.collective(ax, x.contiguous(),
                                    lambda xs: move(xs, perm),
                                    lambda gs: move(gs, inverse))
    if torch.is_grad_enabled() and x.requires_grad:
        return _PPermute.apply(x, ax, perm)
    return _permute(x, ax, perm)


def _exchange(x, ax, split_axis, concat_axis):
    n = x.shape[split_axis]
    if n % ax.size:
        raise ValueError(f"all_to_all: dim {split_axis} of size {n} does "
                         f"not split into {ax.size} blocks")
    chunks = [c.contiguous() for c in torch.chunk(x, ax.size, split_axis)]
    if ax.local:
        got = chunks
    else:
        got = [torch.empty_like(c) for c in chunks]
        dist.all_to_all(got, chunks, group=ax.group)
    return torch.cat(got, concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.ax, ctx.split, ctx.concat = ax, split_axis, concat_axis
        return _exchange(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.ax, ctx.concat, ctx.split), None, None, None


def all_to_all(x, axis_name, split_axis, concat_axis, mesh=None):
    """`lax.all_to_all(..., tiled=True)` parity: x splits into `size`
    blocks along `split_axis`, block j goes to rank j of the axis, and
    the blocks received are concatenated along `concat_axis` in the
    order of the ranks they came from.  Differentiable: the backward is
    the reverse exchange."""
    ax = _axis(mesh, axis_name)
    if ax.inproc:
        def swap(ts, split, concat):
            n = len(ts)
            for t in ts:
                if t.shape[split] % n:
                    raise ValueError(
                        f"all_to_all: dim {split} of size {t.shape[split]} "
                        f"does not split into {n} blocks")
            parts = [torch.chunk(t, n, split) for t in ts]
            return [torch.cat([parts[i][j] for i in range(n)], concat)
                    for j in range(n)]

        return inprocess.collective(
            ax, x.contiguous(), lambda xs: swap(xs, split_axis, concat_axis),
            lambda gs: swap(gs, concat_axis, split_axis))
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, ax, split_axis, concat_axis)
    return _exchange(x, ax, split_axis, concat_axis)


# --- eager collectives over a global array ---------------------------------

def _block(x, ax):
    n = x.shape[0]
    if n % ax.size:
        raise ValueError(f"dim 0 of size {n} does not split over "
                         f"an axis of size {ax.size}")
    blk = n // ax.size
    return torch.as_tensor(x).narrow(0, ax.index * blk, blk).contiguous()


def eager_all_reduce(x, mesh=None, axis_name="dp", op="sum"):
    ax = _axis(mesh, axis_name)
    y = all_reduce(_block(x, ax), axis_name, op, mesh)
    return all_gather(y, axis_name, mesh=mesh)


def eager_all_gather(x, mesh=None, axis_name="dp"):
    ax = _axis(mesh, axis_name)
    return all_gather(_block(x, ax), axis_name, mesh=mesh)


def eager_reduce_scatter(x, mesh=None, axis_name="dp"):
    ax = _axis(mesh, axis_name)
    y = reduce_scatter(_block(x, ax), axis_name, mesh=mesh)
    return all_gather(y, axis_name, mesh=mesh)


def eager_broadcast(x, mesh=None, axis_name="dp", root=0):
    ax = _axis(mesh, axis_name)
    y = broadcast(_block(x, ax), axis_name, root, mesh)
    return all_gather(y, axis_name, mesh=mesh)
