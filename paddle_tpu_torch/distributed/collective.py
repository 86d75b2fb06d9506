"""Collective communication (port of paddle_tpu/distributed/collective.py).

Two forms, as in the reference:
- the in-step collectives (`all_reduce`, `psum`, `all_gather`, ...) take
  this rank's tensor, as the reference's take a shard inside shard_map,
  and return a new tensor; the input is left as it was;
- the `eager_*` forms take a global array, as the reference's take one
  sharded over dp: rank r works on the r-th 1/size block of dim 0, and a
  result sharded over dp comes back as the global array again
  (concatenated over the ranks).

All run on the mesh's process group (`mesh=None`: the default mesh).  A
mean is a SUM followed by a division by the group's size, on both
backends (`ReduceOp.AVG` is NCCL-only).  The only axis is "dp";
`ppermute` and `all_to_all` belong to the axes that are not ported
(ROADMAP queue 1 item 8).
"""

from functools import partial

import torch
import torch.distributed as dist

__all__ = [
    "all_reduce", "all_gather", "reduce_scatter", "broadcast", "ppermute",
    "all_to_all", "psum", "pmean", "pmax", "pmin",
    "eager_all_reduce", "eager_all_gather", "eager_broadcast",
    "eager_reduce_scatter",
]

_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
        "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
        "prod": dist.ReduceOp.PRODUCT}
_ITEM8 = "ROADMAP queue 1 item 8"


def _mesh(mesh, axis_name):
    from .mesh import default_mesh

    if axis_name != "dp":
        raise NotImplementedError(f"mesh axis {axis_name!r}: only 'dp' is "
                                  f"ported ({_ITEM8})")
    return mesh or default_mesh()


def all_reduce_(x, op="sum", mesh=None):
    """In-place all_reduce of `x` over the mesh; returns `x`."""
    if op not in _OPS:
        raise ValueError(f"unknown reduce op {op}")
    mesh = _mesh(mesh, "dp")
    dist.all_reduce(x, _OPS[op], group=mesh.group)
    if op == "mean":
        x.div_(mesh.size)
    return x


def all_reduce(x, axis_name="dp", op="sum", mesh=None):
    """c_allreduce_{sum,max,min,prod} parity, and the mean."""
    _mesh(mesh, axis_name)
    y = x.clone()
    if op == "mean" and not y.is_floating_point():
        y = y.float()
    return all_reduce_(y, op, mesh)


psum = partial(all_reduce, op="sum")
pmean = partial(all_reduce, op="mean")
pmax = partial(all_reduce, op="max")
pmin = partial(all_reduce, op="min")


def all_gather(x, axis_name="dp", axis=0, tiled=True, mesh=None):
    """c_allgather parity: every rank's x, concatenated along `axis`
    (tiled) or stacked on a new `axis`."""
    mesh = _mesh(mesh, axis_name)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)


def reduce_scatter(x, axis_name="dp", scatter_axis=0, mesh=None):
    """c_reducescatter parity (tiled): the sum over the ranks of x,
    split into `size` blocks along `scatter_axis`; rank r keeps block r.
    It is an all_reduce and a slice, which gloo and NCCL both run."""
    mesh = _mesh(mesh, axis_name)
    n = x.shape[scatter_axis]
    if n % mesh.size:
        raise ValueError(f"reduce_scatter: dim {scatter_axis} of size {n} "
                         f"does not split into {mesh.size} blocks")
    total = all_reduce(x, axis_name, "sum", mesh)
    blk = n // mesh.size
    return total.narrow(scatter_axis, mesh.rank * blk, blk).contiguous()


def broadcast(x, axis_name="dp", root=0, mesh=None):
    """c_broadcast parity: every rank gets root's value."""
    mesh = _mesh(mesh, axis_name)
    y = x.clone()
    # the mesh's group is the whole world, so dp index = global rank
    dist.broadcast(y, root, group=mesh.group)
    return y


def ppermute(x, axis_name, perm):
    raise NotImplementedError(f"ppermute serves the ring-attention and "
                              f"pipeline axes, not ported ({_ITEM8})")


def all_to_all(x, axis_name, split_axis, concat_axis):
    raise NotImplementedError(f"all_to_all serves the MoE expert axis, not "
                              f"ported ({_ITEM8})")


# --- eager collectives over a global array ---------------------------------

def _block(x, mesh):
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"dim 0 of size {n} does not split over "
                         f"dp={mesh.size}")
    blk = n // mesh.size
    return torch.as_tensor(x).narrow(0, mesh.rank * blk, blk).contiguous()


def eager_all_reduce(x, mesh=None, axis_name="dp", op="sum"):
    mesh = _mesh(mesh, axis_name)
    y = all_reduce(_block(x, mesh), axis_name, op, mesh)
    return all_gather(y, axis_name, mesh=mesh)


def eager_all_gather(x, mesh=None, axis_name="dp"):
    mesh = _mesh(mesh, axis_name)
    return all_gather(_block(x, mesh), axis_name, mesh=mesh)


def eager_reduce_scatter(x, mesh=None, axis_name="dp"):
    mesh = _mesh(mesh, axis_name)
    y = reduce_scatter(_block(x, mesh), axis_name, mesh=mesh)
    return all_gather(y, axis_name, mesh=mesh)


def eager_broadcast(x, mesh=None, axis_name="dp", root=0):
    mesh = _mesh(mesh, axis_name)
    y = broadcast(_block(x, mesh), axis_name, root, mesh)
    return all_gather(y, axis_name, mesh=mesh)
