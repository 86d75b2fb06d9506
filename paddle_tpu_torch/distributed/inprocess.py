"""Several ranks of a mesh in one process (the port's counterpart of a
multi-device mesh on one host).

NCCL takes one card per rank, so a mesh of W > 1 ranks on a machine with
one card cannot be W processes.  Here it is W threads of one process:
`local_meshes(dp=.., tp=.., ...)` gives one `Mesh` per rank whose axis
groups are `LocalGroup`s, and `run_ranks(meshes, fn)` runs `fn(rank,
mesh)` on every rank at once, one thread each.  The ranks run the same
shard, step and schedule code as processes do; only the collectives of
`collective.py` see a `LocalGroup` and exchange the ranks' tensors in
memory instead of through `torch.distributed`.

Collectives inside autograd.  A rank's backward cannot wait for another
rank's inside the autograd engine (the engine runs a device's backward
nodes on one worker thread), so an in-process collective that needs a
gradient is ONE autograd node over all the ranks' tensors: its forward
takes every rank's input and gives every rank its output, and its
backward gives each rank exactly the cotangent that the multi-process
collective's backward would (for example the identity for a sum whose
every rank computes the same loss).  One backward over the sum of the
ranks' losses (`joint_grad`) then gives each rank the gradients it would
compute alone.  The forward of a collective waits for every rank of its
group (a barrier); the combining is done once, by one of them.
"""

import threading

import torch

__all__ = ["LocalGroup", "LocalWorld", "local_meshes", "run_ranks",
           "joint_grad"]


class LocalGroup:
    """The ranks of one mesh-axis line inside one process.  `exchange`
    is the only primitive: every rank deposits a value, one of them
    computes `combine(values) -> per-rank results`, every rank takes its
    own."""

    def __init__(self, size, world):
        self.size = size
        self.world = world
        self._barrier = threading.Barrier(size, timeout=world.timeout)
        world._barriers.append(self._barrier)
        self._slots = [None] * size
        self._result = None

    def exchange(self, index, value, combine):
        self._slots[index] = value
        if self._barrier.wait() == 0:
            try:
                self._result = combine(list(self._slots))
            except BaseException:
                self.world.abort()
                raise
        self._barrier.wait()
        out = self._result[index]
        self._slots[index] = None
        # nobody deposits the next value before everyone has read
        self._barrier.wait()
        return out


class LocalWorld:
    """Every rank of an in-process mesh: its world group (for barriers)
    and its barriers, which `abort` breaks when a rank fails, so that the
    others raise instead of waiting forever."""

    def __init__(self, size, timeout=600.0):
        self.size = size
        self.timeout = timeout
        self._barriers = []
        self.group = LocalGroup(size, self)

    def abort(self):
        for b in self._barriers:
            b.abort()


def local_meshes(dp=1, tp=1, pp=1, sp=1, ep=1, device=None,
                 timeout=600.0, axes=None, devices=None):
    """One `mesh.Mesh` per rank of a mesh held in this process: over the
    canonical axes, a dp x tp x pp x sp x ep mesh whose rank r has the
    coordinate `np.unravel_index(r, (pp, dp, sp, tp, ep))`, as in
    `build_mesh`; with `axes` ({name: size}, a partition-rule set's
    mesh), a rule mesh over those axes in their order, as in
    `build_rule_mesh`.  Each axis line of the grid is one `LocalGroup`.
    A rule mesh's ranks also carry `model_group`, the ranks that share
    this rank's dp coordinate (the GSPMD tier's joint backward).  Every
    rank's tensors live on `device`, the card by default (raises without
    one, as `build_mesh`), or on `devices[r]` when a device list (one
    device per rank, in rank order) is given."""
    import numpy as np

    from ..core.place import resolve_device
    from .mesh import AXES, Mesh, _rule_axes

    if axes is not None:
        sizes = _rule_axes(axes)
        names = tuple(sizes)
    else:
        sizes = {"pp": pp, "dp": dp, "sp": sp, "tp": tp, "ep": ep}
        names = AXES
    shape = tuple(int(sizes[a]) for a in names)
    world = int(np.prod(shape))
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if len(devs) < world:
            raise ValueError(f"mesh needs {world} devices, only "
                             f"{len(devs)} available")
    else:
        devs = [resolve_device(device)] * world
    lw = LocalWorld(world, timeout)
    grid = np.arange(world).reshape(shape)
    per_rank = [dict() for _ in range(world)]
    for i, name in enumerate(names):
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
            ranks = [int(r) for r in line]
            group = LocalGroup(len(ranks), lw) if len(ranks) > 1 else None
            for pos, r in enumerate(ranks):
                per_rank[r][name] = (group, shape[i], pos, ranks)
    model = {}
    if axes is not None:
        # the ranks of one data coordinate: the model axes' sub-grid
        di = names.index("dp") if "dp" in names else None
        for r in range(world):
            key = (None if di is None
                   else int(np.unravel_index(r, shape)[di]))
            model.setdefault(key, []).append(r)
        groups = {k: LocalGroup(len(v), lw) if len(v) > 1 else None
                  for k, v in model.items()}
    meshes = []
    for r in range(world):
        if "dp" in per_rank[r]:
            g, n, idx, _ = per_rank[r]["dp"]
        else:
            g, n, idx = None, 1, 0
        m = Mesh(g, n, idx, devs[r], per_rank[r],
                 names=names if axes is not None else None)
        m.world_rank, m.world = r, lw
        if axes is not None:
            for k, ranks in model.items():
                if r in ranks:
                    m.model_group = (groups[k], len(ranks), ranks.index(r),
                                     ranks)
        meshes.append(m)
    return meshes


def run_ranks(meshes, fn):
    """`fn(rank, mesh)` on every rank of an in-process mesh at once (one
    thread each, grad mode on as in a fresh thread); returns the list of
    results in rank order.  The first rank that raises breaks every
    barrier and its exception is raised here."""
    world = meshes[0].world
    out = [None] * len(meshes)
    errors = []

    def body(r):
        try:
            out[r] = fn(r, meshes[r])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append((r, e))
            world.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True)
               for r in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # the first failure is the cause; the rest are broken barriers
        first = [e for e in errors
                 if not isinstance(e[1], threading.BrokenBarrierError)]
        r, e = (first or errors)[0]
        raise RuntimeError(f"in-process rank {r} failed: "
                           f"{type(e).__name__}: {e}") from e
    return out


def joint_grad(losses, inputs):
    """The gradients of every rank's loss with respect to every rank's
    inputs in one backward: `losses` [W] scalars, `inputs` [W] lists of
    tensors -> [W] lists of grads (None where unused)."""
    flat = [t for ins in inputs for t in ins]
    grads = torch.autograd.grad(list(losses), flat, allow_unused=True)
    out, i = [], 0
    for ins in inputs:
        out.append(list(grads[i:i + len(ins)]))
        i += len(ins)
    return out


# --- the collectives over a LocalGroup ---------------------------------------

class _Joint(torch.autograd.Function):
    """One node over every rank's tensor of a collective: forward(xs) ->
    per-rank outputs, backward(gs) -> per-rank cotangents, both given."""

    @staticmethod
    def forward(ctx, fwd, bwd, *xs):
        ctx.bwd = bwd
        return tuple(fwd(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *ctx.bwd(list(gs)))


def collective(ax, x, fwd, bwd=None):
    """This rank's result of a collective over the in-process axis `ax`
    (`collective._Axis`): every rank deposits x; `fwd(xs)` gives the
    outputs; with `bwd` and grad on, one `_Joint` node joins the ranks'
    graphs."""

    def combine(xs):
        if bwd is not None and torch.is_grad_enabled() and \
                any(t.requires_grad for t in xs):
            return _Joint.apply(fwd, bwd, *xs)
        with torch.no_grad():
            return fwd(xs)

    return ax.group.exchange(ax.index, x, combine)


def total(xs):
    """The sum of the ranks' tensors in rank order, on the first rank's
    device."""
    s = xs[0]
    for t in xs[1:]:
        s = s + t.to(s.device)
    return s
