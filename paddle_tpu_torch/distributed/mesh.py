"""The device mesh (port of paddle_tpu/distributed/mesh.py).

In the reference a mesh is a `jax.sharding.Mesh` whose named axes stand
for the NCCL rings of the original framework.  In the port one process
drives one device, and each named axis is a `torch.distributed` process
group: rank r of the world has the coordinate `np.unravel_index(r,
sizes)` over the mesh's ordered axes, as device r of the reference's
mesh does, and the group of an axis holds the ranks that differ from r
in that coordinate only.  A `Mesh` is one rank's view: an ordered map
{axis: (group, size, this rank's index, the group's global ranks)}.
`Mesh.group`, `.size` and `.rank` are the dp axis's, which the
data-parallel tier reads.

Two vocabularies of axes:
- `build_mesh` builds the canonical axes `AXES` (pp, dp, sp, tp, ep):
  dp (data parallel), sp (sequence parallel: ring attention), tp
  (tensor parallel: `tensor_parallel`), pp (pipeline stages: `pipeline`)
  and ep (expert parallel: MoE);
- `build_rule_mesh` builds the axes of a partition-rule set verbatim,
  in the rule set's order and with its size-1 axes (`{"dp": 2, "mp":
  2}`), for the GSPMD runtime tier (`CompiledProgram.with_sharding_rules
  (..., execute=True)`).
A mesh held in one process, one thread a rank, is `inprocess.local_meshes`
over either vocabulary.  `devices=[...]` names one device per rank in
global rank order; `mesh_key` and the shared `mesh_layout` cache give a
mesh's device-identity key and its derived placement facts.
"""

import math

import numpy as np
import torch
import torch.distributed as dist

from .env import ParallelEnv, init_parallel_env

__all__ = ["AXES", "Mesh", "build_mesh", "build_rule_mesh", "mesh_key",
           "MeshLayout", "mesh_layout", "default_mesh", "set_global_mesh",
           "get_global_mesh"]

_GLOBAL_MESH = None

# canonical axis order (the reference's)
AXES = ("pp", "dp", "sp", "tp", "ep")


class Mesh:
    """This rank's view of the mesh.  `axes` maps each axis name, in the
    mesh's order, to (group, size, this rank's index on the axis, the
    global ranks of the group in axis order); without it the mesh is dp
    only, over `group`.  `names` is the mesh's axis vocabulary: `AXES`
    for a canonical mesh (an axis it was built without has size 1), the
    rule set's axes for a rule mesh.  `group`, `size` and `rank` are the
    dp axis's; `device` is where this rank's tensors live."""

    def __init__(self, group, size, rank, device, axes=None, names=None):
        self.group = group
        self.size = size
        self.rank = rank
        self.device = device
        self.axes = dict(axes) if axes else {
            "dp": (group, size, rank, list(range(size)))}
        self.names = tuple(names) if names is not None else AXES

    def _axis(self, name):
        if name in self.axes:
            return self.axes[name]
        if name in self.names:
            # an axis the mesh was built without: size 1, no group
            return (None, 1, 0, [self.world_index()])
        raise ValueError(f"unknown mesh axis {name!r}; axes are "
                         f"{self.names}")

    def world_index(self):
        """This rank's global rank."""
        rank = getattr(self, "world_rank", None)
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        return rank

    @property
    def shape(self):
        """{axis: size} of every axis, in the mesh's order."""
        return {a: self._axis(a)[1] for a in self.names}

    def axis_group(self, name):
        return self._axis(name)[0]

    def axis_size(self, name):
        return self._axis(name)[1]

    def axis_index(self, name):
        return self._axis(name)[2]

    def axis_ranks(self, name):
        """The global ranks of this rank's group on `name`, in axis
        order."""
        return self._axis(name)[3]

    def coords(self):
        """{axis: (this rank's index, size)} over the mesh's axes."""
        return {a: (self._axis(a)[2], self._axis(a)[1]) for a in self.names}

    def __repr__(self):
        if self.names == AXES:
            sizes = ", ".join(f"{a}={s}" for a, s in self.shape.items()
                              if s > 1) or "dp=1"
        else:
            sizes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return (f"Mesh({sizes}, rank={self.world_index()}, "
                f"device={self.device})")


def _axis_lines(shape, names, me, new_group):
    """{axis: (group, size, index, ranks)} of rank `me` on a grid of
    `shape` over `names`: the groups of an axis are the grid's lines
    along it, made for every line in one fixed order (`new_group` is
    collective); a line of the whole world is the world group, and
    another axis of size 1 needs no group (its collectives are the
    identity)."""
    world = int(np.prod(shape)) if shape else 1
    grid = np.arange(world).reshape(shape)
    coord = np.unravel_index(me, shape)
    axes = {}
    for i, name in enumerate(names):
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
            ranks = [int(r) for r in line]
            if len(ranks) == world:
                group = dist.group.WORLD
            elif len(ranks) == 1:
                group = None
            else:
                group = new_group(ranks)
            if me in ranks:
                axes[name] = (group, shape[i], int(coord[i]), ranks)
    return axes


def _join(devices, device, need):
    """Join the process group, this process bound to `devices[rank]`
    when a device list is given (one torch.device per rank, in global
    rank order); returns this rank's device."""
    from ..core.place import resolve_device

    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if len(devices) < need:
            raise ValueError(
                f"mesh needs {need} devices, only {len(devices)} "
                f"available")
        device = devices[ParallelEnv().local_rank]
        if device.type == "cuda":
            torch.cuda.set_device(device)
    init_parallel_env(device)
    if dist.get_world_size() != need:
        return None
    if devices is not None:
        return devices[dist.get_rank()]
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def build_mesh(dp=1, tp=1, pp=1, sp=1, ep=1, devices=None, device=None):
    """The mesh over this process group (joined through
    `init_parallel_env` if it is not yet).  One process is one rank, so
    pp x dp x sp x tp x ep must equal the world size.  `devices` (one
    torch.device per rank, in global rank order) binds this process to
    `devices[rank]`; a list shorter than the mesh raises ValueError, as
    the reference's does."""
    sizes = {"pp": pp, "dp": dp, "sp": sp, "tp": tp, "ep": ep}
    need = int(np.prod(list(sizes.values())))
    dev = _join(devices, device, need)
    if dev is None:
        raise ValueError(
            f"mesh needs dp={dp} x sp={sp} x ep={ep} x tp={tp} x pp={pp} "
            f"= {need} ranks; the process group has "
            f"{dist.get_world_size()} (one rank per process)")
    shape = tuple(sizes[a] for a in AXES)
    axes = _axis_lines(shape, AXES, dist.get_rank(), dist.new_group)
    g, n, r, _ = axes["dp"]
    return Mesh(g, n, r, dev, axes)


def _rule_axes(axes):
    axes = {str(k): int(v) for k, v in dict(
        axes.axes if hasattr(axes, "axes") else axes).items()}
    return axes or {"dp": 1}


def build_rule_mesh(axes, devices=None, device=None):
    """The mesh of a partition-rule set's ``{axis: size}`` (`MeshSpec` or
    dict, e.g. ``{"dp": 2, "mp": 2}``) over this process group: the rule
    set's axis names become the mesh's axes verbatim, in its order,
    size-1 axes kept, so a rule spec ``[None, "mp"]`` names this mesh's
    "mp" with no renaming table.  One process is one rank: the product
    of the sizes must equal the world size.  `devices` pins one device
    per rank as in `build_mesh`.  The same mesh held in one process is
    `inprocess.local_meshes(axes=...)`."""
    axes = _rule_axes(axes)
    need = math.prod(axes.values())
    dev = _join(devices, device, need)
    if dev is None:
        raise ValueError(
            f"mesh {axes} needs {need} ranks; the process group has "
            f"{dist.get_world_size()} (one rank per process)")
    names = tuple(axes)
    lines = _axis_lines(tuple(axes.values()), names, dist.get_rank(),
                        dist.new_group)
    if "dp" in lines:
        g, n, r, _ = lines["dp"]
    else:
        g, n, r = None, 1, 0
    return Mesh(g, n, r, dev, lines, names=names)


def _ranks(mesh):
    """The rank views of a mesh: a list of in-process ranks as given,
    one process-group rank as a list of one."""
    return list(mesh) if isinstance(mesh, (list, tuple)) else [mesh]


def mesh_key(mesh):
    """Device-identity cache key of a mesh (a `Mesh`, or the list of an
    in-process mesh's ranks): (axis names, shape, the world's size and
    the (global rank, device) of every rank this process drives).  Two
    meshes with the same key place state alike; a retarget onto a
    same-sized different device set changes the key."""
    ranks = _ranks(mesh)
    first = ranks[0]
    world = (len(ranks) if getattr(first, "world", None) is not None
             else (dist.get_world_size() if dist.is_initialized() else 1))
    return (tuple(first.names), tuple(first.shape.values()), world,
            tuple(sorted((m.world_index(), str(m.device))
                         for m in ranks)))


class MeshLayout:
    """One mesh's derived placement facts, computed once and shared by
    every path that reads them (the executor's spmd state placement and
    plan caches key on `key`).

    Fields:
      mesh         — the mesh as given (a `Mesh` or in-process ranks)
      key          — :func:`mesh_key` device-identity tuple
      data_axis    — the batch-sharding axis name (None if absent)
      data_sharding— the `ShardSpec` splitting dim 0 over data_axis
      local_rows   — ranks this process drives
      shard_procs  — process index per rank this process drives
      data_rows    — data-axis coordinates among this process's ranks
                     (one row per dp SHARD, not per rank)
      data_procs   — process index per data-axis shard (the first rank
                     of each dp slice this process sees)
      fingerprint  — the rule-set fingerprint this layout was keyed
                     with (None for plain dp layouts)
    """

    __slots__ = ("mesh", "key", "data_axis", "data_sharding",
                 "local_rows", "shard_procs", "data_rows", "data_procs",
                 "fingerprint")

    def __init__(self, mesh, data_axis="dp", fingerprint=None):
        from ..analysis.sharding import REPLICATED, ShardSpec

        ranks = _ranks(mesh)
        first = ranks[0]
        self.mesh = mesh
        self.key = mesh_key(mesh)
        self.data_axis = data_axis if data_axis in first.names else None
        self.fingerprint = fingerprint
        inproc = getattr(first, "world", None) is not None
        me = 0 if inproc else first.world_index()
        self.shard_procs = [0 if inproc else m.world_index()
                            for m in ranks]
        self.local_rows = len(ranks)
        if self.data_axis is not None:
            procs = {}
            for m in ranks:
                procs.setdefault(m.axis_index(self.data_axis),
                                 0 if inproc else me)
            self.data_procs = [procs[i] for i in sorted(procs)]
            self.data_rows = len(procs)
        else:
            self.data_procs = list(self.shard_procs)
            self.data_rows = self.local_rows
        self.data_sharding = (ShardSpec((self.data_axis,))
                              if self.data_axis else REPLICATED)


_LAYOUT_CACHE = {}   # (id(mesh), data_axis, fingerprint) -> MeshLayout


def mesh_layout(mesh, data_axis="dp", fingerprint=None):
    """The shared mesh-layout cache: one :class:`MeshLayout` per (mesh,
    data axis, rule fingerprint), id-recycle-proof (the entry holds the
    mesh; a recycled id() with a different mesh object misses).
    Bounded: 8 entries, cleared wholesale."""
    k = (id(mesh), data_axis, fingerprint)
    ent = _LAYOUT_CACHE.get(k)
    if ent is not None and ent.mesh is mesh:
        return ent
    layout = MeshLayout(mesh, data_axis=data_axis, fingerprint=fingerprint)
    if len(_LAYOUT_CACHE) >= 8:
        _LAYOUT_CACHE.clear()
    _LAYOUT_CACHE[k] = layout
    return layout


def set_global_mesh(mesh):
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh
    return mesh


def get_global_mesh():
    return _GLOBAL_MESH


def default_mesh(device=None):
    """Every rank of the process group on dp (joined first if needed)."""
    global _GLOBAL_MESH
    if _GLOBAL_MESH is None:
        init_parallel_env(device)
        _GLOBAL_MESH = build_mesh(dp=dist.get_world_size())
    return _GLOBAL_MESH
