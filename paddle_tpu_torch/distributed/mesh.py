"""The device mesh (port of paddle_tpu/distributed/mesh.py).

In the reference a mesh is a `jax.sharding.Mesh` whose named axes stand
for the NCCL rings of the original framework.  In the port one process
drives one device, and each named axis is a `torch.distributed` process
group: rank r of the world has the coordinate
`np.unravel_index(r, (pp, dp, sp, tp, ep))`, as device r of the
reference's mesh does (`AXES` is the reference's canonical order), and
the group of an axis holds the ranks that differ from r in that
coordinate only.  `Mesh.group`, `.size` and `.rank` are the dp axis's,
which the data-parallel tier reads.

Every axis is ported: dp (data parallel), sp (sequence parallel: ring
attention), tp (tensor parallel: `tensor_parallel`), pp (pipeline
stages: `pipeline`) and ep (expert parallel: MoE).  A mesh held in one
process, one thread a rank, is `inprocess.local_meshes`.  An explicit
device list is ROADMAP item 8.5; the rule meshes of the sharding
analyzer (`build_rule_mesh`, `mesh_key`, `MeshLayout`) are item 8.2.
"""

import numpy as np
import torch
import torch.distributed as dist

from .env import init_parallel_env

__all__ = ["AXES", "Mesh", "build_mesh", "build_rule_mesh", "mesh_key",
           "MeshLayout", "default_mesh", "set_global_mesh",
           "get_global_mesh"]

_ITEM8_2 = "ROADMAP item 8.2, the GSPMD tier"
_ITEM8_5 = "ROADMAP item 8.5"
_GLOBAL_MESH = None

# canonical axis order (the reference's)
AXES = ("pp", "dp", "sp", "tp", "ep")


class Mesh:
    """This rank's view of the mesh.  `axes` maps each axis name to
    (group, size, this rank's index on the axis, the global ranks of the
    group in axis order); without it the mesh is dp only, over `group`.
    `group`, `size` and `rank` are the dp axis's; `device` is where this
    rank's tensors live."""

    def __init__(self, group, size, rank, device, axes=None):
        self.group = group
        self.size = size
        self.rank = rank
        self.device = device
        self.axes = dict(axes) if axes else {
            "dp": (group, size, rank, list(range(size)))}

    def _axis(self, name):
        if name in self.axes:
            return self.axes[name]
        if name in AXES:
            # an axis the mesh was built without: size 1, no group
            return (None, 1, 0, [dist.get_rank()])
        raise ValueError(f"unknown mesh axis {name!r}; axes are {AXES}")

    @property
    def shape(self):
        """{axis: size} of every axis, in the canonical order."""
        return {a: self._axis(a)[1] for a in AXES}

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

    def __repr__(self):
        sizes = ", ".join(f"{a}={s}" for a, s in self.shape.items() if s > 1)
        rank = getattr(self, "world_rank", None)
        if rank is None:
            rank = dist.get_rank()
        return (f"Mesh({sizes or 'dp=1'}, rank={rank}, "
                f"device={self.device})")


def build_mesh(dp=1, tp=1, pp=1, sp=1, ep=1, devices=None, device=None):
    """The mesh over this process group (joined through
    `init_parallel_env(device)` if it is not yet).  One process is one
    rank, so pp x dp x sp x tp x ep must equal the world size.  Every
    rank builds every axis's groups in one fixed order (`new_group` is
    collective).  An explicit device list is not ported."""
    if devices is not None:
        raise NotImplementedError(
            f"an explicit device list: one process drives one device in "
            f"the port ({_ITEM8_5})")
    init_parallel_env(device)
    world = dist.get_world_size()
    sizes = {"pp": pp, "dp": dp, "sp": sp, "tp": tp, "ep": ep}
    need = int(np.prod(list(sizes.values())))
    if need != world:
        raise ValueError(
            f"mesh needs dp={dp} x sp={sp} x ep={ep} x tp={tp} x pp={pp} "
            f"= {need} ranks; the "
            f"process group has {world} (one rank per process)")
    me = dist.get_rank()
    shape = tuple(sizes[a] for a in AXES)
    grid = np.arange(world).reshape(shape)
    coord = np.unravel_index(me, shape)
    backend = dist.get_backend()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend == "nccl" else torch.device("cpu"))
    axes = {}
    for i, name in enumerate(AXES):
        # the groups of this axis are the grid's lines along axis i; an
        # axis of size 1 in a bigger world needs no group (its
        # collectives are the identity)
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
            ranks = [int(r) for r in line]
            if len(ranks) == world:
                group = dist.group.WORLD
            elif len(ranks) == 1:
                group = None
            else:
                group = dist.new_group(ranks)
            if me in ranks:
                axes[name] = (group, shape[i], int(coord[i]), ranks)
    g, n, r, _ = axes["dp"]
    return Mesh(g, n, r, dev, axes)


def build_rule_mesh(axes, devices=None):
    raise NotImplementedError(f"rule meshes of the sharding analyzer are "
                              f"not ported ({_ITEM8_2})")


def mesh_key(mesh):
    raise NotImplementedError(f"mesh_key (device-identity cache keys) is "
                              f"not ported ({_ITEM8_2})")


class MeshLayout:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"MeshLayout is not ported ({_ITEM8_2})")


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
