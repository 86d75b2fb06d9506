"""The data-parallel mesh (port of the dp part of
paddle_tpu/distributed/mesh.py).

In the reference a mesh is a `jax.sharding.Mesh` whose named axes stand
for the NCCL rings of the original framework.  In the port one process
drives one device, so the "dp" axis is a `torch.distributed` process
group: a `Mesh` holds that group, its size, this process's rank in it
and the device its tensors live on.  Only "dp" is ported: the tp, pp,
sp and ep axes (tensor, pipeline, sequence and expert parallelism) and
the rule meshes of the sharding analyzer are ROADMAP queue 1 item 8.
"""

import torch
import torch.distributed as dist

from .env import init_parallel_env

__all__ = ["Mesh", "build_mesh", "build_rule_mesh", "mesh_key",
           "MeshLayout", "default_mesh", "set_global_mesh",
           "get_global_mesh"]

_ITEM8 = "ROADMAP queue 1 item 8"
_GLOBAL_MESH = None


class Mesh:
    """The dp process group: `group`, `size`, this process's `rank` in
    it and its `device`."""

    def __init__(self, group, size, rank, device):
        self.group = group
        self.size = size
        self.rank = rank
        self.device = device

    def __repr__(self):
        return (f"Mesh(dp={self.size}, rank={self.rank}, "
                f"device={self.device})")


def build_mesh(dp=1, tp=1, pp=1, sp=1, ep=1, devices=None, device=None):
    """The dp mesh over this process group (joined through
    `init_parallel_env(device)` if it is not yet).  One process is one
    rank of dp, so dp must equal the world size.  tp, pp, sp and ep
    above 1, and an explicit device list, are not ported."""
    if max(tp, pp, sp, ep) > 1:
        raise NotImplementedError(
            f"mesh axes tp={tp} pp={pp} sp={sp} ep={ep}: only dp is ported "
            f"({_ITEM8})")
    if devices is not None:
        raise NotImplementedError(
            f"an explicit device list: one process drives one device in "
            f"the port ({_ITEM8})")
    init_parallel_env(device)
    world = dist.get_world_size()
    if dp != world:
        raise ValueError(f"mesh needs dp={dp} ranks; the process group "
                         f"has {world} (one rank per process)")
    backend = dist.get_backend()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend == "nccl" else torch.device("cpu"))
    return Mesh(dist.group.WORLD, world, dist.get_rank(), dev)


def build_rule_mesh(axes, devices=None):
    raise NotImplementedError(f"rule meshes of the sharding analyzer are "
                              f"not ported ({_ITEM8})")


def mesh_key(mesh):
    raise NotImplementedError(f"mesh_key (device-identity cache keys) is "
                              f"not ported ({_ITEM8})")


class MeshLayout:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"MeshLayout is not ported ({_ITEM8})")


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
