"""Distributed training (port of the data-parallel tier of
paddle_tpu/distributed/).

The reference's "dp" mesh axis is a `torch.distributed` process group
here (NCCL on the card, gloo on the CPU), one process per rank:
`env` (the trainer env and the rendezvous), `launch` (the worker
launcher), `mesh` (the dp mesh), `collective`, `data_parallel`,
`strategies` (DGC on kernel K10, LocalSGD) and `fleet`.  Only what is
ported is exported here; the modules keep the reference's other names
(`ppermute`, `all_to_all`, `build_rule_mesh`, `mesh_key`, `MeshLayout`,
the dygraph `DataParallel`), which raise NotImplementedError naming
their ROADMAP item.  Ring attention, MoE, pipelines, the sharded (TP /
ZeRO / FSDP) rules and the parameter server are ROADMAP queue 1 item 8.
"""

from . import collective, fleet, mesh  # noqa: F401
from .collective import (
    all_gather, all_reduce, broadcast, pmax, pmean, pmin, psum,
    reduce_scatter,
)
from .data_parallel import DataParallelTrainStep, scale_loss
from .env import (
    ParallelEnv, destroy_parallel_env, get_rank, get_world_size,
    init_parallel_env,
)
from .mesh import (
    Mesh, build_mesh, default_mesh, get_global_mesh, set_global_mesh,
)
from .strategies import DGCTrainStep, LocalSGDTrainStep, dgc_topk_mask

__all__ = [
    "collective", "mesh", "fleet",
    "all_reduce", "all_gather", "reduce_scatter", "broadcast", "psum",
    "pmean", "pmax", "pmin",
    "Mesh", "build_mesh", "default_mesh", "get_global_mesh",
    "set_global_mesh",
    "ParallelEnv", "init_parallel_env", "destroy_parallel_env", "get_rank",
    "get_world_size",
    "DataParallelTrainStep", "scale_loss",
    "DGCTrainStep", "LocalSGDTrainStep", "dgc_topk_mask",
]
