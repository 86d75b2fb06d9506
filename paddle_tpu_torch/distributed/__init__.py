"""Distributed training (port of paddle_tpu/distributed/).

The reference's mesh axes are `torch.distributed` process groups here
(NCCL on the card, gloo on the CPU), one process per rank: `env` (the
trainer env and the rendezvous), `launch` (the worker launcher), `mesh`
(the pp, dp, sp, tp and ep axes; a partition-rule set's axes:
`build_rule_mesh`, `mesh_key`, `mesh_layout`), `collective`,
`data_parallel`,
`strategies` (DGC on kernel K10, LocalSGD), `fleet`, `moe` (mixture of
experts over ep), `ring_attention` (sequence parallelism over sp),
`tensor_parallel` (Megatron tp and sp for the GPT's layers), `sharded`
(the partition rules and the sharded train step: tp, sp, ep, ZeRO-1,
FSDP, accumulation, clipping) and `pipeline` (GPipe, the interleaved
schedule, the 3D GPT).  `inprocess` holds a mesh's ranks in one process
(one thread each), which is how W > 1 runs on one card.  The parameter
server's data plane is `ps` (sharded host tables on the native shard,
the Communicator, the TCP service and its wire format), with
`federated` (FedAvg over ps's wire), `fleet_util` (global metrics as
sums over a mesh axis) and `fs` (LocalFS, HDFSClient).  A mesh takes an
explicit device list (`devices=[...]`, one device a rank).  The modules
keep the reference's other names (the dygraph `DataParallel`), which
raise NotImplementedError naming their ROADMAP item.
"""

from . import (  # noqa: F401
    collective, federated, fleet, fleet_util, fs, inprocess, mesh,
    pipeline, ps, tensor_parallel,
)
from .collective import (
    all_gather, all_reduce, all_to_all, broadcast, pmax, pmean, pmin,
    ppermute, psum, reduce_scatter,
)
from .data_parallel import DataParallelTrainStep, scale_loss
from .env import (
    ParallelEnv, destroy_parallel_env, get_rank, get_world_size,
    init_parallel_env,
)
from .mesh import (
    Mesh, build_mesh, build_rule_mesh, default_mesh, get_global_mesh,
    mesh_key, mesh_layout, set_global_mesh,
)
from .moe import (
    init_moe_params, moe_ffn, moe_ffn_shardmap, shard_moe_params,
    sharded_moe_ffn, top_k_gating,
)
from .inprocess import local_meshes, run_ranks
from .pipeline import (
    build_gpt_pipeline, build_gpt_pipeline_3d, gpipe, interleaved_gpipe,
)
from .ring_attention import ring_attention, ring_attention_sharded
from .sharded import (
    PartitionRules, bert_rules, fsdp_rules, gpt_rules,
    make_sharded_train_step, mlp_rules, run_local_step, shard_batch,
    shard_params, shard_train_state,
)
from .strategies import DGCTrainStep, LocalSGDTrainStep, dgc_topk_mask

__all__ = [
    "collective", "mesh", "fleet", "inprocess", "pipeline", "ps",
    "federated", "fleet_util", "fs",
    "tensor_parallel", "local_meshes", "run_ranks", "run_local_step",
    "gpipe", "interleaved_gpipe", "build_gpt_pipeline",
    "build_gpt_pipeline_3d",
    "all_reduce", "all_gather", "reduce_scatter", "broadcast", "ppermute",
    "all_to_all", "psum", "pmean", "pmax", "pmin",
    "Mesh", "build_mesh", "build_rule_mesh", "default_mesh",
    "get_global_mesh", "mesh_key", "mesh_layout", "set_global_mesh",
    "ParallelEnv", "init_parallel_env", "destroy_parallel_env", "get_rank",
    "get_world_size",
    "DataParallelTrainStep", "scale_loss",
    "DGCTrainStep", "LocalSGDTrainStep", "dgc_topk_mask",
    "PartitionRules", "gpt_rules", "bert_rules", "mlp_rules",
    "shard_params", "shard_batch", "shard_train_state",
    "make_sharded_train_step", "fsdp_rules",
    "ring_attention", "ring_attention_sharded",
    "init_moe_params", "moe_ffn", "moe_ffn_shardmap", "sharded_moe_ffn",
    "shard_moe_params", "top_k_gating",
]
