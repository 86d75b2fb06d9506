"""Distributed training (port of paddle_tpu/distributed/).

The reference's mesh axes are `torch.distributed` process groups here
(NCCL on the card, gloo on the CPU), one process per rank: `env` (the
trainer env and the rendezvous), `launch` (the worker launcher), `mesh`
(the dp, sp and ep axes), `collective`, `data_parallel`, `strategies`
(DGC on kernel K10, LocalSGD), `fleet`, `moe` (mixture of experts over
ep), `ring_attention` (sequence parallelism over sp) and `sharded` (the
partition rules and the dp x ep train step).  Only what is ported is
exported here; the modules keep the reference's other names
(`build_rule_mesh`, `mesh_key`, `MeshLayout`, the dygraph
`DataParallel`), which raise NotImplementedError naming their ROADMAP
item.  Pipelines, tensor parallelism, ZeRO-1/FSDP, the parameter server
and federated learning are ROADMAP queue 1 item 8.
"""

from . import collective, fleet, mesh  # noqa: F401
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
    Mesh, build_mesh, default_mesh, get_global_mesh, set_global_mesh,
)
from .moe import (
    init_moe_params, moe_ffn, moe_ffn_shardmap, shard_moe_params,
    sharded_moe_ffn, top_k_gating,
)
from .ring_attention import ring_attention, ring_attention_sharded
from .sharded import (
    PartitionRules, bert_rules, fsdp_rules, gpt_rules,
    make_sharded_train_step, mlp_rules, shard_batch, shard_params,
    shard_train_state,
)
from .strategies import DGCTrainStep, LocalSGDTrainStep, dgc_topk_mask

__all__ = [
    "collective", "mesh", "fleet",
    "all_reduce", "all_gather", "reduce_scatter", "broadcast", "ppermute",
    "all_to_all", "psum", "pmean", "pmax", "pmin",
    "Mesh", "build_mesh", "default_mesh", "get_global_mesh",
    "set_global_mesh",
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
