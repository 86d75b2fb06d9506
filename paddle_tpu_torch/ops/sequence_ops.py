"""The LoD rank-table ops of the control-flow layers (port of
paddle_tpu/ops/sequence_ops.py:379-403): `lod_rank_table`,
`max_sequence_len` and `shrink_memory`, which `layers.control_flow`'s
DynamicRNN helpers emit.  The rest of the reference's sequence op corpus
is ROADMAP item 10.

`shrink_memory`'s output has as many rows as sequences still active at
step I, a value-dependent shape: it reads I and the rank table on the
host (the reference runs it only under FLAGS_eager_executor; the port is
always eager).
"""

import torch

from ..kernels.backend import count_host_sync
from .registry import register_op


@register_op("lod_rank_table")
def lod_rank_table(ins, attrs):
    length = ins["X"].reshape(-1).to(torch.int32)
    # stable descending sort by length (ties keep their order)
    order = torch.argsort(-length, stable=True)
    return {"Out": torch.stack([order.to(torch.int32), length[order]],
                               dim=1)}


@register_op("max_sequence_len")
def max_sequence_len(ins, attrs):
    return {"Out": ins["RankTable"][0, 1].to(torch.int32)}


@register_op("shrink_memory")
def shrink_memory(ins, attrs):
    """Keep only the memory rows of sequences still active at step I
    (rows are in rank-table order, so the active ones are a prefix)."""
    count_host_sync("shrink_memory")
    i = int(ins["I"].reshape(()).item())
    active = int((ins["RankTable"][:, 1] > i).sum().item())
    return {"Out": ins["X"][:active]}
