"""Fleet metric aggregation utilities (port of
paddle_tpu/distributed/fleet_util.py).

Parity: python/paddle/fluid/incubate/fleet/utils/fleet_util.py (global
AUC / accuracy via allreduce across workers): each worker holds local
accumulator state; the global metric is computed from the SUM of the
accumulators, not the mean of local metrics.  The sum is an `all_reduce`
over a mesh axis of the port's `Mesh` (`global_metric_over_mesh`), or a
plain host-side sum when the caller already gathered per-worker states.
"""

import numpy as np
import torch

__all__ = ["sum_accumulators", "global_auc", "global_accuracy",
           "global_metric_over_mesh"]


def _host(s):
    if isinstance(s, torch.Tensor):
        s = s.detach().cpu().numpy()
    return np.asarray(s, np.float64)


def sum_accumulators(states):
    """Elementwise-sum a list of per-worker accumulator arrays or tensors
    (the host-side form of the reference's allreduce), in float64."""
    out = None
    for s in states:
        a = _host(s)
        out = a if out is None else out + a
    return out


def global_auc(stat_pos_list, stat_neg_list, num_thresholds=None):
    """Global AUC from per-worker positive/negative histogram stats
    (fleet_util.get_global_auc): sum the histograms, then integrate one
    ROC curve — NOT the mean of local AUCs."""
    pos = sum_accumulators(stat_pos_list)
    neg = sum_accumulators(stat_neg_list)
    # integrate from the highest threshold bucket down
    tp = np.cumsum(pos[::-1])
    fp = np.cumsum(neg[::-1])
    tot_p = tp[-1]
    tot_n = fp[-1]
    if tot_p == 0 or tot_n == 0:
        return 0.5
    tpr = np.concatenate([[0.0], tp / tot_p])
    fpr = np.concatenate([[0.0], fp / tot_n])
    return float(np.trapezoid(tpr, fpr))


def global_accuracy(correct_list, total_list):
    """Global accuracy = sum(correct) / sum(total) across workers."""
    c = float(sum_accumulators(correct_list))
    t = float(sum_accumulators(total_list))
    return c / max(t, 1.0)


def global_metric_over_mesh(mesh, axis, local_state):
    """The sum over the ranks of the mesh axis `axis` of this rank's
    `local_state` (a tensor, or a list, tuple or dict of them): one
    `all_reduce` per tensor, the in-graph form of the reference's
    allreduce-based metric aggregation."""
    from . import collective as C

    def agg(x):
        if isinstance(x, dict):
            return {k: agg(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(agg(v) for v in x)
        return C.all_reduce(x, axis, "sum", mesh)

    return agg(local_state)
