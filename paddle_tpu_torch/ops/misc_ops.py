"""The static DGC ops (port of paddle_tpu/ops/misc_ops.py:582-660):
`dgc_clip_by_norm`, `dgc` and `dgc_momentum`, the three ops
`optimizer.DGCMomentumOptimizer` emits, and `print` (:717, the op of
`layers.Print`).  The rest of the reference's misc_ops corpus is ROADMAP
item 10.

`dgc` takes the reference's exact threshold: the k-th largest |v|,
`kthvalue` of the flattened |v| at n - k + 1 (the reference's
`sort(|v|)[n - k]`).  The dygraph DGC step's histogram threshold (kernel
K10, `distributed/strategies.py`) is approximate and is not used here,
as the reference's static op does not use it either.
"""

import torch

from ..kernels.backend import count_host_sync
from .registry import register_op


def _step(ins):
    step = ins.get("current_step", 0)
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(float(step))
    return step.reshape(())


@register_op("dgc_clip_by_norm")
def dgc_clip_by_norm(ins, attrs):
    """operators/dgc_clip_by_norm_op.cc — clip_by_norm, applied from the
    rampup step on."""
    x = ins["X"]
    step = _step(ins)
    rampup = float(attrs.get("rampup_begin_step", 0.0))
    max_norm = float(attrs.get("max_norm", 1.0))
    norm = torch.sqrt(torch.square(x).sum())
    clipped = x * torch.clamp(max_norm / torch.clamp(norm, min=1e-10),
                              max=1.0)
    return {"Out": torch.where(step < rampup, x, clipped)}


@register_op("dgc", stateful=True)
def dgc(ins, attrs):
    """operators/dgc_op.h — DGC sparsification with momentum correction
    and error feedback (arXiv:1712.01887).  Before `rampup_begin_step`
    the grad passes through untouched; after it, U accumulates momentum,
    V accumulates error feedback, and only the top-(1-s) fraction of |V|
    ships (GradOut), the rest staying in U/V.  The sparsity s walks the
    `sparsity` array over `rampup_step` steps (optimizer.py:1069-1075).
    The masked dense GradOut is the operand of the data-parallel sync,
    as in the reference (no sparse encode buffer)."""
    u, v, g = ins["U"], ins["V"], ins["Grad"]
    step = _step(ins).to(torch.float32)
    mu = float(attrs.get("m", attrs.get("mu", 0.9)))
    rampup_begin = float(attrs.get("rampup_begin_step", 0.0))
    rampup_step = max(float(attrs.get("rampup_step", 1.0)), 1.0)
    sparsity = torch.tensor([float(s) for s in attrs.get("sparsity",
                                                         [0.999])],
                            dtype=torch.float32, device=step.device)
    nlev = sparsity.shape[0]
    # warm-up: index into the sparsity array by progress through rampup
    prog = torch.clamp((step - rampup_begin) / rampup_step, 0.0, 1.0)
    idx = torch.clamp((prog * nlev).to(torch.int32), 0, nlev - 1)
    s = sparsity[idx.long()]

    u_n = mu * u + g                               # momentum correction
    v_n = v + u_n                                  # error feedback
    flat = torch.abs(v_n).reshape(-1)
    n = flat.shape[0]
    k = int(torch.clamp(torch.round(n * (1.0 - s)).to(torch.int32), 1, n))
    # the k-th largest |v|: the reference's sort(|v|)[n - k]
    kth = torch.kthvalue(flat, n - k + 1).values
    mask = (torch.abs(v_n) >= kth).to(g.dtype)
    before = step < rampup_begin
    return {"GradOut": torch.where(before, g, v_n * mask),
            "UOut": torch.where(before, u, u_n * (1.0 - mask)),
            "VOut": torch.where(before, v, v_n * (1.0 - mask))}


@register_op("dgc_momentum", stateful=True)
def dgc_momentum(ins, attrs):
    """operators/optimizers/dgc_momentum_op.h — momentum before the
    rampup boundary, plain SGD after (the sparse path then owns the
    velocity)."""
    p, g, vel = ins["Param"], ins["Grad"], ins["Velocity"]
    lr = ins["LearningRate"].reshape(())
    step = _step(ins)
    mu = float(attrs.get("mu", 0.9))
    rampup = float(attrs.get("rampup_begin_step", 0.0))
    v_new = mu * vel + g
    if bool(attrs.get("use_nesterov", False)):
        p_mom = p - lr * (g + mu * v_new)
    else:
        p_mom = p - lr * v_new
    p_sgd = p - lr * g
    before = step < rampup
    return {"ParamOut": torch.where(before, p_mom, p_sgd),
            "VelocityOut": torch.where(before, v_new, vel)}


@register_op("print")
def print_op(ins, attrs):
    """operators/print_op.cc — a runtime tensor peek, identity on the
    data path.  The reference prints with jax.debug.print; the port
    prints the value from the host (one host read)."""
    x = ins["In"]
    msg = attrs.get("message") or "print"
    count_host_sync("print")
    v = x.detach()
    if v.dtype == torch.bfloat16:
        v = v.float()
    print(f"[{msg}] shape={tuple(x.shape)} value={v.cpu().numpy()}")
    return {"Out": x}
