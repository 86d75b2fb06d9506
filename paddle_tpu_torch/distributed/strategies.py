"""Distributed training strategies: DGC and LocalSGD (port of
paddle_tpu/distributed/strategies.py).

- **DGC** (deep gradient compression, the reference's
  DGCMomentumOptimizer, optimizer.py:1041): local momentum correction
  (u = m u + g), error feedback (v += u), a per-parameter top-k mask on
  |v|, an all-reduce of only the selected entries (the masked dense
  tensor, averaged over the mesh, as the reference's pmean) and the
  selected slots cleared from u and v.  The mask is `dgc_topk_mask`:
  the exact k-th |v| from `torch.topk`, or under
  FLAGS_use_pallas_dgc_topk the histogram threshold of kernel K10
  (`kernels/topk_threshold.py`), which keeps at least k elements.
- **LocalSGD** (transpiler/collective.py:270): every rank takes
  `local_sgd_steps` optimizer steps on its own replica, then the
  replicas are averaged.

As in `data_parallel.py`, each rank is a process and its model is its
replica; the batch is global and rank r takes the r-th share.  The DGC
state (u, v and the dense velocity of the steps before
`rampup_begin_step`) belongs to each rank, as each device's shard of the
reference's state does.  The reference's `lax.cond` on the step count is
a Python branch on a counter kept on the host, so no step syncs the
device.  The elementwise math runs in float32 and each stored tensor is
rounded once to its dtype.
"""

import torch

from .. import flags
from .collective import all_reduce_
from .data_parallel import (
    _average, _broadcast_model, _local_loss_and_grads, _pmean_loss,
    _shard_batch, _trainable,
)
from .mesh import default_mesh

__all__ = ["DGCTrainStep", "LocalSGDTrainStep", "dgc_topk_mask"]


def dgc_topk_mask(v, sparsity):
    """Top-k selection mask on |v| in v's dtype: keep the largest
    (1 - sparsity) fraction.

    Default: the exact k-th value via `torch.topk` (ties with it are
    kept).  Under FLAGS_use_pallas_dgc_topk the threshold comes from the
    histogram kernel K10: one pass, no sort, at least k elements kept."""
    if flags.flag("use_pallas_dgc_topk"):
        from ..kernels.topk_threshold import dgc_topk_mask_pallas

        return dgc_topk_mask_pallas(v, sparsity)
    flat = v.abs().reshape(-1)
    k = max(1, int(round(flat.shape[0] * (1.0 - sparsity))))
    kth = torch.topk(flat, k).values[-1]
    return (v.abs() >= kth).to(v.dtype)


class DGCTrainStep:
    """DGC momentum data-parallel train step.

    step = DGCTrainStep(model, loss_fn, mesh, lr=..., momentum=...,
                        sparsity=0.999, rampup_begin_step=0)
    loss = step(x, y)

    Before `rampup_begin_step` steps the update is plain dense momentum
    DP (the reference's DGCMomentumOptimizer: DGC starts at the rampup
    boundary)."""

    def __init__(self, model, loss_fn, mesh=None, lr=0.01, momentum=0.9,
                 sparsity=0.999, rampup_begin_step=0):
        self._model = model
        self._loss_fn = loss_fn
        self._mesh = mesh or default_mesh()
        self._lr = lr
        self._m = momentum
        self._sparsity = sparsity
        self._rampup = int(rampup_begin_step)
        self._state = None   # (u, v, velocity): name -> tensor
        self._count = 0

    def __call__(self, *batch):
        mesh = self._mesh
        if self._state is None:
            _broadcast_model(self._model, mesh)
            params = _trainable(self._model)
            self._state = tuple({n: torch.zeros_like(p) for n, p in
                                 params.items()} for _ in range(3))
        loss, params, grads = _local_loss_and_grads(
            self._model, self._loss_fn, _shard_batch(batch, mesh))
        u, v, vel = self._state
        dgc = self._count >= self._rampup
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n]
                g = torch.zeros_like(p) if g is None else g
                if dgc:
                    self._dgc_update(p, g, u[n], v[n])
                else:
                    g = all_reduce_(g, "mean", mesh).float()
                    vel[n].copy_(vel[n].float().mul_(self._m).add_(g))
                    p.copy_(p.float() - self._lr * vel[n].float())
        self._count += 1
        _average(self._model.buffers(), mesh)
        return _pmean_loss(loss, mesh)

    def _dgc_update(self, p, g, u, v):
        u32 = u.float().mul_(self._m).add_(g.float())   # momentum correction
        u.copy_(u32)
        v.copy_(v.float().add_(u32))                     # error feedback
        mask = dgc_topk_mask(v, self._sparsity)
        dense = all_reduce_(v * mask, "mean", self._mesh)
        keep = 1 - mask
        u.mul_(keep)
        v.mul_(keep)
        # the selected velocity is applied directly (u carries momentum)
        p.copy_(p.float() - self._lr * dense.float())


class LocalSGDTrainStep:
    """LocalSGD data-parallel train step (collective.py:270 parity).

    Each rank's model is its own replica, updated by `optimizer` (a
    functional optimizer, its state per rank); every `local_sgd_steps`
    steps the floating params and buffers are averaged over the mesh.
    local_sgd_steps=1 is synchronous DP for SGD."""

    def __init__(self, model, optimizer, loss_fn, mesh=None,
                 local_sgd_steps=1):
        self._model = model
        self._optimizer = optimizer
        self._loss_fn = loss_fn
        self._mesh = mesh or default_mesh()
        self._k = int(local_sgd_steps)
        self._opt_state = None
        self._count = 0

    def __call__(self, *batch):
        mesh = self._mesh
        if self._opt_state is None:
            _broadcast_model(self._model, mesh)
            self._opt_state = self._optimizer.init(_trainable(self._model))
        loss, params, grads = _local_loss_and_grads(
            self._model, self._loss_fn, _shard_batch(batch, mesh))
        grads = {n: g for n, g in grads.items() if g is not None}
        self._optimizer.update(params, grads, self._opt_state, inplace=True)
        self._count += 1
        if self._count % self._k == 0:
            _average([*params.values(), *self._model.buffers()], mesh)
        return _pmean_loss(loss, mesh)
