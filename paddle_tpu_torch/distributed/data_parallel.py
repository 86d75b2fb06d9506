"""Data parallelism (port of paddle_tpu/distributed/data_parallel.py).

The reference runs one jitted shard_map over the mesh's "dp" axis:
params replicated, the global batch sharded over dp, grads pmean'd.  In
the port every rank is a process holding its own replica of the model
(its `Parameter`s are the replica, updated in place) and running the
same step eagerly on its share of the batch:

- the batch is global, as in the reference: rank r takes the contiguous
  r-th 1/size share of dim 0 (what `P("dp")` gives); a batch that does
  not divide by the mesh's size raises;
- the loss and the grads are averaged over the mesh (a SUM all_reduce,
  then a division by the size), the optimizer (a functional optimizer of
  `paddle_tpu_torch.optimizer`) updates the params in place; the
  buffers a forward replaced (the batch-norm running stats) are written
  back into the model's own tensors, and the floating buffers are
  averaged;
- on its first call a step broadcasts rank 0's params and buffers, so
  the replicas start equal, as the reference's replicated params are.

`_local_loss_and_grads`, `_shard_batch`, `_commit_buffers` and
`_average` are shared with the DGC and LocalSGD steps
(`strategies.py`).
"""

import torch
import torch.distributed as dist

from .collective import all_reduce_
from .mesh import default_mesh

__all__ = ["DataParallel", "DataParallelTrainStep", "scale_loss"]


def scale_loss(loss, nranks=None):
    """Parity: dygraph/parallel.py:290 — kept for API compatibility; the
    step's mean of the grads makes explicit loss scaling unnecessary."""
    return loss


def _shard_batch(batch, mesh):
    """Rank r's contiguous 1/size share of each global batch array, on
    the mesh's device."""
    out = []
    for b in batch:
        t = torch.as_tensor(b)
        n = t.shape[0]
        if n % mesh.size:
            raise ValueError(f"batch dim 0 of size {n} does not divide "
                             f"over dp={mesh.size}")
        blk = n // mesh.size
        out.append(t.narrow(0, mesh.rank * blk, blk).to(mesh.device))
    return tuple(out)


def _trainable(model):
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _buffer_slots(model):
    return {(mod, name): b for mod in model.modules()
            for name, b in mod._buffers.items() if b is not None}


def _local_loss_and_grads(model, loss_fn, batch):
    """loss_fn(model, *batch) on this rank's batch and its grads with
    respect to the model's trainable params (None for an unused one).
    The buffers the forward replaced are copied into the model's own
    tensors; a recomputed forward (fleet's `recompute`) does not replace
    them a second time."""
    params = _trainable(model)
    before = _buffer_slots(model)
    with torch.enable_grad():
        loss = loss_fn(model, *batch)
        after = _buffer_slots(model)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
    _commit_buffers(model, before, after)
    return loss.detach(), params, dict(zip(params, grads))


def _commit_buffers(model, before, after):
    with torch.no_grad():
        for (mod, name), old in before.items():
            new = after[(mod, name)]
            if new is not old:
                old.copy_(new)
            mod._buffers[name] = old


def _average(tensors, mesh):
    """Average the floating tensors over the mesh, in place (a real
    collective at every size, so a one-rank group runs the path too)."""
    with torch.no_grad():
        for t in tensors:
            if t.is_floating_point():
                all_reduce_(t, "mean", mesh)


def _broadcast_model(model, mesh):
    """The first dp rank's params and buffers to the other dp ranks of
    its group, in place (on a multi-axis mesh the dp group need not
    hold global rank 0)."""
    if mesh.size == 1:
        return
    src = mesh.axis_ranks("dp")[0]
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t.data, src, group=mesh.group)


def _pmean_loss(loss, mesh):
    return all_reduce_(loss.clone(), "mean", mesh)


class DataParallelTrainStep:
    """Data-parallel train step over a mesh's dp ranks.

        step = DataParallelTrainStep(model, optimizer, loss_fn, mesh)
        loss = step(x, y)   # x, y: the global batch

    `optimizer` is a functional optimizer (`optimizer.functional`); its
    state lives on the step, one copy per rank (they stay equal, since
    every rank applies the same averaged grads)."""

    def __init__(self, model, optimizer, loss_fn, mesh=None):
        self._model = model
        self._optimizer = optimizer
        self._loss_fn = loss_fn
        self._mesh = mesh or default_mesh()
        self._opt_state = None

    def __call__(self, *batch):
        mesh = self._mesh
        if self._opt_state is None:
            _broadcast_model(self._model, mesh)
            self._opt_state = self._optimizer.init(_trainable(self._model))
        loss, params, grads = _local_loss_and_grads(
            self._model, self._loss_fn, _shard_batch(batch, mesh))
        grads = {n: g for n, g in grads.items() if g is not None}
        _average(grads.values(), mesh)
        self._optimizer.update(params, grads, self._opt_state, inplace=True)
        _average(self._model.buffers(), mesh)
        return _pmean_loss(loss, mesh)


class DataParallel:
    """The dygraph `DataParallel` (reference parallel.py:223) wraps a
    layer for the dygraph tracer, which the port does not have yet."""

    def __init__(self, layer, strategy=None):
        raise NotImplementedError(
            "DataParallel belongs to the dygraph tier, not ported yet "
            "(ROADMAP queue 1 item 10); use DataParallelTrainStep")
