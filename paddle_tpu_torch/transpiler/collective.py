"""`fluid.transpiler.collective` — the dp gradient sync (port of
paddle_tpu/transpiler/collective.py).

The reference's GradAllReduce / LocalSGD are program-rewriting
transpilers that insert c_allreduce ops, and its
``fuse_all_reduce_op_pass`` coalesces the per-gradient allreduces into
fused groups.  The static Executor's data-parallel step calls
:func:`sync_gradients` between each BackwardSection and the update ops;
it implements the coalescing as **bucketed gradient synchronization**
(the PyTorch-DDP design, Li et al. VLDB 2020):

- gradients are flattened and packed, per dtype, into fixed-capacity
  buckets of ``FLAGS_dp_bucket_bytes``: ONE all_reduce per bucket
  instead of one per gradient;
- packing runs in reverse production order (the backward produces the
  LAST layer's gradients first);
- the mean is elementwise, so the bucketed sync equals the
  per-gradient sync bitwise;
- gradients that are not plain dense tensors fall back to the
  unbucketed sync: a sparse tensor (the SelectedRows-style lookup-table
  grad) passes through unsynced, a list, tuple or dict of tensors syncs
  one collective per leaf.

The collectives run on the dp axis of the port's `distributed.mesh.Mesh`:
a `torch.distributed` group (NCCL on the card, gloo on the CPU), or an
in-process `LocalGroup` (`distributed/inprocess.py`).  The planning
(:func:`plan_buckets`, :func:`implied_collective_plan`) is the
reference's, line for line, so the plans and the stats of
:func:`last_sync_stats` are the reference's for the same gradients.

The legacy transpile() classes below keep the reference's 1.x entry
points importable.
"""

import torch

from .. import flags
from ..distributed.strategies import LocalSGDTrainStep  # noqa: F401

_ITEM10 = "ROADMAP item 10, monitor and fleet telemetry"

# stats of the most recent sync_gradients call: what the tests and the
# card's smoke run read to hold the collective count
_LAST_SYNC = {}


def last_sync_stats():
    """Stats dict of the most recent gradient sync: mode,
    grads/psums/buckets/fallbacks counts, bucket_bytes, total_bytes,
    per-bucket layout (plan).  Empty dict before any dp run."""
    return dict(_LAST_SYNC)


def plan_buckets(entries, bucket_bytes):
    """Pure planning: pack ``entries`` — ``(name, numel, itemsize,
    dtype_str)`` in firing order — into dtype-segregated fixed-capacity
    flat buckets.  A gradient may span bucket boundaries (the flattened
    design), so per dtype the bucket count is exactly
    ``ceil(total_bytes / bucket_bytes)``.

    Returns ``[{"dtype", "elems", "bytes", "names"}, ...]`` where
    ``names`` lists every gradient with elements in that bucket."""
    groups = {}
    order = []
    for name, numel, itemsize, dtype in entries:
        if dtype not in groups:
            groups[dtype] = []
            order.append(dtype)
        groups[dtype].append((name, int(numel), int(itemsize)))
    buckets = []
    for dtype in order:
        items = groups[dtype]
        itemsize = items[0][2]
        cap_elems = max(1, int(bucket_bytes) // itemsize)
        cur = None
        for name, numel, _ in items:
            remaining = numel
            while remaining > 0 or numel == 0:
                if cur is None or cur["elems"] >= cap_elems:
                    cur = {"dtype": dtype, "elems": 0, "bytes": 0,
                           "names": []}
                    buckets.append(cur)
                take = min(remaining, cap_elems - cur["elems"])
                if name not in cur["names"]:
                    cur["names"].append(name)
                cur["elems"] += take
                cur["bytes"] += take * itemsize
                remaining -= take
                if numel == 0:
                    break
    return buckets


def implied_collective_plan(entries, axes=("dp",), bucket_bytes=None):
    """The static twin of :func:`sync_gradients`: the same
    ``plan_buckets`` math over ``(name, numel, itemsize, dtype)`` entries
    in firing order, as implied-collective records.  ``bucket_bytes=None``
    reads ``FLAGS_dp_bucket_bytes``; 0 plans one all_reduce per
    gradient."""
    if bucket_bytes is None:
        bucket_bytes = int(flags.flag("dp_bucket_bytes"))
    axes = list(axes)
    out = []
    entries = list(entries)
    if bucket_bytes > 0 and entries:
        for b in plan_buckets(entries, bucket_bytes):
            out.append({"kind": "all_reduce", "axes": axes,
                        "var": "+".join(b["names"]),
                        "bytes": int(b["bytes"]),
                        "dtype": b["dtype"]})
    else:
        for name, numel, itemsize, dtype in entries:
            out.append({"kind": "all_reduce", "axes": axes,
                        "var": name,
                        "bytes": int(numel) * int(itemsize),
                        "dtype": dtype})
    return out


def _dtype_name(dtype):
    """A torch dtype by the reference's (numpy's) name: "float32"."""
    return str(dtype).replace("torch.", "")


def _is_dense(g):
    """A plain dense tensor that can be flattened and concatenated (a
    sparse tensor is the SelectedRows-style lookup-table grad)."""
    return isinstance(g, torch.Tensor) and g.layout == torch.strided


def _leaves(g):
    if isinstance(g, dict):
        return [x for v in g.values() for x in _leaves(v)]
    if isinstance(g, (list, tuple)):
        return [x for v in g for x in _leaves(v)]
    return [g]


def _map_leaves(fn, g):
    if isinstance(g, dict):
        return {k: _map_leaves(fn, v) for k, v in g.items()}
    if isinstance(g, (list, tuple)):
        return type(g)(_map_leaves(fn, v) for v in g)
    return fn(g)


def sync_gradients(grads, axis_name, bucket_bytes=None, order=None,
                   key=None, mesh=None):
    """The dp gradient all_reduce (mean) of ``grads`` ({name: tensor})
    over the ``axis_name`` axis of ``mesh`` (None: the default mesh);
    returns {name: synced}.

    ``axis_name=None`` returns the gradients unchanged.  ``bucket_bytes``
    defaults to ``FLAGS_dp_bucket_bytes``; 0 makes one all_reduce per
    gradient.  ``order`` is the firing order for packing (default:
    reversed insertion order — backward produces grads back-to-front).
    ``key`` names the sync in the reference's telemetry record, which is
    ROADMAP item 10; it is accepted and unused."""
    global _LAST_SYNC
    if axis_name is None:
        return dict(grads)
    from ..distributed import collective as C

    if bucket_bytes is None:
        bucket_bytes = int(flags.flag("dp_bucket_bytes"))
    names = list(order) if order is not None else list(reversed(grads))
    dense = [n for n in names if _is_dense(grads[n])]
    dense_set = set(dense)
    fallback = [n for n in names if n not in dense_set]
    out = {}
    psums = 0
    bucketed = 0
    plan = []
    if bucket_bytes > 0 and dense:
        groups = {}
        g_order = []
        for n in dense:
            dt = _dtype_name(grads[n].dtype)
            if dt not in groups:
                groups[dt] = []
                g_order.append(dt)
            groups[dt].append(n)
        plan = plan_buckets(
            [(n, grads[n].numel(), grads[n].element_size(),
              _dtype_name(grads[n].dtype)) for n in dense], bucket_bytes)
        for dt in g_order:
            ns = groups[dt]
            # one new flat buffer per dtype: the buckets are its slices,
            # reduced in place, and the synced grads are views of it
            flat = torch.cat([grads[n].reshape(-1) for n in ns])
            # the collectives follow the plan: the per-bucket element
            # counts below are the ones the stats report
            chunks, off = [], 0
            for b in plan:
                if b["dtype"] == dt:
                    chunks.append(flat[off:off + b["elems"]])
                    off += b["elems"]
            C.all_reduce_many_(chunks, "mean", mesh, axis_name)
            psums += len(chunks)
            bucketed += len(chunks)
            off = 0
            for n in ns:
                sz = grads[n].numel()
                out[n] = flat[off:off + sz].view(grads[n].shape)
                off += sz
    else:
        for n in dense:
            out[n] = C.all_reduce(grads[n], axis_name, "mean", mesh)
            psums += 1
    for n in fallback:
        # a sparse grad passes through UNSYNCED: its rows are this rank's
        # batch's ids, so a sum would add unrelated rows (aggregation
        # belongs to the sparse push of the parameter server, as in the
        # reference's DistMultiTrainer split).  Other nested grads sync
        # per leaf, one collective each.
        g = grads[n]
        if isinstance(g, torch.Tensor):
            out[n] = g
        else:
            out[n] = _map_leaves(
                lambda x: C.all_reduce(x, axis_name, "mean", mesh), g)
            psums += len(_leaves(g))
    _LAST_SYNC = {
        "mode": "bucketed" if bucketed else "per_grad",
        "grads": len(names),
        "psums": psums,
        "buckets": bucketed,
        "fallbacks": len(fallback),
        "bucket_bytes": int(bucket_bytes),
        "total_bytes": int(sum(grads[n].numel() * grads[n].element_size()
                               for n in dense)),
        "plan": plan,
    }
    return out


def note_model_sync(records, key=None):
    """Record the model-parallel collectives of the most recent GSPMD
    step into ``last_sync_stats()["model"]``: ``psums`` (how many),
    ``total_bytes``, ``axes`` and the ``records`` themselves.  The port's
    runtime tier passes the collectives a rank EXECUTED
    (`framework/spmd.py` counts each one as it runs it), so the stats can
    be held against the plan's `collective_table()`.  The reference's
    telemetry record of them (``key``) is ROADMAP item 10; ``key`` is
    accepted and unused."""
    records = [dict(r) for r in records]
    axes = sorted({a for r in records for a in r.get("axes", ())})
    _LAST_SYNC["model"] = {
        "psums": len(records),
        "total_bytes": int(sum(int(r.get("bytes", 0))
                               for r in records)),
        "axes": axes,
        "records": records,
    }
    return dict(_LAST_SYNC["model"])


def emit_skew_probe(ts_sec, ts_usec, axis_name="dp", gather=True):
    """The reference's fleet straggler probe, emitted with the grad
    sync; the port's fleet telemetry is not there yet."""
    raise NotImplementedError(
        f"emit_skew_probe is not ported to paddle_tpu_torch yet ({_ITEM10})")


class Collective:
    def __init__(self, nrings=1):
        self.nrings = nrings
        self.nranks = 1
        self.rank = 0

    def transpile(self, startup_program=None, main_program=None, rank=0,
                  endpoints="127.0.0.1:6174", current_endpoint=None,
                  wait_port=True):
        eps = (endpoints.split(",") if isinstance(endpoints, str)
               else list(endpoints))
        self.nranks = len(eps)
        self.rank = rank
        self.startup_program = startup_program
        self.main_program = main_program
        return self


class GradAllReduce(Collective):
    """DP gradient allreduce: the Executor's data-parallel step inserts
    it (sync_gradients) — nothing to rewrite."""


class LocalSGD(Collective):
    """Periodic parameter averaging; the executing implementation is
    LocalSGDTrainStep."""

    def __init__(self, nrings=1, k_steps=1):
        super().__init__(nrings)
        self.k_steps = k_steps


__all__ = ["GradAllReduce", "LocalSGD", "Collective",
           "sync_gradients", "plan_buckets", "last_sync_stats",
           "implied_collective_plan", "emit_skew_probe",
           "note_model_sync"]
