"""Pipeline parallelism: the GPipe and interleaved schedules over the "pp"
mesh axis (port of paddle_tpu/distributed/pipeline.py).

The reference runs the whole schedule as one SPMD program: the stacked
stage weights are split over pp, and each tick every device runs its
stage and ppermutes the activation to its ring neighbour.  In the port
each pp rank holds its own stage and runs the same ticks:

- `gpipe(stage_fn, mesh, m)(stage_params, x)`: tick t of rank i runs
  microbatch t - i through the stage (ranks idle in the fill and drain
  bubbles run no stage), then `ppermute`s the output to rank i + 1;
  the last stage collects the outputs, and a sum over pp whose backward
  is the identity (`collective.reduce_sum`) gives every pp rank the
  result, so that every rank computes the same loss from it.  x is the
  same on every pp rank; its gradient is summed over pp
  (`collective.sum_grad`), so each rank gets stage 0's;
- every tick's received activation stays in the graph on every rank
  (stage 0 and idle ticks keep it with a zero cotangent), so that every
  rank runs every hop's backward, in the same order;
- `remat=True` recomputes each stage in the backward
  (`torch.utils.checkpoint`); with dropout each (tick, stage, batch
  index) draws from its own stream, a `torch.Generator` seeded by
  `fold_in` chains of integers as the reference folds its keys (the
  masks are not JAX's bits);
- `interleaved_gpipe`: V chunks per rank (chunk c on rank c mod S), the
  microbatch riding the ring V laps; the fill bubble shrinks V-fold
  (`bubble_fraction`).

`build_gpt_pipeline` splits a `models.gpt.GPT` into the embedding, this
rank's stage of the block stack ({name: [blocks per stage, ...]}) and
the head; `build_gpt_pipeline_3d` adds Megatron tp inside each stage
through `tensor_parallel` (the GPT blocks' own tp code).  The loss an
apply function returns is the global batch's: the batch is split over
the batch axis (dp), each rank's mean is summed over it with an
identity backward, so a rank's grads are its share and `value_and_grad`
sums them over dp.

On a mesh held in one process (`inprocess.local_meshes`) every rank
runs the same code in its thread.
"""

import torch
import torch.utils.checkpoint

from . import collective
from .ring_attention import _KeepInGraph

__all__ = ["gpipe", "interleaved_gpipe", "bubble_fraction",
           "stack_block_params", "interleave_stack_params",
           "stage_params", "tp_stage_spec", "build_gpt_pipeline",
           "build_gpt_pipeline_3d",
           "value_and_grad", "fold_in", "pipeline_dryrun"]

_MASK = (1 << 63) - 1


def fold_in(key, data):
    """A new integer key from `key` and `data` (a splitmix64 step): the
    port's `jax.random.fold_in` for seeding `torch.Generator`s."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(data) + 0x632BE59BD9B4E019) \
        & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & _MASK


def _key_of(rng_key):
    """An integer key from an int or a torch.Generator (one draw)."""
    if isinstance(rng_key, torch.Generator):
        return int(torch.randint(0, 1 << 62, (), generator=rng_key,
                                 device=rng_key.device))
    return int(rng_key)


def _select(take_first, a, b):
    """a if take_first else b, the other kept in the graph with a zero
    cotangent (the reference's jnp.where, whose untaken branch still
    transposes)."""
    keep, drop = (a, b) if take_first else (b, a)
    if torch.is_grad_enabled() and drop.requires_grad:
        return _KeepInGraph.apply(keep, drop)
    return keep


def _idle(h, params):
    """An idle tick's output: zeros, with the received activation and
    the stage's params kept in the graph.  So every tick's sent tensor
    leads, on every rank, to the params and to the schedule's input: the
    backward of a hop is needed on every rank or on none, whatever the
    caller takes grads against (autograd skips the nodes that lead to
    none of them)."""
    z = torch.zeros_like(h)
    deps = [t for t in (h, *_leaves(params)) if t.requires_grad]
    if torch.is_grad_enabled() and deps:
        return _KeepInGraph.apply(z, *deps)
    return z


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _run_stage(stage_fn, remat, params, h, key):
    args = (params, h) if key is None else (params, h, key)
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(stage_fn, *args,
                                                 use_reentrant=False)
    return stage_fn(*args)


def _microbatches(x, m):
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} does not split into "
                         f"{m} microbatches")
    return x.reshape(m, x.shape[0] // m, *x.shape[1:])


def _collect(outs, m, h_last, x, axis_name, mesh, is_last):
    """The m outputs of the last stage (zeros elsewhere) summed over pp
    with an identity backward; the final tick's output kept in the graph
    so that every hop before it stays in it."""
    if is_last:
        out = torch.stack(outs)
    else:
        out = torch.zeros((m,) + tuple(h_last.shape), dtype=h_last.dtype,
                          device=h_last.device)
    if torch.is_grad_enabled() and h_last.requires_grad:
        out = _KeepInGraph.apply(out, h_last)
    out = collective.reduce_sum(out, axis_name, mesh)
    return out.reshape(x.shape)


def gpipe(stage_fn, mesh, num_microbatches, axis_name="pp",
          batch_axis="dp", remat=True, needs_rng=False):
    """Build fn(stage_params, x[, rng_key]) -> y running the GPipe
    schedule on this rank's stage.

    stage_fn(stage_params, h) -> h' (h's shape and dtype); with
    needs_rng, stage_fn(stage_params, h, key) with an integer key =
    fold_in(fold_in(base, tick), stage) (then the batch axis index, when
    `batch_axis` names one), the same in the recompute.
    stage_params: this rank's stage (the reference's `l[0]` of its
    pp-split stack).  x: this rank's [B, ...] (its block over
    batch_axis), B divisible into num_microbatches; y is the stack's
    output for x, on every pp rank.  A rank holds its own tiles, so the
    reference's `param_specs` has no counterpart."""
    n_stages = mesh.axis_size(axis_name)
    me = mesh.axis_index(axis_name)
    m = int(num_microbatches)
    perm = [(j, (j + 1) % n_stages) for j in range(n_stages)]

    def fn(params, x, rng_key=None):
        if needs_rng and rng_key is None:
            raise ValueError("this schedule was built with needs_rng: pass "
                             "an rng_key")
        base = _key_of(rng_key) if needs_rng else None
        x = collective.sum_grad(x, axis_name, mesh)
        xs = _microbatches(x, m)
        h_recv = torch.zeros_like(xs[0])
        outs, h_out = [], None
        ticks = m + n_stages - 1
        for t in range(ticks):
            h_in = _select(me == 0, xs[min(t, m - 1)], h_recv)
            if 0 <= t - me < m:
                key = None
                if needs_rng:
                    key = fold_in(fold_in(base, t), me)
                    if batch_axis:
                        key = fold_in(key, mesh.axis_index(batch_axis))
                h_out = _run_stage(stage_fn, remat, params, h_in, key)
                if me == n_stages - 1:
                    outs.append(h_out)
            else:
                h_out = _idle(h_in, params)
            if t < ticks - 1:
                h_recv = collective.ppermute(h_out, axis_name, perm, mesh)
        return _collect(outs, m, h_out, x, axis_name, mesh,
                        me == n_stages - 1)

    return fn


def bubble_fraction(n_stages, num_microbatches, num_virtual=1):
    """Idle fraction of the schedule: GPipe (S-1)/(m+S-1); with V
    interleaved chunks per rank (S-1)/(mV+S-1)."""
    s, m, v = n_stages, num_microbatches, num_virtual
    return (s - 1) / (m * v + s - 1)


def interleaved_gpipe(stage_fn, mesh, num_microbatches, num_virtual,
                      axis_name="pp", batch_axis="dp", remat=True):
    """The interleaved virtual-stage schedule (Megatron-LM 2104.04473
    §2.2): rank d holds V chunks (chunk c = v*S + d at level v); at
    tick t it runs unit tp = t - d: q, r = divmod(tp, S), level v = q %
    V, microbatch j = (q // V)*S + r, then ppermutes to d + 1, so every
    dependency arrives one tick earlier on the ring neighbour.  m*V +
    S - 1 ticks of 1/V of a GPipe stage each.

    stage_params: this rank's [V, ...] leaves (its rows of
    `interleave_stack_params`).  num_microbatches % S == 0."""
    n_stages = mesh.axis_size(axis_name)
    d = mesh.axis_index(axis_name)
    v_chunks = int(num_virtual)
    m = int(num_microbatches)
    if m % n_stages != 0:
        raise ValueError(
            f"interleaved schedule needs num_microbatches ({m}) "
            f"divisible by n_stages ({n_stages}) — wave injection")
    perm = [(j, (j + 1) % n_stages) for j in range(n_stages)]

    def fn(params, x):
        for name, leaf in params.items():
            if leaf.shape[0] != v_chunks:
                raise ValueError(
                    f"interleaved params must have local leading dim "
                    f"num_virtual={v_chunks} (this rank's rows of "
                    f"interleave_stack_params); {name} has {leaf.shape[0]}")
        x = collective.sum_grad(x, axis_name, mesh)
        xs = _microbatches(x, m)
        h_recv = torch.zeros_like(xs[0])
        outs, h_out = {}, None
        ticks = m * v_chunks + n_stages - 1
        for t in range(ticks):
            u = t - d
            valid = 0 <= u < m * v_chunks
            q, r = divmod(min(max(u, 0), m * v_chunks - 1), n_stages)
            v, j = q % v_chunks, (q // v_chunks) * n_stages + r
            h_in = _select(d == 0 and v == 0, xs[j], h_recv)
            if valid:
                chunk = {n: leaf[v] for n, leaf in params.items()}
                h_out = _run_stage(stage_fn, remat, chunk, h_in, None)
                if d == n_stages - 1 and v == v_chunks - 1:
                    outs[j] = h_out
            else:
                h_out = _idle(h_in, params)
            if t < ticks - 1:
                h_recv = collective.ppermute(h_out, axis_name, perm, mesh)
        last = d == n_stages - 1
        return _collect([outs[j] for j in range(m)] if last else None, m,
                        h_out, x, axis_name, mesh, last)

    return fn


def stack_block_params(block_param_dicts):
    """[{name: tensor}, ...] per block -> {name: tensor[L, ...]}."""
    names = block_param_dicts[0].keys()
    return {n: torch.stack([d[n] for d in block_param_dicts])
            for n in names}


def interleave_stack_params(block_param_dicts, n_stages, num_virtual):
    """Blocks -> {name: [S*V, per_chunk, ...]} in interleaved rank order:
    row d*V + v holds chunk v*S + d, so rank d's rows are d*V ..
    d*V + V - 1."""
    n_blocks = len(block_param_dicts)
    chunks = n_stages * num_virtual
    if n_blocks % chunks != 0:
        raise ValueError(
            f"{n_blocks} blocks not divisible into {chunks} chunks")
    per = n_blocks // chunks
    stacked = stack_block_params(block_param_dicts)
    out = {}
    for n, arr in stacked.items():
        byc = arr.reshape(chunks, per, *arr.shape[1:])
        out[n] = torch.stack([byc[v * n_stages + d]
                              for d in range(n_stages)
                              for v in range(num_virtual)])
    return out


def stage_params(stacked, mesh, axis_name="pp", rows=1):
    """This rank's rows of a pp-stacked tree ({name: [S*rows, ...]}):
    rows r*rows .. (r+1)*rows - 1 (rows = 1 gives [per, ...] leaves
    without the stage dim; rows = V gives the interleaved [V, ...])."""
    r = mesh.axis_index(axis_name)
    if rows == 1:
        return {n: v[r].clone() for n, v in stacked.items()}
    return {n: v[r * rows:(r + 1) * rows].clone() for n, v in stacked.items()}


def _blocks_stage_fn(block0, dropout_p):
    """A stage over stacked blocks ({name: [per, ...]}), each block a
    functional call of `block0` with its row; with dropout, block k of a
    stage draws from a generator seeded fold_in(key, k)."""
    from ..nn.layers import functional_call
    from ..nn.parameter import default_rng

    def plain(p, h):
        per = next(iter(p.values())).shape[0]
        for k in range(per):
            h = functional_call(block0, {n: t[k] for n, t in p.items()}, h)
        return h

    if not dropout_p:
        return plain

    def with_rng(p, h, key):
        per = next(iter(p.values())).shape[0]
        for k in range(per):
            g = torch.Generator(device=h.device)
            g.manual_seed(fold_in(key, k))
            with default_rng.key_context(g):
                h = functional_call(block0, {n: t[k] for n, t in p.items()},
                                    h)
        return h

    return with_rng


def _emb_head(model):
    from ..nn.layers import param_dict

    all_params = param_dict(model)
    emb = {n: v for n, v in all_params.items()
           if n.startswith(("wte.", "wpe."))}
    head = {n: v for n, v in all_params.items() if n.startswith("norm_f.")}
    return emb, head


def build_gpt_pipeline(model, mesh, num_microbatches, axis_name="pp",
                       interleave=1, batch_axis="dp"):
    """Split a models.gpt.GPT into a pp-parallel middle: (apply_fn,
    params) with params = {"emb": {...}, "stages": this rank's stage
    {name: [L/S, ...]} (interleave V > 1: {name: [V, L/(S V), ...]}),
    "head": {...}} and apply_fn(params, input_ids, labels[, rng_key]) ->
    the global batch's mean token loss (see the module docstring).
    interleave > 1 needs dropout 0 and num_microbatches % S == 0."""
    from ..nn.layers import param_dict

    dropout_p = float(getattr(model.cfg, "dropout", 0.0) or 0.0)
    n_stages = mesh.axis_size(axis_name)
    blocks = list(model.blocks)
    block0 = blocks[0]
    dicts = [{n: t.detach() for n, t in param_dict(b).items()}
             for b in blocks]
    if interleave > 1:
        if dropout_p:
            raise ValueError(
                "interleave > 1 requires dropout=0.0 (per-tick rng "
                "threading is GPipe-schedule only)")
        stages = stage_params(interleave_stack_params(dicts, n_stages,
                                                      interleave),
                              mesh, axis_name, rows=interleave)
        pipe = interleaved_gpipe(_blocks_stage_fn(block0, 0.0), mesh,
                                 num_microbatches, interleave,
                                 axis_name=axis_name, batch_axis=batch_axis)
    else:
        if len(blocks) % n_stages:
            raise ValueError(f"{len(blocks)} blocks not divisible into "
                             f"{n_stages} stages")
        per = len(blocks) // n_stages
        me = mesh.axis_index(axis_name)
        stages = stack_block_params(dicts[me * per:(me + 1) * per])
        pipe = gpipe(_blocks_stage_fn(block0, dropout_p), mesh,
                     num_microbatches, axis_name=axis_name,
                     batch_axis=batch_axis, needs_rng=bool(dropout_p))
    emb, head = _emb_head(model)
    params = {"emb": {n: v.detach().clone() for n, v in emb.items()},
              "stages": {n: v.clone() for n, v in stages.items()},
              "head": {n: v.detach().clone() for n, v in head.items()}}
    return _lm_apply_fn(model, pipe, dropout_p, mesh, batch_axis), params


def _lm_apply_fn(model, pipe, dropout_p, mesh, batch_axis):
    """The pre/post-pipeline LM wrapper shared by both builders: the
    embedding lookup (+ dropout), the pipelined blocks, the final
    LayerNorm, the tied head and the fused CE; the rank's mean summed
    over the batch axis (identity backward)."""
    from ..nn import functional as F

    max_seq = model.cfg.max_seq_len
    eps = model.norm_f._epsilon
    bsize = mesh.axis_size(batch_axis) if batch_axis else 1

    def apply_fn(params, input_ids, labels, rng_key=None):
        wte = params["emb"]["wte.weight"]
        wpe = params["emb"]["wpe.weight"]
        seq = input_ids.shape[1]
        if seq > max_seq:
            raise ValueError(
                f"sequence length {seq} exceeds max_seq_len {max_seq}")
        pos = torch.arange(seq, dtype=torch.long,
                           device=input_ids.device)[None, :]
        h = F.embedding(input_ids.long(), wte) + F.embedding(pos, wpe)
        if dropout_p:
            if rng_key is None:
                raise ValueError(
                    "this pipeline was built with dropout>0: pass a "
                    "fresh rng_key to every apply_fn call (a fixed key "
                    "would reuse the same dropout masks each step)")
            key = _key_of(rng_key)
            g = torch.Generator(device=h.device)
            g.manual_seed(fold_in(key, 1 << 30))
            h = F.dropout(h, p=dropout_p, generator=g)
            h = pipe(params["stages"], h, key)
        else:
            h = pipe(params["stages"], h)
        h = F.layer_norm(h, [h.shape[-1]], params["head"]["norm_f.weight"],
                         params["head"]["norm_f.bias"], eps)
        logits = torch.einsum("bsh,vh->bsv", h, wte)
        lse = torch.logsumexp(logits.float(), dim=-1)
        lab = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        loss = (lse - lab.float()).mean()
        if bsize > 1:
            loss = collective.reduce_sum(loss / bsize, batch_axis, mesh)
        return loss

    return apply_fn


def tp_stage_spec(name):
    """The tp split of a stacked block leaf [per, ...] in the 3D pipeline:
    column parallel (output dim) for q/k/v and fc1, row parallel (input
    dim) for out_proj and fc2 weights, the rest whole (the norms, the
    row-parallel biases)."""
    from .sharded import P

    col = any(k in name for k in ("q_proj", "k_proj", "v_proj", "fc1"))
    if col and name.endswith(".weight"):
        return P(None, None, "tp")
    if col and name.endswith(".bias"):
        return P(None, "tp")
    if name.endswith(".weight") and any(k in name
                                        for k in ("out_proj", "fc2")):
        return P(None, "tp", None)
    return P()


def build_gpt_pipeline_3d(model, mesh, num_microbatches, axis_pp="pp",
                          axis_tp="tp", batch_axis="dp"):
    """dp x tp x pp in one mesh: Megatron tensor parallelism inside each
    pipeline stage.  This rank's stage leaves are its tp tiles of the
    stacked blocks (q/k/v and fc1 split on their output dim, out_proj
    and fc2 on their input dim, the rest whole), and each block runs
    the GPT block's own tp path under `tensor_parallel(mesh)` (two sums
    over tp per block).  Needs dropout 0.  Returns (apply_fn, params)
    like `build_gpt_pipeline`."""
    from ..nn.layers import param_dict
    from .sharded import local_block
    from .tensor_parallel import tensor_parallel

    if float(getattr(model.cfg, "dropout", 0.0) or 0.0):
        raise ValueError("build_gpt_pipeline_3d requires dropout=0.0")
    if axis_tp != "tp":
        raise ValueError("the GPT blocks' tp path runs over the 'tp' axis")
    n_stages = mesh.axis_size(axis_pp)
    tp = mesh.axis_size(axis_tp)
    heads = model.cfg.num_heads
    if heads % tp:
        raise ValueError(f"{heads} heads not divisible by tp={tp}")
    blocks = list(model.blocks)
    if len(blocks) % n_stages:
        raise ValueError(f"{len(blocks)} blocks not divisible into "
                         f"{n_stages} stages")
    per = len(blocks) // n_stages
    me = mesh.axis_index(axis_pp)
    dicts = [{n: t.detach() for n, t in param_dict(b).items()}
             for b in blocks[me * per:(me + 1) * per]]
    stacked = stack_block_params(dicts)

    stages = {n: local_block(mesh, tp_stage_spec(n), v).clone()
              for n, v in stacked.items()}
    plain = _blocks_stage_fn(blocks[0], 0.0)

    def stage_fn(p, h):
        # the context inside the stage, so that its recompute in the
        # backward runs the tp path too
        with tensor_parallel(mesh):
            return plain(p, h)

    # a recompute would run the tp sums inside the backward, which the
    # ranks of an in-process mesh (threads) cannot meet in
    pipe = gpipe(stage_fn, mesh, num_microbatches, axis_name=axis_pp,
                 batch_axis=batch_axis,
                 remat=getattr(mesh, "world", None) is None)
    emb, head = _emb_head(model)
    params = {"emb": {n: v.detach().clone() for n, v in emb.items()},
              "stages": stages,
              "head": {n: v.detach().clone() for n, v in head.items()}}
    return _lm_apply_fn(model, pipe, 0.0, mesh, batch_axis), params


def value_and_grad(apply_fn, mesh, batch_axis="dp"):
    """fn(params, *args, **kw) -> (loss, grads): the apply function's
    global loss and, per leaf of params, its gradient summed over the
    batch axis (the grads of the global batch's loss)."""

    def fn(params, *args, **kw):
        flat = [(g, n, t) for g in params for n, t in params[g].items()]
        leaves = [t.detach().requires_grad_() for _, _, t in flat]
        tree = {g: {} for g in params}
        for (g, n, _), leaf in zip(flat, leaves):
            tree[g][n] = leaf
        with torch.enable_grad():
            loss = apply_fn(tree, *args, **kw)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out = {g: {} for g in params}
        for (g, n, t), gr in zip(flat, grads):
            gr = torch.zeros_like(t) if gr is None else gr
            if batch_axis and mesh.axis_size(batch_axis) > 1:
                gr = collective.all_reduce_(gr.contiguous(), "sum", mesh,
                                            batch_axis)
            out[g][n] = gr
        return loss.detach(), out

    return fn


def pipeline_dryrun(n_devices, num_microbatches=4, pp=2, dropout=0.0,
                    mesh=None, device=None):
    """One pipelined forward, backward and SGD step on a pp x dp mesh of
    n_devices ranks (this process's group, or `mesh`); returns the
    loss."""
    import numpy as np

    from ..models.gpt import GPT, GPTConfig
    from ..nn import make_generator
    from .mesh import build_mesh

    dp = n_devices // pp
    if mesh is None:
        mesh = build_mesh(dp=dp, pp=pp, device=device)
    model = GPT(GPTConfig(vocab_size=256, hidden_size=32, num_layers=pp * 2,
                          num_heads=4, max_seq_len=16, dropout=dropout),
                device=mesh.device, generator=make_generator(0))
    apply_fn, params = build_gpt_pipeline(model, mesh, num_microbatches)
    r = np.random.default_rng(0)
    batch = max(2 * dp, 1) * num_microbatches
    x = torch.as_tensor(r.integers(0, 256, (batch, 16)), dtype=torch.int32)
    y = torch.as_tensor(r.integers(0, 256, (batch, 16)), dtype=torch.int32)
    from .sharded import P, shard_batch

    x, y = (t.to(mesh.device) for t in shard_batch(mesh, x, y, spec=P("dp")))
    kw = {"rng_key": 0} if dropout else {}
    loss, grads = value_and_grad(apply_fn, mesh)(params, x, y, **kw)
    with torch.no_grad():
        for g in params:
            for n, t in params[g].items():
                t.sub_(1e-3 * grads[g][n])
    if not np.isfinite(float(loss)):
        raise AssertionError("pipeline dryrun loss not finite")
    return float(loss)
