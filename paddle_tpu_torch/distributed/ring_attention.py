"""Ring attention: exact attention over a sequence sharded on the sp axis
(port of paddle_tpu/distributed/ring_attention.py).

Each rank of the "sp" axis holds a [B, H, S/n, D] shard of q, k and v.
The k/v shards travel around the ring (`collective.ppermute`, rank i to
rank i + 1) while the local q shard folds in one block per hop, so
attention over the whole sequence is computed without any rank holding
more than 1/n of it.  Two forms of the block, as in the reference:

- "flash": each block is `flash_attention_with_lse` (K1 forward, K2/K3
  backward with the lse cotangent on the card).  On the causal ring a
  block is past (K1 non-causal), diagonal (K1 causal) or future (skipped,
  lse = -inf); the (out, lse) partials merge by `_combine_lse`;
- "xla" (the composition): the block's scores with the causal mask at
  global positions, merged by a running max m, sum l and unnormalised
  accumulator o; each block is recomputed in the backward
  (`torch.utils.checkpoint`, the reference's `jax.checkpoint`).

`impl="auto"` picks the flash blocks on the card when the local shard is
in K1's envelope (S/n a multiple of 128, head_dim 64/128/256) and the
composition otherwise, so on the CPU.  A flash block that cannot launch
raises; there is no fallback.

The loop (`ring_loop`) works on a list of local shards and takes the
hop as a function: over the sp group the list holds this rank's shard
and the hop is a ppermute; `ring_attention_local` runs the same loop in
one process over all n shards, the hop rotating the list.
"""

import math

import torch
import torch.utils.checkpoint

NEG_INF = -1e30

__all__ = ["ring_attention", "ring_attention_sharded",
           "ring_attention_local"]


def _use_flash_blocks(impl, q):
    if impl not in ("auto", "flash", "xla"):
        raise ValueError(
            f"ring_attention impl must be 'auto', 'flash' or 'xla'; "
            f"got {impl!r}")
    if impl != "auto":
        return impl == "flash"
    from ..kernels.flash_attention import HEAD_DIMS

    return (q.is_cuda and q.shape[2] % 128 == 0
            and q.shape[3] in HEAD_DIMS)


def _block_attn(q, k, v, q_start, k_start, scale, causal):
    """One q-shard x kv-shard block of the composition: (unnormalised
    out f32, row max m, row sum l), the mask at global positions."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = q_start + torch.arange(q.shape[2], device=q.device)[:, None]
        k_pos = k_start + torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o, m, l


class _KeepInGraph(torch.autograd.Function):
    """x unchanged, with `deps` made part of its graph (zero cotangents).
    A skipped future block keeps its k/v shard in the graph this way: a
    rank whose later shards all lie in its future would otherwise run
    none of the backward hops that the other ranks wait for."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=d)
                     for s, t, d in ctx.deps))


def _flash_ring_block(q, k, v, scale, rel):
    """One block through K1, returning (normalized out f32, lse f32).
    rel: 0 = past (full attention), 1 = diagonal (the causal triangle),
    2 = future (contributes nothing: lse = -inf weights it out)."""
    from ..kernels.flash_attention import flash_attention_with_lse

    if rel == 2:
        lse = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                         device=q.device)
        if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad):
            lse = _KeepInGraph.apply(lse, k, v)
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                lse)
    o, lse = flash_attention_with_lse(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=rel == 1,
                                      sm_scale=scale)
    return o.float(), lse


def _combine_lse(acc, o_i, lse_i):
    """Merge (normalized out, lse) partials: the softmax-weighted mean.
    An empty partial (lse = -inf) gets weight exp(-inf) = 0."""
    o_acc, lse_acc = acc
    lse_new = torch.logaddexp(lse_acc, lse_i)
    safe = torch.where(lse_new <= NEG_INF, torch.zeros_like(lse_new),
                       lse_new)
    a = torch.exp(lse_acc - safe)[..., None]
    b = torch.exp(lse_i - safe)[..., None]
    return o_acc * a + o_i * b, lse_new


def _combine_ml(acc, o_i, m_i, l_i):
    m_acc, l_acc, o_acc = acc
    m_new = torch.maximum(m_acc, m_i)
    # an all-masked block has m_i = -1e30 -> beta = 0: no contribution
    alpha = torch.exp(m_acc - m_new)
    beta = torch.exp(m_i - m_new)
    return (m_new, l_acc * alpha + l_i * beta,
            o_acc * alpha[..., None] + o_i * beta[..., None])


def ring_loop(qs, ks, vs, idxs, n, hop, causal, sm_scale, flash):
    """The ring over the shards this process holds: qs/ks/vs are lists of
    [B, H, S/n, D] shards, idxs their ring positions, and hop(list) the
    lists' tensors one step further round the ring (shard i -> i + 1).
    The local block first, then n - 1 hops, each followed by the block of
    the kv shard that arrived.  Returns the output shards."""
    s_loc = qs[0].shape[2]
    kv_idx = list(idxs)
    if flash:
        def rel(i, j):
            if not causal:
                return 0
            return 1 if j == i else (0 if j < i else 2)

        accs = [(torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                 torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                            device=q.device)) for q in qs]
    else:
        accs = [(torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                            device=q.device),
                 torch.zeros(q.shape[:3], dtype=torch.float32,
                             device=q.device),
                 torch.zeros(q.shape, dtype=torch.float32, device=q.device))
                for q in qs]
    for step in range(n):
        if step:
            ks, vs = hop(ks), hop(vs)
            kv_idx = [(j - 1) % n for j in kv_idx]
        for s, (q, k, v) in enumerate(zip(qs, ks, vs)):
            i, j = idxs[s], kv_idx[s]
            if flash:
                accs[s] = _combine_lse(
                    accs[s], *_flash_ring_block(q, k, v, sm_scale,
                                                rel(i, j)))
            else:
                blk = torch.utils.checkpoint.checkpoint(
                    _block_attn, q, k, v, i * s_loc, j * s_loc, sm_scale,
                    causal, use_reentrant=False)
                accs[s] = _combine_ml(accs[s], *blk)
    if flash:
        return [o.to(q.dtype) for (o, _), q in zip(accs, qs)]
    outs = []
    for (_, l, o), q in zip(accs, qs):
        l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
        outs.append((o / l_safe[..., None]).to(q.dtype))
    return outs


def ring_attention(q, k, v, axis_name="sp", causal=False, sm_scale=None,
                   impl="auto", mesh=None):
    """Exact attention with q/k/v sequence-sharded over `axis_name`:
    q, k, v are this rank's [B, H, S_local, D] shards (rank i of the axis
    holds block i); returns its output shard, q's shape and dtype.
    impl: "auto" (flash blocks on the card within K1's envelope, the
    composition elsewhere), "flash" or "xla"."""
    from .collective import _axis, ppermute

    ax = _axis(mesh, axis_name)
    n = ax.size
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    perm = [(i, (i + 1) % n) for i in range(n)]

    def hop(ts):
        return [ppermute(t, axis_name, perm, mesh) for t in ts]

    return ring_loop([q], [k], [v], [ax.index], n, hop, bool(causal),
                     float(sm_scale), _use_flash_blocks(impl, q))[0]


def ring_attention_local(q, k, v, n, causal=False, sm_scale=None,
                         impl="auto"):
    """The ring in one process: [B, H, S, D] inputs split into n sequence
    shards, each shard's loop run here, the hop rotating the list of
    shards.  The same blocks and merges as `ring_attention` over n
    ranks; returns the [B, H, S, D] output."""
    if q.shape[2] % n:
        raise ValueError(f"sequence {q.shape[2]} does not split into {n} "
                         "shards")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    split = lambda t: [c.contiguous() for c in torch.chunk(t, n, dim=2)]
    qs, ks, vs = split(q), split(k), split(v)
    hop = lambda ts: ts[-1:] + ts[:-1]
    outs = ring_loop(qs, ks, vs, list(range(n)), n, hop, bool(causal),
                     float(sm_scale), _use_flash_blocks(impl, qs[0]))
    return torch.cat(outs, dim=2)


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False,
                           sm_scale=None, impl="auto"):
    """Global-array entry point (the port's `eager_*` convention): q/k/v
    are the whole [B, H, S, D] arrays, the same on every rank; rank r of
    the axis takes the r-th sequence block, the ring runs, and every rank
    gets the global output back.  Every rank computes the same function
    of the output, so its backward gives each rank its own block's
    cotangent."""
    from .collective import _axis, all_gather

    ax = _axis(mesh, axis_name)
    s = q.shape[2]
    if s % ax.size:
        raise ValueError(f"sequence {s} does not split over "
                         f"{axis_name}={ax.size}")
    blk = s // ax.size
    take = lambda t: t.narrow(2, ax.index * blk, blk).contiguous()
    out = ring_attention(take(q), take(k), take(v), axis_name, causal,
                         sm_scale, impl, mesh)
    return all_gather(out, axis_name, axis=2, mesh=mesh, grad="slice")
