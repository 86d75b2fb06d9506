"""Mixture-of-Experts with expert parallelism over the ep axis (port of
paddle_tpu/distributed/moe.py).

The reference routes with dense one-hot einsums: `top_k_gating` builds
dispatch/combine tensors [N, E, C] (N tokens, E experts, C slots per
expert) and the dispatch and combine are products with them.  The port
keeps that API: `top_k_gating` returns the same dense tensors, bit for
bit in f32.  Its FFNs route by index instead (`_route`): each slot of
[E, C, D] gathers the token that fills it and scatter-adds `gate x out`
back to it.  It is the same function; only the order in which
the <= k terms of a token are summed can differ.  At the sizes the card
trains (8192 tokens, 8 experts, 2560 slots) a dense [N, E, C] f32
tensor is 671 MB per layer, which the backward would keep per layer.

Routing and the expert products run in f32 whatever the input dtype, as
the reference casts, with `torch.autocast` off around them; the port's
AMP lists never reach them (they are torch calls, not the port's ops).

Forms:
- `top_k_gating`: softmax router, top-k expert choice, capacity
  clipping, the Switch load-balance auxiliary loss;
- `moe_ffn`: the MoE FFN on one rank;
- `shard_moe_params` / `sharded_moe_ffn`: expert weights split over ep
  (each rank its [E/ep, ...] slice, the router whole), tokens the same
  on every rank, each rank running its local experts and the outputs
  all-gathered over ep;
- `moe_ffn_shardmap`: per-rank tokens, local gating and the two
  explicit all_to_alls over ep (the reference's shard_map form);
- `moe_layer`: what `models.gpt.MoEFFN` calls: `moe_ffn`, or inside
  `expert_parallel(mesh)` (the sharded train step) the global-batch
  form: the router input gathered over dp, every rank gating the global
  tokens, its local experts run and their outputs gathered over ep.
"""

import contextlib
import math
import threading

import torch

__all__ = ["init_moe_params", "top_k_gating", "moe_ffn",
           "shard_moe_params", "sharded_moe_ffn", "moe_ffn_shardmap",
           "expert_parallel", "moe_layer"]

# (mesh, expert axis, data axis) of the active step, per thread (the
# ranks of an in-process mesh are threads)
_EXPERT_MESH = threading.local()


def _expert_stack():
    stack = getattr(_EXPERT_MESH, "stack", None)
    if stack is None:
        stack = _EXPERT_MESH.stack = []
    return stack


def gelu(x):
    """`jax.nn.gelu`'s default, the tanh form."""
    return torch.nn.functional.gelu(x, approximate="tanh")


@contextlib.contextmanager
def _f32_products(device):
    with torch.autocast(device_type=device.type, enabled=False):
        yield


def init_moe_params(generator, num_experts, d_model, d_hidden,
                    dtype=torch.float32):
    """Router + per-expert FFN weights: wg [D, E], w1 [E, D, H], w2 [E, H,
    D], normal draws from `generator` (on its device) scaled by
    1/sqrt(fan-in)."""
    s1 = 1.0 / math.sqrt(d_model)
    s2 = 1.0 / math.sqrt(d_hidden)

    def draw(shape, scale):
        v = torch.randn(shape, generator=generator,
                        device=generator.device) * scale
        return v.to(dtype)

    return {"wg": draw((d_model, num_experts), s1),
            "w1": draw((num_experts, d_model, d_hidden), s1),
            "w2": draw((num_experts, d_hidden, d_model), s2)}


def capacity(n, e, k, capacity_factor, min_capacity=4):
    return max(int(min_capacity), int(math.ceil(k * n / e * capacity_factor)))


class _Routing:
    """The index form of one gating: per choice pass p, `idx[p]` [N]
    (the expert), `pos[p]` [N] (the slot in its capacity), `keep[p]` [N]
    and `gate[p]` [N] (the router probability of the choice, which
    carries the gradient); `probs` [N, E], `aux`, `n`, `e`, `cap`."""

    def __init__(self, probs, idx, pos, keep, gate, aux, cap):
        self.probs, self.idx, self.pos, self.keep = probs, idx, pos, keep
        self.gate, self.aux, self.cap = gate, aux, cap
        self.n, self.e = probs.shape

    def slots(self, experts=None):
        """(token ids, slot ids, gates, trash) over every (token,
        choice), pass by pass: the slot of a kept choice is
        (e - lo) * cap + pos; a dropped choice, or one routed to an
        expert outside `experts` = (lo, hi), goes to the slot `trash` =
        (hi - lo) * cap with gate 0.  The shapes do not depend on the
        routing, so nothing waits for the device."""
        lo, hi = experts or (0, self.e)
        trash = (hi - lo) * self.cap
        idx, pos = torch.cat(self.idx), torch.cat(self.pos)
        live = torch.cat(self.keep) & (idx >= lo) & (idx < hi)
        slot = torch.where(live, (idx - lo) * self.cap + pos,
                           torch.full_like(idx, trash))
        toks = torch.arange(self.n, device=idx.device).repeat(len(self.idx))
        return toks, slot, torch.cat(self.gate) * live, trash

    def by_slot(self, experts=None):
        """(token [S], gate [S]) of each of the S = (hi - lo) * cap
        slots of `experts` (all by default): the token that fills it and
        its router probability, or the dummy token n and gate 0 where
        the slot is empty.  Indexed by slot, the dispatch and the
        combine gather and scatter without repeated indices but the
        dummy's, so their backwards are cheap."""
        toks, slot, gates, trash = self.slots(experts)
        slot_tok = torch.full((trash + 1,), self.n, dtype=toks.dtype,
                              device=toks.device).scatter(0, slot, toks)
        slot_gate = gates.new_zeros(trash + 1).scatter(0, slot, gates)
        return slot_tok[:trash], slot_gate[:trash]


def _route(x, wg, k, capacity_factor, min_capacity=4):
    """Top-k gating of tokens x [N, D] in index form (see `_Routing`),
    the reference's `top_k_gating` step for step: f32 logits and softmax,
    `argmax`'s first maximum per pass, each pass's positions offset past
    the slots earlier passes took, the Switch aux loss on the full
    router distribution.  Positions are cumulative counts over the
    tokens of each expert (a scan along the contiguous dim of the
    [E, N] one-hot)."""
    n = x.shape[0]
    e = wg.shape[1]
    cap = capacity(n, e, k, capacity_factor, min_capacity)
    with _f32_products(x.device):
        logits = x.float() @ wg.float()                        # [N, E]
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)
    counts = torch.zeros(e, 1, dtype=torch.int32, device=x.device)
    total = torch.zeros(e, dtype=torch.float32, device=x.device)
    masked = probs.detach()
    idxs, poss, keeps, gates = [], [], [], []
    for _ in range(k):
        idx = torch.argmax(masked, dim=1)                      # [N]
        onehot = torch.nn.functional.one_hot(idx, e)           # [N, E]
        hot_t = onehot.t().to(torch.int32).contiguous()        # [E, N]
        pos = (torch.cumsum(hot_t, dim=1, dtype=torch.int32) - 1
               + counts).gather(0, idx[None, :])[0]
        keep = pos < cap
        idxs.append(idx)
        poss.append(pos)
        keeps.append(keep)
        gates.append(probs.gather(1, idx[:, None])[:, 0])
        total = total + onehot.float().sum(dim=0)
        counts = counts + (hot_t * keep).sum(dim=1, keepdim=True,
                                             dtype=torch.int32)
        masked = masked * (1.0 - onehot.float())
    ce = total / n / k
    aux = e * torch.sum(me * ce)
    return _Routing(probs, idxs, poss, keeps, gates, aux, cap)


def top_k_gating(x, wg, k=2, capacity_factor=1.25, min_capacity=4):
    """Route tokens to top-k experts.

    x: [N, D] tokens.  Returns (dispatch [N, E, C] 0/1 f32, combine
    [N, E, C], aux_loss) with C = max(min_capacity, ceil(k N / E
    capacity_factor)): the reference's dense form."""
    r = _route(x, wg, k, capacity_factor, min_capacity)
    toks, slot, gates, trash = r.slots()
    live = (slot < trash).float()
    zeros = torch.zeros((r.n, trash + 1), dtype=torch.float32,
                        device=x.device)
    # the trash column takes the dropped choices and is cut off
    dispatch = zeros.index_put((toks, slot), live)[:, :trash]
    combine = zeros.index_put((toks, slot), gates)[:, :trash]
    shape = (r.n, r.e, r.cap)
    return dispatch.reshape(shape), combine.reshape(shape), r.aux


def _dispatch(toks, slot_tok):
    """[S, D] f32: each slot's token, zeros in the empty slots."""
    ext = torch.cat([toks, toks.new_zeros((1, toks.shape[1]))])
    return ext.index_select(0, slot_tok)


def _combine(out, slot_tok, slot_gate, n):
    """[n, D]: the sum over each token's kept choices of gate x the
    expert output in its slot (out [S, D] by slot; the empty slots add
    0 to a dummy row)."""
    y = out.new_zeros((n + 1, out.shape[-1]))
    return y.index_add(0, slot_tok, out * slot_gate[:, None])[:n]


def _experts(xin, w1, w2, activation):
    """[E, C, D] f32 slots through each expert's FFN, in f32."""
    h = activation(torch.bmm(xin, w1.float()))
    return torch.bmm(h, w2.float())


def moe_ffn(params, x, k=2, capacity_factor=1.25, activation=gelu):
    """MoE feed-forward over tokens x: [..., D] -> [..., D] in x's dtype,
    plus the load-balance aux loss."""
    lead, d = x.shape[:-1], x.shape[-1]
    toks = x.reshape(-1, d)
    r = _route(toks, params["wg"], k, capacity_factor)
    slot_tok, slot_gate = r.by_slot()
    with _f32_products(x.device):
        xin = _dispatch(toks.float(), slot_tok)
        out = _experts(xin.view(r.e, r.cap, d), params["w1"], params["w2"],
                       activation)
        y = _combine(out.reshape(-1, d), slot_tok, slot_gate, r.n)
    return y.reshape(*lead, d).to(x.dtype), r.aux


def _ep(mesh, axis):
    from .collective import _axis

    return _axis(mesh, axis)


def shard_moe_params(params, mesh, axis="ep"):
    """This rank's [E/ep, ...] slices of the expert-major weights (w1,
    w2); the router wg stays whole."""
    ax = _ep(mesh, axis)
    out = dict(params)
    for name in ("w1", "w2"):
        w = params[name]
        if w.shape[0] % ax.size:
            raise ValueError(f"shard_moe_params: {w.shape[0]} experts do "
                             f"not split over {axis}={ax.size}")
        blk = w.shape[0] // ax.size
        out[name] = w[ax.index * blk:(ax.index + 1) * blk].clone()
    return out


def local_experts_ffn(params, toks, r, mesh, axis, activation):
    """The expert half of a gating `r` of tokens `toks` [N, D] that are
    the same on every rank of `axis`: this rank runs its E/ep experts on
    their slots, the outputs are all-gathered over `axis` and combined
    -> [N, D] f32.  The tokens' gradient is summed over `axis` (each rank
    sends back only its experts' share); the gathered outputs give each
    rank its own block's cotangent, not the group's sum, since every
    rank computes the same loss from them."""
    from .collective import all_gather, sum_grad

    ax = _ep(mesh, axis)
    e_loc, d = params["w1"].shape[0], toks.shape[1]
    lo = ax.index * e_loc
    if e_loc * ax.size != r.e:
        raise ValueError(
            f"the router routes over {r.e} experts but w1 holds {e_loc} "
            f"local experts x {ax.size} '{axis}' shards")
    with _f32_products(toks.device):
        src = sum_grad(toks.float(), axis, mesh)
        xin = _dispatch(src, r.by_slot((lo, lo + e_loc))[0])
        out = _experts(xin.view(e_loc, r.cap, d), params["w1"],
                       params["w2"], activation)
        out = all_gather(out, axis, mesh=mesh, grad="slice")
        return _combine(out.reshape(-1, d), *r.by_slot(), r.n)


def sharded_moe_ffn(params, x, mesh, axis="ep", k=2, capacity_factor=1.25,
                    activation=gelu):
    """Expert-parallel MoE forward: params are this rank's slices
    (`shard_moe_params`), x [..., D] is the same on every rank of
    `axis`; each rank gates all tokens, runs its local experts, and the
    expert outputs are all-gathered over `axis` -> the dense result
    (`moe_ffn`'s) on every rank, and the aux loss."""
    lead, d = x.shape[:-1], x.shape[-1]
    toks = x.reshape(-1, d)
    r = _route(toks, params["wg"], k, capacity_factor)
    y = local_experts_ffn(params, toks, r, mesh, axis, activation)
    return y.reshape(*lead, d).to(x.dtype), r.aux


def moe_ffn_shardmap(params, x, axis="ep", k=2, capacity_factor=1.25,
                     activation=gelu, mesh=None):
    """Expert-parallel MoE over per-rank tokens (the reference's form for
    a shard_map body).  params' expert-major leaves are this rank's
    [E/ep, ...] slices, the router wg is whole [D, E]; x is this rank's
    token shard.  Tokens are gated locally, the [E, C, D] slots are
    exchanged expert-major over `axis` (all_to_all), the local experts
    run on every source rank's slots, the reverse exchange brings the
    outputs back, and the combine gives each token its experts' sum.
    With enough capacity (no drops) the result is `moe_ffn` of the same
    tokens."""
    from .collective import all_to_all

    ax = _ep(mesh, axis)
    ep = ax.size
    lead, d = x.shape[:-1], x.shape[-1]
    toks = x.reshape(-1, d)
    e_loc = params["w1"].shape[0]
    if params["wg"].shape[-1] != ep * e_loc:
        raise AssertionError(
            f"moe_ffn_shardmap: router wg routes over "
            f"{params['wg'].shape[-1]} experts but w1 holds {e_loc} local "
            f"experts x {ep} '{axis}' shards = {ep * e_loc}.  Expert-major "
            f"leaves (w1/w2) must be the LOCAL [E/ep, ...] slices of the "
            f"global expert dim: pass params sharded over '{axis}' (e.g. "
            f"with shard_moe_params), not the full-expert arrays.")
    r = _route(toks, params["wg"], k, capacity_factor)
    cap = r.cap
    slot_tok, slot_gate = r.by_slot()
    with _f32_products(x.device):
        xin = _dispatch(toks.float(), slot_tok)
        # [E, C, D] -> [ep, E_loc, C, D]; after the exchange the leading
        # dim is the SOURCE rank whose tokens fill those slots
        xin = all_to_all(xin.view(ep, e_loc, cap, d), axis, 0, 0, mesh)
        xin = xin.transpose(0, 1).reshape(e_loc, ep * cap, d)
        out = _experts(xin, params["w1"], params["w2"], activation)
        out = out.view(e_loc, ep, cap, d).transpose(0, 1).contiguous()
        # reverse exchange: slots travel back to their tokens' ranks
        out = all_to_all(out, axis, 0, 0, mesh)
        y = _combine(out.reshape(-1, d), slot_tok, slot_gate, r.n)
    return y.reshape(*lead, d).to(x.dtype), r.aux


@contextlib.contextmanager
def expert_parallel(mesh, axis="ep", data_axis="dp"):
    """Within it `moe_layer` computes the unsharded layer's function of
    the GLOBAL batch, from this rank's batch block (split over
    `data_axis`, and its sequence over "sp") and this rank's expert
    slices (split over `axis`)."""
    stack = _expert_stack()
    stack.append((mesh, axis, data_axis))
    try:
        yield
    finally:
        stack.pop()


def moe_layer(params, x, k=2, capacity_factor=1.25, activation=gelu):
    """`moe_ffn`, or inside `expert_parallel` its global-batch form: x
    [B/dp, ..., D] is this rank's block of the batch; the blocks are
    gathered over dp (the backward sums each block's cotangent over the
    dp ranks, whose losses differ), every rank gates the global tokens,
    its local experts run (`local_experts_ffn`), and it keeps its block
    of the result.  Gating, capacity and the aux loss are the global
    batch's, as under the reference's GSPMD step."""
    stack = _expert_stack()
    if not stack:
        return moe_ffn(params, x, k, capacity_factor, activation)
    from .collective import _axis, all_gather

    mesh, axis, data_axis = stack[-1]
    dp = _axis(mesh, data_axis)
    sp = _axis(mesh, "sp")
    xs = x
    if sp.size > 1:
        # [B/dp, S/sp, D] -> [B/dp, S, D]: the global token order
        xs = all_gather(xs, "sp", axis=1, mesh=mesh)
    xs = all_gather(xs, data_axis, axis=0, mesh=mesh)
    lead, d = xs.shape[:-1], xs.shape[-1]
    toks = xs.reshape(-1, d)
    r = _route(toks, params["wg"], k, capacity_factor)
    y = local_experts_ffn(params, toks, r, mesh, axis, activation)
    y = y.reshape(*lead, d).to(x.dtype)
    blk = x.shape[0]
    y = y.narrow(0, dp.index * blk, blk)
    if sp.size > 1:
        y = y.narrow(1, sp.index * x.shape[1], x.shape[1])
    return y, r.aux
