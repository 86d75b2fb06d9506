"""Tensor and sequence parallelism for the GPT's layers (the port of what
the reference's `gpt_rules()` makes GSPMD compile, spelled out as
`distributed/pipeline.py` `build_gpt_pipeline_3d` spells it).

Inside `tensor_parallel(mesh)` the GPT (`models/gpt.py`, its attention
`nn.MultiHeadAttention`) runs on this rank's shards:

- tp (Megatron): q, k, v and fc1 are column-parallel (their output dim
  split over tp, so the heads divide over tp), out_proj and fc2
  row-parallel (their input dim split), each followed by a sum over tp
  and the bias added once after it.  The conjugate pair is
  `copy_to_tp` (the identity; its backward sums the cotangent over tp)
  before a column-parallel product and `reduce_from_tp` (a sum over tp;
  its backward the identity) after a row-parallel one: the residual
  stream, the LayerNorms and their grads are whole on every tp rank;
- the embeddings split over tp by rows (`P("tp", None)`): a rank looks
  up the ids in its rows, zeros elsewhere, and the sum over tp gives
  the whole lookup (`parallel_embedding`); the tied head computes its
  vocab shard's logits and the cross-entropy reduces the logsumexp and
  the label logit over tp (`parallel_cross_entropy`);
- sp: this rank's block of the sequence, its positions offset by
  `axis_index("sp") * S/sp`, attention through `ring_attention` over
  sp (K1-K3 blocks on the card).

A table that the axis does not divide stays whole (the reference's
clamp); the layers see it by its shape.  The layers run one path and
read `current()`: outside any context, and on a mesh whose tp and sp
are of size 1, each of its ops is the serial one.
"""

import contextlib
import threading

import torch

from . import collective

__all__ = ["tensor_parallel", "current", "TensorParallel",
           "parallel_embedding", "parallel_cross_entropy"]

_STATE = threading.local()


class TensorParallel:
    """The mesh's `tp` (size, index) and `sp` (size, index) axes that the
    layers read, with the conjugate pair over tp, the row-parallel
    product and the attention over sp.  Without a mesh, and on a mesh
    whose tp and sp are of size 1, every one of them is the serial op."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.tp = mesh.axis_size("tp") if mesh is not None else 1
        self.tp_index = mesh.axis_index("tp") if mesh is not None else 0
        self.sp = mesh.axis_size("sp") if mesh is not None else 1
        self.sp_index = mesh.axis_index("sp") if mesh is not None else 0

    def copy_to_tp(self, x):
        """Before a column-parallel product: x, its grad summed over tp."""
        if self.tp == 1:
            return x
        return collective.sum_grad(x, "tp", self.mesh)

    def reduce_from_tp(self, x):
        """After a row-parallel product: the sum over tp, its grad the
        identity."""
        if self.tp == 1:
            return x
        return collective.reduce_sum(x, "tp", self.mesh)

    def max_over_tp(self, x):
        if self.tp == 1:
            return x
        return collective.all_reduce(x, "tp", "max", self.mesh)

    def gather_tp(self, x, axis):
        """x's shards over tp concatenated along `axis`; every tp rank
        computes the same loss from it, so each keeps its own block of
        the cotangent."""
        if self.tp == 1:
            return x
        return collective.all_gather(x, "tp", axis=axis, mesh=self.mesh,
                                     grad="slice")

    def row_parallel(self, lin, x):
        """`lin(x)` for a Linear whose input dim is split over tp: the
        local product, the sum over tp, then the bias once.  At tp = 1
        the Linear itself (its bias fused into the product)."""
        if self.tp == 1:
            return lin(x)
        from ..nn import functional as F
        from .sharded import fsdp_full

        out = self.reduce_from_tp(F.linear(x, fsdp_full(lin.weight)))
        if lin.bias is not None:
            out = out + fsdp_full(lin.bias).to(out.dtype)
        return out

    def attention(self, q, k, v, attn_mask=None, dropout_p=0.0,
                  is_causal=False, training=True):
        """Attention of this rank's heads [B, h, S, D]: over sp > 1 the
        ring over this rank's sequence block (no mask, no dropout)."""
        from ..nn import functional as F

        if self.sp == 1:
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=dropout_p,
                is_causal=is_causal, training=training)
        if attn_mask is not None or dropout_p:
            raise ValueError("attention over sp > 1 (the ring) takes no "
                             "mask and no dropout")
        from .ring_attention import ring_attention

        return ring_attention(q, k, v, "sp", causal=is_causal,
                              mesh=self.mesh)


_SERIAL = TensorParallel()


@contextlib.contextmanager
def tensor_parallel(mesh):
    """Within it the GPT's layers run tp- and sp-parallel on this rank's
    shards (see the module docstring).  The context is per thread, so
    the ranks of an in-process mesh each enter their own."""
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(TensorParallel(mesh))
    try:
        yield stack[-1]
    finally:
        stack.pop()


def current():
    """The innermost `tensor_parallel` of this thread, else the serial
    one (tp = sp = 1)."""
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else _SERIAL


def parallel_embedding(ids, emb, rows, par):
    """(lookup, sharded): rows `ids` of the embedding `emb`, a table of
    `rows` rows whose shard on this tp rank is `emb.weight` (the layer
    itself when it holds every row).  A shard gives zeros for the ids
    outside its rows; the sum over tp (`reduce_from_tp`) is then the
    whole lookup.  The lookup comes BEFORE that sum, so that the caller
    can sum several lookups in one all-reduce; `sharded` says whether
    it needs one."""
    from ..nn import functional as F

    weight = emb.weight
    if par.tp == 1 or weight.shape[0] == rows:
        return emb(ids), False
    ids = ids.long()
    lo = par.tp_index * weight.shape[0]
    local = ids - lo
    inside = (local >= 0) & (local < weight.shape[0])
    out = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                      weight)
    return out * inside[..., None].to(out.dtype), True


class _HeadProduct(torch.autograd.Function):
    """z = hs @ wte_shard^T in wte's dtype, whose grad with respect to hs
    (f32 here) is returned in f32: the product of the cotangent and the
    shard in their own dtype, accumulated and written in f32.  At random
    init the logits' cotangent is nearly uniform over the vocab, so a
    shard's partial of the hidden state's grad is nearly the same vector
    for every token: rounded to bf16 before the sum over tp, its
    rounding error adds up coherently over the tokens (measured: the
    final LayerNorm's bias grad 3-9x the unsharded step's error against
    f32).  Summing the partials in f32 and rounding once, as the
    unsharded product does, keeps the error of the unsharded step."""

    @staticmethod
    def forward(ctx, hs, w):
        low = hs.to(w.dtype)
        ctx.save_for_backward(low, w)
        return torch.matmul(low, w.t())

    @staticmethod
    def backward(ctx, dz):
        low, w = ctx.saved_tensors
        if dz.is_cuda:
            dh = torch.mm(dz, w, out_dtype=torch.float32)
        else:
            dh = torch.matmul(dz.float(), w.float())
        return dh, torch.matmul(dz.t(), low)


def parallel_cross_entropy(h, wte, labels, vocab, par, chunk=0):
    """Mean token cross-entropy of the tied head over a vocab split on
    tp: h [B, S, H] (whole on every tp rank), wte this rank's [V/tp, H]
    rows.  Each rank's logsumexp over its rows (streamed over chunks of
    `chunk` rows when > 0, as `models.gpt.streaming_softmax_ce`) and its
    label logit (0 where the label is not in its rows) are reduced over
    tp: lse = M + log(sum over tp of exp(lse_r - M)), M the max over tp
    (a constant to the gradient).  The hidden state's grad is summed
    over tp in f32 (`_HeadProduct`)."""
    from ..models.gpt import _stream_ce

    hidden = wte.shape[1]
    lo = par.tp_index * wte.shape[0]
    wide = par.copy_to_tp(h.reshape(-1, hidden).float())
    lab = labels.reshape(-1).to(device=h.device, dtype=torch.long) - lo
    if chunk > 0:
        if wte.shape[0] % chunk:
            raise ValueError(f"ce_vocab_chunk {chunk} must divide the "
                             f"vocab shard {wte.shape[0]} (vocab {vocab} "
                             f"over tp={par.tp})")
        m, s, zlab = _stream_ce(wide, wte, lab, chunk, _HeadProduct.apply)
        lse_r = m + torch.log(s)
    else:
        z = _HeadProduct.apply(wide, wte)
        lse_r = torch.logsumexp(z.float(), dim=-1)
        inside = (lab >= 0) & (lab < wte.shape[0])
        zl = torch.gather(z, 1, lab.clamp(0, wte.shape[0] - 1)[:, None])
        zlab = torch.where(inside, zl[:, 0].float(),
                           torch.zeros_like(lse_r))
    big = par.max_over_tp(lse_r.detach())
    lse = big + torch.log(par.reduce_from_tp(torch.exp(lse_r - big)))
    return (lse - par.reduce_from_tp(zlab)).mean()
