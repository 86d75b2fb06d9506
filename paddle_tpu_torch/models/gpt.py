"""GPT-style causal decoder (port of paddle_tpu/models/gpt.py).

`GPTConfig` keeps the reference's defaults: GPT-2 small geometry
(vocab 50304, hidden 768, 12 layers, 12 heads, max_seq_len 1024).
Parameter names equal the reference's `param_dict` keys.  On the card
attention runs through the flash kernels (K1 forward, K2/K3 backward)
and every LayerNorm through K4 (forward) and K5 (backward).
`num_experts > 0` replaces each block's FFN by a mixture of experts
(`MoEFFN`, `distributed.moe`), whose router aux loss `GPT.loss` adds.
Inside `distributed.tensor_parallel.tensor_parallel(mesh)` the layers
run on this rank's tp shards and sp block (see that module); inside the
sharded step's FSDP context a dp-split table is gathered where it is
used (`distributed.sharded`).
"""

import dataclasses

import torch
import torch.utils.checkpoint

from .. import nn


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    dropout: float = 0.0
    dtype: str = "float32"
    # > 0: stream the CE over vocab chunks of this size (must divide
    # vocab_size) so the full [B, S, V] logits never persist to the
    # backward (`streaming_softmax_ce`); a memory lever, not a speed one
    ce_vocab_chunk: int = 0
    # MoE (0 = dense FFN): experts split over the mesh's "ep" axis under
    # distributed.sharded.gpt_rules; the router aux loss folds into .loss()
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01


class MoEFFN(nn.Layer):
    """Mixture-of-experts FFN: `distributed.moe.moe_ffn` over the layer's
    parameters wg [D, E], w1 [E, D, 4D], w2 [E, 4D, D].  Keeps the aux
    loss of its last forward in `last_aux_loss`.  Inside
    `moe.expert_parallel(mesh)` (the sharded train step) w1/w2 are this
    rank's [E/ep, ...] slices and the layer gates the global batch."""

    def __init__(self, hidden, num_experts, top_k=2, capacity_factor=1.25,
                 **kw):
        super().__init__(**kw)
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.wg = self.create_parameter([hidden, num_experts])
        self.w1 = self.create_parameter([num_experts, hidden, 4 * hidden])
        self.w2 = self.create_parameter([num_experts, 4 * hidden, hidden])
        self.last_aux_loss = 0.0

    def forward(self, x):
        from ..distributed import moe

        params = {"wg": self.wg, "w1": self.w1, "w2": self.w2}
        y, aux = moe.moe_layer(params, x, k=self.top_k,
                               capacity_factor=self.capacity_factor)
        self.last_aux_loss = aux
        return y


class GPTBlock(nn.Layer):
    def __init__(self, cfg, **kw):
        super().__init__(dtype=cfg.dtype, **kw)
        sub = self.sub_kwargs()
        self.norm1 = nn.LayerNorm(cfg.hidden_size, **sub)
        self.attn = nn.MultiHeadAttention(cfg.hidden_size, cfg.num_heads,
                                          dropout=cfg.dropout, **sub)
        self.norm2 = nn.LayerNorm(cfg.hidden_size, **sub)
        self._moe = cfg.num_experts > 0
        if self._moe:
            self.moe = MoEFFN(cfg.hidden_size, cfg.num_experts,
                              top_k=cfg.moe_top_k,
                              capacity_factor=cfg.moe_capacity_factor, **sub)
        else:
            self.fc1 = nn.Linear(cfg.hidden_size, 4 * cfg.hidden_size,
                                 act="gelu", **sub)
            self.fc2 = nn.Linear(4 * cfg.hidden_size, cfg.hidden_size,
                                 **sub)
        self.drop = nn.Dropout(cfg.dropout, **sub)

    def forward(self, x):
        from ..distributed.tensor_parallel import current

        par = current()
        x = x + self.attn(self.norm1(x), is_causal=True)
        h = self.norm2(x)
        if self._moe:
            ff = self.moe(h)
        else:
            ff = par.row_parallel(self.fc2, self.fc1(par.copy_to_tp(h)))
        return x + self.drop(ff)


class GPT(nn.Layer):
    """`GPT(cfg, device=None, generator=None)`: device defaults to
    `cuda`; parameters are drawn from `generator` (seed 0 if None)."""

    def __init__(self, cfg: GPTConfig, device=None, generator=None):
        super().__init__(dtype=cfg.dtype, device=device, generator=generator)
        self.cfg = cfg
        sub = self.sub_kwargs()
        self.wte = nn.Embedding([cfg.vocab_size, cfg.hidden_size], **sub)
        self.wpe = nn.Embedding([cfg.max_seq_len, cfg.hidden_size], **sub)
        self.drop = nn.Dropout(cfg.dropout, **sub)
        self.blocks = nn.LayerList([GPTBlock(cfg, device=self._device,
                                             generator=self._generator)
                                    for _ in range(cfg.num_layers)], **sub)
        self.norm_f = nn.LayerNorm(cfg.hidden_size, **sub)

    def _head_weight(self):
        """The tied head's table: wte, gathered over dp where the
        sharded step's FSDP split it."""
        from ..distributed.sharded import fsdp_full

        return fsdp_full(self.wte.weight)

    def forward(self, input_ids):
        from ..distributed.tensor_parallel import current

        x = self._final_hidden(input_ids)
        w = self._head_weight()
        if w.shape[0] != self.cfg.vocab_size:
            # this rank's vocab rows of the logits, gathered over tp
            par = current()
            logits = torch.einsum("bsh,vh->bsv", par.copy_to_tp(x), w)
            return par.gather_tp(logits, 2)
        return torch.einsum("bsh,vh->bsv", x, w)

    def loss(self, input_ids, labels):
        """Mean token cross-entropy: per-token logsumexp (f32) minus the
        gathered label logit; streamed over vocab chunks when
        `ce_vocab_chunk > 0`.  MoE adds `moe_aux_weight` x the blocks'
        router aux losses of the same forward.  Inside
        `tensor_parallel` with wte split over tp: the vocab-parallel
        cross-entropy (`parallel_cross_entropy`) of this rank's tokens."""
        from ..distributed.tensor_parallel import (
            current, parallel_cross_entropy)

        h = self._final_hidden(input_ids)
        w = self._head_weight()
        if w.shape[0] != self.cfg.vocab_size:
            ce = parallel_cross_entropy(h, w, labels, self.cfg.vocab_size,
                                        current(), self.cfg.ce_vocab_chunk)
        elif self.cfg.ce_vocab_chunk > 0:
            ce = streaming_softmax_ce(h, w, labels, self.cfg.ce_vocab_chunk)
        else:
            logits = torch.einsum("bsh,vh->bsv", h, w)
            lse = torch.logsumexp(logits.float(), dim=-1)
            lab = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
            ce = (lse - lab.float()).mean()
        if self.cfg.num_experts > 0:
            aux = sum(blk.moe.last_aux_loss for blk in self.blocks)
            ce = ce + self.cfg.moe_aux_weight * aux
        return ce

    def _final_hidden(self, input_ids):
        """forward() up to (and including) the final layer norm.  The
        wte and wpe lookups of tables split over tp are summed in one
        reduction over tp."""
        from ..distributed.tensor_parallel import current, parallel_embedding

        par = current()
        seq = input_ids.shape[1]
        start = par.sp_index * seq
        if start + seq > self.cfg.max_seq_len:
            raise ValueError(
                f"sequence length {start + seq} exceeds max_seq_len "
                f"{self.cfg.max_seq_len}")
        pos = torch.arange(start, start + seq, dtype=torch.int32,
                           device=input_ids.device)[None, :]
        e, e_split = parallel_embedding(input_ids, self.wte,
                                        self.cfg.vocab_size, par)
        p, p_split = parallel_embedding(pos, self.wpe, self.cfg.max_seq_len,
                                        par)
        if e_split and p_split:
            x = par.reduce_from_tp(e + p)
        else:
            x = ((par.reduce_from_tp(e) if e_split else e)
                 + (par.reduce_from_tp(p) if p_split else p))
        x = self.drop(x)
        for blk in self.blocks:
            x = blk(x)
        return self.norm_f(x)


def _ce_chunk(hs, wc, lab, base, m, s, zlab, product):
    """One vocab chunk of `streaming_softmax_ce`: the chunk's logits in
    f32, the online logsumexp update, and the label logits that fall in
    the chunk."""
    z = product(hs, wc).float()                           # [N, chunk]
    m_new = torch.maximum(m, z.amax(dim=-1))
    s = s * torch.exp(m - m_new) + torch.exp(z - m_new[:, None]).sum(dim=-1)
    chunk = wc.shape[0]
    in_c = (lab >= base) & (lab < base + chunk)
    zl = torch.gather(z, 1, (lab - base).clamp(0, chunk - 1)[:, None])[:, 0]
    return m_new, s, torch.where(in_c, zl, zlab)


def streaming_softmax_ce(h, wte, labels, chunk):
    """Fused CE streamed over vocab chunks: mean(lse - z_label) where
    z = h @ wte^T, computed chunk by chunk with an online logsumexp so the
    [N, V] logits never exist at once; each chunk runs under
    `torch.utils.checkpoint`, so its logits are recomputed from h and its
    wte rows in the backward instead of being kept (the reference's
    `lax.scan` over a `jax.checkpoint` body).  In bf16 the chunk's logits
    are rounded to bf16 before the f32 reduction (the reference
    accumulates the einsum straight into f32).

    h: [B, S, H] (or [N, H]); wte: [V, H]; labels int [B, S] / [N]."""
    v, hidden = wte.shape
    if v % chunk != 0:
        raise ValueError(f"ce_vocab_chunk {chunk} must divide vocab {v}")
    hs = h.reshape(-1, hidden)
    lab = labels.reshape(-1).to(device=hs.device, dtype=torch.long)
    m, s, zlab = _stream_ce(hs, wte, lab, chunk)
    return (m + torch.log(s) - zlab).mean()


def _chunk_product(hs, wc):
    return torch.matmul(hs, wc.t())


def _stream_ce(hs, wte, lab, chunk, product=_chunk_product):
    """The online (max, sum of exponents, label logit) of hs [N, H]
    against the rows of wte, chunk by chunk (a chunk's logits
    `product(hs, rows)`), each chunk recomputed in the backward; a label
    outside wte's rows gives a label logit of 0."""
    n = hs.shape[0]
    m = torch.full((n,), float("-inf"), dtype=torch.float32, device=hs.device)
    s = torch.zeros((n,), dtype=torch.float32, device=hs.device)
    zlab = torch.zeros((n,), dtype=torch.float32, device=hs.device)
    for base in range(0, wte.shape[0], chunk):
        m, s, zlab = torch.utils.checkpoint.checkpoint(
            _ce_chunk, hs, wte[base:base + chunk], lab, base, m, s, zlab,
            product, use_reentrant=False)
    return m, s, zlab
