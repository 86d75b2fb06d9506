"""Attention seq2seq with greedy and beam decode (port of
paddle_tpu/models/seq2seq.py: `Seq2SeqConfig`, `Encoder`,
`AttentionDecoderCell`, `Seq2Seq` with `loss`, `greedy_decode`,
`beam_search_decode`).

Python loops over time take the place of the reference's `lax.scan`;
the math is the reference's: an LSTM encoder (state frozen past each
source length), an LSTM decoder cell with Luong dot attention over the
encoder outputs (padding masked to -1e9), and a fixed-width beam of
[B * beam] rows that expands beam * vocab candidates per step, keeps
the top beam (ties to the lower index, as `jax.lax.top_k`), gathers the
parent states and backtracks the parent pointers at the end.
"""

import dataclasses

import torch

from .. import nn
from ..nn import functional as F
from .generate import _top_k_lower_first

NEG_INF = -1e9


@dataclasses.dataclass
class Seq2SeqConfig:
    src_vocab: int = 1000
    tgt_vocab: int = 1000
    hidden_size: int = 128
    embed_dim: int = 64
    bos_id: int = 0
    eos_id: int = 1
    dtype: str = "float32"


class Encoder(nn.Layer):
    def __init__(self, cfg, **kw):
        super().__init__(dtype=cfg.dtype, **kw)
        sub = self.sub_kwargs()
        self.embed = nn.Embedding([cfg.src_vocab, cfg.embed_dim], **sub)
        self.rnn = nn.RNN(nn.LSTMCell(cfg.embed_dim, cfg.hidden_size, **sub))

    def forward(self, src_ids, src_len=None):
        x = self.embed(src_ids)                       # [B, T, E]
        outs, (h, c) = self.rnn(x, length=src_len)
        return outs, (h, c)


class AttentionDecoderCell(nn.Layer):
    """LSTM cell + Luong dot attention over the encoder outputs."""

    def __init__(self, cfg, **kw):
        super().__init__(dtype=cfg.dtype, **kw)
        sub = self.sub_kwargs()
        self.cell = nn.LSTMCell(cfg.embed_dim + cfg.hidden_size,
                                cfg.hidden_size, **sub)
        self.attn_out = nn.Linear(2 * cfg.hidden_size, cfg.hidden_size,
                                  act="tanh", **sub)

    def forward(self, x_t, state, enc_outs, enc_mask):
        h, c = state
        out, (h, c) = self.cell(torch.cat([x_t, h], dim=-1), (h, c))
        scores = torch.einsum("bh,bth->bt", out, enc_outs)
        scores = torch.where(enc_mask > 0, scores,
                             torch.full((), NEG_INF, dtype=scores.dtype,
                                        device=scores.device))
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bt,bth->bh", probs, enc_outs)
        attn_h = self.attn_out(torch.cat([ctx, out], dim=-1))
        return attn_h, (h, c)


class Seq2Seq(nn.Layer):
    """`Seq2Seq(cfg, device=None, generator=None)`: device defaults to
    `cuda`."""

    def __init__(self, cfg: Seq2SeqConfig, device=None, generator=None):
        super().__init__(dtype=cfg.dtype, device=device, generator=generator)
        self.cfg = cfg
        sub = self.sub_kwargs()
        self.encoder = Encoder(cfg, device=self._device,
                               generator=self._generator)
        self.tgt_embed = nn.Embedding([cfg.tgt_vocab, cfg.embed_dim], **sub)
        self.dec_cell = AttentionDecoderCell(cfg, device=self._device,
                                             generator=self._generator)
        self.out_proj = nn.Linear(cfg.hidden_size, cfg.tgt_vocab, **sub)

    def _enc_mask(self, src_ids, src_len):
        t = src_ids.shape[1]
        if src_len is None:
            return torch.ones(src_ids.shape[:2], dtype=torch.float32,
                              device=src_ids.device)
        return (torch.arange(t, device=src_ids.device)[None, :]
                < src_len[:, None]).float()

    def forward(self, src_ids, tgt_in, src_len=None):
        """Teacher-forced logits [B, T_tgt, V]."""
        enc_outs, state = self.encoder(src_ids, src_len)
        mask = self._enc_mask(src_ids, src_len)
        x = self.tgt_embed(tgt_in)                    # [B, T, E]
        hs = []
        for t in range(x.shape[1]):
            attn_h, state = self.dec_cell(x[:, t], state, enc_outs, mask)
            hs.append(attn_h)
        return self.out_proj(torch.stack(hs, dim=1))  # [B, T, V]

    def loss(self, src_ids, tgt_in, tgt_out, src_len=None, tgt_len=None):
        logits = self.forward(src_ids, tgt_in, src_len)
        logp = F.log_softmax(logits.float(), axis=-1)
        nll = -torch.gather(logp, -1, tgt_out.to(torch.int64)[..., None]
                            )[..., 0]                 # [B, T]
        if tgt_len is not None:
            m = (torch.arange(nll.shape[1], device=nll.device)[None, :]
                 < tgt_len[:, None]).to(nll.dtype)
            return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
        return nll.mean()

    # -- decoding ----------------------------------------------------------

    @torch.no_grad()
    def greedy_decode(self, src_ids, max_len, src_len=None):
        """[B, max_len] int32 token ids, argmax decoding."""
        cfg = self.cfg
        enc_outs, state = self.encoder(src_ids, src_len)
        mask = self._enc_mask(src_ids, src_len)
        b = src_ids.shape[0]
        tok = torch.full((b,), cfg.bos_id, dtype=torch.int32,
                         device=src_ids.device)
        done = torch.zeros((b,), dtype=torch.bool, device=src_ids.device)
        toks = []
        for _ in range(max_len):
            attn_h, state = self.dec_cell(self.tgt_embed(tok), state,
                                          enc_outs, mask)
            nxt = torch.argmax(self.out_proj(attn_h), dim=-1).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, cfg.eos_id), nxt)
            done = done | (nxt == cfg.eos_id)
            tok = nxt
            toks.append(nxt)
        return torch.stack(toks, dim=1)

    @torch.no_grad()
    def beam_search_decode(self, src_ids, max_len, beam_size=4,
                           src_len=None, length_penalty=0.0):
        """Fixed-width beam search: (tokens [B, beam, max_len], scores [B,
        beam]) sorted best-first; finished beams are locked to EOS with
        their score frozen."""
        cfg = self.cfg
        b, k = src_ids.shape[0], beam_size
        dev = src_ids.device
        enc_outs, (h, c) = self.encoder(src_ids, src_len)
        mask = self._enc_mask(src_ids, src_len)

        def tile(x):
            return torch.repeat_interleave(x, k, dim=0)

        enc_outs_t, mask_t = tile(enc_outs), tile(mask)
        state = (tile(h), tile(c))
        tok = torch.full((b * k,), cfg.bos_id, dtype=torch.int32, device=dev)
        # only beam 0 is live at first, so the first top-k draws k
        # distinct continuations of it
        scores = torch.tensor([0.0] + [NEG_INF] * (k - 1),
                              device=dev).repeat(b)            # [B*k]
        done = torch.zeros((b * k,), dtype=torch.bool, device=dev)
        toks, parents = [], []
        for _ in range(max_len):
            attn_h, new_state = self.dec_cell(self.tgt_embed(tok), state,
                                              enc_outs_t, mask_t)
            logp = torch.log_softmax(self.out_proj(attn_h).float(), dim=-1)
            v = logp.shape[-1]
            # finished beams: only the EOS continuation, at zero cost
            eos_only = torch.full((v,), NEG_INF, device=dev)
            eos_only[cfg.eos_id] = 0.0
            logp = torch.where(done[:, None], eos_only[None, :], logp)
            cand = (scores[:, None] + logp).reshape(b, k * v)
            top_scores, top_idx = _top_k_lower_first(cand, k)  # [B, k]
            parent = top_idx // v
            token = (top_idx % v).to(torch.int32)
            flat_parent = (torch.arange(b, device=dev)[:, None] * k
                           + parent).reshape(-1)
            state = tuple(s[flat_parent] for s in new_state)
            tok = token.reshape(-1)
            scores = top_scores.reshape(-1)
            done = done[flat_parent] | (tok == cfg.eos_id)
            toks.append(tok)
            parents.append(flat_parent)

        # backtrack the parent pointers: sequences [B*k, max_len]
        beam_idx = torch.arange(b * k, device=dev)
        rev = []
        for t in range(max_len - 1, -1, -1):
            rev.append(toks[t][beam_idx])
            beam_idx = parents[t][beam_idx]
        seqs = torch.stack(rev[::-1], dim=1).reshape(b, k, max_len)
        scores = scores.reshape(b, k)
        if length_penalty:
            lens = (seqs != cfg.eos_id).sum(dim=-1).float()
            scores = scores / ((5.0 + lens) / 6.0) ** length_penalty
        order = torch.argsort(-scores, dim=-1, stable=True)
        seqs = torch.gather(seqs, 1, order[:, :, None].expand_as(seqs))
        return seqs, torch.gather(scores, 1, order)
