"""BERT (port of paddle_tpu/models/bert.py: `BertConfig`,
`bert_base_config`, `bert_tiny_config`, `BertEmbeddings`, `BertModel`,
`BertForPretraining` with its MLM + NSP `loss`).

Parameter names are the reference's.  The MLM head ties its vocab
projection to the word-embedding table (one parameter, both uses'
gradients summed by autograd).  The attention mask is additive, -1e9 in
the activations' dtype.

On the card every LayerNorm runs K4 (forward) and K5 (backward) with the
layer's epsilon (1e-12 for the embeddings and the MLM transform, 1e-5 in
the encoder layers, as the reference's).  Attention runs K1-K3 only
inside the flash envelope: no mask and no training dropout.  A padding
mask, or the default `attention_probs_dropout_prob` in training, takes
the eager attention (`kernels/attention.py`), as the reference takes its
XLA composition on the TPU.
"""

import dataclasses

import torch

from .. import nn
from ..nn import functional as F


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"


def bert_base_config(**kw):
    return BertConfig(**kw)


def bert_tiny_config(**kw):
    base = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                max_position_embeddings=128)
    base.update(kw)
    return BertConfig(**base)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg, **kw):
        super().__init__(dtype=cfg.dtype, **kw)
        self.cfg = cfg
        sub = self.sub_kwargs()
        self.word_embeddings = nn.Embedding(
            [cfg.vocab_size, cfg.hidden_size], **sub)
        self.position_embeddings = nn.Embedding(
            [cfg.max_position_embeddings, cfg.hidden_size], **sub)
        self.token_type_embeddings = nn.Embedding(
            [cfg.type_vocab_size, cfg.hidden_size], **sub)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps, **sub)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob, **sub)

    def forward(self, input_ids, token_type_ids=None):
        seq = input_ids.shape[1]
        if seq > self.cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {seq} exceeds max_position_embeddings "
                f"{self.cfg.max_position_embeddings}")
        pos = torch.arange(seq, dtype=torch.int32,
                           device=input_ids.device)[None, :]
        emb = self.word_embeddings(input_ids)
        emb = emb + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(emb))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig, **kw):
        super().__init__(dtype=cfg.dtype, **kw)
        self.cfg = cfg
        sub = self.sub_kwargs()
        self.embeddings = BertEmbeddings(cfg, device=self._device,
                                         generator=self._generator)
        self.encoder = nn.TransformerEncoder(
            lambda: nn.TransformerEncoderLayer(
                cfg.hidden_size, cfg.num_attention_heads,
                cfg.intermediate_size, dropout=cfg.hidden_dropout_prob,
                activation="gelu", **sub),
            cfg.num_hidden_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                act="tanh", **sub)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            # [B, S] 1/0 -> additive [B, 1, 1, S]
            mask = (1.0 - attention_mask[:, None, None, :].to(x.dtype))
            mask = mask * -1e9
        x = self.encoder(x, mask)
        pooled = self.pooler(x[:, 0])
        return x, pooled


class BertForPretraining(nn.Layer):
    """MLM + NSP heads; `loss` is their sum.  `BertForPretraining(cfg,
    device=None, generator=None)`: device defaults to `cuda`."""

    def __init__(self, cfg: BertConfig, device=None, generator=None):
        super().__init__(dtype=cfg.dtype, device=device, generator=generator)
        sub = self.sub_kwargs()
        self.bert = BertModel(cfg, device=self._device,
                              generator=self._generator)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                   act="gelu", **sub)
        self.transform_norm = nn.LayerNorm(cfg.hidden_size,
                                           epsilon=cfg.layer_norm_eps, **sub)
        self.mlm_bias = self.create_parameter([cfg.vocab_size], is_bias=True)
        self.nsp = nn.Linear(cfg.hidden_size, 2, **sub)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None):
        seq_out, pooled = self.bert(input_ids, token_type_ids,
                                    attention_mask)
        if masked_positions is not None:
            # the hidden states at the masked positions [B, M], so the
            # vocab projection runs on M << S tokens
            idx = masked_positions.to(torch.int64)[..., None].expand(
                -1, -1, seq_out.shape[-1])
            seq_out = torch.gather(seq_out, 1, idx)
        h = self.transform_norm(self.transform(seq_out))
        # weight tying with the word embedding table (standard BERT)
        emb = self.bert.embeddings.word_embeddings.weight
        logits = torch.einsum("bsh,vh->bsv", h, emb) + self.mlm_bias
        nsp_logits = self.nsp(pooled)
        return logits, nsp_logits

    def loss(self, input_ids, mlm_labels, nsp_labels, token_type_ids=None,
             attention_mask=None, ignore_index=-100):
        logits, nsp_logits = self.forward(input_ids, token_type_ids,
                                          attention_mask)
        logp = F.log_softmax(logits.float(), axis=-1)
        valid = mlm_labels != ignore_index
        safe = torch.where(valid, mlm_labels, torch.zeros_like(mlm_labels))
        tok_loss = -torch.gather(logp, -1, safe.to(torch.int64)[..., None]
                                 )[..., 0]
        denom = torch.clamp(valid.sum(), min=1)
        mlm_loss = torch.where(valid, tok_loss,
                               torch.zeros_like(tok_loss)).sum() / denom
        nsp_logp = F.log_softmax(nsp_logits.float(), axis=-1)
        nsp_loss = -torch.gather(nsp_logp, -1,
                                 nsp_labels.to(torch.int64)[:, None]).mean()
        return mlm_loss + nsp_loss
