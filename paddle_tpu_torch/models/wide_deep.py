"""Wide&Deep CTR model (port of paddle_tpu/models/wide_deep.py): one
shared hashed embedding table for the sparse fields, an MLP over the
dense features and the embeddings, and a wide (linear) term."""

import torch

from .. import nn
from ..nn import functional as F

_MASK32 = 0xFFFFFFFF
_GOLDEN = 2654435761


def hash_ids(sparse_ids, vocab):
    """The reference's `_hash_ids`: (id * 2654435761 + field *
    0x9E3779B9) % vocab in wrapping uint32 arithmetic.  torch has no
    uint32 multiply on either device, so it is computed in int64 and
    masked to 32 bits after each multiply and add; the id is split into
    16-bit halves so that no int64 product overflows."""
    f = sparse_ids.shape[1]
    ids = sparse_ids.to(torch.int64) & _MASK32
    field = torch.arange(f, dtype=torch.int64, device=ids.device)[None, :]
    lo, hi = ids & 0xFFFF, ids >> 16
    mixed = (lo * _GOLDEN + (((hi * _GOLDEN) & 0xFFFF) << 16)) & _MASK32
    mixed = (mixed + ((field * 0x9E3779B9) & _MASK32)) & _MASK32
    return (mixed % vocab).to(torch.int32)


class WideDeep(nn.Layer):
    def __init__(self, sparse_field_count=26, sparse_vocab_size=100000,
                 embedding_dim=16, dense_dim=13, hidden=(400, 400, 400),
                 dtype="float32", **kw):
        super().__init__(dtype=dtype, **kw)
        sub = self.sub_kwargs()
        self.sparse_field_count = sparse_field_count
        self.embedding = nn.Embedding([sparse_vocab_size, embedding_dim],
                                      **sub)
        self.wide = nn.Embedding([sparse_vocab_size, 1], **sub)
        dims = [dense_dim + sparse_field_count * embedding_dim] + list(hidden)
        self.deep = nn.LayerList([
            nn.Linear(dims[i], dims[i + 1], act="relu", **sub)
            for i in range(len(dims) - 1)
        ], **sub)
        self.out = nn.Linear(dims[-1], 1, **sub)

    def _hash_ids(self, sparse_ids):
        return hash_ids(sparse_ids, self.embedding.weight.shape[0])

    def forward(self, sparse_ids, dense_features):
        # sparse_ids: [B, F] int32, dense_features: [B, D]
        sparse_ids = self._hash_ids(sparse_ids)
        emb = self.embedding(sparse_ids)          # [B, F, E]
        x = torch.cat([dense_features, emb.reshape(emb.shape[0], -1)],
                      dim=-1)
        for fc in self.deep:
            x = fc(x)
        deep_logit = self.out(x)
        wide_logit = self.wide(sparse_ids).sum(dim=1)  # [B, 1]
        return deep_logit + wide_logit

    def loss(self, sparse_ids, dense_features, labels):
        logit = self.forward(sparse_ids, dense_features)[:, 0]
        return F.binary_cross_entropy_with_logits(logit,
                                                  labels.to(logit.dtype))
