"""Word2Vec, CBOW (port of paddle_tpu/models/word2vec.py): N-gram
context embeddings concatenated into an MLP softmax."""

from .. import nn
from ..nn import functional as F


class Word2Vec(nn.Layer):
    def __init__(self, vocab_size, embed_dim=32, context=4, hidden=256,
                 dtype="float32", **kw):
        super().__init__(dtype=dtype, **kw)
        sub = self.sub_kwargs()
        self.embedding = nn.Embedding([vocab_size, embed_dim], **sub)
        self.fc1 = nn.Linear(context * embed_dim, hidden, act="sigmoid",
                             **sub)
        self.fc2 = nn.Linear(hidden, vocab_size, **sub)

    def forward(self, context_ids):
        # context_ids: [B, C]
        emb = self.embedding(context_ids)
        flat = emb.reshape(emb.shape[0], -1)
        return self.fc2(self.fc1(flat))

    def loss(self, context_ids, target_ids):
        return F.cross_entropy(self.forward(context_ids), target_ids)
