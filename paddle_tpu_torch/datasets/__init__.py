"""Stock dataset zoo — the `paddle.dataset.*` reader API surface.

Parity: python/paddle/dataset/ (mnist.py, cifar.py,
uci_housing.py, imdb.py, movielens.py, conll05.py, wmt14.py ...): each
dataset exposes reader *creators* — zero-arg callables returning a
generator of samples — that compose with paddle_tpu_torch.reader decorators
(shuffle/batch/map_readers).

Design note (documented deviation): the reference downloads real corpora
at import time; this environment is offline by design, so every dataset
here synthesizes a deterministic, learnable surrogate with the exact
sample STRUCTURE of the original (shapes, dtypes, vocab semantics,
label ranges). Model code written against the reference API runs
unchanged; numbers differ. Seeds are fixed so runs are reproducible.
"""

from . import (cifar, common, conll05, flowers, image, imdb, imikolov,
               mnist, movielens, mq2007, sentiment, uci_housing, voc2012,
               wmt14, wmt16)

__all__ = [
    "mnist", "cifar", "uci_housing", "imdb", "movielens", "conll05",
    "wmt14", "wmt16", "imikolov", "sentiment", "flowers", "voc2012",
    "mq2007", "common", "image",
]
