"""paddle.dataset.imdb parity — word_dict() -> {word: id}; train/test
readers yield (list[int] token ids, 0/1 label). The surrogate plants the
label signal in sentiment marker tokens, so an embedding+pool classifier
learns it."""

import numpy as np

from ._synth import rng_for

VOCAB = 5148            # reference's cutoff-150 vocab is ~5k
TRAIN_N, TEST_N = 1024, 256
_POS, _NEG = 10, 11     # marker token ids


def word_dict():
    return {f"w{i}": i for i in range(VOCAB)}


def _make(split, n):
    rs = rng_for("imdb", split)

    def reader():
        for _ in range(n):
            length = int(rs.integers(8, 64))
            words = rs.integers(12, VOCAB, length)
            label = int(rs.integers(0, 2))
            marker = _POS if label else _NEG
            k = max(1, length // 8)
            pos = rs.choice(length, size=k, replace=False)
            words[pos] = marker
            yield [int(w) for w in words], label

    return reader


def train(word_idx=None):
    return _make("train", TRAIN_N)


def test(word_idx=None):
    return _make("test", TEST_N)
