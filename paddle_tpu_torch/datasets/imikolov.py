"""paddle.dataset.imikolov parity — PTB language-model n-grams:
build_dict() -> {word: id}; train/test(word_idx, n) yield n-tuples of
ids (NGRAM) or (src, trg) shifted sequences (SEQ), reference
imikolov.py:54,114,134.  The surrogate text is a Markov chain over the
vocab, so an n-gram model beats uniform."""

import numpy as np

from ._synth import rng_for

VOCAB = 2074            # reference min_word_freq=50 vocab is ~2k
TRAIN_N, TEST_N = 2048, 512


class DataType:
    NGRAM = 1
    SEQ = 2


def build_dict(min_word_freq=50):
    d = {f"w{i}": i for i in range(VOCAB - 2)}
    d["<s>"] = VOCAB - 2
    d["<e>"] = VOCAB - 1
    return d


def _chain(rs, length):
    # deterministic per-dataset transition offsets: w -> (a*w+b) % V
    w = int(rs.integers(0, VOCAB))
    seq = [w]
    for _ in range(length - 1):
        w = (3 * w + int(rs.integers(0, 7))) % VOCAB
        seq.append(w)
    return seq


def _make(split, n_samples, n, data_type):
    rs = rng_for("imikolov", split)

    def reader():
        for _ in range(n_samples):
            if data_type == DataType.NGRAM:
                seq = _chain(rs, n)
                yield tuple(seq)
            else:
                seq = _chain(rs, int(rs.integers(4, 20)))
                yield seq[:-1], seq[1:]

    return reader


def train(word_idx=None, n=5, data_type=DataType.NGRAM):
    return _make("train", TRAIN_N, n, data_type)


def test(word_idx=None, n=5, data_type=DataType.NGRAM):
    return _make("test", TEST_N, n, data_type)
