"""paddle.dataset.wmt14 parity — translation samples: (src ids, trg ids,
trg_next ids) with <s>/<e>/<unk> convention (reference wmt14.py). The
surrogate task is copy-with-offset, learnable by a small seq2seq."""

from ._synth import rng_for

DICT_SIZE = 30000
START, END, UNK = 0, 1, 2
TRAIN_N, TEST_N = 512, 128


def _make(split, n, dict_size):
    rs = rng_for("wmt14", split)

    def reader():
        for _ in range(n):
            t = int(rs.integers(3, 10))
            src = [int(w) for w in rs.integers(3, dict_size, t)]
            trg = [(w + 1) % dict_size or 3 for w in src]
            yield src, [START] + trg, trg + [END]

    return reader


def train(dict_size=DICT_SIZE):
    return _make("train", TRAIN_N, dict_size)


def test(dict_size=DICT_SIZE):
    return _make("test", TEST_N, dict_size)
