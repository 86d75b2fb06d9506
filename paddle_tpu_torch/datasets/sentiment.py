"""paddle.dataset.sentiment parity — NLTK movie-reviews surface:
get_word_dict() -> {word: id}; train()/test() yield
(list[int] ids, 0/1 label), reference sentiment.py:70,133,141.  Same
marker-token construction as the imdb surrogate."""

from ._synth import rng_for

VOCAB = 39768           # reference movie_reviews vocab size
TRAIN_N, TEST_N = 800, 200
_POS, _NEG = 10, 11


def get_word_dict():
    return {f"w{i}": i for i in range(VOCAB)}


def _make(split, n):
    rs = rng_for("sentiment", split)

    def reader():
        for _ in range(n):
            length = int(rs.integers(8, 48))
            words = rs.integers(12, VOCAB, length)
            label = int(rs.integers(0, 2))
            k = max(1, length // 8)
            pos = rs.choice(length, size=k, replace=False)
            words[pos] = _POS if label else _NEG
            yield [int(w) for w in words], label

    return reader


def train():
    return _make("train", TRAIN_N)


def test():
    return _make("test", TEST_N)
