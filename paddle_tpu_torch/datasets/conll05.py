"""paddle.dataset.conll05 parity — SRL samples: 8 parallel int-id
sequences + a label sequence (reference conll05.py reader tuple). The
surrogate's labels are a learnable function of word and predicate."""

from ._synth import rng_for

WORD_VOCAB, LABEL_N = 44068, 67
TRAIN_N = 512


def get_dict():
    word = {f"w{i}": i for i in range(200)}
    verb = {f"v{i}": i for i in range(50)}
    label = {f"l{i}": i for i in range(LABEL_N)}
    return word, verb, label


def get_embedding():
    return None  # reference downloads emb; offline surrogate has none


def test():
    rs = rng_for("conll05", "test")

    def reader():
        for _ in range(TRAIN_N):
            t = int(rs.integers(4, 16))
            words = [int(w) for w in rs.integers(0, 200, t)]
            pred = int(rs.integers(0, 50))
            ctx = [[int(w) for w in rs.integers(0, 200, t)]
                   for _ in range(5)]
            mark = [int(b) for b in rs.integers(0, 2, t)]
            labels = [(w + pred) % LABEL_N for w in words]
            yield (words, [pred] * t, *ctx, mark, labels)

    return reader
