"""paddle.dataset.wmt16 parity — en<->de translation with BPE-size
dicts: train/test/validation(src_dict_size, trg_dict_size, src_lang)
yield (src ids, trg ids, trg_next ids); get_dict(lang, size, reverse),
reference wmt16.py:147,196,245,292.  Surrogate task is
copy-with-offset like the wmt14 surrogate."""

from ._synth import rng_for

TOTAL_EN_WORDS = 11250
TOTAL_DE_WORDS = 19220
START, END, UNK = 0, 1, 2
TRAIN_N, TEST_N, VALID_N = 512, 128, 128


def _clip(size, lang):
    total = TOTAL_EN_WORDS if lang == "en" else TOTAL_DE_WORDS
    return min(int(size), total) if size > 0 else total


def get_dict(lang, dict_size, reverse=False):
    dict_size = _clip(dict_size, lang)
    words = {"<s>": START, "<e>": END, "<unk>": UNK}
    for i in range(3, dict_size):
        words[f"{lang}{i}"] = i
    return {v: k for k, v in words.items()} if reverse else words


def _make(split, n, src_size, trg_size, src_lang):
    rs = rng_for("wmt16", split)
    src_size = _clip(src_size, src_lang)
    trg_size = _clip(trg_size, "de" if src_lang == "en" else "en")

    def reader():
        for _ in range(n):
            t = int(rs.integers(3, 12))
            src = [int(w) for w in rs.integers(3, src_size, t)]
            # keep START/END/UNK out of sentence bodies whatever the
            # src/trg vocab ratio
            trg = [w2 if (w2 := (w + 1) % trg_size) > UNK else UNK + 1
                   for w in src]
            yield src, [START] + trg, trg + [END]

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    if src_lang not in ("en", "de"):
        raise ValueError("src_lang must be 'en' or 'de'")
    return _make("train", TRAIN_N, src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    if src_lang not in ("en", "de"):
        raise ValueError("src_lang must be 'en' or 'de'")
    return _make("test", TEST_N, src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    if src_lang not in ("en", "de"):
        raise ValueError("src_lang must be 'en' or 'de'")
    return _make("val", VALID_N, src_dict_size, trg_dict_size, src_lang)
