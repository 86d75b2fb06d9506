"""paddle.dataset.uci_housing parity — samples: (13-float32 features,
float32 price). The surrogate is a fixed linear model + noise, so
fit-a-line converges exactly like the book test expects."""

import numpy as np

from ._synth import rng_for

TRAIN_N, TEST_N = 404, 102
_W = rng_for("uci_housing", "w").standard_normal((13, 1)).astype(
    np.float32)


def _make(split, n):
    rs = rng_for("uci_housing", split)

    def reader():
        for _ in range(n):
            x = rs.standard_normal(13).astype(np.float32)
            y = float(x @ _W[:, 0] + 0.1 * rs.standard_normal())
            yield x, np.array([y], np.float32)

    return reader


def train():
    return _make("train", TRAIN_N)


def test():
    return _make("test", TEST_N)
