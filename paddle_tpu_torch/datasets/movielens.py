"""paddle.dataset.movielens parity — samples: ([user_id, gender, age,
job], [movie_id, category, title-token], rating). Structured like the
reference's feature tuple; ratings follow a latent dot-product."""

import numpy as np

from ._synth import rng_for

MAX_USER, MAX_MOVIE = 6040, 3952
TRAIN_N, TEST_N = 2048, 512
_UF = rng_for("movielens", "uf").standard_normal((MAX_USER + 1, 4))
_MF = rng_for("movielens", "mf").standard_normal((MAX_MOVIE + 1, 4))


def max_user_id():
    return MAX_USER


def max_movie_id():
    return MAX_MOVIE


def max_job_id():
    return 20


def _make(split, n):
    rs = rng_for("movielens", split)

    def reader():
        for _ in range(n):
            u = int(rs.integers(1, MAX_USER + 1))
            m = int(rs.integers(1, MAX_MOVIE + 1))
            rating = float(np.clip(
                2.5 + _UF[u] @ _MF[m] * 0.6 + 0.2 * rs.standard_normal(),
                0.5, 5.0))
            yield ([u, int(rs.integers(0, 2)), int(rs.integers(0, 7)),
                    int(rs.integers(0, 21))],
                   [m, int(rs.integers(0, 18)), int(rs.integers(0, 5175))],
                   np.array([rating], np.float32))

    return reader


def train():
    return _make("train", TRAIN_N)


def test():
    return _make("test", TEST_N)
