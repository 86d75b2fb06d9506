"""paddle.dataset.voc2012 parity — segmentation pairs: train()/test()/
val() yield (CHW float32 image, HW int32 label map in [0, 21)),
reference voc2012.py:69,76.  Surrogate masks are axis-aligned rectangles
of a random class over background, learnable by a small FCN."""

import numpy as np

from ._synth import rng_for

CLASSES = 21            # 20 object classes + background
SHAPE = (3, 128, 128)
TRAIN_N, TEST_N, VAL_N = 256, 64, 64


def _make(split, n):
    rs = rng_for("voc2012", split)
    c, h, w = SHAPE

    def reader():
        for _ in range(n):
            img = rs.standard_normal(SHAPE).astype(np.float32) * 0.1
            lab = np.zeros((h, w), np.int32)
            cls = int(rs.integers(1, CLASSES))
            y0, x0 = int(rs.integers(0, h // 2)), int(rs.integers(0, w // 2))
            y1, x1 = y0 + int(rs.integers(8, h // 2)), \
                x0 + int(rs.integers(8, w // 2))
            lab[y0:y1, x0:x1] = cls
            img[:, y0:y1, x0:x1] += cls / CLASSES   # signal for the FCN
            yield img, lab

    return reader


def train():
    return _make("train", TRAIN_N)


def test():
    return _make("test", TEST_N)


def val():
    return _make("val", VAL_N)
