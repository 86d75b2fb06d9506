"""paddle.dataset.mnist parity — samples: (784-float32 in [-1,1]-ish,
int label 0..9); reference mnist.py normalizes to (-1, 1) and flattens."""

from ._synth import class_prototype_images

TRAIN_N, TEST_N = 2048, 512


def _flat(creator):
    def reader():
        for img, y in creator():
            yield img.reshape(-1), y
    return reader


def train():
    return _flat(class_prototype_images(
        "mnist", "train", TRAIN_N, (1, 28, 28), 10))


def test():
    return _flat(class_prototype_images(
        "mnist", "test", TEST_N, (1, 28, 28), 10))
