"""paddle.dataset.cifar parity — samples: (3072-float32, int label);
train10/test10 = CIFAR-10, train100/test100 = CIFAR-100."""

from ._synth import class_prototype_images

TRAIN_N, TEST_N = 2048, 512


def _flat(creator):
    def reader():
        for img, y in creator():
            yield img.reshape(-1), y
    return reader


def train10():
    return _flat(class_prototype_images(
        "cifar10", "train", TRAIN_N, (3, 32, 32), 10))


def test10():
    return _flat(class_prototype_images(
        "cifar10", "test", TEST_N, (3, 32, 32), 10))


def train100():
    return _flat(class_prototype_images(
        "cifar100", "train", TRAIN_N, (3, 32, 32), 100))


def test100():
    return _flat(class_prototype_images(
        "cifar100", "test", TEST_N, (3, 32, 32), 100))
