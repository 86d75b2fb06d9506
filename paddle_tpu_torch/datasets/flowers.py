"""paddle.dataset.flowers parity — 102-class flower images:
train()/test()/valid() yield (CHW float32 image, label), reference
flowers.py:146,175,204 (whose mappers emit 3x224x224 crops).  Surrogate
images are class prototypes + noise (learnable by a small convnet)."""

from ._synth import class_prototype_images

CLASSES = 102
SHAPE = (3, 224, 224)
TRAIN_N, TEST_N, VALID_N = 512, 128, 128


def _maybe_cycle(reader, cycle):
    if not cycle:
        return reader

    def cycled():
        while True:             # ref flowers.py reader_creator cycle=True
            yield from reader()

    return cycled


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _maybe_cycle(
        class_prototype_images("flowers", "train", TRAIN_N, SHAPE,
                               CLASSES), cycle)


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return _maybe_cycle(
        class_prototype_images("flowers", "test", TEST_N, SHAPE,
                               CLASSES), cycle)


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return class_prototype_images("flowers", "valid", VALID_N, SHAPE,
                                  CLASSES)
