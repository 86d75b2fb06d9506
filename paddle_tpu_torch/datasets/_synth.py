"""Shared synthetic-data machinery for the offline dataset zoo."""

import zlib

import numpy as np


def rng_for(name, split):
    # Stable per-dataset/per-split seed. Must be process-independent
    # (builtin hash() is PYTHONHASHSEED-salted), so that train/eval in
    # separate processes see the same samples.
    return np.random.default_rng(zlib.crc32(f"{name}/{split}".encode()))


def class_prototype_images(name, split, n, shape, num_classes,
                           noise=0.25):
    """Images drawn as class prototype + noise: learnable by a small
    convnet, structured like the real corpus (shape/dtype/labels)."""
    r = rng_for(name, "protos")
    protos = r.standard_normal((num_classes,) + shape).astype(np.float32)
    rs = rng_for(name, split)

    def reader():
        for _ in range(n):
            y = int(rs.integers(0, num_classes))
            x = protos[y] + noise * rs.standard_normal(shape)
            yield x.astype(np.float32), y

    return reader
