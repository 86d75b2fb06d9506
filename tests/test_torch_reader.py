"""The port's readers against the JAX package's: the decorators, the
DataLoader, the shared-memory loader, the native MultiSlot reader and
parameter-server shard, and `device_prefetch` on the CPU device.

The same seeded numpy samples go through both packages; every batch must
be exactly the reference's (the same values, dtypes and order), the
native shard's pulls bitwise equal after the same pushes.  The timing
gate of the reference's loader tests is not ported.
"""

import os
import time

import numpy as np
import pytest
import torch

from paddle_tpu import native as jnative
from paddle_tpu import reader as jreader
from paddle_tpu.reader.shm import ShmBatchLoader as JShm

import paddle_tpu_torch as fluid
from paddle_tpu_torch import native as tnative
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.reader.shm import ProducerDeadError, ShmBatchLoader
from torch_threads import torch_threads  # noqa: F401


def _samples(n=23, seed=0):
    """A reader of n seeded (float32[3], int64[1]) samples, the same
    values on every call."""
    rng = np.random.default_rng(seed)
    data = [(rng.standard_normal(3).astype(np.float32) + i,
             np.array([i], np.int64)) for i in range(n)]

    def reader():
        yield from data
    return reader


def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), (a, b)


@pytest.mark.parametrize("seed", [0, 5, 7])
def test_shuffle_gives_the_references_order(seed):
    def ints():
        yield from range(50)

    j = list(jreader.shuffle(ints, 8, seed=seed)())
    t = list(treader.shuffle(ints, 8, seed=seed)())
    assert j == t and sorted(t) == list(range(50))


def test_decorators_match_the_reference():
    src = _samples()
    for name, args in (("batch", (5,)), ("batch", (5, True)),
                       ("buffered", (4,)), ("firstn", (7,)),
                       ("cache", ())):
        j = list(getattr(jreader, name)(src, *args)())
        t = list(getattr(treader, name)(src, *args)())
        _same(t, j)
    _same(list(treader.chain(src, src)()), list(jreader.chain(src, src)()))
    _same(list(treader.compose(src, src)()),
          list(jreader.compose(src, src)()))
    double = (lambda a: (a[0] * 2, a[1]))
    _same(list(treader.map_readers(double, src)()),
          list(jreader.map_readers(double, src)()))
    _same(list(treader.xmap_readers(double, src, 3, 4, order=True)()),
          list(jreader.xmap_readers(double, src, 3, 4, order=True)()))
    got = list(treader.multiprocess_reader([src, src])())
    assert sorted(int(x[1][0]) for x in got) == \
        sorted(2 * list(range(23)))


def test_data_loader_batches_are_the_references():
    src = _samples()
    for setter, args in (("set_sample_generator", (src, 4)),
                         ("set_sample_list_generator",
                          (jreader.batch(src, 6),)),
                         ("set_batch_generator",
                          (lambda: ({"x": np.full(2, i, np.float32)}
                                    for i in range(5)),))):
        jl = jreader.DataLoader.from_generator(feed_list=["x", "y"])
        tl = fluid.DataLoader.from_generator(feed_list=["x", "y"])
        getattr(jl, setter)(*args)
        getattr(tl, setter)(*args)
        _same(list(tl), list(jl))
    feeder_j = jreader.DataFeeder(["x", "y"])
    feeder_t = DataFeeder(["x", "y"])
    rows = list(src())[:5]
    _same(feeder_t.feed(rows), feeder_j.feed(rows))


def test_multiprocess_data_loader_is_the_serial_stream():
    src = _samples(n=12)
    tl = fluid.DataLoader.from_generator(feed_list=["x", "y"],
                                         use_multiprocess=True,
                                         num_workers=2)
    tl.set_sample_generator(src, 3)
    jl = jreader.DataLoader.from_generator(feed_list=["x", "y"])
    jl.set_sample_generator(src, 3)
    _same(list(tl), list(jl))


def _batches(n=8):
    def reader():
        for i in range(n):
            yield {"i": np.array([i], np.int64),
                   "x": np.full((2, 3), i, np.float32)}
    return reader


def test_shm_loader_yields_the_references_batches():
    _same(list(ShmBatchLoader(_batches(), num_workers=2)),
          list(JShm(_batches(), num_workers=2)))

    def tuples():
        for i in range(5):
            yield (np.arange(i, i + 3, dtype=np.int32),
                   np.full(2, i, np.float64))
    _same(list(ShmBatchLoader(tuples, num_workers=3)),
          list(JShm(tuples, num_workers=3)))

    def sharded(worker_id, num_workers):
        for i in range(worker_id, 9, num_workers):
            yield {"i": np.array([i])}
    assert [int(b["i"][0]) for b in ShmBatchLoader(sharded, 2)] == \
        list(range(9))


def test_shm_worker_error_and_death_are_reported():
    def bad():
        yield {"i": np.zeros(1)}
        raise ValueError("reader broke")

    with pytest.raises(RuntimeError, match="reader broke"):
        list(ShmBatchLoader(bad, num_workers=1))

    def dies():
        for i in range(8):
            if i == 2:
                time.sleep(0.5)     # the queue's feeder thread flushes
                os._exit(1)         # killed: no sentinel, no cleanup
            yield {"i": np.array([i])}

    got = []
    t0 = time.time()
    with pytest.raises(ProducerDeadError, match="died"):
        for b in ShmBatchLoader(dies, num_workers=1, death_poll_s=0.2):
            got.append(int(b["i"][0]))
    assert got == [0, 1] and time.time() - t0 < 30
    assert isinstance(ProducerDeadError("x"), ConnectionError)


def _write(path, instances):
    with open(path, "w") as f:
        for label, ids, dense in instances:
            parts = [f"1 {label}", str(len(ids))] + [str(i) for i in ids]
            parts += [str(len(dense))] + [f"{d}" for d in dense]
            f.write(" ".join(parts) + "\n")


SLOTS = [("label", "float", 1), ("ids", "int64", 4), ("dense", "float", 2)]


def test_multislot_reader_yields_the_references_batches(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "part-0.txt")
    _write(path, [(float(i % 2), list(rng.integers(0, 99, 1 + i % 4)),
                   list(np.round(rng.standard_normal(2), 4)))
                  for i in range(21)])

    def read(mod):
        r = mod.MultiSlotFileReader([path], SLOTS, batch_size=4,
                                    n_threads=1)
        out = [{k: v.copy() for k, v in b.items()} for b in r]
        r.close()
        return out

    _same(read(tnative), read(jnative))
    text = open(path).read()
    _same(tnative.parse_multislot(text, ["float", "int64", "float"]),
          jnative.parse_multislot(text, ["float", "int64", "float"]))


def test_native_shard_matches_the_references():
    rng = np.random.default_rng(2)
    shards = [mod.NativeShard(8, seed=3, optimizer="adagrad", lr=0.1)
              for mod in (jnative, tnative)]
    ids = rng.integers(0, 1000, 64)
    for _ in range(3):
        pulls = [s.pull(ids) for s in shards]
        assert np.array_equal(*pulls)
        grads = rng.standard_normal((64, 8)).astype(np.float32)
        for s in shards:
            s.push(ids, grads)
    assert len(shards[0]) == len(shards[1])
    _same(shards[1].export_full(), shards[0].export_full())
    assert tnative._so_path().parent.name == "_build"


def test_device_prefetch_keeps_order_depth_and_fresh_buffers():
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield {"x": np.full((2, 2), i, np.float32), "name": f"b{i}",
                   "t": torch.full((3,), float(i))}

    it = treader.device_prefetch(source(), size=2, device="cpu")
    first = next(it)
    assert pulled == [0, 1, 2]      # two ahead, then one more per batch
    rest = list(it)
    out = [first] + rest
    assert [b["name"] for b in out] == [f"b{i}" for i in range(6)]
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor)
        assert torch.equal(b["x"], torch.full((2, 2), float(i)))
        assert torch.equal(b["t"], torch.full((3,), float(i)))
    # every leaf a buffer of its own
    src = np.zeros((2, 2), np.float32)
    t = torch.zeros(3)
    (b,) = treader.device_prefetch([{"x": src, "t": t}], device="cpu")
    b["x"][0, 0] = 5.0
    b["t"][0] = 5.0
    assert src[0, 0] == 0.0 and t[0] == 0.0
    with pytest.raises(ValueError, match="size"):
        next(treader.device_prefetch([], size=0, device="cpu"))


def test_device_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists on this host")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(treader.device_prefetch([{"x": np.zeros(1)}]))
