"""Data pipeline (port of paddle_tpu/reader/__init__.py).

Parity targets:
- DataLoader.from_generator (the reference's reader.py:179)
- the reader decorators (python/paddle/reader/decorator.py: batch,
  shuffle, map, ...), with the same orders for the same seeds (`shuffle`
  is Python's `random`, as there)
- the C++ double-buffered device feed (operators/reader/buffered_reader.cc)
  becomes `device_prefetch`: each batch's host-to-device copy is issued
  on a side CUDA stream from pinned host memory, `size` batches ahead of
  the consumer, so the copy of batch N+1 runs while step N computes.

The reference's `reader.prefetch_depth` gauge and goodput `data_wait`
span come with `monitor` (ROADMAP item 10).
"""

import itertools
import queue
import random as _random
import threading

import numpy as np
import torch

from ..core.place import resolve_device
from ..interop import from_numpy_exact

__all__ = ["DataLoader", "PyReader", "batch", "shuffle", "buffered", "map_readers",
           "chain", "compose", "firstn", "cache", "device_prefetch"]


# ---------------------------------------------------------------------------
# reader decorators (python/paddle/reader/decorator.py parity)
# ---------------------------------------------------------------------------

def batch(reader, batch_size, drop_last=False):
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def shuffle(reader, buf_size, seed=None):
    def shuffled():
        rng = _random.Random(seed)
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf

    return shuffled


def buffered(reader, size):
    """Background-thread prefetch (decorator.py buffered): a worker thread
    fills a queue of at most `size` items ahead of the consumer."""

    class _End:
        pass

    def buffered_reader():
        q = queue.Queue(maxsize=size)

        def worker():
            try:
                for item in reader():
                    q.put(item)
            finally:
                q.put(_End)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _End:
                break
            yield item

    return buffered_reader


def map_readers(func, *readers):
    def reader():
        its = [r() for r in readers]
        for items in zip(*its):
            yield func(*items)

    return reader


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()

    return reader


def compose(*readers):
    def reader():
        for items in zip(*[r() for r in readers]):
            out = []
            for it in items:
                if isinstance(it, tuple):
                    out.extend(it)
                else:
                    out.append(it)
            yield tuple(out)

    return reader


def firstn(reader, n):
    def reader_n():
        yield from itertools.islice(reader(), n)

    return reader_n


def cache(reader):
    all_items = []
    filled = [False]

    def cached():
        if not filled[0]:
            for item in reader():
                all_items.append(item)
                yield item
            filled[0] = True
        else:
            yield from all_items

    return cached


def _transferable(leaf):
    """Array leaves go to the device; names and metadata pass through."""
    return isinstance(leaf, (np.ndarray, np.generic, torch.Tensor))


def _tree_map(fn, item):
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        vals = [_tree_map(fn, v) for v in item]
        return vals if isinstance(item, list) else tuple(vals)
    return fn(item)


def _tree_leaves(item):
    if isinstance(item, dict):
        return [x for v in item.values() for x in _tree_leaves(v)]
    if isinstance(item, (list, tuple)):
        return [x for v in item for x in _tree_leaves(v)]
    return [item]


def _host_tensor(leaf, pin):
    """A host array leaf as a CPU tensor the caller owns alone: pinned (one
    copy into page-locked memory) when `pin`, else a plain copy."""
    if isinstance(leaf, torch.Tensor):
        src, copied = leaf.detach(), False
    else:
        a = np.asarray(leaf)
        if a.dtype.kind == "V" or not a.flags.writeable \
                or not a.flags.c_contiguous:
            src, copied = from_numpy_exact(a), True
        else:
            src, copied = torch.from_numpy(a), False
    if pin:
        out = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        return out.copy_(src)
    return src if copied else src.clone()


def device_prefetch(batches, size=2, device=None):
    """Double-buffered host->device prefetch (buffered_reader.cc's role).

    Keeps `size` batches' copies in flight ahead of the consumer.  On a
    CUDA device each array leaf is staged in pinned host memory and copied
    with `.to(device, non_blocking=True)` on a side stream; the batch
    carries an event recorded after its copies, and when the batch is
    handed out the consumer's current stream waits on that event and each
    tensor is `record_stream`-ed on it, so the caching allocator cannot
    hand its memory to another tensor before the consumer's work on it is
    done.  Batch N+1's copy is issued before batch N is yielded, so it
    runs while the consumer's step N computes.

    Each array leaf of every yielded batch is a fresh tensor the consumer
    owns alone: a leaf already on the device is copied too, and the
    iterator keeps no reference once a batch is handed out.  Non-array
    leaves (names, metadata) pass through.  Order is the source order:
    nothing is dropped, duplicated or reordered.

    batches: iterable of nests (dicts, lists, tuples) of numpy arrays or
    tensors.  device: a Place, device string or torch.device; None means
    `cuda`, and raises on a host without one."""
    import collections

    if size < 1:
        raise ValueError(f"device_prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None

    def put_leaf(leaf):
        if not _transferable(leaf):
            return leaf
        if isinstance(leaf, torch.Tensor) and leaf.device == dev:
            return leaf.clone()
        if not cuda:
            return _host_tensor(leaf, False).to(dev)
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.to(dev, non_blocking=True)
        return _host_tensor(leaf, True).to(dev, non_blocking=True)

    def put(item):
        if not cuda:
            return _tree_map(put_leaf, item), None
        # the side stream starts after the consumer's work so far, so a
        # device leaf is copied once its producer is done
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = _tree_map(put_leaf, item)
            ev = torch.cuda.Event()
            ev.record(side)
        return out, ev

    def hand_out(staged):
        out, ev = staged
        if ev is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ev)
            for leaf in _tree_leaves(out):
                if isinstance(leaf, torch.Tensor):
                    leaf.record_stream(consumer)
        return out

    it = iter(batches)
    pending = collections.deque()

    def fill(n):
        for item in itertools.islice(it, n):
            pending.append(put(item))

    fill(size)
    while pending:
        staged = pending.popleft()
        # issue batch N+1's copy before handing batch N to the consumer:
        # the copy overlaps the consumer's step
        fill(1)
        yield hand_out(staged)
        del staged


# ---------------------------------------------------------------------------
# DataLoader
# ---------------------------------------------------------------------------

def _stack_samples(samples, feed_names):
    """list of tuples -> dict of batched numpy arrays."""
    cols = list(zip(*samples))
    out = {}
    for name, col in zip(feed_names, cols):
        out[name] = np.stack([np.asarray(c) for c in col])
    return out


class DataLoader:
    """Feeds dict batches to Executor.run (reader.py:179 parity).

    Iterating yields dicts name->np.ndarray ready to pass as `feed`
    (host batches; `device_prefetch` moves them to the card ahead of the
    step).
    """

    def __init__(self, feed_list=None, capacity=4, iterable=True,
                 use_multiprocess=False, num_workers=2):
        self._feed_names = [
            v.name if hasattr(v, "name") else v for v in (feed_list or [])
        ]
        self._capacity = capacity
        self._batch_reader = None
        self._use_multiprocess = use_multiprocess
        self._num_workers = num_workers

    @staticmethod
    def from_generator(feed_list=None, capacity=4, iterable=True,
                       return_list=False, use_double_buffer=True,
                       use_multiprocess=False, num_workers=2):
        """use_multiprocess=True engages worker processes + shared-memory
        transport (reader.py:469 DygraphGeneratorLoader parity) instead
        of the background thread — the GIL-free path for CPU-bound
        python readers."""
        return DataLoader(feed_list, capacity, iterable,
                          use_multiprocess=use_multiprocess,
                          num_workers=num_workers)

    def set_batch_generator(self, reader, places=None):
        self._batch_reader = reader
        return self

    def set_sample_list_generator(self, reader, places=None):
        def batched():
            for samples in reader():
                yield _stack_samples(samples, self._feed_names)

        self._batch_reader = batched
        return self

    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        return self.set_sample_list_generator(
            batch(reader, batch_size, drop_last=drop_last), places)

    def __iter__(self):
        if self._batch_reader is None:
            raise RuntimeError("no generator set on DataLoader")
        if self._use_multiprocess:
            from .shm import ShmBatchLoader

            def sharded(worker_id, num_workers):
                return self._gen_feed_dicts(worker_id, num_workers)

            return iter(ShmBatchLoader(sharded,
                                       num_workers=self._num_workers,
                                       capacity=self._capacity))
        prefetched = buffered(self._gen_feed_dicts, self._capacity)
        return iter(prefetched())

    def _gen_feed_dicts(self, worker_id=None, num_workers=None):
        import itertools

        reader = self._batch_reader
        if worker_id is None:
            items = reader()
        else:
            # multiprocess path: pass the shard through when the user's
            # reader is shard-aware, else round-robin islice (order
            # preserved; see ShmBatchLoader doc for the cost model)
            from .shm import is_shard_aware

            items = (reader(worker_id, num_workers)
                     if is_shard_aware(reader)
                     else itertools.islice(reader(), worker_id, None,
                                           num_workers))
        for item in items:
            if isinstance(item, dict):
                yield item
            elif isinstance(item, (list, tuple)) and self._feed_names:
                yield {n: np.asarray(v)
                       for n, v in zip(self._feed_names, item)}
            else:
                yield item


class DataFeeder:
    """Parity: fluid.DataFeeder (data_feeder.py) — converts sample lists
    to feed dicts."""

    def __init__(self, feed_list, place=None):
        self._feed_names = [v.name if hasattr(v, "name") else v
                            for v in feed_list]

    def feed(self, samples):
        return _stack_samples(samples, self._feed_names)


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel-map a reader with a thread pool (parity:
    python/paddle/reader/decorator.py:364 xmap_readers — the reference
    uses threads too). order=True preserves sample order."""
    import queue as _q
    import threading as _t

    def xreader():
        in_q = _q.Queue(buffer_size)
        out_q = _q.Queue(buffer_size)
        END = object()

        errors = []

        def feeder():
            try:
                for i, sample in enumerate(reader()):
                    in_q.put((i, sample))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
            finally:
                # guarantee every worker sees an END even if the source
                # reader raised (missing sentinels deadlock the consumer)
                for _ in range(process_num):
                    in_q.put(END)

        def worker():
            try:
                while True:
                    item = in_q.get()
                    if item is END:
                        return
                    i, sample = item
                    out_q.put((i, mapper(sample)))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
            finally:
                out_q.put(END)

        threads = [_t.Thread(target=feeder, daemon=True)]
        threads += [_t.Thread(target=worker, daemon=True)
                    for _ in range(process_num)]
        for t in threads:
            t.start()

        finished = 0
        if order:
            import heapq
            heap, want = [], 0
            while finished < process_num:
                item = out_q.get()
                if item is END:
                    finished += 1
                    continue
                heapq.heappush(heap, item)
                while heap and heap[0][0] == want:
                    yield heapq.heappop(heap)[1]
                    want += 1
            # on error some indices never arrive; drain what's complete
            while heap and not errors:
                yield heapq.heappop(heap)[1]
        else:
            while finished < process_num:
                item = out_q.get()
                if item is END:
                    finished += 1
                    continue
                yield item[1]
        if errors:
            raise errors[0]

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave multiple readers, each drained on its own thread
    (parity: decorator.py:457 — the reference's Paddle forks processes;
    threads give the same overlap without fork hazards once a CUDA
    context exists)."""
    import queue as _q
    import threading as _t

    def mreader():
        out_q = _q.Queue(queue_size)
        END = object()

        errors = []

        def drain(r):
            try:
                for sample in r():
                    out_q.put(sample)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
            finally:
                out_q.put(END)  # guaranteed sentinel, even on error

        threads = [_t.Thread(target=drain, args=(r,), daemon=True)
                   for r in readers]
        for t in threads:
            t.start()
        finished = 0
        while finished < len(readers):
            item = out_q.get()
            if item is END:
                finished += 1
                continue
            yield item
        if errors:
            raise errors[0]

    return mreader


class PyReader(DataLoader):
    """`fluid.io.PyReader` parity (reference reader.py:441): the 1.x
    name for the generator-fed loader.  decorate_* methods map onto the
    DataLoader setters; start()/reset() exist for the non-iterable
    protocol (iteration here is always the iterable protocol, so they
    are no-ops kept for script parity)."""

    def __init__(self, feed_list=None, capacity=4, use_double_buffer=True,
                 iterable=True, return_list=False):
        super().__init__(feed_list=feed_list, capacity=capacity,
                         iterable=iterable)

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        return self.set_sample_generator(sample_generator, batch_size,
                                         drop_last=drop_last, places=places)

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places=places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places=places)

    def start(self):
        return None

    def reset(self):
        return None
