"""Industrial dataset API over the native MultiSlot reader.

Parity surface: fluid.dataset (python/paddle/fluid/dataset.py:22-793 —
DatasetFactory, QueueDataset streaming, InMemoryDataset with
local_shuffle); the C++ feed underneath is csrc/data_feed.cpp instead of
framework/data_feed.cc, and batches surface as numpy dicts ready for
Executor.run feeds or jitted train steps.
"""

import numpy as np

__all__ = ["QueueDataset", "InMemoryDataset", "BoxPSDataset",
           "DatasetFactory"]


class _DatasetBase:
    def __init__(self):
        self._files = []
        self._slots = []
        self._batch_size = 1
        self._threads = 2

    def set_filelist(self, files):
        self._files = list(files)

    def set_batch_size(self, batch_size):
        self._batch_size = batch_size

    def set_thread(self, n):
        self._threads = n

    def set_use_var(self, slots):
        """slots: list of (name, dtype, max_values) — the MultiSlot schema
        (the reference derives this from use-var Variables; here it is
        explicit)."""
        norm = []
        for s in slots:
            name, dtype, mx = s
            norm.append((name, "float" if "float" in str(dtype) else "int64",
                         int(mx)))
        self._slots = norm


class QueueDataset(_DatasetBase):
    """Streaming dataset: batches flow straight from the native reader
    queue (dataset.py:672 QueueDataset — no global shuffle support,
    matching the reference's restriction)."""

    def __iter__(self):
        from .. import native

        reader = native.MultiSlotFileReader(
            self._files, self._slots, self._batch_size,
            n_threads=self._threads)
        try:
            yield from reader
        finally:
            reader.close()

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset does not support shuffle (dataset.py:756 parity)")

    def global_shuffle(self, fleet=None):
        raise NotImplementedError(
            "QueueDataset does not support shuffle (dataset.py:770 parity)")


class InMemoryDataset(_DatasetBase):
    """Loads all instances into host memory, supports local_shuffle
    (dataset.py:292). Instances are kept as row-dicts; batches re-stack."""

    def __init__(self):
        super().__init__()
        self._instances = None
        self._rng = np.random.default_rng(0)

    def load_into_memory(self):
        from .. import native

        reader = native.MultiSlotFileReader(
            self._files, self._slots, batch_size=4096,
            n_threads=self._threads)
        rows = []
        try:
            for batch in reader:
                n = batch[self._slots[0][0]].shape[0]
                for i in range(n):
                    rows.append({k: v[i] for k, v in batch.items()})
        finally:
            reader.close()
        self._instances = rows

    def local_shuffle(self, seed=None):
        assert self._instances is not None, "call load_into_memory first"
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._rng.shuffle(self._instances)

    def release_memory(self):
        self._instances = None

    def __len__(self):
        return len(self._instances) if self._instances is not None else 0

    def __iter__(self):
        assert self._instances is not None, "call load_into_memory first"
        bs = self._batch_size
        for start in range(0, len(self._instances), bs):
            chunk = self._instances[start:start + bs]
            yield {k: np.stack([r[k] for r in chunk])
                   for k in chunk[0]}


class BoxPSDataset(InMemoryDataset):
    """dataset.py:793 BoxPSDataset surface parity.

    In the reference this extends InMemoryDataset with hooks into the
    BoxPS ads-serving hardware wrapper
    (framework/fleet/box_wrapper.h:123): begin_pass/end_pass bracket a
    pass of data through that external system.  There is no BoxPS
    hardware here, so the DATA surface (load_into_memory, shuffles,
    iteration) is the real InMemoryDataset implementation and the
    pass hooks are explicit no-ops — scripts written against the
    BoxPSDataset API run unchanged, feeding the ordinary PS/collective
    paths instead of BoxPS.  See README "Documented drops" for the
    BoxWrapper rationale."""

    def begin_pass(self):
        return None

    def end_pass(self, need_save_delta=False):  # noqa: ARG002 (parity sig)
        return None

    def wait_preload_done(self):
        return None

    def preload_into_memory(self):
        # reference overlaps load with training via boxps threads; the
        # truthful equivalent here is a synchronous load
        return self.load_into_memory()


class DatasetFactory:
    """dataset.py:22 DatasetFactory parity."""

    def create_dataset(self, name="QueueDataset"):
        if name == "QueueDataset":
            return QueueDataset()
        if name == "InMemoryDataset":
            return InMemoryDataset()
        if name == "BoxPSDataset":
            return BoxPSDataset()
        raise ValueError(f"unknown dataset type {name}")
