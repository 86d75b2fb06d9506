"""paddle.dataset.common parity — cache-dir, checksum, and reader
split/merge helpers.

Reference: python/paddle/dataset/common.py (DATA_HOME, md5file :57,
download :66, split :128, cluster_files_reader :166).  The project
is offline by design, so `download` serves only the cache-hit path and
raises a clear error otherwise; everything else is fully functional.
Unlike the reference, nothing is created under DATA_HOME: a cache miss
writes no directory.
"""

import glob
import hashlib
import os
import pickle

__all__ = ["DATA_HOME", "download", "md5file", "split",
           "cluster_files_reader", "must_mkdirs", "fetch_all"]

DATA_HOME = os.path.expanduser("~/.cache/paddle_tpu/dataset")


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname,
        url.split("/")[-1] if save_name is None else save_name)
    if os.path.exists(filename) and (
            not md5sum or md5file(filename) == md5sum):
        return filename
    raise RuntimeError(
        "offline environment: %s is not cached at %s; the stock dataset "
        "zoo (paddle_tpu_torch.datasets.*) provides deterministic surrogates "
        "that need no downloads" % (url, filename))


def fetch_all():
    """common.py:117 parity — pre-fetch every dataset.  The surrogate
    zoo generates data deterministically, so this is a no-op pass that
    simply verifies every dataset module imports."""
    import importlib

    import paddle_tpu_torch.datasets as datasets

    for name in datasets.__all__:
        importlib.import_module("paddle_tpu_torch.datasets." + name)


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """common.py:128 parity — dump a reader into line_count-sized
    pickle shards named by `suffix`."""
    indx_f = 0
    batch = []
    out_paths = []

    def flush():
        nonlocal indx_f, batch
        if not batch:
            return
        path = suffix % indx_f
        with open(path, "wb") as f:
            dumper(batch, f)
        out_paths.append(path)
        batch = []
        indx_f += 1

    for item in reader():
        batch.append(item)
        if len(batch) == line_count:
            flush()
    flush()
    return out_paths


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """common.py:166 parity — read the shards belonging to this
    trainer (round-robin by index)."""

    def reader():
        flist = sorted(glob.glob(files_pattern))
        for idx, fn in enumerate(flist):
            if idx % trainer_count == trainer_id:
                with open(fn, "rb") as f:
                    for item in loader(f):
                        yield item

    return reader
