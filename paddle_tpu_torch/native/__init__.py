"""Native (C++) host runtime, loaded with ctypes (port of
paddle_tpu/native/__init__.py).

The host-side data plane of both packages is C++: sparse-embedding
shards and the MultiSlot text parser (`csrc/ps_shard.cpp`) and the
threaded MultiSlot file reader (`csrc/data_feed.cpp`), in the
repository's `csrc/`.  The port builds its own copy of the library from
those two sources at first use,

    g++ -O3 -shared -fPIC -std=c++17 -pthread \
        -o paddle_tpu_torch/_build/libpaddle_tpu_torch_native-<digest>.so \
        csrc/ps_shard.cpp csrc/data_feed.cpp

(the digest covers the sources and the flags, so an edited source is
rebuilt), and never loads or writes the JAX package's library.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
_SRCS = [_REPO / "csrc" / f for f in ("ps_shard.cpp", "data_feed.cpp")]
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()


def _so_path():
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SRCS:
        digest.update(s.read_bytes())
    return _BUILD_DIR / f"libpaddle_tpu_torch_native-{digest.hexdigest()[:12]}.so"


def _build(out):
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp)] + [str(s) for s in _SRCS]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, out)


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            so = _so_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError):
            return None
        c = ctypes
        lib.ps_create.restype = c.c_void_p
        lib.ps_create.argtypes = [c.c_int64, c.c_float, c.c_uint64,
                                  c.c_int, c.c_float, c.c_float]
        lib.ps_destroy.argtypes = [c.c_void_p]
        lib.ps_set_lr.argtypes = [c.c_void_p, c.c_float]
        lib.ps_pull.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                c.c_void_p]
        lib.ps_push.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                c.c_void_p]
        lib.ps_assign.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                  c.c_void_p]
        lib.ps_size.restype = c.c_int64
        lib.ps_size.argtypes = [c.c_void_p]
        lib.ps_export.restype = c.c_int64
        lib.ps_export.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                  c.c_int64]
        lib.ps_row_width.restype = c.c_int64
        lib.ps_row_width.argtypes = [c.c_void_p]
        lib.ps_export_full.restype = c.c_int64
        lib.ps_export_full.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                       c.c_int64]
        lib.ps_assign_full.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                       c.c_void_p]
        lib.ps_parse_multislot.restype = c.c_int64
        lib.ps_parse_multislot.argtypes = [
            c.c_char_p, c.c_int64, c.c_int, c.c_void_p, c.c_void_p,
            c.c_int64, c.c_void_p, c.c_int64, c.c_void_p, c.c_int64]
        lib.reader_create.restype = c.c_void_p
        lib.reader_create.argtypes = [
            c.POINTER(c.c_char_p), c.c_int, c.c_int, c.c_void_p,
            c.c_void_p, c.c_int, c.c_int, c.c_int]
        lib.reader_int_width.restype = c.c_int64
        lib.reader_int_width.argtypes = [c.c_void_p]
        lib.reader_float_width.restype = c.c_int64
        lib.reader_float_width.argtypes = [c.c_void_p]
        lib.reader_next.restype = c.c_int64
        lib.reader_next.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                    c.c_void_p]
        lib.reader_destroy.argtypes = [c.c_void_p]
        _lib = lib
        return _lib


def available():
    return load() is not None


class NativeShard:
    """ctypes wrapper over one C++ embedding shard."""

    OPT = {"sgd": 0, "adagrad": 1}

    def __init__(self, dim, init_range=0.05, seed=0, optimizer="adagrad",
                 lr=0.05, adagrad_eps=1e-6):
        lib = load()
        if lib is None:
            raise RuntimeError("native ps_shard library unavailable")
        self._lib = lib
        self.dim = int(dim)
        self._h = lib.ps_create(self.dim, float(init_range), int(seed),
                                self.OPT[optimizer], float(lr),
                                float(adagrad_eps))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ps_destroy(h)
            self._h = None

    def set_lr(self, lr):
        self._lib.ps_set_lr(self._h, float(lr))

    def pull(self, ids):
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        out = np.empty((len(ids), self.dim), dtype=np.float32)
        self._lib.ps_pull(self._h, ids.ctypes.data, len(ids),
                          out.ctypes.data)
        return out

    def push(self, ids, grads):
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        grads = np.ascontiguousarray(grads, dtype=np.float32)
        assert grads.shape == (len(ids), self.dim)
        self._lib.ps_push(self._h, ids.ctypes.data, len(ids),
                          grads.ctypes.data)

    def assign(self, ids, vals):
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        self._lib.ps_assign(self._h, ids.ctypes.data, len(ids),
                            vals.ctypes.data)

    def __len__(self):
        return int(self._lib.ps_size(self._h))

    def export(self):
        n = len(self)
        ids = np.empty(n, dtype=np.int64)
        vals = np.empty((n, self.dim), dtype=np.float32)
        written = self._lib.ps_export(self._h, ids.ctypes.data,
                                      vals.ctypes.data, n)
        return ids[:written], vals[:written]

    @property
    def row_width(self):
        return int(self._lib.ps_row_width(self._h))

    def export_full(self):
        """(ids, [n, row_width]) including optimizer accumulators."""
        n = len(self)
        w = self.row_width
        ids = np.empty(n, dtype=np.int64)
        vals = np.empty((n, w), dtype=np.float32)
        written = self._lib.ps_export_full(self._h, ids.ctypes.data,
                                           vals.ctypes.data, n)
        return ids[:written], vals[:written]

    def assign_full(self, ids, vals):
        ids = np.ascontiguousarray(ids, dtype=np.int64)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        assert vals.shape == (len(ids), self.row_width)
        self._lib.ps_assign_full(self._h, ids.ctypes.data, len(ids),
                                 vals.ctypes.data)


def parse_multislot(text, slot_types):
    """Parse MultiSlot lines (data_feed.cc format) with the native parser.

    text: str/bytes of newline-separated instances; slot_types: sequence
    of "float"/"int64" per slot. Returns (counts [n_inst, n_slots],
    int_values flat, float_values flat).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native ps_shard library unavailable")
    if isinstance(text, str):
        text = text.encode()
    n_slots = len(slot_types)
    is_float = np.array([1 if t == "float" else 0 for t in slot_types],
                        dtype=np.uint8)
    n_lines = max(1, text.count(b"\n") + 1)
    max_groups = n_lines * n_slots
    counts = np.zeros(max_groups, dtype=np.int64)
    # every value consumes >= 2 input bytes, so len(text) bounds the count
    cap = len(text) // 2 + 16
    int_vals = np.empty(cap, dtype=np.int64)
    float_vals = np.empty(cap, dtype=np.float32)
    n = lib.ps_parse_multislot(
        text, len(text), n_slots, is_float.ctypes.data, counts.ctypes.data,
        max_groups, int_vals.ctypes.data, cap, float_vals.ctypes.data, cap)
    if n < 0:
        raise ValueError("malformed MultiSlot input")
    counts = counts[: n * n_slots].reshape(n, n_slots)
    n_int = int(counts[:, is_float == 0].sum()) if n else 0
    n_float = int(counts[:, is_float == 1].sum()) if n else 0
    return counts, int_vals[:n_int].copy(), float_vals[:n_float].copy()


class MultiSlotFileReader:
    """Threaded native file reader: parses MultiSlot text files into
    padded numpy batches off the Python thread (data_feed.cc +
    blocking_queue.h parity).

    slots: list of (name, "int64"|"float", max_values). Iterate to get
    dicts {name: np.ndarray [batch, max_values]} plus "<name>:count".
    """

    def __init__(self, files, slots, batch_size, n_threads=2, queue_cap=8):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.slots = slots
        self.batch_size = batch_size
        n = len(slots)
        is_float = np.array([1 if t == "float" else 0 for _, t, _ in slots],
                            dtype=np.uint8)
        smax = np.array([m for _, _, m in slots], dtype=np.int64)
        arr = (ctypes.c_char_p * len(files))(
            *[f.encode() for f in files])
        self._h = lib.reader_create(
            arr, len(files), n, is_float.ctypes.data, smax.ctypes.data,
            batch_size, n_threads, queue_cap)
        self._iw = lib.reader_int_width(self._h)
        self._fw = lib.reader_float_width(self._h)

    def __iter__(self):
        return self

    def __next__(self):
        n_slots = len(self.slots)
        counts = np.empty((self.batch_size, n_slots), np.int64)
        ints = np.empty((self.batch_size, self._iw), np.int64)
        floats = np.empty((self.batch_size, self._fw), np.float32)
        n = self._lib.reader_next(self._h, counts.ctypes.data,
                                  ints.ctypes.data, floats.ctypes.data)
        if n < 0:
            raise ValueError("malformed MultiSlot input file")
        if n == 0:
            raise StopIteration
        out = {}
        iw = fw = 0
        for si, (name, typ, m) in enumerate(self.slots):
            if typ == "float":
                out[name] = floats[:n, fw:fw + m]
                fw += m
            else:
                out[name] = ints[:n, iw:iw + m]
                iw += m
            out[name + ":count"] = counts[:n, si]
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.reader_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def build_capi(out, demo=False):
    """Build the C inference API (`paddle_tpu_torch/csrc/predictor_capi.cpp`)
    with g++ against this interpreter's Python headers: a shared library
    at `out` for a process that already runs Python (ctypes; the Python
    symbols resolve in that process), or with `demo` the standalone
    program of its PD_CAPI_DEMO_MAIN (`out <model_dir> [device]`), which
    embeds libpython.  Returns `out` as a string."""
    import sysconfig

    src = Path(__file__).resolve().parent.parent / "csrc" / \
        "predictor_capi.cpp"
    cmd = ["g++", "-O1", "-std=c++17", str(src),
           "-I" + sysconfig.get_paths()["include"], "-o", str(out)]
    if demo:
        libdir = sysconfig.get_config_var("LIBDIR")
        cmd[2:2] = ["-DPD_CAPI_DEMO_MAIN"]
        cmd += [f"-L{libdir}", f"-Wl,-rpath,{libdir}",
                "-lpython" + sysconfig.get_config_var("LDVERSION")]
        for var in ("LIBS", "SYSLIBS"):
            cmd += (sysconfig.get_config_var(var) or "").split()
    else:
        cmd[2:2] = ["-shared", "-fPIC"]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return str(out)


def capi_load(path):
    """The C API library at `path` (from `build_capi`) with its entry
    points' ctypes signatures."""
    c = ctypes
    lib = c.CDLL(str(path))
    P, I, C = c.c_void_p, c.c_int, c.c_char_p
    sigs = {"PD_NewPredictor": (P, [C, C]), "PD_DeletePredictor": (None, [P]),
            "PD_FeedCount": (I, [P]), "PD_FetchCount": (I, [P]),
            "PD_FeedName": (C, [P, I]),
            "PD_SetInput": (I, [P, C, P, c.POINTER(c.c_int64), I]),
            "PD_Run": (I, [P]),
            "PD_GetOutput": (I, [P, I, c.POINTER(P), c.POINTER(P),
                                 c.POINTER(I)]),
            "PD_LastError": (C, [])}
    for name, (res, args) in sigs.items():
        f = getattr(lib, name)
        f.restype, f.argtypes = res, args
    return lib


def capi_run(lib, model_dir, feed, device):
    """Serve `feed` ({name: array}) once through the C API of `lib`: a
    predictor for `model_dir` on `device` (None: the C API's default,
    "cuda"), every feed as float32 (the C ABI's type), one PD_Run.
    Returns [np.ndarray] per fetch; raises RuntimeError with
    PD_LastError on a failure."""
    def ok(status):
        if status != 0:
            raise RuntimeError(lib.PD_LastError().decode())

    p = lib.PD_NewPredictor(str(model_dir).encode(),
                            None if device is None else str(device).encode())
    if not p:
        raise RuntimeError(lib.PD_LastError().decode())
    try:
        for i in range(lib.PD_FeedCount(p)):
            name = lib.PD_FeedName(p, i)
            a = np.ascontiguousarray(feed[name.decode()], np.float32)
            shape = (ctypes.c_int64 * a.ndim)(*a.shape)
            ok(lib.PD_SetInput(p, name, a.ctypes.data, shape, a.ndim))
        ok(lib.PD_Run(p))
        outs = []
        for i in range(lib.PD_FetchCount(p)):
            data, shape, ndim = ctypes.c_void_p(), ctypes.c_void_p(), \
                ctypes.c_int()
            ok(lib.PD_GetOutput(p, i, ctypes.byref(data),
                                ctypes.byref(shape), ctypes.byref(ndim)))
            dims = [ctypes.cast(shape, ctypes.POINTER(ctypes.c_int64))[d]
                    for d in range(ndim.value)]
            n = int(np.prod(dims))
            buf = ctypes.cast(data, ctypes.POINTER(ctypes.c_float * n))
            outs.append(np.frombuffer(buf.contents, np.float32)
                        .reshape(dims).copy())
        return outs
    finally:
        lib.PD_DeletePredictor(p)
