"""Backend detection, the CUDA kernel build, and kernel launch counts.

Counterpart of paddle_tpu/kernels/backend.py:13 `is_tpu_backend`: the
port's kernels are for Hopper (`sm_90a`), and `is_hopper()` says whether
the current CUDA device is one.

The CUDA C++ kernels under `paddle_tpu_torch/csrc/` are compiled at
first use, one `nvcc` process per source, all started together, into
`paddle_tpu_torch/_build/` (listed in .gitignore):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o _build/lib<name>-<digest>.so csrc/<name>.cu

Each library has a plain C interface and is loaded with `ctypes`;
pointers and the stream pass as `c_void_p`.  Every C entry returns
`cudaGetLastError()` after its launch, and `check()` raises on a
non-zero code.  The file name carries a digest of the source and the
flags, so an edited source is rebuilt.

Every kernel wrapper adds one to its entry in `LAUNCHES` where it
launches its kernel, and nowhere else (`count_launch`; a float16 launch
also under `<name>:float16`); a run reads the counts to show that its
path went through the kernels.  Beside them, `HOST_SYNCS` counts the
host reads of device values the static Executor makes by design (a
control-flow predicate or array index, the guard's finite flag, a fetch
the dataset loop materializes; `count_host_sync`), so a run can report
them per loop trip and per step.

Inside `traced_kernels()` the forward wrappers an inference Program
reaches (K1, K4) call their launcher through a `torch.library` custom op
(`paddle_tpu_torch::flash_attention_fwd`, `::layer_norm_fwd`) with a fake
(shape-only) version beside it, so that `torch.export` can trace a
Program: a ctypes launch on `data_ptr()` cannot run on the fake tensors
export traces with.  The exported graph holds the ops as nodes, whose
implementation is the launcher itself.
"""

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# every csrc/*.cu source, one shared library each
SOURCES = ("flash_attention", "flash_attention_bwd", "flash_decode",
           "fused_block", "fused_bottleneck", "fused_down",
           "fused_stem_tail", "layer_norm_bwd", "topk_threshold")

LAUNCHES = collections.Counter()
HOST_SYNCS = collections.Counter()
# compiler output (ptxas register / shared-memory / spill report) per
# library built by this process
BUILD_LOG = {}

_lock = threading.Lock()
# ranks held in one process (distributed/inprocess.py) launch from
# threads of their own: the counts are read-modify-writes
_count_lock = threading.Lock()
_libs = {}
_sms = {}


_TRACED = [0]


@contextlib.contextmanager
def traced_kernels():
    """Route the kernel wrappers through their custom ops while active
    (see the module docstring)."""
    _TRACED[0] += 1
    try:
        yield
    finally:
        _TRACED[0] -= 1


def tracing():
    return _TRACED[0] > 0


def is_hopper():
    """True when a CUDA device of compute capability 9.x is present."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability()[0] == 9)


def sm_count(device):
    """The SM count of CUDA device `device`, read once per device (the
    planners size their grids from it)."""
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


def reset_launches():
    LAUNCHES.clear()


def count_launch(name, dtype):
    """One launch of kernel `name`.  A float16 launch runs the kernel's
    float16 instantiation, a kernel of its own: it is also counted under
    `name:float16`."""
    with _count_lock:
        LAUNCHES[name] += 1
        if dtype == torch.float16:
            LAUNCHES[name + ":float16"] += 1


def reset_host_syncs():
    HOST_SYNCS.clear()


def count_host_sync(kind, n=1):
    """`n` host reads of device values of kind `kind` ("cond", "while",
    "array_index", "guard", "fetch", ...)."""
    with _count_lock:
        HOST_SYNCS[kind] += n


def nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def lib_path(name):
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(part.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=SOURCES):
    """Compile every library in `names` that is not built yet, one nvcc
    process per source, all running at once.  Returns the paths."""
    with _lock:
        return _build_locked(names)


def _build_locked(names):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return [lib_path(n) for n in names]


def load(name, signatures):
    """Build (if needed) and load library `name`; `signatures` maps each
    C entry point to its ctypes argtypes.  Every entry returns int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _build_locked((name,))[0]
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(status, what):
    """Raise if a C entry's cudaGetLastError() code is not cudaSuccess."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")


def stream_handle(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
