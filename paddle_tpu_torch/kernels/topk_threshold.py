"""K10: the DGC top-k threshold (port of paddle_tpu/kernels/topk_threshold.py).

Deep gradient compression keeps the largest (1 - sparsity) fraction of
|v| in each tensor.  A full sort is not needed for that: a threshold
that approximates the k-th largest |v| is.  `count_ge_histogram` counts,
in one pass over the tensor, the elements with |x| >= each of 256 linear
edges over [0, max|x|] (the reference's `_count_ge_kernel`, :35, reached
through `count_ge_histogram`, :45); `topk_threshold` takes the largest
edge that still keeps at least k elements, so `|v| >= t` keeps at least
k elements and at most the bin that holds the exact k-th value.

On a CUDA tensor `count_ge_histogram` launches K10
(`csrc/topk_threshold.cu`), which reads the values in their own dtype
(bf16 or f32), takes |x| after the cast, finds each element's bin among
the sorted edges by a binary search and counts in integers: the counts
are exact and do not depend on the order of the sums.  It is one launch
per call: its last block writes the float32 counts and clears the
integer workspace that the wrapper keeps per device and stream.  On a CPU
tensor it runs the plain version, `count_ge_histogram_ref`, which sorts
|x| and counts by binary search, also exactly.  Both return float32
counts, as the reference does.  The reference sums float32 per-tile
partials, so above 2^24 elements its counts can round where the port's
stay exact.

The max, the edges, the pick of the edge and the mask are torch ops
outside the kernel, as they are jnp ops outside the Pallas call in the
reference.  The edges are `EDGE_FRACTIONS * max(vmax, 1e-30)`, with the
fractions bitwise equal to `jnp.linspace(0, 1, 256, dtype=float32)`
(`torch.linspace` differs from it in half of them).
"""

import ctypes

import numpy as np
import torch

from . import backend

NUM_EDGES = 256
DEFAULT_BLOCK = 64 * 1024
# jnp.linspace(0.0, 1.0, NUM_EDGES, dtype=float32), bit for bit
EDGE_FRACTIONS = np.arange(NUM_EDGES, dtype=np.float32) \
    * np.float32(1.0 / (NUM_EDGES - 1))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SIGS = {"pt_count_ge_histogram": [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p]}
# per (device index, stream): K10's integer workspace (256 sums and the
# blocks' arrival counter), zeroed once; every launch leaves it 0
_WORK = {}


def _work(device, stream):
    key = (device.index, stream.value)
    if key not in _WORK:
        _WORK[key] = torch.zeros(NUM_EDGES + 1, dtype=torch.int32,
                                 device=device)
    return _WORK[key]


def count_ge_histogram_ref(x, edges):
    """The plain version: counts of |x| >= edge for each edge, over the
    flattened x (any float dtype, |x| taken in float32), as float32.
    It sorts the non-NaN |x| and counts the elements at or above each
    edge by a binary search (a NaN element never counts; a NaN edge
    counts nothing, as it searches to the end)."""
    a = x.reshape(-1).float().abs()
    a = torch.sort(a[~torch.isnan(a)]).values
    below = torch.searchsorted(a, edges.contiguous(), side="left")
    return (a.numel() - below).float()


def _launch(x, edges):
    flat = x.reshape(-1)
    if flat.dtype not in _DTYPE_CODES:
        raise TypeError(f"count_ge_histogram: dtype {flat.dtype} not in "
                        "float32/bfloat16")
    if edges.shape != (NUM_EDGES,) or edges.dtype != torch.float32 \
            or edges.device != flat.device:
        raise ValueError(f"count_ge_histogram: edges must be float32 "
                         f"[{NUM_EDGES}] on {flat.device}, got "
                         f"{edges.dtype} {list(edges.shape)} on "
                         f"{edges.device}")
    if flat.numel() >= 2 ** 31:
        raise ValueError("count_ge_histogram: the kernel counts in 32 bits "
                         f"and takes fewer than 2^31 elements, got "
                         f"{flat.numel()}")
    flat, edges = flat.contiguous(), edges.contiguous()
    counts = torch.empty(NUM_EDGES, dtype=torch.float32, device=flat.device)
    lib = backend.load("topk_threshold", _SIGS)
    with torch.cuda.device(flat.device):
        stream = backend.stream_handle(flat.device)
        status = lib.pt_count_ge_histogram(
            flat.data_ptr(), flat.numel(), edges.data_ptr(),
            counts.data_ptr(), _work(flat.device, stream).data_ptr(),
            _DTYPE_CODES[flat.dtype], stream)
    backend.check(status, "count_ge_histogram")
    backend.LAUNCHES["topk_threshold"] += 1
    return counts


def count_ge_histogram(flat_abs, edges, block=DEFAULT_BLOCK):
    """[N] |values| + [NUM_EDGES] float32 edges -> [NUM_EDGES] float32
    counts of |x| >= edge.  `block` is the reference's tile size; the
    kernel picks its own tiling and the counts do not depend on it."""
    if flat_abs.device.type == "cpu":
        return count_ge_histogram_ref(flat_abs, edges)
    return _launch(flat_abs, edges)


# EDGE_FRACTIONS on each device it was asked for: copied there once, as
# a copy from pageable host memory waits for the device
_FRACTIONS_ON = {}


def _edges(vmax):
    frac = _FRACTIONS_ON.get(vmax.device)
    if frac is None:
        frac = _FRACTIONS_ON[vmax.device] = torch.from_numpy(
            EDGE_FRACTIONS).to(vmax.device)
    return frac * torch.clamp(vmax, min=1e-30)


def topk_threshold(v, k, block=DEFAULT_BLOCK):
    """Approximate k-th largest |v|: the largest histogram edge that
    keeps at least k elements, as a float32 0-d tensor (no host sync)."""
    flat = v.reshape(-1)
    vmax = torch.linalg.vector_norm(flat, float("inf")).float()
    edges = _edges(vmax)
    counts = count_ge_histogram(flat, edges, block=block)
    keep = counts >= k
    idx = torch.where(keep, torch.arange(NUM_EDGES, device=v.device),
                      0).max()
    # a gather, not edges[idx]: indexing with a 0-d tensor may read it
    # on the host
    return edges.gather(0, idx.reshape(1)).reshape(())


def dgc_topk_mask_pallas(v, sparsity, block=DEFAULT_BLOCK):
    """DGC keep-mask from the histogram threshold: keeps the largest
    ~(1 - sparsity) fraction of |v| (always at least the exact k), in
    v's dtype.  |v| is compared with the threshold in float32, as the
    reference's promotion does."""
    n = v.numel()
    k = max(1, int(round(n * (1.0 - sparsity))))
    t = topk_threshold(v, k, block=block)
    return (v.float().abs() >= t).to(v.dtype)
