"""P1 and P2: K7's forward cut in two, for Hopper.

Port of the two stripped Pallas kernels of tools/fused_probe.py:

    P1 (`p4_conv_only`, pallas_call :88): y = round(conv3x3(zero_pad(x), w2))
        x, y [N, H, W, Cm]; w2 [3, 3, Cm, Cm] (HWIO); the nine taps summed
        in f32 (`_conv3x3` of paddle_tpu/kernels/fused_bottleneck.py :165),
        rounded once to x's dtype; no affine, no relu.
    P2 (`p5_matmuls`, pallas_call :114): h0 = round(relu(x @ w1)),
        y = round(h0 @ w3 + x)
        x, y [N, H, W, Cin]; w1 [Cin, Cm]; w3 [Cm, Cin]; both products in
        f32 (`_dot` :134), relu and round between them, the residual added
        in f32 before the last round.

The kernels are CUDA C++ in `paddle_tpu_torch/csrc/fused_bottleneck.cu`,
both on K7's pieces (`csrc/block_tc.cuh`) and K7's tiling.  P1
(`probe_conv3x3_kernel`) runs K7's forward path for its 3x3 (x's halo
rows staged where K7 keeps h0, then `conv3x3<T, 1>` on the tensor-core
product of `csrc/mma.cuh`).  P2 (`probe_matmuls_kernel`) runs K7's
identity forward without the halo, the 3x3 and the affines: x @ w1 on
the same product over the tile's own pixels, h0 kept where K7 keeps h1,
then h0 @ w3 per 128-column chunk with the residual in its epilogue.  So
K7's stage-1 forward splits three ways on the same inputs: P1, P2 and K7
- P1 - P2 (the halo's h0 product, the affines and the rest).  On CPU
tensors the wrappers run the plain versions (`conv3x3_probe_ref`,
`matmul_chain_probe_ref`); on CUDA tensors they launch the kernels or
raise.  The Pallas probes have no backward, and neither do these.
"""

import ctypes

import torch

from . import backend
from .fused_bottleneck import _DTYPE_CODES, _dot, _im2col, _pad_hw

_P, _I = ctypes.c_void_p, ctypes.c_int
# csrc/fused_bottleneck.cu
_SIGS = {
    "pt_probe_conv3x3": [_P] * 3 + [_I] * 5 + [_P],
    "pt_probe_matmuls": [_P] * 4 + [_I] * 6 + [_P],
    "pt_probe_tiles": [_I] * 4 + [_P],
}


def conv3x3_probe_ref(x, w2):
    """Plain P1: zero pad, im2col, one f32 product, one rounding."""
    n, h, w, cm = x.shape
    p = _im2col(_pad_hw(x), n, h, w, cm)
    return _dot(p, w2.reshape(9 * cm, cm)).to(x.dtype).reshape(n, h, w, cm)


def matmul_chain_probe_ref(x, w1, w3):
    """Plain P2: round(relu(x @ w1)) @ w3 + x in f32, rounded once."""
    n, h, w, cin = x.shape
    xm = x.reshape(n * h * w, cin)
    h0 = torch.clamp_min(_dot(xm, w1), 0.0).to(x.dtype)
    return (_dot(h0, w3) + xm.float()).to(x.dtype).reshape(n, h, w, cin)


def _check(name, x, ws, shapes):
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [N, H, W, C] (NHWC), got "
                         f"{tuple(x.shape)}")
    for t, want in zip(ws, shapes):
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: weight must be {list(want)}, got "
                             f"{tuple(t.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not in float32/bfloat16")
    for t in ws:
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: weights must share x's dtype and "
                             "device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_launch(name, cm, *ts):
    if cm & (cm - 1):
        raise ValueError(f"{name}: the CUDA kernel needs Cm a power of two, "
                         f"got {cm}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             "inputs")


def conv3x3_probe(x, w2):
    """P1: the 3x3 conv of K7 alone.  x [N, H, W, Cm], w2 [3, 3, Cm, Cm]."""
    cm = x.shape[-1] if x.dim() == 4 else 0
    _check("conv3x3_probe", x, (w2,), ((3, 3, cm, cm),))
    if x.device.type == "cpu":
        return conv3x3_probe_ref(x, w2)
    _check_launch("conv3x3_probe", cm, x, w2)
    lib = backend.load("fused_bottleneck", _SIGS)
    n, h, w, _ = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = lib.pt_probe_conv3x3(
            x.data_ptr(), w2.data_ptr(), y.data_ptr(), n, h, w, cm,
            _DTYPE_CODES[x.dtype], backend.stream_handle(x.device))
    backend.check(status, "probe_conv3x3")
    backend.LAUNCHES["probe_conv3x3"] += 1
    return y


def matmul_chain_probe(x, w1, w3):
    """P2: the 1x1 chain of K7 and its residual, no 3x3.  x [N, H, W,
    Cin], w1 [Cin, Cm], w3 [Cm, Cin]."""
    cin = x.shape[-1] if x.dim() == 4 else 0
    cm = w1.shape[-1] if w1.dim() == 2 else 0
    _check("matmul_chain_probe", x, (w1, w3), ((cin, cm), (cm, cin)))
    if x.device.type == "cpu":
        return matmul_chain_probe_ref(x, w1, w3)
    _check_launch("matmul_chain_probe", cm, x, w1, w3)
    lib = backend.load("fused_bottleneck", _SIGS)
    n, h, w, _ = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = lib.pt_probe_matmuls(
            x.data_ptr(), w1.data_ptr(), w3.data_ptr(), y.data_ptr(), n, h,
            w, cin, cm, _DTYPE_CODES[x.dtype],
            backend.stream_handle(x.device))
    backend.check(status, "probe_matmuls")
    backend.LAUNCHES["probe_matmuls"] += 1
    return y


def probe_tiles(h, w, cm, dtype):
    """How the launches lay out on the current CUDA device for sides h x
    w and Cm channels: ((rows per tile of P1, of P2), (blocks that fit on
    one SM for P1, P2)); 0 where nothing fits.  Both take K7's rule (the
    least work among the heights whose shared memory fits, ties to the
    larger height) on their own pixels padded to 16 rows; P2's shared
    memory is K7's forward layout."""
    lib = backend.load("fused_bottleneck", _SIGS)
    out = (ctypes.c_int * 4)()
    backend.check(lib.pt_probe_tiles(h, w, cm, _DTYPE_CODES[dtype],
                                     ctypes.addressof(out)), "probe_tiles")
    return tuple(out[:2]), tuple(out[2:])
