"""Fused ResNet blocks for Hopper: K7, K8 and K9, forward and backward.

Port of paddle_tpu/kernels/fused_bottleneck.py (`fused_bottleneck` :399,
`fused_bottleneck_proj` :436).  K7's kernels are CUDA C++ in
`paddle_tpu_torch/csrc/fused_block.cu` on the tensor-core pieces it
shares with K8 (`csrc/block_tc.cuh`, `csrc/mma.cuh`; built and bound by
`backend`): one forward kernel (the Pallas `_fwd_kernel` :180, `_fwd`
:335) and a backward entry (the Pallas `_bwd_kernel` :205, `_bwd` :357)
that runs its two activation-gradient kernels, one batch-wide
weight-gradient GEMM and its slice-order sum in a row, into scratch
that `block_plan` sizes.  A stride-1 block over NHWC rows, f32
accumulation, the activations rounded to x's dtype where the Pallas
kernels round them:

    y  = relu(a3 * (h1 @ w3) + b3 + s),   s = x  or  a4 * (x @ w4) + b4
    h1 = relu(a2 * conv3x3(h0, w2) + b2)
    h0 = relu(a1 * (x @ w1) + b1)

x [N, H, W, Cin]; w1 [Cin, Cm]; w2 [3, 3, Cm, Cm] (HWIO); w3 [Cm, Cout];
w4 [Cin, Cout]; the a/b are per-channel batch-norm affines resolved by
the caller.  `fused_bottleneck` and `fused_bottleneck_proj` are
`torch.autograd.Function`s (`_Fused`, `_FusedProj`, the counterparts of
the reference's custom VJPs `_vjp_fwd`/`_vjp_bwd` :411-429 and
:446-463): they save only x, the weights and the packed affines, and the
backward recomputes the rest, as the TPU kernel does.  The affine grads
come back in the affines' dtype (:426), the weight grads in the weights'.

On CPU tensors the wrappers run the plain PyTorch versions
(`fused_bottleneck_fwd_ref`, `fused_bottleneck_bwd_ref`), which copy
the Pallas kernels' math and rounding points; on CUDA tensors they
launch the kernels or raise.  `batch_tile` is checked as the reference
checks it (it must divide N) and then has no effect: the TPU's VMEM row
budgets (`default_batch_tile`, `_rows_for`, `_FWD_ROW_UNITS`,
`_BWD_ROW_UNITS`) and `PADDLE_TPU_FUSED_CONV` (im2col or taps compute
the same function) do not carry over; the CUDA launcher picks its own
spatial tiles.

K8 (`fused_bottleneck_down`, the reference's :702) is the stride-2
transition block, x [N, H, W, Cin] -> y [N, H/2, W/2, Cout] for even H
and W:

    h0 = relu(a1 * (x @ w1) + b1)                      at H x W
    h1 = relu(a2 * conv3x3_s2(h0, w2) + b2)            at H/2 x W/2, pad 1
    y  = relu(a3 * (h1 @ w3) + b3 + a4 * (x[:, ::2, ::2] @ w4) + b4)

with the Pallas `_fwd_kernel_down` :499 / `_bwd_kernel_down` :526
rounding points, under `_FusedDown` (the custom VJP :713-733).  K9
(`fused_stem_tail`, :902) is the ResNet stem's tail, relu(c * a + b)
then a 3x3 stride-2 max-pool with pad 1; its backward routes each
window's gradient to EVERY element equal to the window's max (the
Pallas `_stem_bwd_kernel` :775), not to the first.  Above a side of 112
the reference dispatches to its XLA composition (`_stem_tail_xla`
:892), whose pool gradient goes to the first maximum; the port keeps
that dispatch (it decides the tie rule), with its own `pool2d` in the
composition.  K8's CUDA kernels are in `csrc/fused_down.cu`, the
stride-2 instances of the pieces it shares with K7 (`csrc/block_tc.cuh`
on `csrc/mma.cuh`; its backward writes scratch that `down_plan` sizes),
K9's in `csrc/fused_stem_tail.cu`.
"""

import ctypes
import functools

import torch
import torch.nn.functional as TF

from . import backend

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
# K7 (csrc/fused_block.cu)
_BLOCK_SIGS = {
    "pt_fused_block_fwd": [_P] * 7 + [_I] * 9 + [_P],
    "pt_fused_block_bwd": [_P] * 20 + [_I] * 9 + [_P],
    "pt_fused_block_plan": [_I] * 8 + [_P],
}
# K8 (csrc/fused_down.cu)
_DOWN_SIGS = {
    "pt_fused_down_fwd": [_P] * 7 + [_I] * 8 + [_P],
    "pt_fused_down_bwd": [_P] * 20 + [_I] * 8 + [_P],
    "pt_fused_down_plan": [_I] * 7 + [_P],
}
_STEM_SIGS = {
    "pt_fused_stem_tail_fwd": [_P] * 3 + [_I] * 5 + [_P],
    "pt_fused_stem_tail_bwd": [_P] * 7 + [_I] * 9 + [_P],
    "pt_fused_stem_tail_plan": [_I] * 8 + [_P],
}
# K9 backward's tiling per dtype: (window rows R, window columns Q,
# 16-byte channel vectors per block), from chip_smoke.py's stem plan
# sweep at the ResNet-50 stem
STEM_BWD_TILING = {torch.bfloat16: (8, 14, 4), torch.float32: (2, 28, 8)}
# the reference's `_STEM_SIDE_LIMIT` (:890): above it the stem tail is
# the XLA composition, whose pool gradient goes to the first maximum
_STEM_SIDE_LIMIT = 112


def _pack_affines(affs, width):
    """[8, width] f32 row-packed affine table (rows padded to width;
    rows 6-7 are the projection-shortcut affine, zero for identity)."""
    rows = []
    for v in affs:
        v = v.to(torch.float32)
        rows.append(TF.pad(v, (0, width - v.shape[0]))
                    if v.shape[0] < width else v)
    while len(rows) < 8:
        rows.append(torch.zeros(width, dtype=torch.float32,
                                device=rows[0].device))
    return torch.stack(rows)


def _dot(a, b):
    """a @ b with f32 products and sums (the Pallas `_dot` with
    preferred_element_type=f32; bf16 operands are exact in f32)."""
    return torch.matmul(a.float(), b.float())


def _im2col(p, n, h, w, c):
    """Lane-concatenated 3x3 patches of a padded [N, H+2, W+2, C] tensor
    -> [N*H*W, 9*C] (tap order dy, dx as the reference's `_im2col`)."""
    taps = [p[:, dy:dy + h, dx:dx + w, :].reshape(n * h * w, c)
            for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=1)


def _pad_hw(t):
    return TF.pad(t, (0, 0, 1, 1, 1, 1))


def fused_bottleneck_fwd_ref(x, w1, w2, w3, w4, aff, proj):
    """Plain version of the forward kernel (the Pallas `_fwd_kernel`),
    over the whole batch: y [N, H, W, Cout] in x's dtype."""
    dt = x.dtype
    n, h, w, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    xm = x.reshape(n * h * w, cin)
    a1, b1, a2, b2 = aff[0, :cm], aff[1, :cm], aff[2, :cm], aff[3, :cm]
    a3, b3 = aff[4, :cout], aff[5, :cout]
    c0 = _dot(xm, w1)
    h0 = torch.clamp_min(c0 * a1 + b1, 0.0).to(dt)
    p = _im2col(_pad_hw(h0.reshape(n, h, w, cm)), n, h, w, cm)
    c1 = _dot(p, w2.reshape(9 * cm, cm))
    h1 = torch.clamp_min(c1 * a2 + b2, 0.0).to(dt)
    c2 = _dot(h1, w3)
    if proj:
        s = _dot(xm, w4) * aff[6, :cout] + aff[7, :cout]
    else:
        s = xm.float()
    pre = c2 * a3 + b3 + s
    return torch.clamp_min(pre, 0.0).to(dt).reshape(n, h, w, cout)


def fused_bottleneck_bwd_ref(x, dy, w1, w2, w3, w4, aff, proj,
                             masks=None, keep=None):
    """Plain version of the backward kernel (the Pallas `_bwd_kernel`):
    recomputes the forward and returns (dx in x's dtype, dW1, dW2, dW3,
    dW4, daff [8, width]), the weight and affine grads in f32 (dW4 is
    None for the identity block).  c0, c1, c2, c4 are rounded to x's
    dtype before the affine-grad sums, dc2, dc1, dc0, dc4 before their
    products, as in the reference.  `masks`, if given, are the three
    relu masks (bool [R, Cm], [R, Cm], [R, Cout]) taken in place of
    u0 > 0, u1 > 0 and pre > 0: a check that holds a kernel to this
    version on the masks the kernel chose.  `keep`, if a list, receives
    h0, h1, dc0, dc1, dc2 and dc4 (the identity block: dz3) in x's
    dtype, as the kernel's scratch (`_launch_bwd`)."""
    dt = x.dtype
    n, h, w, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    r = n * h * w
    xm = x.reshape(r, cin)
    a1, b1, a2, b2 = aff[0, :cm], aff[1, :cm], aff[2, :cm], aff[3, :cm]
    a3, b3 = aff[4, :cout], aff[5, :cout]
    daff = torch.zeros_like(aff, dtype=torch.float32)

    # recompute the forward
    c0 = _dot(xm, w1)
    u0 = c0 * a1 + b1
    h0 = torch.clamp_min(u0, 0.0).to(dt)
    c0 = c0.to(dt)
    p = _im2col(_pad_hw(h0.reshape(n, h, w, cm)), n, h, w, cm)
    c1 = _dot(p, w2.reshape(9 * cm, cm))
    u1 = c1 * a2 + b2
    h1 = torch.clamp_min(u1, 0.0).to(dt)
    c1 = c1.to(dt)
    c2 = _dot(h1, w3)
    if proj:
        a4, b4 = aff[6, :cout], aff[7, :cout]
        c4 = _dot(xm, w4)
        s = c4 * a4 + b4
        c4 = c4.to(dt)
    else:
        s = xm.float()
    pre = c2 * a3 + b3 + s
    c2 = c2.to(dt)
    m0, m1, m2 = masks or (u0 > 0.0, u1 > 0.0, pre > 0.0)

    # the backward chain
    dyf = dy.reshape(r, cout).float()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    dz3 = torch.where(m2, dyf, zero)
    daff[4, :cout] = (dz3 * c2.float()).sum(0)
    daff[5, :cout] = dz3.sum(0)
    dc2 = (dz3 * a3).to(dt)
    dw3 = _dot(h1.t(), dc2)
    dh1 = _dot(dc2, w3.t())
    du1 = torch.where(m1, dh1, zero)
    daff[2, :cm] = (du1 * c1.float()).sum(0)
    daff[3, :cm] = du1.sum(0)
    dc1 = (du1 * a2).to(dt)
    dw2 = _dot(p.t(), dc1).reshape(w2.shape)
    pr = _im2col(_pad_hw(dc1.reshape(n, h, w, cm)), n, h, w, cm)
    w2t = w2.flip(0, 1).transpose(2, 3).reshape(9 * cm, cm)
    dh0 = _dot(pr, w2t)
    du0 = torch.where(m0, dh0, zero)
    daff[0, :cm] = (du0 * c0.float()).sum(0)
    daff[1, :cm] = du0.sum(0)
    dc0 = (du0 * a1).to(dt)
    dw1 = _dot(xm.t(), dc0)
    dx_main = _dot(dc0, w1.t())
    dw4 = None
    if proj:
        daff[6, :cout] = (dz3 * c4.float()).sum(0)
        daff[7, :cout] = dz3.sum(0)
        dc4 = (dz3 * a4).to(dt)
        dw4 = _dot(xm.t(), dc4)
        dx_res = _dot(dc4, w4.t())
    else:
        dx_res = dz3
    dx = (dx_main + dx_res).to(dt).reshape(n, h, w, cin)
    if keep is not None:
        keep.extend([h0, h1, dc0, dc1, dc2, dc4 if proj else dz3.to(dt)])
    return dx, dw1, dw2, dw3, dw4, daff


# ---------------------------------------------------------------------------
# the CUDA launches
# ---------------------------------------------------------------------------

def _check(x, w1, w2, w3, w4, proj, batch_tile):
    if x.dim() != 4:
        raise ValueError(f"fused_bottleneck: x must be [N, H, W, C] (NHWC), "
                         f"got {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if w1.dim() != 2 or w1.shape[0] != cin:
        raise ValueError(f"fused_bottleneck: w1 must be [{cin}, Cm], got "
                         f"{tuple(w1.shape)}")
    cm = w1.shape[1]
    if tuple(w2.shape) != (3, 3, cm, cm):
        raise ValueError(f"fused_bottleneck: w2 must be [3, 3, {cm}, {cm}] "
                         f"(HWIO), got {tuple(w2.shape)}")
    if w3.dim() != 2 or w3.shape[0] != cm:
        raise ValueError(f"fused_bottleneck: w3 must be [{cm}, Cout], got "
                         f"{tuple(w3.shape)}")
    cout = w3.shape[1]
    if proj:
        if tuple(w4.shape) != (cin, cout):
            raise ValueError(f"fused_bottleneck_proj: w4 must be [{cin}, "
                             f"{cout}], got {tuple(w4.shape)}")
    elif cout != cin:
        raise ValueError(f"fused_bottleneck: the identity block needs Cout "
                         f"== Cin, got w3 {tuple(w3.shape)} for Cin {cin}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_bottleneck: dtype {x.dtype} not in "
                        "float32/bfloat16")
    weights = (w1, w2, w3) + ((w4,) if proj else ())
    for t in weights:
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("fused_bottleneck: weights must share x's dtype "
                             "and device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_bottleneck: unsupported device {x.device}")
    if batch_tile is not None and n % batch_tile:
        raise ValueError(f"batch_tile={batch_tile} does not divide batch {n}")


# the CUDA route's short pixel tables (csrc/block_tc.cuh `geo_ok`)
_MAX_W = 32767 // 8


def _check_launch(x, *ws):
    """What K7's and K8's CUDA route refuses, as ValueError: Cm not a power
    of two, inputs that are not contiguous, W above 4095 (its pixel
    tables hold shorts) or 2^31 pixels and more.  Any channel count and
    alignment is taken: 16-byte groups where every channel count is a
    multiple of 8 (bf16) or 4 (f32) and every pointer is 16-byte
    aligned, single elements otherwise."""
    cm = ws[0].shape[1]
    if cm & (cm - 1):
        raise ValueError(f"fused_bottleneck: the CUDA kernel needs Cm a "
                         f"power of two, got {cm}")
    for t in (x,) + ws:
        if not t.is_contiguous():
            raise ValueError("fused_bottleneck: the CUDA kernel needs "
                             "contiguous inputs")
    n, h, w, _ = x.shape
    if w > _MAX_W:
        raise ValueError(f"fused_bottleneck: the CUDA kernel needs W <= "
                         f"{_MAX_W}, got {w}")
    if n * h * w >= 2 ** 31:
        raise ValueError(f"fused_bottleneck: the CUDA kernel needs fewer "
                         f"than 2^31 pixels, got {n * h * w}")


def _dims(x, w1, w3, aff, proj):
    n, h, w, cin = x.shape
    return (n, h, w, cin, w1.shape[1], w3.shape[1], aff.shape[1],
            _DTYPE_CODES[x.dtype], int(proj))


def _device_index(device):
    index = torch.device("cuda" if device is None else device).index
    return torch.cuda.current_device() if index is None else index


def _plan_dict(out, n, h, w, cm, cout, s, dtype):
    """The 18 values of a plan entry (`plan_out`, csrc/block_tc.cuh) as a
    dict, with the backward's scratch in MB: h0, dc0 [R_in, Cm]; h1, dc1
    [R_out, Cm]; dc2, dc4 [R_out, Cout] in the activation dtype, and the
    float32 partials (R_out = R_in / s^2)."""
    elt = torch.empty((), dtype=dtype).element_size()
    r_in, r_out = n * h * w, n * (h // s) * (w // s)
    scratch = (2 * r_in * cm + 2 * r_out * cm + 2 * r_out * cout) * elt
    return dict(tile_rows=tuple(out[0:3]),
                tile_px=tuple(t * (w // s) for t in out[0:3]),
                blocks=tuple(out[3:6]), smem=tuple(out[6:9]),
                per_sm=tuple(out[15:18]), slices=tuple(out[9:13]),
                partials=out[13], wgrad_items=out[14],
                scratch_mb=(scratch + 4 * out[13]) / 1e6)


def block_plan(n, h, w, cin, cm, cout, proj, dtype, device=None):
    """K7's launch plan on a CUDA device (default: the current one;
    `pt_fused_block_plan`): per kernel (forward, B1, B2) the rows and
    pixels of a tile, the blocks, the shared memory and the blocks that
    fit on one SM; the K slices of dW1..dW4 (dW4's unused by the
    identity block) and the weight-gradient GEMM's items; the float32
    partials those slices store (one per slice per weight element, summed
    in slice order) and the backward's scratch in MB.  Planned once per
    device, geometry and dtype."""
    return dict(_block_plan(_device_index(device), n, h, w, cin, cm, cout,
                            bool(proj), dtype))


@functools.lru_cache(maxsize=None)
def _block_plan(index, n, h, w, cin, cm, cout, proj, dtype):
    lib = backend.load("fused_block", _BLOCK_SIGS)
    out = (ctypes.c_longlong * 18)()
    with torch.cuda.device(index):
        status = lib.pt_fused_block_plan(n, h, w, cin, cm, cout,
                                         _DTYPE_CODES[dtype], int(proj),
                                         ctypes.addressof(out))
    backend.check(status, "fused_block_plan")
    return _plan_dict(list(out), n, h, w, cm, cout, 1, dtype)


def _launch_fwd(x, w1, w2, w3, w4, aff, proj):
    w4 = w4 if proj else w1          # never read by the identity kernel
    _check_launch(x, w1, w2, w3, w4)
    aff = aff.contiguous()
    lib = backend.load("fused_block", _BLOCK_SIGS)
    n, h, w, _ = x.shape
    y = torch.empty((n, h, w, w3.shape[1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.pt_fused_block_fwd(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
            w4.data_ptr(), aff.data_ptr(), y.data_ptr(),
            *_dims(x, w1, w3, aff, proj), backend.stream_handle(x.device))
    backend.check(status, "fused_bottleneck_fwd")
    backend.LAUNCHES["fused_bottleneck_fwd"] += 1
    return y


def _launch_bwd(x, dy, w1, w2, w3, w4, aff, proj, keep=None):
    """K7's backward on the card.  `keep`, if a list, receives the
    scratch h0, h1, dc0, dc1, dc2 and dc4 (the identity block: dz3): dc0,
    dc1 and dc2 are nonzero exactly where the kernel's relu masks pass
    a gradient."""
    w4 = w4 if proj else w1          # never read by the identity kernels
    _check_launch(x, w1, w2, w3, w4)
    dy, aff = dy.contiguous(), aff.contiguous()
    lib = backend.load("fused_block", _BLOCK_SIGS)
    n, h, w, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    r = n * h * w
    partials = block_plan(n, h, w, cin, cm, cout, proj, x.dtype,
                          x.device)["partials"]
    f32 = dict(dtype=torch.float32, device=x.device)
    act = dict(dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty(w1.shape, **f32), torch.empty(w2.shape, **f32)
    dw3 = torch.empty(w3.shape, **f32)
    dw4 = torch.empty(w4.shape, **f32) if proj else dw1   # never written
    daff = torch.zeros(aff.shape, **f32)
    # h0, h1, dc0, dc1 [R, Cm]; dc2, and dc4 (the identity block: dz3)
    # [R, Cout]; the weight-gradient slices' partials
    scratch = [torch.empty((r, cm), **act) for _ in range(4)] + [
        torch.empty((r, cout), **act), torch.empty((r, cout), **act),
        torch.empty(partials, **f32)]
    with torch.cuda.device(x.device):
        status = lib.pt_fused_block_bwd(
            x.data_ptr(), dy.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            w3.data_ptr(), w4.data_ptr(), aff.data_ptr(), dx.data_ptr(),
            dw1.data_ptr(), dw2.data_ptr(), dw3.data_ptr(), dw4.data_ptr(),
            daff.data_ptr(), *(t.data_ptr() for t in scratch),
            *_dims(x, w1, w3, aff, proj), backend.stream_handle(x.device))
    backend.check(status, "fused_bottleneck_bwd")
    backend.LAUNCHES["fused_bottleneck_bwd"] += 1
    if keep is not None:
        keep.extend(scratch[:6])
    return dx, dw1, dw2, dw3, (dw4 if proj else None), daff


def _fwd(x, w1, w2, w3, w4, aff, proj):
    if x.device.type == "cpu":
        return fused_bottleneck_fwd_ref(x, w1, w2, w3, w4, aff, proj)
    return _launch_fwd(x, w1, w2, w3, w4, aff, proj)


def _bwd(x, dy, w1, w2, w3, w4, aff, proj):
    if x.device.type == "cpu":
        return fused_bottleneck_bwd_ref(x, dy, w1, w2, w3, w4, aff, proj)
    return _launch_bwd(x, dy, w1, w2, w3, w4, aff, proj)


# ---------------------------------------------------------------------------
# the autograd Functions and the public functions
# ---------------------------------------------------------------------------

class _Fused(torch.autograd.Function):
    """Identity-shortcut block: forward K7 fwd, backward K7 bwd."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, a1, b1, a2, b2, a3, b3):
        aff = _pack_affines((a1, b1, a2, b2, a3, b3), x.shape[-1])
        ctx.save_for_backward(x, w1, w2, w3, aff)
        ctx.adtype = a1.dtype
        return _fwd(x, w1, w2, w3, None, aff, False)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, w3, aff = ctx.saved_tensors
        cm = w1.shape[1]
        dx, dw1, dw2, dw3, _, daff = _bwd(x, dy, w1, w2, w3, None, aff,
                                          False)
        daff = daff.to(ctx.adtype)
        return (dx, dw1.to(w1.dtype), dw2.to(w2.dtype), dw3.to(w3.dtype),
                daff[0, :cm], daff[1, :cm], daff[2, :cm], daff[3, :cm],
                daff[4], daff[5])


class _FusedProj(torch.autograd.Function):
    """Projection-shortcut block: forward K7 fwd, backward K7 bwd."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, w4, a1, b1, a2, b2, a3, b3, a4, b4):
        aff = _pack_affines((a1, b1, a2, b2, a3, b3, a4, b4), w3.shape[1])
        ctx.save_for_backward(x, w1, w2, w3, w4, aff)
        ctx.adtype = a1.dtype
        return _fwd(x, w1, w2, w3, w4, aff, True)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, w3, w4, aff = ctx.saved_tensors
        cm = w1.shape[1]
        dx, dw1, dw2, dw3, dw4, daff = _bwd(x, dy, w1, w2, w3, w4, aff,
                                            True)
        daff = daff.to(ctx.adtype)
        return (dx, dw1.to(w1.dtype), dw2.to(w2.dtype), dw3.to(w3.dtype),
                dw4.to(w4.dtype), daff[0, :cm], daff[1, :cm], daff[2, :cm],
                daff[3, :cm], daff[4], daff[5], daff[6], daff[7])


def fused_bottleneck(x, w1, w2, w3, a1, b1, a2, b2, a3, b3,
                     batch_tile=None):
    """Identity-shortcut stride-1 bottleneck block, one device-memory
    round trip.  x: [N, H, W, Cin] (NHWC); w1: [Cin, Cm]; w2: [3, 3, Cm,
    Cm]; w3: [Cm, Cin]; a*/b*: per-channel affines."""
    _check(x, w1, w2, w3, None, False, batch_tile)
    return _Fused.apply(x, w1, w2, w3, a1, b1, a2, b2, a3, b3)


def fused_bottleneck_proj(x, w1, w2, w3, w4, a1, b1, a2, b2, a3, b3, a4,
                          b4, batch_tile=None):
    """Projection-shortcut stride-1 bottleneck block (ResNet-50 stage-1
    block 0: Cin 64 -> Cout 256 at 56x56).  shortcut = a4 * (x @ w4) +
    b4."""
    _check(x, w1, w2, w3, w4, True, batch_tile)
    return _FusedProj.apply(x, w1, w2, w3, w4, a1, b1, a2, b2, a3, b3, a4,
                            b4)




# ---------------------------------------------------------------------------
# K8: the stride-2 transition block
# ---------------------------------------------------------------------------

def _im2col_s2(p, n, ho, wo, c):
    """Stride-2 3x3 patches of a padded [N, H+2, W+2, C] tensor ->
    [N*Ho*Wo, 9*C] (tap (dy, dx) reads rows dy, dy+2, ..., the
    reference's `_tap2`)."""
    taps = [p[:, dy:dy + 2 * ho:2, dx:dx + 2 * wo:2, :].reshape(
        n * ho * wo, c) for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=1)


def _down_recompute(x, w1, w2, w3, w4, aff):
    """The forward of the Pallas `_fwd_kernel_down` with its rounding
    points: (c0, u0, h0, p, c1, u1, h1, c2, xs2, c4, pre), all f32 but
    h0 and h1 (x's dtype); p the stride-2 patches of h0."""
    dt = x.dtype
    n, h, w, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    ho, wo = h // 2, w // 2
    a1, b1, a2, b2 = aff[0, :cm], aff[1, :cm], aff[2, :cm], aff[3, :cm]
    a3, b3, a4, b4 = (aff[4, :cout], aff[5, :cout], aff[6, :cout],
                      aff[7, :cout])
    c0 = _dot(x.reshape(n * h * w, cin), w1)
    u0 = c0 * a1 + b1
    h0 = torch.clamp_min(u0, 0.0).to(dt)
    p = _im2col_s2(_pad_hw(h0.reshape(n, h, w, cm)), n, ho, wo, cm)
    c1 = _dot(p, w2.reshape(9 * cm, cm))
    u1 = c1 * a2 + b2
    h1 = torch.clamp_min(u1, 0.0).to(dt)
    c2 = _dot(h1, w3)
    xs2 = x[:, ::2, ::2, :].reshape(n * ho * wo, cin)
    c4 = _dot(xs2, w4)
    pre = c2 * a3 + b3 + (c4 * a4 + b4)
    return c0, u0, h0, p, c1, u1, h1, c2, xs2, c4, pre


def fused_bottleneck_down_fwd_ref(x, w1, w2, w3, w4, aff):
    """Plain version of the K8 forward kernel (the Pallas
    `_fwd_kernel_down`): y [N, H/2, W/2, Cout] in x's dtype."""
    n, h, w, _ = x.shape
    pre = _down_recompute(x, w1, w2, w3, w4, aff)[-1]
    return torch.clamp_min(pre, 0.0).to(x.dtype).reshape(
        n, h // 2, w // 2, w3.shape[1])


def fused_bottleneck_down_bwd_ref(x, dy, w1, w2, w3, w4, aff, masks=None,
                                  keep=None):
    """Plain version of the K8 backward kernel (the Pallas
    `_bwd_kernel_down`): recomputes the forward and returns (dx in x's
    dtype, dW1, dW2, dW3, dW4, daff [8, width]), the weight and affine
    grads in f32.  c0, c1, c2, c4 are rounded to x's dtype before the
    affine-grad sums, dc2, dc1, dc0, dc4 before their products; dh0 is
    the stride-2 3x3 conv transposed, and the shortcut's dx lands on the
    even rows and columns only.  `masks` and `keep` as in
    `fused_bottleneck_bwd_ref` (the masks bool [R_in, Cm], [R_out, Cm],
    [R_out, Cout])."""
    dt = x.dtype
    n, h, w, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    ho, wo = h // 2, w // 2
    a1, a2, a3, a4 = aff[0, :cm], aff[2, :cm], aff[4, :cout], aff[6, :cout]
    c0, u0, h0, p, c1, u1, h1, c2, xs2, c4, pre = _down_recompute(
        x, w1, w2, w3, w4, aff)
    c0, c1, c2, c4 = c0.to(dt), c1.to(dt), c2.to(dt), c4.to(dt)
    m0, m1, m2 = masks or (u0 > 0.0, u1 > 0.0, pre > 0.0)
    daff = torch.zeros_like(aff, dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    dyf = dy.reshape(n * ho * wo, cout).float()
    dz3 = torch.where(m2, dyf, zero)
    daff[4, :cout] = (dz3 * c2.float()).sum(0)
    daff[5, :cout] = dz3.sum(0)
    daff[6, :cout] = (dz3 * c4.float()).sum(0)
    daff[7, :cout] = dz3.sum(0)
    dc2 = (dz3 * a3).to(dt)
    dw3 = _dot(h1.t(), dc2)
    dh1 = _dot(dc2, w3.t())
    du1 = torch.where(m1, dh1, zero)
    daff[2, :cm] = (du1 * c1.float()).sum(0)
    daff[3, :cm] = du1.sum(0)
    dc1 = (du1 * a2).to(dt)

    dc4 = (dz3 * a4).to(dt)
    dw4 = _dot(xs2.t(), dc4)
    dx = torch.zeros((n, h, w, cin), dtype=torch.float32, device=x.device)
    dx[:, ::2, ::2, :] = _dot(dc4, w4.t()).reshape(n, ho, wo, cin)

    dw2 = _dot(p.t(), dc1).reshape(w2.shape)
    # the transposed stride-2 conv: tap (dy, dx) of output (i, j) feeds
    # input (2i + dy - 1, 2j + dx - 1), zero padding absorbing the edge
    dh0 = torch.zeros((n, h + 2, w + 2, cm), dtype=torch.float32,
                      device=x.device)
    for ky in range(3):
        for kx in range(3):
            dh0[:, ky:ky + 2 * ho:2, kx:kx + 2 * wo:2, :] += _dot(
                dc1, w2[ky, kx].t()).reshape(n, ho, wo, cm)
    dh0 = dh0[:, 1:h + 1, 1:w + 1, :].reshape(n * h * w, cm)
    du0 = torch.where(m0, dh0, zero)
    daff[0, :cm] = (du0 * c0.float()).sum(0)
    daff[1, :cm] = du0.sum(0)
    dc0 = (du0 * a1).to(dt)
    xm = x.reshape(n * h * w, cin)
    dw1 = _dot(xm.t(), dc0)
    dx = (_dot(dc0, w1.t()).reshape(n, h, w, cin) + dx).to(dt)
    if keep is not None:
        keep.extend([h0, h1, dc0, dc1, dc2, dc4])
    return dx, dw1, dw2, dw3, dw4, daff


def down_plan(n, h, w, cin, cm, cout, dtype, device=None):
    """K8's launch plan on a CUDA device (default: the current one;
    `pt_fused_down_plan`), as `block_plan` gives K7's: per kernel
    (forward, B1, B2) the output rows and pixels of a tile, the blocks,
    the shared memory and the blocks per SM; the K slices of dW1..dW4 and
    the weight-gradient GEMM's items; the float32 partials and the
    backward's scratch in MB (h0, dc0 [R_in, Cm]; h1, dc1 [R_out, Cm];
    dc2, dc4 [R_out, Cout] in the activation dtype, and the partials).
    Planned once per device, geometry and dtype."""
    return dict(_down_plan(_device_index(device), n, h, w, cin, cm, cout,
                           dtype))


@functools.lru_cache(maxsize=None)
def _down_plan(index, n, h, w, cin, cm, cout, dtype):
    lib = backend.load("fused_down", _DOWN_SIGS)
    out = (ctypes.c_longlong * 18)()
    with torch.cuda.device(index):
        status = lib.pt_fused_down_plan(n, h, w, cin, cm, cout,
                                        _DTYPE_CODES[dtype],
                                        ctypes.addressof(out))
    backend.check(status, "fused_down_plan")
    return _plan_dict(list(out), n, h, w, cm, cout, 2, dtype)


def _launch_down_fwd(x, w1, w2, w3, w4, aff):
    _check_launch(x, w1, w2, w3, w4)
    aff = aff.contiguous()
    lib = backend.load("fused_down", _DOWN_SIGS)
    n, h, w, _ = x.shape
    y = torch.empty((n, h // 2, w // 2, w3.shape[1]), dtype=x.dtype,
                    device=x.device)
    with torch.cuda.device(x.device):
        status = lib.pt_fused_down_fwd(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
            w4.data_ptr(), aff.data_ptr(), y.data_ptr(),
            *_dims(x, w1, w3, aff, True)[:-1],
            backend.stream_handle(x.device))
    backend.check(status, "fused_bottleneck_down_fwd")
    backend.LAUNCHES["fused_bottleneck_down_fwd"] += 1
    return y


def _launch_down_bwd(x, dy, w1, w2, w3, w4, aff, keep=None):
    """K8's backward on the card; `keep` as in `_launch_bwd`."""
    _check_launch(x, w1, w2, w3, w4)
    dy, aff = dy.contiguous(), aff.contiguous()
    lib = backend.load("fused_down", _DOWN_SIGS)
    n, h, w, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    r_in, r_out = n * h * w, n * (h // 2) * (w // 2)
    partials = down_plan(n, h, w, cin, cm, cout, x.dtype,
                         x.device)["partials"]
    f32 = dict(dtype=torch.float32, device=x.device)
    act = dict(dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty(w1.shape, **f32), torch.empty(w2.shape, **f32)
    dw3, dw4 = torch.empty(w3.shape, **f32), torch.empty(w4.shape, **f32)
    daff = torch.zeros(aff.shape, **f32)
    # h0, dc0 [R_in, Cm]; h1, dc1 [R_out, Cm]; dc2, dc4 [R_out, Cout];
    # the weight-gradient slices' partials
    scratch = [torch.empty((r_in, cm), **act), torch.empty((r_out, cm), **act),
               torch.empty((r_in, cm), **act), torch.empty((r_out, cm), **act),
               torch.empty((r_out, cout), **act),
               torch.empty((r_out, cout), **act),
               torch.empty(partials, **f32)]
    with torch.cuda.device(x.device):
        status = lib.pt_fused_down_bwd(
            x.data_ptr(), dy.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            w3.data_ptr(), w4.data_ptr(), aff.data_ptr(), dx.data_ptr(),
            dw1.data_ptr(), dw2.data_ptr(), dw3.data_ptr(), dw4.data_ptr(),
            daff.data_ptr(), *(t.data_ptr() for t in scratch),
            *_dims(x, w1, w3, aff, True)[:-1],
            backend.stream_handle(x.device))
    backend.check(status, "fused_bottleneck_down_bwd")
    backend.LAUNCHES["fused_bottleneck_down_bwd"] += 1
    if keep is not None:
        keep.extend(scratch[:6])
    return dx, dw1, dw2, dw3, dw4, daff


class _FusedDown(torch.autograd.Function):
    """Stride-2 transition block: forward K8 fwd, backward K8 bwd."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, w4, a1, b1, a2, b2, a3, b3, a4, b4):
        aff = _pack_affines((a1, b1, a2, b2, a3, b3, a4, b4), w3.shape[1])
        ctx.save_for_backward(x, w1, w2, w3, w4, aff)
        ctx.adtype = a1.dtype
        if x.device.type == "cpu":
            return fused_bottleneck_down_fwd_ref(x, w1, w2, w3, w4, aff)
        return _launch_down_fwd(x, w1, w2, w3, w4, aff)

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, w3, w4, aff = ctx.saved_tensors
        cm = w1.shape[1]
        bwd = (fused_bottleneck_down_bwd_ref if x.device.type == "cpu"
               else _launch_down_bwd)
        dx, dw1, dw2, dw3, dw4, daff = bwd(x, dy, w1, w2, w3, w4, aff)
        daff = daff.to(ctx.adtype)
        return (dx, dw1.to(w1.dtype), dw2.to(w2.dtype), dw3.to(w3.dtype),
                dw4.to(w4.dtype), daff[0, :cm], daff[1, :cm], daff[2, :cm],
                daff[3, :cm], daff[4], daff[5], daff[6], daff[7])


def _check_even(name, t):
    if t.dim() != 4 or t.shape[1] % 2 or t.shape[2] % 2:
        raise ValueError(f"{name}: needs an NHWC input with even H and W, "
                         f"got {tuple(t.shape)}")


def fused_bottleneck_down(x, w1, w2, w3, w4, a1, b1, a2, b2, a3, b3, a4,
                          b4, batch_tile=None):
    """Stride-2 transition bottleneck block (3x3 stride-2 conv1 and a 1x1
    stride-2 projection shortcut): [N, H, W, Cin] -> [N, H/2, W/2,
    Cout], H and W even.  w1: [Cin, Cm]; w2: [3, 3, Cm, Cm] (HWIO); w3:
    [Cm, Cout]; w4: [Cin, Cout]; a*/b*: per-channel affines."""
    _check_even("fused_bottleneck_down", x)
    _check(x, w1, w2, w3, w4, True, batch_tile)
    return _FusedDown.apply(x, w1, w2, w3, w4, a1, b1, a2, b2, a3, b3, a4,
                            b4)


# ---------------------------------------------------------------------------
# K9: the stem tail, relu(c * a + b) then a 3x3 stride-2 max-pool, pad 1
# ---------------------------------------------------------------------------

def _pool_s2(hp, ho, wo):
    """Max over the nine stride-2 taps of a padded [N, H+2, W+2, C]."""
    out = None
    for dy in range(3):
        for dx in range(3):
            sl = hp[:, dy:dy + 2 * ho:2, dx:dx + 2 * wo:2, :]
            out = sl if out is None else torch.maximum(out, sl)
    return out


def fused_stem_tail_fwd_ref(c, aff):
    """Plain version of the K9 forward kernel (the Pallas
    `_stem_fwd_kernel`): h = relu(f32(c) * a + b) rounded to c's dtype,
    zero-padded (h >= 0, so the pad never wins), pooled."""
    n, h, w, _ = c.shape
    hh = torch.clamp_min(c.float() * aff[0] + aff[1], 0.0).to(c.dtype)
    return _pool_s2(_pad_hw(hh), h // 2, w // 2)


def fused_stem_tail_bwd_ref(c, dy, aff):
    """Plain version of the K9 backward kernel (the Pallas
    `_stem_bwd_kernel`): recomputes h and the pooled y in c's dtype, then
    every element equal to its window's max receives that window's dy
    (summed in f32 over the <= 4 windows that cover it, in the
    reference's order), then the relu mask.  Returns (dc in c's dtype,
    daff [2, C] f32)."""
    n, h, w, cm = c.shape
    ho, wo = h // 2, w // 2
    a, b = aff[0], aff[1]
    cf = c.float()
    u = cf * a + b
    hh = torch.clamp_min(u, 0.0).to(c.dtype)
    yp = _pad_hw(_pool_s2(_pad_hw(hh), ho, wo))
    dyp = _pad_hw(dy.float())
    zero = torch.zeros((), dtype=torch.float32, device=c.device)
    dh = torch.empty((n, h, w, cm), dtype=torch.float32, device=c.device)
    # phase (pr, pc) of h is covered by windows (dy_, dx_) with dy_ = pr+1
    # and dx_ = pc+1 (mod 2), at padded window offset 1 + (pr+1-dy_)//2
    for pr in (0, 1):
        for pc in (0, 1):
            h_ph = hh[:, pr::2, pc::2, :]
            acc = torch.zeros((n, ho, wo, cm), dtype=torch.float32,
                              device=c.device)
            for ky in range(3):
                if ky % 2 != (pr + 1) % 2:
                    continue
                for kx in range(3):
                    if kx % 2 != (pc + 1) % 2:
                        continue
                    ro, co = 1 + (pr + 1 - ky) // 2, 1 + (pc + 1 - kx) // 2
                    ysl = yp[:, ro:ro + ho, co:co + wo, :]
                    dsl = dyp[:, ro:ro + ho, co:co + wo, :]
                    acc = acc + torch.where(h_ph == ysl, dsl, zero)
            dh[:, pr::2, pc::2, :] = acc
    du = torch.where(u > 0.0, dh, zero)
    daff = torch.stack([(du * cf).sum((0, 1, 2)), du.sum((0, 1, 2))])
    return (du * a).to(c.dtype), daff


def _check_stem_launch(c):
    vec = 16 // c.element_size()
    if c.shape[3] % vec or 256 % (c.shape[3] // vec):
        raise ValueError(f"fused_stem_tail: the CUDA kernel needs C a "
                         f"multiple of {vec} with C/{vec} dividing 256, got "
                         f"{c.shape[3]}")
    if not c.is_contiguous() or c.data_ptr() % 16:
        raise ValueError("fused_stem_tail: the CUDA kernel needs a "
                         "contiguous, 16-byte aligned input")


def _launch_stem_fwd(c, aff):
    _check_stem_launch(c)
    lib = backend.load("fused_stem_tail", _STEM_SIGS)
    n, h, w, cm = c.shape
    y = torch.empty((n, h // 2, w // 2, cm), dtype=c.dtype, device=c.device)
    with torch.cuda.device(c.device):
        status = lib.pt_fused_stem_tail_fwd(
            c.data_ptr(), aff.contiguous().data_ptr(), y.data_ptr(), n, h,
            w, cm, _DTYPE_CODES[c.dtype], backend.stream_handle(c.device))
    backend.check(status, "fused_stem_tail_fwd")
    backend.LAUNCHES["fused_stem_tail_fwd"] += 1
    return y


def stem_tiling(shape, dtype, tiling=None):
    """K9 backward's tiling of c [N, H, W, C] in `dtype`: (R window rows,
    Q window columns, 16-byte channel vectors per block), `tiling` or
    STEM_BWD_TILING clamped to the output's size and to C."""
    rows, cols, vecs = tiling or STEM_BWD_TILING[dtype]
    _, h, w, cm = shape
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return min(rows, h // 2), min(cols, w // 2), min(vecs, cm // vec)


# per (device index, shape, dtype, tiling): K9 backward's plan
_STEM_PLANS = {}


def stem_plan(shape, dtype, tiling=None, device=None):
    """K9 backward's launch plan for c [N, H, W, C] on the card: the
    tiling (rows, cols, vecs; chans = channels per block), grid, blocks
    per SM, shared memory bytes, spatial tiles and channel groups."""
    device = torch.device(device or "cuda")
    rows, cols, vecs = stem_tiling(shape, dtype, tiling)
    key = (device.index, tuple(shape), dtype, (rows, cols, vecs))
    if key not in _STEM_PLANS:
        lib = backend.load("fused_stem_tail", _STEM_SIGS)
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(device):
            status = lib.pt_fused_stem_tail_plan(
                *shape, rows, cols, vecs, _DTYPE_CODES[dtype], out)
        backend.check(status, "fused_stem_tail_plan")
        vec = 16 // torch.empty((), dtype=dtype).element_size()
        _STEM_PLANS[key] = dict(
            rows=rows, cols=cols, vecs=vecs, chans=vecs * vec, grid=out[0],
            blocks_per_sm=out[1], smem=out[2], tiles=out[3], groups=out[4])
    return _STEM_PLANS[key]


# per (device index, stream): K9 backward's partials and its arrival
# counter (zeroed once; every launch leaves it 0); a set outgrown is kept
# alive behind the new one, since a CUDA graph that captured a launch
# keeps its pointers
_STEM_SCRATCH = {}


def _stem_scratch(device, stream, floats):
    held = _STEM_SCRATCH.setdefault((device.index, stream.value), [])
    if not held or held[-1][0].numel() < floats:
        size = max(floats, 2 * held[-1][0].numel()) if held else floats
        held.append((torch.empty(size, dtype=torch.float32, device=device),
                     torch.zeros(1, dtype=torch.int32, device=device)))
    return held[-1]


def _launch_stem_bwd(c, dy, aff, tiling=None):
    _check_stem_launch(c)
    dy, aff = dy.contiguous(), aff.contiguous()
    if dy.data_ptr() % 16:
        raise ValueError("fused_stem_tail: the CUDA kernel needs a 16-byte "
                         "aligned dy")
    plan = stem_plan(c.shape, c.dtype, tiling, c.device)
    lib = backend.load("fused_stem_tail", _STEM_SIGS)
    n, h, w, cm = c.shape
    dc = torch.empty_like(c)
    daff = torch.empty((2, cm), dtype=torch.float32, device=c.device)
    with torch.cuda.device(c.device):
        stream = backend.stream_handle(c.device)
        part, counter = _stem_scratch(c.device, stream,
                                      plan["grid"] * 2 * plan["chans"])
        status = lib.pt_fused_stem_tail_bwd(
            c.data_ptr(), dy.data_ptr(), aff.data_ptr(), dc.data_ptr(),
            daff.data_ptr(), part.data_ptr(), counter.data_ptr(), n, h, w,
            cm, plan["rows"], plan["cols"], plan["vecs"], plan["grid"],
            _DTYPE_CODES[c.dtype], stream)
    backend.check(status, "fused_stem_tail_bwd")
    backend.LAUNCHES["fused_stem_tail_bwd"] += 1
    return dc, daff


class _StemTail(torch.autograd.Function):
    """The stem tail: forward K9 fwd, backward K9 bwd (equality
    routing)."""

    @staticmethod
    def forward(ctx, c, a, b):
        aff = torch.stack([a.float(), b.float()])
        ctx.save_for_backward(c, aff)
        ctx.adtype = a.dtype
        if c.device.type == "cpu":
            return fused_stem_tail_fwd_ref(c, aff)
        return _launch_stem_fwd(c, aff)

    @staticmethod
    def backward(ctx, dy):
        c, aff = ctx.saved_tensors
        bwd = (fused_stem_tail_bwd_ref if c.device.type == "cpu"
               else _launch_stem_bwd)
        dc, daff = bwd(c, dy, aff)
        daff = daff.to(ctx.adtype)
        return dc, daff[0], daff[1]


def _stem_tail_composition(c, a, b):
    """The reference's `_stem_tail_xla`: relu(c * a + b) in f32, rounded,
    then a 3x3 stride-2 max-pool (pad 1) whose gradient goes to the first
    maximum of each window."""
    from ..ops import nn_ops

    u = c.float() * a + b
    hh = torch.maximum(u, torch.zeros((), dtype=u.dtype, device=u.device))
    return nn_ops.pool2d({"X": hh.to(c.dtype)}, {
        "pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
        "paddings": [1, 1], "data_format": "NHWC"})["Out"]


def fused_stem_tail(c, a, b, batch_tile=None):
    """relu(c * a + b) -> 3x3 stride-2 max-pool (pad 1), the ResNet
    stem's batch-norm, relu and pool tail.  c: [N, H, W, Cm] (H, W even);
    a, b: per-channel affines.  Sides above 112 take the reference's
    composition (see the module docstring); the kernel takes any even
    side."""
    _check_even("fused_stem_tail", c)
    if batch_tile is not None and c.shape[0] % batch_tile:
        raise ValueError(f"batch_tile={batch_tile} does not divide batch "
                         f"{c.shape[0]}")
    if c.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_stem_tail: dtype {c.dtype} not in "
                        "float32/bfloat16")
    if max(c.shape[1], c.shape[2]) > _STEM_SIDE_LIMIT:
        return _stem_tail_composition(c, a, b)
    return _StemTail.apply(c, a, b)
