"""Fused ResNet bottleneck block for Hopper: K7, forward and backward.

Port of paddle_tpu/kernels/fused_bottleneck.py (`fused_bottleneck` :399,
`fused_bottleneck_proj` :436).  The kernels are CUDA C++ in
`paddle_tpu_torch/csrc/fused_bottleneck.cu` (built and bound by
`backend`): one forward kernel (the Pallas `_fwd_kernel` :180, `_fwd`
:335) and a backward entry (the Pallas `_bwd_kernel` :205, `_bwd` :357)
that runs its two kernels in a row.  A stride-1 block over NHWC rows,
f32 accumulation, the activations rounded to x's dtype where the Pallas
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

K8 (`fused_bottleneck_down`) and K9 (`fused_stem_tail`) are not ported
yet: they raise NotImplementedError (ROADMAP queue 2).
"""

import ctypes

import torch
import torch.nn.functional as TF

from . import backend

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "pt_fused_bottleneck_fwd": [_P] * 7 + [_I] * 9 + [_P],
    "pt_fused_bottleneck_bwd": [_P] * 15 + [_I] * 9 + [_P],
}
_UNPORTED = ("{} (K8/K9) is not ported to the PyTorch/H100 port yet: "
             "ROADMAP queue 2")


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


def fused_bottleneck_bwd_ref(x, dy, w1, w2, w3, w4, aff, proj):
    """Plain version of the backward kernel (the Pallas `_bwd_kernel`):
    recomputes the forward and returns (dx in x's dtype, dW1, dW2, dW3,
    dW4, daff [8, width]), the weight and affine grads in f32 (dW4 is
    None for the identity block).  c0, c1, c2, c4 are rounded to x's
    dtype before the affine-grad sums, dc2, dc1, dc0, dc4 before their
    products, as in the reference."""
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

    # the backward chain
    dyf = dy.reshape(r, cout).float()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    dz3 = torch.where(pre > 0.0, dyf, zero)
    daff[4, :cout] = (dz3 * c2.float()).sum(0)
    daff[5, :cout] = dz3.sum(0)
    dc2 = (dz3 * a3).to(dt)
    dw3 = _dot(h1.t(), dc2)
    dh1 = _dot(dc2, w3.t())
    du1 = torch.where(u1 > 0.0, dh1, zero)
    daff[2, :cm] = (du1 * c1.float()).sum(0)
    daff[3, :cm] = du1.sum(0)
    dc1 = (du1 * a2).to(dt)
    dw2 = _dot(p.t(), dc1).reshape(w2.shape)
    pr = _im2col(_pad_hw(dc1.reshape(n, h, w, cm)), n, h, w, cm)
    w2t = w2.flip(0, 1).transpose(2, 3).reshape(9 * cm, cm)
    dh0 = _dot(pr, w2t)
    du0 = torch.where(u0 > 0.0, dh0, zero)
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


def _check_launch(x, *ws):
    cm = ws[0].shape[1]
    if cm & (cm - 1):
        raise ValueError(f"fused_bottleneck: the CUDA kernel needs Cm a "
                         f"power of two, got {cm}")
    for t in (x,) + ws:
        if not t.is_contiguous():
            raise ValueError("fused_bottleneck: the CUDA kernel needs "
                             "contiguous inputs")


def _dims(x, w1, w3, aff, proj):
    n, h, w, cin = x.shape
    return (n, h, w, cin, w1.shape[1], w3.shape[1], aff.shape[1],
            _DTYPE_CODES[x.dtype], int(proj))


def _launch_fwd(x, w1, w2, w3, w4, aff, proj):
    w4 = w4 if proj else w1          # never read by the identity kernel
    _check_launch(x, w1, w2, w3, w4)
    aff = aff.contiguous()
    lib = backend.load("fused_bottleneck", _SIGS)
    n, h, w, _ = x.shape
    y = torch.empty((n, h, w, w3.shape[1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.pt_fused_bottleneck_fwd(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(),
            w4.data_ptr(), aff.data_ptr(), y.data_ptr(),
            *_dims(x, w1, w3, aff, proj), backend.stream_handle(x.device))
    backend.check(status, "fused_bottleneck_fwd")
    backend.LAUNCHES["fused_bottleneck_fwd"] += 1
    return y


def _launch_bwd(x, dy, w1, w2, w3, w4, aff, proj):
    w4 = w4 if proj else w1
    _check_launch(x, w1, w2, w3, w4)
    dy, aff = dy.contiguous(), aff.contiguous()
    lib = backend.load("fused_bottleneck", _SIGS)
    n, h, w, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw1 = torch.zeros(w1.shape, **f32)
    dw2 = torch.zeros(w2.shape, **f32)
    dw3 = torch.zeros(w3.shape, **f32)
    dw4 = torch.zeros(w4.shape, **f32) if proj else dw1
    daff = torch.zeros(aff.shape, **f32)
    dc1 = torch.empty((n * h * w, cm), dtype=x.dtype, device=x.device)
    mask = torch.empty((n * h * w, cout), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.pt_fused_bottleneck_bwd(
            x.data_ptr(), dy.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            w3.data_ptr(), w4.data_ptr(), aff.data_ptr(), dx.data_ptr(),
            dw1.data_ptr(), dw2.data_ptr(), dw3.data_ptr(), dw4.data_ptr(),
            daff.data_ptr(), dc1.data_ptr(), mask.data_ptr(),
            *_dims(x, w1, w3, aff, proj), backend.stream_handle(x.device))
    backend.check(status, "fused_bottleneck_bwd")
    backend.LAUNCHES["fused_bottleneck_bwd"] += 1
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


def fused_bottleneck_down(*args, **kwargs):
    """The stride-2 transition block (K8): not ported yet."""
    raise NotImplementedError(_UNPORTED.format("fused_bottleneck_down"))


def fused_stem_tail(*args, **kwargs):
    """The stem's BN affine + relu + max-pool tail (K9): not ported yet."""
    raise NotImplementedError(_UNPORTED.format("fused_stem_tail"))
