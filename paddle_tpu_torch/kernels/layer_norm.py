"""K4 / K5: fused LayerNorm forward and backward for Hopper, in Triton.

Port of paddle_tpu/kernels/layer_norm.py: K4 replaces `_fwd_kernel`
(driven by `_fwd`), K5 replaces `_bwd_kernel` (driven by `_bwd`); public
as `fused_layer_norm` / `layer_norm_fused` (the reference's
`fused_layer_norm` / `layer_norm_pallas`).

K4 computes, for each row of a [rows, D] input, the mean and biased
variance in f32 and writes y = (x - mean) * rstd * gamma + beta in the
input dtype; the statistics are not stored.  `fused_layer_norm` is a
`torch.autograd.Function` (`_LayerNorm`, the counterpart of the
reference's custom VJP): forward K4, saving x and gamma only; backward
K5, which recomputes mean and rstd from x and writes
dx = rstd * (wdy - mean(wdy) - xhat * mean(wdy * xhat)), wdy = dy * gamma,
plus per-program f32 partial sums of dgamma = sum(dy * xhat) and
dbeta = sum(dy).

K4 design.  One Triton program per row holds the whole row in one
masked block of next_pow2(D) lanes, so x is read once and y written
once; the two reductions run on the block in registers.

K5 design.  Each program takes a block of ROWS consecutive rows and
walks them one at a time with the whole row in one masked block of
next_pow2(D) lanes: it recomputes the statistics, writes dx, and adds
the row's dy * xhat and dy to two [BLOCK] f32 accumulators in
registers.  At the end it writes them to row `pid` of two f32
[n_programs, D] scratch arrays, which the wrapper sums with torch, as
the reference sums its [groups, D] accumulator outside the kernel: no
atomics, so the sums are deterministic.  ROWS trades the scratch's size
against parallelism: it is the power of two that gives at least
`_MIN_PROGRAMS` programs, at most 32 (the train step's 24576 rows take
32, so the scratch is 1/(12 * 32) of x's bytes in bf16), since a
program's rows run one after another.  Padded rows and columns are
masked with `tl.where`, never a multiply, so NaN padding cannot leak.

Bound on the H100: device-memory bytes for both kernels.  K4 reads x
and writes y once, about 2 * rows * D * bytes; K5 reads x and dy and
writes dx, about 3 * rows * D * bytes plus the scratch (2 * 4 * D
bytes per program).  At the serving shapes (rows = slots or batch *
seq, D = 768) the launch itself costs as much as the data; fusing the
norm into its neighbours is later work.

Triton serves as well as CUDA C++ here: each kernel is row reductions
and an elementwise pass, needs no tensor cores and no hand staging of
shared memory.  `triton` is imported inside the function that builds
the kernels, never when this module is imported, so the CPU tests
import it freely.  On CPU tensors the Function runs the plain versions
`layer_norm_ref` and `layer_norm_bwd_ref`.
"""

import torch

from . import backend

# triton.language, bound by _kernel() at the first launch
tl = None
_KERNEL = None
_DTYPES = (torch.float32, torch.bfloat16)
# K5: at most this many rows per program (a power of two), and about
# two programs per SM of an H100 where the rows allow
_MAX_ROWS = 32
_MIN_PROGRAMS = 264


def _bwd_rows(rows):
    r = 1
    while r < _MAX_ROWS and rows >= 2 * r * _MIN_PROGRAMS:
        r *= 2
    return r


def _kernel():
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as language

        tl = language

        @triton.jit
        def _ln_fwd_kernel(x_ptr, g_ptr, b_ptr, y_ptr, d, eps,
                           BLOCK: tl.constexpr):
            row = tl.program_id(0).to(tl.int64)
            cols = tl.arange(0, BLOCK)
            mask = cols < d
            x = tl.load(x_ptr + row * d + cols, mask=mask,
                        other=0.0).to(tl.float32)
            mean = tl.sum(x, axis=0) / d
            xc = tl.where(mask, x - mean, 0.0)
            var = tl.sum(xc * xc, axis=0) / d
            rstd = tl.rsqrt(var + eps)
            g = tl.load(g_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            b = tl.load(b_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = xc * rstd * g + b
            tl.store(y_ptr + row * d + cols,
                     y.to(y_ptr.dtype.element_ty), mask=mask)

        @triton.jit
        def _ln_bwd_kernel(x_ptr, g_ptr, dy_ptr, dx_ptr, dg_ptr, db_ptr,
                           rows, d, eps, ROWS: tl.constexpr,
                           BLOCK: tl.constexpr):
            pid = tl.program_id(0)
            cols = tl.arange(0, BLOCK)
            cmask = cols < d
            g = tl.load(g_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
            dg_acc = tl.zeros([BLOCK], dtype=tl.float32)
            db_acc = tl.zeros([BLOCK], dtype=tl.float32)
            for i in range(ROWS):
                row = pid.to(tl.int64) * ROWS + i
                mask = cmask & (row < rows)
                off = row * d + cols
                x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + off, mask=mask,
                             other=0.0).to(tl.float32)
                mean = tl.sum(x, axis=0) / d
                xc = tl.where(mask, x - mean, 0.0)
                var = tl.sum(xc * xc, axis=0) / d
                rstd = tl.rsqrt(var + eps)
                xhat = xc * rstd
                wdy = tl.where(mask, dy * g, 0.0)
                c1 = tl.sum(wdy, axis=0) / d
                c2 = tl.sum(wdy * xhat, axis=0) / d
                dx = rstd * (wdy - c1 - xhat * c2)
                tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty),
                         mask=mask)
                dg_acc += tl.where(mask, dy * xhat, 0.0)
                db_acc += tl.where(mask, dy, 0.0)
            tl.store(dg_ptr + pid * d + cols, dg_acc, mask=cmask)
            tl.store(db_ptr + pid * d + cols, db_acc, mask=cmask)

        _KERNEL = (triton, _ln_fwd_kernel, _ln_bwd_kernel)
    return _KERNEL


def _check(x, gamma, beta):
    if x.dim() != 2:
        raise ValueError(f"fused_layer_norm: x must be [rows, D], got "
                         f"{tuple(x.shape)}")
    d = x.shape[1]
    if d % 128:
        raise ValueError(f"fused_layer_norm: needs D % 128 == 0, got {d}")
    if tuple(gamma.shape) != (d,) or tuple(beta.shape) != (d,):
        raise ValueError(f"fused_layer_norm: gamma/beta must be [{d}]")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_layer_norm: dtype {x.dtype} not in "
                        "float32/bfloat16")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("fused_layer_norm: inputs on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")


def layer_norm_ref(x, gamma, beta, eps=1e-5):
    """Plain version of K4: f32 mean / biased variance over the last
    axis, y = (x - mean) * rsqrt(var + eps) * gamma + beta in x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    return y.to(x.dtype)


def _check_contiguous(tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_layer_norm: the kernel needs contiguous "
                         "inputs")


def _launch(x, gamma, beta, eps):
    _check_contiguous((x, gamma, beta))
    triton, kernel, _ = _kernel()
    rows, d = x.shape
    y = torch.empty_like(x)
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(rows,)](x, gamma, beta, y, d, float(eps), BLOCK=block,
                        num_warps=4 if block <= 1024 else 8)
    backend.LAUNCHES["layer_norm_fwd"] += 1
    return y


def layer_norm_bwd_ref(x, gamma, dy, eps=1e-5):
    """Plain version of K5: statistics recomputed from x in f32, then
    dx = rstd * (wdy - mean(wdy) - xhat * mean(wdy * xhat)) in x.dtype
    and dgamma = sum(dy * xhat), dbeta = sum(dy) over the rows in f32."""
    xf, dyf = x.float(), dy.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = xc * rstd
    wdy = dyf * gamma.float()
    c1 = wdy.mean(dim=-1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (wdy - c1 - xhat * c2)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def _launch_bwd(x, gamma, dy, eps):
    _check_contiguous((x, gamma, dy))
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"fused_layer_norm backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} does not match x {tuple(x.shape)} "
                         f"{x.dtype}")
    triton, _, kernel = _kernel()
    rows, d = x.shape
    dx = torch.empty_like(x)
    per_program = _bwd_rows(rows)
    programs = triton.cdiv(rows, per_program)
    dg = torch.empty((programs, d), dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg)
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(programs,)](x, gamma, dy, dx, dg, db, rows, d, float(eps),
                            ROWS=per_program, BLOCK=block,
                            num_warps=4 if block <= 1024 else 8)
    backend.LAUNCHES["layer_norm_bwd"] += 1
    return dx, dg.sum(dim=0), db.sum(dim=0)


def _fwd(x, gamma, beta, eps):
    if x.device.type == "cpu":
        return layer_norm_ref(x, gamma, beta, eps)
    return _launch(x, gamma, beta, eps)


class _LayerNorm(torch.autograd.Function):
    """y = LayerNorm(x; gamma, beta): forward K4, backward K5.  Saves x
    and gamma only; the backward recomputes mean and rstd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        return _fwd(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dy = dy.contiguous()
        if x.device.type == "cpu":
            dx, dg, db = layer_norm_bwd_ref(x, gamma, dy, ctx.eps)
        else:
            dx, dg, db = _launch_bwd(x, gamma, dy, ctx.eps)
        return dx, dg.to(gamma.dtype), db.to(gamma.dtype), None


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of a 2-D [rows, D] input,
    differentiable in x, gamma and beta.  A call that records no
    gradient skips the Function's bookkeeping (the decode loop)."""
    _check(x, gamma, beta)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _LayerNorm.apply(x, gamma, beta, float(eps))
    return _fwd(x, gamma, beta, float(eps))


def layer_norm_fused(x, gamma, beta, eps=1e-5):
    """Any-rank wrapper (counterpart of `layer_norm_pallas`): normalizes
    over the last axis."""
    shape = x.shape
    y = fused_layer_norm(x.reshape(-1, shape[-1]), gamma, beta, eps)
    return y.reshape(shape)
