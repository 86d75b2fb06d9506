"""K4 / K5: fused LayerNorm forward (Triton) and backward (CUDA C++), Hopper.

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
and dgamma = sum(dy * xhat), dbeta = sum(dy) over the rows.

K4 design (Triton).  One program per row holds the whole row in one
masked block of next_pow2(D) lanes, so x is read once and y written
once; the two reductions run on the block in registers.  Triton serves
here as well as CUDA C++: one row reduction and an elementwise pass.
`triton` is imported inside `_kernel()`, never when this module is
imported, so the CPU tests import it freely.

K5 design (CUDA C++, `csrc/layer_norm_bwd.cu`): one launch per call and
no torch op beside it.  A warp (a team of `warps_per_row` warps for wide
rows) owns a row held in registers; its three reductions are shuffle
butterflies; persistent blocks of 8 warps load the next row before the
current row's math; dgamma/dbeta are summed per thread over its rows,
per block in team order, then merged in groups of G blocks and across
groups by the last blocks to arrive (atomic tickets), in one fixed order
per plan, and written in the dtype asked for.  `ln_bwd_plan` sets the
plan from the rows, D, the dtype and the SM count; `_ln_bwd_plan_model`
is that plan's order of sums in f32 torch (the tests' and the chip
run's yardstick).  The partial rows and the tickets live in a workspace
kept per device and stream (`_bwd_work`).

Bound on the H100: device-memory bytes for both kernels.  K4 reads x
and writes y once, about 2 * rows * D * bytes; K5 reads x and dy and
writes dx, about 3 * rows * D * bytes.  At the serving shapes (rows =
slots or batch * seq, D = 768) the launch itself costs as much as the
data.

On CPU tensors the Function runs the plain versions `layer_norm_ref` and
`layer_norm_bwd_ref`.
"""

import collections
import ctypes
import math

import torch

from . import backend

# triton.language, bound by _kernel() at the first launch
tl = None
_KERNEL = None
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# K5's plan (csrc/layer_norm_bwd.cu): warps per block; the most 16-byte
# vectors of a row a thread holds in registers (kMaxVecs*); the blocks per
# SM each kernel's registers allow (kBlocks*: __launch_bounds__), by vectors
# per thread, index 0 the wide kernel (rows wider than 8 warps' registers);
# float16 runs the bf16 kernels' instantiation for __half, with their plan
LN_BWD_WARPS = 8
LN_BWD_MAX_VECS = {torch.float32: 6, torch.bfloat16: 4, torch.float16: 4}
LN_BWD_BLOCKS_PER_SM = {torch.float32: (2, 4, 3, 2, 2, 1, 1),
                        torch.bfloat16: (2, 4, 2, 2, 1),
                        torch.float16: (2, 4, 2, 2, 1)}
_BWD_SIGS = {
    "pt_layer_norm_bwd": [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    "pt_layer_norm_bwd_occupancy": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int)],
}
# per (device index, stream): K5's workspace, (f32 partial and group rows,
# int32 tickets zeroed once; every launch leaves them 0); one outgrown is
# kept alive behind the new one, since a CUDA graph that captured a launch
# keeps its pointers
_BWD_WORK = {}

LnBwdPlan = collections.namedtuple("LnBwdPlan", (
    "vecs_per_thread",   # 16-byte vectors per thread; 0: the wide kernel
    "warps_per_row",
    "warps_per_block",
    "blocks",
    "stages",            # rows in flight per team (the current, the next)
    "group",             # blocks per merge group
    "groups",
    "smem",              # dynamic shared memory bytes per block
))


def ln_bwd_plan(rows, d, dtype, sms, warps_per_row=None):
    """K5's launch plan for x [rows, d] of `dtype` on a card of `sms` SMs.

    A team of `warps_per_row` warps owns a row: the fewest (1, 2, 4 or 8)
    whose threads hold the row's 16-byte vectors in at most
    LN_BWD_MAX_VECS each; wider rows take the wide kernel (one team of 8
    warps per block, `vecs_per_thread` 0).  `warps_per_row` forces a team
    size instead (the chip run's sweep).  Blocks of 8 warps, as many as
    the rows need, at most the blocks per SM the kernel is held to times
    `sms`; team g of the grid takes rows g, g + teams, ...  Merge groups of
    G = ceil(sqrt(blocks)) blocks."""
    nvec = d * dtype.itemsize // 16
    most = LN_BWD_MAX_VECS[dtype]
    if warps_per_row is None:
        w = 1
        while w < LN_BWD_WARPS and -(-nvec // (32 * w)) > most:
            w *= 2
    elif warps_per_row in (1, 2, 4, 8):
        w = warps_per_row
    else:
        raise ValueError(f"ln_bwd_plan: warps_per_row {warps_per_row} not "
                         "in 1, 2, 4, 8")
    nv = -(-nvec // (32 * w))
    if nv > most:
        w, nv = LN_BWD_WARPS, 0
    teams = LN_BWD_WARPS // w
    blocks = max(1, min(-(-rows // teams),
                        sms * LN_BWD_BLOCKS_PER_SM[dtype][nv]))
    group = math.isqrt(blocks - 1) + 1
    # gamma as f32; with several teams, then their sums [2, d]
    smem = 0 if nv == 0 else (8 if teams > 1 else 4) * d
    return LnBwdPlan(nv, w, LN_BWD_WARPS, blocks, 2 if nv else 1, group,
                     -(-blocks // group), smem)


def _ln_bwd_teams(plan, rows):
    """[teams in the grid, k] int64: the rows of each team in the order it
    takes them (team g: g, g + teams, ...), -1 past the last row."""
    teams = plan.blocks * plan.warps_per_block // plan.warps_per_row
    k = -(-rows // teams)
    idx = torch.arange(k * teams).reshape(k, teams).T
    return torch.where(idx < rows, idx, -1)


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

        _KERNEL = (triton, _ln_fwd_kernel)
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
                        "float32/bfloat16/float16")
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
    triton, kernel = _kernel()
    rows, d = x.shape
    y = torch.empty_like(x)
    block = triton.next_power_of_2(d)
    with torch.cuda.device(x.device):
        kernel[(rows,)](x, gamma, beta, y, d, float(eps), BLOCK=block,
                        num_warps=4 if block <= 1024 else 8)
    backend.count_launch("layer_norm_fwd", x.dtype)
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


def _ln_bwd_plan_model(x, gamma, dy, plan, eps=1e-5):
    """K5's sums in the order of `plan`, in f32 torch (any device):
    (dx in x.dtype, dgamma, dbeta in f32).

    Thread (w, lane) of a row's team holds the vectors j * 32 W + 32 w +
    lane of the row (16 bytes each, zeros past D); each row reduction sums
    a thread's values in (vector, element) order, then the lanes by the
    xor butterfly, then the team's warps in warp order.  dgamma/dbeta:
    each team sums its rows (`_ln_bwd_teams`) in order, a block its teams
    in team order (a block with no rows gives zeros), a merge group of G
    its blocks in block order, then the groups in group order.  The
    kernel contracts some products into FMAs where this rounds twice."""
    rows, d = x.shape
    vec = 16 // x.element_size()
    w, tpr = plan.warps_per_row, 32 * plan.warps_per_row
    nv = -(-(d // vec) // tpr)
    width = nv * tpr * vec

    def own(a):
        a = torch.nn.functional.pad(a, (0, width - d))
        return a.reshape(a.shape[0], nv, w, 32, vec)

    lane = torch.arange(32, device=x.device)

    def team_sum(v):
        s = torch.zeros(v.shape[0], w, 32, device=x.device)
        for j in range(nv):
            for e in range(vec):
                s = s + v[:, j, :, :, e]
        for o in (16, 8, 4, 2, 1):
            s = s + s[..., lane ^ o]
        out = s[:, 0, 0]
        for q in range(1, w):
            out = out + s[:, q, 0]
        return out[:, None, None, None, None]

    xs, dys = own(x.float()), own(dy.float())
    gs = own(gamma.float()[None])
    live = own(torch.ones(1, d, device=x.device)) > 0
    mean = team_sum(xs) / d
    xc = torch.where(live, xs - mean, 0.0)
    rstd = torch.rsqrt(team_sum(xc * xc) / d + eps)
    xhat = xc * rstd
    wdy = dys * gs
    c1, c2 = team_sum(wdy) / d, team_sum(wdy * xhat) / d
    dx = (rstd * (wdy - c1 - xhat * c2)).reshape(rows, width)[:, :d]

    terms = torch.stack([(dys * xhat).reshape(rows, width)[:, :d],
                         dys.reshape(rows, width)[:, :d]], 1)
    terms = torch.cat([terms, terms.new_zeros(1, 2, d)])   # row -1: none
    order = _ln_bwd_teams(plan, rows).to(x.device)
    acc = terms.new_zeros(order.shape[0], 2, d)
    for i in range(order.shape[1]):
        acc = acc + terms[order[:, i]]
    acc = acc.reshape(plan.blocks, -1, 2, d)
    part = acc[:, 0]
    for q in range(1, acc.shape[1]):
        part = part + acc[:, q]
    part = torch.cat([part, part.new_zeros(
        plan.groups * plan.group - plan.blocks, 2, d)])
    part = part.reshape(plan.groups, plan.group, 2, d)
    grow = part[:, 0]
    for b in range(1, plan.group):
        grow = grow + part[:, b]
    out = grow[0]
    for g in range(1, plan.groups):
        out = out + grow[g]
    return dx.to(x.dtype), out[0], out[1]


def _bwd_work(device, stream, plan, d):
    """K5's workspace on (device, stream) for `plan` at width d: (f32
    partial and group rows, int32 tickets)."""
    floats, tickets = (plan.blocks + plan.groups) * 2 * d, plan.groups + 1
    held = _BWD_WORK.setdefault((device.index, stream.value), [])
    if not held or held[-1][0].numel() < floats \
            or held[-1][1].numel() < tickets:
        if held:
            floats = max(floats, 2 * held[-1][0].numel())
            tickets = max(tickets, 2 * held[-1][1].numel())
        held.append((torch.empty(floats, dtype=torch.float32, device=device),
                     torch.zeros(tickets, dtype=torch.int32, device=device)))
    return held[-1]


def ln_bwd_occupancy(dtype, vecs_per_thread, smem):
    """Blocks of 8 warps per SM that K5's kernel for (dtype,
    vecs_per_thread) keeps resident with `smem` bytes of dynamic shared
    memory, on the current device."""
    lib = backend.load("layer_norm_bwd", _BWD_SIGS)
    out = ctypes.c_int(0)
    backend.check(lib.pt_layer_norm_bwd_occupancy(
        _DTYPE_CODES[dtype], vecs_per_thread, smem, ctypes.byref(out)),
        "layer_norm backward occupancy")
    return out.value


def _launch_bwd(x, gamma, dy, eps, out_dtype=torch.float32, plan=None):
    """K5 on the card: (dx in x.dtype, dgamma, dbeta in `out_dtype`), one
    launch.  `plan` overrides `ln_bwd_plan`'s (the chip run's sweep)."""
    _check_contiguous((x, gamma, dy))
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"fused_layer_norm backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} does not match x {tuple(x.shape)} "
                         f"{x.dtype}")
    if gamma.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_layer_norm backward: gamma {gamma.dtype} and "
                        f"the grads' {out_dtype} must be "
                        "float32/bfloat16/float16")
    if any(t.data_ptr() % 16 for t in (x, gamma, dy)):
        raise ValueError("fused_layer_norm backward: the kernel needs "
                         "16-byte aligned x, gamma and dy")
    rows, d = x.shape
    if plan is None:
        plan = ln_bwd_plan(rows, d, x.dtype, backend.sm_count(x.device))
    dx = torch.empty_like(x)
    dg = torch.empty(d, dtype=out_dtype, device=x.device)
    db = torch.empty(d, dtype=out_dtype, device=x.device)
    lib = backend.load("layer_norm_bwd", _BWD_SIGS)
    with torch.cuda.device(x.device):
        stream = backend.stream_handle(x.device)
        ws, tickets = _bwd_work(x.device, stream, plan, d)
        status = lib.pt_layer_norm_bwd(
            x.data_ptr(), gamma.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dg.data_ptr(), db.data_ptr(), ws.data_ptr(), tickets.data_ptr(),
            rows, d, float(eps), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[gamma.dtype], _DTYPE_CODES[out_dtype],
            plan.vecs_per_thread, plan.warps_per_row, plan.blocks,
            plan.group, stream)
    backend.check(status, "layer_norm backward")
    backend.count_launch("layer_norm_bwd", x.dtype)
    return dx, dg, db


def _fwd(x, gamma, beta, eps):
    if x.device.type == "cpu":
        return layer_norm_ref(x, gamma, beta, eps)
    return _launch(x, gamma, beta, eps)


@torch.library.custom_op("paddle_tpu_torch::layer_norm_fwd", mutates_args=())
def _fwd_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float) -> torch.Tensor:
    """K4 as a custom op (`backend.traced_kernels`): the launcher on CUDA
    tensors, the plain version on CPU ones."""
    return _fwd(x, gamma, beta, eps)


@_fwd_op.register_fake
def _(x, gamma, beta, eps):
    return torch.empty_like(x)


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
            return dx, dg.to(gamma.dtype), db.to(gamma.dtype), None
        return (*_launch_bwd(x, gamma, dy, ctx.eps, gamma.dtype), None)


def fused_layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm over the last axis of a 2-D [rows, D] input,
    differentiable in x, gamma and beta.  A call that records no
    gradient skips the Function's bookkeeping (the decode loop)."""
    _check(x, gamma, beta)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _LayerNorm.apply(x, gamma, beta, float(eps))
    if backend.tracing():
        return _fwd_op(x, gamma, beta, float(eps))
    return _fwd(x, gamma, beta, float(eps))


def layer_norm_fused(x, gamma, beta, eps=1e-5):
    """Any-rank wrapper (counterpart of `layer_norm_pallas`): normalizes
    over the last axis."""
    shape = x.shape
    y = fused_layer_norm(x.reshape(-1, shape[-1]), gamma, beta, eps)
    return y.reshape(shape)
