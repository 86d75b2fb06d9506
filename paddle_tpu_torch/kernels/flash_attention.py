"""Flash attention for Hopper: K1 (forward), K2/K3 (backward) and K6
(single-query decode).

Port of paddle_tpu/kernels/flash_attention.py.  The kernels are CUDA C++
in `paddle_tpu_torch/csrc/` (built and bound by `backend`):

- K1 `flash_attention` / `flash_attention_with_lse` replace the Pallas
  `_fwd_kernel` (`_fwd`): online-softmax attention over [B, H, S, D]
  with an optional causal mask, f32 statistics, O in the input dtype
  and the row logsumexp in f32.  bf16 runs on the tensor cores
  (`mma.sync`, P kept in registers), f32 on an exact scalar kernel; see
  csrc/flash_attention.cu for the design and what bounds it on the H100.
- K2 and K3 replace the Pallas `_bwd_dq_kernel` and `_bwd_dkv_kernel`
  (`_bwd_core`): the FA-2 backward, P recomputed from the saved lse,
  dQ in one kernel and dK/dV in the other.  `flash_attention` and
  `flash_attention_with_lse` are `torch.autograd.Function`s (`_Flash`,
  `_FlashLse`, the counterparts of the reference's custom-VJP `_flash`
  and `_flash_lse`): forward K1, backward K2 + K3.  delta = rowsum(dO *
  O) in f32 is computed with torch outside the kernels, as the
  reference's `_bwd` does, and the lse cotangent folds into delta -
  dlse.  In bf16 both run on the tensor cores (K2: dS kept in
  registers; K3: P^T and dS^T), in f32 on exact scalar kernels.  See
  csrc/flash_attention_bwd.cu.
- K6 `flash_decode` replaces the Pallas `_decode_kernel`: one query row
  per (b, h) against a KV cache, keys past `lengths[b]` never read.  One
  launch splits each row's cache into chunks (`decode_plan`), one block
  each; the last block of a row merges the partials in split order.
  See csrc/flash_decode.cu.

Each wrapper checks its envelope (shapes, dtypes, devices, contiguity)
and raises on anything outside it.  On CPU tensors it returns the plain
PyTorch version beside it (`flash_attention_ref`, `flash_decode_ref`),
which the CPU tests hold against the Pallas kernels; on CUDA tensors it
launches the kernel or raises.  `round_to=torch.bfloat16` makes the
flash plain versions round p and ds where the Pallas kernels do: the
model the bf16 tensor-core kernels are held to.  The TPU tile sizes (`DEFAULT_BLOCK_Q/K`,
`PADDLE_TPU_FLASH_BLOCK`) do not carry over: the CUDA kernels fix their
own tiles.
"""

import ctypes
import math

import torch

from . import backend

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_SIGS = {"pt_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]}
_BWD_SIGS = {
    "pt_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                        _P],
    "pt_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _F, _P],
}
_DECODE_SIGS = {"pt_flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _F, _I, _P, _P, _P]}
# K6's split of the cache (csrc/flash_decode.cu): chunks of at least 64
# keys, a multiple of 64, enough of them for about two blocks per SM
DECODE_MIN_CHUNK = 64
DECODE_BLOCKS_PER_SM = 2


def _check_common(name, tensors):
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not in float32/bfloat16")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: inputs must share one device and "
                             f"dtype, got {[(x.device, x.dtype) for x in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def _check_launch(name, tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel needs contiguous "
                             "inputs")


# --------------------------------------------------------------------------
# K1: forward
# --------------------------------------------------------------------------

def _check_fwd(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError("flash_attention: q, k, v must be equal "
                         f"[B, H, S, D] shapes, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s, d = q.shape[-2], q.shape[-1]
    if s % 128 or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: needs S % 128 == 0 and head_dim "
                         f"in {HEAD_DIMS}, got S={s}, D={d}")
    _check_common("flash_attention", (q, k, v))


def flash_attention_ref(q, k, v, causal=False, sm_scale=None,
                        round_to=None):
    """Plain version of K1: (out in q.dtype, lse [B, H, S] in f32).  The
    same math as the kernel in f32 (in float64 for float64 inputs): -1e30
    causal mask, exp(s - max), the `l == 0` guard.  With `round_to` (a
    dtype) p is rounded to it before P.V, where the reference's
    `_fwd_kernel` rounds it (`p.astype(v_blk.dtype)`; l sums the unrounded
    p): the rounding model of the bf16 tensor-core kernel."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * sm_scale
    if causal:
        n_q, n_k = s.shape[-2], s.shape[-1]
        live = torch.ones(n_q, n_k, dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(_rounded(p, round_to), v.to(ct)) / l_safe
    return out.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _rounded(x, dtype):
    """x rounded to `dtype` and back (None: x itself)."""
    return x if dtype is None else x.to(dtype).to(x.dtype)


def _check_aligned(name, tensors):
    # the bf16 tensor-core kernels load 16 bytes a cp.async
    if tensors[0].dtype == torch.bfloat16:
        for t in tensors:
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the bf16 kernel needs 16-byte "
                                 "aligned inputs")


def _launch_fwd(q, k, v, causal, sm_scale):
    _check_launch("flash_attention", (q, k, v))
    _check_aligned("flash_attention", (q, k, v))
    b, h, s, d = q.shape
    lib = backend.load("flash_attention", _FWD_SIGS)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = lib.pt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b * h, s, d, _DTYPE_CODES[q.dtype], int(causal),
            float(sm_scale), backend.stream_handle(q.device))
    backend.check(status, "flash_attention")
    backend.LAUNCHES["flash_attention_fwd"] += 1
    return out, lse


def _fwd(q, k, v, causal, sm_scale):
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal, sm_scale)
    return _launch_fwd(q, k, v, causal, sm_scale)


# --------------------------------------------------------------------------
# K2 / K3: backward
# --------------------------------------------------------------------------

def flash_attention_bwd_ref(q, k, v, do, lse, delta, causal=False,
                            sm_scale=None, round_to=None):
    """Plain version of K2/K3: the FA-2 backward in f32 (float64 for
    float64 inputs), P recomputed from the forward's lse (p = exp(s -
    lse), the same -1e30 causal mask), ds = p * (dp - delta) * sm_scale.
    Returns (dq, dk, dv) in the inputs' dtype.  With `round_to` (a dtype)
    p is rounded to it before dV and ds before dK and dQ, where the
    reference's `_bwd_dkv_kernel` and `_bwd_dq_kernel` round them."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, dof = q.to(ct), k.to(ct), v.to(ct), do.to(ct)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        n = s.shape[-1]
        live = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.to(ct)[..., None])
    dv = torch.matmul(_rounded(p, round_to).transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = _rounded(p * (dp - delta.to(ct)[..., None]) * sm_scale, round_to)
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd(q, k, v, do, lse, delta):
    _check_launch("flash_attention_bwd", (q, k, v, do, lse, delta))
    b, h, s, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s):
            raise ValueError(f"flash_attention_bwd: {name} must be float32 "
                             f"[{b}, {h}, {s}], got {t.dtype} "
                             f"{tuple(t.shape)}")


def _bwd_args(q, k, v, do, lse, delta, causal, sm_scale):
    b, h, s, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    dims = (b * h, s, d, _DTYPE_CODES[q.dtype], int(causal), float(sm_scale))
    return ptrs, dims


def _launch_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale):
    """K2 alone: dq."""
    _check_bwd(q, k, v, do, lse, delta)
    _check_aligned("flash_attention_bwd_dq", (q, k, v, do, lse, delta))
    lib = backend.load("flash_attention_bwd", _BWD_SIGS)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, causal, sm_scale)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        status = lib.pt_flash_bwd_dq(*ptrs, dq.data_ptr(), *dims,
                                     backend.stream_handle(q.device))
    backend.check(status, "flash_attention_bwd_dq")
    backend.LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale):
    """K3 alone: (dk, dv)."""
    _check_bwd(q, k, v, do, lse, delta)
    _check_aligned("flash_attention_bwd_dkv", (q, k, v, do, lse, delta))
    lib = backend.load("flash_attention_bwd", _BWD_SIGS)
    ptrs, dims = _bwd_args(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        status = lib.pt_flash_bwd_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                      *dims, backend.stream_handle(q.device))
    backend.check(status, "flash_attention_bwd_dkv")
    backend.LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def _launch_bwd(q, k, v, do, lse, delta, causal, sm_scale):
    """K2 then K3: (dq, dk, dv)."""
    args = (q, k, v, do, lse, delta, causal, sm_scale)
    return (_launch_bwd_dq(*args), *_launch_bwd_dkv(*args))


def _bwd(ctx, do, dlse):
    """Shared backward of `_Flash` and `_FlashLse`: delta in f32 with
    torch, the lse cotangent folded in as delta - dlse (the reference's
    `_flash_lse_bwd`), then K2 + K3 (or the plain version on the CPU)."""
    q, k, v, out, lse = ctx.saved_tensors
    # MHA hands dO over as a transpose view; the kernels take it dense
    do = torch.zeros_like(out) if do is None else do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, do, lse, delta, ctx.causal,
                                       ctx.sm_scale)
    return _launch_bwd(q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)


class _Flash(torch.autograd.Function):
    """out = attention(q, k, v): forward K1, backward K2 + K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = _fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        return (*_bwd(ctx, do, None), None, None)


class _FlashLse(torch.autograd.Function):
    """(out, lse) = attention(q, k, v), differentiable through both."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = _fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return (*_bwd(ctx, do, dlse), None, None)


def _records_grad(tensors):
    # a call that records no gradient skips the Function's bookkeeping
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention_with_lse(q, k, v, causal=False, sm_scale=None):
    """Tiled attention over [B, H, S, D] that also returns the per-row
    logsumexp [B, H, S] (f32), differentiable through both outputs."""
    _check_fwd(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _records_grad((q, k, v)):
        return _FlashLse.apply(q, k, v, bool(causal), float(sm_scale))
    return _fwd(q, k, v, bool(causal), float(sm_scale))


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Tiled attention over [B, H, S, D]; returns q's shape and dtype."""
    _check_fwd(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _records_grad((q, k, v)):
        return _Flash.apply(q, k, v, bool(causal), float(sm_scale))
    return _fwd(q, k, v, bool(causal), float(sm_scale))[0]


# --------------------------------------------------------------------------
# K6: single-query decode
# --------------------------------------------------------------------------

def _decode_lengths(lengths, batch, device):
    lengths = torch.as_tensor(lengths, device=device).to(torch.int32)
    return lengths.reshape(-1).expand(batch).contiguous()


def _check_decode(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_decode: q [B, H, 1, D] and k, v "
                         "[B, H, T, D] expected")
    b, h, q_len, d = q.shape
    if q_len != 1:
        raise ValueError(f"flash_decode needs q_len == 1, got {q_len}")
    if tuple(k.shape[:2]) != (b, h) or k.shape[-1] != d:
        raise ValueError(f"flash_decode: cache {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if k.shape[-2] % 128 or d not in HEAD_DIMS:
        raise ValueError(f"flash_decode: needs T % 128 == 0 and head_dim in "
                         f"{HEAD_DIMS}, got T={k.shape[-2]}, D={d}")
    _check_common("flash_decode", (q, k, v))


def flash_decode_ref(q, k, v, lengths, sm_scale=None):
    """Plain version of K6: attention of q [B, H, 1, D] over the first
    lengths[b] cache rows of k, v [B, H, T, D]; a row with no live key
    returns 0 (the `l == 0` guard)."""
    b, t = q.shape[0], k.shape[-2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    lengths = _decode_lengths(lengths, b, q.device)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    live = (torch.arange(t, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return (torch.matmul(p, v.float()) / l_safe).to(q.dtype)


def decode_plan(bh, t, sms):
    """K6's split of a T-deep cache over `bh` = b * h rows on a card of
    `sms` SMs: (chunk, splits).  The chunk is the largest multiple of 64
    keys for which bh * splits reaches DECODE_BLOCKS_PER_SM blocks per
    SM, and at least 64; splits = ceil(t / chunk).  It depends on T and
    bh alone: the host does not read the lengths."""
    want = -(-DECODE_BLOCKS_PER_SM * sms // bh)
    chunk = max(DECODE_MIN_CHUNK,
                t // want // DECODE_MIN_CHUNK * DECODE_MIN_CHUNK)
    return chunk, -(-t // chunk)


_SMS = {}
# per (device index, stream): K6's arrival counters, zeroed once (every
# launch leaves them 0); a set outgrown is kept alive behind the new one,
# since a CUDA graph that captured a launch keeps its pointer
_DECODE_COUNTERS = {}


def _sm_count(device):
    if device.index not in _SMS:
        _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device.index]


def _decode_counters(device, stream, n_rows):
    held = _DECODE_COUNTERS.setdefault((device.index, stream.value), [])
    if not held or held[-1].numel() < n_rows:
        size = max(n_rows, 2 * held[-1].numel()) if held else n_rows
        held.append(torch.zeros(size, dtype=torch.int32, device=device))
    return held[-1]


def _launch_decode(q, k, v, lengths, sm_scale):
    _check_launch("flash_decode", (q, k, v))
    for t_ in (k, v):
        if t_.data_ptr() % 16:
            raise ValueError("flash_decode: the kernel needs 16-byte aligned "
                             "caches")
    b, h, _, d = q.shape
    t = k.shape[-2]
    chunk, splits = decode_plan(b * h, t, _sm_count(q.device))
    lib = backend.load("flash_decode", _DECODE_SIGS)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = backend.stream_handle(q.device)
        ws_ptr = counters_ptr = None
        if splits > 1:   # the partials (written before read), the counters
            ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                             device=q.device)
            ws_ptr = ws.data_ptr()
            counters_ptr = _decode_counters(q.device, stream,
                                            b * h).data_ptr()
        status = lib.pt_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), b, h, t, d, _DTYPE_CODES[q.dtype],
            float(sm_scale), chunk, ws_ptr, counters_ptr, stream)
    backend.check(status, "flash_decode")
    backend.LAUNCHES["flash_decode"] += 1
    return out


def flash_decode(q, k, v, lengths, sm_scale=None):
    """Single-query flash attention for the decode phase.

    q: [B, H, 1, D]; k, v: [B, H, T, D] (the KV cache); lengths: int [B]
    or a scalar, the live prefix per row (pos + 1).  Cache positions >=
    length are masked and, on the card, never read."""
    _check_decode(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, lengths, sm_scale)
    return _launch_decode(q, k, v, _decode_lengths(lengths, q.shape[0],
                                                   q.device), sm_scale)
