"""The plain versions of K1-K3 with the reference's rounding points
(`round_to`) against the JAX package's Pallas kernels.

`flash_attention_ref(..., round_to=dtype)` rounds p to `dtype` before
P.V, and `flash_attention_bwd_ref(..., round_to=dtype)` rounds p before
dV and ds before dK and dQ, where `_fwd_kernel`, `_bwd_dkv_kernel` and
`_bwd_dq_kernel` round them.  That is the rounding model the bf16
tensor-core kernels K1 and K3 are held to on the card (chip_smoke.py
`flash_precision`).  Here the Pallas kernels run in interpret mode on the
CPU (forward and `jax.vjp` with an lse cotangent), with their default
tiles (one tile at S = 256) and with 64-row tiles (the CUDA kernels'),
where the running max rounds p against other scales.  Inputs are made
with numpy from a seed.

The same with float16 inputs and `round_to=torch.float16`, the model of
the float16 tensor-core kernels, at the bf16 bound scaled to float16's
mantissa: atol = rtol = 2.5e-4.

Tolerance, bf16: atol = rtol = 2e-3.  Measured over these cases (on
this CPU): the rounding model's largest error 9.77e-4 (O and dV at
64-row tiles), the default plain version's 7.81e-3, which holds only at
tests/test_torch_kernels.py's 3e-2; each case also checks that the model
is no further from the kernel than the default is.  f32: 2e-5, and
`round_to=torch.float32` is the default bit for bit.  The default
(`round_to=None`) is held bitwise to the plain versions as they were
before the option (`_fwd_before`, `_bwd_before` below).

`_dq_tile_model` is a CPU model of the bf16 tensor-core K2's tile
schedule (64-query x 64-key tiles in the kernel's order, the diagonal
tile the only one masked, ds rounded per tile, dq summed in f32 and
rounded once); it is held against the Pallas `_bwd_dq_kernel` (interpret
mode, `_bwd_core` with block_q = block_k = 64) on the same lse and
delta at 2e-3, the bound above, and the card's bf16 K2 is held to it at
one bf16 ulp (tests/test_torch_kernels.py `test_kernels_on_card`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import (
    _bwd_core as j_bwd_core, flash_attention_with_lse as j_flash_lse)

from paddle_tpu_torch.kernels import flash_attention as TFA
from torch_threads import torch_threads  # noqa: F401

# float16: the bf16 bound scaled to float16's mantissa (2^-10 against
# 2^-7 relative)
TOL = {"float32": 2e-5, "bfloat16": 2e-3, "float16": 2e-3 / 8}


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _max_err(got, want):
    return float(np.abs(got.float().numpy()
                        - np.asarray(want.astype(jnp.float32))).max())


def _fwd_before(q, k, v, causal=False, sm_scale=None):
    """flash_attention_ref before `round_to`, verbatim."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        n_q, n_k = s.shape[-2], s.shape[-1]
        live = torch.ones(n_q, n_k, dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(live, s, torch.full_like(s, TFA.NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p, v.float()) / l_safe
    return out.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _bwd_before(q, k, v, do, lse, delta, causal=False, sm_scale=None):
    """flash_attention_bwd_ref before `round_to`, verbatim."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        n = s.shape[-1]
        live = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        s = torch.where(live, s, torch.full_like(s, TFA.NEG_INF))
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.float()[..., None]) * sm_scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _plain(q, k, v, do, dlse, causal, round_to):
    """out, lse, dq, dk, dv of the plain versions, delta as the autograd
    Function computes it (dlse folded in)."""
    out, lse = TFA.flash_attention_ref(q, k, v, causal, round_to=round_to)
    delta = (do.float() * out.float()).sum(-1) - dlse
    grads = TFA.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal,
                                        round_to=round_to)
    return (out, lse, *grads)


@pytest.mark.parametrize("blocks", [None, 64])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_round_to_matches_pallas(dtype, causal, d, blocks):
    shape = (1, 2, 256, d)
    q, k, v, do = (_rand(shape, s) for s in (11, 12, 13, 14))
    dlse = _rand(shape[:3], 15)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    (j_out, j_lse), vjp = jax.vjp(
        lambda a, b, c: j_flash_lse(a, b, c, causal=causal, block_q=blocks,
                                    block_k=blocks), jq, jk, jv)
    want = (j_out, j_lse, *vjp((jnp.asarray(do, jd), jnp.asarray(dlse))))
    args = (*(_t(a, dtype) for a in (q, k, v, do)), torch.from_numpy(dlse),
            causal)
    model = _plain(*args, round_to=getattr(torch, dtype))
    default = _plain(*args, round_to=None)
    for name, got, base, w in zip(("out", "lse", "dq", "dk", "dv"), model,
                                  default, want):
        assert got.dtype == base.dtype, name
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(w.astype(jnp.float32)),
            atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)
        assert _max_err(got, w) <= _max_err(base, w), name
        if dtype == "float32":      # rounding to f32 changes nothing
            assert torch.equal(got, base), name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_default_is_bitwise_unchanged(dtype, causal):
    shape = (2, 2, 128, 64)
    q, k, v, do = (_t(_rand(shape, s), dtype) for s in (21, 22, 23, 24))
    out, lse = TFA.flash_attention_ref(q, k, v, causal)
    before_out, before_lse = _fwd_before(q, k, v, causal)
    assert torch.equal(out, before_out) and torch.equal(lse, before_lse)
    delta = (do.float() * out.float()).sum(-1) - _t(_rand(shape[:3], 25),
                                                    "float32")
    got = TFA.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal)
    for g, w in zip(got, _bwd_before(q, k, v, do, lse, delta, causal)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_round_to_runs_in_float64():
    """float64 inputs compute in float64 (the card's precision check takes
    its float64 products from here) and agree with the f32 path."""
    shape = (1, 2, 128, 64)
    q, k, v, do = (_rand(shape, s) for s in (31, 32, 33, 34))
    bf = [_t(a, "bfloat16") for a in (q, k, v, do)]
    dlse = torch.from_numpy(_rand(shape[:3], 35))
    f32 = _plain(*bf, dlse, True, torch.bfloat16)
    f64 = _plain(*(t.double() for t in bf), dlse.double(), True,
                 torch.bfloat16)
    for a, b in zip(f32, f64):
        assert b.dtype == torch.float64
        torch.testing.assert_close(a.double(), b, atol=2e-3, rtol=2e-3)


def _dq_tile_model(q, k, v, do, lse, delta, causal, sm_scale, tile=64):
    """K2's tile schedule on the CPU: per `tile`-row query tile, the key
    tiles the kernel visits, in its order (0 up; causal: up to the
    diagonal tile, the only one masked), s and dp in f32, p = exp(s -
    lse), ds = p (dp - delta) sm_scale rounded to q's dtype per tile, dq
    summed over the tiles in f32 and rounded once.  Runs on q's device
    (tests/test_torch_kernels.py holds the card's K2 to it)."""
    b, h, n, d = q.shape
    dev = q.device
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    dq = torch.empty(b, h, n, d, device=dev)
    live = torch.ones(tile, tile, dtype=torch.bool, device=dev).tril()
    for qt in range(n // tile):
        rows = slice(qt * tile, (qt + 1) * tile)
        acc = torch.zeros(b, h, tile, d, device=dev)
        for kt in range(qt + 1 if causal else n // tile):
            cols = slice(kt * tile, (kt + 1) * tile)
            s = torch.matmul(qf[..., rows, :],
                             kf[..., cols, :].transpose(-1, -2)) * sm_scale
            if causal and kt == qt:
                s = torch.where(live, s, torch.full_like(s, TFA.NEG_INF))
            p = torch.exp(s - lse[..., rows, None])
            dp = torch.matmul(dof[..., rows, :],
                              vf[..., cols, :].transpose(-1, -2))
            ds = p * (dp - delta[..., rows, None]) * sm_scale
            acc = acc + torch.matmul(ds.to(q.dtype).float(), kf[..., cols, :])
        dq[..., rows, :] = acc
    return dq.to(q.dtype)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_k2_tile_model_matches_pallas_dq(causal, d, s):
    shape = (1, 2, s, d)
    q, k, v, do = (_t(_rand(shape, 40 + i), "bfloat16") for i in range(4))
    scale = 1.0 / math.sqrt(d)
    out, lse = TFA.flash_attention_ref(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1) - torch.from_numpy(
        _rand(shape[:3], 44))
    want = j_bwd_core(scale, causal, 64, 64,
                      *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                        for t in (q, k, v, do)),
                      jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()))[0]
    got = _dq_tile_model(q, k, v, do, lse, delta, causal, scale)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])
    # and nearer the kernel than the plain version without the rounding
    # of ds: no further at worst, closer on average
    base = TFA.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal,
                                       scale)[0]
    assert _max_err(got, want) <= _max_err(base, want)
    w = np.asarray(want.astype(jnp.float32))
    assert (np.abs(got.float().numpy() - w).mean()
            < np.abs(base.float().numpy() - w).mean())


def test_bf16_launchers_need_aligned_inputs():
    """The bf16 tensor-core K1, K2 and K3 load 16 bytes a cp.async: their
    launchers raise on a misaligned input before reaching the library."""
    base = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16)
    bad = base[1:].view(1, 2, 128, 64)          # contiguous, 2 bytes off
    good = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TFA._launch_fwd(good, bad, good, False, 0.125)
    lse = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TFA._launch_bwd_dkv(good, good, good, bad, lse, lse, True, 0.125)
    for args in ((bad, good, good, good), (good, good, good, bad)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            TFA._launch_bwd_dq(*args, lse, lse, True, 0.125)
