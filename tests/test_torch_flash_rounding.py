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

Tolerance, bf16: atol = rtol = 2e-3.  Measured over these cases (on
this CPU): the rounding model's largest error 9.77e-4 (O and dV at
64-row tiles), the default plain version's 7.81e-3, which holds only at
tests/test_torch_kernels.py's 3e-2; each case also checks that the model
is no further from the kernel than the default is.  f32: 2e-5, and
`round_to=torch.float32` is the default bit for bit.  The default
(`round_to=None`) is held bitwise to the plain versions as they were
before the option (`_fwd_before`, `_bwd_before` below).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import (
    flash_attention_with_lse as j_flash_lse)

from paddle_tpu_torch.kernels import flash_attention as TFA

TOL = {"float32": 2e-5, "bfloat16": 2e-3}


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
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
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


def test_bf16_launchers_need_aligned_inputs():
    """The bf16 tensor-core K1 and K3 load 16 bytes a cp.async: their
    launchers raise on a misaligned input before reaching the library."""
    base = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16)
    bad = base[1:].view(1, 2, 128, 64)          # contiguous, 2 bytes off
    good = torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TFA._launch_fwd(good, bad, good, False, 0.125)
    lse = torch.zeros(1, 2, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TFA._launch_bwd_dkv(good, good, good, bad, lse, lse, True, 0.125)
