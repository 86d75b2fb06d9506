"""K7, the port's fused bottleneck block, against the JAX package's
Pallas kernels.

On this CPU host the port's wrappers run their plain PyTorch versions
(`fused_bottleneck_fwd_ref`, `fused_bottleneck_bwd_ref`); the JAX
`fused_bottleneck` / `fused_bottleneck_proj` run their Pallas kernels in
interpret mode, as tests/test_fused_bottleneck.py runs them, at that
file's shapes (n 8, 8x8, c 32, cm 8; the projection block cin 16 ->
cout 32).  Inputs are numpy arrays from a seed handed to both packages;
the grads come from `jax.vjp` and `torch.autograd.grad` with the same
cotangent.

Tolerances: float32 atol = rtol = 2e-5 (the same math, sums taken in
another order); bfloat16 atol = rtol = 3e-2 (one bf16 rounding of an
intermediate may land on the other side; on this host the two agree
exactly in practice).

`test_k7_on_card` holds the CUDA kernels against the plain versions on
the card; it needs a GPU and skips here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_bottleneck as JK

from paddle_tpu_torch.kernels import backend
from paddle_tpu_torch.kernels import fused_bottleneck as TK

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _args(seed, proj, n=8, h=8, w=8, c=32, cm=8, cin=16):
    g = np.random.default_rng(seed).standard_normal
    cin = cin if proj else c
    arrs = [g((n, h, w, cin)) * 0.5, g((cin, cm)) * 0.2,
            g((3, 3, cm, cm)) * 0.2, g((cm, c)) * 0.2]
    if proj:
        arrs.append(g((cin, c)) * 0.2)
    affs = [g(cm) * 0.3 + 1, g(cm) * 0.1, g(cm) * 0.3 + 1, g(cm) * 0.1,
            g(c) * 0.3 + 1, g(c) * 0.1]
    if proj:
        affs += [g(c) * 0.3 + 1, g(c) * 0.1]
    return [a.astype(np.float32) for a in arrs + affs]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("proj", [False, True])
def test_k7_plain_matches_pallas_fwd_and_vjp(proj, dtype):
    args = _args(0, proj)
    jf = JK.fused_bottleneck_proj if proj else JK.fused_bottleneck
    tf = TK.fused_bottleneck_proj if proj else TK.fused_bottleneck
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in args]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
             for a in args]
    jy, vjp = jax.vjp(jf, *jargs)
    dy = np.random.default_rng(9).standard_normal(jy.shape).astype(
        np.float32)
    jgrads = vjp(jnp.asarray(dy, getattr(jnp, dtype)))
    ty = tf(*targs)
    tgrads = torch.autograd.grad(ty, targs,
                                 torch.from_numpy(dy).to(ty.dtype))
    tol = TOL[dtype]
    assert ty.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(ty.detach().float().numpy(), _f32(jy),
                               atol=tol, rtol=tol)
    names = ("x w1 w2 w3" + (" w4" if proj else "")
             + " a1 b1 a2 b2 a3 b3" + (" a4 b4" if proj else "")).split()
    for name, t, j, ref in zip(names, tgrads, jgrads, targs):
        # weight and affine grads come back in their primal's dtype
        assert t.dtype == ref.dtype, name
        np.testing.assert_allclose(t.float().numpy(), _f32(j), atol=tol,
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("proj", [False, True])
def test_k7_plain_bwd_matches_its_own_autograd(proj):
    """The plain backward (the kernel's reference) against autograd of
    the plain forward, in f32 (atol = rtol = 1e-4: two chains of sums in
    another order)."""
    args = [torch.from_numpy(a) for a in _args(3, proj, n=2)]
    x, w1, w2, w3 = args[:4]
    w4 = args[4] if proj else None
    affs = args[5:] if proj else args[4:]
    width = w3.shape[1]
    leaves = [t.clone().requires_grad_() for t in [x, w1, w2, w3]
              + ([w4] if proj else []) + affs]
    lw4 = leaves[4] if proj else None
    la = leaves[5:] if proj else leaves[4:]
    aff = TK._pack_affines(la, width)
    y = TK.fused_bottleneck_fwd_ref(leaves[0], leaves[1], leaves[2],
                                    leaves[3], lw4, aff, proj)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(y.shape)).astype(np.float32))
    want = torch.autograd.grad(y, leaves, dy)
    dx, dw1, dw2, dw3, dw4, daff = TK.fused_bottleneck_bwd_ref(
        x, dy, w1, w2, w3, w4, TK._pack_affines(affs, width), proj)
    cm = w1.shape[1]
    got = [dx, dw1, dw2, dw3] + ([dw4] if proj else []) + [
        daff[0, :cm], daff[1, :cm], daff[2, :cm], daff[3, :cm], daff[4],
        daff[5]] + ([daff[6], daff[7]] if proj else [])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_k7_batch_tile_and_unported_variants():
    args = [torch.from_numpy(a) for a in _args(1, False)]
    y = TK.fused_bottleneck(*args, batch_tile=4)
    torch.testing.assert_close(y, TK.fused_bottleneck(*args))
    with pytest.raises(ValueError, match="does not divide batch"):
        TK.fused_bottleneck(*args, batch_tile=3)
    with pytest.raises(ValueError, match="Cout == Cin"):
        TK.fused_bottleneck(args[0][..., :16], args[1][:16], *args[2:])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        TK.fused_bottleneck_down(*args)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        TK.fused_stem_tail(args[0], args[4], args[5])


def test_k7_source_and_launch_counters():
    assert "fused_bottleneck" in backend.SOURCES
    text = (backend.CSRC / "fused_bottleneck.cu").read_text()
    for entry in ("pt_fused_bottleneck_fwd", "pt_fused_bottleneck_bwd"):
        assert f'extern "C" int {entry}' in text
    assert "cudaGetLastError" in text
    # the plain versions run on CPU tensors and count no launch
    backend.reset_launches()
    args = [torch.from_numpy(a).requires_grad_() for a in _args(2, False)]
    torch.autograd.grad(TK.fused_bottleneck(*args).sum(), args)
    assert backend.LAUNCHES["fused_bottleneck_fwd"] == 0
    assert backend.LAUNCHES["fused_bottleneck_bwd"] == 0


@pytest.mark.cuda
def test_k7_on_card():
    """K7 forward and backward on the card, raw and through the
    Functions, against the plain versions.  f32: 2e-5, the weight and
    affine grads (f32 sums over rows, atomics in any order) with atol
    2e-5 * sqrt(rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")
    dev = torch.device("cuda")
    backend.reset_launches()
    for proj in (False, True):
        args = [torch.from_numpy(a).to(dev) for a in _args(5, proj, n=4,
                                                           cm=32)]
        f = TK.fused_bottleneck_proj if proj else TK.fused_bottleneck
        leaves = [a.clone().requires_grad_() for a in args]
        y = f(*leaves)
        dy = torch.randn(y.shape, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
        got = torch.autograd.grad(y, leaves, dy)
        cpu = [a.cpu().requires_grad_() for a in args]
        y_ref = f(*cpu)
        want = torch.autograd.grad(y_ref, cpu, dy.cpu())
        torch.testing.assert_close(y.cpu(), y_ref, atol=2e-5, rtol=2e-5)
        rows = args[0].shape[0] * args[0].shape[1] * args[0].shape[2]
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, atol=2e-5 * rows ** 0.5,
                                       rtol=2e-5)
    torch.cuda.synchronize()
    assert backend.LAUNCHES["fused_bottleneck_fwd"] == 2
    assert backend.LAUNCHES["fused_bottleneck_bwd"] == 2
