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

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_bottleneck as JK

from paddle_tpu_torch.kernels import backend
from paddle_tpu_torch.kernels import fused_bottleneck as TK
from torch_threads import torch_threads  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _args(seed, proj, n=8, h=8, w=8, c=32, cm=8, cin=16, he=False):
    """x, the weights and the affines as numpy; with `he`, the weights
    take a ResNet's fan-in scale (1 / sqrt(fan-in)) in place of 0.2."""
    g = np.random.default_rng(seed).standard_normal
    cin = cin if proj else c

    def s(fan_in):
        return fan_in ** -0.5 if he else 0.2

    arrs = [g((n, h, w, cin)) * 0.5, g((cin, cm)) * s(cin),
            g((3, 3, cm, cm)) * s(9 * cm), g((cm, c)) * s(cm)]
    if proj:
        arrs.append(g((cin, c)) * s(cin))
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
    """`batch_tile` is checked and has no effect; the variants that were
    not ported with K7 (K8 `fused_bottleneck_down`, K9 `fused_stem_tail`)
    now run, and agree with their plain versions on the same inputs (they
    are held against the Pallas kernels in test_torch_fused_down_stem.py)."""
    args = [torch.from_numpy(a) for a in _args(1, False)]
    y = TK.fused_bottleneck(*args, batch_tile=4)
    torch.testing.assert_close(y, TK.fused_bottleneck(*args))
    with pytest.raises(ValueError, match="does not divide batch"):
        TK.fused_bottleneck(*args, batch_tile=3)
    with pytest.raises(ValueError, match="Cout == Cin"):
        TK.fused_bottleneck(args[0][..., :16], args[1][:16], *args[2:])
    x, w1, w2, w3 = args[:4]
    a1, b1, a2, b2, a3, b3 = args[4:]
    w4 = torch.from_numpy(_args(2, True)[4])
    down = TK.fused_bottleneck_down(x[..., :16], w1[:16], w2, w3, w4, a1,
                                    b1, a2, b2, a3, b3, a3, b3)
    aff = TK._pack_affines((a1, b1, a2, b2, a3, b3, a3, b3), 32)
    torch.testing.assert_close(down, TK.fused_bottleneck_down_fwd_ref(
        x[..., :16].contiguous(), w1[:16], w2, w3, w4, aff))
    assert tuple(down.shape) == (8, 4, 4, 32)
    stem = TK.fused_stem_tail(x, a3, b3)
    assert tuple(stem.shape) == (8, 4, 4, 32)
    torch.testing.assert_close(stem, TK.fused_stem_tail_fwd_ref(
        x, torch.stack([a3, b3])))


def _kernel_body(text, name):
    start = text.index(f"\n{name}(")
    return text[start:text.index("\n}\n", start)]


def test_k7_source_and_launch_counters():
    """K7 is csrc/fused_block.cu on the tensor-core pieces it shares with
    K8 (csrc/block_tc.cuh): every K7 kernel that multiplies reaches
    `pt::tc::product`, no kernel adds a weight gradient with atomics
    (the only atomic targets are the affine grads and their shared-memory
    partials), and csrc/fused_bottleneck.cu keeps P1 and P2 alone (P1 on
    K7's `conv3x3`, P2 on the tensor-core `product` in K7's forward
    layout), with no stride-2 code left."""
    assert "fused_block" in backend.SOURCES
    text = (backend.CSRC / "fused_block.cu").read_text()
    for entry in ("pt_fused_block_fwd", "pt_fused_block_bwd",
                  "pt_fused_block_plan"):
        assert f'extern "C" int {entry}' in text
    assert "cudaGetLastError" in text
    assert '#include "block_tc.cuh"' in text
    shared = (backend.CSRC / "block_tc.cuh").read_text()
    assert '#include "mma.cuh"' in shared
    both = text + shared
    for kernel in ("block_fwd_kernel", "block_bwd1_kernel",
                   "block_bwd2_kernel", "wgrad_kernel"):
        assert "product<" in _kernel_body(both, kernel), kernel
    assert set(re.findall(r"atomicAdd\((\w+)", both)) <= {"daff", "dA",
                                                           "dC"}
    # one copy of the shared pieces: K8 includes them, defines none
    down = (backend.CSRC / "fused_down.cu").read_text()
    assert '#include "block_tc.cuh"' in down
    for piece in ("struct Geo", "struct Tile", "struct Carve",
                  "struct WPlan", "res_ld(", "wgrad_kernel(",
                  "wsum_kernel(", "block_bwd1_kernel("):
        assert shared.count(piece) == 1, piece
        assert piece not in down and piece not in text, piece
    probes = (backend.CSRC / "fused_bottleneck.cu").read_text()
    assert "kDown" not in probes and "pt_fused_bottleneck" not in probes
    for kernel in ("bottleneck_fwd_kernel", "bottleneck_bwd1_kernel",
                   "bottleneck_bwd2_kernel"):
        assert kernel not in probes
    assert "conv3x3<T, 1>(" in _kernel_body(probes, "probe_conv3x3_kernel")
    body = _kernel_body(probes, "probe_matmuls_kernel")
    assert "product<" in body and "fwd_layout<T, 1>(" in body
    assert "gemm" not in probes
    for piece in ("struct Geo", "struct Tile", "struct Carve", "res_ld("):
        assert piece not in probes, piece
    # the plain versions run on CPU tensors and count no launch
    backend.reset_launches()
    args = [torch.from_numpy(a).requires_grad_() for a in _args(2, False)]
    torch.autograd.grad(TK.fused_bottleneck(*args).sum(), args)
    assert backend.LAUNCHES["fused_bottleneck_fwd"] == 0
    assert backend.LAUNCHES["fused_bottleneck_bwd"] == 0


@pytest.mark.cuda
def test_k7_on_card():
    """K7 forward and backward on the card, through the Functions,
    against the plain versions.  f32: 2e-5, the weight grads (f32 sums
    over rows in K slices) and the affine grads (atomics in any order)
    with atol 2e-5 * sqrt(rows), outside the footprint of the near-ties
    that `near_ties.NearTies` names (PERF.md Tolerances).  Then bf16 at
    batch 4, ResNet-50's stage-2 widths (28^2, 512/128/512) with weights
    at a ResNet's fan-in scale, identity and projection (Cin 256), by the
    bf16 rule of chip_smoke.compare_k7 (>= 99% of the elements within
    3e-2, the sums x sqrt(rows); <= 1e-2 relative Frobenius error),
    dW1-4 bitwise equal over two runs (the slice-order sum), and the
    relu masks read from the kept scratch (`keep`) the plain version's in
    all but 1e-4 of the elements."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")
    from paddle_tpu_torch.tools import near_ties as NT

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
        nw = 4 if proj else 3
        ws = [a.detach() for a in cpu[1:1 + nw]] + ([] if proj else [None])
        aff = TK._pack_affines([a.detach() for a in cpu[1 + nw:]],
                               args[3].shape[1])
        ties = NT.NearTies(cpu[0].detach(), *ws, aff, proj, False,
                           y.detach().cpu(), y_ref.detach())
        assert NT.hold(y.detach().cpu(), y_ref.detach(), ties, "y") is None
        rows = args[0].shape[0] * args[0].shape[1] * args[0].shape[2]
        for i, (g, w) in enumerate(zip(got, want)):
            why = NT.hold(g.cpu(), w, ties, "dx" if i == 0 else "sum", rows)
            assert why is None, (i, why, str(ties))
    for proj in (False, True):
        args = [torch.from_numpy(a).to(dev, torch.bfloat16)
                for a in _args(7, proj, n=4, h=28, w=28, c=512, cm=128,
                               cin=256, he=True)]
        nw = 4 if proj else 3
        x, ws, affs = args[0], args[1:1 + nw], args[1 + nw:]
        w4 = ws[3] if proj else None
        aff = TK._pack_affines(affs, 512)
        dy = torch.randn((4, 28, 28, 512), device=dev, dtype=torch.bfloat16,
                         generator=torch.Generator(device=dev).manual_seed(1))
        y = TK._launch_fwd(x, *ws[:3], w4, aff, proj)
        got = TK._launch_bwd(x, dy, *ws[:3], w4, aff, proj)
        kept = []
        again = TK._launch_bwd(x, dy, *ws[:3], w4, aff, proj, keep=kept)
        assert all(torch.equal(a, b) for a, b in zip(got[1:5], again[1:5])
                   if a is not None)
        # the kept scratch dc0, dc1, dc2 is nonzero where the kernel's relu
        # masks pass a gradient: where the plain version's do, but for
        # near-ties
        plain = []
        TK.fused_bottleneck_bwd_ref(x, dy, *ws[:3], w4, aff, proj,
                                    keep=plain)
        for t, u in zip(kept[2:5], plain[2:5]):
            off = ((t != 0) != (u != 0)).float().mean()
            assert off <= 1e-4, (proj, off.item())
        y_ref = TK.fused_bottleneck_fwd_ref(x, *ws[:3], w4, aff, proj)
        want = TK.fused_bottleneck_bwd_ref(x, dy, *ws[:3], w4, aff, proj)
        rows = 4 * 28 * 28
        for i, (g, w) in enumerate(zip([y, *got], [y_ref, *want])):
            if g is None:
                continue
            g, w = g.float(), w.float()
            atol = 3e-2 * (1.0 if i < 2 else rows ** 0.5)
            bad = ((g - w).abs() > atol + 3e-2 * w.abs()).float().mean()
            rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
            assert torch.isfinite(g).all() and bad <= 1e-2 and rel <= 1e-2, (
                proj, i, bad.item(), rel)
    torch.cuda.synchronize()
    assert backend.LAUNCHES["fused_bottleneck_fwd"] == 4
    assert backend.LAUNCHES["fused_bottleneck_bwd"] == 6
