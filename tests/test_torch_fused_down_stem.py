"""K8 (the stride-2 transition block) and K9 (the stem tail) of the port
against the JAX package's Pallas kernels.

On this CPU host the port's wrappers run their plain PyTorch versions
(`fused_bottleneck_down_fwd_ref` / `_bwd_ref`, `fused_stem_tail_fwd_ref`
/ `_bwd_ref`); the JAX `fused_bottleneck_down` and `fused_stem_tail` run
their Pallas kernels in interpret mode, as tests/test_fused_bottleneck.py
runs them, at that file's shapes (K8: n 8, 8x8, cin 16 -> cout 32, cm 8;
K9: [4, 8, 8, 16]).  Inputs are numpy arrays from a seed handed to both
packages; the grads come from `jax.vjp` and `torch.autograd.grad` with
the same cotangent.

Tolerances: float32 atol = rtol = 2e-5 (the same math, sums taken in
another order; XLA on the CPU contracts the stem's c * a + b into one
fused multiply-add, the port takes the product and then the sum, as the
card does); bfloat16 atol = rtol = 3e-2 (one bf16 rounding of an
intermediate may land on the other side).

`test_k8_on_card` and `test_k9_on_card` hold the CUDA kernels against
the plain versions on the card; they need a GPU and skip here.
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
DOWN_NAMES = "x w1 w2 w3 w4 a1 b1 a2 b2 a3 b3 a4 b4".split()


def _down_args(seed=0, n=8, h=8, w=8, cin=16, cm=8, cout=32, he=False):
    """tests/test_fused_bottleneck.py `_mk_args_proj`, as numpy; with
    `he`, the weights take a ResNet's fan-in scale (1 / sqrt(fan-in))
    in place of 0.2."""
    g = np.random.default_rng(seed).standard_normal

    def s(fan_in):
        return fan_in ** -0.5 if he else 0.2

    arrs = [g((n, h, w, cin)) * 0.5, g((cin, cm)) * s(cin),
            g((3, 3, cm, cm)) * s(9 * cm), g((cm, cout)) * s(cm),
            g((cin, cout)) * s(cin), g(cm) * 0.3 + 1, g(cm) * 0.1,
            g(cm) * 0.3 + 1, g(cm) * 0.1, g(cout) * 0.3 + 1, g(cout) * 0.1,
            g(cout) * 0.3 + 1, g(cout) * 0.1]
    return [a.astype(np.float32) for a in arrs]


def _stem_args(seed=0, shape=(4, 8, 8, 16), levels=None):
    """c, a, b for the stem tail; with `levels`, c is drawn from those
    integers and (a, b) = (1, 0), so most windows hold exact ties (at the
    max and at 0 after the relu)."""
    rng = np.random.default_rng(seed)
    cm = shape[-1]
    if levels is not None:
        c = rng.choice(np.asarray(levels, np.float32), size=shape)
        return [c, np.ones(cm, np.float32), np.zeros(cm, np.float32)]
    return [rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal(cm) * 0.3 + 1).astype(np.float32),
            (rng.standard_normal(cm) * 0.1).astype(np.float32)]


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _both(jf, tf, args, dtype, seed=9):
    """Forward and every grad of `jf` (JAX) and `tf` (port) on the same
    inputs and cotangent: (ty, tgrads, leaves, jy, jgrads)."""
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in args]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
             for a in args]
    jy, vjp = jax.vjp(jf, *jargs)
    dy = np.random.default_rng(seed).standard_normal(jy.shape).astype(
        np.float32)
    jgrads = vjp(jnp.asarray(dy, getattr(jnp, dtype)))
    ty = tf(*targs)
    tgrads = torch.autograd.grad(ty, targs,
                                 torch.from_numpy(dy).to(ty.dtype))
    return ty, tgrads, targs, jy, jgrads


def _assert_all(ty, tgrads, targs, jy, jgrads, names, tol):
    assert ty.dtype == targs[0].dtype
    np.testing.assert_allclose(ty.detach().float().numpy(), _f32(jy),
                               atol=tol, rtol=tol)
    for name, t, j, ref in zip(names, tgrads, jgrads, targs):
        # grads come back in their primal's dtype
        assert t.dtype == ref.dtype, name
        np.testing.assert_allclose(t.float().numpy(), _f32(j), atol=tol,
                                   rtol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_plain_matches_pallas_fwd_and_vjp(dtype):
    out = _both(JK.fused_bottleneck_down, TK.fused_bottleneck_down,
                _down_args(0), dtype)
    assert tuple(out[0].shape) == (8, 4, 4, 32)
    _assert_all(*out, DOWN_NAMES, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_plain_matches_pallas_at_ragged_shapes(dtype):
    """The edges of the CUDA kernels' 16-wide products: Cin 24 and Cout
    40 (no multiples of 16), 10x10 -> 5x5 (Ho Wo = 25, no multiple of
    16) and an odd batch of 3, against the Pallas kernels (interpret)."""
    out = _both(JK.fused_bottleneck_down, TK.fused_bottleneck_down,
                _down_args(7, n=3, h=10, w=10, cin=24, cm=16, cout=40),
                dtype)
    assert tuple(out[0].shape) == (3, 5, 5, 40)
    _assert_all(*out, DOWN_NAMES, TOL[dtype])


@pytest.mark.parametrize("hw", [(8, 8), (6, 10), (2, 2)])
def test_k8_plain_bwd_matches_its_own_autograd(hw):
    """The plain backward (the kernel's reference) against autograd of
    the plain forward, in f32 (atol = rtol = 1e-4: two chains of sums in
    another order), at square, ragged (H/2 = 3, W/2 = 5) and 1x1 output
    geometries: the transposed stride-2 conv's four phases and edges."""
    args = [torch.from_numpy(a) for a in _down_args(3, n=2, h=hw[0],
                                                    w=hw[1])]
    leaves = [t.clone().requires_grad_() for t in args]
    aff = TK._pack_affines(leaves[5:], 32)
    y = TK.fused_bottleneck_down_fwd_ref(*leaves[:5], aff)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(y.shape)).astype(np.float32))
    want = torch.autograd.grad(y, leaves, dy)
    dx, dw1, dw2, dw3, dw4, daff = TK.fused_bottleneck_down_bwd_ref(
        args[0], dy, *args[1:5], TK._pack_affines(args[5:], 32))
    got = [dx, dw1, dw2, dw3, dw4] + [daff[i, :8] for i in range(4)] + [
        daff[i] for i in range(4, 8)]
    for name, g, w in zip(DOWN_NAMES, got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4, msg=name)


def test_k8_checks_match_the_reference():
    args = _down_args(1)
    odd = [args[0][:, :7]] + args[1:]
    with pytest.raises((TypeError, ValueError)):
        JK.fused_bottleneck_down(*[jnp.asarray(a) for a in odd])
    with pytest.raises(ValueError, match="even H and W"):
        TK.fused_bottleneck_down(*[torch.from_numpy(a) for a in odd])
    six = [args[0][:6]] + args[1:]
    with pytest.raises(ValueError, match="does not divide batch"):
        JK.fused_bottleneck_down(*[jnp.asarray(a) for a in six],
                                 batch_tile=4)
    with pytest.raises(ValueError, match="does not divide batch"):
        TK.fused_bottleneck_down(*[torch.from_numpy(a) for a in six],
                                 batch_tile=4)
    targs = [torch.from_numpy(a) for a in args]
    torch.testing.assert_close(TK.fused_bottleneck_down(*targs,
                                                        batch_tile=4),
                               TK.fused_bottleneck_down(*targs))


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_k9_plain_matches_pallas_fwd_and_vjp(case, dtype):
    args = _stem_args(0, levels=(-1, 0, 1, 2) if case == "ties" else None)
    out = _both(JK.fused_stem_tail, TK.fused_stem_tail, args, dtype)
    assert tuple(out[0].shape) == (4, 4, 4, 16)
    _assert_all(*out, ("c", "a", "b"), TOL[dtype])


def test_k9_ties_get_the_full_window_gradient():
    """Equality routing: on a tie-heavy input every element equal to its
    window's max receives that window's whole gradient, as the Pallas
    `_stem_bwd_kernel` routes it; first-wins (the composition's max-pool
    gradient) gives another answer on the same input."""
    c, a, b = _stem_args(1, levels=(-1, 0, 1, 2))
    dy = np.random.default_rng(5).standard_normal((4, 4, 4, 16)).astype(
        np.float32)
    # expected dc from the definition, one window at a time
    hh = np.maximum(c, 0)
    hp = np.pad(hh, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros_like(np.pad(c, ((0, 0), (1, 1), (1, 1), (0, 0))))
    for i in range(4):
        for j in range(4):
            win = hp[:, 2 * i:2 * i + 3, 2 * j:2 * j + 3, :]
            top = win.max(axis=(1, 2), keepdims=True)
            want[:, 2 * i:2 * i + 3, 2 * j:2 * j + 3, :] += np.where(
                win == top, dy[:, i:i + 1, j:j + 1, :], 0.0)
    want = np.where(c > 0, want[:, 1:9, 1:9, :], 0.0)
    tied = (want != 0).sum()
    ct = torch.from_numpy(c).requires_grad_()
    got = torch.autograd.grad(
        TK.fused_stem_tail(ct, torch.from_numpy(a), torch.from_numpy(b)),
        ct, torch.from_numpy(dy))[0]
    _, vjp = jax.vjp(JK.fused_stem_tail, *map(jnp.asarray, (c, a, b)))
    jdc = np.asarray(vjp(jnp.asarray(dy))[0])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(jdc, want, atol=1e-6, rtol=1e-6)
    first = torch.autograd.grad(
        TK._stem_tail_composition(ct, torch.from_numpy(a),
                                  torch.from_numpy(b)),
        ct, torch.from_numpy(dy))[0]
    assert tied > 0 and not np.allclose(first.numpy(), want, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k9_above_112_takes_the_composition(dtype):
    """Sides above 112: both packages run the composition (relu then a
    max-pool whose gradient goes to the first maximum)."""
    args = _stem_args(2, shape=(2, 114, 114, 8))
    out = _both(JK.fused_stem_tail, TK.fused_stem_tail, args, dtype)
    assert tuple(out[0].shape) == (2, 57, 57, 8)
    _assert_all(*out, ("c", "a", "b"), TOL[dtype])


def test_k9_checks_match_the_reference():
    c, a, b = _stem_args(3)
    odd = c[:, :, :7]
    with pytest.raises((TypeError, ValueError)):
        JK.fused_stem_tail(jnp.asarray(odd), jnp.asarray(a), jnp.asarray(b))
    with pytest.raises(ValueError, match="even H and W"):
        TK.fused_stem_tail(torch.from_numpy(odd), torch.from_numpy(a),
                           torch.from_numpy(b))
    with pytest.raises(ValueError, match="does not divide batch"):
        JK.fused_stem_tail(*map(jnp.asarray, (c, a, b)), batch_tile=3)
    with pytest.raises(ValueError, match="does not divide batch"):
        TK.fused_stem_tail(*map(torch.from_numpy, (c, a, b)), batch_tile=3)


def _stem_bwd_tile_model(c, dy, aff, tiling, workers):
    """CPU model of the K9 backward's tiling (csrc/fused_stem_tail.cu)
    for c [N, H, W, C], dy and aff [2, C] as torch tensors: each tile of
    R window rows x Q window columns of one image (`tiling`, clamped as
    `stem_tiling` clamps it) stages h for its 2R + 3 rows and 2Q + 3
    columns only (0 outside the image), computes y of its (R + 1) x (Q +
    1) windows from them alone, takes dy of those windows (0 outside the
    image) and routes it to its own 2R x 2Q pixels in the reference's
    order, then the relu mask and dc.  da/db are per-tile partials, summed
    per worker w over its tiles w, w + workers, ... in order, then over
    the workers in order.  Returns (dc, daff [2, C] f32)."""
    n, h, w, cm = c.shape
    dt = c.dtype
    ho, wo = h // 2, w // 2
    R, Q, _ = TK.stem_tiling(c.shape, dt, tiling)
    tr, tc = -(-ho // R), -(-wo // Q)
    a, b = aff[0], aff[1]
    zero = torch.zeros((), dtype=torch.float32)
    dc = torch.empty_like(c)
    parts = []
    for s in range(n * tr * tc):
        img, rem = divmod(s, tr * tc)
        i0, j0 = rem // tc * R, rem % tc * Q
        # staged h: input rows 2 i0 - 1 .. 2 i0 + 2R + 1, columns alike
        st = torch.zeros((2 * R + 3, 2 * Q + 3, cm), dtype=dt)
        r0, c0 = 2 * i0 - 1, 2 * j0 - 1
        rl, rh = max(r0, 0), min(r0 + 2 * R + 3, h)
        cl, chh = max(c0, 0), min(c0 + 2 * Q + 3, w)
        st[rl - r0:rh - r0, cl - c0:chh - c0] = torch.clamp_min(
            c[img, rl:rh, cl:chh].float() * a + b, 0.0).to(dt)
        y = None
        for ky in range(3):
            for kx in range(3):
                tap = st[ky:ky + 2 * R + 1:2, kx:kx + 2 * Q + 1:2]
                y = tap if y is None else torch.maximum(y, tap)
        dyw = torch.zeros((R + 1, Q + 1, cm), dtype=dy.dtype)
        ih, jh = min(i0 + R + 1, ho), min(j0 + Q + 1, wo)
        dyw[:ih - i0, :jh - j0] = dy[img, i0:ih, j0:jh]
        # the own pixels (those past the image's edge are dropped)
        co = torch.zeros((2 * R, 2 * Q, cm), dtype=dt)
        oh, ow = min(2 * R, h - 2 * i0), min(2 * Q, w - 2 * j0)
        co[:oh, :ow] = c[img, 2 * i0:2 * i0 + oh, 2 * j0:2 * j0 + ow]
        cf = co.float()
        u = cf * a + b
        hh = torch.clamp_min(u, 0.0).to(dt)
        dh = torch.zeros((2 * R, 2 * Q, cm), dtype=torch.float32)
        # own row 2k + pr is in local window row k (pr 0), or k + 1 then
        # k (pr 1); the same in the columns
        for pr in (0, 1):
            for pc in (0, 1):
                acc = torch.zeros((R, Q, cm), dtype=torch.float32)
                for ro in ((0,) if pr == 0 else (1, 0)):
                    for cof in ((0,) if pc == 0 else (1, 0)):
                        ysl = y[ro:ro + R, cof:cof + Q]
                        dsl = dyw[ro:ro + R, cof:cof + Q].float()
                        acc = acc + torch.where(hh[pr::2, pc::2] == ysl, dsl,
                                                zero)
                dh[pr::2, pc::2] = acc
        du = torch.where(u > 0.0, dh, zero)[:oh, :ow]
        dc[img, 2 * i0:2 * i0 + oh, 2 * j0:2 * j0 + ow] = (du * a).to(dt)
        parts.append(torch.stack([(du * cf[:oh, :ow]).sum((0, 1)),
                                  du.sum((0, 1))]))
    total = torch.zeros((2, cm), dtype=torch.float32)
    for wk in range(workers):
        acc = torch.zeros((2, cm), dtype=torch.float32)
        for part in parts[wk::workers]:
            acc = acc + part
        total = total + acc
    return dc, total


# (shape, tiling): tiles that do not divide Ho or Wo, Ho = 1, Wo = 1,
# C 16 and 64; None is the dtype's STEM_BWD_TILING clamped to the image
STEM_TILE_CASES = [((2, 10, 14, 16), (2, 3, 2)), ((3, 2, 6, 64), (2, 2, 4)),
                   ((2, 8, 2, 16), (3, 1, 1)), ((1, 2, 2, 64), None),
                   ((2, 12, 18, 64), None), ((1, 14, 10, 64), (4, 2, 8))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "ties"])
@pytest.mark.parametrize("shape,tiling", STEM_TILE_CASES)
def test_k9_tile_model_matches_pallas_and_plain(shape, tiling, case, dtype):
    """The K9 backward's tiling computes the reference's function: dc
    bitwise the plain version's, within the tolerance of the Pallas
    `_stem_bwd` (interpret mode; XLA may contract c * a + b there), da/db
    within atol 2e-5 * sqrt(rows) of both, at several worker counts."""
    c, a, b = _stem_args(11, shape=shape,
                         levels=(-1, 0, 1, 2) if case == "ties" else None)
    n, h, w, cm = shape
    dy = np.random.default_rng(12).standard_normal(
        (n, h // 2, w // 2, cm)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tc, tdy = torch.from_numpy(c).to(tdt), torch.from_numpy(dy).to(tdt)
    aff = torch.from_numpy(np.stack([a, b]))
    want_dc, want_daff = TK.fused_stem_tail_bwd_ref(tc, tdy, aff)
    jdc, jdaff = JK._stem_bwd(jnp.asarray(c, jdt), jnp.asarray(dy, jdt),
                              jnp.asarray(np.stack([a, b])), None)
    rows = n * h * w
    for workers in (1, 2, 5):
        got_dc, got_daff = _stem_bwd_tile_model(tc, tdy, aff, tiling,
                                                workers)
        assert got_dc.dtype == tdt
        assert torch.equal(got_dc, want_dc), workers
        np.testing.assert_allclose(got_dc.float().numpy(), _f32(jdc),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        for ref in (want_daff.numpy(), np.asarray(jdaff)):
            np.testing.assert_allclose(got_daff.numpy(), ref,
                                       atol=2e-5 * rows ** 0.5, rtol=2e-5)


def test_stem_tiling_clamps_to_the_image_and_channels():
    assert TK.STEM_BWD_TILING[torch.bfloat16] == (8, 14, 4)
    assert TK.stem_tiling((128, 112, 112, 64), torch.bfloat16) == (8, 14, 4)
    assert TK.stem_tiling((128, 112, 112, 64), torch.float32) == (2, 28, 8)
    # Ho = Wo = 1 and C = 16 (two bf16 vectors, four f32 ones)
    assert TK.stem_tiling((3, 2, 2, 16), torch.bfloat16) == (1, 1, 2)
    assert TK.stem_tiling((3, 2, 2, 16), torch.float32) == (1, 1, 4)
    assert TK.stem_tiling((1, 8, 60, 64), torch.bfloat16,
                          (2, 56, 8)) == (2, 30, 8)
    # one backward launch: no second summing kernel, and the only atomic
    # is the blocks' arrival counter (da/db are summed in a fixed order)
    text = (backend.CSRC / "fused_stem_tail.cu").read_text()
    assert "stem_sum_kernel" not in text
    assert 'extern "C" int pt_fused_stem_tail_plan' in text
    body = _kernel_body(text, "stem_bwd_kernel")
    assert body.count("atomicAdd(") == 1 and "atomicAdd(counter, 1u)" in body


def _with_includes(name):
    """A csrc source and the csrc headers it includes."""
    text = (backend.CSRC / name).read_text()
    for inc in re.findall(r'#include "([^"]+)"', text):
        text += (backend.CSRC / inc).read_text()
    return text


def _kernel_body(text, name):
    start = text.index(f"\n{name}(")
    return text[start:text.index("\n}\n", start)]


def test_k8_k9_sources_and_launch_counters():
    assert "fused_stem_tail" in backend.SOURCES
    assert "fused_down" in backend.SOURCES
    # K8: its own source, on the tensor cores
    text = _with_includes("fused_down.cu")
    for entry in ("pt_fused_down_fwd", "pt_fused_down_bwd",
                  "pt_fused_down_plan"):
        assert f'extern "C" int {entry}' in text
    assert "cudaGetLastError" in text
    assert "mma.sync" in text or "wgmma" in text
    # K8's own B2 and the stride-2 instances of the pieces it shares with
    # K7 (csrc/block_tc.cuh) all reach the tensor-core product
    for kernel in ("down_bwd2_kernel", "block_fwd_kernel",
                   "block_bwd1_kernel", "wgrad_kernel"):
        assert "product<" in _kernel_body(text, kernel), kernel
    for inst in ("launch_fwd<float, 2, true>", "launch_bwd<T, 2, true>",
                 "plan_out<float, 2, true>"):
        assert inst in text, inst
    # K7 moved to the same pieces (csrc/fused_block.cu), P1 runs its
    # stride-1 conv3x3 and P2 its tensor-core product; the CUDA-core
    # `gemm` and K8's old instantiation are gone
    text = (backend.CSRC / "fused_bottleneck.cu").read_text()
    assert "conv3x3<T, 1>(" in _kernel_body(text, "probe_conv3x3_kernel")
    assert "product<" in _kernel_body(text, "probe_matmuls_kernel")
    assert "gemm" not in text
    assert "bottleneck_fwd_kernel" not in text
    assert "pt_fused_bottleneck_down" not in text
    text = (backend.CSRC / "fused_stem_tail.cu").read_text()
    for entry in ("pt_fused_stem_tail_fwd", "pt_fused_stem_tail_bwd"):
        assert f'extern "C" int {entry}' in text
    assert "cudaGetLastError" in text
    # the plain versions run on CPU tensors and count no launch
    backend.reset_launches()
    args = [torch.from_numpy(a).requires_grad_() for a in _down_args(2)]
    torch.autograd.grad(TK.fused_bottleneck_down(*args).sum(), args)
    sargs = [torch.from_numpy(a).requires_grad_() for a in _stem_args(2)]
    torch.autograd.grad(TK.fused_stem_tail(*sargs).sum(), sargs)
    assert not any(backend.LAUNCHES[k] for k in (
        "fused_bottleneck_down_fwd", "fused_bottleneck_down_bwd",
        "fused_stem_tail_fwd", "fused_stem_tail_bwd"))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")


def _card_vs_cpu(fn, args, grads_rows, ties_of=None):
    """fn on the card (the kernels) and on the CPU (the plain versions)
    from the same f32 inputs and cotangent: output 2e-5, grads 2e-5 with
    atol 2e-5 * sqrt(rows) for the sums over rows (f32 atomics or
    partials in another order).  `ties_of(y_card, y_cpu)` names the
    near-ties whose footprint the comparison leaves out
    (`near_ties.hold`)."""
    from paddle_tpu_torch.tools import near_ties as NT

    dev = torch.device("cuda")
    leaves = [torch.from_numpy(a).to(dev).requires_grad_() for a in args]
    y = fn(*leaves)
    dy = torch.randn(y.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))
    got = torch.autograd.grad(y, leaves, dy)
    cpu = [torch.from_numpy(a).requires_grad_() for a in args]
    y_ref = fn(*cpu)
    want = torch.autograd.grad(y_ref, cpu, dy.cpu())
    ties = ties_of(y.detach().cpu(), y_ref.detach()) if ties_of else None
    assert NT.hold(y.detach().cpu(), y_ref.detach(), ties, "y") is None
    for i, (g, w) in enumerate(zip(got, want)):
        why = NT.hold(g.cpu(), w, ties, "dx" if i == 0 else "sum",
                      grads_rows)
        assert why is None, (i, why, str(ties))


@pytest.mark.cuda
def test_k8_on_card():
    """K8 forward and backward on the card, through the Function, against
    the plain versions in f32: a square and a ragged geometry; Cin 24,
    Cout 40, 10x10 -> 5x5 at batch 3 (the products' partial 16-wide
    edges); Cin 6, Cm 4, Cout 10 (no multiple of 8: the element-wise
    loaders).  Then ResNet-50's stage-3 transition (28^2, 512 -> 1024,
    Cm 256, weights at a ResNet's fan-in scale) in bf16 at batch 8,
    against the plain version on the card by the bf16 rule of
    chip_smoke.compare_k7 (>= 99% of the elements within 3e-2, the sums
    x sqrt(rows); <= 1e-2 relative Frobenius error).  At the small
    shapes' weight scale of 0.2 these widths give activations in the
    hundreds, where the plain f32 version itself misses that rule
    against float64 products; chip_smoke.py's `k8_precision` holds the
    kernel there, on these inputs, against a model of the tensor core's
    sums."""
    _needs_card()
    backend.reset_launches()
    from paddle_tpu_torch.tools import near_ties as NT

    cases = [dict(n=4, h=8, w=8, cm=32), dict(n=4, h=10, w=6, cm=32),
             dict(n=3, h=10, w=10, cin=24, cm=16, cout=40),
             dict(n=1, h=6, w=10, cin=6, cm=4, cout=10)]
    for case in cases:
        args = _down_args(5, **case)
        t = [torch.from_numpy(a) for a in args]
        aff = TK._pack_affines(t[5:], t[3].shape[1])
        _card_vs_cpu(TK.fused_bottleneck_down, args,
                     case["n"] * case["h"] * case["w"] // 4,
                     lambda yc, yp: NT.NearTies(t[0], *t[1:5], aff, True,
                                                True, yc, yp))
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev, torch.bfloat16).requires_grad_()
            for a in _down_args(6, n=8, h=28, w=28, cin=512, cm=256,
                                cout=1024, he=True)]
    y = TK.fused_bottleneck_down(*args)
    dy = torch.randn(y.shape, device=dev, dtype=torch.bfloat16,
                     generator=torch.Generator(device=dev).manual_seed(1))
    got = [y] + list(torch.autograd.grad(y, args, dy))
    with torch.no_grad():
        p = [a.detach() for a in args]
        paff = TK._pack_affines(p[5:], 1024)
        y_ref = TK.fused_bottleneck_down_fwd_ref(*p[:5], paff)
        dx, dw1, dw2, dw3, dw4, daff = TK.fused_bottleneck_down_bwd_ref(
            p[0], dy, *p[1:5], paff)
    want = [y_ref, dx, dw1, dw2, dw3, dw4] + [
        daff[i, :256] for i in range(4)] + [daff[i] for i in range(4, 8)]
    rows = 8 * 14 * 14
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        atol = 3e-2 * (1.0 if i < 2 else rows ** 0.5)
        bad = ((g - w).abs() > atol + 3e-2 * w.abs()).float().mean().item()
        rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert torch.isfinite(g).all() and bad <= 1e-2 and rel <= 1e-2, (
            i, bad, rel)
    torch.cuda.synchronize()
    assert backend.LAUNCHES["fused_bottleneck_down_fwd"] == 5
    assert backend.LAUNCHES["fused_bottleneck_down_bwd"] == 5


@pytest.mark.cuda
def test_k9_on_card():
    """K9 forward and backward on the card against the plain versions,
    on random and tie-heavy inputs; the forward is exact.  Then the raw
    backward at STEM_TILE_CASES (tiles that do not divide Ho or Wo, Ho =
    1, Wo = 1, C 16 and 64) and at the default tiling, f32 and bf16: y
    and dc bitwise the plain versions' on the card, da/db within atol
    2e-5 * sqrt(rows) of them and bitwise equal over two calls."""
    _needs_card()
    backend.reset_launches()
    for levels in (None, (-1, 0, 1, 2)):
        args = _stem_args(6, shape=(4, 16, 12, 16), levels=levels)
        _card_vs_cpu(TK.fused_stem_tail, args, 4 * 16 * 12)
    torch.cuda.synchronize()
    assert backend.LAUNCHES["fused_stem_tail_fwd"] == 2
    assert backend.LAUNCHES["fused_stem_tail_bwd"] == 2
    dev = torch.device("cuda")
    for shape, tiling in STEM_TILE_CASES + [((3, 22, 30, 64), None)]:
        for levels in (None, (-1, 0, 1, 2)):
            c, a, b = _stem_args(7, shape=shape, levels=levels)
            n, h, w, cm = shape
            dy = np.random.default_rng(8).standard_normal(
                (n, h // 2, w // 2, cm)).astype(np.float32)
            aff = torch.from_numpy(np.stack([a, b])).to(dev)
            for dt in (torch.float32, torch.bfloat16):
                tc = torch.from_numpy(c).to(dev, dt)
                tdy = torch.from_numpy(dy).to(dev, dt)
                y = TK._launch_stem_fwd(tc, aff)
                assert torch.equal(y, TK.fused_stem_tail_fwd_ref(tc, aff))
                dc, daff = TK._launch_stem_bwd(tc, tdy, aff, tiling)
                dc2, daff2 = TK._launch_stem_bwd(tc, tdy, aff, tiling)
                want_dc, want_daff = TK.fused_stem_tail_bwd_ref(tc, tdy, aff)
                case = (shape, tiling, levels, dt)
                assert torch.equal(dc, want_dc), case
                assert torch.equal(dc2, dc) and torch.equal(daff2, daff), case
                torch.testing.assert_close(daff, want_daff, rtol=2e-5,
                                           atol=2e-5 * (n * h * w) ** 0.5)
