"""The f32 card-check criterion of K7 and K8 (`tools/near_ties.py`),
exercised on the CPU: the pre-activations it reads are the plain
forward's, a planted near-tie is named with its footprint, `hold`
checks elementwise at 2e-5 as before, falling back to the footprint
(and, for the weight grads, the norm) only where that fails and a
near-tie is named, and a wrong forward (planted controls) names none."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import fused_bottleneck as TK
from paddle_tpu_torch.tools import near_ties as NT
from torch_threads import torch_threads  # noqa: F401

CASES = {"k7_id": (False, False), "k7_proj": (True, False),
         "k8": (True, True)}


def _args(kind, seed=0, n=2, h=8, w=8, cin=16, cm=8):
    proj, down = CASES[kind]
    cout = 32 if proj else cin
    g = np.random.default_rng(seed).standard_normal
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    x = t(g((n, h, w, cin)) * 0.5)
    ws = [t(g((cin, cm)) * 0.3), t(g((3, 3, cm, cm)) * 0.2),
          t(g((cm, cout)) * 0.3), t(g((cin, cout)) * 0.3) if proj else None]
    affs = [t(g(c) * 0.3 + (1.0 if i % 2 == 0 else 0.0))
            for i, c in enumerate([cm] * 4 + [cout] * 4)]
    return x, ws, TK._pack_affines(affs, cout), proj, down


def _fwd(x, ws, aff, proj, down):
    if down:
        return TK.fused_bottleneck_down_fwd_ref(x, *ws, aff)
    return TK.fused_bottleneck_fwd_ref(x, *ws, aff, proj)


@pytest.mark.parametrize("kind", list(CASES))
def test_preactivations_are_the_plain_forward(kind):
    x, ws, aff, proj, down = _args(kind)
    (u0, m0), (u1, m1), (pre, m2) = NT.preactivations(x, *ws, aff, proj,
                                                      down)
    torch.testing.assert_close(torch.clamp_min(pre, 0.0),
                               _fwd(x, ws, aff, proj, down), atol=0, rtol=0)
    s = 2 if down else 1
    assert u0.shape == (2, 8, 8, 8) and u1.shape == (2, 8 // s, 8 // s, 8)
    for u, m in ((u0, m0), (u1, m1), (pre, m2)):
        assert bool((u.abs() <= m * (1 + 1e-6)).all())


@pytest.mark.parametrize("kind", list(CASES))
def test_a_planted_near_tie_is_named_with_its_footprint(kind):
    x, ws, aff, proj, down = _args(kind)
    pre = NT.preactivations(x, *ws, aff, proj, down)[2][0]
    # move b3 of channel 5 so that pre at pixel (1, 2, 3) is ~0
    aff = aff.clone()
    aff[5, 5] -= pre[1, 2, 3, 5]
    y = _fwd(x, ws, aff, proj, down)
    # the "card": the plain y with noise of 5e-7 of each element, as the
    # sound card runs read
    noise = torch.from_numpy(np.random.default_rng(1).uniform(
        -5e-7, 5e-7, y.shape).astype(np.float32))
    ties = NT.NearTies(x, *ws, aff, proj, down, y * (1 + noise), y)
    assert ties.counts[2] >= 1 and ties.n == sum(ties.counts)
    assert 1e-7 <= ties.ratio <= NT.NOISE_MAX and ties.fault is None
    assert bool(ties.y_px[1, 2, 3])
    s = 2 if down else 1
    # dx: the input pixels the output pixel's 3x3 window reads
    rows = range(s * 2 - 1, s * 2 + 2)
    cols = range(s * 3 - 1, s * 3 + 2)
    assert all(bool(ties.dx_px[1, r, c]) for r in rows for c in cols)
    assert "near-ties" in str(ties)


def test_hold_checks_outside_the_footprint():
    x, ws, aff, proj, down = _args("k7_id")
    y = _fwd(x, ws, aff, proj, down)
    clean = NT.NearTies(x, *ws, aff, proj, down, y, y)
    assert clean.n == 0 and clean.ratio == 2.0 ** -24
    assert NT.hold(y, y, clean, "y") is None
    bumped = y.clone()
    bumped[0, 4, 4, 0] += 1e-3
    assert "no near-tie" in NT.hold(bumped, y, clean, "y")
    # a tie at (0, 4, 4): y there is left out, dx on its 3x3 neighbourhood
    ties = NT.NearTies(x, *ws, aff, proj, down, y, y)
    ties.n, ties.y_px = 1, torch.zeros_like(ties.y_px)
    ties.y_px[0, 4, 4] = True
    ties.dx_px = ties.y_px.clone()
    ties.dx_px[0, 3:6, 3:6] = True
    assert NT.hold(bumped, y, ties, "y") is None and ties.used == 1
    dx = torch.randn(y.shape)
    moved = dx.clone()
    moved[0, 5, 5] += 1.0
    assert NT.hold(moved, dx, ties, "dx") is None
    moved[0, 6, 6] += 1.0
    assert NT.hold(moved, dx, ties, "dx") is not None
    # sums: elementwise without a tie, in norm with one
    dw = torch.randn(16, 8) * 10
    off = dw.clone()
    off[0, 0] += 1e-2
    assert "no near-tie" in NT.hold(off, dw, clean, "sum", rows=128)
    assert NT.hold(off, dw, ties, "sum", rows=128) is None
    # what holds elementwise does not use the footprint
    assert NT.hold(dw, dw, ties, "sum", rows=128) is None
    assert ties.used == 3
    assert "Frobenius" in NT.hold(dw * 1.1, dw, ties, "sum", rows=128)
    assert "non-finite" in NT.hold(dw * float("nan"), dw, ties, "sum")


def _controls(x, ws, aff, proj, down):
    """Two wrong f32 forwards: h1 rounded to bf16 before the last
    product, and one tile row of one image off by 1e-3 relative."""
    y = _fwd(x, ws, aff, proj, down)
    (_, (u1, _), (pre, _)) = NT.preactivations(x, *ws, aff, proj, down)
    h1 = torch.clamp_min(u1, 0.0)
    cm, cout = ws[2].shape
    dh = (h1.to(torch.bfloat16).float() - h1).reshape(-1, cm)
    moved = (TK._dot(dh, ws[2]) * aff[4, :cout]).reshape(pre.shape)
    row = y.clone()
    row[1, 2] *= 1 + 1e-3
    return y, {"h1_bf16": torch.clamp_min(pre + moved, 0.0), "row": row}


@pytest.mark.parametrize("control", ["h1_bf16", "row"])
@pytest.mark.parametrize("kind", list(CASES))
def test_a_wrong_forward_names_no_near_tie(kind, control):
    x, ws, aff, proj, down = _args(kind)
    y, bad = _controls(x, ws, aff, proj, down)
    y_bad = bad[control]
    ties = NT.NearTies(x, *ws, aff, proj, down, y_bad, y)
    assert ties.ratio > NT.NOISE_MAX and "not f32 reordering" in ties.fault
    assert "not f32 reordering" in NT.hold(y_bad, y, ties, "y")
    # nor are the grads excused: a 0.5% error fails dx and a weight grad
    g = torch.randn(y.shape[0], *x.shape[1:])
    assert NT.hold(g * 1.005, g, ties, "dx") is not None
    dw = torch.randn(16, 8) * 10
    assert NT.hold(dw * 1.005, dw, ties, "sum", rows=128) is not None
    assert ties.used == 0 and "none named" in str(ties)


def test_too_many_near_ties_name_none():
    """a1 = b1 = 0 puts every u0 on 0 exactly: within the noise ceiling,
    but far more near-ties than a sound draw has."""
    x, ws, aff, proj, down = _args("k7_id")
    aff = aff.clone()
    aff[0:2] = 0.0
    y = _fwd(x, ws, aff, proj, down)
    ties = NT.NearTies(x, *ws, aff, proj, down, y, y)
    n_u0 = x.shape[0] * x.shape[1] * x.shape[2] * ws[0].shape[1]
    assert ties.ratio <= NT.NOISE_MAX and ties.counts[0] == n_u0
    assert "of the relu inputs" in ties.fault
    bumped = y.clone()
    bumped[0, 4, 4, 0] += 1e-3
    assert "of the relu inputs" in NT.hold(bumped, y, ties, "y")
