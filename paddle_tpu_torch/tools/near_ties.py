"""Named near-ties of K7 and K8: the f32 criterion of their card checks.

K7 and K8 have three relus: h0 = relu(u0), h1 = relu(u1) and y =
relu(pre).  The card sums each pre-activation in another order than the
plain version, so where one lies within that rounding noise of 0 its
mask may fall the other way on the card.  In f32 the forward then moves
by at most |u| (tiny), but the backward routes a whole gradient element
differently: dx moves on a 3x3 neighbourhood of the pixel and every
weight or affine gradient the pixel feeds moves by one of its `rows`
terms.  Such an element is a near-tie, and the f32 check names it
instead of failing on it:

- The noise is measured, not assumed.  y = relu(pre) is the one
  pre-activation the forward exposes (exactly, in f32), so on the
  elements where both sides are positive |y_card - y_plain| is the
  card's noise in pre.  A sum's rounding noise scales with the sum of
  its terms' magnitudes, so the measured ratio noise / sum|terms| over
  pre carries to u0 and u1 through their own sums of |terms|.  The
  width of element u is TIE_MARGIN times that ratio times its sum of
  |terms|; |u| <= width names a near-tie.
- Footprints.  A near-tie in pre or u1 at output pixel (i, j) marks
  that pixel of y and, for dx, the input pixels its 3x3 window (K8:
  stride 2) reads; a near-tie in u0 at input pixel q marks q for dx and
  the output pixels whose window reads q for y.
- The noise has a ceiling, NOISE_MAX, fixed from the sound runs (the
  ratio read 2.2-5.1e-7 at every K7/K8 geometry of chip_smoke.py), so
  a wrong forward cannot widen the ties it is excused by: one that
  rounds an intermediate to bf16 reads ~4e-3.  Above the ceiling, or
  with more near-ties than TIE_SHARE_MAX of the relu inputs (~1e-5 in
  the sound runs), no near-tie is named.  The share is taken of the
  relu inputs, not of the pixels: at 7x7 one tie's 3x3 window already
  covers 9% of the pixels.
- The check: first every element within atol = rtol = 2e-5 (the sums
  over rows atol 2e-5 * sqrt(rows)), as without ties; most draws hold
  so.  Only where that fails do the named near-ties decide: every
  element outside their footprint must still hold; the weight and
  affine gradients take every pixel's term, so they are held in norm
  instead, ||got - want|| <= TIE_NORM * ||want||.  Without a named
  near-tie a failure stands.  `NearTies.used` counts the comparisons
  that needed the footprint.

The inputs are never re-drawn to avoid a tie.
"""

import torch
import torch.nn.functional as TF

from ..kernels.fused_bottleneck import _dot, _im2col, _im2col_s2, _pad_hw

TOL = 2e-5
TIE_MARGIN = 2.0
NOISE_MAX = 1e-6
TIE_SHARE_MAX = 1e-3
# the weight and affine grads with a named near-tie: one flipped pixel
# moves one of a sum's `rows` terms, ~1/sqrt(rows) of a column in norm
# and far less of the whole tensor (measured on the card: PERF.md)
TIE_NORM = 1e-2
_EPS32 = 2.0 ** -24


def _abs_sum(a, b):
    return _dot(a.abs(), b.abs())


def preactivations(x, w1, w2, w3, w4, aff, proj, down):
    """The plain forward's three relu inputs in f32 and the sums of the
    magnitudes of their terms: ((u0, m0) [N, H, W, Cm], (u1, m1) [N, Ho,
    Wo, Cm], (pre, m2) [N, Ho, Wo, Cout])."""
    dt = x.dtype
    n, h, w, cin = x.shape
    cm, cout = w1.shape[1], w3.shape[1]
    s = 2 if down else 1
    ho, wo = h // s, w // s
    a1, b1, a2, b2 = (aff[i, :cm] for i in range(4))
    a3, b3, a4, b4 = (aff[i, :cout] for i in range(4, 8))
    xm = x.reshape(n * h * w, cin)
    u0 = _dot(xm, w1) * a1 + b1
    m0 = _abs_sum(xm, w1) * a1.abs() + b1.abs()
    h0 = torch.clamp_min(u0, 0.0).to(dt).reshape(n, h, w, cm)
    patches = _im2col_s2 if down else _im2col
    p = patches(_pad_hw(h0), n, ho, wo, cm)
    w2r = w2.reshape(9 * cm, cm)
    u1 = _dot(p, w2r) * a2 + b2
    m1 = _abs_sum(p, w2r) * a2.abs() + b2.abs()
    h1 = torch.clamp_min(u1, 0.0).to(dt)
    xs = (x[:, ::2, ::2, :] if down else x).reshape(n * ho * wo, cin)
    if proj or down:
        sc = _dot(xs, w4) * a4 + b4
        msc = _abs_sum(xs, w4) * a4.abs() + b4.abs()
    else:
        sc, msc = xs.float(), xs.float().abs()
    pre = _dot(h1, w3) * a3 + b3 + sc
    m2 = _abs_sum(h1, w3) * a3.abs() + b3.abs() + msc.abs()
    return ((u0.reshape(n, h, w, cm), m0.reshape(n, h, w, cm)),
            (u1.reshape(n, ho, wo, cm), m1.reshape(n, ho, wo, cm)),
            (pre.reshape(n, ho, wo, cout), m2.reshape(n, ho, wo, cout)))


def _spread(mask, down, to_input):
    """Pixels [N, H', W'] reached through the 3x3 window (stride 2 for
    K8): output -> the input pixels it reads, or input -> the output
    pixels that read it."""
    t = mask.float()[:, None]
    if not down:
        out = TF.max_pool2d(t, 3, 1, 1)
    elif to_input:
        ones = torch.ones((1, 1, 3, 3), dtype=t.dtype, device=t.device)
        out = TF.conv_transpose2d(t, ones, stride=2, padding=1,
                                  output_padding=1)
    else:
        out = TF.max_pool2d(t, 3, 2, 1)
    return out[:, 0] > 0


class NearTies:
    """The near-ties of one K7/K8 input against the card's y (see the
    module docstring): counts per relu, the measured noise ratio, the y
    and dx footprints ([N, Ho, Wo] and [N, H, W] bool), and `fault`,
    why none may be named (None when they may)."""

    def __init__(self, x, w1, w2, w3, w4, aff, proj, down, y_card, y_plain):
        (u0, m0), (u1, m1), (pre, m2) = preactivations(
            x, w1, w2, w3, w4, aff, proj, down)
        yc, yp = y_card.float(), y_plain.float()
        both = (yc > 0) & (yp > 0)
        ratio = ((yc - yp).abs() / m2.clamp_min(1e-30))[both]
        self.ratio = max(float(ratio.max()) if ratio.numel() else 0.0,
                         _EPS32)
        tie0 = u0.abs() <= TIE_MARGIN * self.ratio * m0
        tie1 = u1.abs() <= TIE_MARGIN * self.ratio * m1
        tie2 = pre.abs() <= TIE_MARGIN * self.ratio * m2
        self.counts = (int(tie0.sum()), int(tie1.sum()), int(tie2.sum()))
        self.n = sum(self.counts)
        share = self.n / (u0.numel() + u1.numel() + pre.numel())
        self.fault = None
        if self.ratio > NOISE_MAX:
            self.fault = (f"card noise {self.ratio:.2e} of the sum of "
                          f"|terms| > {NOISE_MAX:g}: not f32 reordering")
        elif share > TIE_SHARE_MAX:
            self.fault = (f"{self.n} near-ties, {share:.2e} of the relu "
                          f"inputs > {TIE_SHARE_MAX:g}")
        px_in = tie0.any(-1)
        px_out = tie1.any(-1) | tie2.any(-1)
        self.y_px = px_out | _spread(px_in, down, False)
        self.dx_px = px_in | _spread(px_out, down, True)
        self.used = 0

    def __str__(self):
        return (f"{self.n} near-ties (u0 {self.counts[0]}, u1 "
                f"{self.counts[1]}, pre {self.counts[2]}; noise "
                f"{self.ratio:.2e} of the sum of |terms|, width x"
                f"{TIE_MARGIN:g}); {self.used} comparisons needed their "
                "footprint" + (f"; none named: {self.fault}"
                               if self.fault else ""))


def hold(got, want, ties, kind, rows=1):
    """The f32 check of one K7/K8 output against its plain version: None
    when it holds, else what failed.  Elementwise first; where that
    fails and `ties` names near-ties, kind "y" and "dx" skip the
    footprint's pixels and "sum" (a weight or affine grad over `rows`
    pixels) is held in norm."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return "non-finite values"
    atol = TOL * (rows ** 0.5 if kind == "sum" and rows > 1 else 1.0)
    bad = (got - want).abs() > atol + TOL * want.abs()
    if not bad.any():
        return None
    err = (got - want).abs().max().item()
    if ties is None or ties.n == 0:
        return f"max_abs_err {err:.3e} > atol {atol:.3g}, no near-tie named"
    if ties.fault:
        return f"max_abs_err {err:.3e} > atol {atol:.3g}; {ties.fault}"
    if kind == "sum":
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        if rel > TIE_NORM:
            return (f"relative Frobenius error {rel:.2e} > {TIE_NORM:g} "
                    f"with {ties.n} near-ties")
    else:
        foot = ties.y_px if kind == "y" else ties.dx_px
        bad = bad & ~foot[..., None].to(bad.device)
        if bad.any():
            err = ((got - want).abs() * bad).max().item()
            return (f"{int(bad.sum())} elements outside the near-ties' "
                    f"footprint off, max_abs_err {err:.3e} > atol "
                    f"{atol:.3g}")
    ties.used += 1
    return None
