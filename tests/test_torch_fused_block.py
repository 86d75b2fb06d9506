"""The envelope of K7's and K8's CUDA route, held on this CPU host.

`fused_bottleneck._check_launch` is what the wrappers run before they
launch K7 (`_launch_fwd`, `_launch_bwd`) or K8 (`_launch_down_fwd`,
`_launch_down_bwd`) on a CUDA tensor: every input the route refuses
raises ValueError there, before any launch, and nothing falls back to the
plain version.  The checks read shapes and strides only, so they run on
CPU tensors here (the 2^31-pixel case on the meta device, which holds no
data).  `_plan_dict` turns a plan entry's 18 numbers into `block_plan` /
`down_plan`'s dict; its scratch arithmetic is held here too.
"""

import pytest
import torch

from paddle_tpu_torch.kernels import fused_bottleneck as TK
from torch_threads import torch_threads  # noqa: F401


def _block(n=2, h=6, w=5, cin=16, cm=8, cout=16, device="cpu"):
    kw = dict(dtype=torch.bfloat16, device=device)
    return (torch.zeros((n, h, w, cin), **kw), torch.zeros((cin, cm), **kw),
            torch.zeros((3, 3, cm, cm), **kw), torch.zeros((cm, cout), **kw),
            torch.zeros((cin, cout), **kw))


def test_envelope_takes_any_channel_count_and_odd_sides():
    """Channel counts that are no multiple of 8 and odd sides stay
    inside: the loaders fall back to single elements, the last tile of
    rows is ragged."""
    for shape in (dict(cin=6, cm=4, cout=10), dict(h=7, w=7),
                  dict(h=1, w=1, cm=1), dict(w=TK._MAX_W, h=1, n=1)):
        TK._check_launch(*_block(**shape))


def _noncontig(t):
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


@pytest.mark.parametrize("case", [
    "cm_not_power_of_two", "x_not_contiguous", "w1_not_contiguous",
    "w2_not_contiguous", "w3_not_contiguous", "w4_not_contiguous",
    "w_too_wide", "too_many_pixels"])
def test_envelope_refusals_raise_value_error(case):
    x, w1, w2, w3, w4 = _block()
    match = "contiguous"
    if case == "cm_not_power_of_two":
        x, w1, w2, w3, w4 = _block(cm=12)
        match = "power of two"
    elif case == "x_not_contiguous":
        x = x.permute(0, 2, 1, 3)
    elif case == "w1_not_contiguous":
        w1 = _noncontig(w1)
    elif case == "w2_not_contiguous":
        w2 = _noncontig(w2)
    elif case == "w3_not_contiguous":
        w3 = _noncontig(w3)
    elif case == "w4_not_contiguous":
        w4 = _noncontig(w4)
    elif case == "w_too_wide":
        x, w1, w2, w3, w4 = _block(n=1, h=1, w=TK._MAX_W + 1)
        match = "W <= 4095"
    else:
        x, w1, w2, w3, w4 = _block(n=2 ** 16, h=2 ** 8, w=2 ** 7,
                                   device="meta")
        match = "2\\^31"
    assert not (case.endswith("_not_contiguous")
                and all(t.is_contiguous() for t in (x, w1, w2, w3, w4)))
    with pytest.raises(ValueError, match=match):
        TK._check_launch(x, w1, w2, w3, w4)


def test_wrappers_check_before_any_launch():
    """The K7 and K8 launchers run the check first: a refused input
    raises ValueError on its way to the kernel, here without a card."""
    x, w1, w2, w3, w4 = _block(cm=12)
    aff = torch.zeros((8, 16))
    dy = torch.zeros_like(x)
    for call in (lambda: TK._launch_fwd(x, w1, w2, w3, w4, aff, True),
                 lambda: TK._launch_bwd(x, dy, w1, w2, w3, w4, aff, True),
                 lambda: TK._launch_down_fwd(x, w1, w2, w3, w4, aff),
                 lambda: TK._launch_down_bwd(x, dy, w1, w2, w3, w4, aff)):
        with pytest.raises(ValueError, match="power of two"):
            call()


@pytest.mark.parametrize("stride", [1, 2])
def test_plan_dict_reads_the_plan_entry(stride):
    """The 18 values of `plan_out` (csrc/block_tc.cuh) as K7's and K8's
    plan dicts; the scratch is h0, dc0 [R_in, Cm], h1, dc1 [R_out, Cm],
    dc2, dc4 [R_out, Cout] in the activation dtype plus the f32 partials."""
    out = [8, 6, 8, 896, 1280, 896, 190000, 220000, 130000, 36, 36, 36,
           0, 2500000, 540, 1, 1, 1]
    n, h, w, cm, cout = 128, 56, 56, 64, 256
    plan = TK._plan_dict(out, n, h, w, cm, cout, stride, torch.bfloat16)
    r_in, r_out = n * h * w, n * (h // stride) * (w // stride)
    scratch = 2 * (2 * r_in * cm + 2 * r_out * cm + 2 * r_out * cout)
    assert plan["tile_rows"] == (8, 6, 8)
    assert plan["tile_px"] == tuple(t * (w // stride) for t in (8, 6, 8))
    assert plan["blocks"] == (896, 1280, 896)
    assert plan["smem"] == (190000, 220000, 130000)
    assert plan["per_sm"] == (1, 1, 1)
    assert plan["slices"] == (36, 36, 36, 0)
    assert plan["partials"] == 2500000 and plan["wgrad_items"] == 540
    assert plan["scratch_mb"] == pytest.approx((scratch + 4 * 2500000) / 1e6)


def _masks_args(kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    n, h, w, cin, cm, cout = 2, 6, 4, 8, 4, 8 if kind == "id" else 12

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    x = rnd(n, h, w, cin)
    ws = [rnd(cin, cm, scale=0.4), rnd(3, 3, cm, cm, scale=0.2),
          rnd(cm, cout, scale=0.4), rnd(cin, cout, scale=0.4)]
    aff = TK._pack_affines([rnd(c) * 0.3 + (1.0 - i % 2) for i, c in
                            enumerate([cm] * 4 + [cout] * 4)], cout)
    ho, wo = (h // 2, w // 2) if kind == "down" else (h, w)
    return x, rnd(n, ho, wo, cout), ws, aff


def _plain_bwd(kind, x, dy, ws, aff, masks=None, keep=None):
    if kind == "down":
        return TK.fused_bottleneck_down_bwd_ref(x, dy, *ws, aff, masks=masks,
                                                keep=keep)
    proj = kind == "proj"
    return TK.fused_bottleneck_bwd_ref(x, dy, *ws[:3], ws[3] if proj else
                                       None, aff, proj, masks=masks,
                                       keep=keep)


@pytest.mark.parametrize("kind", ["id", "proj", "down"])
def test_plain_backward_takes_relu_masks(kind):
    """`masks` replaces the plain backward's three relu masks (u0 > 0,
    u1 > 0, pre > 0; chip_smoke's precision gate imposes a kernel's
    masks on the float64 run): its own masks give the default bitwise;
    with every mask shut no gradient passes; with pre's open dz3 is dy
    (daff's b3 row is dy summed over the pixels).  `keep` receives h0,
    h1, dc0, dc1, dc2, dc4 as the kernel's scratch holds them: dc2 is
    nonzero exactly where pre's mask passes a nonzero dy."""
    from paddle_tpu_torch.tools import near_ties as NT

    x, dy, ws, aff = _masks_args(kind)
    proj, down = kind != "id", kind == "down"
    pre = NT.preactivations(x, *ws[:3], ws[3] if proj else None, aff, proj,
                            down)
    own = [(u > 0).reshape(-1, u.shape[-1]) for u, _ in pre]
    keep = []
    default = _plain_bwd(kind, x, dy, ws, aff, keep=keep)
    assert len(keep) == 6 and all(t.dtype == x.dtype for t in keep)
    assert torch.equal(keep[4] != 0,
                       own[2] & (dy.reshape(own[2].shape) != 0))
    assert keep[0].shape == own[0].shape and keep[3].shape == own[1].shape
    given = _plain_bwd(kind, x, dy, ws, aff, own)
    for a, b in zip(default, given):
        assert (a is None and b is None) or torch.equal(a, b)
    shut = _plain_bwd(kind, x, dy, ws, aff, [torch.zeros_like(m)
                                             for m in own])
    assert all(not t.any() for t in shut if t is not None)
    cout = ws[2].shape[1]
    opened = _plain_bwd(kind, x, dy, ws, aff,
                        own[:2] + [torch.ones_like(own[2])])
    assert torch.allclose(opened[5][5, :cout], dy.reshape(-1, cout).sum(0),
                          rtol=1e-6, atol=1e-5)
    assert not torch.equal(opened[3], default[3])
