"""K5 (LayerNorm backward, csrc/layer_norm_bwd.cu): its plan and the CPU
model of its order of sums against the Pallas kernel and the plain version.

`_ln_bwd_plan_model` is K5's structure in f32 torch: the plan's rows per
team and block, each thread's columns, the butterfly and warp order of
the row sums, the teams' then the merge groups' then the groups' order
of the dgamma/dbeta sums.  Here it is held against the reference's
`fused_layer_norm` backward through `jax.vjp` (its Pallas `_bwd` in
interpret mode) at f32 atol = rtol = 2e-5 and bf16 3e-2, as
tests/test_torch_kernels.py holds the plain version (f32 dgamma/dbeta,
sums over the rows, at atol 2e-5 * sqrt(rows)), and against the
plain version `layer_norm_bwd_ref`: dx at the same tolerances, dgamma and
dbeta (f32 sums over the rows in another order) at atol 2e-5 * sqrt(rows),
rtol 2e-5.  Plans are made for a 132-SM H100.

`test_k5_on_card` runs the kernel at the same ragged shapes on the card
and skips here.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.layer_norm import fused_layer_norm as j_ln

from paddle_tpu_torch.kernels import backend
from paddle_tpu_torch.kernels import layer_norm as TLN
from torch_threads import torch_threads  # noqa: F401

H100_SMS = 132
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]
# (rows, D): one row; fewer rows than a block's warps; a partial last merge
# group (300 x 768 bf16: 38 blocks in groups of 7; 24576 x 128: 528 blocks
# in groups of 23); several warps per row (1024 f32, 4096); the wide kernel
# (8320 bf16, 6272 f32); the train step's rows at a narrow D
CASES = [(1, 128), (7, 768), (5, 768), (300, 768), (300, 1024), (7, 4096),
         (300, 4096), (3, 6272), (3, 8320), (24576, 128)]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _inputs(rows, d, seed):
    return (_rand((rows, d), seed, 2.0), _rand((d,), seed + 1),
            _rand((d,), seed + 2), _rand((rows, d), seed + 3))


def _sum_close(got, want, rows):
    torch.testing.assert_close(got, want, atol=2e-5 * rows ** 0.5,
                               rtol=2e-5)


@pytest.mark.parametrize("rows,d", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_k5_plan_model_matches_pallas_and_plain(dtype, rows, d):
    x, g, b, dy = _inputs(rows, d, rows + d)
    tx, tg, tdy = (_t(a, dtype) for a in (x, g, dy))
    dt = getattr(torch, dtype)
    plan = TLN.ln_bwd_plan(rows, d, dt, H100_SMS)
    dx, dg, db = TLN._ln_bwd_plan_model(tx, tg, tdy, plan)
    assert dx.dtype == dt and dg.dtype == db.dtype == torch.float32
    want = TLN.layer_norm_bwd_ref(tx, tg, tdy)
    torch.testing.assert_close(dx.float(), want[0].float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    _sum_close(dg, want[1], rows)
    _sum_close(db, want[2], rows)
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a, c, e: j_ln(a, c, e), jnp.asarray(x, jd),
                     jnp.asarray(g, jd), jnp.asarray(b, jd))
    for i, (got, w) in enumerate(zip((dx, dg, db),
                                     vjp(jnp.asarray(dy, jd)))):
        # f32 dgamma/dbeta: sums over the rows in another order
        atol = TOL[dtype] * (rows ** 0.5 if i and dtype == "float32" else 1)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=atol, rtol=TOL[dtype])


@pytest.mark.parametrize("warps_per_row", [1, 2, 4, 8])
def test_k5_plan_model_at_forced_team_sizes(warps_per_row):
    """The chip run's sweep forces the team size: the model's order of
    sums at each, on a small card (4 SMs, so teams take many rows), stays
    within the plain version's tolerance."""
    x, g, _, dy = _inputs(300, 768, 7)
    for dtype in DTYPES:
        tx, tg, tdy = (_t(a, dtype) for a in (x, g, dy))
        plan = TLN.ln_bwd_plan(300, 768, getattr(torch, dtype), 4,
                               warps_per_row=warps_per_row)
        assert plan.warps_per_row == warps_per_row
        got = TLN._ln_bwd_plan_model(tx, tg, tdy, plan)
        want = TLN.layer_norm_bwd_ref(tx, tg, tdy)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        _sum_close(got[1], want[1], 300)
        _sum_close(got[2], want[2], 300)


def test_k5_plan_model_confines_a_nan():
    """A NaN in one element of dy poisons its row of dx and its column of
    dgamma/dbeta, nothing else, as in the plain version."""
    x, g, _, dy = _inputs(300, 768, 11)
    dy[17, 100] = np.nan
    tx, tg, tdy = (_t(a, "float32") for a in (x, g, dy))
    plan = TLN.ln_bwd_plan(300, 768, torch.float32, H100_SMS)
    got = TLN._ln_bwd_plan_model(tx, tg, tdy, plan)
    want = TLN.layer_norm_bwd_ref(tx, tg, tdy)
    for a, w in zip(got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(w))
    assert torch.isnan(got[0]).sum() == 768 and torch.isnan(got[0][17]).all()
    assert torch.isnan(got[1]).sum() == torch.isnan(got[2]).sum() == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_plan_covers_every_row_once(dtype):
    """Over rows, widths and SM counts: every row goes to exactly one team,
    no team is given a row >= rows, the row's vectors fit its team's
    threads (or the wide kernel takes it), the merge groups cover every
    block, and the grid stays within the blocks per SM the kernel is held
    to."""
    elt = dtype.itemsize
    for sms in (1, 4, 132):
        for d in (128, 256, 768, 1024, 2048, 4096, 6144, 6272, 8192, 8320):
            for rows in (0, 1, 7, 8, 9, 63, 300, 2113, 24576):
                plan = TLN.ln_bwd_plan(rows, d, dtype, sms)
                nv, w = plan.vecs_per_thread, plan.warps_per_row
                nvec = d * elt // 16
                assert w in (1, 2, 4, 8) and plan.warps_per_block == 8
                if nv:
                    assert nv <= TLN.LN_BWD_MAX_VECS[dtype]
                    assert nv * 32 * w >= nvec > (nv - 1) * 32 * w
                    assert plan.stages == 2
                    assert plan.smem <= 48 * 1024
                else:
                    assert w == 8 and plan.smem == 0
                    assert nvec > TLN.LN_BWD_MAX_VECS[dtype] * 256
                per_sm = TLN.LN_BWD_BLOCKS_PER_SM[dtype][nv]
                assert 1 <= plan.blocks <= max(1, sms * per_sm)
                assert plan.groups * plan.group >= plan.blocks \
                    > (plan.groups - 1) * plan.group
                order = TLN._ln_bwd_teams(plan, rows)
                assert order.shape[0] == plan.blocks * 8 // w
                taken = order[order >= 0]
                assert bool((taken < rows).all())
                assert torch.equal(taken.sort().values, torch.arange(rows))
                # a team's rows ascend; its -1s come last
                assert bool(((order[:, 1:] > order[:, :-1])
                             | (order[:, 1:] == -1)).all())


def test_k5_plan_at_the_train_shape():
    plan = TLN.ln_bwd_plan(24576, 768, torch.bfloat16, H100_SMS)
    assert plan == TLN.LnBwdPlan(vecs_per_thread=3, warps_per_row=1,
                                 warps_per_block=8, blocks=264, stages=2,
                                 group=17, groups=16, smem=6144)
    with pytest.raises(ValueError, match="warps_per_row"):
        TLN.ln_bwd_plan(8, 768, torch.float32, H100_SMS, warps_per_row=3)


def test_k5_tables_match_the_kernel_source():
    """The plan's vectors per thread and blocks per SM are the kernel's
    (csrc/layer_norm_bwd.cu kMaxVecs*, kBlocks*: __launch_bounds__)."""
    src = (backend.CSRC / "layer_norm_bwd.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name}(?:\[[^\]]*\])? = "
                         rf"([^;]+);", src).group(1)

    assert int(const("kThreads")) == 32 * TLN.LN_BWD_WARPS
    for dt, tag in ((torch.float32, "F32"), (torch.bfloat16, "BF16")):
        assert int(const(f"kMaxVecs{tag}")) == TLN.LN_BWD_MAX_VECS[dt]
        table = tuple(int(v) for v in re.findall(r"\d+",
                                                 const(f"kBlocks{tag}")))
        assert table == TLN.LN_BWD_BLOCKS_PER_SM[dt]
        assert len(table) == TLN.LN_BWD_MAX_VECS[dt] + 1
    assert "layer_norm_bwd" in backend.SOURCES


def test_k5_launch_checks_its_inputs():
    """The wrapper refuses what the kernel does not take before it loads
    the library (no nvcc here)."""
    x = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="does not match"):
        TLN._launch_bwd(x, x[0], x[:2], 1e-5)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        TLN._launch_bwd(x, x[0].double(), x, 1e-5)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        TLN._launch_bwd(x, x[0], x, 1e-5, out_dtype=torch.float64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TLN._launch_bwd(torch.zeros(4 * 128 + 1)[1:].view(4, 128), x[0], x,
                        1e-5)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_k5_on_card():
    """K5 at the CASES shapes on the card, f32 and bf16: dx against the
    plain version (2e-5 / 3e-2), dgamma/dbeta against it (atol 2e-5 *
    sqrt(rows)) and against the plan model run on the card (the same order
    of sums: atol 1e-6 * sqrt(rows), rtol 1e-6, a few ulps, since the
    kernel contracts products into FMAs where the model rounds twice),
    bitwise equal over two calls, and
    through the Function one launch per backward with the grads in
    gamma's dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5 is CUDA C++ with no CPU mode "
                    "(chip_smoke.py runs it on the card)")
    dev = torch.device("cuda")
    sms = backend.sm_count(dev)
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        for rows, d in CASES:
            x, g, b, dy = (_t(a, dtype).to(dev)
                           for a in _inputs(rows, d, rows + d))
            got = TLN._launch_bwd(x, g, dy, 1e-5)
            again = TLN._launch_bwd(x, g, dy, 1e-5)
            want = TLN.layer_norm_bwd_ref(x, g, dy)
            model = TLN._ln_bwd_plan_model(
                x, g, dy, TLN.ln_bwd_plan(rows, d, dt, sms))
            torch.testing.assert_close(got[0].float(), want[0].float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])
            for i in (1, 2):
                assert got[i].dtype == torch.float32
                assert torch.equal(got[i], again[i])
                _sum_close(got[i], want[i], rows)
                torch.testing.assert_close(got[i], model[i],
                                           atol=1e-6 * rows ** 0.5, rtol=1e-6)
            leaves = [t.clone().requires_grad_() for t in (x, g, b)]
            y = TLN.fused_layer_norm(*leaves)
            backend.reset_launches()
            grads = torch.autograd.grad(y, leaves, dy)
            assert backend.LAUNCHES["layer_norm_bwd"] == 1
            torch.testing.assert_close(grads[0], got[0], atol=0, rtol=0)
            for a, w in zip(grads[1:], got[1:]):
                assert a.dtype == dt
                torch.testing.assert_close(a, w.to(dt), atol=0, rtol=0)
    torch.cuda.synchronize()
