"""The port's conv path (ops, layers, ResNet, the Momentum train step)
against the JAX package's.

Inputs are numpy arrays from a seed handed to both packages; weights and
batch-norm buffers cross as numpy arrays (`paddle_tpu_torch.interop`).
On this CPU host the port's K7, K8 and K9 Functions run their plain
versions and the JAX package's fused blocks and stem tail run the Pallas
kernels in interpret mode.

Tolerances (atol = rtol unless said):
- conv2d / pool2d / batch_norm ops, f32: 1e-5 (one op, sums in another
  order); bf16: 3e-2 (bf16 output rounding);
- max-pool gradients with ties: exact (both send the gradient to the
  first maximum of each window in row-major order);
- the fused block, f32: outputs and buffers 1e-5, grads 1e-4 of each
  grad's scale (three convs and the batch-norm stats chain);
- small ResNets, f32: logits 1e-4, the loss stream over 2 Momentum steps
  1e-4, buffers after them 1e-4; each param tensor after them within 5%
  of its update in norm: ||port - jax|| <= 5e-2 ||jax - start|| + 1e-6.
  The first-step grads agree to ~2.5e-4 of each tensor's scale (f32
  sums in another order through ~20 layers), but where a relu mask or a
  max-pool argmax sits on a near-tie, the two frameworks can route one
  element's gradient differently in a later step, and a few elements of
  a tensor then move differently (one such flip measured 2% of a grad
  tensor's scale, and 3.5% of the stem's update after 2 steps); the norm
  bound holds the update as a whole.
The `id` bottleneck net is cut to stages 1-2 ([2, 2, 0, 0]: one identity
block in each, Cm 64 and 128) at 32x32, which keeps its maps at 8x8 and
4x4 (a 2-sample ghost batch over a 1x1 map gives a degenerate 2-point
variance, the note in tests/test_fused_bottleneck.py).  The full-subset
net ([1, 1, 1, 1]: the fused stem, the stride-1 projection block and the
three stride-2 transitions) runs at 64x64, which keeps its stage-4 maps
at 2x2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import resnet as JR
from paddle_tpu.models import train as jtrain
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import nn_ops as jops
from paddle_tpu.optimizer import functional as jopt

from paddle_tpu_torch.interop import (
    load_jax_buffer_dict, load_jax_param_dict, train_state_from_jax,
)
from paddle_tpu_torch.kernels import backend
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.models import train as ttrain
from paddle_tpu_torch.nn import functional as TF_
from paddle_tpu_torch.nn import functional_call_with_state
from paddle_tpu_torch.ops import nn_ops as tops
from paddle_tpu_torch.optimizer import functional as topt
from torch_threads import torch_threads  # noqa: F401

LR = 0.01


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        getattr(torch, dtype))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), _f32(want),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

CONV_CASES = [
    # (cin, cout, k, attrs)
    (4, 6, 3, {"paddings": [1, 1]}),
    (4, 6, 3, {"strides": [2, 2], "paddings": [1, 2, 0, 1]}),
    (4, 6, 3, {"strides": [2, 1], "padding_algorithm": "SAME"}),
    (4, 6, 3, {"dilations": [2, 2], "padding_algorithm": "VALID"}),
    (4, 8, 3, {"groups": 2, "paddings": [1, 1]}),
    (6, 6, 1, {"strides": [2, 2]}),
    (3, 8, 7, {"strides": [2, 2], "paddings": [3, 3]}),
]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_conv2d_op_matches_reference(case, fmt):
    cin, cout, k, attrs = CONV_CASES[case]
    attrs = dict(attrs, data_format=fmt)
    groups = attrs.get("groups", 1)
    shape = (2, cin, 9, 10) if fmt == "NCHW" else (2, 9, 10, cin)
    x, w = _rand(shape, 0), _rand((cout, cin // groups, k, k), 1, 0.3)
    want = jops.conv2d({"Input": jnp.asarray(x), "Filter": jnp.asarray(w)},
                       attrs)["Output"]
    got = tops.conv2d({"Input": _t(x), "Filter": _t(w)}, attrs)["Output"]
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, 1e-5)


POOL_CASES = [
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1]},
    {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
     "padding_algorithm": "SAME"},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1]},
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [1, 1],
     "paddings": [1, 1], "exclusive": False},
    {"pooling_type": "avg", "ksize": [2, 3], "strides": [2, 2],
     "padding_algorithm": "SAME"},
    {"pooling_type": "avg", "global_pooling": True},
    {"pooling_type": "max", "global_pooling": True},
    {"pooling_type": "avg", "ksize": [3, 2], "adaptive": True},
]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pool2d_op_matches_reference(case, fmt):
    attrs = dict(POOL_CASES[case], data_format=fmt)
    x = _rand((2, 3, 9, 10) if fmt == "NCHW" else (2, 9, 10, 3), 2)
    want = jops.pool2d({"X": jnp.asarray(x)}, attrs)["Out"]
    got = tops.pool2d({"X": _t(x)}, attrs)["Out"]
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("mask_bwd", [False, True])
def test_max_pool_grad_goes_to_the_first_tie(mask_bwd):
    """Integer-valued inputs make ties in most windows: the gradient must
    reach the first maximum in row-major window order, as XLA's
    select_and_scatter (and the reference's FLAGS_maxpool_mask_bwd
    backward) send it."""
    from paddle_tpu import flags as jflags

    x = np.random.default_rng(3).integers(0, 3, (2, 3, 8, 8)).astype(
        np.float32)
    dy = _rand((2, 3, 4, 4), 4)
    attrs = {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
             "paddings": [1, 1]}
    old = jflags.get_flags("maxpool_mask_bwd")
    jflags.set_flags({"maxpool_mask_bwd": mask_bwd})
    try:
        _, vjp = jax.vjp(lambda a: jops.pool2d({"X": a}, attrs)["Out"],
                         jnp.asarray(x))
        want = vjp(jnp.asarray(dy))[0]
    finally:
        jflags.set_flags(old)
    xt = _t(x).requires_grad_()
    got = torch.autograd.grad(tops.pool2d({"X": xt}, attrs)["Out"], xt,
                              _t(dy))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt,ss,mode", [
    ("NCHW", 0, "train"), ("NHWC", 0, "train"), ("NHWC", 3, "train"),
    ("NCHW", 0, "is_test"), ("NHWC", 0, "use_global_stats")])
def test_batch_norm_op_matches_reference(fmt, ss, mode, dtype):
    c = 5
    x = _rand((6, c, 4, 3) if fmt == "NCHW" else (6, 4, 3, c), 5, 2.0) + 1
    scale, bias = _rand((c,), 6) + 1, _rand((c,), 7)
    mean, var = _rand((c,), 8), np.abs(_rand((c,), 9)) + 0.5
    attrs = {"momentum": 0.8, "epsilon": 1e-4, "data_layout": fmt,
             "stats_sample": ss, "is_test": mode == "is_test",
             "use_global_stats": mode == "use_global_stats"}
    jd = getattr(jnp, dtype)
    want = jops.batch_norm(
        {"X": jnp.asarray(x, jd), "Scale": jnp.asarray(scale, jd),
         "Bias": jnp.asarray(bias, jd), "Mean": jnp.asarray(mean),
         "Variance": jnp.asarray(var)}, attrs)
    got = tops.batch_norm(
        {"X": _t(x, dtype), "Scale": _t(scale, dtype),
         "Bias": _t(bias, dtype), "Mean": _t(mean), "Variance": _t(var)},
        attrs)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for k in ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        assert got[k].dtype == (getattr(torch, dtype) if k == "Y"
                                else torch.float32), k
        np.testing.assert_allclose(got[k].float().numpy(), _f32(want[k]),
                                   atol=tol, rtol=tol, err_msg=k)


def test_cross_entropy_matches_reference():
    logits, label = _rand((6, 10), 10), np.array([0, 3, 9, 2, 2, -100])
    want = JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label),
                            reduction="none")
    got = TF_.cross_entropy(_t(logits), torch.from_numpy(label),
                            reduction="none")
    _close(got, want, 1e-6)
    assert float(got[-1, 0]) == 0.0
    np.testing.assert_allclose(
        float(TF_.cross_entropy(_t(logits), torch.from_numpy(label))),
        float(JF.cross_entropy(jnp.asarray(logits), jnp.asarray(label))),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# the fused block
# ---------------------------------------------------------------------------

def _block_pair(dtype="float32", ss=4, in_ch=32, stride=1):
    np.random.seed(0)
    jb = JR.BottleneckBlock(in_ch, 8, stride=stride, data_format="NHWC",
                            dtype=dtype, fused=True)
    tb = TR.BottleneckBlock(in_ch, 8, stride=stride, data_format="NHWC",
                            dtype=dtype, fused=True, device="cpu")
    for lyr in jb.sublayers(include_self=True):
        if isinstance(lyr, jnn.BatchNorm):
            lyr._stats_sample = ss
    TR.set_bn_stats_sample(tb, ss)
    load_jax_param_dict(tb, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jb).items()})
    assert jb._fused and tb._fused
    return jb, tb


def _buffers(jm):
    return {n: np.asarray(v) for n, v in jm.named_buffers()}


@pytest.mark.parametrize("training", [True, False])
def test_fused_block_matches_reference(training):
    """BottleneckBlock(fused=True): output, every param grad and the
    updated running stats against the JAX block (K7 in interpret mode)."""
    jb, tb = _block_pair()
    _check_block_against_reference(jb, tb, (8, 8, 8, 32), training)


@pytest.mark.parametrize("training", [True, False])
def test_fused_down_block_matches_reference(training, monkeypatch):
    """The stride-2 transition block (fused=True, K8; the reference's
    `fused_bottleneck_down` in interpret mode): output, grads and running
    stats as above, and the block really took K8 in both packages."""
    from paddle_tpu.kernels import fused_bottleneck as JK

    from paddle_tpu_torch.kernels import fused_bottleneck as TK

    calls = []
    for mod in (JK, TK):
        real = mod.fused_bottleneck_down
        monkeypatch.setattr(mod, "fused_bottleneck_down",
                            lambda *a, _f=real, _m=mod, **k: calls.append(_m)
                            or _f(*a, **k))
    jb, tb = _block_pair(in_ch=16, stride=2)
    assert jb._fused and tb._fused
    _check_block_against_reference(jb, tb, (8, 8, 8, 16), training,
                                   out_shape=(8, 4, 4, 32))
    assert JK in calls and TK in calls


def test_down_block_odd_spatial_takes_the_per_conv_path(monkeypatch):
    """Odd H or W cannot split into the four stride-2 phases: a fused
    stride-2 block runs its per-conv path in both packages (the
    reference's `test_down_block_odd_spatial_falls_back`), and the two
    agree."""
    from paddle_tpu.kernels import fused_bottleneck as JK

    from paddle_tpu_torch.kernels import fused_bottleneck as TK

    def refuse(*a, **k):
        raise AssertionError("K8 called on an odd-sided input")

    monkeypatch.setattr(JK, "fused_bottleneck_down", refuse)
    monkeypatch.setattr(TK, "fused_bottleneck_down", refuse)
    jb, tb = _block_pair(in_ch=16, stride=2)
    jb.train()
    tb.train()
    x = _rand((8, 7, 7, 16), 13)
    want = jb(jnp.asarray(x))
    got = tb(_t(x))
    assert tuple(got.shape) == (8, 4, 4, 32)
    _close(got, want, 1e-5)
    for n, b in tb.named_buffers():
        np.testing.assert_allclose(b.numpy(), _f32(_buffers(jb)[n]),
                                   atol=1e-5, rtol=1e-5, err_msg=n)


def _check_block_against_reference(jb, tb, xshape, training,
                                   out_shape=None):
    x = _rand(xshape, 11, 0.5)
    if not training:
        # running stats away from their start, the same in both
        for i in range(2):
            jb.train()
            jb(jnp.asarray(_rand(xshape, 20 + i, 0.5)))
        load_jax_buffer_dict(tb, _buffers(jb))
        jb.eval()
        tb.eval()
    else:
        jb.train()
        tb.train()
    jstate = jtrain.init_train_state(jb, jopt.Momentum(LR))
    lf_j = lambda m, a: jnp.sum(m(a) ** 2)

    def jloss(params):
        return jtrain._loss_with_buffers(jb, params, jstate.buffers,
                                         jax.random.PRNGKey(0), lf_j, (
                                             jnp.asarray(x),))

    (jl, jbufs), jg = jax.value_and_grad(jloss, has_aux=True)(jstate.params)
    params = dict(tb.named_parameters())
    bufs = dict(tb.named_buffers())
    names = list(params)
    leaves = [params[n] for n in names]
    out, tbufs = tnn_call(tb, dict(zip(names, leaves)), bufs, _t(x))
    if out_shape is not None:
        assert tuple(out.shape) == out_shape
    tl = (out.float() ** 2).sum()
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for n, g in zip(names, tg):
        scale = max(float(np.abs(_f32(jg[n])).max()), 1.0)
        np.testing.assert_allclose(g.numpy() / scale, _f32(jg[n]) / scale,
                                   atol=1e-4, rtol=1e-4, err_msg=n)
    for n, b in tbufs.items():
        np.testing.assert_allclose(b.numpy(), _f32(jbufs[n]), atol=1e-5,
                                   rtol=1e-5, err_msg=n)


def tnn_call(layer, params, buffers, x):
    return functional_call_with_state(layer, params, buffers, x)


def test_fused_block_bf16_matches_reference():
    jb, tb = _block_pair("bfloat16")
    jb.train()
    tb.train()
    x = _rand((8, 8, 8, 32), 12, 0.5)
    want = jb(jnp.asarray(x, jnp.bfloat16))
    got = tb(_t(x, "bfloat16"))
    assert got.dtype == torch.bfloat16
    _close(got, want, 3e-2)
    for n, b in tb.named_buffers():
        np.testing.assert_allclose(b.numpy(), _f32(_buffers(jb)[n]),
                                   atol=3e-2, rtol=3e-2, err_msg=n)


def test_fused_with_a_subset_that_needs_k8_or_k9_raises(monkeypatch):
    """The subsets that need K8 and K9 (unset or empty: the reference's
    full fused program) build, and match the reference's gates block by
    block; `id` and `id_early` keep their meaning."""
    for subset, blocks, stem in (("", 16, True), ("id", 12, False),
                                 ("id_early", 5, False)):
        monkeypatch.setenv("PADDLE_TPU_FUSED_SUBSET", subset)
        model = TR.resnet50(num_classes=10, data_format="NHWC", fused=True,
                            device="cpu")
        jm = JR.resnet50(num_classes=10, data_format="NHWC", fused=True)
        # `id`: the projection and stride-2 blocks stay on the per-conv
        # path, as the reference's gate has it
        assert sum(b._fused for b in model.blocks) == blocks, subset
        assert [b._fused for b in model.blocks] == [
            b._fused for b in jm.blocks], subset
        assert model._fused_stem is stem is jm._fused_stem, subset
    monkeypatch.delenv("PADDLE_TPU_FUSED_SUBSET")
    model = TR.resnet50(num_classes=10, data_format="NHWC", fused=True,
                        device="cpu")
    assert sum(b._fused for b in model.blocks) == 16 and model._fused_stem
    assert not TR.resnet50(num_classes=10, data_format="NCHW", fused=True,
                           device="cpu")._fused_stem


@pytest.mark.parametrize("training", [True, False])
def test_stem_pool_fused_matches_reference(training, monkeypatch):
    """`ResNet._stem_pool` with the fused stem (K9 after the stem conv, the
    stem batch norm from the ghost-batch slice): output, the grads of the
    stem's params and its running stats against the JAX `_stem_pool`."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_SUBSET", "")
    np.random.seed(2)
    kw = dict(num_classes=4, data_format="NHWC", fused=True)
    jm = JR.ResNet(JR.BottleneckBlock, [1, 0, 0, 0], **kw)
    tm = TR.ResNet(TR.BottleneckBlock, [1, 0, 0, 0], device="cpu", **kw)
    JR.set_bn_stats_sample(jm, 4)
    TR.set_bn_stats_sample(tm, 4)
    load_jax_param_dict(tm, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jm).items()})
    assert jm._fused_stem and tm._fused_stem
    x = _rand((8, 32, 32, 3), 14)
    if not training:
        jm.train()
        jm._stem_pool(jnp.asarray(_rand((8, 32, 32, 3), 15)))
        load_jax_buffer_dict(tm, _buffers(jm))
        jm.eval()
        tm.eval()
    jstate = jtrain.init_train_state(jm, jopt.Momentum(LR))
    lf_j = lambda m, a: jnp.sum(m._stem_pool(a) ** 2)

    def jloss(params):
        return jtrain._loss_with_buffers(jm, params, jstate.buffers,
                                         jax.random.PRNGKey(0), lf_j,
                                         (jnp.asarray(x),))

    (jl, jbufs), jg = jax.value_and_grad(jloss, has_aux=True)(
        jstate.params)
    params = {n: p for n, p in tm.named_parameters() if n.startswith("stem")}
    bufs = dict(tm.named_buffers())
    out, tbufs = functional_call_with_state(
        tm, params, bufs, _t(x), _method=lambda m, a: m._stem_pool(a))
    assert tuple(out.shape) == (8, 8, 8, 64)
    tl = (out ** 2).sum()
    tg = torch.autograd.grad(tl, list(params.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for n, g in zip(params, tg):
        scale = max(float(np.abs(_f32(jg[n])).max()), 1.0)
        np.testing.assert_allclose(g.numpy() / scale, _f32(jg[n]) / scale,
                                   atol=1e-4, rtol=1e-4, err_msg=n)
    for n, b in tbufs.items():
        np.testing.assert_allclose(b.numpy(), _f32(jbufs[n]), atol=1e-5,
                                   rtol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# small ResNets: logits and 2 Momentum steps from a carried JAX state
# ---------------------------------------------------------------------------

def _loss_j(m, x, y):
    return JF.cross_entropy(m(x), y).mean()


def _loss_t(m, x, y):
    return TF_.cross_entropy(m(x), y).mean()


# The JAX package draws its layers' initial weights from one eager PRNG
# stream (paddle_tpu.nn.default_rng) that every JAX layer built earlier in
# the process has advanced, so unseeded weights depend on which tests ran
# before (ROADMAP.md section 3).  `_net_pair` seeds it.
JAX_INIT_SEED = 0


def _net_pair(kind):
    np.random.seed(1)
    jnn.seed(JAX_INIT_SEED)
    if kind.startswith("bottleneck_nhwc"):
        kw = dict(num_classes=10, data_format="NHWC", fused=True)
        depths = [2, 2, 0, 0] if kind.endswith("_id") else [1, 1, 1, 1]
        jm = JR.ResNet(JR.BottleneckBlock, depths, **kw)
        tm = TR.ResNet(TR.BottleneckBlock, depths, device="cpu", **kw)
        JR.set_bn_stats_sample(jm, 2)
        TR.set_bn_stats_sample(tm, 2)
        # `id`: one identity block per stage; the full subset: the stem
        # (K9), the projection block (K7) and three transitions (K8)
        full = kind.endswith("_full")
        assert sum(b._fused for b in tm.blocks) == (4 if full else 2)
        assert tm._fused_stem is full
    else:
        jm = JR.resnet18(num_classes=10)
        tm = TR.resnet18(num_classes=10, device="cpu")
    return jm, tm


@pytest.mark.parametrize("kind", ["bottleneck_nhwc_id", "resnet18_nchw",
                                  "bottleneck_nhwc_full"])
def test_resnet_logits_and_momentum_steps_match_reference(kind,
                                                          monkeypatch):
    full = kind == "bottleneck_nhwc_full"
    monkeypatch.setenv("PADDLE_TPU_FUSED_SUBSET", "" if full else "id")
    jm, tm = _net_pair(kind)
    rng = np.random.default_rng(2)
    # 64x64 keeps the full net's and resnet18's stage-4 maps at 2x2 (a
    # 2-sample ghost batch, or resnet18's batch of 4, over 1x1 maps has a
    # degenerate 2- or 4-point variance, and its step's loss then moves
    # by 1e-4 to 2e-2 with f32 sum-order noise, depending on the draw)
    side = 32 if kind == "bottleneck_nhwc_id" else 64
    xs = [rng.standard_normal((4, 3, side, side)).astype(np.float32)
          for _ in range(3)]
    ys = [rng.integers(0, 10, (4,)).astype(np.int32) for _ in range(3)]
    # the nets at random init are steep: one step of lr 0.01 moves the
    # full net's loss by ~0.7, so f32 sum-order noise in a step's update
    # (~0.2% of it, or one relu mask within a rounding of 0 falling the
    # other way) moves the next loss by up to ~6e-4; at lr 1e-3 a step
    # does not amplify it past the tolerances, at any of the JAX seeds
    # 0-7 (chip_smoke.py's card-vs-CPU ResNet check takes a small lr for
    # the same reason)
    lr = 1e-3
    jo, to = jopt.Momentum(lr, 0.9), topt.Momentum(lr, 0.9)
    jstate = jtrain.init_train_state(jm, jo)
    jstep = jtrain.make_train_step(jm, jo, loss_fn=_loss_j, jit=True)
    # one JAX step first: the velocity and the running stats are past
    # their start when the state crosses over
    jstate, _ = jstep(jstate, jnp.asarray(xs[0]), jnp.asarray(ys[0]))
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), tm, to,
                                  device="cpu")
    for n, b in tstate.buffers.items():
        np.testing.assert_array_equal(b.numpy(), _f32(jstate.buffers[n]))
    start = {n: _f32(p) for n, p in jstate.params.items()}

    # eval-mode logits with the carried params and buffers
    jm.eval()
    tm.eval()
    jlogits = _j_eval(jm, jstate, xs[1])
    with torch.no_grad():
        tlogits = tm(torch.from_numpy(xs[1]))
    _close(tlogits, jlogits, 1e-4)
    jm.train()

    tstep = ttrain.make_train_step(tm, to, loss_fn=_loss_t)
    jl, tl = [], []
    for x, y in zip(xs[1:], ys[1:]):
        jstate, l = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        jl.append(float(l))
        tstate, l = tstep(tstate, torch.from_numpy(x),
                          torch.from_numpy(y))
        tl.append(float(l))
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    for n, p in tstate.params.items():
        want = _f32(jstate.params[n])
        moved = float(np.linalg.norm(want - start[n]))
        off = float(np.linalg.norm(p.detach().numpy() - want))
        assert off <= 5e-2 * moved + 1e-6, (n, off, moved)
    for n, b in tstate.buffers.items():
        np.testing.assert_allclose(b.numpy(), _f32(jstate.buffers[n]),
                                   atol=1e-4, rtol=1e-4, err_msg=n)
    assert int(tstate.step) == int(jstate.step) == 3
    # the state's buffers are the model's own, updated in place
    own = dict(tm.named_buffers())
    assert all(tstate.buffers[n] is own[n] for n in own)


def test_resnet_parity_does_not_depend_on_earlier_jax_draws(monkeypatch):
    """`_net_pair` draws the same reference weights (which the port's
    carry) whatever state earlier tests left the JAX eager PRNG in:
    reseeded (tests/test_torch_distributed.py) or advanced by the layers
    they built."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_SUBSET", "id")

    def weights():
        jm, _ = _net_pair("bottleneck_nhwc_id")
        params = jtrain.init_train_state(jm, jopt.Momentum(LR)).params
        return {n: _f32(p) for n, p in params.items()}

    jnn.seed(7)
    first = weights()
    jnn.seed(0)
    for _ in range(5):          # as five layers built before would
        jnn.default_rng.next_key()
    second = weights()
    assert first.keys() == second.keys()
    for n in first:
        np.testing.assert_array_equal(second[n], first[n], err_msg=n)


def _j_eval(jm, jstate, x):
    step = jtrain.make_eval_step(jm, jit=True)
    return step(jstate.params, jstate.buffers, jnp.asarray(x))


@pytest.mark.cuda
def test_fused_resnet_step_on_card(monkeypatch):
    """The fused (subset id) ResNet step on the card launches K7 forward
    and backward once per identity block and agrees with the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")
    monkeypatch.setenv("PADDLE_TPU_FUSED_SUBSET", "id")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 10, (4,)).astype(np.int32)
    losses = {}
    for dev in ("cuda", "cpu"):
        m = TR.ResNet(TR.BottleneckBlock, [2, 2, 0, 0], num_classes=10,
                      data_format="NHWC", fused=True, device=dev)
        TR.set_bn_stats_sample(m, 2)
        opt = topt.Momentum(LR, 0.9)
        st = ttrain.init_train_state(m, opt)
        step = ttrain.make_train_step(m, opt, loss_fn=_loss_t)
        backend.reset_launches()
        st, loss = step(st, torch.from_numpy(x).to(dev),
                        torch.from_numpy(y).to(dev))
        losses[dev] = float(loss)
        if dev == "cuda":
            assert backend.LAUNCHES["fused_bottleneck_fwd"] == 2
            assert backend.LAUNCHES["fused_bottleneck_bwd"] == 2
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
