"""The port's nn functionals and layers of the model-zoo slice against the
reference's on the same numpy inputs and copied weights: f32 at 1e-6,
bf16 at 3e-2, VJPs against `jax.grad` at 1e-5.  The LSTM and GRU cells
and `RNN` run with ragged lengths; `Conv2DTranspose` with groups and
strides; the transformer encoder post- and pre-norm, with and without a
mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF

from paddle_tpu_torch import nn
from paddle_tpu_torch.interop import load_jax_param_dict
from paddle_tpu_torch.nn import functional as F
from torch_threads import torch_threads  # noqa: F401

RNG = np.random.default_rng(0)
X = RNG.standard_normal((3, 4, 5, 6)).astype(np.float32) * 3.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=tol, atol=tol)


ACTS = [
    ("relu6", {}), ("sigmoid", {}), ("tanh", {}), ("elu", {"alpha": 0.7}),
    ("leaky_relu", {"negative_slope": 0.05}), ("softplus", {}),
    ("silu", {}), ("swish", {"beta": 1.5}), ("hard_sigmoid", {}),
    ("hard_swish", {}), ("gelu", {}), ("gelu", {"approximate": True}),
]


@pytest.mark.parametrize("name,kw", ACTS)
def test_activation_and_its_vjp_match(name, kw):
    got = getattr(F, name)(_t(X), **kw)
    want = getattr(JF, name)(jnp.asarray(X), **kw)
    _close(got.numpy(), want, 1e-6)
    w = RNG.standard_normal(X.shape).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(getattr(JF, name)(x, **kw) * w))(
        jnp.asarray(X))
    x = _t(X).requires_grad_()
    (getattr(F, name)(x, **kw) * _t(w)).sum().backward()
    _close(x.grad.numpy(), jg, 1e-5)


@pytest.mark.parametrize("name,kw", ACTS[:6])
def test_activation_bf16(name, kw):
    xb = _t(X).to(torch.bfloat16)
    got = getattr(F, name)(xb, **kw)
    assert got.dtype == torch.bfloat16
    want = getattr(JF, name)(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16), **kw)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), 3e-2)


def test_softplus_is_logaddexp_above_twenty():
    x = _t(np.array([-40.0, 0.0, 19.0, 25.0, 80.0], np.float32))
    _close(F.softplus(x).numpy(),
           np.asarray(jax.nn.softplus(jnp.asarray(x.numpy()))), 1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_losses_and_vjps(reduction):
    logit = RNG.standard_normal((5, 7)).astype(np.float32)
    target = RNG.standard_normal((5, 7)).astype(np.float32)
    label01 = (RNG.random((5, 7)) > 0.5).astype(np.float32)
    cls = RNG.integers(0, 7, size=5)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logit), -1))
    cases = [
        ("mse_loss", (logit, target)),
        ("binary_cross_entropy_with_logits", (logit, label01)),
        ("nll_loss", (logp, cls)),
    ]
    for name, (a, b) in cases:
        want = getattr(JF, name)(jnp.asarray(a), jnp.asarray(b),
                                 reduction=reduction)
        got = getattr(F, name)(_t(a), _t(b), reduction=reduction)
        _close(got.numpy(), want, 1e-6)
        w = RNG.standard_normal(np.shape(want)).astype(np.float32)
        jg = jax.grad(lambda x: jnp.sum(getattr(JF, name)(
            x, jnp.asarray(b), reduction=reduction) * w))(jnp.asarray(a))
        x = _t(a).requires_grad_()
        (getattr(F, name)(x, _t(b), reduction=reduction) * _t(w)
         ).sum().backward()
        _close(x.grad.numpy(), jg, 1e-5)


def test_one_hot_rows_and_out_of_range_ids():
    ids = np.array([[0, 3, -1], [5, 2, 7]], np.int32)
    got = F.one_hot(_t(ids), 6)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JF.one_hot(jnp.asarray(ids), 6)))


@pytest.mark.parametrize("mode", ["constant", "reflect", "symmetric", "edge",
                                  "wrap"])
@pytest.mark.parametrize("width", [2, ((0, 0), (1, 2), (3, 0), (2, 2))])
def test_pad_modes(mode, width):
    kw = {"value": 1.5} if mode == "constant" else {}
    got = F.pad(_t(X), width, mode=mode, **kw)
    want = JF.pad(jnp.asarray(X), width, mode=mode, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode,size,scale", [
    ("nearest", (7, 9), None), ("bilinear", (3, 4), None),
    ("bilinear", None, 2.0), ("bicubic", (9, 13), None),
])
def test_interpolate_is_the_reference_resize(mode, size, scale):
    got = F.interpolate(_t(X), size=size, scale_factor=scale, mode=mode)
    want = JF.interpolate(jnp.asarray(X), size=size, scale_factor=scale,
                          mode=mode)
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("out", [1, 2, (5, 3)])
def test_adaptive_pools(out):
    x = RNG.standard_normal((2, 3, 10, 6)).astype(np.float32)
    for name in ("adaptive_avg_pool2d", "adaptive_max_pool2d"):
        got = getattr(F, name)(_t(x), out)
        want = getattr(JF, name)(jnp.asarray(x), out)
        _close(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("stride,padding,groups,dilation", [
    (1, 0, 1, 1), (2, 1, 1, 1), (2, 0, 2, 1), (3, 2, 4, 2),
])
def test_conv2d_transpose_layer(stride, padding, groups, dilation):
    jnn.seed(1)
    jl = jnn.Conv2DTranspose(4, 8, 3, stride=stride, padding=padding,
                             groups=groups, dilation=dilation)
    tl = nn.Conv2DTranspose(4, 8, 3, stride=stride, padding=padding,
                            groups=groups, dilation=dilation, device="cpu")
    assert tuple(tl.weight.shape) == (4, 8 // groups, 3, 3)
    load_jax_param_dict(tl, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jl).items()})
    x = RNG.standard_normal((2, 4, 5, 6)).astype(np.float32)
    _close(tl(_t(x)).detach().numpy(), jl(jnp.asarray(x)), 1e-5)
    w = RNG.standard_normal(np.shape(jl(jnp.asarray(x)))).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(JF.conv2d_transpose(
        a, jl.weight.value, jl.bias.value, stride, padding, dilation,
        groups) * w))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    (tl(xt) * _t(w)).sum().backward()
    _close(xt.grad.numpy(), jg, 1e-5)


def test_group_norm_and_simple_layers():
    jnn.seed(2)
    jg, tg = jnn.GroupNorm(2, 4), nn.GroupNorm(2, 4, device="cpu")
    load_jax_param_dict(tg, {"weight": np.arange(1, 5, dtype=np.float32),
                             "bias": np.arange(4, dtype=np.float32)})
    jg.weight.set_value(np.arange(1, 5, dtype=np.float32))
    jg.bias.set_value(np.arange(4, dtype=np.float32))
    _close(tg(_t(X)).detach().numpy(), jg(jnp.asarray(X)), 1e-5)
    for jl, tl in ((jnn.GELU(), nn.GELU(device="cpu")),
                   (jnn.GELU(True), nn.GELU(True, device="cpu")),
                   (jnn.Sigmoid(), nn.Sigmoid(device="cpu")),
                   (jnn.Tanh(), nn.Tanh(device="cpu")),
                   (jnn.Softmax(1), nn.Softmax(1, device="cpu"))):
        _close(tl(_t(X)).numpy(), jl(jnp.asarray(X)), 1e-6)


def test_parameter_list_keys_and_interop():
    jp = jnn.ParameterList([jnn.EagerParameter(np.ones((2, 3), np.float32)),
                            jnn.EagerParameter(np.zeros(4, np.float32))])
    tp = nn.ParameterList([torch.nn.Parameter(torch.zeros(2, 3)),
                           torch.nn.Parameter(torch.ones(4))], device="cpu")
    tp.append(torch.nn.Parameter(torch.zeros(1)))
    assert [n for n, _ in tp.named_parameters()] == ["0", "1", "2"]
    assert len(tp) == 3 and tp[2].shape == (1,)
    del tp._parameters["2"]
    load_jax_param_dict(tp, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jp).items()})
    np.testing.assert_array_equal(tp[0].detach().numpy(), np.ones((2, 3)))


def _cells(kind, jnn_seed=4, **kw):
    jnn.seed(jnn_seed)
    jc = getattr(jnn, kind)(5, 6, **kw)
    tc = getattr(nn, kind)(5, 6, device="cpu", **kw)
    load_jax_param_dict(tc, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jc).items()})
    return jc, tc


@pytest.mark.parametrize("kind,kw", [("LSTMCell", {}),
                                     ("LSTMCell", {"forget_bias": 1.0}),
                                     ("GRUCell", {})])
def test_cells_and_ragged_rnn(kind, kw):
    jc, tc = _cells(kind, **kw)
    assert tuple(tc.weight_ih.shape) == (5, (4 if "LSTM" in kind else 3) * 6)
    x = RNG.standard_normal((3, 7, 5)).astype(np.float32)
    length = np.array([7, 2, 0], np.int32)
    jo, js = jnn.RNN(jc)(jnp.asarray(x), length=jnp.asarray(length))
    to, ts = nn.RNN(tc)(_t(x), length=_t(length))
    _close(to.detach().numpy(), jo, 1e-5)
    for a, b in zip(jax.tree.leaves(ts), jax.tree.leaves(js)):
        _close(a.detach().numpy(), b, 1e-5)
    # past each length: output 0, state frozen (row 2 keeps the zeros)
    assert (to[1, 2:] == 0).all() and (to[2] == 0).all()
    # time-major, no length, and the VJP of the whole scan
    w = RNG.standard_normal((7, 3, 6)).astype(np.float32)
    xt = np.swapaxes(x, 0, 1)
    jg = jax.grad(lambda a: jnp.sum(jnn.RNN(jc, time_major=True)(a)[0] * w))(
        jnp.asarray(xt))
    xv = _t(xt).requires_grad_()
    (nn.RNN(tc, time_major=True)(xv)[0] * _t(w)).sum().backward()
    _close(xv.grad.numpy(), jg, 1e-5)


@pytest.mark.parametrize("pre_norm", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_transformer_encoder(pre_norm, masked):
    def layer_j():
        return jnn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                           normalize_before=pre_norm)

    jnn.seed(5)
    je = jnn.TransformerEncoder(layer_j, 2)
    te = nn.TransformerEncoder(
        lambda: nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0,
                                           normalize_before=pre_norm,
                                           device="cpu"), 2)
    names = {n for n, _ in te.named_parameters()}
    assert "layers.1.self_attn.q_proj.weight" in names
    assert "layers.0.linear1.weight" in names and "layers.0.norm2.bias" in names
    load_jax_param_dict(te, {n: np.asarray(v)
                             for n, v in jnn.param_dict(je).items()})
    je.eval()
    te.eval()
    x = RNG.standard_normal((2, 5, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((2, 1, 1, 5), np.float32)
        mask[1, ..., 3:] = -1e9
    got = te(_t(x), None if mask is None else _t(mask))
    want = je(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    _close(got.detach().numpy(), want, 1e-5)


def test_op_backed_layers_raise_naming_item_10():
    for name in ("Conv3D", "Conv3DTranspose", "GRUUnit", "NCE", "PRelu",
                 "BilinearTensorProduct", "SequenceConv", "RowConv",
                 "SpectralNorm", "TreeConv"):
        with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
            getattr(nn, name)(4, 4)
    assert set(nn.__all__) >= {n for n in jnn.__all__
                               if n != "EagerParameter"}


@pytest.mark.cuda
def test_encoder_on_card_matches_cpu():
    """The transformer encoder on the card (K1 in eval without a mask, K4
    at each LayerNorm; the eager attention with a mask) against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1, K4)")

    def make(device):
        return nn.TransformerEncoder(
            lambda: nn.TransformerEncoderLayer(128, 2, 256, dropout=0.0,
                                               device=device), 2).eval()

    cpu, card = make("cpu"), make("cuda")
    card.load_state_dict(cpu.state_dict())
    x = RNG.standard_normal((2, 128, 128)).astype(np.float32)
    mask = np.zeros((2, 1, 1, 128), np.float32)
    mask[1, ..., 100:] = -1e9
    with torch.no_grad():
        for m in (None, mask):
            want = cpu(_t(x), None if m is None else _t(m))
            got = card(_t(x).cuda(), None if m is None else _t(m).cuda())
            _close(got.cpu().numpy(), want.numpy(), 1e-4)
