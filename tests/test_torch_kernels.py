"""The PyTorch port's kernels against the JAX package's Pallas kernels.

On this CPU host the port's wrappers take their plain PyTorch versions;
the JAX kernels run in Pallas interpret mode, as tests/test_flash_attention.py
and tests/test_pallas_layer_norm.py run them.  Inputs are made with numpy
from a seed and handed to both packages.

Tolerances: float32 atol = rtol = 2e-5 (one kernel, sums taken in another
order); bfloat16 3e-2 (the two frameworks round to bf16 at different
places, e.g. the Pallas kernel rounds P to bf16 before P.V).

The backward plain versions (K2/K3, K5) are held against `jax.vjp` of the
JAX package's custom-VJP functions, whose backward runs the Pallas
backward kernels in interpret mode: f32 atol = rtol = 2e-5, bf16 3e-2
(the Pallas kernels round p and ds to bf16 before their matmuls; the
port keeps them in f32).

`test_kernels_on_card` and `test_kernel_grads_on_card` hold the CUDA and
Triton kernels against the plain versions on the card, K1, K2 and K3 at
head dims 64, 128 and 256, causal and not, and in bf16 also against the
rounding model (`round_to`, tests/test_torch_flash_rounding.py) within
one bf16 ulp, raw K2 against that file's model of its tile schedule
(`_dq_tile_model`), K6 against the model of its split schedule
(tests/test_torch_flash_decode.py `_decode_split_model`); they need a GPU
and skip here.
"""

import ast
import contextlib
import ctypes
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import attention as JA
from paddle_tpu.kernels.flash_attention import (
    flash_attention as j_flash, flash_attention_with_lse as j_flash_lse,
    flash_decode as j_decode)
from paddle_tpu.kernels.layer_norm import fused_layer_norm as j_ln
from paddle_tpu.ops import nn_ops as j_ops

from paddle_tpu_torch.kernels import attention as TA
from paddle_tpu_torch.kernels import backend
from paddle_tpu_torch.kernels import flash_attention as TFA
from paddle_tpu_torch.kernels import layer_norm as TLN
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.ops import nn_ops as t_ops
from test_torch_flash_decode import _decode_split_model
from test_torch_flash_rounding import _dq_tile_model

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
DTYPES = ["float32", "bfloat16"]


def _rand(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _j(a, dtype="float32"):
    return jnp.asarray(a, dtype=getattr(jnp, dtype))


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a)).to(getattr(torch, dtype))


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# plain versions of K1, K4, K6 against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
def test_k1_plain_matches_pallas(causal, dtype):
    q, k, v = (_rand((1, 2, 256, 64), s) for s in (1, 2, 3))
    j_out, j_lse = j_flash_lse(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                               causal=causal)
    before = dict(backend.LAUNCHES)
    t_out, t_lse = TFA.flash_attention_with_lse(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), causal=causal)
    assert dict(backend.LAUNCHES) == before     # CPU: no kernel launch
    assert t_out.dtype == getattr(torch, dtype)
    assert t_lse.dtype == torch.float32 and t_lse.shape == (1, 2, 256)
    _close(t_out, j_out, dtype)
    _close(t_lse, j_lse, dtype)
    _close(TFA.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                               causal=causal), j_out, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k4_plain_matches_pallas(dtype):
    # 300 rows: the Pallas kernel's 256-row blocks leave a partial block
    x = _rand((300, 128), 4, 1.0)
    g, b = _rand((128,), 5, 1.0), _rand((128,), 6, 1.0)
    want = j_ln(_j(x, dtype), _j(g, dtype), _j(b, dtype))
    got = TLN.fused_layer_norm(_t(x, dtype), _t(g, dtype), _t(b, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    got3 = TLN.layer_norm_fused(_t(x, dtype).reshape(3, 100, 128),
                                _t(g, dtype), _t(b, dtype))
    _close(got3.reshape(300, 128), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k6_plain_matches_pallas(dtype):
    q = _rand((4, 2, 1, 64), 7)
    k, v = _rand((4, 2, 256, 64), 8), _rand((4, 2, 256, 64), 9)
    lengths = np.array([0, 77, 129, 256], np.int32)   # ragged, one empty
    want = j_decode(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                    jnp.asarray(lengths))
    got = TFA.flash_decode(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                           torch.from_numpy(lengths))
    _close(got, want, dtype)
    assert float(got[0].abs().max()) == 0.0            # the l == 0 guard
    # a scalar length broadcasts over the batch
    want1 = j_decode(_j(q), _j(k), _j(v), 100)
    _close(TFA.flash_decode(_t(q), _t(k), _t(v), 100), want1)


# ---------------------------------------------------------------------------
# plain versions of K2/K3 and K5, and the autograd Functions, against the
# Pallas backward kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_lse", [False, True])
def test_k2_k3_plain_matches_pallas_vjp(with_lse, causal, dtype):
    """dq, dk, dv of flash_attention (cotangent dO) and of
    flash_attention_with_lse (cotangents dO and dlse) against jax.vjp:
    once through flash_attention_bwd_ref with delta computed as the
    Function does, once through the Function's own backward."""
    q, k, v, do = (_rand((1, 2, 128, 64), s) for s in (40, 41, 42, 43))
    dlse = _rand((1, 2, 128), 44)
    jq, jk, jv = _j(q, dtype), _j(k, dtype), _j(v, dtype)
    if with_lse:
        _, vjp = jax.vjp(lambda a, b, c: j_flash_lse(a, b, c, causal=causal),
                         jq, jk, jv)
        want = vjp((_j(do, dtype), jnp.asarray(dlse)))
    else:
        _, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, causal=causal),
                         jq, jk, jv)
        want = vjp(_j(do, dtype))
    tq, tk, tv, tdo = (_t(a, dtype) for a in (q, k, v, do))
    out, lse = TFA.flash_attention_ref(tq, tk, tv, causal)
    delta = (tdo.float() * out.float()).sum(-1)
    if with_lse:
        delta = delta - _t(dlse)
    got = TFA.flash_attention_bwd_ref(tq, tk, tv, tdo, lse, delta, causal)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        _close(g, w, dtype)
    # the Function: same grads, the plain versions on CPU tensors
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = dict(backend.LAUNCHES)
    if with_lse:
        outs = TFA.flash_attention_with_lse(*leaves, causal=causal)
        grads = torch.autograd.grad(outs, leaves, (tdo, _t(dlse)))
    else:
        outs = TFA.flash_attention(*leaves, causal=causal)
        grads = torch.autograd.grad(outs, leaves, tdo)
    assert dict(backend.LAUNCHES) == before     # CPU: no kernel launch
    for g, w in zip(grads, got):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_flash_lse_function_takes_one_sided_cotangents():
    """Only lse used, or only out: the missing cotangent counts as 0."""
    q, k, v = (_t(_rand((1, 1, 128, 64), s)).requires_grad_()
               for s in (45, 46, 47))
    out, lse = TFA.flash_attention_with_lse(q, k, v, causal=True)
    g_lse = torch.autograd.grad(lse.sum(), (q, k, v))
    out, lse = TFA.flash_attention_with_lse(q, k, v, causal=True)
    g_out = torch.autograd.grad(out.sum(), (q, k, v))
    with torch.no_grad():
        ref_out, ref_lse = TFA.flash_attention_ref(q, k, v, True)
        delta0 = ref_out.sum(-1)
        want_lse = TFA.flash_attention_bwd_ref(
            q, k, v, torch.zeros_like(q), ref_lse,
            torch.zeros_like(ref_lse) - 1.0, True)
        want_out = TFA.flash_attention_bwd_ref(
            q, k, v, torch.ones_like(q), ref_lse, delta0, True)
    for g, w in zip(g_lse + g_out, want_lse + want_out):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k5_plain_matches_pallas_vjp(dtype):
    # 300 rows: the Pallas kernel's 256-row blocks leave a partial block
    x = _rand((300, 128), 48, 1.0)
    g, b = _rand((128,), 49, 1.0), _rand((128,), 50, 1.0)
    dy = _rand((300, 128), 51, 1.0)
    _, vjp = jax.vjp(lambda a, c, e: j_ln(a, c, e), _j(x, dtype),
                     _j(g, dtype), _j(b, dtype))
    want = vjp(_j(dy, dtype))
    tx, tg, tb, tdy = (_t(a, dtype) for a in (x, g, b, dy))
    dx, dg, db = TLN.layer_norm_bwd_ref(tx, tg, tdy)
    assert dx.dtype == getattr(torch, dtype)
    assert dg.dtype == db.dtype == torch.float32
    for got, w in zip((dx, dg, db), want):
        _close(got, w, dtype)
    # the Function: grads to x, gamma and beta in their dtypes
    leaves = [t.clone().requires_grad_() for t in (tx, tg, tb)]
    y = TLN.fused_layer_norm(*leaves)
    grads = torch.autograd.grad(y, leaves, tdy)
    for got, w in zip(grads, (dx, dg.to(tg.dtype), db.to(tb.dtype))):
        torch.testing.assert_close(got, w, atol=0, rtol=0)


def test_functions_through_the_model_match_eager(monkeypatch):
    """A small GPT's loss and grads with the dispatch gates forced open
    (the route a CUDA tensor takes: the flash and LayerNorm Functions,
    here with their plain versions) against the eager compositions that
    CPU tensors take.  f32 atol = rtol = 1e-4: two layers, the -1e9
    eager mask against the kernels' -1e30."""
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    model = GPT(cfg, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(52).integers(
        0, 256, size=(2, 128), dtype=np.int32))
    labels = torch.roll(ids, -1, 1)
    params = list(model.parameters())

    def loss_and_grads():
        loss = model.loss(ids, labels)
        return [loss, *torch.autograd.grad(loss, params)]

    eager = loss_and_grads()
    calls = []
    for cls in (TFA._Flash, TLN._LayerNorm):
        orig = cls.apply
        monkeypatch.setattr(cls, "apply", staticmethod(
            lambda *a, _o=orig, _c=cls: (calls.append(_c), _o(*a))[1]))
    monkeypatch.setattr(TA, "_use_kernel", lambda use_flash, q: True)
    monkeypatch.setattr(t_ops, "_use_kernel", lambda x: True)
    routed = loss_and_grads()
    assert calls.count(TFA._Flash) == 2
    assert calls.count(TLN._LayerNorm) == 5
    for got, want in zip(routed, eager):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the eager compositions against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
@pytest.mark.parametrize("causal", [False, True])
def test_eager_attention_matches_xla(causal, mask_kind):
    q, k, v = (_rand((2, 3, 24, 16), s) for s in (10, 11, 12))
    mask = None
    if mask_kind == "bool":
        mask = np.random.default_rng(13).random((2, 1, 24, 24)) > 0.3
    elif mask_kind == "additive":
        mask = _rand((2, 1, 24, 24), 14)
    want = JA._xla_attention(_j(q), _j(k), _j(v),
                             None if mask is None else jnp.asarray(mask),
                             0.25, causal, 0.0, False, None)
    got = TA._eager_attention(_t(q), _t(k), _t(v),
                              None if mask is None else torch.from_numpy(mask),
                              0.25, causal, 0.0, False, None)
    _close(got, want)


@pytest.mark.parametrize("pos_kind", ["scalar", "per_row", "mask", "none"])
def test_decode_composition_matches_reference(pos_kind):
    q = _rand((3, 2, 1, 16), 15)
    k, v = _rand((3, 2, 40, 16), 16), _rand((3, 2, 40, 16), 17)
    kw_j, kw_t = {}, {}
    if pos_kind == "scalar":
        kw_j["pos"] = kw_t["pos"] = 21
    elif pos_kind == "per_row":
        pos = np.array([0, 13, 39], np.int32)
        kw_j["pos"], kw_t["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    elif pos_kind == "mask":
        m = np.random.default_rng(18).random((3, 1, 1, 40)) > 0.5
        m[..., 0] = True
        kw_j["mask"], kw_t["mask"] = jnp.asarray(m), torch.from_numpy(m)
    want = JA.decode_attention(_j(q), _j(k), _j(v), use_flash=False, **kw_j)
    got = TA.decode_attention(_t(q), _t(k), _t(v), **kw_t)
    _close(got, want)


def test_decode_attention_forced_kernel_runs_plain_version_on_cpu():
    """use_flash=True inside the envelope goes through the K6 wrapper;
    on CPU tensors that is the plain version (no launch counted)."""
    q = _rand((2, 2, 1, 64), 19)
    k, v = _rand((2, 2, 128, 64), 20), _rand((2, 2, 128, 64), 21)
    pos = np.array([5, 127], np.int32)
    want = JA.decode_attention(_j(q), _j(k), _j(v), pos=jnp.asarray(pos),
                               use_flash=True)       # Pallas interpret
    before = dict(backend.LAUNCHES)
    got = TA.decode_attention(_t(q), _t(k), _t(v),
                              pos=torch.from_numpy(pos), use_flash=True)
    assert dict(backend.LAUNCHES) == before
    _close(got, want)


def test_dot_product_attention_dispatch_on_cpu():
    q, k, v = (_t(_rand((1, 2, 128, 64), s)) for s in (22, 23, 24))
    # CPU tensors inside the envelope take the eager composition
    eager = TA._eager_attention(q, k, v, None, 0.125, True, 0.0, False,
                                None)
    assert torch.equal(TA.dot_product_attention(q, k, v, is_causal=True),
                       eager)
    # forcing the kernel runs its plain version
    flash = TA.dot_product_attention(q, k, v, is_causal=True,
                                     use_flash=True)
    assert torch.equal(flash, TFA.flash_attention_ref(q, k, v, True)[0])
    # forced outside the envelope: the reference's warning, eager path
    q2 = q[:, :, :100]
    with pytest.warns(UserWarning, match="use_flash=True requested"):
        out = TA.dot_product_attention(q2, q2, q2, use_flash=True)
    assert out.shape == (1, 2, 100, 64)


def test_float16_inside_the_envelope_reaches_the_flash_wrapper(monkeypatch):
    """float16 does not leave the flash path: inside the envelope it
    reaches K1's launch with dtype code 2 (the float16 tensor-core
    kernels), and K2/K3 take the same code, instead of falling back to
    the eager path.  The launcher runs against a stand-in library, as it
    would on the card."""
    calls = {}

    class Lib:
        @staticmethod
        def pt_flash_fwd(*args):
            calls.setdefault("fwd", []).append(args)
            return 0

        @staticmethod
        def pt_flash_bwd_dq(*args):
            calls.setdefault("dq", []).append(args)
            return 0

        @staticmethod
        def pt_flash_bwd_dkv(*args):
            calls.setdefault("dkv", []).append(args)
            return 0

    monkeypatch.setattr(backend, "load", lambda name, sigs: Lib)
    monkeypatch.setattr(backend, "stream_handle",
                        lambda dev: ctypes.c_void_p(7))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(TFA, "_fwd", TFA._launch_fwd)
    backend.reset_launches()
    q = _t(_rand((1, 2, 128, 64), 28)).half()
    out = TA.dot_product_attention(q, q, q, use_flash=True)
    assert out.dtype == torch.float16 and out.shape == q.shape
    assert calls["fwd"][-1][8] == 2            # dtype code: float16
    assert backend.LAUNCHES["flash_attention_fwd"] == 1
    assert backend.LAUNCHES["flash_attention_fwd:float16"] == 1
    lse = torch.zeros(1, 2, 128)
    dq, dk, dv = TFA._launch_bwd(q, q, q, q, lse, lse, False, 0.125)
    assert calls["dq"][-1][10] == 2 and calls["dkv"][-1][11] == 2
    assert dq.dtype == dk.dtype == dv.dtype == torch.float16
    # CPU tensors take the eager composition, float16 included
    monkeypatch.undo()
    assert TA.dot_product_attention(q, q, q).dtype == torch.float16


def test_layer_norm_op_matches_reference():
    x = _rand((4, 5, 128), 25, 2.0)
    g, b = _rand((5, 128), 26), _rand((5, 128), 27)
    attrs = {"begin_norm_axis": 1, "epsilon": 1e-5}
    want = j_ops.layer_norm({"X": _j(x), "Scale": _j(g).reshape(-1),
                             "Bias": _j(b).reshape(-1)}, attrs)
    got = t_ops.layer_norm({"X": _t(x), "Scale": _t(g).reshape(-1),
                            "Bias": _t(b).reshape(-1)}, attrs)
    for key in ("Y", "Mean", "Variance"):
        _close(got[key], want[key])


def test_lookup_and_dropout_ops_match_reference():
    w = _rand((10, 4), 28)
    ids = np.array([[0, 3, 9], [3, 3, -1]], np.int32)
    for pad in (-1, 3):
        want = j_ops.lookup_table_v2({"Ids": jnp.asarray(ids), "W": _j(w)},
                                     {"padding_idx": pad})["Out"]
        got = t_ops.lookup_table_v2({"Ids": torch.from_numpy(ids),
                                     "W": _t(w)}, {"padding_idx": pad})["Out"]
        _close(got, want)
    x = _rand((64, 64), 29)
    for impl in ("downgrade_in_infer", "upscale_in_train"):
        attrs = {"dropout_prob": 0.3, "is_test": True,
                 "dropout_implementation": impl}
        _close(t_ops.dropout({"X": _t(x)}, attrs)["Out"],
               j_ops.dropout({"X": _j(x)}, attrs)["Out"])
    gen = torch.Generator().manual_seed(0)
    out = t_ops.dropout({"X": _t(x)}, {
        "dropout_prob": 0.3, "dropout_implementation": "upscale_in_train",
        "_generator": gen})
    keep = out["Mask"].bool()
    assert 0.6 < float(keep.float().mean()) < 0.8
    torch.testing.assert_close(out["Out"][keep], _t(x)[keep] / 0.7)
    assert float(out["Out"][~keep].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# wrappers: envelopes, launch counts, build plumbing
# ---------------------------------------------------------------------------

def test_wrappers_raise_outside_their_envelopes():
    ok = _t(_rand((1, 1, 128, 64), 30))
    with pytest.raises(ValueError, match="S % 128"):
        TFA.flash_attention(ok[:, :, :100], ok[:, :, :100], ok[:, :, :100])
    with pytest.raises(ValueError, match="head_dim"):
        TFA.flash_attention(ok[..., :32], ok[..., :32], ok[..., :32])
    with pytest.raises(TypeError, match="dtype"):
        TFA.flash_attention(ok.double(), ok.double(), ok.double())
    with pytest.raises(ValueError, match="share one device and dtype"):
        TFA.flash_attention(ok, ok, ok.bfloat16())
    with pytest.raises(ValueError, match="q_len == 1"):
        TFA.flash_decode(ok[:, :, :2], ok, ok, 3)
    with pytest.raises(ValueError, match="T % 128"):
        TFA.flash_decode(ok[:, :, :1], ok[:, :, :100], ok[:, :, :100], 3)
    x = _t(_rand((4, 100), 31))
    with pytest.raises(ValueError, match="D % 128"):
        TLN.fused_layer_norm(x, x[0], x[0])
    with pytest.raises(ValueError, match="rows, D"):
        TLN.fused_layer_norm(x[None], x[0], x[0])


def test_kernel_sources_and_build_plumbing():
    flags = " ".join(backend.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    for name in backend.SOURCES:
        src = backend.CSRC / f"{name}.cu"
        assert src.exists()
        text = src.read_text()
        assert 'extern "C" int' in text and "cudaGetLastError" in text
        path = backend.lib_path(name)
        assert path.parent == backend.BUILD_DIR
        assert path == backend.lib_path(name)           # stable digest
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        backend.check(1, "k")
    backend.check(0, "k")
    # triton is imported only inside the function that builds K4
    tree = ast.parse(open(TLN.__file__).read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("triton" in ast.dump(n) for n in top)


def test_is_hopper_false_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert backend.is_hopper() is False


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# K1 / K3 on the card in bf16 against the rounding model (the plain
# versions with round_to=torch.bfloat16): atol = rtol = 2^-7, one bf16
# ulp of the output.  The kernels round p against the running max of
# their 64-key tiles, the model against the row's final max, so an output
# may land one rounding apart; a wrong fragment or mask is off by far more.
MODEL_TOL = 2.0 ** -7
CARD_FLASH_CASES = [(d, causal) for d in (64, 128, 256)
                    for causal in (False, True)]


@pytest.mark.cuda
def test_kernels_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA and Triton kernels have "
                    "no CPU mode (chip_smoke.py runs them on the card)")
    dev = torch.device("cuda")
    backend.reset_launches()
    with torch.inference_mode(), warnings.catch_warnings():
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            for d, causal in CARD_FLASH_CASES:
                q, k, v = (_t(_rand((2, 3, 256, d), s)).to(dev, dt)
                           for s in (1, 2, 3))
                got, lse = TFA.flash_attention_with_lse(q, k, v, causal)
                want, want_lse = TFA.flash_attention_ref(q, k, v, causal)
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=TOL[dtype], rtol=TOL[dtype])
                torch.testing.assert_close(lse, want_lse, atol=TOL[dtype],
                                           rtol=TOL[dtype])
                if dtype == "bfloat16":
                    model, model_lse = TFA.flash_attention_ref(
                        q, k, v, causal, round_to=dt)
                    torch.testing.assert_close(got.float(), model.float(),
                                               atol=MODEL_TOL,
                                               rtol=MODEL_TOL)
                    torch.testing.assert_close(lse, model_lse, atol=2e-5,
                                               rtol=2e-5)
                # K2 raw, on the plain forward's lse and delta
                do = _t(_rand((2, 3, 256, d), 7)).to(dev, dt)
                delta = (do.float() * want.float()).sum(-1)
                args = (q, k, v, do, want_lse, delta, causal, d ** -0.5)
                dq = TFA._launch_bwd_dq(*args)
                torch.testing.assert_close(
                    dq.float(), TFA.flash_attention_bwd_ref(*args)[0].float(),
                    atol=TOL[dtype], rtol=TOL[dtype])
                if dtype == "bfloat16":
                    # the model of K2's tile schedule, itself held
                    # against the Pallas kernel (test_torch_flash_rounding)
                    model = _dq_tile_model(*args)
                    torch.testing.assert_close(dq.float(), model.float(),
                                               atol=MODEL_TOL,
                                               rtol=MODEL_TOL)
            _decode_on_card(dev, dt, dtype)
            x = _t(_rand((300, 768), 5, 2.0)).to(dev, dt)
            g = _t(_rand((768,), 6)).to(dev, dt)
            torch.testing.assert_close(
                TLN.fused_layer_norm(x, g, g).float(),
                TLN.layer_norm_ref(x, g, g).float(),
                atol=TOL[dtype], rtol=TOL[dtype])
    torch.cuda.synchronize()
    assert backend.LAUNCHES["flash_attention_fwd"] == 2 * len(
        CARD_FLASH_CASES)
    assert backend.LAUNCHES["flash_attention_bwd_dq"] == 2 * len(
        CARD_FLASH_CASES)
    assert backend.LAUNCHES["flash_decode"] == 2 * DECODE_CARD_LAUNCHES
    assert backend.LAUNCHES["layer_norm_fwd"] == 2


# K6 on the card: lengths 0, 1, the 64-key chunk boundary +-1, two
# chunks + 1, T and past T, over a 256-deep cache (S = 4 splits)
DECODE_LENGTHS = np.array([0, 1, 63, 64, 65, 129, 256, 265], np.int32)
DECODE_CARD_LAUNCHES = 9


def _decode_on_card(dev, dt, dtype):
    """K6 against its plain version (TOL) and the model of its split
    schedule at the card's SM count (f32 2e-5, bf16 one ulp: both keep p
    in f32 and round O once), at D 64, 128, 256; bitwise equal over two
    calls; then two geometries with other (b*h, S) back to back and the
    first again, bitwise: a counter left non-zero would lose a merge."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    model_tol = MODEL_TOL if dtype == "bfloat16" else TOL[dtype]
    lens = torch.from_numpy(DECODE_LENGTHS).to(dev)
    for d in (64, 128, 256):
        q = _t(_rand((8, 2, 1, d), 11)).to(dev, dt)
        k, v = (_t(_rand((8, 2, 256, d), s)).to(dev, dt) for s in (12, 13))
        got = TFA.flash_decode(q, k, v, lens)
        torch.testing.assert_close(
            got.float(), TFA.flash_decode_ref(q, k, v, lens).float(),
            atol=TOL[dtype], rtol=TOL[dtype])
        model = _decode_split_model(*(t.cpu() for t in (q, k, v, lens)),
                                    sms=sms)
        torch.testing.assert_close(got.cpu().float(), model.float(),
                                   atol=model_tol, rtol=model_tol)
        assert float(got[0].abs().max()) == 0.0      # the l == 0 guard
        assert torch.equal(got, TFA.flash_decode(q, k, v, lens))
    runs = []
    for b, t, seed in ((2, 384, 14), (4, 1024, 15), (2, 384, 14)):
        q = _t(_rand((b, 3, 1, 64), seed)).to(dev, dt)
        k = _t(_rand((b, 3, t, 64), seed + 1)).to(dev, dt)
        n = torch.tensor([t - 1, 70, 0, t][:b], dtype=torch.int32,
                         device=dev)
        assert TFA.decode_plan(3 * b, t, sms)[1] > 1
        runs.append(TFA.flash_decode(q, k, k, n))
        torch.testing.assert_close(
            runs[-1].float(), TFA.flash_decode_ref(q, k, k, n).float(),
            atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.equal(runs[0], runs[2])


@pytest.mark.cuda
def test_kernel_grads_on_card():
    """K1 + K2 + K3 and K4 + K5 through their autograd Functions on the
    card, against the plain backward versions on the same inputs; bf16
    dQ (K2) and dK, dV (K3) also against the rounding model."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA and Triton kernels have "
                    "no CPU mode (chip_smoke.py runs them on the card)")
    dev = torch.device("cuda")
    backend.reset_launches()
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        tol = dict(atol=TOL[dtype], rtol=TOL[dtype])
        for d, causal in CARD_FLASH_CASES:
            q, k, v, do = (_t(_rand((1, 2, 256, d), s)).to(dev, dt)
                           for s in (53, 54, 55, 56))
            dlse = _t(_rand((1, 2, 256), 57)).to(dev)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            outs = TFA.flash_attention_with_lse(*leaves, causal=causal)
            got = torch.autograd.grad(outs, leaves, (do, dlse))
            out, lse = TFA.flash_attention_ref(q, k, v, causal)
            delta = (do.float() * out.float()).sum(-1) - dlse
            want = TFA.flash_attention_bwd_ref(q, k, v, do, lse, delta,
                                               causal)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.float(), w.float(), **tol)
            if dtype == "bfloat16":
                # K2 and K3 alone, on the model's own lse and delta
                dq = TFA._launch_bwd_dq(q, k, v, do, lse, delta, causal,
                                        d ** -0.5)
                dk, dv = TFA._launch_bwd_dkv(q, k, v, do, lse, delta, causal,
                                             d ** -0.5)
                model = TFA.flash_attention_bwd_ref(q, k, v, do, lse, delta,
                                                    causal, round_to=dt)
                for g, w in zip((dq, dk, dv), model):
                    torch.testing.assert_close(g.float(), w.float(),
                                               atol=MODEL_TOL, rtol=MODEL_TOL)
        x = _t(_rand((300, 768), 58, 2.0)).to(dev, dt)
        g = _t(_rand((768,), 59)).to(dev, dt)
        dy = _t(_rand((300, 768), 60)).to(dev, dt)
        leaves = [t.clone().requires_grad_() for t in (x, g, g)]
        got = torch.autograd.grad(TLN.fused_layer_norm(*leaves), leaves, dy)
        dx, dg, db = TLN.layer_norm_bwd_ref(x, g, dy)
        torch.testing.assert_close(got[0].float(), dx.float(), **tol)
        for a, w in ((got[1], dg), (got[2], db)):
            torch.testing.assert_close(a.float(), w.to(dt).float(), **tol)
    torch.cuda.synchronize()
    n = len(CARD_FLASH_CASES)
    assert backend.LAUNCHES["flash_attention_bwd_dq"] == 3 * n
    assert backend.LAUNCHES["flash_attention_bwd_dkv"] == 3 * n
    assert backend.LAUNCHES["layer_norm_bwd"] == 2
