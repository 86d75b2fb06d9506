"""The PyTorch port's train step against the JAX package's.

A small GPT (vocab 256, hidden 128, 2 layers, 2 heads of 64, seq 64,
batch 4) is built by the JAX package; its whole TrainState crosses to the
port as numpy arrays (`paddle_tpu_torch.interop.train_state_from_jax`),
after one JAX step so the optimizer state is not at its start.  Both
packages then take the same steps on the same numpy batches, the JAX one
through `make_train_step(jit=True)`.

Tolerances:
- optimizer rules on the same f32 inputs: atol = rtol = 1e-6 (the same
  elementwise math);
- f32 loss stream: atol = rtol = 1e-4 (two layers of matmuls summed in
  another order, as tests/test_torch_gpt.py);
- params after k AdamW steps: atol = 2 * lr * k + 1e-5.  Adam's update
  m / (sqrt(v) + eps) is close to sign(g) in its first steps, so a grad
  element near 0 that the two frameworks round to opposite signs moves
  that element by up to 2 lr per step; every other element agrees to
  1e-5;
- bf16: loss atol = rtol = 3e-2, params atol = 2 * lr * k + 2 bf16 ulps
  of the largest |param| (bf16 activations round at other places).

The port runs on the CPU here, so its attention and LayerNorm take the
eager compositions, as the JAX package's do on the CPU; the kernel
routes (the autograd Functions with the kernels' plain versions) are
held against JAX in tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.models import train as jtrain
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.ops import optimizer_ops as jops
from paddle_tpu.optimizer import functional as jopt

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import (
    load_jax_param_dict, params_from_numpy, train_state_from_jax,
)
from paddle_tpu_torch.models import train as ttrain
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.ops import optimizer_ops as tops
from paddle_tpu_torch.optimizer import functional as topt
from torch_threads import torch_threads  # noqa: F401

SMALL = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
             max_seq_len=64)
LR = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t if dtype is None else t.to(dtype)


def _batch(seed, shape=(4, 64), vocab=256):
    ids = np.random.default_rng(seed).integers(0, vocab, size=shape,
                                               dtype=np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _param_atol(steps, dtype, params):
    atol = 2 * LR * steps + 1e-5
    if dtype == "bfloat16":
        top = max(float(np.abs(_f32(p)).max()) for p in params.values())
        atol += 2 * top * 2.0 ** -7
    return atol


# ---------------------------------------------------------------------------
# optimizer rules
# ---------------------------------------------------------------------------

def _opt_ins(seed, slots):
    rng = np.random.default_rng(seed)
    ins = {"Param": rng.normal(size=(6, 5)), "Grad": rng.normal(size=(6, 5)),
           "LearningRate": np.array([0.01])}
    for s in slots:
        ins[s] = np.abs(rng.normal(size=(6, 5)))
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    if "Beta1Pow" in slots:
        ins["Beta1Pow"] = np.array(0.9 ** 3, np.float32)
        ins["Beta2Pow"] = np.array(0.999 ** 3, np.float32)
    return ins


@pytest.mark.parametrize("name,slots,attrs", [
    ("sgd", (), {}),
    ("momentum", ("Velocity",), {"mu": 0.8}),
    ("momentum", ("Velocity",), {"mu": 0.8, "use_nesterov": True}),
    ("adam", ("Moment1", "Moment2", "Beta1Pow", "Beta2Pow"),
     {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6}),
    ("adamw", ("Moment1", "Moment2", "Beta1Pow", "Beta2Pow"),
     {"coeff": 0.05}),
])
def test_optimizer_rules_match_reference(name, slots, attrs):
    ins = _opt_ins(0, slots)
    want = getattr(jops, name)({k: jnp.asarray(v) for k, v in ins.items()},
                               dict(attrs))
    got = getattr(tops, name)({k: torch.from_numpy(v)
                               for k, v in ins.items()}, dict(attrs))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["sgd", "momentum", "adam", "adamw"])
def test_functional_optimizers_match_reference(kind, dtype):
    """Three updates from the same params and grads, with a callable LR
    schedule, weight decay and global-norm clipping; the state layout
    (f32 slots, f32 scalar beta powers, int32 __step__) is the
    reference's, and the in-place update gives the same values."""
    rng = np.random.default_rng(1)
    shapes = {"w": (8, 4), "b": (4,)}
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]
    sched_j = lambda s: 0.01 / (1.0 + s)
    sched_t = lambda s: 0.01 / (1.0 + s)
    kw = dict(grad_clip=None, weight_decay=1e-3)
    make = {
        "sgd": lambda m, s: m.SGD(s, **kw),
        "momentum": lambda m, s: m.Momentum(s, momentum=0.8,
                                            use_nesterov=True, **kw),
        "adam": lambda m, s: m.Adam(s, **kw),
        "adamw": lambda m, s: m.AdamW(
            s, coeff=0.1, grad_clip=m.global_norm_clip(1.0)),
    }[kind]
    jo, to = make(jopt, sched_j), make(topt, sched_t)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jp = {n: jnp.asarray(v, jdt) for n, v in p0.items()}
    js = jo.init(jp)
    tp = {n: _t(v, tdt) for n, v in p0.items()}
    ts = to.init(tp)
    tp2 = {n: v.clone() for n, v in tp.items()}
    ts2 = to.init(tp2)
    assert ts["__step__"].dtype == torch.int32
    for n in shapes:
        assert set(ts[n]) == set(js[n])
        for k, v in ts[n].items():
            assert v.dtype == torch.float32
            assert tuple(v.shape) == tuple(np.shape(js[n][k])), (n, k)
    for g in grads:
        jp, js = jo.update(jp, {n: jnp.asarray(v, jdt) for n, v in g.items()},
                           js)
        tg = {n: _t(v, tdt) for n, v in g.items()}
        tp, ts = to.update(tp, tg, ts)
        same_p, same_s = to.update(tp2, tg, ts2, inplace=True)
        assert all(same_p[n] is tp2[n] for n in shapes)
        assert all(same_s[n] is ts2[n] for n in [*shapes, "__step__"])
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    assert int(ts["__step__"]) == int(js["__step__"]) == 3
    assert int(ts2["__step__"]) == 3
    for n in shapes:
        assert tp[n].dtype == tdt
        np.testing.assert_allclose(tp[n].float().numpy(), _f32(jp[n]),
                                   atol=tol, rtol=tol, err_msg=n)
        torch.testing.assert_close(tp2[n], tp[n], atol=0, rtol=0)
        for k in js[n]:
            np.testing.assert_allclose(ts[n][k].numpy(), _f32(js[n][k]),
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"{n}.{k}")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _pair(dtype="float32", seed=0, **cfg_kw):
    # the JAX package's eager PRNG draws the initial weights; seeded, they
    # do not depend on which tests ran before in the process
    np.random.seed(seed)
    jnn.seed(seed)
    jm = JGPT(JGPTConfig(dtype=dtype, **SMALL, **cfg_kw))
    tm = GPT(GPTConfig(dtype=dtype, **SMALL, **cfg_kw), device="cpu")
    return jm, tm


def _jax_state_after_one_step(jm, jo, **step_kw):
    """The JAX state after one step on batch 100: moments, beta powers
    and step counter are all past their start when it crosses over."""
    state = jtrain.init_train_state(jm, jo)
    step = jtrain.make_train_step(jm, jo, jit=True, **step_kw)
    x, y = _batch(100)
    state, _ = step(state, jnp.asarray(x), jnp.asarray(y))
    return state, step


def _run_both(jm, tm, dtype, steps=3, j_kw=None, t_kw=None):
    jo, to = jopt.AdamW(LR), topt.AdamW(LR)
    jstate, jstep = _jax_state_after_one_step(jm, jo, **(j_kw or {}))
    tstate = train_state_from_jax(_np(jstate), tm, to, device="cpu")
    tstep = ttrain.make_train_step(tm, to, **(t_kw or {}))
    jl, tl = [], []
    for i in range(steps):
        x, y = _batch(i)
        jstate, l = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        jl.append(float(l))
        tstate, l = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        tl.append(float(l))
    return jstate, tstate, np.array(jl), np.array(tl)


def _check_states(jstate, tstate, dtype, steps):
    jp = jstate.params
    atol = _param_atol(steps, dtype, jp)
    assert set(tstate.params) == set(jp)
    for n in jp:
        np.testing.assert_allclose(tstate.params[n].detach().float().numpy(),
                                   _f32(jp[n]), atol=atol, rtol=0,
                                   err_msg=n)
        assert tstate.params[n].dtype == getattr(torch, dtype)
    assert int(tstate.step) == int(jstate.step)
    assert int(tstate.opt_state["__step__"]) == \
        int(jstate.opt_state["__step__"])
    for n in jp:
        for k in ("Beta1Pow", "Beta2Pow"):
            np.testing.assert_allclose(float(tstate.opt_state[n][k]),
                                       float(jstate.opt_state[n][k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_reference(dtype):
    """One JAX step, the state carried across, then 3 AdamW steps in
    both packages: the loss stream and the params agree."""
    jm, tm = _pair(dtype)
    jstate, tstate, jl, tl = _run_both(jm, tm, dtype)
    tol = 1e-4 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(tl, jl, atol=tol, rtol=tol)
    assert tl[-1] < tl[0]
    _check_states(jstate, tstate, dtype, steps=4)
    # donation: the state holds the model's own parameters, trained in
    # place
    own = dict(tm.named_parameters())
    assert all(tstate.params[n] is own[n] for n in own)


def test_accum_steps_match_reference():
    jm, tm = _pair(seed=1)
    jstate, tstate, jl, tl = _run_both(jm, tm, "float32", steps=2,
                                       j_kw={"accum_steps": 2},
                                       t_kw={"accum_steps": 2})
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    _check_states(jstate, tstate, "float32", steps=3)


def test_remat_matches_reference_plain_step():
    """remat=True against the reference's remat=False step (the
    reference's remat step fails its own parity test; ROADMAP queue 3),
    with donate=False: the old state stays valid."""
    jm, tm = _pair(seed=2)
    jstate, tstate, jl, tl = _run_both(
        jm, tm, "float32", steps=2, t_kw={"remat": True, "donate": False})
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    _check_states(jstate, tstate, "float32", steps=3)
    own = dict(tm.named_parameters())
    assert all(tstate.params[n] is not own[n] for n in own)


def test_streaming_ce_step_matches_reference():
    """ce_vocab_chunk > 0: the chunked, checkpointed CE trains as the
    reference's lax.scan + jax.checkpoint version does."""
    jm, tm = _pair(seed=3, ce_vocab_chunk=64)
    jstate, tstate, jl, tl = _run_both(jm, tm, "float32", steps=2)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    _check_states(jstate, tstate, "float32", steps=3)


def test_eval_step_matches_reference():
    jm, tm = _pair(seed=4)
    load_jax_param_dict(tm, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jm).items()})
    x, _ = _batch(5)
    want = jtrain.make_eval_step(jm)(jnn.param_dict(jm), {}, jnp.asarray(x))
    tev = ttrain.make_eval_step(tm)
    tm.train()
    got = tev(tnn.param_dict(tm), {}, torch.from_numpy(x))
    assert tm.training                      # the mode is restored
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_unported_step_options_raise():
    _, tm = _pair()
    opt = topt.AdamW(LR)
    # grad_psum_axis over every mesh axis, or a tuple of them, is ported
    # (tests/test_torch_gpt_moe.py); an unknown axis raises
    with pytest.raises(NotImplementedError, match="item 10"):
        ttrain.make_train_step(tm, opt, precision="bfloat16")
    ttrain.make_train_step(tm, opt, grad_psum_axis=("dp", "tp"))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        ttrain.make_train_step(tm, opt, grad_psum_axis="mp")
    # remat="conv_outs" is ported (tests/test_torch_recompute.py)
    ttrain.make_train_step(tm, opt, remat="conv_outs")
    with pytest.raises(ValueError, match="remat"):
        ttrain.make_train_step(tm, opt, remat="everything")
    with pytest.raises(ValueError, match="accum_steps"):
        ttrain.make_train_step(tm, opt, accum_steps=0)
    step = ttrain.make_train_step(tm, opt, accum_steps=3)
    state = ttrain.init_train_state(tm, opt)
    x, y = _batch(6)
    with pytest.raises(ValueError, match="not divisible"):
        step(state, torch.from_numpy(x), torch.from_numpy(y))


def test_precision_setting_is_restored():
    _, tm = _pair()
    opt = topt.AdamW(LR)
    state = ttrain.init_train_state(tm, opt)
    x, y = _batch(7, shape=(2, 64))
    def flags():
        # the matmuls' and the cuDNN convs' TF32 switches
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    before = flags()
    seen = []
    loss_fn = lambda m, *b: (seen.append(flags()), m.loss(*b))[1]
    for precision, want in (("tensorfloat32", True), ("highest", False),
                            ("float32", False)):
        step = ttrain.make_train_step(tm, opt, loss_fn=loss_fn,
                                      precision=precision)
        state, _ = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert seen[-1] == (want, want)
        assert flags() == before


# ---------------------------------------------------------------------------
# dropout's generator
# ---------------------------------------------------------------------------

def test_dropout_draws_from_the_step_generator():
    """With dropout on, the loss stream depends on the state's generator
    only: the same seed gives the same losses whatever torch's global RNG
    holds, another seed other losses."""
    cfg = GPTConfig(dropout=0.2, **SMALL)
    x, y = _batch(8, shape=(2, 64))

    def losses(rng_seed, global_seed):
        tm = GPT(cfg, device="cpu", generator=tnn.make_generator(0))
        opt = topt.AdamW(LR)
        state = ttrain.init_train_state(tm, opt, rng_seed=rng_seed)
        step = ttrain.make_train_step(tm, opt, remat=True)
        torch.manual_seed(global_seed)
        out = []
        for _ in range(2):
            state, l = step(state, torch.from_numpy(x), torch.from_numpy(y))
            out.append(float(l))
        return out

    a = losses(0, 1)
    assert a == losses(0, 2)
    assert a != losses(1, 1)


def test_functional_dropout_uses_default_rng():
    x = torch.ones(64, 64)
    tnn.seed(3)
    torch.manual_seed(0)
    a = tnn.functional.dropout(x, 0.5)
    tnn.seed(3)
    torch.manual_seed(1)
    b = tnn.functional.dropout(x, 0.5)
    assert torch.equal(a, b)
    gen = tnn.make_generator(5)
    with tnn.default_rng.key_context(gen):
        c = tnn.Dropout(0.5, device="cpu")(x)
    d = tnn.functional.dropout(x, 0.5, generator=tnn.make_generator(5))
    assert torch.equal(c, d)
    assert not torch.equal(a, c)


# ---------------------------------------------------------------------------
# functional_call_with_state, interop, entry
# ---------------------------------------------------------------------------

class _Counter(tnn.Layer):
    def __init__(self):
        super().__init__(device="cpu")
        self.weight = self.create_parameter([3], constant=2.0)
        self.register_buffer("seen", torch.zeros(3))

    def forward(self, x):
        self.seen = self.seen + x
        return x * self.weight


def test_functional_call_with_state():
    layer = _Counter()
    params = {"weight": torch.full((3,), 5.0)}
    buffers = {"seen": torch.ones(3)}
    x = torch.arange(3.0)
    out, new = tnn.functional_call_with_state(layer, params, buffers, x)
    torch.testing.assert_close(out, x * 5.0)
    torch.testing.assert_close(new["seen"], 1.0 + x)
    torch.testing.assert_close(buffers["seen"], torch.ones(3))
    # the layer's own tensors are back in place
    torch.testing.assert_close(layer.weight.detach(), torch.full((3,), 2.0))
    torch.testing.assert_close(layer.seen, torch.zeros(3))
    assert set(tnn.buffer_dict(layer)) == {"seen"}
    out, _ = tnn.functional_call_with_state(
        layer, params, {}, x, _method=lambda l, v: l(v).sum())
    assert float(out) == 15.0
    with pytest.raises(KeyError, match="nope"):
        tnn.functional_call_with_state(layer, {"nope": x}, {}, x)


def test_param_dict_trainable_only():
    layer = _Counter()
    layer.weight.requires_grad_(False)
    assert set(tnn.param_dict(layer)) == {"weight"}
    assert tnn.param_dict(layer, trainable_only=True) == {}


def test_train_state_from_jax_carries_everything():
    jm, tm = _pair(seed=5)
    jo = jopt.AdamW(LR)
    jstate, _ = _jax_state_after_one_step(jm, jo)
    np_state = _np(jstate)
    ts = train_state_from_jax(np_state, tm, topt.AdamW(LR), device="cpu")
    assert int(ts.step) == 1 and ts.step.dtype == torch.int32
    assert int(ts.opt_state["__step__"]) == 1
    for n, p in np_state.params.items():
        np.testing.assert_array_equal(ts.params[n].detach().numpy(), p)
        for k, v in np_state.opt_state[n].items():
            np.testing.assert_array_equal(ts.opt_state[n][k].numpy(), v)
    assert isinstance(ts.rng, torch.Generator)
    # a dict with the same fields works too; a wrong slot set raises
    as_dict = {"params": np_state.params, "opt_state": np_state.opt_state,
               "step": np_state.step}
    train_state_from_jax(as_dict, tm, topt.AdamW(LR), device="cpu")
    with pytest.raises(KeyError, match="slots"):
        train_state_from_jax(as_dict, tm, topt.Momentum(LR), device="cpu")


def test_entry_matches_reference_entry():
    import __graft_entry__ as g

    from paddle_tpu_torch.entry import entry

    np.random.seed(9)
    jfwd, (jparams, jids) = g.entry()
    fwd, (params, ids) = entry(device="cpu")
    assert set(params) == set(jparams)
    assert tuple(ids.shape) == (4, 256) and ids.dtype == torch.int32
    want = np.asarray(jax.jit(jfwd)(jparams, jids))
    np_params = {n: np.asarray(v) for n, v in jparams.items()}
    with torch.no_grad():
        got = fwd(params_from_numpy(np_params, device="cpu"),
                  torch.from_numpy(np.asarray(jids)))
    assert tuple(got.shape) == (4, 256, 8192)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
