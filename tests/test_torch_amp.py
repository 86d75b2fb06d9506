"""The port's AMP (paddle_tpu_torch/amp) against the JAX package's.

- The white, black, gray and unsupported lists are the reference's sets,
  and custom lists move ops with its precedence.
- `cast_for_op`, `maybe_cast_to_compute` and nested `auto_cast` give the
  reference's dtypes; the dygraph functional ops (`linear`, `conv2d`,
  `cross_entropy`, `softmax`, `log_softmax`) consult it as the
  reference's do.
- The loss scaler's state over a scripted run of good and bad steps
  (growth, shrink, the floor at 1.0) equals the reference's, field by
  field; `scale_loss`, `unscale_grads` and `all_finite` likewise.
- `make_amp_train_step`: a finite step and a skipped one (a NaN parameter;
  and float16 products under a 2**100 loss scale) against the
  reference's: the finite flag, the scaler, and on a skip params,
  optimizer state and buffers as they were.
- `decorate` / `rewrite_program`: the Programs are `to_json` byte-equal,
  float16 (with the loss-scaling ops) and bfloat16.
- `make_train_step(amp=True)` on a depth-2 GPT and `fleet`'s
  `strategy.amp` on an MLP, 3 steps each against the reference's.

Tolerances: f32 paths atol = rtol 1e-5 (the same math summed in another
order); bf16 losses 3e-2 relative; a bf16 run's params held by their
update (value less start) in norm, within 0.1 of the reference's
(measured at most 0.016 on the GPT: its bf16 gradients agree within
1-2%, as the reference's own bf16 and f32 ones do).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.models import train as jtrain
from paddle_tpu.models.gpt import GPT as JGPT, GPTConfig as JGPTConfig
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import functional as jopt

import paddle_tpu_torch as fluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.interop import load_jax_param_dict
from paddle_tpu_torch.models import train as ttrain
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import functional as topt
from paddle_tpu_torch.resilience import all_finite
from torch_threads import torch_threads  # noqa: F401

SMALL = dict(vocab_size=256, hidden_size=128, num_heads=2, max_seq_len=64)


@pytest.fixture(autouse=True)
def _amp_flags():
    names = ["FLAGS_amp", "FLAGS_amp_dtype", "FLAGS_graph_opt_fuse"]
    j, t = jfluid.get_flags(names), fluid.get_flags(names)
    yield
    jfluid.set_flags(j)
    fluid.set_flags(t)


def _dt(x):
    return str(x.dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# lists and eager autocast
# ---------------------------------------------------------------------------

def test_lists_are_the_references_sets():
    for name in ("WHITE_LIST", "BLACK_LIST", "GRAY_LIST",
                 "UNSUPPORTED_FP16_LIST"):
        assert getattr(tamp, name) == getattr(jamp, name), name
    for kw in ({}, {"custom_white_list": ["softmax", "layer_norm"],
                    "custom_black_list": ["matmul"],
                    "custom_black_varnames": ["x"]}):
        t, j = tamp.AutoMixedPrecisionLists(**kw), \
            jamp.AutoMixedPrecisionLists(**kw)
        for attr in ("white_list", "black_list", "gray_list",
                     "unsupported_list", "black_varnames"):
            assert getattr(t, attr) == getattr(j, attr), (kw, attr)
    for mod in (tamp, jamp):
        with pytest.raises(ValueError, match="overlap"):
            mod.AutoMixedPrecisionLists(custom_white_list=["softmax"],
                                        custom_black_list=["softmax"])
        with pytest.raises(ValueError, match="unsupported"):
            mod.AutoMixedPrecisionLists(custom_white_list=["while"])
    assert tamp.CustomOpLists is tamp.AutoMixedPrecisionLists


@pytest.mark.parametrize("amp_dtype", ["bfloat16", "float16"])
def test_cast_for_op_and_nested_auto_cast_give_the_references_dtypes(
        amp_dtype):
    jfluid.set_flags({"FLAGS_amp_dtype": amp_dtype})
    fluid.set_flags({"FLAGS_amp_dtype": amp_dtype})
    assert _dt(torch.zeros(1, dtype=tamp.amp_dtype())) == \
        jnp.dtype(jamp.amp_dtype()).name
    vals = {"f32": np.ones(3, np.float32), "i32": np.ones(3, np.int32)}

    def both(op, *keys, **ctx):
        outs = []
        for mod, cvt in ((tamp, torch.from_numpy), (jamp, jnp.asarray)):
            xs = [cvt(vals[k]) for k in keys]
            if "low" in ctx:
                xs = [x.to(tamp.amp_dtype()) if mod is tamp
                      else x.astype(jamp.amp_dtype()) for x in xs]
            with mod.auto_cast(**ctx.get("kw", {})):
                r = mod.cast_for_op(op, *xs)
            r = r if isinstance(r, tuple) else (r,)
            outs.append([str(x.dtype).replace("torch.", "") for x in r])
        return outs

    for op in ("matmul", "conv2d", "softmax", "mean", "relu", "while",
               "layer_norm"):
        got, want = both(op, "f32", "i32")
        assert got == want, op
        got, want = both(op, "f32", low=True)
        assert got == want, op
    got, want = both("softmax", "f32", kw={"custom_white_list": ["softmax"]})
    assert got == want == [amp_dtype]
    for mod, t in ((tamp, torch.ones(2)), (jamp, jnp.ones(2))):
        assert not mod.autocast_enabled()
        assert mod.cast_for_op("matmul", t) is t
        with mod.auto_cast():
            assert mod.autocast_enabled()
            with mod.auto_cast(enable=False):
                assert not mod.autocast_enabled()
                assert mod.maybe_cast_to_compute(t) is t
            assert mod.autocast_enabled()
            lo = mod.maybe_cast_to_compute(t)
            assert str(lo.dtype).replace("torch.", "") == amp_dtype
        assert not mod.autocast_enabled()


def test_functional_ops_consult_autocast_as_the_references():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8)).astype(np.float32)
    w = rng.standard_normal((8, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    img = rng.standard_normal((2, 3, 6, 6)).astype(np.float32)
    k = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    lab = rng.integers(0, 5, (4, 1)).astype(np.int32)

    def run(F, cvt, mod):
        with mod.auto_cast():
            h = F.linear(cvt(x), cvt(w), cvt(b))
            outs = [h, F.conv2d(cvt(img), cvt(k), padding=1),
                    F.softmax(h), F.log_softmax(h),
                    F.cross_entropy(h, cvt(lab), reduction="none")]
        return outs + [F.linear(cvt(x), cvt(w))]

    got = run(TF, lambda a: torch.from_numpy(a), tamp)
    want = run(JF, jnp.asarray, jamp)
    for g, w_ in zip(got, want):
        assert (_dt(g), tuple(g.shape)) == (str(w_.dtype), tuple(w_.shape))
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w_, np.float32),
                                   atol=3e-2, rtol=3e-2)


# ---------------------------------------------------------------------------
# the loss scaler and all_finite
# ---------------------------------------------------------------------------

def test_scaler_state_over_a_scripted_run_equals_the_references():
    kw = dict(init_scale=4.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5)
    t = tamp.scaler_init(device="cpu", **kw)
    j = jamp.scaler_init(**kw)
    script = [True, True, True, False, True, False, False, False, False,
              False, False, False, False, True, True, True, True]
    scales = []
    for ok in script:
        t = tamp.scaler_update(t, torch.tensor(ok))
        j = jamp.scaler_update(j, jnp.asarray(ok))
        assert set(t) == set(j)
        for n in j:
            assert t[n].shape == () and _dt(t[n]) == str(j[n].dtype), n
            assert t[n].item() == np.asarray(j[n]).item(), (n, ok)
        scales.append(t["scale"].item())
    # it grew, shrank, stopped at the floor and grew again
    assert scales[:2] == [4.0, 8.0] and min(scales) == 1.0
    assert scales.count(1.0) >= 3 and scales[-1] == 4.0
    loss = torch.tensor(2.0)
    assert tamp.scale_loss(t, loss).item() == float(
        jamp.scale_loss(j, jnp.asarray(2.0)))
    g = {"a": np.array([8.0, 16.0], np.float32), "b": [np.ones(2, np.float32)]}
    got = tamp.unscale_grads(t, {"a": torch.from_numpy(g["a"]),
                                 "b": [torch.from_numpy(g["b"][0])]})
    want = jamp.unscale_grads(j, jax.tree.map(jnp.asarray, g))
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(),
                                  np.asarray(want["b"][0]))


def test_all_finite_skips_ints_and_checks_python_floats():
    nan = float("nan")
    cases = [{"a": np.ones(3, np.float32)},
             {"a": np.array([1.0, nan], np.float32)},
             {"k": np.zeros(2, np.int32), "l": [np.ones(2, np.float32)]},
             {"loss": nan}, {"loss": 1.5}, {"x": [np.array([np.inf],
                                                           np.float32)]},
             {}]
    for tree in cases:
        t_tree = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                      else [torch.from_numpy(x) for x in v]
                      if isinstance(v, list) else v)
                  for k, v in tree.items()}
        j_tree = jax.tree.map(lambda v: jnp.asarray(v)
                              if isinstance(v, np.ndarray) else v, tree)
        assert bool(all_finite(t_tree)) == bool(jamp.all_finite(j_tree)), \
            tree
    assert tamp.all_finite is all_finite


# ---------------------------------------------------------------------------
# make_amp_train_step
# ---------------------------------------------------------------------------

def _gpt_pair(seed=0, layers=1):
    np.random.seed(seed)
    jnn.seed(seed)
    jm = JGPT(JGPTConfig(num_layers=layers, **SMALL))
    tm = GPT(GPTConfig(num_layers=layers, **SMALL), device="cpu")
    load_jax_param_dict(tm, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jm).items()})
    return jm, tm


def _ids(seed, shape=(2, 32)):
    ids = np.random.default_rng(seed).integers(0, SMALL["vocab_size"],
                                               size=shape, dtype=np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def test_amp_step_finite_then_skipped_matches_the_reference():
    jm, tm = _gpt_pair()
    jstep, jmake = jamp.make_amp_train_step(
        jm, jopt.SGD(0.1), jit=True, donate=False,
        decr_every_n_nan_or_inf=1)
    tstep, tmake = tamp.make_amp_train_step(
        tm, topt.SGD(0.1), donate=False, decr_every_n_nan_or_inf=1)
    js, ts = jmake(), tmake()
    assert ts[1]["scale"].device.type == "cpu"
    x, y = _ids(1)
    js, jl, jf = jstep(js, jnp.asarray(x), jnp.asarray(y))
    ts, tl, tf = tstep(ts, torch.from_numpy(x), torch.from_numpy(y))
    assert bool(tf) and bool(jf)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for n, p in js[0].params.items():
        np.testing.assert_allclose(_np(ts[0].params[n]), _np(p), atol=1e-5,
                                   rtol=1e-5, err_msg=n)
    for n in js[1]:
        assert ts[1][n].item() == np.asarray(js[1][n]).item(), n
    # a NaN parameter: the grads are not finite, nothing is committed
    name = "blocks.0.fc1.weight"
    jbad = dict(js[0].params, **{name: js[0].params[name] * np.nan})
    js = (jtrain.TrainState(params=jbad, opt_state=js[0].opt_state,
                            buffers=js[0].buffers, step=js[0].step,
                            rng=js[0].rng), js[1])
    tbad = dict(ts[0].params, **{name: ts[0].params[name] * np.nan})
    ts = (ttrain.TrainState(params=tbad, opt_state=ts[0].opt_state,
                            buffers=ts[0].buffers, step=ts[0].step,
                            rng=ts[0].rng), ts[1])
    before = {n: p.clone() for n, p in tbad.items()}
    js2, _, jf = jstep(js, jnp.asarray(x), jnp.asarray(y))
    ts2, _, tf = tstep(ts, torch.from_numpy(x), torch.from_numpy(y))
    assert not bool(tf) and not bool(jf)
    for n in js2[1]:
        assert ts2[1][n].item() == np.asarray(js2[1][n]).item(), n
    for n, p in before.items():
        torch.testing.assert_close(ts2[0].params[n], p, equal_nan=True,
                                   rtol=0, atol=0)
    assert int(ts2[0].step) == int(js2[0].step) == 2
    assert int(ts2[0].opt_state["__step__"]) == int(
        js2[0].opt_state["__step__"]) == 1


@pytest.mark.parametrize("donate", [False, True])
def test_float16_overflow_commits_nothing_as_the_reference(donate):
    """float16 products under a 2**100 loss scale overflow in the
    backward: grads_finite False, one bad step counted, Adam's state and
    the params as they were (in place too, with donate)."""
    jfluid.set_flags({"FLAGS_amp_dtype": "float16"})
    fluid.set_flags({"FLAGS_amp_dtype": "float16"})
    np.random.seed(0)
    jnn.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16, act="relu"), jnn.Linear(16, 4))
    tm = tnn.Sequential(tnn.Linear(8, 16, act="relu", device="cpu"),
                        tnn.Linear(16, 4, device="cpu"))
    load_jax_param_dict(tm, {n: np.asarray(v)
                             for n, v in jnn.param_dict(jm).items()})
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    y = rng.integers(0, 4, (8, 1)).astype(np.int32)

    def loss(F, mod):
        def fn(m, xb, yb):
            with mod.auto_cast():
                return F.cross_entropy(m(xb), yb)
        return fn

    jstep, jmake = jamp.make_amp_train_step(
        jm, jopt.Adam(1e-3), loss(JF, jamp), jit=False, donate=False,
        init_scale=2.0 ** 100)
    tstep, tmake = tamp.make_amp_train_step(
        tm, topt.Adam(1e-3), loss(TF, tamp), donate=donate,
        init_scale=2.0 ** 100)
    js, ts = jmake(), tmake()
    before = {n: p.clone() for n, p in ts[0].params.items()}
    js, jl, jf = jstep(js, jnp.asarray(x), jnp.asarray(y))
    ts2, tl, tf = tstep(ts, torch.from_numpy(x), torch.from_numpy(y))
    assert not bool(tf) and not bool(jf)
    np.testing.assert_allclose(float(tl), float(jl), rtol=3e-2)
    for n in js[1]:
        assert ts2[1][n].item() == np.asarray(js[1][n]).item(), n
    assert ts2[1]["bad_steps"].item() == 1
    for n, p in before.items():
        torch.testing.assert_close(ts2[0].params[n], p, rtol=0, atol=0)
        assert all(not v.any() for k, v in ts2[0].opt_state[n].items()
                   if k.startswith("Moment"))
    assert (ts2[0] is ts[0]) == donate


def test_float16_autocast_gpt_loss_and_grads_match_the_reference():
    """float16 through the causal attention: its -1e9 fill rounds to
    -inf, as the reference's."""
    jfluid.set_flags({"FLAGS_amp_dtype": "float16"})
    fluid.set_flags({"FLAGS_amp_dtype": "float16"})
    jm, tm = _gpt_pair(seed=2)
    x, y = _ids(3)
    with jamp.auto_cast():
        want = float(jm.loss(jnp.asarray(x), jnp.asarray(y)))
    with tamp.auto_cast():
        got = tm.loss(torch.from_numpy(x), torch.from_numpy(y))
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), want, rtol=1e-2)
    grads = torch.autograd.grad(got, list(tm.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# decorate and the static rewrite
# ---------------------------------------------------------------------------

def _decorated(mod, amp_mod, amp_dtype):
    mod.set_flags({"FLAGS_amp_dtype": amp_dtype})
    main, startup = mod.Program(), mod.Program()
    with mod.unique_name.guard(), mod.program_guard(main, startup):
        x = mod.data("x", [None, 8])
        y = mod.data("y", [None, 1])
        h = mod.layers.fc(x, 16, act="relu")
        out = mod.layers.fc(h, 1)
        loss = mod.layers.mean(mod.layers.square_error_cost(out, y))
        amp_mod.rewrite_program(main)
        opt = amp_mod.decorate(mod.optimizer.SGD(0.1))
        opt.minimize(loss)
    return main, startup, loss.name


@pytest.mark.parametrize("amp_dtype", ["float16", "bfloat16"])
def test_decorated_programs_are_the_references(amp_dtype):
    tmain, tstart, tloss = _decorated(fluid, tamp, amp_dtype)
    jmain, jstart, jloss = _decorated(jfluid, jamp, amp_dtype)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    types = [op.type for op in tmain.global_block().ops]
    # float16: the loss scaled, then each of the 4 grads unscaled; the
    # casts: both inputs of the 2 `mul` ops (white), the `mean`'s (black)
    assert types.count("scale") == (5 if amp_dtype == "float16" else 0)
    assert types.count("cast") == 5 and tmain.amp_enabled
    # three steps of the bf16 program in both executors
    if amp_dtype == "bfloat16":
        rng = np.random.default_rng(0)
        feed = {"x": rng.standard_normal((4, 8)).astype(np.float32),
                "y": rng.standard_normal((4, 1)).astype(np.float32)}
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jsc = jfluid.Scope()
        jexe.run(jstart, scope=jsc)
        from paddle_tpu_torch import interop

        texe = fluid.Executor(fluid.CPUPlace())
        tsc = interop.scope_from_numpy(
            {n: np.asarray(v) for n, v in jsc.vars.items()}, fluid.Scope(),
            "cpu")
        for _ in range(3):
            w, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jsc)
            g, = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tsc)
            np.testing.assert_allclose(g, w, rtol=3e-2)


# ---------------------------------------------------------------------------
# make_train_step(amp=True) and fleet's strategy.amp
# ---------------------------------------------------------------------------

def _assert_updates_match(got, want, start, skip=()):
    """Each param's update (value less `start`) within 0.1 of the
    reference's in norm."""
    for n, w in want.items():
        if any(k in n for k in skip):
            continue
        d_want = _np(w).astype(np.float64) - start[n]
        d_got = _np(got[n]).astype(np.float64) - start[n]
        assert np.linalg.norm(d_got - d_want) <= 0.1 * np.linalg.norm(
            d_want), n


def test_make_train_step_amp_matches_the_reference():
    """A depth-2 GPT with f32 master params, 3 Momentum steps under
    amp=True in both packages (and amp=None with FLAGS_amp=on in the
    port).  Momentum's update is continuous in the gradient, so the
    update comparison sees the AMP forward and backward; under AdamW a
    near-zero gradient that bf16 moves flips its element's update
    (measured: one element of blocks.1.norm2.weight, 2e-3 against an
    update norm of 2e-2)."""
    jm, tm = _gpt_pair(seed=1, layers=2)
    start = {n: _np(p).astype(np.float64)
             for n, p in tm.named_parameters()}
    jo = jopt.Momentum(0.1, 0.9)
    jstate = jtrain.init_train_state(jm, jo)
    jstep = jtrain.make_train_step(jm, jo, jit=True, amp=True)
    fluid.set_flags({"FLAGS_amp": "on"})
    to = topt.Momentum(0.1, 0.9)
    tstate = ttrain.init_train_state(tm, to)
    tstep = ttrain.make_train_step(tm, to, donate=False)
    f32_loss = None
    jl, tl = [], []
    for i in range(3):
        x, y = _ids(i)
        if i == 0:
            f32_loss = float(ttrain.make_train_step(tm, to, amp=False,
                                                    donate=False)(
                tstate, torch.from_numpy(x), torch.from_numpy(y))[1])
        jstate, l = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        jl.append(float(l))
        tstate, l = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        tl.append(float(l))
    assert all(p.dtype == torch.float32 for p in tstate.params.values())
    np.testing.assert_allclose(tl, jl, rtol=3e-2)
    assert tl[0] != f32_loss          # the bf16 products took
    _assert_updates_match(tstate.params, jstate.params, start,
                          skip=("k_proj.bias",))


def test_fleet_strategy_amp_matches_the_reference():
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.distributed.mesh import build_mesh as jbuild_mesh
    from paddle_tpu.dygraph import Momentum as JMomentum

    from paddle_tpu_torch.distributed import fleet as tfleet
    from paddle_tpu_torch.distributed.env import destroy_parallel_env
    from paddle_tpu_torch.distributed.mesh import build_mesh

    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    y = (x @ rng.standard_normal((8, 1))).astype(np.float32)

    def jmodel():
        np.random.seed(0)
        jnn.seed(0)
        return jnn.Sequential(jnn.Linear(8, 8, act="relu"),
                              jnn.Linear(8, 1))

    def mse(m, xb, yb):
        return ((m(xb) - yb) ** 2).mean()

    jruns = {}
    for amp in (False, True):
        jm = jmodel()
        s = jfleet.DistributedStrategy()
        s.amp = amp
        opt = jfleet.distributed_optimizer(
            JMomentum(0.05, 0.9, parameter_list=jm.parameters()), s)
        step = jfleet.make_train_step(jm, opt, mse, mesh=jbuild_mesh(dp=1))
        losses = [float(step(jnp.asarray(x), jnp.asarray(y)))
                  for _ in range(3)]
        jruns[amp] = (losses, {n: np.asarray(p.value)
                               for n, p in jm.named_parameters()})
        if amp:
            start = {n: np.asarray(v, np.float64) for n, v in
                     jnn.param_dict(jmodel()).items()}
    tm = tnn.Sequential(tnn.Linear(8, 8, act="relu", device="cpu"),
                        tnn.Linear(8, 1, device="cpu"))
    load_jax_param_dict(tm, {n: v.astype(np.float32)
                             for n, v in start.items()})
    mesh = build_mesh(dp=1, device="cpu")
    try:
        s = tfleet.DistributedStrategy()
        s.amp = True
        step = tfleet.make_train_step(
            tm, tfleet.distributed_optimizer(topt.Momentum(0.05, 0.9), s),
            mse, mesh=mesh)
        tl = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(3)]
    finally:
        destroy_parallel_env()
    np.testing.assert_allclose(tl, jruns[True][0], rtol=3e-2)
    assert jruns[True][0] != jruns[False][0]
    _assert_updates_match(dict(tm.named_parameters()), jruns[True][1],
                          start)
