"""The port's static-graph Executor against the JAX package's, on the
static zoo.

Per family (mlp, lenet, resnet, bert, gpt, seq2seq, wide_deep,
word2vec): the reference's
startup program runs in JAX; its scope, read as numpy, seeds the port's
scope (`interop.scope_from_numpy`: the port's `uniform_random` never
draws JAX's bits); then both executors take the same 3 steps on the
same numpy feeds (`smoke_feed(4, seed=step)`).  The port runs twice: its
own `static_zoo.build` Program, and `Program.from_json` of the reference's.

Tolerances:
- fetches (the loss; lenet's accuracy too): atol = rtol = 1e-5 (the same
  f32 math summed in another order);
- persistables after SGD / Momentum steps: atol = rtol = 1e-5;
- persistables after Adam or Adagrad steps: atol = 2 * lr * k + 1e-5,
  rtol 1e-5 (the rule of tests/test_torch_train.py: the early update of
  either is about lr * sign(g), so a grad element near 0 that the two
  frameworks round to opposite signs moves by up to 2 lr per step);
- and every persistable's update over the 3 steps (its value less the
  startup value: a moment's is the moment itself) against the
  reference's, in norm: ||d_port - d_ref|| <= 0.1 ||d_ref|| (exactly 0
  where the reference's is 0).  The per-element bound above is twice a
  whole Adam update, so only this one sees an update left out or
  wrong.  It skips the attention's key bias (bert, gpt: `fc_1.b_0` and
  its moments): softmax(q.(k + b)) does not depend on b, so its
  gradient is 0 in exact arithmetic, and what either framework computes
  is rounding noise that Adam scales up to an update of its own.

Also here: the Executor's error probes, its default device, an
inference run of `clone(for_test=True)` feeding only the data vars,
`gradients()` of a feed, the static GPT with LayerNorm forced onto
the kernel route (K4/K5's autograd Function, whose plain versions run on
CPU tensors), and a fetch of `<param>@GRAD` with chip_smoke's card-vs-CPU
rule for Adam parameters (`adam_update_check`) on it.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import static_zoo as jzoo

import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.models import static_zoo as tzoo
from paddle_tpu_torch.ops import nn_ops
from torch_threads import torch_threads  # noqa: F401

STEPS = 3
BATCH = 4
TOL = 1e-5
# family -> (learning rate, an update about lr * sign(g): Adam, Adagrad)
OPTIMIZERS = {"mlp": (0.01, False), "lenet": (1e-3, True),
              "resnet": (0.01, False), "bert": (1e-3, True),
              "gpt": (1e-3, True), "seq2seq": (1e-3, True),
              "wide_deep": (0.05, True), "word2vec": (0.05, False)}

_REF = {}


def _np_scope(scope):
    return {n: np.asarray(v) for n, v in scope.vars.items()
            if v is not None}


def _reference(name, **kw):
    """The reference's startup values, fetches per step and final
    persistables for `name` (cached: the two port variants share it)."""
    key = (name, tuple(sorted(kw.items())))
    if key not in _REF:
        jm = jzoo.BUILDERS[name](**kw)
        exe = jfluid.Executor(jfluid.CPUPlace())
        scope = jfluid.Scope()
        exe.run(jm.startup, scope=scope)
        start = _np_scope(scope)
        fetches = [exe.run(jm.main, feed=jm.smoke_feed(BATCH, seed=i),
                           fetch_list=jm.fetches, scope=scope)
                   for i in range(STEPS)]
        _REF[key] = (jm, start, fetches, _np_scope(scope))
    return _REF[key]


UPDATE_RTOL = 0.1
# the attention's key bias and its moments: a gradient of 0 in exact
# arithmetic (see the module docstring)
ZERO_GRAD = ("fc_1.b_0", "fc_1.b_0_adam_0_moment1", "fc_1.b_0_adam_0_moment2")


def _assert_updates_match(got_state, want_state, start, skip=()):
    """Each persistable's update against the reference's, in norm."""
    for n, w in want_state.items():
        if n in skip:
            continue
        d_ref = (w.astype(np.float64) - start[n]).ravel()
        d_port = (got_state[n].astype(np.float64) - start[n]).ravel()
        off = np.linalg.norm(d_port - d_ref)
        assert off <= UPDATE_RTOL * np.linalg.norm(d_ref), \
            (n, off, np.linalg.norm(d_ref))


def _port_run(program, m, start):
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(start, fluid.Scope(), "cpu")
    fetches = [exe.run(program, feed=m.smoke_feed(BATCH, seed=i),
                       fetch_list=m.fetches, scope=scope)
               for i in range(STEPS)]
    return fetches, scope


@pytest.mark.parametrize("source", ["port", "from_json"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_steps_match_the_reference(name, source):
    jm, start, want_fetches, want_state = _reference(name)
    tm = tzoo.build(name)
    program = tm.main if source == "port" else \
        fluid.Program.from_json(jm.main.to_json())
    got_fetches, scope = _port_run(program, tm, start)
    for step, (got, want) in enumerate(zip(got_fetches, want_fetches)):
        for g, w, n in zip(got, want, tm.fetches):
            assert g.shape == np.shape(w) and g.dtype == np.asarray(w).dtype
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=f"step {step} fetch {n}")
    lr, sign_rule = OPTIMIZERS[name]
    atol = 2 * lr * STEPS + TOL if sign_rule else TOL
    got_state = interop.scope_to_numpy(scope)
    assert set(got_state) == set(want_state)
    for n, w in want_state.items():
        g = got_state[n]
        assert g.shape == w.shape and g.dtype == w.dtype, n
        np.testing.assert_allclose(g, w, atol=atol, rtol=TOL, err_msg=n)
        assert not scope.vars[n].requires_grad
        assert scope.vars[n].grad_fn is None
    _assert_updates_match(got_state, want_state, start,
                          ZERO_GRAD if name in ("bert", "gpt") else ())


@pytest.mark.parametrize("name", ["bert", "gpt"])
def test_zero_grad_names_are_the_key_bias(name):
    """ZERO_GRAD names the bias of the projection that reaches the scores'
    matmul as its transposed Y (the keys), through reshape2/transpose2."""
    ops = tzoo.build(name).main.global_block().ops
    producer = {o: op for op in ops for o in op.output_names()}
    scores = next(op for op in ops
                  if op.type == "matmul" and op.attrs.get("transpose_Y"))
    op = producer[scores.inputs["Y"][0]]
    while op.type in ("transpose2", "reshape2"):
        op = producer[op.inputs["X"][0]]
    assert op.type == "elementwise_add"
    assert op.inputs["Y"] == [ZERO_GRAD[0]]


def test_run_plan_is_cached_until_the_program_changes():
    m = tzoo.build("mlp")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    exe.run(m.main, feed=m.smoke_feed(2), fetch_list=m.fetches, scope=scope)
    plan = m.main._run_plan_cache
    exe.run(m.main, feed=m.smoke_feed(2), fetch_list=m.fetches, scope=scope)
    assert m.main._run_plan_cache is plan
    with fluid.program_guard(m.main, m.startup):
        fluid.layers.scale(m.main.global_block().var(m.fetches[0]), 2.0)
    exe.run(m.main, feed=m.smoke_feed(2), fetch_list=m.fetches, scope=scope)
    assert m.main._run_plan_cache is not plan
    assert m.main._run_plan_cache.version == m.main._version


def test_main_before_startup_raises_runtime_error():
    m = tzoo.build("mlp")
    with pytest.raises(RuntimeError, match="run the startup program"):
        fluid.Executor(fluid.CPUPlace()).run(
            m.main, feed=m.smoke_feed(2), fetch_list=m.fetches,
            scope=fluid.Scope())
    jm = jzoo.build("mlp")
    with pytest.raises(RuntimeError, match="run the startup program"):
        jfluid.Executor(jfluid.CPUPlace()).run(
            jm.main, feed=jm.smoke_feed(2), fetch_list=jm.fetches,
            scope=jfluid.Scope())


def test_bad_fetch_name_raises_key_error_with_did_you_mean():
    m = tzoo.build("mlp")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    start = interop.scope_to_numpy(scope)
    bad = m.fetches[0][:-1] + "9"
    with pytest.raises(KeyError, match="did you mean"):
        exe.run(m.main, feed=m.smoke_feed(2), fetch_list=[bad],
                scope=scope)
    # nothing ran: the scope still holds the startup values
    for n, v in interop.scope_to_numpy(scope).items():
        np.testing.assert_array_equal(v, start[n])
    jm = jzoo.build("mlp")
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jm.startup, scope=jscope)
    with pytest.raises(KeyError):
        jexe.run(jm.main, feed=jm.smoke_feed(2), fetch_list=[bad],
                 scope=jscope)


def test_executor_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        assert fluid.Executor().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA device"):
        fluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA device"):
        fluid.Executor(fluid.CUDAPlace(0))
    assert fluid.Executor(fluid.CPUPlace()).device.type == "cpu"


def _prediction(program):
    """The softmax output the classifier's loss reads."""
    ops = [op for op in program.global_block().ops if op.type == "softmax"]
    return ops[-1].outputs["Out"][0]


@pytest.mark.parametrize("name,data", [("lenet", "img"), ("resnet", "img")])
def test_clone_for_test_inference_feeds_only_data(name, data):
    jm, _, _, want_state = _reference(name)
    tm = tzoo.build(name)
    feed = {data: tm.smoke_feed(BATCH, seed=9)[data]}
    pred = _prediction(tm.main)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    for n, v in want_state.items():
        jscope.set_var(n, v)
    want = jexe.run(jm.main.clone(for_test=True), feed=feed,
                    fetch_list=[pred], scope=jscope)[0]
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(want_state, fluid.Scope(), "cpu")
    test_prog = tm.main.clone(for_test=True)
    got = exe.run(test_prog, feed=feed, fetch_list=[pred], scope=scope)[0]
    assert got.shape == (BATCH, 10)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # an inference run updates nothing (batch norm in test mode)
    for n, v in interop.scope_to_numpy(scope).items():
        np.testing.assert_array_equal(v, want_state[n])


def _grad_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 6])
        h = pkg.layers.fc(x, 4, act="gelu")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.softmax(h), pkg.layers.scale(h, 0.5)))
        (gx,) = pkg.gradients([loss], [x])
    return main, startup, gx


def test_gradients_of_a_feed_match_the_reference():
    x = np.random.default_rng(3).standard_normal((5, 6)).astype(np.float32)
    jmain, jstart, jgx = _grad_program(jfluid)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    want = jexe.run(jmain, feed={"x": x}, fetch_list=[jgx],
                    scope=jscope)[0]
    tmain, tstart, tgx = _grad_program(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(_np_scope(jscope), fluid.Scope(), "cpu")
    got = exe.run(tmain, feed={"x": x}, fetch_list=[tgx], scope=scope)[0]
    assert got.shape == (5, 6)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_static_gpt_through_the_layer_norm_kernel_route(monkeypatch):
    """D 128 (a multiple of 128) with the kernel gate forced open: both
    layer_norm ops take K4/K5's autograd Function (its plain versions on
    CPU tensors) and the run still matches the reference."""
    kw = dict(t=16, d=128, heads=4, vocab=96)
    jm, start, want_fetches, want_state = _reference("gpt", **kw)
    calls = []
    real = nn_ops.layer_norm_fused

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(nn_ops, "_use_kernel", lambda x: True)
    monkeypatch.setattr(nn_ops, "layer_norm_fused", counting)
    tm = tzoo.build_gpt(**kw)
    got_fetches, scope = _port_run(tm.main, tm, start)
    assert len(calls) == 2 * STEPS
    for got, want in zip(got_fetches, want_fetches):
        np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=TOL)
    got_state = interop.scope_to_numpy(scope)
    for n, w in want_state.items():
        np.testing.assert_allclose(got_state[n], w,
                                   atol=2 * 1e-3 * STEPS + TOL, rtol=TOL,
                                   err_msg=n)
    _assert_updates_match(got_state, want_state, start, ZERO_GRAD)


def test_fetching_a_parameter_grad_and_the_card_check_of_adam_updates():
    """chip_smoke's card-vs-CPU rule for an Adam parameter, on two CPU
    runs of lenet: `Executor.run` fetches `<param>@GRAD`; a near-zero
    gradient whose Adam update took the other sign is explained; an
    update left out, or a flip where the gradient is far from 0, fails."""
    import chip_smoke as cs

    tm = tzoo.build("lenet")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(tm.startup, scope=scope)
    start = interop.scope_to_numpy(scope)
    name = "conv2d_0.w_0"
    loss, grad = exe.run(tm.main, feed=tm.smoke_feed(BATCH, seed=0),
                         fetch_list=[tm.loss_name, name + "@GRAD"],
                         scope=scope)
    assert grad.shape == start[name].shape and np.isfinite(loss).all()
    end = interop.scope_to_numpy(scope)[name]
    # one Adam step moves every element by about lr * sign(g)
    d = end.astype(np.float64) - start[name]
    np.testing.assert_allclose(np.abs(d), 1e-3, rtol=1e-2)

    i = int(np.argmin(np.abs(grad)))      # the grad nearest 0 ...
    j = int(np.argmax(np.abs(grad)))      # ... and the one farthest
    other = grad.copy().ravel()
    other[i] = -other[i]                  # the "card" rounds it across 0
    near = cs.near_zero_grad(other.reshape(grad.shape), grad)
    assert near.ravel()[i] and not near.ravel()[j]
    flipped = end.copy().ravel()
    flipped[i] = start[name].ravel()[i] - d.ravel()[i]
    flipped = flipped.reshape(end.shape)
    worst, off, bad = cs.adam_update_check(flipped, end, start[name], near,
                                           1e-3)
    assert (off, bad) == (1, 0) and worst <= 1.0
    assert cs.adam_update_check(end, end, start[name], near, 1e-3) \
        == (0.0, 0, 0)
    worst, off, bad = cs.adam_update_check(start[name], end, start[name],
                                           near, 1e-3)
    assert bad == end.size - int(near.sum()) and worst > 1.0
    far = end.copy().ravel()
    far[j] = start[name].ravel()[j] - d.ravel()[j]
    worst, off, bad = cs.adam_update_check(far.reshape(end.shape), end,
                                           start[name], near, 1e-3)
    assert (off, bad) == (1, 1) and worst > 1.0
