"""The port's control flow against the JAX package's.

Each program of the reference's tests/test_control_flow.py
(`chip_smoke.cf_cases`, built by both packages from one definition) must
serialize to the reference's bytes (`to_json` of main and startup) and
give its results: the port's Executor on the CPU against the reference's
(jitted; lax.cond / lax.while_loop / lax.scan), f32 atol = rtol = 1e-5.
So must IfElse, the block While, DynamicRNN, case, switch_case, the
rank-table ops (`lod_rank_table` -> `lod_tensor_to_array` ->
`array_to_lod_tensor`, `shrink_memory`; the reference under
FLAGS_eager_executor, their row counts being value-dependent), and the
learning-rate Switch.  `Print` survives the executor's pruning.

Grads through a bounded loop (maximum_trip_count) equal the reference's;
a backward through an unbounded loop raises in both packages.  Where a
bounded loop's body would produce inf past the end, the reference (which
runs all max_iters trips and freezes the carry with jnp.where) gets a NaN
gradient and the port (which stops at the first false condition) does
not: the port keeps the finite gradient (ROADMAP section 3).

The predicate of each cond, Switch case and loop trip, and each array
index, is read on the host once: `kernels.backend.HOST_SYNCS` counts
them.
"""

import math

import numpy as np
import pytest

import paddle_tpu as jfluid

import chip_smoke
import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.kernels import backend
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-5
CASES = [c[0] for c in chip_smoke.cf_cases(fluid)]


def _run_both(jmain, jstart, tmain, feed, fetch, eager=False):
    """The reference's startup seeds both scopes; each package runs its
    main once.  Returns (reference outputs, port outputs, port scope)."""
    jexe = jfluid.Executor()
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()}
    old = jfluid.flags.flag("eager_executor")
    jfluid.flags.set_flags({"FLAGS_eager_executor": eager})
    try:
        want = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
    finally:
        jfluid.flags.set_flags({"FLAGS_eager_executor": old})
    texe = fluid.Executor(fluid.CPUPlace())
    tscope = interop.scope_from_numpy(state, fluid.Scope(), "cpu")
    got = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
    return [np.asarray(w) for w in want], got, tscope


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w), (np.shape(g), np.shape(w))
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("name", CASES)
def test_reference_cases_serialize_and_run_alike(name):
    jcase = dict((c[0], c) for c in chip_smoke.cf_cases(jfluid))[name]
    tcase = dict((c[0], c) for c in chip_smoke.cf_cases(fluid))[name]
    _, jmain, jstart, feed, fetch = jcase
    _, tmain, tstart, _, tfetch = tcase
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    assert tfetch == fetch
    backend.reset_host_syncs()
    want, got, _ = _run_both(jmain, jstart, tmain, feed, fetch)
    _close(got, want)
    syncs = dict(backend.HOST_SYNCS)
    kinds = {"cond": "cond", "while": "while", "switch": "switch",
             "tensor_array": "array_index"}
    for key, kind in kinds.items():
        if name.startswith(key):
            assert syncs.get(kind, 0) >= 1, syncs


def test_while_loop_reads_its_condition_once_a_trip():
    _, main, start, feed, fetch = dict(
        (c[0], c) for c in chip_smoke.cf_cases(fluid))["while_loop_counts"]
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(start, scope=scope)
    backend.reset_host_syncs()
    acc, i = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert float(acc[0]) == 45.0 and float(i[0]) == 10.0
    # ten trips and the false condition that ends them
    assert backend.HOST_SYNCS["while"] == 11


def _build(pkg, fn):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        fetch = fn(pkg, pkg.layers)
    return main, startup, [v if isinstance(v, str) else v.name
                           for v in fetch]


def _pair(fn):
    jm, js, jf = _build(jfluid, fn)
    tm, ts, tf = _build(fluid, fn)
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()
    assert tf == jf
    return jm, js, tm, jf


def _ifelse(pkg, L):
    x = pkg.data("x", [None, 4])
    cond = L.greater_than(L.reduce_sum(x),
                          L.fill_constant([1], "float32", 0.0))
    ie = L.IfElse(cond)
    with ie.true_block():
        ie.output(L.scale(ie.input(x), scale=2.0), L.relu(x))
    with ie.false_block():
        ie.output(L.scale(x, scale=-3.0), L.tanh(x))
    return ie()


def _block_while(pkg, L):
    # sum of 0..4 through the block form: the body assigns the loop vars
    i = L.fill_constant([1], "int64", 0)
    acc = L.fill_constant([1], "float32", 0.0)
    n = L.fill_constant([1], "int64", 5)
    cond = L.less_than(i, n)
    loop = L.While(cond)
    with loop.block():
        L.assign(acc + L.cast(i, "float32"), acc)
        L.increment(i, value=1, in_place=True)
        L.assign(L.less_than(i, n), cond)
    return [acc, i]


def _dynamic_rnn(pkg, L):
    x = pkg.data("x", [2, 5, 3])                   # batch-major [B, T, D]
    drnn = L.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(x)
        mem = drnn.memory(shape=[3], value=0.5)
        h = L.tanh(L.elementwise_add(x_t, mem))
        drnn.update_memory(mem, h)
        drnn.output(h)
    return [drnn()]


def _case(pkg, L):
    x = pkg.data("x", [1], dtype="float32")
    one = L.fill_constant([1], "float32", 1.0)
    two = L.fill_constant([1], "float32", 2.0)
    return [L.case([(L.less_than(x, one), lambda: L.scale(x, scale=10.0)),
                    (L.less_than(x, two), lambda: L.scale(x, scale=20.0))],
                   default=lambda: L.scale(x, scale=30.0))]


def _switch_case(pkg, L):
    idx = pkg.data("idx", [1], dtype="int64")
    x = L.fill_constant([2], "float32", 1.0)
    return [L.switch_case(idx, {0: lambda: L.scale(x, scale=1.0),
                                1: lambda: L.scale(x, scale=2.0),
                                3: lambda: L.scale(x, scale=4.0)},
                          default=lambda: L.scale(x, scale=-1.0))]


@pytest.mark.parametrize("fn,feeds", [
    (_ifelse, [{"x": np.full((2, 4), 0.5, np.float32)},
               {"x": np.full((2, 4), -0.5, np.float32)}]),
    (_block_while, [{}]),
    (_dynamic_rnn, [{"x": np.random.default_rng(0).normal(
        size=(2, 5, 3)).astype(np.float32)}]),
    (_case, [{"x": np.array([v], np.float32)} for v in (0.5, 1.5, 2.5)]),
    (_switch_case, [{"idx": np.array([v], np.int64)}
                    for v in (0, 1, 2, 3)]),
], ids=["IfElse", "While", "DynamicRNN", "case", "switch_case"])
def test_block_layers_serialize_and_run_alike(fn, feeds):
    jm, js, tm, fetch = _pair(fn)
    for feed in feeds:
        want, got, _ = _run_both(jm, js, tm, feed, fetch)
        _close(got, want)


def _rank_table_ops(pkg, L):
    x = pkg.data("x", [4, 3, 2])
    lengths = pkg.data("lengths", [4], dtype="int64")
    table = L.lod_rank_table(x, lengths=lengths)
    arr = L.lod_tensor_to_array(x, table)
    back = L.array_to_lod_tensor(arr, table)
    n = L.max_sequence_len(table)
    i = L.fill_constant([1], "int64", 1)
    shrunk = L.shrink_memory(L.array_read(arr, L.fill_constant(
        [1], "int64", 0)), i, table)
    return [table, back, n, L.array_length(arr), shrunk]


def test_rank_table_ops_match_the_eager_reference():
    jm, js, tm, fetch = _pair(_rank_table_ops)
    rng = np.random.default_rng(3)
    feed = {"x": rng.normal(size=(4, 3, 2)).astype(np.float32),
            "lengths": np.array([2, 3, 1, 2], np.int64)}
    want, got, _ = _run_both(jm, js, tm, feed, fetch, eager=True)
    _close(got, want)
    # the padded rows past each length come back as zeros
    back = got[1]
    assert np.all(back[2, 1:] == 0) and np.all(back[0, 2:] == 0)
    assert np.array_equal(back[1], feed["x"][1])


def test_print_survives_pruning(capsys):
    main = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main,
                                                        fluid.Program()):
        x = fluid.data("x", [None, 2])
        fluid.layers.Print(x, message="peek")
        y = fluid.layers.scale(x, scale=2.0)
    assert [op.type for op in fluid.Executor._live_ops(main, [y.name])] \
        == ["print", "scale"]
    exe = fluid.Executor(fluid.CPUPlace())
    (out,) = exe.run(main, feed={"x": np.ones((1, 2), np.float32)},
                     fetch_list=[y])
    assert np.array_equal(out, np.full((1, 2), 2.0, np.float32))
    assert "[peek] shape=(1, 2)" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["rnn", "while"])
def test_grads_through_bounded_recurrences_match(kind):
    kw = dict(batch=2, width=8, trips=4)
    jm, js, jfeed, fetch = chip_smoke.cf_wide(jfluid, kind, **kw)
    tm, ts, feed, tfetch = chip_smoke.cf_wide(fluid, kind, **kw)
    assert tm.to_json() == jm.to_json() and tfetch == fetch
    want, got, tscope = _run_both(jm, js, tm, feed, fetch)
    _close(got, want)
    assert np.abs(got[1]).max() > 0          # w@GRAD flowed back


def _unbounded(pkg, L):
    w = L.create_parameter([1], "float32", name="w",
                           default_initializer=pkg.initializer.Constant(
                               1.0))
    i = L.fill_constant([1], "float32", 0.0)
    three = L.fill_constant([1], "float32", 3.0)
    _, wo = L.while_loop(lambda i, v: L.less_than(i, three),
                         lambda i, v: [i + 1.0, L.scale(v, scale=2.0)],
                         [i, w])
    loss = L.reduce_sum(wo)
    pkg.optimizer.SGD(learning_rate=1.0).minimize(loss)
    return [loss]


def test_backward_through_an_unbounded_loop_raises_in_both():
    jm, js, tm, fetch = _pair(_unbounded)
    jexe = jfluid.Executor()
    jscope = jfluid.Scope()
    jexe.run(js, scope=jscope)
    with pytest.raises(Exception):
        jexe.run(jm, fetch_list=fetch, scope=jscope)
    texe = fluid.Executor(fluid.CPUPlace())
    tscope = interop.scope_from_numpy(
        {n: np.asarray(v) for n, v in jscope.vars.items()}, fluid.Scope(),
        "cpu")
    with pytest.raises(ValueError, match="maximum_trip_count"):
        texe.run(tm, fetch_list=fetch, scope=tscope)


def _inf_past_the_end(pkg, L):
    # v <- v / (3 - i) for i = 0, 1, 2: v = w / 6; one more trip would
    # divide by zero
    w = L.create_parameter([1], "float32", name="w",
                           default_initializer=pkg.initializer.Constant(
                               1.0))
    i = L.fill_constant([1], "float32", 0.0)
    three = L.fill_constant([1], "float32", 3.0)
    _, v = L.while_loop(
        lambda i, v: L.less_than(i, three),
        lambda i, v: [i + 1.0, L.elementwise_div(v, three - i)],
        [i, w], maximum_trip_count=6)
    loss = L.reduce_sum(v)
    pkg.optimizer.SGD(learning_rate=1.0).minimize(loss)
    return [loss, "w@GRAD"]


def test_bounded_loop_stops_at_the_first_false_condition():
    """The port's semantic difference, stated: the reference's frozen
    trips past the end divide by zero and poison the gradient through
    jnp.where; the port's early exit never runs them."""
    jm, js, tm, fetch = _pair(_inf_past_the_end)
    want, got, tscope = _run_both(jm, js, tm, {}, fetch)
    np.testing.assert_allclose(got[0], [1.0 / 6.0], rtol=TOL)
    np.testing.assert_allclose(got[1], [1.0 / 6.0], rtol=TOL)
    np.testing.assert_allclose(want[0], got[0], rtol=TOL)
    assert not np.isfinite(want[1]).all()
    w = np.asarray(tscope.find_var("w").numpy())
    assert math.isclose(float(w[0]), 1.0 - 1.0 / 6.0, rel_tol=TOL)
