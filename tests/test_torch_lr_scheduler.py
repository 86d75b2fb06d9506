"""The port's learning-rate schedules against the JAX package's.

Each schedule of `layers.learning_rate_scheduler` is built by both
packages (`to_json` equal: the same ops over the persistable
`@LR_DECAY_COUNTER@`, stepped in place by `increment`) and run for 20
steps on each Executor: the fetched learning rates agree within f32
atol = rtol = 1e-5.  An Adam program on `noam_decay` (the Transformer
recipe) takes 3 steps in each package from the reference's startup: the
learning rates, losses and the first three updates of every parameter
agree (Adam's first update is about lr * sign(g), so a grad within f32
noise of 0 may flip it: atol 2 lr + 1e-5, the rule of
tests/test_torch_static_zoo.py).
"""

import numpy as np
import pytest

import paddle_tpu as jfluid

import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-5
STEPS = 20

SCHEDULES = {
    "piecewise_decay": lambda L: L.piecewise_decay([3, 8], [1.0, 0.5, 0.1]),
    "noam_decay": lambda L: L.noam_decay(64, 5),
    "noam_decay_scaled": lambda L: L.noam_decay(512, 4000, 2.0),
    "exponential_decay": lambda L: L.exponential_decay(0.1, 5, 0.5),
    "exponential_decay_staircase": lambda L: L.exponential_decay(
        0.1, 5, 0.5, staircase=True),
    "natural_exp_decay": lambda L: L.natural_exp_decay(0.1, 4, 0.3),
    "natural_exp_decay_staircase": lambda L: L.natural_exp_decay(
        0.1, 4, 0.3, staircase=True),
    "inverse_time_decay": lambda L: L.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_decay_staircase": lambda L: L.inverse_time_decay(
        0.1, 3, 0.5, staircase=True),
    "polynomial_decay": lambda L: L.polynomial_decay(0.1, 10, 0.001, 2.0),
    "polynomial_decay_cycle": lambda L: L.polynomial_decay(
        0.1, 6, 0.001, 1.0, cycle=True),
    "cosine_decay": lambda L: L.cosine_decay(0.1, 4, 5),
    "linear_lr_warmup": lambda L: L.linear_lr_warmup(0.1, 5, 0.0, 0.1),
    "linear_lr_warmup_over_decay": lambda L: L.linear_lr_warmup(
        L.exponential_decay(0.1, 5, 0.5), 6, 0.01, 0.1),
}


def _build(pkg, make):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        lr = make(pkg.layers)
    return main, startup, lr.name


def _schedule(pkg, main, startup, lr, place):
    exe = pkg.Executor(place)
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    return [float(np.asarray(exe.run(main, fetch_list=[lr],
                                     scope=scope)[0]).reshape(-1)[0])
            for _ in range(STEPS)]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_values_match_the_reference(name):
    jm, js, jlr = _build(jfluid, SCHEDULES[name])
    tm, ts, tlr = _build(fluid, SCHEDULES[name])
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()
    want = _schedule(jfluid, jm, js, jlr, None)
    got = _schedule(fluid, tm, ts, tlr, fluid.CPUPlace())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the counter is the step: persistable, stepped in place
    counter = [v for v in tm.list_vars() if v.name == "@LR_DECAY_COUNTER@"]
    assert counter and counter[0].persistable


def test_layers_namespace_exports_every_schedule():
    from paddle_tpu_torch import layers

    for name in jfluid.layers.learning_rate_scheduler.__all__:
        assert getattr(layers, name) is getattr(
            layers.learning_rate_scheduler, name)


def _adam_noam(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 6])
        y = pkg.data("y", [None, 1])
        h = pkg.layers.fc(x, 8, act="tanh")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(h, 1), y))
        lr = pkg.layers.noam_decay(8, warmup_steps=2, learning_rate=0.5)
        pkg.optimizer.Adam(lr).minimize(loss)
    return main, startup, loss.name, lr.name


def test_adam_on_noam_decay_matches_the_first_three_updates():
    jm, js, jloss, jlr = _adam_noam(jfluid)
    tm, ts, tloss, tlr = _adam_noam(fluid)
    assert tm.to_json() == jm.to_json()
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(js, scope=jscope)
    params = [p.name for p in tm.all_parameters()]
    state = {n: np.asarray(v) for n, v in jscope.vars.items()}
    texe = fluid.Executor(fluid.CPUPlace())
    tscope = interop.scope_from_numpy(state, fluid.Scope(), "cpu")
    rng = np.random.default_rng(0)
    for step in range(3):
        feed = {"x": rng.normal(size=(5, 6)).astype(np.float32),
                "y": rng.normal(size=(5, 1)).astype(np.float32)}
        before = {n: np.asarray(jscope.find_var(n)) for n in params}
        want = jexe.run(jm, feed=feed, fetch_list=[jloss, jlr],
                        scope=jscope)
        got = texe.run(tm, feed=feed, fetch_list=[tloss, tlr],
                       scope=tscope)
        np.testing.assert_allclose(got[1], want[1], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=TOL)
        lr = float(np.asarray(want[1]).reshape(-1)[0])
        for n in params:
            upd_t = tscope.find_var(n).numpy() - before[n]
            upd_j = np.asarray(jscope.find_var(n)) - before[n]
            np.testing.assert_allclose(upd_t, upd_j, rtol=TOL,
                                       atol=2 * lr + TOL, err_msg=n)
            # and most elements far closer than the sign-flip bound
            assert np.mean(np.abs(upd_t - upd_j) <= 1e-4 * lr + TOL) > 0.9
        # the port's state carries on from its own updates
        interop.scope_from_numpy(
            {n: np.asarray(v) for n, v in jscope.vars.items()}, tscope,
            "cpu")
