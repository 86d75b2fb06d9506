"""The static DGC ops and optimizer, and the static PipelineOptimizer, of the
port against the JAX package's.

- `dgc_clip_by_norm`, `dgc` and `dgc_momentum` (ops/misc_ops.py) against
  the reference's ops on seeded inputs, before, during and after the
  rampup (the warm-up walks the sparsity list), with ties at the
  threshold (inputs on a grid of 1/8, where every sum is exact): outputs
  within atol = rtol = 1e-6, the dgc masks (the elements that ship)
  exact, and on the grid every output bitwise;
- `DGCMomentumOptimizer` on a regression Program (an fc with 20480
  weights, above the 16384 DGC floor, and small ones that stay on
  momentum), built by both packages (`to_json` equal), 5 steps from the
  reference's startup values, alone and as a data-parallel
  CompiledProgram at W = 2: losses and every persistable within 1e-6,
  the masks of each step exact;
- `PipelineOptimizer.run_pipeline`: a macro-batch as 4 microbatches,
  an SGD update each, against the reference's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.ops import registry as treg
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-6
DGC_ATTRS = {"m": 0.9, "rampup_begin_step": 2.0, "rampup_step": 4.0,
             "sparsity": [0.75, 0.9, 0.99]}


def _jop(name):
    from paddle_tpu.ops import registry as jreg

    return jreg.get_op(name)


def _run_op(name, ins, attrs):
    import jax.numpy as jnp

    want = _jop(name).fn({k: jnp.asarray(v) for k, v in ins.items()},
                         dict(attrs))
    got = treg.get_op(name).fn({k: torch.from_numpy(np.array(v))
                                for k, v in ins.items()},
                               dict(attrs, _device=torch.device("cpu")))
    assert set(got) == set(want)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def _dgc_inputs(seed, n, grid):
    rng = np.random.default_rng(seed)
    if grid:
        # values on a grid of 1/8 with mu = 0.5: every product and sum
        # is exact, and |v| repeats, so the threshold has ties
        u, v, g = (rng.integers(-16, 17, n).astype(np.float32) / 8
                   for _ in range(3))
    else:
        u, v, g = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    return {"U": u, "V": v, "Grad": g}


def test_dgc_ops_are_registered_as_the_reference_registers_them():
    for name in ("dgc_clip_by_norm", "dgc", "dgc_momentum"):
        mine, ref = treg.get_op(name), _jop(name)
        assert (mine.needs_rng, mine.stateful) == (ref.needs_rng,
                                                   ref.stateful)


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("step", [0.0, 1.0, 2.0, 3.0, 4.5, 5.0, 7.0, 12.0])
def test_dgc_op_matches_the_reference(step, grid):
    ins = dict(_dgc_inputs(int(step * 10) + grid, 5000, grid),
               current_step=np.array([step], np.float32))
    attrs = dict(DGC_ATTRS, m=0.5 if grid else 0.9)
    got, want = _run_op("dgc", ins, attrs)
    for k in want:
        if grid:
            assert np.array_equal(got[k], want[k]), k
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL,
                                   err_msg=k)
    if step >= DGC_ATTRS["rampup_begin_step"]:
        # the elements that ship: GradOut nonzero where the mask is set
        mask_g = (got["VOut"] == 0) & (got["UOut"] == 0)
        mask_w = (want["VOut"] == 0) & (want["UOut"] == 0)
        assert np.array_equal(mask_g, mask_w)
        assert 0 < mask_g.sum() < mask_g.size
    else:
        assert np.array_equal(got["GradOut"], ins["Grad"])


@pytest.mark.parametrize("step", [0.0, 3.0])
@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_dgc_clip_by_norm_matches_the_reference(step, max_norm):
    rng = np.random.default_rng(3)
    ins = {"X": rng.normal(size=(40, 50)).astype(np.float32),
           "current_step": np.array([step], np.float32)}
    got, want = _run_op("dgc_clip_by_norm", ins,
                        {"max_norm": max_norm, "rampup_begin_step": 2.0})
    np.testing.assert_allclose(got["Out"], want["Out"], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("step", [0.0, 5.0])
def test_dgc_momentum_matches_the_reference(step, nesterov):
    rng = np.random.default_rng(4)
    ins = {"Param": rng.normal(size=(30, 20)).astype(np.float32),
           "Grad": rng.normal(size=(30, 20)).astype(np.float32),
           "Velocity": rng.normal(size=(30, 20)).astype(np.float32),
           "LearningRate": np.array([0.1], np.float32),
           "current_step": np.array([step], np.float32)}
    got, want = _run_op("dgc_momentum", ins,
                        {"mu": 0.9, "use_nesterov": nesterov,
                         "rampup_begin_step": 2.0})
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL,
                                   err_msg=k)


def _dgc_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 160])
        y = pkg.data("y", [None, 1])
        h = pkg.layers.fc(x, 128, act="tanh")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(h, 1), y))
        pkg.optimizer.DGCMomentumOptimizer(
            0.1, 0.9, rampup_begin_step=1, sparsity=[0.75, 0.99],
            local_grad_clip_norm=1.0, num_trainers=2).minimize(loss)
    return main, startup, loss.name


def _dgc_feeds(steps=5, batch=8):
    rng = np.random.default_rng(0)
    return [{"x": rng.normal(size=(batch, 160)).astype(np.float32),
             "y": rng.normal(size=(batch, 1)).astype(np.float32)}
            for _ in range(steps)]


def _masks(state):
    """Each DGC'd param's mask of the step: U and V both zeroed."""
    us = sorted(n for n in state if n.endswith("__dgc_u_"))
    return {n: (state[n] == 0) & (state[n.replace("__dgc_u_", "__dgc_v_")]
                                  == 0) for n in us}


@pytest.fixture(scope="module")
def dgc_runs():
    """The reference's DGC program: 5 steps plain and at W = 2, with each
    step's losses and state."""
    import paddle_tpu as jfluid

    main, startup, loss = _dgc_program(jfluid)
    exe = jfluid.Executor()
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    start = {n: np.asarray(v) for n, v in scope.vars.items()}
    runs = {}
    for places in (None, 2):
        sc = jfluid.Scope()
        for n, v in start.items():
            sc.set_var(n, v)
        prog = main if places is None else jfluid.CompiledProgram(
            main).with_data_parallel(loss_name=loss, places=places)
        steps = []
        for f in _dgc_feeds():
            out = exe.run(prog, feed=f, fetch_list=[loss], scope=sc)
            steps.append((np.asarray(out[0]),
                          {n: np.asarray(v) for n, v in sc.vars.items()}))
        runs[places] = steps
    return dict(main=main.to_json(), loss=loss, start=start, runs=runs)


@pytest.mark.parametrize("places", [None, 2])
def test_dgc_optimizer_program_matches_the_reference(dgc_runs, places):
    main, _, loss = _dgc_program(fluid)
    assert main.to_json() == dgc_runs["main"]
    types = [op.type for op in main.global_block().ops]
    assert types.count("dgc") == 1 and types.count("dgc_momentum") == 1
    assert types.count("momentum") == 3 and types.count("increment") == 1
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(dgc_runs["start"], fluid.Scope(), "cpu")
    prog = main if places is None else fluid.CompiledProgram(
        main).with_data_parallel(loss_name=loss, places=places)
    shipped = 0
    for i, (f, (want_loss, want)) in enumerate(zip(
            _dgc_feeds(), dgc_runs["runs"][places])):
        got_loss = exe.run(prog, feed=f, fetch_list=[loss], scope=scope)[0]
        np.testing.assert_allclose(got_loss, want_loss, atol=TOL, rtol=TOL)
        got = interop.scope_to_numpy(scope)
        assert set(got) == set(want)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], atol=TOL, rtol=TOL,
                                       err_msg=f"step {i} {n}")
        for n, m in _masks(want).items():
            assert np.array_equal(_masks(got)[n], m), f"step {i} {n}"
            if i >= 1:
                shipped += int(m.sum())
    # steps 1-4 ship a share walking 25% -> 1% of the 20480 weights
    assert 0 < shipped < 4 * 20480 // 2


def _pipeline_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 12])
        y = pkg.data("y", [None, 1])
        h = pkg.layers.fc(x, 16, act="relu")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(h, 1), y))
        opt = pkg.optimizer.PipelineOptimizer(
            pkg.optimizer.SGD(0.1), cut_list=[[h]],
            place_list=["cpu", "cpu"], concurrency_list=[1, 4])
        opt.minimize(loss)
    return main, startup, loss.name, opt


def test_pipeline_optimizer_runs_microbatches_as_the_reference():
    import paddle_tpu as jfluid

    jmain, jstartup, loss, jopt = _pipeline_program(jfluid)
    main, _, _, opt = _pipeline_program(fluid)
    assert main.to_json() == jmain.to_json()
    assert main._pipeline_cfg.keys() == jmain._pipeline_cfg.keys()
    assert main._pipeline_cfg["concurrency_list"] == [1, 4]
    jexe = jfluid.Executor()
    jscope = jfluid.Scope()
    jexe.run(jstartup, scope=jscope)
    start = {n: np.asarray(v) for n, v in jscope.vars.items()}
    rng = np.random.default_rng(5)
    feed = {"x": rng.normal(size=(16, 12)).astype(np.float32),
            "y": rng.normal(size=(16, 1)).astype(np.float32)}
    with jfluid.scope_guard(jscope):
        want = jopt.run_pipeline(jexe, jmain, feed, [loss])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(start, fluid.Scope(), "cpu")
    with fluid.scope_guard(scope):
        got = opt.run_pipeline(exe, main, feed, [loss])
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for n, v in jscope.vars.items():
        np.testing.assert_allclose(scope.vars[n].numpy(), np.asarray(v),
                                   atol=1e-5, rtol=1e-5, err_msg=n)
    with pytest.raises(ValueError, match="divisible"):
        opt.run_pipeline(exe, main, {n: a[:6] for n, a in feed.items()},
                         [loss], micro_batch_num=4)
