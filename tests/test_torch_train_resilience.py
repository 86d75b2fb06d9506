"""The fault-tolerance half of the port's train loop against the JAX
package's: the executor-loop cases of the reference's
tests/test_resilience.py (:282-1035), each run on both packages.

Every scenario is one function over a package bundle (`_Pkg`: its fluid
namespace, resilience, fault injection, checkpoint manager and monitor),
run once with the reference and once with the port (CPU).  Outcomes
(what raised, where the loop stopped, which checkpoints exist, the
preemption flag), the `resilience.*` monitor counters and the trained or
restored parameters are equal across the two (f32 atol = rtol = 1e-5,
both from the reference's startup state, the train tier off in both so
that neither rounds to bf16), and rollback and resume are bitwise equal,
within each package, to that package's uninterrupted run.  The guard's
skip, raise and escalation; rollback in a bare loop, in the loop, before
any checkpoint and without checkpoint=; the checkpoint cadence;
preemption then auto_resume; SIGTERM (in a subprocess); the flag cleared
once handled, the checkpoint-less warning and drain; mismatched managers
and rollback with a sparse push refused; the replay batches kept on the
host; `guarded_step`.
"""

import os
import pathlib
import signal
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import checkpoint as jckpt
from paddle_tpu import monitor as jmon
from paddle_tpu import resilience as jres

import paddle_tpu_torch as fluid
from paddle_tpu_torch import checkpoint as tckpt
from paddle_tpu_torch import interop
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import resilience as tres
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-5
REPO = pathlib.Path(__file__).resolve().parents[1]
W = "fc_0.w_0"


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.port = name == "port"
        self.fluid = fluid if self.port else jfluid
        self.res = tres if self.port else jres
        self.fi = self.res.faultinject
        self.ckpt = tckpt if self.port else jckpt
        self.mon = tmon if self.port else jmon

    def executor(self):
        return (fluid.Executor(fluid.CPUPlace()) if self.port
                else jfluid.Executor())

    @staticmethod
    def np(v):
        return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    def counters(self):
        # the non-zero counts: a registry keeps a counter at 0 across
        # `reset()` once any earlier test in the process created it
        c = self.mon.snapshot().get("counters", {})
        return {k: v for k, v in c.items() if k.startswith("resilience.")
                and not k.endswith("_s") and v}


PKGS = ("reference", "port")


@pytest.fixture(autouse=True)
def _clean():
    names = {"FLAGS_amp": "off", "FLAGS_graph_opt_fuse": "off"}
    old = [m.get_flags(list(names)) for m in (jfluid, fluid)]
    for m in (jfluid, fluid):
        m.set_flags(names)
    for mon in (jmon, tmon):
        mon.reset()
        mon.enable()
    yield
    for m, o in zip((jfluid, fluid), old):
        m.set_flags(o)
    for res in (jres, tres):
        res.disable_anomaly_guard()
        res.disable_retry()
        res.clear_preemption()
        res.faultinject.disarm()
    for mon in (jmon, tmon):
        mon.disable()
        mon.reset()


def _program(P):
    L = P.fluid.layers
    with P.fluid.unique_name.guard():
        main, startup = P.fluid.Program(), P.fluid.Program()
        with P.fluid.program_guard(main, startup):
            x = P.fluid.data("x", [None, 8])
            y = P.fluid.data("y", [None, 1])
            loss = L.mean(L.square_error_cost(L.fc(x, 1), y))
            P.fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss.name


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((16, 8)).astype(np.float32),
             "y": rng.standard_normal((16, 1)).astype(np.float32)}
            for _ in range(n)]


_START = {}


def _setup(P):
    """(exe, scope, main, startup, loss) with the reference's startup
    values in either package's scope."""
    main, startup, loss = _program(P)
    if "state" not in _START:
        jm, js, _ = _program(_Pkg("reference"))
        exe, sc = jfluid.Executor(), jfluid.Scope()
        exe.run(js, scope=sc)
        _START["state"] = {n: np.asarray(v) for n, v in sc.vars.items()}
    exe = P.executor()
    if P.port:
        scope = interop.scope_from_numpy(_START["state"], fluid.Scope(),
                                         "cpu")
    else:
        scope = jfluid.Scope()
        import jax.numpy as jnp

        for n, v in _START["state"].items():
            scope.set_var(n, jnp.asarray(v))
    return exe, scope, main, startup, loss


def _uninterrupted(P, batches, train_loop):
    exe, sc, main, _, loss = _setup(P)
    if train_loop:
        exe.train_from_dataset(main, list(batches), scope=sc,
                               fetch_list=[loss], print_period=100,
                               prefetch=False)
    else:
        for b in batches:
            exe.run(main, feed=b, fetch_list=[loss], scope=sc)
    return P.np(sc.find_var(W))


def _both(body, tmp_path):
    """Run `body(P, tmp)` for each package (each in its own directory);
    return {name: result}."""
    out = {}
    for name in PKGS:
        P = _Pkg(name)
        P.mon.reset()
        tmp = tmp_path / name
        tmp.mkdir()
        out[name] = body(P, tmp)
    return out


def _same(out, weights=(), exact=()):
    """The reference's and the port's outcomes equal: `weights` keys
    within TOL, `exact` keys equal, every other key equal."""
    ref, port = out["reference"], out["port"]
    assert ref.keys() == port.keys()
    for k in ref:
        if k in weights:
            np.testing.assert_allclose(port[k], ref[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
        else:
            assert port[k] == ref[k], (k, port[k], ref[k])


def test_guard_skip_step_commits_nothing(tmp_path):
    def body(P, tmp):
        exe, sc, main, _, loss = _setup(P)
        P.res.enable_anomaly_guard(policy="skip_step")
        snaps = []
        with P.fi.plan_scope(nan_at_steps=[2]):
            for b in _batches(5):
                snaps.append(P.np(sc.find_var(W)).copy())
                exe.run(main, feed=b, fetch_list=[loss], scope=sc)
        w = P.np(sc.find_var(W))
        assert np.array_equal(snaps[3], snaps[2])
        assert not np.array_equal(snaps[2], snaps[1])
        assert np.isfinite(w).all()
        return {"w": w, "counters": P.counters()}

    out = _both(body, tmp_path)
    _same(out, weights=("w",))
    assert out["port"]["counters"]["resilience.skipped_steps"] == 1


def test_guard_raise_and_escalation(tmp_path):
    def body(P, tmp):
        exe, sc, main, _, loss = _setup(P)
        b = _batches(1)[0]
        res = {}
        P.res.enable_anomaly_guard(policy="raise")
        exe.run(main, feed=b, fetch_list=[loss], scope=sc)
        with P.fi.plan_scope(nan_at_steps=[0]):
            with pytest.raises(P.res.AnomalyError) as e:
                exe.run(main, feed=b, fetch_list=[loss], scope=sc)
        res["raise"] = str(e.value)
        P.res.enable_anomaly_guard(policy="skip_step", max_consecutive=2)
        with P.fi.plan_scope(nan_at_steps=[0, 1, 2]):
            exe.run(main, feed=b, fetch_list=[loss], scope=sc)
            exe.run(main, feed=b, fetch_list=[loss], scope=sc)
            with pytest.raises(P.res.AnomalyError) as e:
                exe.run(main, feed=b, fetch_list=[loss], scope=sc)
        res["escalate"] = str(e.value)
        res["counters"] = P.counters()
        res["w"] = P.np(sc.find_var(W))
        return res

    _same(_both(body, tmp_path), weights=("w",))


def test_guard_rollback_in_a_bare_loop_is_bitwise(tmp_path):
    def body(P, tmp):
        batches = _batches(6)
        ref_w = _uninterrupted(P, batches, train_loop=False)
        mgr = P.ckpt.CheckpointManager(tmp, save_interval_steps=1)
        exe, sc, main, _, loss = _setup(P)
        persist = sorted(v.name for v in main.list_vars() if v.persistable)
        P.res.enable_anomaly_guard(policy="rollback", manager=mgr)
        rollbacks = []
        with P.fi.plan_scope(nan_at_steps=[4]):
            i = 0
            while i < len(batches):
                try:
                    exe.run(main, feed=batches[i], fetch_list=[loss],
                            scope=sc)
                except P.res.RollbackPerformed as rb:
                    rollbacks.append((i, rb.step))
                    i = rb.step
                    continue
                i += 1
                mgr.save({n: sc.find_var(n) for n in persist
                          if sc.find_var(n) is not None}, i)
        w = P.np(sc.find_var(W))
        assert np.array_equal(w, ref_w)
        return {"rollbacks": rollbacks, "w": w, "counters": P.counters()}

    out = _both(body, tmp_path)
    _same(out, weights=("w",))
    assert out["port"]["rollbacks"] == [(4, 4)]


@pytest.mark.parametrize("case", ["with_manager", "without_checkpoint_kwarg",
                                  "first_batch"])
def test_loop_rollback_replays_the_cursor_bitwise(tmp_path, case):
    n, nan_at, every = {"with_manager": (7, 5, 2),
                        "without_checkpoint_kwarg": (5, 3, 2),
                        "first_batch": (5, 0, 2)}[case]

    def body(P, tmp):
        batches = _batches(n)
        ref_w = _uninterrupted(P, batches, train_loop=True)
        mgr = P.ckpt.CheckpointManager(tmp, save_interval_steps=every)
        exe, sc, main, _, loss = _setup(P)
        P.res.enable_anomaly_guard(policy="rollback", manager=mgr)
        kw = {"checkpoint": mgr} if case == "with_manager" else {}
        with P.fi.plan_scope(nan_at_steps=[nan_at]):
            exe.train_from_dataset(main, batches, scope=sc,
                                   fetch_list=[loss], print_period=100,
                                   prefetch=False, **kw)
        w = P.np(sc.find_var(W))
        assert np.array_equal(w, ref_w)
        return {"w": w, "counters": P.counters(),
                "latest": mgr.latest_step()}

    out = _both(body, tmp_path)
    _same(out, weights=("w",))
    assert out["port"]["counters"]["resilience.rollbacks"] == 1


def test_rollback_before_any_checkpoint_escalates(tmp_path):
    def body(P, tmp):
        exe, sc, main, _, loss = _setup(P)
        P.res.enable_anomaly_guard(
            policy="rollback", manager=P.ckpt.CheckpointManager(tmp))
        with P.fi.plan_scope(nan_at_steps=[0]):
            with pytest.raises(P.res.AnomalyError,
                               match="before any complete checkpoint"):
                exe.run(main, feed=_batches(1)[0], fetch_list=[loss],
                        scope=sc)
        return {"w": P.np(sc.find_var(W)), "counters": P.counters()}

    _same(_both(body, tmp_path), weights=("w",))


def test_checkpoint_cadence_and_gated_saves(tmp_path):
    def body(P, tmp):
        exe, sc, main, _, loss = _setup(P)
        calls = []

        class Counting(P.ckpt.CheckpointManager):
            def save(self, state, step, **kw):
                calls.append(step)
                return super().save(state, step, **kw)

        exe.train_from_dataset(main, _batches(7), scope=sc,
                               fetch_list=[loss], print_period=100,
                               checkpoint={"directory": str(tmp / "a"),
                                           "save_interval_steps": 3})
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp / "a")
                       if d.startswith("step_"))
        extras = sorted(P.ckpt.load_extras(str(tmp / "a")))
        exe.train_from_dataset(main, _batches(7), scope=sc,
                               fetch_list=[loss], print_period=100,
                               prefetch=False,
                               checkpoint=Counting(tmp / "b",
                                                   save_interval_steps=3))
        return {"steps": steps, "calls": calls, "extras": extras,
                "w": P.np(sc.find_var(W))}

    out = _both(body, tmp_path)
    assert out["reference"]["steps"] == out["port"]["steps"] == [3, 6]
    assert out["port"]["calls"] == [3, 6]
    # the rng sidecar: the reference's PRNG key, the port's generator
    assert out["reference"]["extras"] == ["executor_rng_key"]
    assert out["port"]["extras"] == ["executor_generator_state"]
    np.testing.assert_allclose(out["port"]["w"], out["reference"]["w"],
                               rtol=TOL, atol=TOL)


def test_preempt_then_auto_resume_is_bitwise(tmp_path):
    def body(P, tmp):
        batches = _batches(8)
        ref_w = _uninterrupted(P, batches, train_loop=True)
        exe, sc, main, startup, loss = _setup(P)

        def preempting():
            for i, b in enumerate(batches):
                if i == 5:
                    P.res.request_preemption()
                yield b

        ck = {"directory": str(tmp), "save_interval_steps": 1000}
        exe.train_from_dataset(main, preempting(), scope=sc,
                               fetch_list=[loss], checkpoint=ck,
                               print_period=100, prefetch=False)
        stopped = P.ckpt.latest_step(str(tmp))
        flag = P.res.preemption_requested()
        exe2, sc2, _, _, _ = _setup(P)         # a relaunch
        exe2.train_from_dataset(main, batches, scope=sc2,
                                fetch_list=[loss], checkpoint=ck,
                                auto_resume=True, print_period=100)
        w = P.np(sc2.find_var(W))
        assert np.array_equal(w, ref_w)
        return {"stopped": stopped, "flag": flag, "w": w,
                "counters": P.counters()}

    out = _both(body, tmp_path)
    _same(out, weights=("w",))
    c = out["port"]["counters"]
    assert out["port"]["stopped"] == 5 and not out["port"]["flag"]
    assert (c["resilience.preempt_checkpoint"], c["resilience.auto_resume"],
            c["resilience.batches_skipped"]) == (1, 1, 5)


def test_preempt_flag_handling_and_checkpointless_runs(tmp_path):
    def body(P, tmp):
        exe, sc, main, _, loss = _setup(P)
        res = {}
        # handled: a durable checkpoint, the flag comes down, the next
        # loop trains
        P.res.request_preemption()
        exe.train_from_dataset(main, _batches(3), scope=sc,
                               fetch_list=[loss], checkpoint=str(tmp / "a"),
                               print_period=100, prefetch=False)
        res["cleared"] = not P.res.preemption_requested()
        w0 = P.np(sc.find_var(W)).copy()
        exe.train_from_dataset(main, _batches(3), scope=sc,
                               fetch_list=[loss], print_period=100,
                               prefetch=False)
        res["trained"] = not np.array_equal(P.np(sc.find_var(W)), w0)
        # no checkpoint store: stop, warn, leave the flag up
        P.res.request_preemption()
        with pytest.warns(RuntimeWarning, match="no checkpoint="):
            out = exe.train_from_dataset(main, _batches(3), scope=sc,
                                         fetch_list=[loss],
                                         print_period=100, prefetch=False)
        res["drain_out"] = out
        res["flag_kept"] = P.res.preemption_requested()
        P.res.clear_preemption()
        # a boundary already durable is not rewritten
        forced = []

        class Spy(P.ckpt.CheckpointManager):
            def save(self, state, step, force=False, **kw):
                if force:
                    forced.append(step)
                return super().save(state, step, force=force, **kw)

        mgr = Spy(tmp / "b", save_interval_steps=1)
        batches = _batches(5)

        def preempting():
            for i, b in enumerate(batches):
                if i == 3:
                    P.res.request_preemption()
                yield b

        exe.train_from_dataset(main, preempting(), scope=sc,
                               fetch_list=[loss], checkpoint=mgr,
                               print_period=100, prefetch=False)
        res["forced"] = forced
        res["latest"] = mgr.latest_step()
        res["counters"] = P.counters()
        res["w"] = P.np(sc.find_var(W))
        return res

    out = _both(body, tmp_path)
    _same(out, weights=("w",))
    p = out["port"]
    assert p["cleared"] and p["trained"] and p["drain_out"] is None
    assert p["flag_kept"] and p["forced"] == [] and p["latest"] == 3


def test_refusals(tmp_path):
    def body(P, tmp):
        exe, sc, main, _, loss = _setup(P)
        msgs = []
        P.res.enable_anomaly_guard(
            policy="rollback",
            manager=P.ckpt.CheckpointManager(tmp / "a"))
        with pytest.raises(ValueError, match="same one") as e:
            exe.train_from_dataset(
                main, _batches(1), fetch_list=[loss], scope=sc,
                checkpoint=P.ckpt.CheckpointManager(tmp / "b"))
        msgs.append(str(e.value))

        class _Table:
            def pull(self, ids):
                return np.zeros((len(ids), 4), np.float32)

            def push(self, ids, g):
                pass

        mgr = P.res.active_guard().manager
        with pytest.raises(ValueError, match="rollback") as e:
            exe.train_from_dataset(
                main, _batches(1), fetch_list=[loss], checkpoint=mgr,
                scope=sc, sparse_config={"table": _Table(), "ids_var": "x",
                                         "emb_var": "x"})
        msgs.append(str(e.value))
        P.res.disable_anomaly_guard()
        with pytest.raises(ValueError, match="auto_resume") as e:
            exe.train_from_dataset(main, _batches(1), fetch_list=[loss],
                                   scope=sc, auto_resume=True)
        msgs.append(str(e.value))
        return {"msgs": msgs}

    _same(_both(body, tmp_path))


def test_replay_batches_stay_on_the_host(monkeypatch):
    """The rollback replay buffer keeps every feed since the last save:
    host numpy arrays, never the device tensors the prefetch made."""
    from paddle_tpu_torch import reader as treader

    P = _Pkg("port")
    exe, sc, main, _, loss = _setup(P)
    used = []
    real = treader.device_prefetch
    monkeypatch.setattr(treader, "device_prefetch",
                        lambda gen, **kw: used.append(1) or real(gen, **kw))
    exe.train_from_dataset(main, _batches(2), scope=sc, fetch_list=[loss],
                           print_period=100)
    assert used
    del used[:]
    seen = []
    inner = exe.run

    def run(program=None, feed=None, **kw):
        seen.extend(type(v) for v in (feed or {}).values())
        return inner(program, feed=feed, **kw)

    monkeypatch.setattr(exe, "run", run)
    tres.enable_anomaly_guard(policy="rollback",
                              manager=tckpt.CheckpointManager(
                                  tempfile.mkdtemp()))
    exe.train_from_dataset(main, _batches(2), scope=sc, fetch_list=[loss],
                           print_period=100)
    assert not used
    assert seen and all(t is np.ndarray for t in seen), seen


def test_skip_step_pushes_no_nan_rows_and_eval_ignores_the_manager(
        tmp_path):
    from paddle_tpu.distributed.ps import SparseEmbedding as JTable

    from paddle_tpu_torch.distributed.ps import SparseEmbedding as TTable

    start = {}                  # the reference runs first (PKGS order)

    def body(P, tmp):
        dim = 4
        table = (TTable(dim=dim, num_shards=2, lr=0.2, seed=0, device="cpu")
                 if P.port else JTable(dim=dim, num_shards=2, lr=0.2,
                                       seed=0))
        L = P.fluid.layers
        with P.fluid.unique_name.guard():
            main, startup = P.fluid.Program(), P.fluid.Program()
            with P.fluid.program_guard(main, startup):
                emb = P.fluid.data("emb", [None, 2, dim])
                label = P.fluid.data("label", [None, 1])
                loss = L.mean(L.sigmoid_cross_entropy_with_logits(
                    L.fc(L.reshape(emb, [-1, 2 * dim]), 1), label))
                params = [p.name for p in main.all_parameters()]
                P.fluid.backward.append_backward(
                    loss, parameter_list=params + [emb.name])
                P.fluid.optimizer.SGD(0.2).apply_gradients(
                    [(main.global_block().var(p),
                      main.global_block().var(p + "@GRAD"))
                     for p in params])
        exe = P.executor()
        sc = P.fluid.Scope()
        exe.run(startup, scope=sc)
        if P.port:
            # the reference's startup values (its fc draws differ)
            interop.scope_from_numpy(start, sc, "cpu")
        else:
            start.update({n: np.asarray(v) for n, v in sc.vars.items()})
        r = np.random.default_rng(0)
        batches = [{"ids": r.integers(0, 20, (8, 2)).astype(np.int64),
                    "label": r.integers(0, 2, (8, 1)).astype(np.float32)}
                   for _ in range(3)]
        P.res.enable_anomaly_guard(policy="skip_step")
        with P.fi.plan_scope(nan_at_steps=[1]):
            exe.train_from_dataset(
                main, batches, scope=sc, fetch_list=[loss],
                print_period=100,
                sparse_config={"table": table, "ids_var": "ids",
                               "emb_var": "emb"})
        ids = np.unique(np.concatenate([b["ids"].ravel() for b in batches]))
        rows = P.np(table.pull(ids))
        assert np.isfinite(rows).all() and len(table) > 0
        # an eval drain under a rollback guard saves nothing
        mgr = P.ckpt.CheckpointManager(tmp, save_interval_steps=1)
        P.res.enable_anomaly_guard(policy="rollback", manager=mgr)
        test = main.clone(for_test=True)
        exe.infer_from_dataset(test, [dict(b, emb=np.zeros(
            (8, 2, dim), np.float32)) for b in batches], scope=sc,
            fetch_list=[loss], print_period=100)
        return {"counters": P.counters(), "latest": mgr.latest_step(),
                "files": sorted(os.listdir(tmp)), "rows": rows}

    out = _both(body, tmp_path)
    _same(out, weights=("rows",))
    assert out["port"]["latest"] is None and out["port"]["files"] == []


SIGTERM_CHILD = r"""
import os, signal, sys
sys.path.insert(0, {repo!r})
import paddle_tpu_torch as fluid
from paddle_tpu_torch import resilience
from paddle_tpu_torch.checkpoint import CheckpointManager, latest_step
import numpy as np

main, startup = fluid.Program(), fluid.Program()
with fluid.unique_name.guard(), fluid.program_guard(main, startup):
    x = fluid.data("x", [None, 8])
    y = fluid.data("y", [None, 1])
    loss = fluid.layers.mean(fluid.layers.square_error_cost(
        fluid.layers.fc(x, 1), y))
    fluid.optimizer.SGD(0.1).minimize(loss)
exe = fluid.Executor(fluid.CPUPlace())
exe.run(startup)
rng = np.random.default_rng(0)

def batches():
    for i in range(10):
        if i == 4:
            os.kill(os.getpid(), signal.SIGTERM)   # the orchestrator
        yield {{"x": rng.standard_normal((4, 8)).astype(np.float32),
               "y": rng.standard_normal((4, 1)).astype(np.float32)}}

with resilience.PreemptionHandler():
    exe.train_from_dataset(main, batches(), fetch_list=[loss],
                           checkpoint={{"directory": {ckpt!r},
                                        "save_interval_steps": 100}},
                           print_period=100, prefetch=False)
print("stopped at", latest_step({ckpt!r}),
      "flag", resilience.preemption_requested(),
      "handler restored", signal.getsignal(signal.SIGTERM) == signal.SIG_DFL)
"""


def test_sigterm_in_a_subprocess_checkpoints_and_exits(tmp_path):
    code = SIGTERM_CHILD.format(repo=str(REPO), ckpt=str(tmp_path / "c"))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stdout + out.stderr
    # the signal lands while batch 4 is made: the boundary before it
    assert "stopped at 4 flag False handler restored True" in out.stdout, \
        out.stdout


def test_signal_handler_semantics_match(tmp_path):
    def body(P, tmp):
        h = P.res.PreemptionHandler()
        h._on_signal(signal.SIGTERM, None)
        first = P.res.preemption_requested()
        h._on_signal(signal.SIGINT, None)     # first Ctrl-C: graceful
        with pytest.raises(KeyboardInterrupt):
            h._on_signal(signal.SIGINT, None)
        P.res.clear_preemption()
        with P.mon._registry._lock:           # async-signal-safe
            P.res.request_preemption()
        return {"first": first, "again": P.res.preemption_requested()}

    _same(_both(body, tmp_path))


def test_guarded_step_skip_and_rollback(tmp_path):
    """The reference's guarded_step case (an AMP train step of a tiny
    GPT), each package on its own model and step: the same outcomes and
    counters, and the rollback restores the saved params bitwise."""

    def body(P, tmp):
        if P.port:
            from paddle_tpu_torch.amp import make_amp_train_step
            from paddle_tpu_torch.models.gpt import GPT, GPTConfig
            from paddle_tpu_torch.models.train import TrainState
            from paddle_tpu_torch.optimizer.functional import SGD

            m = GPT(GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                              num_heads=2, max_seq_len=8), device="cpu")
            step, make_state = make_amp_train_step(m, SGD(0.1),
                                                   donate=False)
        else:
            from paddle_tpu.amp import make_amp_train_step
            from paddle_tpu.models.gpt import GPT, GPTConfig
            from paddle_tpu.models.train import TrainState
            from paddle_tpu.optimizer.functional import SGD

            m = GPT(GPTConfig(vocab_size=32, hidden_size=16, num_layers=1,
                              num_heads=2, max_seq_len=8))
            step, make_state = make_amp_train_step(m, SGD(0.1), jit=True,
                                                   donate=False)
        state = make_state()
        r = np.random.default_rng(0)
        x = r.integers(0, 32, (2, 8)).astype(np.int32)
        if P.port:
            x = torch.from_numpy(x)
        mgr = P.ckpt.CheckpointManager(tmp, save_interval_steps=1)
        guard = P.res.enable_anomaly_guard(policy="skip_step")
        gstep = P.res.guarded_step(step, guard)
        state, loss, ok = gstep(state, x, x)
        mgr.save(state, 1)
        ts, sc = state
        bad = dict(ts.params)
        k = next(iter(bad))
        bad[k] = ts.params[k] * float("nan")
        poisoned = (TrainState(params=bad, opt_state=ts.opt_state,
                               buffers=ts.buffers, step=ts.step,
                               rng=ts.rng), sc)
        _, _, ok2 = gstep(poisoned, x, x)
        guard = P.res.enable_anomaly_guard(policy="rollback", manager=mgr)
        gstep = P.res.guarded_step(step, guard)
        with pytest.raises(P.res.RollbackPerformed) as ei:
            gstep(poisoned, x, x)
        restored = P.np(ei.value.state[0].params[k])
        assert np.array_equal(restored, P.np(ts.params[k]))
        return {"ok": bool(ok), "ok2": bool(ok2), "step": ei.value.step,
                "counters": P.counters()}

    out = _both(body, tmp_path)
    _same(out)
    assert out["port"]["ok"] and not out["port"]["ok2"]


def test_healthz_reports_an_anomaly_streak(tmp_path):
    def body(P, tmp):
        from importlib import import_module

        exporter = import_module(P.mon.__name__ + ".exporter")
        exe, sc, main, _, loss = _setup(P)
        P.res.enable_anomaly_guard(policy="skip_step")
        b = _batches(1)[0]
        with P.fi.plan_scope(nan_at_steps=[0]):
            exe.run(main, feed=b, fetch_list=[loss], scope=sc)
        bad = exporter.health()
        reason = exporter._health_reason(bad[1])
        exe.run(main, feed=b, fetch_list=[loss], scope=sc)
        good = exporter.health()
        return {"bad": (bad[0], bad[1]["anomaly_streak"]),
                "reason": reason,
                "good": (good[0], good[1]["anomaly_streak"])}

    out = _both(body, tmp_path)
    _same(out)
    assert out["port"]["bad"] == (False, 1)
    assert out["port"]["reason"] == "anomaly_streak"
