"""The port's data-parallel static step (`CompiledProgram.with_data_parallel`,
`Executor.run`, `transpiler.collective`, `ParallelExecutor`) against the
JAX package's.

The reference runs its CompiledProgram on the 8 virtual CPU devices of
tests/conftest.py; the port runs W ranks held in this process on the CPU
(`places=W`, a thread a rank).  The same Program crosses as
`Program.to_json()`, the same startup values as numpy
(`interop.scope_from_numpy`), the same seeded numpy feeds go to both.
Fetches and persistables agree within atol = rtol = 1e-5 (f32): the
losses of 5 SGD steps and the final params at W = 2 and 8, a batch-norm
program's running stats after the state sync, the concatenated rank-1
fetch.  Bucketing is held exactly: `plan_buckets` and `last_sync_stats()`
equal the reference's for the same grads, and the bucketed step equals
the per-gradient one bitwise.

One launch of two gloo worker processes (`python
tests/test_torch_compiled_program.py <program dir> <out dir>`, killed
after 120 s; no jax in the workers) runs the same steps with one rank a
process, each process feeding its own half of the batch, against the
in-process W = 2 run.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.transpiler import collective as tcoll
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-5
STEPS = 5
BATCH = 16


def _mlp(pkg, lr=0.05):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 24])
        y = pkg.data("y", [None, 1], dtype="int64")
        h = pkg.layers.fc(x, 32, act="relu")
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            pkg.layers.fc(h, 10), y))
        pkg.optimizer.SGD(lr).minimize(loss)
    return main, startup, loss.name


def _bn(pkg, lr=0.05):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 3, 6, 6])
        y = pkg.data("y", [None, 1])
        h = pkg.layers.conv2d(x, 4, 3, padding=1)
        h = pkg.layers.batch_norm(h, act="relu")
        pred = pkg.layers.fc(pkg.layers.reshape(h, [-1, 144]), 1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.Momentum(lr, 0.9).minimize(loss)
    return main, startup, loss.name


BUILDERS = {"mlp": _mlp, "bn": _bn}


def _feeds(name, steps=STEPS, batch=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        if name == "mlp":
            out.append({"x": rng.normal(size=(batch, 24)).astype(np.float32),
                        "y": rng.integers(0, 10, (batch, 1)).astype(
                            np.int64)})
        else:
            out.append({"x": rng.normal(size=(batch, 3, 6, 6)).astype(
                np.float32), "y": rng.normal(size=(batch, 1)).astype(
                np.float32)})
    return out


def _reference(name, places, bucket_bytes=None):
    """The JAX package's run: (main json, startup values, losses,
    persistables, last_sync_stats)."""
    import paddle_tpu as jfluid
    from paddle_tpu.transpiler import collective as jcoll

    entry = jfluid.get_flags(["FLAGS_dp_bucket_bytes"])
    if bucket_bytes is not None:
        jfluid.set_flags({"FLAGS_dp_bucket_bytes": bucket_bytes})
    try:
        main, startup, loss = BUILDERS[name](jfluid)
        exe = jfluid.Executor()
        scope = jfluid.Scope()
        exe.run(startup, scope=scope)
        start = {n: np.asarray(v) for n, v in scope.vars.items()}
        prog = jfluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss, places=places)
        losses = [np.asarray(exe.run(prog, feed=f, fetch_list=[loss],
                                     scope=scope)[0])
                  for f in _feeds(name)]
        state = {n: np.asarray(v) for n, v in scope.vars.items()}
        return dict(main=main.to_json(), loss=loss, start=start,
                    losses=losses, state=state,
                    stats=jcoll.last_sync_stats())
    finally:
        jfluid.set_flags(entry)


def _port(ref, places, name="mlp", bucket_bytes=None, compiled=True):
    """The port's run of the reference's Program from its startup values:
    (losses, persistables, last_sync_stats)."""
    entry = fluid.get_flags(["FLAGS_dp_bucket_bytes"])
    if bucket_bytes is not None:
        fluid.set_flags({"FLAGS_dp_bucket_bytes": bucket_bytes})
    try:
        main = fluid.Program.from_json(ref["main"])
        exe = fluid.Executor(fluid.CPUPlace())
        scope = interop.scope_from_numpy(ref["start"], fluid.Scope(), "cpu")
        prog = main
        if compiled:
            prog = fluid.CompiledProgram(main)
            if places is not False:
                prog = prog.with_data_parallel(loss_name=ref["loss"],
                                               places=places)
        losses = [exe.run(prog, feed=f, fetch_list=[ref["loss"]],
                          scope=scope)[0] for f in _feeds(name)]
        return losses, interop.scope_to_numpy(scope), \
            tcoll.last_sync_stats()
    finally:
        fluid.set_flags(entry)


@pytest.fixture(scope="module")
def refs():
    """The reference's runs, made once: mlp at W = 2 and 8, bn at 4."""
    return {("mlp", 2): _reference("mlp", 2), ("mlp", 8): _reference("mlp", 8),
            ("bn", 4): _reference("bn", 4)}


def _hold(got, want):
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=TOL, rtol=TOL,
                                   err_msg=n)


@pytest.mark.parametrize("places", [2, 8])
def test_dp_steps_match_the_reference(refs, places):
    ref = refs[("mlp", places)]
    losses, state, stats = _port(ref, places)
    assert [np.shape(x) for x in losses] == [np.shape(x)
                                            for x in ref["losses"]]
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref["losses"]),
                               atol=TOL, rtol=TOL)
    _hold(state, ref["state"])
    assert stats == ref["stats"]


def test_batch_norm_running_stats_are_averaged_over_the_ranks(refs):
    ref = refs[("bn", 4)]
    losses, state, _ = _port(ref, 4, name="bn")
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref["losses"]),
                               atol=TOL, rtol=TOL)
    _hold(state, ref["state"])
    # the running variance is the ranks' mean, not the whole batch's: a
    # one-rank run of the same steps ends elsewhere
    _, alone, _ = _port(ref, 1, name="bn")
    var = [n for n in state if n.endswith(".moving_1")]
    assert var and not np.allclose(alone[var[0]], state[var[0]], atol=1e-6)


def test_rank1_fetch_concatenates_and_scalar_fetch_averages():
    import paddle_tpu as jfluid

    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [None, 4])
            rows = pkg.layers.reduce_sum(x, dim=1)
            total = pkg.layers.mean(x)
        return main, rows.name, total.name

    xb = np.arange(32, dtype=np.float32).reshape(8, 4)
    jmain, rows, total = build(jfluid)
    want = jfluid.Executor().run(
        jfluid.CompiledProgram(jmain).with_data_parallel(places=4),
        feed={"x": xb}, fetch_list=[rows, total])
    main = fluid.Program.from_json(jmain.to_json())
    got = fluid.Executor(fluid.CPUPlace()).run(
        fluid.CompiledProgram(main).with_data_parallel(places=4),
        feed={"x": xb}, fetch_list=[rows, total], scope=fluid.Scope())
    np.testing.assert_allclose(got[0], xb.sum(1), rtol=1e-6)
    for g, w in zip(got, want):
        assert np.shape(g) == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6)


def test_indivisible_feed_raises_divisible(refs):
    ref = refs[("mlp", 8)]
    main = fluid.Program.from_json(ref["main"])
    scope = interop.scope_from_numpy(ref["start"], fluid.Scope(), "cpu")
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=ref["loss"], places=8)
    feed = _feeds("mlp", steps=1, batch=12)[0]
    with pytest.raises(ValueError, match="divisible"):
        fluid.Executor(fluid.CPUPlace()).run(prog, feed=feed,
                                             fetch_list=[ref["loss"]],
                                             scope=scope)


@pytest.mark.parametrize("places", [False, None, [fluid.CPUPlace()]])
def test_one_rank_and_no_dp_equal_a_plain_run_bitwise(refs, places):
    """CompiledProgram without with_data_parallel, and with one rank (no
    process group, or one listed place), runs as the raw Program does."""
    ref = refs[("mlp", 2)]
    plain, plain_state, _ = _port(ref, None, compiled=False)
    losses, state, _ = _port(ref, places)
    assert all(np.array_equal(a, b) for a, b in zip(losses, plain))
    assert all(np.array_equal(state[n], plain_state[n]) for n in plain_state)


ENTRIES = [("a", 100, 4, "float32"), ("b", 50, 4, "float32"),
           ("c", 7, 2, "bfloat16"), ("d", 0, 4, "float32"),
           ("e", 64, 4, "float32"), ("f", 300, 2, "bfloat16")]


@pytest.mark.parametrize("bucket_bytes", [0, 1, 256, 512, 1 << 20])
def test_plan_buckets_equals_the_reference(bucket_bytes):
    from paddle_tpu.transpiler import collective as jcoll

    assert tcoll.plan_buckets(ENTRIES, max(bucket_bytes, 1)) == \
        jcoll.plan_buckets(ENTRIES, max(bucket_bytes, 1))
    assert tcoll.implied_collective_plan(ENTRIES, bucket_bytes=bucket_bytes) \
        == jcoll.implied_collective_plan(ENTRIES, bucket_bytes=bucket_bytes)


@pytest.mark.parametrize("bucket_bytes", [0, 256])
def test_sync_stats_equal_the_reference(refs, bucket_bytes):
    want = _reference("mlp", 2, bucket_bytes=bucket_bytes)["stats"]
    _, _, got = _port(refs[("mlp", 2)], 2, bucket_bytes=bucket_bytes)
    assert got == want
    assert got["mode"] == ("bucketed" if bucket_bytes else "per_grad")


def test_bucketed_sync_equals_per_gradient_sync_bitwise(refs):
    """Per-gradient (0), tiny buckets (a gradient spanning several) and
    one big bucket give the same state bit for bit."""
    ref = refs[("mlp", 8)]
    runs = {b: _port(ref, 8, bucket_bytes=b) for b in (0, 256, 4 << 20)}
    assert runs[0][2]["psums"] == runs[0][2]["grads"] == 4
    tiny = runs[256][2]
    assert tiny["psums"] == -(-tiny["total_bytes"] // 256) > 4
    assert runs[4 << 20][2]["psums"] == 1
    base = runs[0][1]
    for b in (256, 4 << 20):
        assert all(np.array_equal(runs[b][0][i], runs[0][0][i])
                   for i in range(STEPS))
        for n in base:
            assert np.array_equal(runs[b][1][n], base[n]), (b, n)


def test_sync_gradients_falls_back_for_sparse_and_nested_grads():
    from paddle_tpu_torch.distributed import inprocess

    meshes = inprocess.local_meshes(dp=2, device="cpu")

    def rank(r, mesh):
        x = torch.full((4, 2), float(r + 1))
        grads = {"dense_w": x * 2.0, "dense_b": x.sum(0),
                 "table": torch.eye(3).to_sparse(),
                 "tree": (x, x * 3.0)}
        return tcoll.sync_gradients(grads, "dp", bucket_bytes=1024,
                                    mesh=mesh), tcoll.last_sync_stats()

    (out, stats), _ = inprocess.run_ranks(meshes, rank)
    torch.testing.assert_close(out["dense_w"], torch.full((4, 2), 3.0))
    torch.testing.assert_close(out["tree"][1], torch.full((4, 2), 4.5))
    assert out["table"].is_sparse
    assert (stats["mode"], stats["fallbacks"], stats["psums"]) == \
        ("bucketed", 2, 3)


def test_parallel_executor_runs_the_compiled_program(refs):
    ref = refs[("mlp", 2)]
    main = fluid.Program.from_json(ref["main"])
    scope = interop.scope_from_numpy(ref["start"], fluid.Scope(), "cpu")
    pe = fluid.ParallelExecutor(use_cuda=False, loss_name=ref["loss"],
                                main_program=main, scope=scope, places=2)
    losses = [pe.run([ref["loss"]], feed_dict=f)[0] for f in _feeds("mlp")]
    np.testing.assert_allclose(np.asarray(losses), np.asarray(ref["losses"]),
                               atol=TOL, rtol=TOL)
    _hold(interop.scope_to_numpy(scope), ref["state"])


def test_gloo_processes_match_the_in_process_ranks(refs, tmp_path):
    from test_torch_moe import run_workers

    ref = refs[("mlp", 2)]
    (tmp_path / "ref.pkl").write_bytes(pickle.dumps(
        {k: ref[k] for k in ("main", "loss", "start")}))
    ranks = run_workers(__file__, 2, tmp_path,
                        args=(str(tmp_path / "ref.pkl"),))
    losses, state, stats = _port(ref, 2)
    for res in ranks:
        assert res["stats"] == stats
        assert all(np.array_equal(a, b) for a, b in zip(res["losses"],
                                                        losses))
        for n in state:
            np.testing.assert_allclose(res["state"][n], state[n],
                                       atol=1e-7, rtol=1e-7, err_msg=n)
        np.testing.assert_allclose(np.asarray(res["losses"]),
                                   np.asarray(ref["losses"]), atol=TOL,
                                   rtol=TOL)



def test_precision_retarget_and_the_rest_of_the_compiled_api(refs):
    from paddle_tpu_torch.framework import compiler as tcompiler

    ref = refs[("mlp", 2)]
    main = fluid.Program.from_json(ref["main"])
    prog = fluid.CompiledProgram(main)
    with pytest.raises(ValueError, match="with_data_parallel first"):
        prog.retarget_dp(2)
    assert tcompiler.resolve_precision(prog) is None
    fluid.set_flags({"FLAGS_conv_matmul_precision": "tensorfloat32"})
    try:
        assert tcompiler.resolve_precision(prog) == "tensorfloat32"
        assert tcompiler.resolve_precision(
            prog.with_precision("float32")) == "float32"
    finally:
        fluid.set_flags({"FLAGS_conv_matmul_precision": ""})
    seen = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    tcompiler.apply_precision_policy(
        lambda: seen.append(torch.backends.cuda.matmul.allow_tf32),
        "tensorfloat32")()
    tcompiler.apply_precision_policy(
        lambda: seen.append(torch.backends.cudnn.allow_tf32), "highest")()
    assert seen == [True, False]
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    with pytest.raises(ValueError, match="unknown precision"):
        tcompiler.apply_precision_policy(lambda: None, "half")
    assert prog.with_telemetry("mlp")._telemetry_label == "mlp"
    # a run at W = 2, then the same program retargeted to W = 4: the state
    # carries over and the fetch widens to the new ranks
    scope = interop.scope_from_numpy(ref["start"], fluid.Scope(), "cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    prog.with_data_parallel(loss_name=ref["loss"], places=2)
    feeds = _feeds("mlp")
    first = exe.run(prog, feed=feeds[0], fetch_list=[ref["loss"]],
                    scope=scope)[0]
    np.testing.assert_allclose(first, ref["losses"][0], atol=TOL, rtol=TOL)
    prog.retarget_dp(4)
    x = exe.run(prog, feed=feeds[1], fetch_list=["x"], scope=scope)[0]
    assert x.shape == (BATCH, 24) and np.array_equal(x, feeds[1]["x"])

@pytest.mark.cuda
def test_dp_on_the_card_matches_the_cpu():
    """Two in-process ranks on the card (the static GPT at D 128, whose
    LayerNorms take K4/K5) against two on the CPU, 3 Adam steps, f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4, K5)")
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import static_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    m = static_zoo.build_gpt(t=128, d=128, heads=4, vocab=256)
    cpu = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    cpu.run(m.startup, scope=scope)
    start = interop.scope_to_numpy(scope)
    runs = {}
    for dev in ("cuda", "cpu"):
        exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
        sc = interop.scope_from_numpy(start, fluid.Scope(), dev)
        prog = fluid.CompiledProgram(m.main).with_data_parallel(
            loss_name=m.loss_name, places=2)
        backend.reset_launches()
        losses = [float(np.mean(exe.run(prog, feed=m.smoke_feed(4, seed=i),
                                        fetch_list=[m.loss_name],
                                        scope=sc)[0])) for i in range(3)]
        runs[dev] = (losses, interop.scope_to_numpy(sc),
                     dict(backend.LAUNCHES))
    assert runs["cuda"][2] == {"layer_norm_fwd": 12, "layer_norm_bwd": 12}
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-4,
                               rtol=1e-4)
    for n, w in runs["cpu"][1].items():
        np.testing.assert_allclose(runs["cuda"][1][n], w,
                                   atol=2 * 1e-3 * 3 + 1e-5, rtol=1e-4,
                                   err_msg=n)

def _worker_main(ref_file, out_dir):
    from paddle_tpu_torch.distributed.env import (
        destroy_parallel_env, init_parallel_env,
    )

    torch.set_num_threads(1)
    init_parallel_env(device="cpu")
    rank = torch.distributed.get_rank()
    ref = pickle.loads(Path(ref_file).read_bytes())
    main = fluid.Program.from_json(ref["main"])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(ref["start"], fluid.Scope(), "cpu")
    prog = fluid.CompiledProgram(main).with_data_parallel(
        loss_name=ref["loss"])
    half = BATCH // 2
    losses = [exe.run(prog, feed={n: a[rank * half:(rank + 1) * half]
                                  for n, a in f.items()},
                      fetch_list=[ref["loss"]], scope=scope)[0]
              for f in _feeds("mlp")]
    out = {"losses": losses, "state": interop.scope_to_numpy(scope),
           "stats": tcoll.last_sync_stats(),
           "jax_imported": "jax" in sys.modules}
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    destroy_parallel_env()


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
