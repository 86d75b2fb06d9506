"""The port's Executor.train_from_dataset / infer_from_dataset against
the JAX package's.

The cases of the reference's tests/test_train_from_dataset.py run through
both executors from the reference's startup state (weights cross through
numpy, `interop.scope_from_numpy`), with the train tier off in both
(FLAGS_amp and FLAGS_graph_opt_fuse "off": their "train" defaults AMP the
program in the loop, whose bf16 products the CPUs of the two frameworks
round differently): the dense loop over MultiSlot files, the Downpour
pull -> step -> push loop over in-process sparse tables, and the same
loop through a synchronous `Communicator`; losses, parameters and table
rows agree within f32 atol = rtol = 1e-5.  Also: the data generator's
files feed the loop (tests/test_data_generator.py), prefetch on and off
give bitwise equal results in the port, the print_period lines and the
returned fetches are the reference's, the loop under the default flags
runs the AMP + fused substitute, `infer_from_dataset` pulls without
pushing, and `elastic=` raises naming ROADMAP item 10.
"""

import contextlib
import os
import re

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.datasets.multislot import QueueDataset as JQueue
from paddle_tpu.distributed import ps as jps

import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.datasets.multislot import QueueDataset as TQueue
from paddle_tpu_torch.distributed import ps as tps
from torch_threads import torch_threads  # noqa: F401

TOL = 1e-5


@contextlib.contextmanager
def _tier_off():
    names = {"FLAGS_amp": "off", "FLAGS_graph_opt_fuse": "off"}
    old = [pkg.get_flags(list(names)) for pkg in (jfluid, fluid)]
    for pkg in (jfluid, fluid):
        pkg.set_flags(names)
    try:
        yield
    finally:
        for pkg, o in zip((jfluid, fluid), old):
            pkg.set_flags(o)


def _write_files(tmp, n_files=2, lines=48, seed=0):
    """MultiSlot text (tests/test_train_from_dataset.py's): per line
    slot ids (2), label (1), feat (3)."""
    rng = np.random.default_rng(seed)
    files = []
    for i in range(n_files):
        path = os.path.join(tmp, f"part-{i}")
        with open(path, "w") as f:
            for _ in range(lines):
                ids = rng.integers(0, 20, 2)
                feat = rng.normal(size=3)
                f.write(f"2 {ids[0]} {ids[1]} 1 {int(ids.sum() % 2)} "
                        f"3 {feat[0]:.4f} {feat[1]:.4f} {feat[2]:.4f}\n")
        files.append(path)
    return files


def _queue(cls, files, batch=16):
    ds = cls()
    ds.set_filelist(files)
    ds.set_batch_size(batch)
    ds.set_thread(1)           # one reader thread: the files' order
    ds.set_use_var([("ids", "int64", 2), ("label", "float", 1),
                    ("feat", "float", 3)])
    return ds


def _dense(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        feat = pkg.data("feat", [None, 3])
        label = pkg.data("label", [None, 1])
        h = pkg.layers.fc(feat, 8, act="relu")
        logit = pkg.layers.fc(h, 1)
        loss = pkg.layers.mean(
            pkg.layers.sigmoid_cross_entropy_with_logits(logit, label))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss.name


def _start(jstart):
    jexe, jscope = jfluid.Executor(), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    state = {n: np.asarray(v) for n, v in jscope.vars.items()}
    return jexe, jscope, state


def _params_close(main, tscope, jscope):
    for p in main.all_parameters():
        np.testing.assert_allclose(tscope.find_var(p.name).numpy(),
                                   np.asarray(jscope.find_var(p.name)),
                                   rtol=TOL, atol=TOL, err_msg=p.name)


def test_dense_loop_matches_the_reference(tmp_path, capsys):
    files = _write_files(str(tmp_path))
    jm, js, loss = _dense(jfluid)
    tm, ts, _ = _dense(fluid)
    assert tm.to_json() == jm.to_json()
    jexe, jscope, state = _start(js)
    texe = fluid.Executor(fluid.CPUPlace())
    tscope = interop.scope_from_numpy(state, fluid.Scope(), "cpu")
    with _tier_off():
        capsys.readouterr()
        want = jexe.train_from_dataset(jm, _queue(JQueue, files),
                                       scope=jscope, fetch_list=[loss],
                                       print_period=2)
        jprint = capsys.readouterr().out
        got = texe.train_from_dataset(tm, _queue(TQueue, files),
                                      scope=tscope, fetch_list=[loss],
                                      print_period=2)
        tprint = capsys.readouterr().out
    # the returned fetches: the last batch's, as numpy
    assert isinstance(got, list) and len(got) == len(want) == 1
    assert isinstance(got[0], np.ndarray)
    assert got[0].shape == np.asarray(want[0]).shape
    np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
    _params_close(tm, tscope, jscope)
    # the print_period lines: the same steps and names, values within TOL
    line = re.compile(r"\[train_from_dataset\] step (\d+): (\S+)=(\S+)")
    jl, tl = line.findall(jprint), line.findall(tprint)
    assert [(s, n) for s, n, _ in tl] == [(s, n) for s, n, _ in jl]
    assert [s for s, _, _ in tl] == ["2", "4", "6"]
    np.testing.assert_allclose([float(v) for _, _, v in tl],
                               [float(v) for _, _, v in jl], atol=2e-6)


def _ctr(pkg, dim=8):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        emb = pkg.data("emb", [None, 2, dim])      # the pulled rows
        label = pkg.data("label", [None, 1])
        flat = pkg.layers.reshape(emb, [-1, 2 * dim])
        logit = pkg.layers.fc(flat, 1)
        loss = pkg.layers.mean(
            pkg.layers.sigmoid_cross_entropy_with_logits(logit, label))
        params = [p.name for p in main.all_parameters()]
        pkg.backward.append_backward(loss, parameter_list=params
                                     + [emb.name])
        opt = pkg.optimizer.SGD(0.2)
        opt.apply_gradients([(main.global_block().var(p),
                              main.global_block().var(p + "@GRAD"))
                             for p in params])
    return main, startup, loss.name


def _ids(table):
    ids = np.arange(20)
    rows = table.pull(ids)
    return rows.numpy() if isinstance(rows, torch.Tensor) else \
        np.asarray(rows)


@pytest.mark.parametrize("comm", [None, "sync"])
def test_downpour_loop_matches_the_reference(tmp_path, comm):
    """Pull -> step -> push over a sparse table of the reference's seeds,
    3 epochs (with `comm`: through a synchronous Communicator)."""
    files = _write_files(str(tmp_path))
    jm, js, loss = _ctr(jfluid)
    tm, ts, _ = _ctr(fluid)
    assert tm.to_json() == jm.to_json()
    jexe, jscope, state = _start(js)
    texe = fluid.Executor(fluid.CPUPlace())
    tscope = interop.scope_from_numpy(state, fluid.Scope(), "cpu")
    tables = {}
    for name, mod, kw in (("ref", jps, {}), ("port", tps,
                                           {"device": "cpu"})):
        t = mod.SparseEmbedding(dim=8, num_shards=2, optimizer="adagrad",
                                lr=0.2, seed=0, **kw)
        tables[name] = (t, mod.Communicator(t, mode=comm) if comm else t)
    losses = {"ref": [], "port": []}
    with _tier_off():
        for _ in range(3):
            for name, exe, prog, scope, q in (
                    ("ref", jexe, jm, jscope, JQueue),
                    ("port", texe, tm, tscope, TQueue)):
                out = exe.train_from_dataset(
                    prog, _queue(q, files), scope=scope, fetch_list=[loss],
                    sparse_config={"table": tables[name][1],
                                   "ids_var": "ids", "emb_var": "emb"})
                losses[name].append(float(np.asarray(out[0]).reshape(-1)[0]))
    if comm:
        for name in tables:
            tables[name][1].barrier()
            tables[name][1].stop()
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(_ids(tables["port"][0]),
                               _ids(tables["ref"][0]), rtol=TOL, atol=TOL)
    _params_close(tm, tscope, jscope)
    assert len(tables["port"][0]) == len(tables["ref"][0]) > 0


def test_downpour_through_an_async_communicator_runs(tmp_path):
    files = _write_files(str(tmp_path))
    tm, ts, loss = _ctr(fluid, dim=4)
    table = tps.SparseEmbedding(dim=4, num_shards=2, lr=0.2, seed=0,
                                device="cpu")
    comm = tps.Communicator(table, mode="half_async")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(ts, scope=scope)
    out = exe.train_from_dataset(
        tm, _queue(TQueue, files), scope=scope, fetch_list=[loss],
        sparse_config={"table": comm, "ids_var": "ids", "emb_var": "emb"})
    comm.barrier()
    comm.stop()
    assert np.isfinite(out[0]).all() and len(table) > 0


def _generator_files(pkg, tmp):
    dg = pkg.incubate.data_generator

    class CTR(dg.MultiSlotDataGenerator):
        def __init__(self, seed):
            super().__init__()
            self._rng = np.random.default_rng(seed)

        def generate_sample(self, line):
            def it():
                for _ in range(64):
                    ids = self._rng.integers(0, 20, 2)
                    yield [("ids", [int(i) for i in ids]),
                           ("label", [float(int(ids.sum()) % 2)])]
            return it

    files = []
    for i in range(2):
        path = os.path.join(tmp, f"{pkg.__name__}-part-{i}")
        with open(path, "w") as f:
            CTR(seed=i).run_from_memory(out=f)
        files.append(path)
    return files


def _onehot(pkg):
    main, startup = pkg.Program(), pkg.Program()
    L = pkg.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data("ids", [None, 2], dtype="int64")
        label = pkg.data("label", [None, 1])
        oh = L.cast(L.one_hot(L.reshape(ids, [-1, 2, 1]), 20), "float32")
        logit = L.fc(L.reshape(oh, [-1, 40]), 1)
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        pkg.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss.name


def test_generator_files_feed_the_loop(tmp_path):
    """tests/test_data_generator.py::test_generator_files_feed_train_from_
    dataset through both packages: the port's generator writes the
    files, each package's QueueDataset reads them, 4 epochs."""
    jfiles = _generator_files(jfluid, str(tmp_path))
    tfiles = _generator_files(fluid, str(tmp_path))
    for a, b in zip(jfiles, tfiles):
        assert open(a).read() == open(b).read()
    jm, js, loss = _onehot(jfluid)
    tm, _, _ = _onehot(fluid)
    jexe, jscope, state = _start(js)
    texe = fluid.Executor(fluid.CPUPlace())
    tscope = interop.scope_from_numpy(state, fluid.Scope(), "cpu")
    use = [("ids", "int64", 2), ("label", "float", 1)]
    got, want = [], []
    with _tier_off():
        for _ in range(4):
            for exe, prog, scope, q, files, out in (
                    (jexe, jm, jscope, JQueue, jfiles, want),
                    (texe, tm, tscope, TQueue, tfiles, got)):
                ds = q()
                ds.set_filelist(files)
                ds.set_batch_size(16)
                ds.set_thread(1)
                ds.set_use_var(use)
                r = exe.train_from_dataset(prog, ds, scope=scope,
                                           fetch_list=[loss],
                                           print_period=10 ** 6)
                out.append(float(np.asarray(r[0]).reshape(-1)[0]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=TOL)
    assert got[-1] < got[0], got


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"feat": rng.normal(size=(8, 3)).astype(np.float32),
             "label": (rng.random((8, 1)) > 0.5).astype(np.float32),
             "unused": np.zeros(2)} for _ in range(n)]


def test_prefetch_on_and_off_are_bitwise_equal():
    tm, ts, loss = _dense(fluid)
    results = []
    for prefetch in (True, False):
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(ts, scope=scope)
        out = exe.train_from_dataset(tm, _batches(9), scope=scope,
                                     fetch_list=[loss], print_period=4,
                                     prefetch=prefetch)
        results.append((out[0], {p.name: scope.find_var(p.name).clone()
                                 for p in tm.all_parameters()}))
    assert np.array_equal(results[0][0], results[1][0])
    for n, v in results[0][1].items():
        assert torch.equal(v, results[1][1][n]), n


def test_default_flags_run_the_train_tier_substitute():
    """FLAGS_amp / FLAGS_graph_opt_fuse at "train": the loop runs the AMP
    + fused clone (cached on the program), a bare run does not."""
    tm, ts, loss = _dense(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(ts, scope=scope)
    assert fluid.get_flags(["FLAGS_amp"])["FLAGS_amp"] == "train"
    exe.run(tm, feed=_batches(1)[0], fetch_list=[loss], scope=scope)
    assert not getattr(tm, "_opt_cache", None)
    out = exe.train_from_dataset(tm, _batches(3), scope=scope,
                                 fetch_list=[loss], print_period=10 ** 6)
    assert np.isfinite(out[0]).all()
    (sub,) = tm._opt_cache.values()
    assert sub._train_tier["amp"] == "bfloat16"
    assert "cast" in [op.type for op in sub.global_block().ops]
    assert exe.train_from_dataset(tm, _batches(2), scope=scope) is None


def test_infer_from_dataset_pulls_without_pushing(tmp_path):
    files = _write_files(str(tmp_path))
    tm, ts, loss = _ctr(fluid)
    test = tm.clone(for_test=True)
    table = tps.SparseEmbedding(dim=8, num_shards=2, lr=0.2, seed=0,
                                device="cpu")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(ts, scope=scope)
    before = _ids(table)
    w = {p.name: scope.find_var(p.name).clone()
         for p in tm.all_parameters()}
    # the dense drain: no parameter moves
    out = exe.infer_from_dataset(
        test, [{"ids": np.array([[1, 2]] * 4, np.int64),
                "label": np.ones((4, 1), np.float32),
                "emb": np.zeros((4, 2, 8), np.float32)}], scope=scope,
        fetch_list=[loss])
    assert np.isfinite(out[0]).all()
    for n, v in w.items():
        assert torch.equal(scope.find_var(n), v), n
    # through a table (the config a transpiler attaches): rows are
    # pulled, nothing is pushed
    test._ps_sparse_config = [{"table": table, "ids_var": "ids",
                               "emb_var": "emb"}]
    out = exe.infer_from_dataset(test, _queue(TQueue, files), scope=scope,
                                 fetch_list=[loss])
    assert np.isfinite(out[0]).all()
    np.testing.assert_array_equal(_ids(table), before)


def test_elastic_and_the_unported_records_raise_naming_item_10():
    tm, ts, loss = _dense(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        exe.train_from_dataset(tm, _batches(1), elastic=object())
    fluid.set_flags({"FLAGS_goodput": True})
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
            exe.train_from_dataset(tm, _batches(1))
    finally:
        fluid.set_flags({"FLAGS_goodput": False})
    with pytest.raises(ValueError, match="needs a dataset"):
        exe.train_from_dataset(tm, None)


def test_the_loops_flags_default_to_the_references():
    """The flags the control-flow slice reads, declared with the
    reference's names, defaults and types."""
    from paddle_tpu import flags as jflags

    from paddle_tpu_torch import flags as tflags

    for name in ("eager_executor", "executor_log_ops", "goodput",
                 "fleet_skew", "amp", "graph_opt_fuse", "global_seed"):
        t, j = tflags._REGISTRY[name], jflags._REGISTRY[name]
        assert (t.default, t.type) == (j.default, j.type), name


def test_executor_log_ops_prints_each_op(capsys):
    tm, ts, loss = _dense(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(ts, scope=scope)
    fluid.set_flags({"FLAGS_executor_log_ops": True})
    try:
        exe.run(tm.clone(for_test=True), feed=_batches(1)[0],
                fetch_list=[loss], scope=scope)
    finally:
        fluid.set_flags({"FLAGS_executor_log_ops": False})
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[paddle_tpu_torch.executor]")]
    assert lines and lines[0].split()[1] == "mul"
