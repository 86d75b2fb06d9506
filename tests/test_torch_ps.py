"""The port's parameter-server data plane (distributed/ps.py, the
DistributeTranspiler, federated.py, fleet_util.py, fs.py) against the
JAX package's.

- `SparseEmbedding`: pulls equal the reference's bitwise for the same
  seed and ids, and so do the rows after the same pushes (sgd and
  adagrad, in the native shard both packages build from
  csrc/ps_shard.cpp); pulls are torch tensors on the table's device,
  pushes take torch or numpy grads;
- the wire format byte for byte: the port's frames equal the
  reference's, each package decodes the other's, and the port refuses
  what the reference refuses (object dtypes, pickle frames, truncation,
  trailing bytes, the frame limit);
- a reference `PSServer` answering a port `PSClient` and the reverse,
  `ShardedPSClient` over two servers, `HeartBeatMonitor`;
- the Communicator's sync, async, half_async and geo modes against the
  reference's on the same pushes;
- the transpiler's rewrite of a CTR program equal to the reference's
  (ops, sections, startup, `_ps_sparse_config`);
- FedAvg through `FLServer` / `FLClient` against the reference's
  `_tree_avg`, and a reference client against a port server;
- the Downpour CTR loop on the transpiled program, pull -> step -> push
  by hand over two TCP servers: the losses equal the reference's loop
  and fall.
"""

import pickle
import socket
import struct
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.distributed import federated as tfed
from paddle_tpu_torch.distributed import fleet_util as tfu
from paddle_tpu_torch.distributed import fs as tfs
from paddle_tpu_torch.distributed import ps as tps
from torch_threads import torch_threads  # noqa: F401

CPU = torch.device("cpu")


def _jps():
    from paddle_tpu.distributed import ps

    return ps


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_sparse_embedding_pulls_and_pushes_equal_the_reference(optimizer):
    jps = _jps()
    kw = dict(dim=8, num_shards=3, optimizer=optimizer, lr=0.1, seed=11)
    want = jps.SparseEmbedding(**kw)
    got = tps.SparseEmbedding(device="cpu", **kw)
    rng = np.random.default_rng(0)
    for step in range(3):
        ids = rng.integers(0, 5000, (32, 4))
        rows = got.pull(ids)
        assert isinstance(rows, torch.Tensor) and rows.device == CPU
        assert np.array_equal(rows.numpy(), want.pull(ids))
        g = rng.normal(size=(32, 4, 8)).astype(np.float32)
        want.push(ids, g)
        # torch grads and torch ids on the port side
        got.push(torch.from_numpy(ids), torch.from_numpy(g))
    assert len(got) == len(want)
    st_g, st_w = got.state_dict(), want.state_dict()
    order_g, order_w = np.argsort(st_g["ids"]), np.argsort(st_w["ids"])
    assert np.array_equal(st_g["ids"][order_g], st_w["ids"][order_w])
    assert np.array_equal(st_g["values"][order_g], st_w["values"][order_w])


WIRE_OBJS = [None, True, 0, -7, 1 << 40, 3.5, "héllo", b"\x00\xff",
             [1, 2.0, "x"], (1, (2, 3)),
             {"op": "push", "ids": np.arange(12, dtype=np.int64).reshape(3, 4),
              "grads": np.ones((3, 8), np.float32), "lr": 0.05},
             np.zeros((0, 8), np.float32), np.float32(2.5),
             np.arange(6, dtype=np.float16), np.array([True, False])]


@pytest.mark.parametrize("i", range(len(WIRE_OBJS)))
def test_wire_frames_are_the_references_both_ways(i):
    jps = _jps()
    obj = WIRE_OBJS[i]
    frame = tps.wire_dumps(obj)
    assert frame == jps.wire_dumps(obj)
    a, b = jps.wire_loads(frame), tps.wire_loads(frame)
    assert pickle.dumps(_canon(a)) == pickle.dumps(_canon(b))


def _canon(x):
    if isinstance(x, np.ndarray):
        return ("nd", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_canon(v) for v in x)
    return x


def test_wire_refusals_are_the_references():
    with pytest.raises(TypeError):
        tps.wire_dumps(np.array([object()], dtype=object))
    with pytest.raises(TypeError):
        tps.wire_dumps({1: "non-str key"})
    with pytest.raises(TypeError):
        tps.wire_dumps(lambda: 1)
    with pytest.raises(ValueError, match="magic"):
        tps.wire_loads(pickle.dumps({"op": "pull"}))
    with pytest.raises(ValueError, match="magic"):
        tps.wire_loads(b"PT")
    good = tps.wire_dumps({"op": "pull", "ids": np.arange(4)})
    with pytest.raises(Exception):
        tps.wire_loads(good[:-3])
    with pytest.raises(ValueError, match="trailing"):
        tps.wire_loads(good + b"xx")
    bad_dtype = good.replace(b"int64", b"objec")
    with pytest.raises(ValueError):
        tps.wire_loads(bad_dtype)
    a, b = socket.socketpair()
    try:
        b.sendall(struct.pack("<Q", 1 << 50))
        with pytest.raises(ValueError, match="exceeds"):
            tps._recv_msg(a, max_frame=1 << 20)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("server_pkg", ["reference", "port"])
def test_server_and_client_of_either_package_interoperate(server_pkg):
    jps = _jps()
    srv_mod, cli_mod = (jps, tps) if server_pkg == "reference" else (tps, jps)
    srv = srv_mod.PSServer(dim=4, optimizer="sgd", lr=0.5, seed=2).start()
    try:
        # a pickle frame first: the server drops it and keeps serving
        s = socket.create_connection(("127.0.0.1", srv.port))
        evil = pickle.dumps({"op": "pull"})
        s.sendall(struct.pack("<Q", len(evil)) + evil)
        s.close()
        c = cli_mod.PSClient("127.0.0.1", srv.port, dim=4)
        ids = np.array([5, 9, 5], np.int64)
        local = jps._make_shard(4, optimizer="sgd", lr=0.5, seed=2)
        assert np.array_equal(c.pull(ids), local.pull(ids))
        g = np.arange(12, dtype=np.float32).reshape(3, 4)
        c.push(ids, torch.from_numpy(g) if cli_mod is tps else g)
        local.push(ids, g)
        assert np.array_equal(c.pull(ids), local.pull(ids))
        assert len(c) == 2 and c.row_width == 4
        c.heartbeat("w0")
        c.close()
    finally:
        srv.stop()


def test_sharded_client_over_two_servers_equals_in_process_shards():
    srvs = [tps.PSServer(dim=8, optimizer="adagrad", lr=0.05, seed=s).start()
            for s in (0, 1)]
    try:
        client = tps.ShardedPSClient(
            [f"127.0.0.1:{s.port}" for s in srvs], 8, device="cpu")
        local = [tps._make_shard(8, optimizer="adagrad", lr=0.05, seed=s)
                 for s in (0, 1)]
        ids = np.random.default_rng(1).integers(0, 10 ** 6, (64, 26))
        rows = client.pull(ids)
        flat = ids.reshape(-1)
        want = np.stack([local[i % 2].pull(np.array([i]))[0] for i in flat])
        assert np.array_equal(rows.numpy().reshape(-1, 8), want)
        client.close()
    finally:
        for s in srvs:
            s.stop()


def test_heartbeat_monitor_reports_stale_workers():
    mon = tps.HeartBeatMonitor(timeout=10.0)
    mon.beat("a")
    mon.beat("b")
    now = mon._beats["a"]
    mon._beats["b"] = now - 20.0
    assert mon.dead_workers(now=now + 1.0) == ["b"]
    assert sorted(mon.dead_workers(now=now + 11.0)) == ["a", "b"]


@pytest.mark.parametrize("mode", ["sync", "async", "half_async", "geo"])
def test_communicator_modes_match_the_reference(mode):
    jps = _jps()
    tables = {}
    for pkg in ("reference", "port"):
        mod = jps if pkg == "reference" else tps
        kw = {} if pkg == "reference" else {"device": "cpu"}
        t = mod.SparseEmbedding(dim=4, num_shards=2, optimizer="sgd",
                                lr=1.0, seed=0, **kw)
        comm = mod.Communicator(t, mode=mode, geo_steps=3)
        rng = np.random.default_rng(2)
        for _ in range(7):
            ids = rng.integers(0, 50, 6)
            g = rng.normal(size=(6, 4)).astype(np.float32)
            comm.push(ids, g)
        comm.barrier()
        comm.stop()
        tables[pkg] = t
    ids = np.arange(50)
    got = tables["port"].pull(ids).numpy()
    np.testing.assert_allclose(got, tables["reference"].pull(ids),
                               atol=1e-6, rtol=1e-6)


def _ctr(pkg, fields=4, dense=5, vocab=1000, dim=8):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data("ids", [None, fields], dtype="int64")
        den = pkg.data("dense", [None, dense])
        label = pkg.data("label", [None, 1])
        emb = pkg.layers.embedding(ids, size=(vocab, dim), is_sparse=True)
        deep = pkg.layers.fc(pkg.layers.concat(
            [pkg.layers.reshape(emb, shape=[-1, fields * dim]), den],
            axis=1), 16, act="relu")
        logit = pkg.layers.elementwise_add(pkg.layers.fc(deep, 1),
                                           pkg.layers.fc(den, 1))
        loss = pkg.layers.mean(
            pkg.layers.sigmoid_cross_entropy_with_logits(logit, label))
        pkg.optimizer.Adagrad(0.05).minimize(loss)
    return main, startup, loss.name


def _transpile(pkg, transpiler_mod, pservers=""):
    main, startup, loss = _ctr(pkg)
    cfg = transpiler_mod.DistributeTranspilerConfig()
    cfg.ps_lr = 0.1
    if hasattr(cfg, "device"):
        cfg.device = "cpu"
    t = transpiler_mod.DistributeTranspiler(cfg)
    t.transpile(trainer_id=0, program=main, pservers=pservers,
                startup_program=startup)
    return t, main, startup, loss


def test_transpiler_rewrite_equals_the_references():
    from paddle_tpu import transpiler as jtr
    import paddle_tpu as jfluid

    jt, jmain, jstart, _ = _transpile(jfluid, jtr)
    from paddle_tpu_torch import transpiler as ttr

    tt, tmain, tstart, _ = _transpile(fluid, ttr)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    assert "lookup_table_v2" not in [op.type for op in
                                     tmain.global_block().ops]
    assert [(s.pos, s.param_names, s.loss_name)
            for s in tmain.backward_sections] == \
        [(s.pos, s.param_names, s.loss_name) for s in jmain.backward_sections]
    strip = [{k: v for k, v in e.items() if k != "table"}
             for e in tmain._ps_sparse_config]
    assert strip == [{k: v for k, v in e.items() if k != "table"}
                     for e in jmain._ps_sparse_config]
    assert isinstance(tt.tables[0], tps.SparseEmbedding)
    assert tt.tables[0].device == CPU
    # the transpiled program trains by itself through the dataset loop:
    # its _ps_sparse_config drives pull -> step -> push as the by-hand
    # loop does, over a second transpile's table of the same seeds
    tt2, tmain2, _, loss = _transpile(fluid, ttr)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(tstart, scope=scope)
    start = interop.scope_to_numpy(scope)
    names = ["FLAGS_amp", "FLAGS_graph_opt_fuse"]
    old = fluid.get_flags(names)
    fluid.set_flags({n: "off" for n in names})
    try:
        out = exe.train_from_dataset(tmain, _ctr_batches(6), scope=scope,
                                     fetch_list=[loss],
                                     print_period=10 ** 6)
    finally:
        fluid.set_flags(old)
    hand = _downpour(fluid, exe, interop.scope_from_numpy(
        start, fluid.Scope(), "cpu"), tmain2, loss, tt2.tables[0], 6)
    np.testing.assert_allclose(float(out[0]), hand[-1], rtol=1e-5,
                               atol=1e-5)
    ids = np.arange(200)
    np.testing.assert_allclose(tt.tables[0].pull(ids).numpy(),
                               tt2.tables[0].pull(ids).numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="unknown pserver"):
        tt.get_pserver_program("127.0.0.1:1")


def _ctr_batches(steps, batch=32, fields=4, dense=5, seed=0):
    """A fixed pool of 4 batches whose label is set by the parity of the
    first id and the sign of the dense features' sum."""
    rng = np.random.default_rng(seed)
    pool = []
    for _ in range(4):
        ids = rng.integers(0, 200, (batch, fields))
        den = rng.normal(size=(batch, dense)).astype(np.float32)
        label = ((ids[:, :1] % 2 == 0) ^ (den.sum(1, keepdims=True) > 0))
        pool.append({"ids": ids.astype(np.int64), "dense": den,
                     "label": label.astype(np.float32)})
    return [pool[i % 4] for i in range(steps)]


def _downpour(pkg, exe, scope, main, loss, table, steps):
    """pull -> step -> push by hand: the rows fed as the lookup's output,
    its @GRAD fetched and pushed."""
    e = main._ps_sparse_config[0]
    losses = []
    for b in _ctr_batches(steps):
        rows = table.pull(b["ids"])
        feed = {"dense": b["dense"], "label": b["label"],
                e["emb_var"]: rows}
        out = exe.run(main, feed=feed, fetch_list=[loss, e["emb_var"] +
                                                   "@GRAD"], scope=scope)
        table.push(b["ids"], out[1])
        losses.append(float(np.asarray(out[0])))
    return losses


def test_pserver_handles_dispatchers_and_no_op_passes():
    from paddle_tpu import transpiler as jtr
    from paddle_tpu_torch import transpiler as ttr

    eps = ["127.0.0.1:0", "127.0.0.1:1", "127.0.0.1:2"]
    names = [f"w{i}" for i in range(7)]
    assert ttr.RoundRobin(eps).dispatch(names) == \
        jtr.RoundRobin(eps).dispatch(names)
    rr = ttr.RoundRobin(eps)
    rr.dispatch(names[:2])
    rr.reset()
    assert rr.dispatch(names[:1]) == [eps[0]]
    assert ttr.HashName(eps).dispatch(names) == \
        jtr.HashName(eps).dispatch(names)
    assert ttr.memory_optimize(fluid.Program()) is None
    assert ttr.release_memory(fluid.Program()) is None
    t, main, startup, _ = _transpile(fluid, ttr, pservers="127.0.0.1:0")
    handle, st = t.get_pserver_programs("127.0.0.1:0")
    assert st is startup and handle.port is None
    server = handle.start()
    try:
        assert handle.port == server.port > 0
        c = tps.PSClient("127.0.0.1", handle.port, dim=8)
        assert c.pull(np.array([3])).shape == (1, 8)
        c.close()
    finally:
        handle.stop()
    assert handle.port is None

def test_downpour_ctr_loop_matches_the_reference_and_learns():
    from paddle_tpu import transpiler as jtr
    import paddle_tpu as jfluid
    from paddle_tpu_torch import transpiler as ttr

    steps = 20
    jt, jmain, jstart, loss = _transpile(jfluid, jtr)
    jexe = jfluid.Executor()
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    start = {n: np.asarray(v) for n, v in jscope.vars.items()}
    want = _downpour(jfluid, jexe, jscope, jmain, loss, jt.tables[0], steps)

    srvs = [tps.PSServer(dim=8, optimizer="adagrad", lr=0.1, seed=s).start()
            for s in (0, 1)]
    try:
        eps = ",".join(f"127.0.0.1:{s.port}" for s in srvs)
        tt, tmain, _, _ = _transpile(fluid, ttr, pservers=eps)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = interop.scope_from_numpy(start, fluid.Scope(), "cpu")
        tcp = _downpour(fluid, exe, scope, tmain, loss, tt.tables[0], steps)
        tt.client.close()
    finally:
        for s in srvs:
            s.stop()
    # the same loop on an in-process table of the reference's seeds
    tt2, tmain2, _, _ = _transpile(fluid, ttr)
    scope2 = interop.scope_from_numpy(start, fluid.Scope(), "cpu")
    local = _downpour(fluid, exe, scope2, tmain2, loss, tt2.tables[0], steps)
    np.testing.assert_allclose(local, want, atol=1e-5, rtol=1e-5)
    assert np.mean(tcp[-4:]) < np.mean(tcp[:4]) - 0.05, tcp
    assert np.mean(local[-4:]) < np.mean(local[:4]) - 0.05, local


def test_fedavg_rounds_average_the_clients():
    from paddle_tpu.distributed import federated as jfed

    true_w = np.array([[2.0], [-1.0], [0.5]], np.float32)
    server = tfed.FLServer({"w": torch.zeros(3, 1)}, num_clients=2).start()
    results, pushed = {}, []

    def client_main(cid, seed):
        r = np.random.default_rng(seed)
        x = r.standard_normal((32 + 16 * cid, 3)).astype(np.float32)
        y = x @ true_w
        # one port client, one reference client on the port's server
        mod = tfed if cid == 0 else jfed
        c = mod.FLClient("127.0.0.1", server.port)

        def local_train(params):
            w = torch.from_numpy(np.array(params["w"]))
            for _ in range(10):
                w = w - 0.05 * torch.from_numpy(
                    2 * x.T @ (x @ w.numpy() - y) / len(x))
            pushed.append((cid, {"w": w.numpy()}, len(x)))
            return {"w": w if cid == 0 else w.numpy()}

        for _ in range(3):
            results[cid] = mod.run_fl_round(c, local_train, len(x))
        c.close()

    threads = [threading.Thread(target=client_main, args=(i, 10 + i))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    server.stop()
    (v0, p0), (v1, p1) = results[0], results[1]
    assert v0 == v1 == 3 and np.array_equal(p0["w"], p1["w"])
    last = sorted(pushed[-2:], key=lambda e: e[0])
    want = jfed._tree_avg([(p, n) for _, p, n in last])
    assert np.array_equal(p0["w"], want["w"])
    assert np.array_equal(tfed._tree_avg([(p, n) for _, p, n in last])["w"],
                          want["w"])


def test_fleet_util_and_fs_match_the_reference(tmp_path):
    from paddle_tpu.distributed import fleet_util as jfu
    from paddle_tpu.distributed import fs as jfs
    from paddle_tpu_torch.distributed import inprocess

    rng = np.random.default_rng(0)
    pos = [rng.integers(0, 50, 16) for _ in range(3)]
    neg = [rng.integers(0, 50, 16) for _ in range(3)]
    assert tfu.global_auc([torch.from_numpy(p) for p in pos], neg) == \
        jfu.global_auc(pos, neg)
    assert tfu.global_accuracy([3, 4], [10, 10]) == \
        jfu.global_accuracy([3, 4], [10, 10])
    meshes = inprocess.local_meshes(dp=2, device="cpu")
    out = inprocess.run_ranks(meshes, lambda r, m: tfu.global_metric_over_mesh(
        m, "dp", {"pos": torch.from_numpy(pos[r]).double()}))
    want = pos[0] + pos[1]
    assert all(np.array_equal(o["pos"].numpy(), want) for o in out)
    files = [f"part-{i}" for i in range(7)]
    assert tfs.split_files(files, 1, 3) == jfs.split_files(files, 1, 3)
    lfs = tfs.LocalFS()
    lfs.makedirs(str(tmp_path / "a"))
    (tmp_path / "a" / "x.txt").write_text("hi")
    lfs.upload(str(tmp_path / "b"), str(tmp_path / "a"))
    assert lfs.ls(str(tmp_path / "b")) == ["x.txt"]
    assert lfs.cat(str(tmp_path / "b" / "x.txt")) == "hi"
    with pytest.raises(FileExistsError):
        lfs.rename(str(tmp_path / "a"), str(tmp_path / "b"))


def test_root_shims_and_lookup_table_helpers():
    from paddle_tpu import distribute_lookup_table as jdlt
    import paddle_tpu as jfluid
    from paddle_tpu_torch import communicator, distribute_lookup_table as tdlt

    assert communicator.Communicator is tps.Communicator

    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            ids = pkg.data("ids", [None, 2], dtype="int64")
            pkg.layers.embedding(ids, size=(100, 4), is_distributed=True)
        return main

    jmain, tmain = build(jfluid), build(fluid)
    name = tdlt.find_distributed_lookup_table(tmain)
    assert name == jdlt.find_distributed_lookup_table(jmain)
    assert tdlt.find_distributed_lookup_table_inputs(tmain, name) == \
        jdlt.find_distributed_lookup_table_inputs(jmain, name)
    assert tdlt.find_distributed_lookup_table_outputs(tmain, name) == \
        jdlt.find_distributed_lookup_table_outputs(jmain, name)


@pytest.mark.cuda
def test_pulls_go_to_the_card_and_pushes_take_card_grads():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    t = tps.SparseEmbedding(dim=8, num_shards=2, optimizer="sgd", lr=0.5,
                            seed=1)
    host = tps.SparseEmbedding(dim=8, num_shards=2, optimizer="sgd",
                               lr=0.5, seed=1, device="cpu")
    ids = torch.arange(40, device="cuda").reshape(8, 5)
    rows = t.pull(ids)
    assert rows.device.type == "cuda" and rows.shape == (8, 5, 8)
    g = torch.ones(8, 5, 8, device="cuda")
    t.push(ids, g)
    host.push(ids.cpu(), g.cpu())
    assert torch.equal(t.pull(ids).cpu(), host.pull(ids.cpu()))
