"""The port's GSPMD runtime tier (`CompiledProgram.with_sharding_rules(...,
execute=True)`, `framework/spmd.py`) against the JAX package's runs.

The reference's own {dp=2, mp=2} executor run does not execute on this
host's JAX (its `shard_map` takes no `auto` axes), so the port's tier is
held three ways, as the reference's `bench.py tp_runtime_smoke` holds its
own: zoo bert and a 1-layer narrow GPT, under their default Megatron
rules as {dp=2, mp=2} ranks held in this process, take 3 SGD and 3 Adam
steps and

- agree with the reference's dp-only `with_data_parallel` W = 2 run of
  the same Program (crossed by `to_json`), weights (its startup values,
  `interop`) and feeds within rtol 2e-3, atol 2e-5 (losses and final
  params), and with the port's own dp W = 2 run within 1e-5;
- hold only their shards: each rank's blocks and Adam moments have the
  plan's shapes, and a rank's resident state bytes are the plan's
  per-shard figure;
- execute exactly the model collectives the plan prices
  (`last_sync_stats()["model"]` against `collective_table()`; bert: 3
  all-reduces over mp, 24576 bytes);
- compute every sharded param's grad equal to the unsharded step's,
  block by block.

Also: `mesh_key` / `mesh_layout` caching, explicit device lists,
`FLAGS_static_check=error` raising before any op, one launch of two gloo
worker processes running {dp=1, mp=2} (`python
tests/test_torch_spmd_runtime.py <program> <out dir>`, no jax in the
workers) against the in-process ranks, and the TP checkpoint restoring
bitwise onto a {dp=4} run.  The `cuda`-marked twins run the tier on the
card against the CPU and skip here.
"""

import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.analysis import sharding as tsh
from paddle_tpu_torch.framework.spmd import ShardedValue
from paddle_tpu_torch.transpiler import collective as tcoll
from torch_threads import torch_threads  # noqa: F401

RTOL, ATOL = 2e-3, 2e-5     # against the reference (bench.py's yardstick)
OWN = 1e-5                  # against the port's own dp run
STEPS = 3
BATCH = 8
T, D, HEADS, VOCAB = 16, 32, 4, 128


def _family(pkg, family, opt):
    """Zoo bert, or the 1-layer narrow GPT, with the optimizer `opt`
    ("sgd" | "adam"); the zoo's own layers, so the names (fc_0, ...) are
    the ones its default rules name."""
    import importlib

    zoo = importlib.import_module(pkg.__name__ + ".models.static_zoo")
    L = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data("ids", [None, T], dtype="int64")
        if family == "bert":
            label = pkg.data("label", [None, 1], dtype="int64")
            tok = L.embedding(ids, size=(VOCAB, D))
            x = zoo._transformer_layer(L.layer_norm(tok, begin_norm_axis=2),
                                       D, HEADS, T)
            pooled = L.reshape(L.reduce_mean(x, dim=[1]), shape=[-1, D])
            loss = L.mean(L.softmax_with_cross_entropy(L.fc(pooled, 2),
                                                       label))
        else:
            targets = pkg.data("targets", [None, T, 1], dtype="int64")
            x = zoo._transformer_layer(L.embedding(ids, size=(VOCAB, D)), D,
                                       HEADS, T)
            loss = L.mean(L.softmax_with_cross_entropy(
                L.fc(x, VOCAB, num_flatten_dims=2), targets))
        (pkg.optimizer.SGD(0.1) if opt == "sgd"
         else pkg.optimizer.Adam(1e-3)).minimize(loss)
    return main, startup, loss.name


def _feeds(family, steps=STEPS, batch=BATCH):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(steps):
        f = {"ids": rng.integers(0, VOCAB, (batch, T)).astype(np.int64)}
        if family == "bert":
            f["label"] = rng.integers(0, 2, (batch, 1)).astype(np.int64)
        else:
            f["targets"] = rng.integers(0, VOCAB, (batch, T, 1)).astype(
                np.int64)
        out.append(f)
    return out


CASES = [(f, o) for f in ("bert", "gpt") for o in ("sgd", "adam")]


def _reference(family, opt):
    """The JAX package's dp-only W = 2 run from its startup values."""
    import paddle_tpu as jfluid

    main, startup, loss = _family(jfluid, family, opt)
    exe = jfluid.Executor()
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    start = {n: np.asarray(v) for n, v in scope.vars.items()}
    prog = jfluid.CompiledProgram(main).with_data_parallel(loss_name=loss,
                                                           places=2)
    losses = [float(np.mean(exe.run(prog, feed=f, fetch_list=[loss],
                                    scope=scope)[0]))
              for f in _feeds(family)]
    return dict(main=main.to_json(), loss=loss, start=start, losses=losses,
                state={n: np.asarray(v) for n, v in scope.vars.items()})


@pytest.fixture(scope="module")
def refs():
    return {case: _reference(*case) for case in CASES}


def _rules(family, mesh=None):
    from paddle_tpu_torch.models import static_zoo

    doc = dict(static_zoo.DEFAULT_SHARDING_RULES[family])
    if mesh is not None:
        doc["mesh"] = mesh
    return tsh.PartitionRules.from_dict(doc)


def _run(ref, how, fetch=(), family=None, steps=STEPS):
    """The port's run of the reference Program from its startup values:
    (losses, scope, last fetches, sync stats).  `how`: "plain", an int W
    (dp over W in-process ranks) or a rule mesh {axis: size}."""
    main = fluid.Program.from_json(ref["main"])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(ref["start"], fluid.Scope(), "cpu")
    if how == "plain":
        prog = main
    elif isinstance(how, int):
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=ref["loss"], places=how)
    else:
        prog = fluid.CompiledProgram(main).with_sharding_rules(
            _rules(family, how), execute=True)
    losses, got = [], None
    for f in _feeds(family)[:steps]:
        got = exe.run(prog, feed=f, fetch_list=[ref["loss"], *fetch],
                      scope=scope)
        losses.append(float(np.mean(got[0])))
    return losses, scope, got[1:], tcoll.last_sync_stats()


def _plan(ref, family, mesh=None):
    main = fluid.Program.from_json(ref["main"])
    shapes = {n: a.shape for n, a in _feeds(family)[0].items()}
    return tsh.lower(main, _rules(family, mesh), fetch_names=[ref["loss"]],
                     feed_names=sorted(shapes), feed_shapes=shapes)


TP = {"dp": 2, "mp": 2}


@pytest.fixture(scope="module")
def runs(refs):
    """The port's {dp=2, mp=2} and dp W = 2 runs of every case, made
    once."""
    return {case: {"tp": _run(refs[case], TP, family=case[0]),
                   "dp": _run(refs[case], 2, family=case[0])}
            for case in CASES}


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_tp_steps_match_the_reference_dp_run(refs, runs, case):
    ref = refs[case]
    tp_losses, tp_scope, _, _ = runs[case]["tp"]
    dp_losses, dp_scope, _, _ = runs[case]["dp"]
    np.testing.assert_allclose(tp_losses, ref["losses"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tp_losses, dp_losses, rtol=OWN, atol=OWN)
    got = interop.scope_to_numpy(tp_scope)
    own = interop.scope_to_numpy(dp_scope)
    assert set(got) == set(ref["state"])
    for n, want in ref["state"].items():
        np.testing.assert_allclose(got[n], want, rtol=RTOL, atol=ATOL,
                                   err_msg=n)
        # the key bias's gradient is 0 in exact arithmetic: Adam divides
        # its rounding noise by its own size, so the two runs' sum orders
        # give it different values of size ~1e-5 (held to the
        # reference's tolerance above, and near 0 here)
        own_tol = 2 * ATOL if case[1] == "adam" \
            and n.startswith("fc_1.b_0") else OWN
        np.testing.assert_allclose(got[n], own[n], rtol=OWN, atol=own_tol,
                                   err_msg=n)
    # the sharded params really moved
    assert not np.allclose(got["fc_0.w_0"], ref["start"]["fc_0.w_0"])


@pytest.mark.parametrize("family", ["bert", "gpt"])
def test_each_rank_holds_only_its_shards(refs, runs, family):
    ref = refs[(family, "adam")]
    plan = _plan(ref, family)
    scope = runs[(family, "adam")]["tp"][1]
    resident = {r: 0 for r in range(4)}
    sharded = 0
    for row in plan.per_var_table():
        v = scope.find_var(row["var"])
        assert isinstance(v, ShardedValue), row["var"]
        assert sorted(v.shards) == [0, 1, 2, 3]
        assert v.spec.render() == row["spec"]
        for r, t in v.shards.items():
            assert t.numel() * t.element_size() == row["shard_bytes"], \
                (row["var"], r)
            resident[r] += v.nbytes(r)
        if "mp" in row["partition_spec"]:
            sharded += 1
            assert row["shard_bytes"] * 2 == row["full_bytes"]
    assert sharded == plan.to_record()["sharded_state_vars"] > 0
    for name in ("fc_0.w_0", "fc_3.w_0", "embedding_0.w_0", "fc_4.b_0"):
        w = scope.find_var(name)
        for slot in ("moment1", "moment2"):
            m = scope.find_var(f"{name}_adam_0_{slot}")
            assert m.spec == w.spec
            assert m.shards[1].shape == w.shards[1].shape
    assert tuple(scope.find_var("fc_0.w_0").shards[0].shape) == (D, D // 2)
    assert tuple(scope.find_var("embedding_0.w_0").shards[3].shape) == (
        VOCAB // 2, D)
    # a rank's resident state is the plan's per-shard figure
    assert set(resident.values()) == {plan.memory["state_bytes"]}


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_executed_model_collectives_equal_the_plan(refs, runs, case):
    plan = _plan(refs[case], case[0])
    model = runs[case]["tp"][3]["model"]
    want = plan.collective_table()[("all_reduce", ("mp",))]
    assert model["psums"] == want["count"] == 3
    assert model["total_bytes"] == want["bytes"]
    assert model["axes"] == ["mp"]
    assert [(r["op_index"], r["var"]) for r in model["records"]] \
        == [(r["op_index"], r["var"]) for r in plan.model_sync_records()]
    if case[0] == "bert":
        assert want["bytes"] == 24576
    # the dp grad sync ran beside them, as in the data-parallel tier
    assert runs[case]["tp"][3]["grads"] == len(
        fluid.Program.from_json(refs[case]["main"]).backward_sections[0]
        .param_names)


@pytest.mark.parametrize("family", ["bert", "gpt"])
def test_sharded_grads_equal_the_unsharded_step(refs, family):
    ref = refs[(family, "sgd")]
    plan = _plan(ref, family)
    params = [r["var"] for r in plan.per_var_table()
              if r["class"] == "param"]
    grads = [p + "@GRAD" for p in params]
    _, _, tp, _ = _run(ref, TP, fetch=grads, family=family, steps=1)
    _, _, plain, _ = _run(ref, "plain", fetch=grads, family=family, steps=1)
    coords = [{"dp": (i // 2, 2), "mp": (i % 2, 2)} for i in range(4)]
    for p, g, w in zip(params, tp, plain):
        spec = plan.state_specs[p]
        # a fetch of rank >= 1 comes back concatenated over the 2 dp
        # ranks (the data-parallel tier's merge); after the grad sync
        # both hold the same grad
        assert g.shape == (2 * w.shape[0],) + w.shape[1:], p
        assert np.array_equal(g[:w.shape[0]], g[w.shape[0]:]), p
        g = g[:w.shape[0]]
        for c in coords:
            np.testing.assert_allclose(tsh.local_slice(g, spec, c),
                                       tsh.local_slice(w, spec, c),
                                       rtol=OWN, atol=OWN, err_msg=p)


def test_mp_only_mesh_and_rule_reattachment(refs):
    """{dp=1, mp=2}: no dp sync of the data, the same losses; a changed
    rule set re-lowers instead of serving the old plan."""
    ref = refs[("gpt", "adam")]
    one, _, _, stats = _run(ref, {"dp": 1, "mp": 2}, family="gpt")
    plain, _, _, _ = _run(ref, "plain", family="gpt")
    np.testing.assert_allclose(one, plain, rtol=OWN, atol=OWN)
    assert stats["model"]["psums"] == 3
    main = fluid.Program.from_json(ref["main"])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(ref["start"], fluid.Scope(), "cpu")
    prog = fluid.CompiledProgram(main).with_sharding_rules(
        _rules("gpt", {"dp": 1, "mp": 2}), execute=True)
    f = _feeds("gpt")[0]
    exe.run(prog, feed=f, fetch_list=[ref["loss"]], scope=scope)
    assert scope.find_var("fc_0.w_0").spec.render() == "[-, mp]"
    prog.with_sharding_rules(tsh.PartitionRules([(".*", [])], {"dp": 2}),
                             execute=True)
    exe.run(prog, feed=f, fetch_list=[ref["loss"]], scope=scope)
    assert scope.find_var("fc_0.w_0").spec.is_replicated
    assert tcoll.last_sync_stats()["model"]["psums"] == 0
    with pytest.raises(ValueError, match="'dp' data axis"):
        prog.with_sharding_rules(tsh.PartitionRules(
            [(".*", [])], {"batch": 2}, data_axis="batch"), execute=True)
        exe.run(prog, feed=f, fetch_list=[ref["loss"]], scope=scope)


def test_mesh_key_and_the_shared_layout_cache():
    from paddle_tpu_torch.distributed import inprocess
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.models import static_zoo

    ranks = inprocess.local_meshes(axes={"dp": 2, "mp": 2}, device="cpu")
    lay = tmesh.mesh_layout(ranks)
    assert tmesh.mesh_layout(ranks) is lay
    assert lay.data_rows == 2 and lay.local_rows == 4
    assert len(lay.data_procs) == 2
    assert lay.data_sharding.render() == "[dp]"
    fp = tmesh.mesh_layout(ranks, fingerprint="abc")
    assert fp is not lay and fp.fingerprint == "abc" and fp.key == lay.key
    assert [m.names for m in ranks] == [("dp", "mp")] * 4
    assert ranks[3].coords() == {"dp": (1, 2), "mp": (1, 2)}
    assert ranks[1].model_group[3] == [0, 1]
    assert repr(ranks[2]).startswith("Mesh(dp=2, mp=2, rank=2")
    m = static_zoo.build("bert")
    rules = m.partition_rules()
    cpu4 = ["cpu"] * 4
    prog = fluid.CompiledProgram(m.main).with_sharding_rules(
        rules, execute=True, places=cpu4)
    k1 = prog._spmd_key()
    assert fluid.CompiledProgram(m.main).with_sharding_rules(
        rules, execute=True, places=cpu4)._spmd_key() == k1
    other = tsh.PartitionRules([[r".*", []]], {"dp": 2, "mp": 2})
    k2 = prog.with_sharding_rules(other, execute=True)._spmd_key()
    assert k2 != k1 and k2[0] == k1[0]


def test_explicit_device_lists():
    from paddle_tpu_torch.distributed import inprocess
    from paddle_tpu_torch.distributed import mesh as tmesh

    devs = [torch.device("cpu")] * 4
    ranks = inprocess.local_meshes(axes={"dp": 2, "mp": 2}, devices=devs)
    assert [m.device for m in ranks] == devs
    assert [m.device for m in inprocess.local_meshes(
        dp=2, devices=["cpu", "cpu"])] == devs[:2]
    with pytest.raises(ValueError, match="needs 4 devices"):
        inprocess.local_meshes(axes={"dp": 2, "mp": 2}, devices=devs[:3])
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.build_mesh(dp=2, tp=2, devices=devs[:2])
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.build_rule_mesh({"dp": 1, "mp": 2}, devices=devs[:1])
    prog = fluid.CompiledProgram(fluid.Program()).with_sharding_rules(
        {"mesh": {"dp": 2, "mp": 2}, "rules": [[".*", []]]}, execute=True,
        places=devs)
    mode, meshes = prog._spmd_meshes(torch.device("cpu"))
    assert mode == "threads" and [m.device for m in meshes] == devs


@pytest.fixture
def static_check_flag():
    yield
    fluid.set_flags({"FLAGS_static_check": "off"})


def test_static_check_error_raises_before_any_op(refs, static_check_flag):
    ref = refs[("bert", "adam")]
    main = fluid.Program.from_json(ref["main"])
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(ref["start"], fluid.Scope(), "cpu")
    # a rule set that misses every trainable param but fc_0's: PT301
    prog = fluid.CompiledProgram(main).with_sharding_rules(
        tsh.PartitionRules([(r"fc_0\.w_0$", [None, "mp"])], TP),
        execute=True)
    fluid.set_flags({"FLAGS_static_check": "error"})
    with pytest.raises(fluid.analysis.ProgramLintError, match="PT301"):
        exe.run(prog, feed=_feeds("bert")[0], fetch_list=[ref["loss"]],
                scope=scope)
    # nothing ran: the state is the startup's, unsharded
    for n, a in ref["start"].items():
        assert isinstance(scope.find_var(n), torch.Tensor)
        assert np.array_equal(scope.find_var(n).numpy(), a)
    # the default rules lint clean, and the step runs
    prog.with_sharding_rules(_rules("bert"), execute=True)
    exe.run(prog, feed=_feeds("bert")[0], fetch_list=[ref["loss"]],
            scope=scope)


def test_tp_checkpoint_restores_bitwise_onto_dp4(refs, runs, tmp_path):
    from paddle_tpu_torch import checkpoint

    ref = refs[("bert", "adam")]
    scope = runs[("bert", "adam")]["tp"][1]
    state = dict(scope.vars)
    checkpoint.save_checkpoint(str(tmp_path), state, STEPS)
    assert checkpoint.load_topology(str(tmp_path))["mesh"] == TP
    template = interop.scope_from_numpy(ref["start"], fluid.Scope(), "cpu")
    restored, step = checkpoint.restore_resharded(str(tmp_path),
                                                  dict(template.vars))
    assert step == STEPS
    for n, v in state.items():
        assert torch.equal(restored[n], v.full()), n
    # the restored state runs on {dp=4} as the {dp=2, mp=2} run goes on
    dp4 = fluid.Scope()
    dp4.vars.update(restored)
    main = fluid.Program.from_json(ref["main"])
    exe = fluid.Executor(fluid.CPUPlace())
    nxt = _feeds("bert", steps=STEPS + 1)[STEPS]
    a = exe.run(fluid.CompiledProgram(main).with_sharding_rules(
        tsh.PartitionRules([(".*", [])], {"dp": 4}), execute=True),
        feed=nxt, fetch_list=[ref["loss"]], scope=dp4)[0]
    tp = fluid.Scope()
    tp.vars.update(restored)
    b = exe.run(fluid.CompiledProgram(main).with_sharding_rules(
        _rules("bert"), execute=True), feed=nxt, fetch_list=[ref["loss"]],
        scope=tp)[0]
    np.testing.assert_allclose(np.mean(a), np.mean(b), rtol=OWN, atol=OWN)
    # a sharded template comes back whole, where its blocks live
    again, _ = checkpoint.restore_resharded(str(tmp_path), state)
    assert torch.equal(again["fc_0.w_0"], state["fc_0.w_0"].full())


def test_gloo_processes_match_the_in_process_ranks(refs, tmp_path):
    """Two processes on gloo, one rank each, run gpt under {dp=1, mp=2}:
    each holds its own blocks and they equal the in-process rank's."""
    from test_torch_moe import start_workers

    ref = refs[("gpt", "adam")]
    (tmp_path / "ref.pkl").write_bytes(pickle.dumps(
        {k: ref[k] for k in ("main", "loss", "start")}))
    wait = start_workers(__file__, 2, tmp_path,
                         args=(str(tmp_path / "ref.pkl"),))
    losses, scope, _, stats = _run(ref, {"dp": 1, "mp": 2}, family="gpt")
    ranks = wait()
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], losses, rtol=1e-6,
                                   atol=1e-6)
        assert res["model"]["psums"] == stats["model"]["psums"]
        assert res["model"]["total_bytes"] == stats["model"]["total_bytes"]
        for n, block in res["shards"].items():
            np.testing.assert_allclose(
                block, scope.find_var(n).shards[r].numpy(), rtol=1e-6,
                atol=1e-6, err_msg=n)
        assert res["shards"]["fc_0.w_0"].shape == (D, D // 2)


def _card_and_cpu(family, amp, make=None):
    from paddle_tpu_torch.models import static_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    m = make() if make is not None else static_zoo.build(family)
    cpu = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    cpu.run(m.startup, scope=scope)
    start = interop.scope_to_numpy(scope)
    out = {}
    flags = {"FLAGS_amp": "on" if amp else "train",
             "FLAGS_graph_opt_fuse": "on" if amp else "train"}
    fluid.set_flags(flags)
    try:
        for dev in ("cuda", "cpu"):
            exe = fluid.Executor(None if dev == "cuda" else fluid.CPUPlace())
            sc = interop.scope_from_numpy(start, fluid.Scope(), dev)
            prog = fluid.CompiledProgram(m.main).with_sharding_rules(
                m.partition_rules(), execute=True)
            losses = [float(np.mean(exe.run(
                prog, feed=m.smoke_feed(8, seed=i), fetch_list=[m.loss_name],
                scope=sc)[0])) for i in range(3)]
            out[dev] = (losses, interop.scope_to_numpy(sc),
                        tcoll.last_sync_stats()["model"])
    finally:
        fluid.set_flags({"FLAGS_amp": "train",
                         "FLAGS_graph_opt_fuse": "train"})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["bert", "gpt"])
def test_tp_on_the_card_matches_the_cpu(family):
    """{dp=2, mp=2} in-process ranks on the card against the CPU, f32,
    3 Adam steps: losses, params, and the same executed collectives."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K4, K5)")
    out = _card_and_cpu(family, amp=False)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    for n, w in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][n], w, rtol=1e-4,
                                   atol=2 * 1e-3 * 3 + 1e-5, err_msg=n)
    assert out["cuda"][2]["psums"] == out["cpu"][2]["psums"] == 3
    assert out["cuda"][2]["total_bytes"] == out["cpu"][2]["total_bytes"]


@pytest.mark.cuda
def test_tp_amp_fused_on_the_card_runs_the_kernels():
    """The AMP + fused GPT at D 128 (2 heads of 64: inside K1-K3's
    envelope) under {dp=2, mp=2} on the card: each rank's fused attention
    on K1-K3 and its two fused LayerNorms on K4/K5, every step; the
    losses and the executed collectives as the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1-K5)")
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import static_zoo

    backend.reset_launches()
    out = _card_and_cpu("gpt", amp=True, make=lambda: static_zoo.build_gpt(
        t=128, d=128, heads=2, vocab=256))
    ranks, steps = 4, 3
    assert dict(backend.LAUNCHES) == {
        "flash_attention_fwd": ranks * steps,
        "flash_attention_bwd_dq": ranks * steps,
        "flash_attention_bwd_dkv": ranks * steps,
        "layer_norm_fwd": 2 * ranks * steps,
        "layer_norm_bwd": 2 * ranks * steps}
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=3e-2)
    assert out["cuda"][2]["psums"] == out["cpu"][2]["psums"] == 3
    assert out["cuda"][2]["total_bytes"] == out["cpu"][2]["total_bytes"]


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
    prog = fluid.CompiledProgram(main).with_sharding_rules(
        _rules("gpt", {"dp": 1, "mp": 2}), execute=True)
    losses = [float(np.mean(exe.run(prog, feed=f, fetch_list=[ref["loss"]],
                                    scope=scope)[0]))
              for f in _feeds("gpt")]
    shards = {n: v.local(rank).numpy() for n, v in scope.vars.items()
              if isinstance(v, ShardedValue)}
    out = {"losses": losses, "shards": shards,
           "model": tcoll.last_sync_stats()["model"],
           "jax_imported": "jax" in sys.modules}
    Path(out_dir, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    destroy_parallel_env()


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
