"""The port's static analysis tier (`paddle_tpu_torch.analysis`: the
verifier, the numerics and sharding analyzers, the diagnostics) and its
lint CLI against the JAX package's.

Every case builds one Program with each package's own layers (the two
Programs are asserted byte-identical by `to_json()`, so a Program crossed
by `to_json` is the same Program), runs the same analysis in
both and holds the port's records equal to the reference's, exactly:
`ShardSpec`/`MeshSpec`/`PartitionRules` semantics, rule matching with its
did-you-mean, each propagation family's specs and implied collectives,
the seeded PT301-PT306 and PT401-PT407 programs, `check_program` over
the eight zoo models (plain, and AMP + fused), `estimate_memory`,
`dp_sync_plan` and `lower(...)` for bert and gpt, `cached_check`'s
re-keying, rule attachment, and the CLI's text and `--json` output.
Diagnostics are compared without their `callsite` (it names a frame of
the caller) and lint records without their wall time.
"""

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as jf
import paddle_tpu_torch as tf
from paddle_tpu import amp as jamp
from paddle_tpu import analysis as ja
from paddle_tpu import passes as jpasses
from paddle_tpu.analysis import sharding as jsh
from paddle_tpu.models import static_zoo as jzoo
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import analysis as ta
from paddle_tpu_torch import passes as tpasses
from paddle_tpu_torch.analysis import sharding as tsh
from paddle_tpu_torch.models import static_zoo as tzoo
from torch_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PKGS = {"jax": (jf, jsh, ja, jamp, jpasses), "torch": (tf, tsh, ta, tamp,
                                                      tpasses)}


def _diag(d):
    out = d.to_dict()
    out.pop("callsite", None)
    return out


def _both(build):
    """`build(fluid, main)` -> fetch names, run in each package inside a
    fresh unique_name guard; returns {pkg: (main, fetches)} after holding
    the two Programs equal byte for byte."""
    out = {}
    for key, (fl, *_rest) in PKGS.items():
        with fl.unique_name.guard():
            main = fl.Program()
            with fl.program_guard(main, fl.Program()):
                fetches = build(fl, main)
        out[key] = (main, fetches)
    assert out["jax"][0].to_json() == out["torch"][0].to_json()
    return out


def _rules(key, rules_list, mesh, data_axis="dp"):
    return PKGS[key][1].PartitionRules(rules_list, mesh,
                                       data_axis=data_axis)


def _same_analysis(progs, rules_list, mesh, fetches=None, feed_shapes=None,
                   data_axis="dp"):
    res = {}
    for key, (main, built) in progs.items():
        f = built if fetches is None else fetches
        res[key] = PKGS[key][1].analyze(
            main, _rules(key, rules_list, mesh, data_axis), fetch_names=f,
            feed_shapes=feed_shapes)
    j, t = res["jax"], res["torch"]
    rj, rt = j.to_record(), t.to_record()
    for r in (rj, rt):
        for d in r["diagnostics"]:
            d.pop("callsite", None)
    assert rj == rt
    assert [_diag(d) for d in j.diagnostics] \
        == [_diag(d) for d in t.diagnostics]
    assert j.collectives == t.collectives
    assert j.collective_table() == t.collective_table()
    assert j.notes == t.notes
    assert {n: s.render() for n, s in j.specs.items()} \
        == {n: s.render() for n, s in t.specs.items()}
    assert j.report["claimed"] == t.report["claimed"]
    assert j.report["fallthrough"] == t.report["fallthrough"]
    assert j.report["unmatched_rules"] == t.report["unmatched_rules"]
    assert j.memory == t.memory
    assert j.dp_sync_plan() == t.dp_sync_plan()
    return j, t


def _codes(a):
    return sorted({d.code for d in a.diagnostics})


# ---------------------------------------------------------------------------
# the lattice and the rule engine
# ---------------------------------------------------------------------------

SPECS = [None, (), ("mp", None), (None, "mp"), ("dp", "mp"), ("a", "b"),
         (None, None), ("-", ""), ("dp",)]


@pytest.mark.parametrize("dims", SPECS, ids=str)
def test_shard_spec_semantics(dims):
    mesh = {"dp": 2, "mp": 4, "a": 2, "b": 3}
    out = {}
    for key in PKGS:
        sh = PKGS[key][1]
        s = sh.ShardSpec(dims)
        p = s.with_partial(["dp"])
        m = sh.MeshSpec(mesh)
        out[key] = (s.dims, s.render(), repr(s), s.is_replicated,
                    s.sharded_axes(), s.axis_of(0), s.axis_of(1),
                    s.at_rank(1).dims, s.at_rank(3).dims, p.render(),
                    p.clear_partial().render(), s.shard_factor(m),
                    s.replace_dim(2, "b").render(), hash(s) == hash(
                        sh.ShardSpec(dims)), s == sh.REPLICATED,
                    m.total, repr(m), m.to_dict())
    assert out["jax"] == out["torch"]


def test_mesh_spec_and_rule_validation_raise_alike():
    for key in PKGS:
        sh = PKGS[key][1]
        with pytest.raises(ValueError, match="size 0"):
            sh.MeshSpec({"dp": 0})
        with pytest.raises(ValueError, match="ghost_axis"):
            sh.PartitionRules([(r".*", ["ghost_axis"])], {"mp": 2})
        assert sh.REPLICATED == sh.ShardSpec((None, None))
        assert len({sh.REPLICATED, sh.ShardSpec((None,)),
                    sh.ShardSpec((None, None))}) == 1


def test_rules_match_roundtrip_fingerprint_and_file(tmp_path):
    doc = {"mesh": {"dp": 2, "mp": 2}, "data_axis": "dp",
           "rules": [["w_special", ["mp", None]], ["w", [None, "mp"]],
                     [".*", []]]}
    p = tmp_path / "rules.json"
    p.write_text(json.dumps(doc))
    q = tmp_path / "nodp.json"
    q.write_text(json.dumps({"mesh": {"mp": 2},
                             "rules": [[".*", [None, "mp"]]]}))
    out = {}
    for key in PKGS:
        sh = PKGS[key][1]
        r = sh.PartitionRules.from_dict(doc)
        f = sh.load_rules_file(str(p))
        g = sh.load_rules_file(str(q))
        out[key] = ([r.match(n) and r.match(n)[:2]
                     for n in ("w_special", "w_other", "bias")],
                    r.to_dict(), r.fingerprint(), f.fingerprint(),
                    repr(r), g.data_axis, g.mesh.axes)
    assert out["jax"] == out["torch"]


def _mlp(fl, main):
    x = fl.data("x", [None, 8])
    y = fl.data("y", [None, 1])
    pred = fl.layers.fc(fl.layers.fc(x, 16, act="relu"), 1)
    loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
    fl.optimizer.Adam(1e-3).minimize(loss)
    return [loss.name]


MATCH_RULES = [
    [(r"fc_0\.w_0$", [None, "mp"])],
    [(r"fc_0\.w_0", ["mp"]), (r".*", [])],
    [(r"fc_0\.w_9$", [None, "mp"]), (r".*", [])],
    [(r"fc_[01]\.w_0$", [None, "mp"]), (r"fc_.*\.b", ["mp"]), (r".*", [])],
]


@pytest.mark.parametrize("rules", MATCH_RULES, ids=range(len(MATCH_RULES)))
def test_match_report_with_did_you_mean(rules):
    progs = _both(_mlp)
    reps = {}
    for key, (main, _) in progs.items():
        rep = PKGS[key][1].match_report(
            main, _rules(key, rules, {"dp": 2, "mp": 2}))
        rep["specs"] = {n: s.render() for n, s in rep["specs"].items()}
        reps[key] = rep
    assert reps["jax"] == reps["torch"]


def test_block_var_did_you_mean_alike():
    progs = _both(_mlp)
    msgs = []
    for main, _ in progs.values():
        with pytest.raises(ValueError) as ei:
            main.global_block().var("fc_0.w_9")
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] and "did you mean" in msgs[0]


# ---------------------------------------------------------------------------
# the propagation families and the seeded PT3xx programs
# ---------------------------------------------------------------------------

def _row_parallel(fl, main):
    x = fl.data("x", [4, 8])
    w = main.global_block().create_parameter(name="w", shape=[8, 6])
    return [fl.layers.relu(fl.layers.matmul(x, w)).name]


def _raw_partial(fl, main):
    x = fl.data("x", [4, 8])
    w = main.global_block().create_parameter(name="w", shape=[8, 6])
    return [fl.layers.matmul(x, w).name]


def _reshape_major(fl, main):
    w = main.global_block().create_parameter(name="emb", shape=[8, 16, 32])
    r = fl.layers.reshape(w, shape=[8, 16, 4, 8])
    return [fl.layers.transpose(r, perm=[0, 2, 1, 3]).name]


def _reshape_minor(fl, main):
    w = main.global_block().create_parameter(name="emb", shape=[4, 6])
    return [fl.layers.reshape(w, shape=[24]).name]


def _reduce(fl, main):
    w = main.global_block().create_parameter(name="w", shape=[8, 6])
    return [fl.layers.relu(fl.layers.reduce_sum(w, dim=[0])).name]


def _lookup(fl, main):
    ids = fl.data("ids", [None, 4], dtype="int64")
    return [fl.layers.relu(fl.layers.embedding(ids, size=(100, 8))).name]


def _unknown(fl, main):
    w = main.global_block().create_parameter(name="w", shape=[8, 6])
    out = main.global_block().create_var(name="o", shape=[8, 6])
    main.global_block().append_op("sequence_reverse", inputs={"X": w},
                                  outputs={"Out": out})
    return None


def _two_params(op):
    def build(fl, main):
        pa = main.global_block().create_parameter(name="pa", shape=[8, 4])
        pb = main.global_block().create_parameter(name="pb", shape=[8, 4])
        if op == "concat":
            return [fl.layers.concat([pa, pb], axis=1).name]
        if op == "add":
            return [fl.layers.elementwise_add(pa, pb).name]
        out = main.global_block().create_var(name="s", shape=[8, 4])
        main.global_block().append_op("sum", inputs={"X": [pa, pb]},
                                      outputs={"Out": out})
        return ["s"]
    return build


def _contraction(op_type):
    def build(fl, main):
        x = main.global_block().create_parameter(name="px", shape=[4, 8])
        w = main.global_block().create_parameter(name="pw", shape=[8, 6])
        out = main.global_block().create_var(name="o", shape=[4, 6])
        main.global_block().append_op(op_type, inputs={"X": x, "Y": w},
                                      outputs={"Out": out})
        return None
    return build


def _layer_norm_2d(fl, main):
    w = main.global_block().create_parameter(name="w", shape=[8, 4])
    return [fl.layers.layer_norm(w, begin_norm_axis=1).name]


def _tp_head(fl, main):
    x = fl.data("x", [None, 8])
    label = fl.data("label", [None, 1], dtype="int64")
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        fl.layers.fc(x, 10), label))
    fl.optimizer.SGD(0.1).minimize(loss)
    return [loss.name]


def _odd(fl, main):
    w = main.global_block().create_parameter(name="w", shape=[13, 4])
    return [fl.layers.relu(w).name]


def _giant(fl, main):
    ids = fl.data("ids", [None, 4], dtype="int64")
    return [fl.layers.reduce_sum(fl.layers.embedding(
        ids, size=(1000, 64))).name]


MP = {"mp": 2}
ROW_COL = {"row": 2, "col": 2}
CASES = {
    # name: (build, rules, mesh, feed_shapes, data_axis, a code it seeds)
    "matmul_row_parallel": (_row_parallel, [("^w$", ["mp", None]),
                                            (".*", [])], MP, None, "dp",
                            None),
    "matmul_column_parallel": (_raw_partial, [("^w$", [None, "mp"]),
                                              (".*", [])], MP, None, "dp",
                               None),
    "reshape_major_split": (_reshape_major, [("^emb$", [None, None, "mp"]),
                                             (".*", [])], MP, None, "dp",
                            None),
    "reshape_minor_gathers": (_reshape_minor, [("^emb$", [None, "mp"]),
                                               (".*", [])], MP, None, "dp",
                              None),
    "reduce_pends_psum": (_reduce, [("^w$", ["mp", None]), (".*", [])], MP,
                          None, "dp", None),
    "lookup_vocab_shard": (_lookup, [(r"embedding_0\.w_0$", ["mp", None]),
                                     (".*", [])], MP, {"ids": (6, 4)},
                           None, None),
    "unknown_family_degrades": (_unknown, [("^w$", ["mp", None]),
                                           (".*", [])], MP, None, "dp",
                                None),
    "partial_gather": (_layer_norm_2d, [("^w$", ["dp", "mp"]), (".*", [])],
                       {"dp": 2, "mp": 2}, None, "dp", None),
    "pt301_rule_miss": (_mlp, [(r"fc_0\.w_0$", [None, "mp"])],
                        {"dp": 2, "mp": 2}, None, "dp", "PT301"),
    "pt303_hot_edge": (_tp_head, [(r"fc_0\.w_0$", [None, "mp"]),
                                  (".*", [])], {"dp": 2, "mp": 2},
                       {"x": (8, 8), "label": (8, 1)}, "dp", "PT303"),
    "pt304_divisibility": (_odd, [("^w$", ["mp", None]), (".*", [])], MP,
                           None, "dp", "PT304"),
    "pt305_elementwise": (_two_params("add"), [("^pa$", ["row", None]),
                                               ("^pb$", ["col", None]),
                                               (".*", [])], ROW_COL, None,
                          "dp", "PT305"),
    "pt305_concat": (_two_params("concat"), [("^pa$", ["row", None]),
                                             ("^pb$", ["col", None]),
                                             (".*", [])], ROW_COL, None,
                     "dp", "PT305"),
    "pt305_sum": (_two_params("sum"), [("^pa$", ["row", None]),
                                       ("^pb$", ["col", None]), (".*", [])],
                  ROW_COL, None, "dp", "PT305"),
    "pt305_matmul": (_contraction("matmul"), [("^px$", [None, "a"]),
                                              ("^pw$", ["b", None]),
                                              (".*", [])],
                     {"a": 2, "b": 2}, None, "dp", "PT305"),
    "pt305_mul": (_contraction("mul"), [("^px$", [None, "a"]),
                                        ("^pw$", ["b", None]), (".*", [])],
                  {"a": 2, "b": 2}, None, "dp", "PT305"),
    "pt306_unresolved": (_raw_partial, [("^w$", ["mp", None]), (".*", [])],
                         MP, None, "dp", "PT306"),
    "dp_scalar_loss_fetch": (_mlp, [(".*", [])], {"dp": 2},
                             {"x": (8, 8), "y": (8, 1)}, "dp", None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_propagation_and_seeded_pt3xx_match_the_reference(case):
    build, rules, mesh, feed_shapes, data_axis, code = CASES[case]
    j, t = _same_analysis(_both(build), rules, mesh,
                          feed_shapes=feed_shapes, data_axis=data_axis)
    if code is not None:
        assert code in _codes(t)
    assert j.render() == t.render()


def test_seeded_pt302_replicated_giant_param():
    before = tf.get_flags("replicated_param_bytes")
    jbefore = jf.get_flags("replicated_param_bytes")
    tf.set_flags({"FLAGS_replicated_param_bytes": 1024})
    jf.set_flags({"FLAGS_replicated_param_bytes": 1024})
    try:
        j, t = _same_analysis(_both(_giant), [(r".*", [])], {"dp": 2})
        assert "PT302" in _codes(t)
    finally:
        tf.set_flags(before)
        jf.set_flags(jbefore)


@pytest.mark.parametrize("bucket", [4 << 20, 64, 0])
def test_dp_sync_plan_uses_the_bucket_planner(bucket):
    before = tf.get_flags("dp_bucket_bytes")
    jbefore = jf.get_flags("dp_bucket_bytes")
    tf.set_flags({"FLAGS_dp_bucket_bytes": bucket})
    jf.set_flags({"FLAGS_dp_bucket_bytes": bucket})
    try:
        j, t = _same_analysis(_both(_mlp), [(".*", [])], {"dp": 2},
                              feed_shapes={"x": (8, 8), "y": (8, 1)})
        assert t.dp_sync_plan()["count"] >= 1
    finally:
        tf.set_flags(before)
        jf.set_flags(jbefore)


# ---------------------------------------------------------------------------
# the seeded PT4xx programs (AMP)
# ---------------------------------------------------------------------------

def _pt401(fl, main):
    x = fl.data("x", [None, 8])
    return [fl.layers.log(fl.layers.cast(x, "bfloat16")).name]


def _pt402(fl, main):
    p = main.global_block().create_parameter(name="w", shape=[4],
                                             dtype="bfloat16")
    g = fl.data("g", [4])
    lr = fl.data("lr", [1])
    main.global_block().append_op(
        "sgd", inputs={"Param": p, "Grad": g, "LearningRate": lr},
        outputs={"ParamOut": p})
    return None


def _pt403(fl, main):
    x = fl.data("x", [None, 8])
    a = fl.layers.cast(x, "bfloat16")
    b = fl.layers.cast(x, "bfloat16")
    c = fl.layers.cast(a, "bfloat16")
    down = fl.layers.cast(x, "bfloat16")
    up = fl.layers.cast(down, "float32")
    out = fl.layers.elementwise_add(fl.layers.relu(a), fl.layers.relu(b))
    return [out.name, fl.layers.relu(c).name, fl.layers.relu(up).name]


def _pt404(fl, main):
    x = fl.data("x", [4, 100000])
    return [fl.layers.reduce_sum(fl.layers.cast(x, "bfloat16"),
                                 dim=[1]).name]


def _amp_train(dtype, scale=None):
    def build(fl, main):
        x = fl.data("x", [None, 8])
        y = fl.data("y", [None, 1])
        loss = fl.layers.mean(fl.layers.square_error_cost(
            fl.layers.fc(x, 1), y))
        if scale is not None:
            loss = fl.layers.scale(loss, scale=scale)
        fl.optimizer.SGD(0.1).minimize(loss)
        (jamp if fl is jf else tamp).rewrite_train_program(
            main, dest_dtype=dtype)
        return [loss.name]
    return build


def _pt407(fl, main):
    x = fl.data("x", [None, 8])
    h = fl.layers.cast(fl.layers.relu(x), "bfloat16")
    return [h.name]


PT4XX = {
    "pt401_fragile_bf16": (_pt401, ["x"], "PT401"),
    "pt402_lost_master": (_pt402, ["g", "lr"], "PT402"),
    "pt403_cast_churn": (_pt403, ["x"], "PT403"),
    "pt404_accumulation": (_pt404, ["x"], "PT404"),
    "pt405_fp16_unscaled": (_amp_train("float16"), ["x", "y"], "PT405"),
    "pt405_fp16_scaled": (_amp_train("float16", 1024.0), ["x", "y"], None),
    "pt405_bf16": (_amp_train("bfloat16"), ["x", "y"], None),
    "pt407_fetch_drift": (_pt407, ["x"], None),
}


@pytest.mark.parametrize("case", sorted(PT4XX))
def test_seeded_pt4xx_match_the_reference(case):
    build, feeds, code = PT4XX[case]
    res = {}
    for key, (main, fetches) in _both(build).items():
        r = PKGS[key][2].check_program(main, fetch_names=fetches,
                                       feed_names=feeds)
        res[key] = ([_diag(d) for d in r.diagnostics], r.ok,
                    r.numerics.churn_bytes, r.numerics.churn_removable,
                    r.numerics.near_miss_guards())
    assert res["jax"] == res["torch"]
    if code is not None:
        assert code in {d["code"] for d in res["torch"][0]}


def _attention(leak):
    def build(fl, main):
        q = fl.data("q", [2, 4, 8, 16])
        k = fl.data("k", [2, 4, 8, 16])
        v = fl.data("v", [2, 4, 8, 16])
        probs = fl.layers.softmax(fl.layers.scale(
            fl.layers.matmul(q, k, transpose_y=True), scale=0.25))
        out = fl.layers.matmul(probs, v)
        return [out.name] + ([fl.layers.relu(probs).name] if leak else [])
    return build


@pytest.mark.parametrize("leak", [True, False])
def test_pt406_fusion_near_miss_matches_the_reference(leak):
    res = {}
    for key, (main, fetches) in _both(_attention(leak)).items():
        passes = PKGS[key][4]
        fused, _ = passes.fuse_program(main, fetch_names=fetches,
                                       record=False)
        r = PKGS[key][2].check_program(fused, fetch_names=fetches)
        res[key] = ([_diag(d) for d in r.diagnostics],
                    r.numerics.near_miss_guards())
    assert res["jax"] == res["torch"]
    assert ("PT406" in {d["code"] for d in res["torch"][0]}) == leak


# ---------------------------------------------------------------------------
# the zoo: check_program, the lowering, memory
# ---------------------------------------------------------------------------

def _zoo_pair(name):
    jm = jzoo.build(name)
    tm = tzoo.build(name)
    assert tf.Program.from_json(jm.main.to_json()).to_json() \
        == tm.main.to_json()
    return jm, tm


def _lint_records(result):
    rec = result.to_record()
    rec.pop("wall_ms", None)
    rec["diagnostics"] = [_diag(d) for d in result.diagnostics]
    if result.sharding is not None:
        rec["sharding"] = result.sharding.to_record()
        for d in rec["sharding"]["diagnostics"]:
            d.pop("callsite", None)
        rec["memory"] = result.sharding.memory
    return rec


@pytest.mark.parametrize("tier", ["plain", "amp_fused"])
@pytest.mark.parametrize("name", sorted(tzoo.BUILDERS))
def test_check_program_on_the_zoo_matches_the_reference(name, tier):
    """All eight families, under their default rules, as built and as the
    AMP + fused substitute the Executor runs: the same diagnostics (code,
    op index, var, message), the same sharding and memory records."""
    jm, tm = _zoo_pair(name)
    jp = jm.main
    tp = tf.Program.from_json(jm.main.to_json())
    if tier == "amp_fused":
        jp = jamp.rewrite_train_program(jp.clone())
        jp, _ = jpasses.fuse_program(jp, fetch_names=jm.fetches,
                                     record=False)
        tp = tamp.rewrite_train_program(tp.clone())
        tp, _ = tpasses.fuse_program(tp, fetch_names=tm.fetches,
                                     record=False)
        assert jp.to_json() == tp.to_json()
    fs = jm.smoke_feed_shapes()
    jr = ja.check_program(jp, fetch_names=jm.fetches, feed_names=sorted(fs),
                          sharding=jm.partition_rules(), feed_shapes=fs)
    tr = ta.check_program(tp, fetch_names=tm.fetches, feed_names=sorted(fs),
                          sharding=tm.partition_rules(), feed_shapes=fs)
    assert _lint_records(jr) == _lint_records(tr)
    assert tr.ok and tr.sharding is not None
    assert not tr.sharding.diagnostics
    # without rules: the PT1xx/PT2xx/PT4xx passes alone
    jr = ja.check_program(jp, fetch_names=jm.fetches)
    tr = ta.check_program(tp, fetch_names=tm.fetches)
    assert _lint_records(jr) == _lint_records(tr)


@pytest.mark.parametrize("name", ["bert", "gpt"])
def test_lower_matches_the_reference(name):
    """The lowering plan of the transformers' Megatron rules: the record,
    the render, the collective and per-var tables, the model records, the
    constraints, the state specs and the analysis' memory estimate."""
    jm, tm = _zoo_pair(name)
    fs = jm.smoke_feed_shapes()
    kw = dict(fetch_names=[jm.loss_name], feed_names=sorted(fs),
              feed_shapes=fs)
    jp = jsh.lower(jm.main, jm.partition_rules(), **kw)
    tp = tsh.lower(tm.main, tm.partition_rules(), **kw)
    assert jp.to_record() == tp.to_record()
    assert jp.render() == tp.render()
    assert jp.collective_table() == tp.collective_table()
    assert jp.per_var_table() == tp.per_var_table()
    assert jp.model_sync_records() == tp.model_sync_records()
    assert [(i, n, s.render()) for i, n, s in jp.constraints] \
        == [(i, n, s.render()) for i, n, s in tp.constraints]
    assert {n: s.render() for n, s in jp.state_specs.items()} \
        == {n: s.render() for n, s in tp.state_specs.items()}
    assert jp.memory == tp.memory
    assert tp.body_spec(tsh.ShardSpec(("dp", "mp"))).dims == (None, "mp")
    table = tp.collective_table()[("all_reduce", ("mp",))]
    assert table == {"count": 3, "bytes": 24576}
    ja_ = jsh.analyze(jm.main, jm.partition_rules(), fetch_names=jm.fetches,
                      feed_shapes=fs)
    ta_ = tsh.analyze(tm.main, tm.partition_rules(), fetch_names=tm.fetches,
                      feed_shapes=fs)
    assert ja_.memory == ta_.memory
    repl = tsh.analyze(tm.main, tsh.PartitionRules([(".*", [])], {"dp": 2}),
                       fetch_names=tm.fetches, feed_shapes=fs)
    assert ta_.memory["state_bytes"] < repl.memory["state_bytes"]
    assert sum(ta_.memory["per_scope"].values()) \
        == ta_.memory["peak_bytes"]


def test_op_records_cover_every_op_and_keep_the_records():
    """The port's per-op record (the runtime tier's input) names every op
    of gpt, consumes each input at a spec and writes each output's."""
    tm = tzoo.build("gpt")
    fs = tm.smoke_feed_shapes()
    plan = tsh.lower(tm.main, tm.partition_rules(),
                     fetch_names=[tm.loss_name], feed_names=sorted(fs),
                     feed_shapes=fs)
    ops = tm.main.global_block().ops
    assert sorted(plan.op_records) == list(range(len(ops)))
    for i, op in enumerate(ops):
        rec = plan.op_records[i]
        assert rec.type == op.type
        assert set(rec.consumed) == set(op.input_names())
        assert set(rec.outputs) == set(op.output_names())
    resolved = [(i, n) for i, r in plan.op_records.items()
                for n, steps in r.steps.items()
                if any(k == "resolve" for k, _, _ in steps)]
    model = [(r["op_index"], r["var"]) for r in plan.model_sync_records()]
    assert resolved == model
    # the fc_0 bias joins its column-parallel product sliced, for free
    add = plan.op_records[2]
    assert add.consumed["fc_0.b_0"].render() == "[mp]"
    # moments are consumed where the plan places them
    adam = next(r for r in plan.op_records.values()
                if r.type == "adam" and "fc_0.w_0" in r.consumed)
    assert adam.consumed["fc_0.w_0_adam_0_moment1"].render() == "[-, mp]"


def test_local_slice_gives_each_rank_its_block():
    x = np.arange(24).reshape(4, 6)
    spec = tsh.ShardSpec(("dp", "mp"))
    blocks = [tsh.local_slice(x, spec, {"dp": (i, 2), "mp": (j, 3)})
              for i in range(2) for j in range(3)]
    assert all(b.shape == (2, 2) for b in blocks)
    assert np.array_equal(np.block([blocks[:3], blocks[3:]]), x)
    # an axis without a coordinate (the data axis of a body spec) leaves
    # its dim whole
    assert tsh.local_slice(x, tsh.ShardSpec(("dp", None)),
                           {"mp": (1, 2)}).shape == (4, 6)
    with pytest.raises(ValueError, match="does not split"):
        tsh.local_slice(x, tsh.ShardSpec(("mp",)), {"mp": (0, 3)})


# ---------------------------------------------------------------------------
# caching, attachment, the executor's wiring
# ---------------------------------------------------------------------------

def test_cached_check_rekeys_and_attach_keeps_the_version():
    from paddle_tpu_torch.analysis import verifier

    progs = _both(_mlp)
    main, fetches = progs["torch"]
    v = main._version
    base = verifier.analysis_runs
    tsh.attach(main, tsh.PartitionRules([(".*", [])], {"dp": 2}))
    assert main._version == v
    r1, fresh1 = ta.cached_check(main, fetch_names=fetches)
    r1b, fresh1b = ta.cached_check(main, fetch_names=fetches)
    assert fresh1 and not fresh1b and r1b is r1
    tsh.attach(main, tsh.PartitionRules([(r"fc_0\.w_0$", [None, "mp"])],
                                        {"dp": 2, "mp": 2}))
    r2, fresh2 = ta.cached_check(main, fetch_names=fetches)
    assert fresh2 and any(d.code == "PT301" for d in r2.errors)
    tf.set_flags({"FLAGS_numerics_reduce_elems": 1024})
    try:
        _, fresh3 = ta.cached_check(main, fetch_names=fetches)
    finally:
        tf.set_flags({"FLAGS_numerics_reduce_elems": 65536})
    assert fresh3
    assert verifier.analysis_runs == base + 3
    tsh.attach(main, None)
    assert main._version == v


def test_clone_and_the_fused_substitute_keep_the_rules():
    from paddle_tpu_torch.framework.executor import Executor

    progs = _both(_raw_partial)
    main, fetches = progs["torch"]
    rules = tsh.PartitionRules([("^w$", ["mp", None]), (".*", [])], MP)
    tsh.attach(main, rules)
    ev = main.clone(for_test=True)
    assert tsh.attached(ev) is rules
    assert any(d.code == "PT306"
               for d in ta.check_program(ev, fetch_names=fetches).errors)
    m = tzoo.build("gpt")
    rules = m.partition_rules()
    tf.CompiledProgram(m.main).with_sharding_rules(rules)
    sub = Executor._resolve_train_optimized(m.main, m.fetches, True, True)
    assert tsh.attached(sub) is rules


@pytest.fixture
def static_check_flag():
    yield
    tf.set_flags({"FLAGS_static_check": "off"})


def test_executor_error_mode_raises_before_any_op(static_check_flag):
    progs = _both(_raw_partial)
    main, fetches = progs["torch"]
    prog = tf.CompiledProgram(main).with_sharding_rules(
        [("^w$", ["mp", None]), (".*", [])], mesh={"mp": 2})
    tf.set_flags({"FLAGS_static_check": "error"})
    exe = tf.Executor(tf.CPUPlace())
    scope = tf.Scope()
    with pytest.raises(ta.ProgramLintError) as ei:
        # no scope value for w: an op run first would raise otherwise
        exe.run(prog, feed={"x": np.ones((4, 8), np.float32)},
                fetch_list=fetches, scope=scope)
    assert "PT306" in str(ei.value)


def test_warn_mode_warns_once_per_version_and_off_runs_nothing(
        static_check_flag):
    from paddle_tpu_torch.analysis import verifier

    with tf.unique_name.guard():
        main, startup = tf.Program(), tf.Program()
        with tf.program_guard(main, startup):
            x = tf.data("x", [None, 8])
            h = tf.layers.fc(x, 4)
            tf.layers.relu(h)        # dead: never fetched
            loss = tf.layers.mean(h)
    exe = tf.Executor(tf.CPUPlace())
    scope = tf.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((4, 8), np.float32)}
    base = verifier.analysis_runs
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert verifier.analysis_runs == base
    tf.set_flags({"FLAGS_static_check": "warn"})
    with pytest.warns(ta.ProgramLintWarning, match="PT201"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert verifier.analysis_runs == base + 1


def test_exports_are_the_reference_names():
    assert set(ja.__all__) == set(ta.__all__)
    for n in ja.__all__:
        assert hasattr(ta, n), n
    assert ja.CODES == ta.CODES
    assert callable(ta.warn_result)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_ARGS = [
    ["--all-models", "--sharding-rules", "default"],
    ["--model", "bert", "--sharding-rules", "default", "--lower"],
    ["--model", "gpt", "--sharding-rules", "default", "--lower", "--json"],
    ["--all-models", "--amp", "--fuse"],
    ["--all-models", "--amp", "--fuse", "--json"],
    ["--model", "mlp", "--lower"],
    ["--model", "nope"],
]


def _cli(main, args, capsys):
    rc = main(args)
    cap = capsys.readouterr()
    out = re.sub(r"\[[0-9.]+ ms\]", "[ms]", cap.out)
    if "--json" in args and rc in (0, 1):
        recs = json.loads(out)
        for r in recs:
            r.pop("wall_ms", None)
            for d in r.get("diagnostics", ()):
                d.pop("callsite", None)
            for d in r.get("sharding", {}).get("diagnostics", ()):
                d.pop("callsite", None)
        out = recs
    return rc, out, cap.err


@pytest.mark.parametrize("args", CLI_ARGS, ids=" ".join)
def test_cli_output_and_exit_code_match_the_reference(args, capsys):
    sys.path.insert(0, str(REPO))
    import tools.program_lint as jcli

    from paddle_tpu_torch.tools import program_lint as tcli

    j = _cli(jcli.main, list(args), capsys)
    t = _cli(tcli.main, list(args), capsys)
    assert j == t
    assert t[0] in (0, 2)


def test_cli_shape_dependent_and_sharding_errors_exit_one(tmp_path, capsys):
    from paddle_tpu_torch.tools import program_lint as tcli

    p = tmp_path / "rules.json"
    p.write_text(json.dumps({"mesh": {"dp": 3}, "data_axis": "dp",
                             "rules": [[".*", []]]}))
    assert tcli.main(["--model", "mlp", "--sharding-rules", str(p)]) == 1
    assert "PT304" in capsys.readouterr().out
    progs = _both(_raw_partial)
    main, fetches = progs["torch"]
    prog = tmp_path / "prog.json"
    prog.write_text(main.to_json())
    rules = tmp_path / "mp.json"
    rules.write_text(json.dumps({"mesh": {"mp": 2},
                                 "rules": [["^w$", ["mp", None]],
                                           [".*", []]]}))
    assert tcli.main([str(prog), "--fetch", fetches[0],
                      "--sharding-rules", str(rules)]) == 1
    assert "PT306" in capsys.readouterr().out
