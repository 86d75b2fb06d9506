"""The port's fact layer (analysis/facts.py, analysis/shape_rules.py)
against the JAX package's.

On every static-zoo family's Program, plain, fused (`passes.fuse_program`)
and AMP-rewritten then fused, the (shape, dtype) walk `infer_specs` gives
equal `VarSpec`s for every name, and the same events (`no_rule`,
`shape_error`, `rule_crash`) on the op types both registries hold (the
reference's registry has many more op types than the port's, and
`infer_specs` reports `no_rule` only for registered types).  The
liveness, segment, multi-write and protected-name facts are equal too.
All exact: the port's modules are copies of the reference's pure Python.
"""

import pytest

import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
from paddle_tpu import amp as jamp
from paddle_tpu import passes as jpasses
from paddle_tpu.analysis import facts as jfacts
from paddle_tpu.analysis import shape_rules as jsr
from paddle_tpu.models import static_zoo as jzoo
from paddle_tpu.ops import registry as jreg

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import passes as tpasses
from paddle_tpu_torch.analysis import facts as tfacts
from paddle_tpu_torch.analysis import shape_rules as tsr
from paddle_tpu_torch.models import static_zoo as tzoo
from paddle_tpu_torch.ops import registry as treg
from torch_threads import torch_threads  # noqa: F401

FAMILIES = sorted(jzoo.BUILDERS)
COMMON_TYPES = set(treg._OPS) & set(jreg._OPS)


def _program(zoo, amp_mod, passes_mod, name, form):
    m = zoo.build(name)
    prog = m.main.clone()
    if form == "amp_fused":
        amp_mod.rewrite_train_program(prog)
    if form != "plain":
        prog, _ = passes_mod.fuse_program(prog, fetch_names=[m.loss_name])
    return m, prog


def _pair(name, form):
    tm, tprog = _program(tzoo, tamp, tpasses, name, form)
    jm, jprog = _program(jzoo, jamp, jpasses, name, form)
    assert tprog.to_json() == jprog.to_json()
    return tm, tprog, jm, jprog


def _specs(facts_mod, prog, feeds):
    events = []

    def on_event(kind, op, i, err):
        if op.type in COMMON_TYPES:
            events.append((kind, op.type, i, type(err).__name__,
                           str(err) if err is not None else None))

    specs = facts_mod.infer_specs(prog, feed_names=feeds, on_event=on_event)
    return {n: (s.shape, s.dtype) for n, s in specs.items()}, events


@pytest.mark.parametrize("form", ["plain", "fused", "amp_fused"])
@pytest.mark.parametrize("name", FAMILIES)
def test_infer_specs_and_events_are_the_references(name, form):
    tm, tprog, jm, jprog = _pair(name, form)
    feeds = sorted(tm.smoke_feed(2))
    got, g_events = _specs(tfacts, tprog, feeds)
    want, w_events = _specs(jfacts, jprog, feeds)
    assert got == want
    assert g_events == w_events
    # with a concrete batch the walk still agrees
    over = {f: (3,) + tuple(tprog.global_block().var(f).shape[1:])
            for f in feeds}
    assert {n: (s.shape, s.dtype) for n, s in tfacts.infer_specs(
        tprog, feed_names=feeds, overrides=over).items()} == {
        n: (s.shape, s.dtype) for n, s in jfacts.infer_specs(
            jprog, feed_names=feeds, overrides=over).items()}


@pytest.mark.parametrize("form", ["plain", "amp_fused"])
@pytest.mark.parametrize("name", FAMILIES)
def test_liveness_segments_writes_and_protection_are_the_references(
        name, form):
    tm, tprog, jm, jprog = _pair(name, form)
    for facts_mod, prog, m, out in ((tfacts, tprog, tm, []),
                                    (jfacts, jprog, jm, [])):
        ops = prog.global_block().ops
        sections = list(prog.backward_sections)
        persist = {v.name for v in prog.list_vars() if v.persistable}
        pre = persist | set(m.smoke_feed(2))
        out.append(facts_mod.backward_segments(len(ops), sections))
        out.append(facts_mod.live_op_mask(
            ops, sections, [m.loss_name], persist,
            facts_mod.control_flow_types(), facts_mod.SIDE_EFFECT_TYPES))
        # a test clone: no sections, only the fetch keeps ops alive
        test_ops = prog.clone(for_test=True).global_block().ops
        out.append(facts_mod.live_op_mask(test_ops, [], [m.loss_name],
                                          persist))
        out.append(sorted(facts_mod.multi_written_names(ops, pre)))
        out.append(sorted(facts_mod.protected_names(prog)))
        if facts_mod is tfacts:
            got = out
        else:
            want = out
    assert got == want
    assert sum(got[1]) > 0 and got[0][-1] == len(tprog.backward_sections)


def test_shape_rule_tables_and_helpers_are_the_references():
    assert set(tsr._RULES) == set(jsr._RULES)
    assert tsr._OPAQUE_OPS == jsr._OPAQUE_OPS
    assert tsr.stale_opaque_entries() == jsr.stale_opaque_entries() == []
    assert tfacts.control_flow_types() == jfacts.control_flow_types()
    assert tfacts.SIDE_EFFECT_TYPES == jfacts.SIDE_EFFECT_TYPES
    assert tfacts.grad_name("w") == jfacts.grad_name("w") == "w@GRAD"
    # every op type the port registers has a rule or is marked opaque,
    # as in the reference
    missing = sorted(t for t in treg._OPS
                     if not tsr.has_shape_rule(t) and not tsr.is_opaque(t))
    assert missing == sorted(t for t in treg._OPS
                             if not jsr.has_shape_rule(t)
                             and not jsr.is_opaque(t))
    for mod in (tsr, jsr):
        spec = mod.VarSpec([2, -1, 3], "float32")
        assert (spec.shape, spec.rank, spec.numel()) == ((2, None, 3), 3,
                                                          None)
        assert mod.OPAQUE.shape is None and mod.OPAQUE.dtype is None
    specs_t, specs_j = {}, {}
    tm, jm = tzoo.build("mlp"), jzoo.build("mlp")
    top, jop = tm.main.global_block().ops[0], jm.main.global_block().ops[0]
    tfacts.bind_outputs(specs_t, top, None)
    jfacts.bind_outputs(specs_j, jop, None)
    assert {n: (s.shape, s.dtype) for n, s in specs_t.items()} == {
        n: (s.shape, s.dtype) for n, s in specs_j.items()}
    v = tm.main.global_block().var(top.input_names()[0])
    assert (tfacts.var_spec(v).shape, tfacts.var_spec(v).dtype) == (
        tuple(None if d is None or d < 0 else d for d in v.shape), v.dtype)
