"""The port's fusion tier and AMP train tier against the JAX package's.

Programs: for all eight static-zoo families the port's Program, after
`passes.fuse_program` alone, `amp.rewrite_train_program` alone and AMP
then fusion, is `to_json` byte-equal to the reference's, with equal
per-pass match counts and op counts, equal near-misses (their callsite
left out: it names the test's own frames) and equal `folded_from` on
every op.  Wall-clock fields are left out of the reports.

Fused ops: each of the four fusion-tier ops against the reference's
registered op function on the same seeded numpy inputs: f32 atol = rtol
1e-6 (the same composition, sums of a few terms in another order), bf16
3e-2 (one bf16 rounding taken at other places); VJPs against `jax.grad`
with a seeded cotangent, f32, 1e-5.

Executor: three steps with FLAGS_graph_opt_fuse "on" (and FLAGS_amp
"on" or "off") against the JAX Executor with the same flags, from the
reference's startup values (`interop.scope_from_numpy`):
- fused f32, every family: the tolerances of tests/test_torch_static_zoo.py
  (fetches 1e-5; each persistable's update in norm within 0.1 of the
  reference's, the attention's key bias `fc_1.b_0` left out);
- AMP + fused (bert, gpt, resnet): losses within 3e-2 relative; the dtype
  and shape of every intermediate the forward produces equal at every
  step; and two update rules (`_update_faults`).  The replay: every
  optimizer op at every step equals the reference's op function on the
  port's own state and gradient, within 1e-4 of its step in norm, so
  every parameter and optimizer state is held whatever its gradient's
  noise.  The update: each parameter's update within 0.1 of the
  reference's in norm, over the elements whose gradient lies farther
  than 20 times the two frameworks' difference from 0 at every step
  (a gradient known to 0.05); the running statistics over all their
  elements.  Elements near 0 are many in bf16 because the reference's
  CPU backend sums a bf16 reduction at bf16 precision (a [4, 16, 6, 6]
  bias-gradient sum 1.1e-2 off the exact one, torch's 1.8e-3): resnet's
  batch-norm and conv gradients differ from the port's by up to 0.87 in
  norm, as far as from the reference's own f32 ones.  A planted
  left-out optimizer op fails both rules (`test_amp_update_rules_catch_
  a_left_out_update`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
from paddle_tpu import amp as jamp
from paddle_tpu import passes as jpasses
from paddle_tpu.framework import executor as jexecutor
from paddle_tpu.models import static_zoo as jzoo
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch as fluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import interop
from paddle_tpu_torch import passes as tpasses
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.models import static_zoo as tzoo
from paddle_tpu_torch.ops import registry as treg
from torch_threads import torch_threads  # noqa: F401

FAMILIES = sorted(jzoo.BUILDERS)
MODES = ("fuse", "amp", "amp_fuse")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _tier_flags_off():
    """Every test starts with both packages' tier flags off and leaves
    them as it found them."""
    names = ["FLAGS_amp", "FLAGS_graph_opt_fuse", "FLAGS_amp_dtype"]
    j, t = jfluid.get_flags(names), fluid.get_flags(names)
    off = {"FLAGS_amp": "off", "FLAGS_graph_opt_fuse": "off"}
    jfluid.set_flags(off)
    fluid.set_flags(off)
    yield
    jfluid.set_flags(j)
    fluid.set_flags(t)


def _report(rep):
    rep = {k: v for k, v in rep.items() if k not in ("total_wall_ms", "key")}
    rep["passes"] = [{k: v for k, v in r.items() if k != "wall_ms"}
                     for r in rep["passes"]]
    return rep


def _misses(program):
    return [{k: v for k, v in nm.items() if k != "callsite"}
            for nm in getattr(program, "_fusion_near_misses", [])]


def _rewrite(amp_mod, passes_mod, program, mode, fetch):
    report = None
    if "amp" in mode:
        amp_mod.rewrite_train_program(program)
    if "fuse" in mode:
        program, report = passes_mod.fuse_program(program, fetch_names=fetch)
    return program, report


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", FAMILIES)
def test_rewritten_programs_are_the_references(name, mode):
    jm, tm = jzoo.build(name), tzoo.build(name)
    got, g_rep = _rewrite(tamp, tpasses, tm.main.clone(), mode,
                          [tm.loss_name])
    want, w_rep = _rewrite(jamp, jpasses, jm.main.clone(), mode,
                           [jm.loss_name])
    assert got.to_json() == want.to_json()
    assert [(op.type, tuple(op.folded_from))
            for op in got.global_block().ops] == [
        (op.type, tuple(op.folded_from)) for op in want.global_block().ops]
    assert (got.amp_enabled, getattr(got, "_amp_dest", None)) == (
        want.amp_enabled, getattr(want, "_amp_dest", None))
    if "fuse" in mode:
        assert _report(g_rep) == _report(w_rep)
        assert _misses(got) == _misses(want)
        assert got._fusion_applied and want._fusion_applied


def test_match_counts_are_the_references_tests():
    """The counts of the reference's tests/test_fuse.py."""
    expect = {"bert": {"fuse_attention": 1, "fuse_bias_act": 1,
                       "fuse_layer_norm": 2},
              "gpt": {"fuse_attention": 1, "fuse_bias_act": 1,
                      "fuse_layer_norm": 2},
              "resnet": {"fuse_bottleneck": 6},
              "lenet": {"fuse_bias_act": 2},
              "mlp": {"fuse_bias_act": 1}}
    for name, want in expect.items():
        m = tzoo.build(name)
        _, rep = tpasses.fuse_program(m.main, fetch_names=[m.loss_name])
        got = {r["name"]: r["matched"] for r in rep["passes"]
               if r.get("matched")}
        assert got == want, name
        assert rep["patterns_matched"] == sum(want.values())


def test_near_misses_equal_the_references():
    """Fetching the attention's softmax output protects it: the attention
    pattern is refused by a named guard, in both packages alike."""
    out = {}
    for zoo, passes_mod in ((tzoo, tpasses), (jzoo, jpasses)):
        m = zoo.build("bert")
        probs = next(op.outputs["Out"][0] for op in m.main.global_block().ops
                     if op.type == "softmax")
        fused, rep = passes_mod.fuse_program(
            m.main, fetch_names=[m.loss_name, probs])
        out[zoo] = (fused.to_json(), _report(rep), _misses(fused))
    assert out[tzoo] == out[jzoo]
    misses = out[tzoo][2]
    assert misses and misses[0]["guard"] == "protected_var"
    assert out[tzoo][1]["near_miss_guards"] == {"protected_var": 1}


@pytest.mark.parametrize("name", FAMILIES)
def test_fusion_is_idempotent_and_keeps_the_canonical_order(name):
    m = tzoo.build(name)
    amped = tamp.rewrite_train_program(m.main.clone())
    fused, _ = tpasses.fuse_program(amped, fetch_names=[m.loss_name])
    again, rep = tpasses.fuse_program(fused, fetch_names=[m.loss_name])
    assert rep["patterns_matched"] == 0 and rep["ops_removed"] == 0
    assert again.to_json() == fused.to_json()
    # AMP after fusion is refused (a program the tier fused, or one that
    # merely carries fused ops), in both packages; AMP twice is a no-op
    fused_only, rep = tpasses.fuse_program(m.main, fetch_names=[m.loss_name])
    jm = jzoo.build(name)
    jfused, _ = jpasses.fuse_program(jm.main, fetch_names=[jm.loss_name],
                                     record=False)
    if rep["patterns_matched"]:
        for mod, prog in ((tamp, fused_only), (jamp, jfused)):
            with pytest.raises(ValueError, match="canonical order"):
                mod.rewrite_train_program(prog)
            clone = prog.clone()
            clone._fusion_applied = False
            with pytest.raises(ValueError, match="canonical order"):
                mod.rewrite_train_program(clone)
    n = len(amped.global_block().ops)
    assert len(tamp.rewrite_train_program(amped).global_block().ops) == n


def test_rewrite_program_refuses_a_minimized_program():
    m = tzoo.build("mlp")
    with pytest.raises(ValueError, match="before minimize"):
        tamp.rewrite_program(m.main.clone())


def test_unknown_fusion_pass_names_raise():
    with pytest.raises(KeyError, match="unknown fusion pass"):
        tpasses.enabled_fusion_passes("fuse_everything")
    assert tpasses.enabled_fusion_passes("fuse_attention, fuse_bottleneck") \
        == ("fuse_bias_act", "fuse_layer_norm")
    assert tpasses.FUSION_PIPELINE == jpasses.FUSION_PIPELINE
    assert tpasses.FUSED_TIER_TYPES == jpasses.FUSED_TIER_TYPES


# ---------------------------------------------------------------------------
# the fused ops against the reference's registered op functions
# ---------------------------------------------------------------------------

def _rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _attn(q, k, v, **attrs):
    return {"Q": q, "K": k, "V": v}, dict(
        {"scale": 0.5, "head_number": 0, "compute_dtype": "",
         "softmax_axis": -1}, **attrs)


_CONV = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 1, "data_format": "NCHW"}
_BN = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
       "data_layout": "NCHW"}
_BOTTLENECK = ({"Input": _rnd((2, 3, 6, 6), 40), "Filter":
                _rnd((4, 3, 3, 3), 41, 0.3), "Scale": _rnd((4,), 42),
                "Bias": _rnd((4,), 43), "Mean": _rnd((4,), 44, 0.1),
                "Variance": np.abs(_rnd((4,), 45)) + 0.5},
               {"conv_attrs": _CONV, "bn_attrs": _BN, "act": "relu",
                "act_attrs": {}, "compute_dtype": ""})

# (id, op, inputs, attrs, grads: slots whose VJP is held, or ())
FUSED_CASES = [
    ("attn_rank4", "fused_attention",
     *_attn(_rnd((2, 2, 8, 4), 1), _rnd((2, 2, 8, 4), 2),
            _rnd((2, 2, 8, 4), 3)), ("Q", "K", "V")),
    ("attn_heads", "fused_attention",
     *_attn(_rnd((2, 8, 8), 4), _rnd((2, 8, 8), 5), _rnd((2, 8, 8), 6),
            head_number=2, scale=0.35), ("Q", "K", "V")),
    ("attn_rank3_bool_mask", "fused_attention",
     *_attn(_rnd((2, 6, 4), 7), _rnd((2, 6, 4), 8), _rnd((2, 6, 4), 9)),
     ("Q", "K", "V")),
    ("attn_rank3_add_mask", "fused_attention",
     *_attn(_rnd((2, 6, 4), 10), _rnd((2, 6, 4), 11), _rnd((2, 6, 4), 12)),
     ("Q", "K", "V", "Mask")),
    ("attn_decode", "fused_attention",
     *_attn(_rnd((2, 1, 8), 13), _rnd((2, 6, 8), 14), _rnd((2, 6, 8), 15),
            head_number=2, decode=True), ("Q", "K", "V")),
    ("attn_bf16_compute", "fused_attention",
     *_attn(_rnd((2, 8, 8), 16), _rnd((2, 8, 8), 17), _rnd((2, 8, 8), 18),
            head_number=2, compute_dtype="bfloat16"), ()),
    ("bias_relu", "fused_bias_act",
     {"X": _rnd((4, 6), 20), "Bias": _rnd((6,), 21)},
     {"act": "relu", "act_attrs": {}, "axis": -1}, ("X", "Bias")),
    ("bias_gelu_tanh", "fused_bias_act",
     {"X": _rnd((4, 6), 22), "Bias": _rnd((6,), 23)},
     {"act": "gelu", "act_attrs": {"approximate": True}, "axis": -1},
     ("X", "Bias")),
    ("bias_gelu_axis1", "fused_bias_act",
     {"X": _rnd((2, 3, 4), 24), "Bias": _rnd((3,), 25)},
     {"act": "gelu", "act_attrs": {}, "axis": 1}, ("X", "Bias")),
    ("bias_tanh", "fused_bias_act",
     {"X": _rnd((4, 6), 26), "Bias": _rnd((6,), 27)},
     {"act": "tanh", "act_attrs": {}, "axis": -1}, ("X", "Bias")),
    ("bias_sigmoid", "fused_bias_act",
     {"X": _rnd((4, 6), 28), "Bias": _rnd((6,), 29)},
     {"act": "sigmoid", "act_attrs": {}, "axis": -1}, ("X", "Bias")),
    ("ln_residual", "fused_layer_norm",
     {"X": _rnd((4, 8), 30), "Residual": _rnd((4, 8), 31),
      "Scale": _rnd((8,), 32), "Bias": _rnd((8,), 33)},
     {"begin_norm_axis": 1, "epsilon": 1e-5},
     ("X", "Residual", "Scale", "Bias")),
    ("ln_plain", "fused_layer_norm",
     {"X": _rnd((2, 3, 8), 34), "Scale": _rnd((8,), 35),
      "Bias": _rnd((8,), 36)},
     {"begin_norm_axis": 2, "epsilon": 1e-5}, ("X", "Scale", "Bias")),
    ("bottleneck_relu", "fused_bottleneck", *_BOTTLENECK,
     ("Input", "Filter", "Scale", "Bias")),
    ("bottleneck_bf16_compute", "fused_bottleneck", _BOTTLENECK[0],
     dict(_BOTTLENECK[1], act="", compute_dtype="bfloat16"), ()),
]
_MASKS = {"attn_rank3_bool_mask": np.random.default_rng(19).random(
    (2, 6, 6)) < 0.7, "attn_rank3_add_mask": _rnd((2, 6, 6), 37)}
for _cid, _op, _ins, _attrs, _g in FUSED_CASES:
    if _cid in _MASKS:
        _ins["Mask"] = _MASKS[_cid]


def _jax_in(a, dtype):
    if a.dtype.kind == "f" and dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16)
    return jnp.asarray(a)


def _torch_in(a, dtype):
    t = torch.from_numpy(np.array(a))
    if a.dtype.kind == "f" and dtype == "bfloat16":
        return t.to(torch.bfloat16)
    return t


def _np_of(v):
    if isinstance(v, torch.Tensor):
        name = str(v.dtype).replace("torch.", "")
        v = v.detach()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy(), name
    a = np.asarray(v)
    name = a.dtype.name
    return (a.astype(np.float32) if name == "bfloat16" else a), name


def _assert_outs_equal(got, want, tol):
    assert sorted(got) == sorted(want)
    for slot in sorted(want):
        g, g_dt = _np_of(got[slot])
        w, w_dt = _np_of(want[slot])
        assert (g.shape, g_dt) == (w.shape, w_dt), slot
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=slot)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cid,op,ins,attrs,grads", FUSED_CASES,
                         ids=[c[0] for c in FUSED_CASES])
def test_fused_op_matches_reference(cid, op, ins, attrs, grads, dtype):
    want = jreg.get_op(op).fn({k: _jax_in(a, dtype) for k, a in ins.items()},
                              dict(attrs))
    got = treg.get_op(op).fn({k: _torch_in(a, dtype)
                              for k, a in ins.items()},
                             dict(attrs, _device=CPU))
    _assert_outs_equal(got, want, 1e-6 if dtype == "float32" else 3e-2)


def test_fused_attention_mixed_input_dtypes_promote_as_the_reference():
    ins, attrs = _attn(_rnd((2, 8, 8), 50), _rnd((2, 8, 8), 51),
                       _rnd((2, 8, 8), 52), head_number=2)
    dts = {"Q": "bfloat16", "K": "float32", "V": "float32"}
    want = jreg.get_op("fused_attention").fn(
        {k: _jax_in(a, dts[k]) for k, a in ins.items()}, attrs)
    got = treg.get_op("fused_attention").fn(
        {k: _torch_in(a, dts[k]) for k, a in ins.items()},
        dict(attrs, _device=CPU))
    # the bf16 query rounds once; the products run in the promoted f32
    _assert_outs_equal(got, want, 1e-6)


@pytest.mark.parametrize("cid,op,ins,attrs,grads",
                         [c for c in FUSED_CASES if c[4]],
                         ids=[c[0] for c in FUSED_CASES if c[4]])
def test_fused_op_gradients_match_reference(cid, op, ins, attrs, grads):
    jfn, tfn = jreg.get_op(op).fn, treg.get_op(op).fn
    outs = jfn({k: jnp.asarray(a) for k, a in ins.items()}, dict(attrs))
    slots = sorted(s for s, v in outs.items()
                   if jnp.issubdtype(v.dtype, jnp.floating))
    cots = {s: _rnd(np.shape(outs[s]), 7) for s in slots}

    def jloss(*xs):
        full = {k: jnp.asarray(a) for k, a in ins.items()}
        full.update(zip(grads, xs))
        o = jfn(full, dict(attrs))
        return sum(jnp.sum(o[s] * cots[s]) for s in slots)

    want = jax.grad(jloss, argnums=tuple(range(len(grads))))(
        *[jnp.asarray(ins[k]) for k in grads])
    full = {k: torch.from_numpy(np.array(a)) for k, a in ins.items()}
    leaves = [full[k].requires_grad_(True) for k in grads]
    o = tfn(full, dict(attrs, _device=CPU))
    loss = sum((o[s] * torch.from_numpy(cots[s])).sum() for s in slots)
    got = torch.autograd.grad(loss, leaves)
    for k, g, w in zip(grads, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_fused_ops_are_registered_with_the_reference_flags():
    for name in tpasses.FUSED_TIER_TYPES:
        mine, ref = treg.get_op(name), jreg.get_op(name)
        assert (mine.needs_rng, mine.stateful) == (ref.needs_rng,
                                                   ref.stateful), name


# ---------------------------------------------------------------------------
# the Executor's train tier against the JAX Executor's
# ---------------------------------------------------------------------------

STEPS = 3
BATCH = 4
TOL = 1e-5
UPDATE_RTOL = 0.1
ZERO_GRAD = ("fc_1.b_0", "fc_1.b_0_adam_0_moment1", "fc_1.b_0_adam_0_moment2")
AMP_FAMILIES = ("bert", "gpt", "resnet")
AMP_LOSS_RTOL = 3e-2
# a parameter element's AMP update is held only where its gradient lies
# farther than AMP_NEAR times the two frameworks' difference from 0 at
# every step: its gradient known to UPDATE_RTOL / 2
AMP_NEAR = 2 / UPDATE_RTOL
# an optimizer op's outputs against the reference's op function on the
# same state and gradient, relative to the step it takes (f32 rounding)
REPLAY_RTOL = 1e-4
_REF = {}
_PORT = {}


def _np_scope(scope):
    return {n: np.asarray(v) for n, v in scope.vars.items() if v is not None}


def _forward_names(program, fetches):
    """The names the forward ops of the AMP + fusion substitute produce
    (fetched beside the loss: fetching them changes no fusion, since
    every one of them survives it)."""
    sub = texecutor.Executor._resolve_train_optimized(
        program, list(fetches), True, True)
    names = []
    for op in sub.global_block().ops[:sub.backward_sections[0].pos]:
        names += [n for n in op.output_names()
                  if n not in names and n not in fetches
                  and not n.endswith("XShape")]
    return names


def _grad_names(program):
    return [n + "@GRAD" for n in sorted(v.name for v in
                                        program.all_parameters())]


def _reference(name, amp):
    """The reference's startup values, per-step fetches (return_numpy
    False: device arrays, their dtypes kept) and final persistables with
    the train tier on: fusion, and AMP when `amp`.  With AMP the fetches
    are the loss, every forward intermediate, then every parameter's
    gradient."""
    key = (name, amp)
    if key not in _REF:
        jm = jzoo.build(name)
        exe = jfluid.Executor(jfluid.CPUPlace())
        scope = jfluid.Scope()
        exe.run(jm.startup, scope=scope)
        start = _np_scope(scope)
        tier = {"FLAGS_amp": "on" if amp else "off",
                "FLAGS_graph_opt_fuse": "on"}
        jfluid.set_flags(tier)
        fluid.set_flags(tier)
        fetch = list(jm.fetches)
        if amp:
            fetch += (_forward_names(tzoo.build(name).main, jm.fetches)
                      + _grad_names(jm.main))
        fetches = [exe.run(jm.main, feed=jm.smoke_feed(BATCH, seed=i),
                           fetch_list=fetch, scope=scope,
                           return_numpy=False) for i in range(STEPS)]
        _REF[key] = (start, fetch, fetches, _np_scope(scope))
    return _REF[key]


def _port_steps(name, start, fetch):
    """The port's STEPS steps from `start`: (model, per-step fetches,
    the persistables after each step)."""
    m = tzoo.build(name)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(start, fluid.Scope(), "cpu")
    fetches, states = [], []
    for i in range(STEPS):
        fetches.append(exe.run(m.main, feed=m.smoke_feed(BATCH, seed=i),
                               fetch_list=fetch, scope=scope,
                               return_numpy=False))
        states.append(interop.scope_to_numpy(scope))
    return m, fetches, states


def _updates(state, start, skip=()):
    return {n: (v.astype(np.float64) - start[n]).ravel()
            for n, v in state.items() if n not in skip}


@pytest.mark.parametrize("name", FAMILIES)
def test_fused_f32_steps_match_the_reference(name):
    start, fetch, want_f, want_state = _reference(name, amp=False)
    m, got_f, states = _port_steps(name, start, fetch)
    got_state = states[-1]
    sub = next(iter(m.main._opt_cache.values()))
    assert sub._train_tier == {"amp": None,
                               "fuse": list(tpasses.FUSION_PIPELINE)}
    for step, (got, want) in enumerate(zip(got_f, want_f)):
        for g, w in zip(got, want):
            g, w = _np_of(g)[0], np.asarray(w)
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=f"step {step}")
    assert set(got_state) == set(want_state)
    skip = ZERO_GRAD if name in ("bert", "gpt") else ()
    d_ref = _updates(want_state, start, skip)
    d_port = _updates(got_state, start, skip)
    for n, d in d_ref.items():
        assert got_state[n].dtype == want_state[n].dtype, n
        assert np.linalg.norm(d_port[n] - d) <= UPDATE_RTOL * \
            np.linalg.norm(d), n


def _amp_runs(name):
    """The reference's AMP + fused run of `name` and the port's from the
    same startup values, each computed once."""
    ref = _reference(name, amp=True)
    if name not in _PORT:
        tier = {"FLAGS_amp": "on", "FLAGS_graph_opt_fuse": "on"}
        jfluid.set_flags(tier)
        fluid.set_flags(tier)
        _PORT[name] = _port_steps(name, ref[0], ref[1])
    return ref, _PORT[name]


def _grads(fetch, fetches):
    """{param: [its gradient at each step]} from per-step fetches."""
    k = len(fetch) - sum(n.endswith("@GRAD") for n in fetch)
    return {n[:-len("@GRAD")]: [_np_of(f[i])[0].astype(np.float64)
                                for f in fetches]
            for i, n in enumerate(fetch) if i >= k}


def _near(g_ref, g_port):
    """Per parameter, the elements whose reference gradient lies within
    AMP_NEAR times the two frameworks' difference of 0 at some step."""
    near = {}
    for n, steps in g_ref.items():
        near[n] = np.zeros(steps[0].shape, bool)
        for w, g in zip(steps, g_port[n]):
            diff = np.abs(g - w)
            near[n] |= (diff > 0) & (np.abs(w) <= AMP_NEAR * diff)
    return near


def _optimizer_ops(program):
    return program.global_block().ops[program.backward_sections[0].pos:]


def _update_faults(m, start, g_port, near, want_state, states):
    """The AMP run's two update rules, each as the persistables it finds
    at fault.

    "replay": every optimizer op, at every step, against the reference's
    registered op function on the port's own state before the step and
    its own gradient: each output within REPLAY_RTOL of the step the
    reference's takes, in norm.  Noise-free (f32 on both sides), so it
    holds every parameter and optimizer state, however noisy its
    gradient.

    "update": each parameter's update over the steps (its value less
    `start`) against the reference's, in norm within UPDATE_RTOL over
    its elements off `near` (the optimizer states follow their
    gradients through the replay); every other persistable (the running
    statistics, the learning rate) over all its elements."""
    opt_ops = _optimizer_ops(m.main)
    held_by_replay = {n for op in opt_ops for slot, names in
                      op.outputs.items() if slot != "ParamOut"
                      for n in names}
    faults = {"replay": [], "update": []}
    for i, after in enumerate(states):
        before = start if i == 0 else states[i - 1]
        for op in opt_ops:
            ins = {slot: jnp.asarray(g_port[names[0][:-len("@GRAD")]][i]
                                     .astype(np.float32)
                                     if slot == "Grad" else before[names[0]])
                   for slot, names in op.inputs.items()}
            outs = jreg.get_op(op.type).fn(ins, dict(op.attrs))
            for slot, names in op.outputs.items():
                n = names[0]
                want = np.asarray(outs[slot], np.float64)
                step = np.linalg.norm(want - before[n])
                off = np.linalg.norm(after[n].astype(np.float64) - want)
                if not off <= REPLAY_RTOL * step and n not in \
                        faults["replay"]:
                    faults["replay"].append(n)
    final = states[-1]
    for n, w in want_state.items():
        if n in held_by_replay or n in ZERO_GRAD:
            continue
        d_ref = w.astype(np.float64) - start[n]
        d_port = final[n].astype(np.float64) - start[n]
        held = ~near[n] if n in near else np.ones(d_ref.shape, bool)
        if not np.linalg.norm((d_port - d_ref)[held]) <= UPDATE_RTOL * \
                np.linalg.norm(d_ref[held]):
            faults["update"].append(n)
    return faults


@pytest.mark.parametrize("name", AMP_FAMILIES)
def test_amp_fused_steps_match_the_reference(name):
    (start, fetch, want_f, want_state), (m, got_f, states) = \
        _amp_runs(name)
    sub = next(iter(m.main._opt_cache.values()))
    assert sub._train_tier["amp"] == "bfloat16" and sub.amp_enabled
    assert len(fetch) > 10
    for step, (got, want) in enumerate(zip(got_f, want_f)):
        for n, g, w in zip(fetch, got, want):
            assert (tuple(g.shape), str(g.dtype).replace("torch.", "")) == (
                tuple(w.shape), str(w.dtype)), (step, n)
        g, w = float(got[0].float().sum()), float(np.asarray(want[0]).sum())
        assert abs(g - w) <= AMP_LOSS_RTOL * abs(w), (step, g, w)
    assert set(states[-1]) == set(want_state)
    g_port = _grads(fetch, got_f)
    near = _near(_grads(fetch, want_f), g_port)
    assert _update_faults(m, start, g_port, near, want_state, states) == {
        "replay": [], "update": []}


@pytest.mark.parametrize("name", AMP_FAMILIES)
def test_amp_update_rules_catch_a_left_out_update(name):
    """A port that leaves one parameter's optimizer op out (the parameter
    and its optimizer state keep their startup values) fails: the replay
    on the parameter whose gradient is the least determined (the most
    elements near 0; in resnet a parameter with every element near),
    and both rules on the one whose gradient is the best determined."""
    (start, fetch, want_f, want_state), (m, got_f, states) = \
        _amp_runs(name)
    g_port = _grads(fetch, got_f)
    near = _near(_grads(fetch, want_f), g_port)
    share = {n: float(v.mean()) for n, v in near.items()
             if n not in ZERO_GRAD}
    noisy, clean = max(share, key=share.get), min(share, key=share.get)
    for leaf, rules in ((noisy, ("replay",)), (clean, ("replay", "update"))):
        op = next(op for op in _optimizer_ops(m.main)
                  if op.inputs["Param"] == [leaf])
        left_out = [dict(s, **{n: start[n] for names in
                               op.outputs.values() for n in names})
                    for s in states]
        faults = _update_faults(m, start, g_port, near, want_state,
                                left_out)
        for rule in rules:
            assert leaf in faults[rule], (leaf, rule, faults)


def test_bare_run_with_default_flags_builds_no_substitute():
    fluid.set_flags({"FLAGS_amp": "train", "FLAGS_graph_opt_fuse": "train"})
    m = tzoo.build("gpt")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    exe.run(m.main, feed=m.smoke_feed(2), fetch_list=m.fetches, scope=scope)
    assert m.main._opt_cache is None
    assert m.main._run_plan_cache.program is m.main
    assert texecutor.Executor._train_tier_modes(m.main, False) == (False,
                                                                   False)
    assert texecutor.Executor._train_tier_modes(m.main, True) == (True, True)
    jm = jzoo.build("gpt")
    assert jexecutor.Executor._train_tier_modes(jm.main, False) == (False,
                                                                    False)


def test_the_substitute_is_cached_and_a_mutation_drops_it():
    fluid.set_flags({"FLAGS_amp": "on", "FLAGS_graph_opt_fuse": "on"})
    m = tzoo.build("mlp")
    tier = texecutor.Executor._resolve_train_optimized
    sub = tier(m.main, [m.loss_name], True, True)
    assert tier(m.main, [m.loss_name], True, True) is sub
    assert tier(m.main, ["x"], True, True) is not sub
    m.main._bump()
    assert tier(m.main, [m.loss_name], True, True) is not sub
    fluid.set_flags({"FLAGS_graph_opt_fuse_disable": "bogus"})
    try:
        with pytest.raises(ValueError, match="unknown fusion pass"):
            tier(m.main, [m.loss_name], False, True)
    finally:
        fluid.set_flags({"FLAGS_graph_opt_fuse_disable": ""})


@pytest.mark.parametrize("name", ["bert", "resnet"])
def test_op_scope_names_of_the_train_loop_are_the_references(name):
    names = {"FLAGS_amp": "train", "FLAGS_graph_opt_fuse": "train"}
    jfluid.set_flags(names)
    fluid.set_flags(names)
    jm, tm = jzoo.build(name), tzoo.build(name)
    for train_loop in (False, True):
        got = texecutor.op_scope_names(tm.main, [tm.loss_name],
                                       train_loop=train_loop)
        want = jexecutor.op_scope_names(jm.main, [jm.loss_name],
                                        train_loop=train_loop)
        assert [(s, op.type, tuple(op.folded_from)) for s, op in got] == [
            (s, op.type, tuple(op.folded_from)) for s, op in want]
    assert any(op.folded_from for _, op in got)
