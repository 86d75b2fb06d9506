"""The port's Program, builders and static optimizers against the JAX
package's.

Each static-zoo family (mlp, lenet, resnet, bert, gpt, seq2seq,
wide_deep, word2vec) is built by the port's builder and by the
reference's, each in its own
`unique_name.guard()` (the builders open one): `Program.to_json()` of the
main and startup programs must be equal byte for byte, `from_json` of
either side must load in the other and serialize to the same bytes,
`clone(for_test=True)` and `_prune` must agree, and so must
`op_types()`.  No tolerance: the comparisons are of bytes.

Also here: the initializers' startup ops, `append_backward` /
`gradients` against the reference's, the Programs the regularizers, the
gradient clips, `WeightNormParamAttr`, `fc` over several inputs and the
Variable operators build, the optimizer names (the static classes at the
top level, the functional ones under `functional`), and the
NotImplementedError of every reference name the port does not have yet,
each naming a ROADMAP item.

Those Programs also run: the reference's startup in JAX seeds the port's
scope (`interop.scope_from_numpy`), then both Executors take the same 3
steps on the same seeded numpy feeds.  Fetches and persistables agree
within atol = rtol = 1e-5 (SGD, Momentum), or atol 2 lr k + 1e-5 for
Adagrad, whose first update is about lr * sign(g) as Adam's is (the rule
of tests/test_torch_static_zoo.py).  Each clip is shown to engage: its
fetched factor or clipped gradient differs from the raw one, and agrees
with the reference's.  The initializers' startup programs run too: the
constant and numpy ones give the reference's values exactly, the random
ones its shape, dtype and moments.
"""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import static_zoo as jzoo
from paddle_tpu.optimizer import functional as jfunctional

import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch import layers as L
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.models import static_zoo as tzoo
from torch_threads import torch_threads  # noqa: F401

FAMILIES = ("mlp", "lenet", "resnet", "bert", "gpt", "seq2seq",
            "wide_deep", "word2vec")
REPO = pathlib.Path(__file__).resolve().parents[1]


def _pair(name):
    return jzoo.build(name), tzoo.build(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_builders_serialize_to_the_reference_bytes(name):
    jm, tm = _pair(name)
    assert tm.main.to_json() == jm.main.to_json()
    assert tm.startup.to_json() == jm.startup.to_json()
    assert tm.op_types() == jm.op_types()
    assert (tm.feeds, tm.fetches, tm.loss_name) == (jm.feeds, jm.fetches,
                                                    jm.loss_name)
    # hermetic: a second build is byte-identical
    assert tzoo.build(name).main.to_json() == tm.main.to_json()


@pytest.mark.parametrize("name", FAMILIES)
def test_from_json_round_trips_both_ways(name):
    jm, tm = _pair(name)
    for prog in ("main", "startup"):
        ref_text = getattr(jm, prog).to_json()
        port_text = getattr(tm, prog).to_json()
        assert fluid.Program.from_json(ref_text).to_json() == ref_text
        assert jfluid.Program.from_json(port_text).to_json() == port_text
        loaded = fluid.Program.from_json(ref_text)
        assert [op.type for op in loaded.global_block().ops] == [
            op.type for op in getattr(jm, prog).global_block().ops]


@pytest.mark.parametrize("name", FAMILIES)
def test_clone_for_test_and_prune_agree(name):
    jm, tm = _pair(name)
    assert tm.main.clone(for_test=True).to_json() == \
        jm.main.clone(for_test=True).to_json()
    assert tm.main.clone().to_json() == jm.main.clone().to_json()
    assert tm.main._prune(tm.fetches).to_json() == \
        jm.main._prune(jm.fetches).to_json()


def _build_fc(pkg, init):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 6])
        pkg.layers.fc(x, 4, param_attr=pkg.ParamAttr(initializer=init),
                      bias_attr=pkg.ParamAttr(
                          initializer=pkg.initializer.Constant(0.5)))
    return main, startup


INITIALIZERS = [
    ("Constant", (0.25,)), ("Uniform", (-0.5, 0.5, 3)),
    ("Normal", (0.0, 0.02, 1)), ("TruncatedNormal", (0.1, 0.2, 2)),
    ("Xavier", ()), ("MSRA", (False,)), ("NumpyArrayInitializer", None),
]


@pytest.mark.parametrize("kind,args", INITIALIZERS)
def test_initializers_emit_the_reference_startup_ops(kind, args):
    def make(pkg):
        cls = getattr(pkg.initializer, kind)
        if args is None:
            return cls(np.arange(24, dtype=np.float32).reshape(6, 4))
        return cls(*args)

    jmain, jstart = _build_fc(jfluid, make(jfluid))
    tmain, tstart = _build_fc(fluid, make(fluid))
    assert tstart.to_json() == jstart.to_json()
    assert tmain.to_json() == jmain.to_json()


def _backward_programs(pkg, use_gradients):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 5])
        h = pkg.layers.fc(x, 3, act="relu")
        loss = pkg.layers.mean(h)
        if use_gradients:
            pkg.gradients([loss], [x])
        else:
            pkg.append_backward(loss)
    return main


@pytest.mark.parametrize("use_gradients", [False, True])
def test_backward_sections_and_grad_vars_match(use_gradients):
    j = _backward_programs(jfluid, use_gradients)
    t = _backward_programs(fluid, use_gradients)
    assert t.to_json() == j.to_json()
    sec = t.backward_sections[0]
    assert all(n + "@GRAD" in t.global_block().vars for n in sec.param_names)


def _several_targets(pkg, weighted):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 5])
        a = pkg.layers.fc(x, 3, act="tanh")
        b = pkg.layers.mean(pkg.layers.relu(x))
        tg = [pkg.layers.fill_constant([1], "float32", 0.5), None] \
            if weighted else None
        grads = pkg.gradients([a, b], [x], target_gradients=tg)
    return main, startup, grads


@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_of_several_targets_build_the_reference_program(weighted):
    """d(sum_i <target_i, target_gradients_i or 1>) / d(inputs): the
    elementwise_mul, reduce_sum and sum ops of the reference, under its
    var names."""
    jmain, _, _ = _several_targets(jfluid, weighted)
    tmain, _, (g,) = _several_targets(fluid, weighted)
    assert tmain.to_json() == jmain.to_json()
    assert g.name == "x@GRAD"
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("reduce_sum") == 2 and types[-1] == "sum"
    assert types.count("elementwise_mul") == int(weighted)


def test_optimizer_names_follow_the_reference():
    assert topt.Adam is not topt.functional.Adam
    assert issubclass(topt.Adam, topt.Optimizer)
    assert issubclass(topt.SGD, topt.Optimizer)
    assert issubclass(topt.Momentum, topt.Optimizer)
    assert issubclass(topt.AdamW, topt.Adam)
    assert issubclass(topt.functional.Adam, topt.functional.FunctionalOptimizer)
    assert topt.SGDOptimizer is topt.SGD and topt.AdamOptimizer is topt.Adam
    # the reference's own split: static at the top, functional beneath
    assert jfluid.optimizer.Adam is not jfunctional.Adam
    for name in ("SGD", "Momentum", "Adam", "AdamW"):
        assert hasattr(jfunctional, name) and hasattr(topt.functional, name)


@pytest.mark.parametrize("name,item", [
    ("DGCMomentumOptimizer", "8"), ("PipelineOptimizer", "8"),
    ("Adamax", "10"), ("LarsMomentum", "10"), ("RMSProp", "10"),
    ("Lamb", "10"), ("Ftrl", "10"), ("ModelAverage", "10"),
])
def test_unported_optimizers_raise_naming_their_item(name, item):
    if name in ITEM_8_OPTIMIZERS:
        # ported with item 8's static DGC and pipeline optimizers: the
        # names construct as the reference's do
        cls = getattr(topt, name)
        assert cls.__name__ == getattr(jfluid.optimizer, name).__name__
        opt = (cls(0.1, 0.9, rampup_begin_step=1)
               if name == "DGCMomentumOptimizer" else cls(topt.SGD(0.1)))
        assert callable(opt.minimize)
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        getattr(topt, name)(0.1)


ITEM_8_OPTIMIZERS = ("DGCMomentumOptimizer", "PipelineOptimizer")


def _clip_decay_program(pkg, clip, decay, param_decay, opt):
    """fc -> fc regression; `clip` and `decay` are (class name, args) of
    pkg.clip / pkg.regularizer, `param_decay` a regularizer on the first
    fc's weight, `opt` (class name, args) of pkg.optimizer."""
    def make(mod, spec):
        return None if spec is None else getattr(mod, spec[0])(*spec[1])

    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 6])
        y = pkg.data("y", [None, 1])
        h = pkg.layers.fc(x, 8, act="relu", param_attr=pkg.ParamAttr(
            regularizer=make(pkg.regularizer, param_decay)))
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            pkg.layers.fc(h, 1), y))
        getattr(pkg.optimizer, opt[0])(
            *opt[1], regularization=make(pkg.regularizer, decay),
            grad_clip=make(pkg.clip, clip)).minimize(loss)
    return main, startup, loss


CLIP_DECAY = {
    "l2_decay": (None, ("L2Decay", (1e-2,)), None, ("SGD", (0.1,))),
    "l1_param_decay": (None, None, ("L1Decay", (1e-2,)), ("SGD", (0.1,))),
    "param_over_optimizer_decay": (None, ("L2Decay", (1e-2,)),
                                   ("L1Decay", (5e-3,)),
                                   ("Momentum", (0.1, 0.9))),
    "clip_by_value": (("GradientClipByValue", (0.05,)), None, None,
                      ("SGD", (0.1,))),
    "clip_by_norm": (("GradientClipByNorm", (0.1,)), None, None,
                     ("Momentum", (0.1, 0.9))),
    "clip_by_global_norm": (("GradientClipByGlobalNorm", (0.1,)),
                            ("L2Decay", (1e-2,)), None,
                            ("Momentum", (0.1, 0.9))),
    "adagrad_clip_decay": (("GradientClipByGlobalNorm", (0.1,)),
                           ("L1Decay", (1e-3,)), None, ("Adagrad", (0.1,))),
}


@pytest.mark.parametrize("name", list(CLIP_DECAY))
def test_regularizers_and_clips_build_the_reference_program(name):
    """Clip first, then decay (the reference's order); the parameter's
    own regularizer over the optimizer's."""
    j = _clip_decay_program(jfluid, *CLIP_DECAY[name])
    t = _clip_decay_program(fluid, *CLIP_DECAY[name])
    assert t[0].to_json() == j[0].to_json()
    assert t[1].to_json() == j[1].to_json()
    types = [op.type for op in t[0].global_block().ops]
    clip, decay, param_decay, _ = CLIP_DECAY[name]
    if clip is not None:
        first = {"GradientClipByValue": "clip",
                 "GradientClipByNorm": "clip_by_norm",
                 "GradientClipByGlobalNorm": "squared_l2_norm"}[clip[0]]
        assert types.index(first) < types.index("scale") \
            if decay or param_decay else first in types
    # one sign op per parameter under L1: the first weight's own
    # regularizer, else the optimizer's; the optimizer's on the other 3
    first_w = param_decay or decay
    assert types.count("sign") == \
        (first_w is not None and first_w[0] == "L1Decay") \
        + 3 * (decay is not None and decay[0] == "L1Decay")


def test_set_gradient_clip_is_global_until_reset():
    """The module-global clip reaches every optimizer built while it is
    set, in both packages, and is gone once reset."""
    def build(pkg):
        return _clip_decay_program(pkg, None, None, None,
                                   ("SGD", (0.1,)))[0]

    for pkg in (jfluid, fluid):
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(1.0))
        try:
            assert isinstance(pkg.clip.get_gradient_clip(),
                              pkg.clip.GradientClipByGlobalNorm)
            clipped = build(pkg)
        finally:
            pkg.clip.set_gradient_clip(None)
        assert pkg.clip.get_gradient_clip() is None
        assert "squared_l2_norm" in [op.type for op in
                                     clipped.global_block().ops]
        assert "squared_l2_norm" not in [op.type for op in
                                         build(pkg).global_block().ops]
    fluid.clip.set_gradient_clip(fluid.clip.GradientClipByNorm(0.5))
    jfluid.clip.set_gradient_clip(jfluid.clip.GradientClipByNorm(0.5))
    try:
        assert build(fluid).to_json() == build(jfluid).to_json()
    finally:
        fluid.clip.set_gradient_clip(None)
        jfluid.clip.set_gradient_clip(None)


def _weight_norm_program(pkg, dim):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 6])
        h = pkg.layers.fc(x, 4, param_attr=pkg.WeightNormParamAttr(
            dim=dim, name="wn"))
        loss = pkg.layers.mean(pkg.layers.square(h))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup


@pytest.mark.parametrize("dim", [None, 1, -2])
def test_weight_norm_param_attr_builds_the_reference_program(dim):
    jmain, jstart = _weight_norm_program(jfluid, dim)
    tmain, tstart = _weight_norm_program(fluid, dim)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    params = {p.name for p in tmain.all_parameters()}
    assert {"wn_v", "wn_g"} <= params


def _two_input_fc(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        a = pkg.data("a", [None, 3])
        b = pkg.data("b", [None, 5])
        pkg.layers.fc([a, b], 4, act="sigmoid")
    return main, startup


def test_fc_over_two_inputs_adds_with_the_sum_op():
    jmain, jstart = _two_input_fc(jfluid)
    tmain, tstart = _two_input_fc(fluid)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    assert [op.type for op in tmain.global_block().ops] == [
        "mul", "mul", "sum", "elementwise_add", "sigmoid"]


def test_unported_layer_names_raise_naming_their_items():
    ported = set(L.__all__)
    missing = sorted(n for n in dir(jfluid.layers)
                     if not n.startswith("_") and n not in ported
                     and callable(getattr(jfluid.layers, n)))
    # rnn, extended, sequence, detection and distributions: every name
    # of the reference's nn, tensor, loss, metric_op, control_flow and
    # learning_rate_scheduler resolves (the 27 names of the last two
    # came with the control-flow slice)
    assert len(missing) == 168
    for mod in (jfluid.layers.nn, jfluid.layers.tensor, jfluid.layers.loss,
                jfluid.layers.metric_op, jfluid.layers.control_flow,
                jfluid.layers.learning_rate_scheduler):
        assert set(mod.__all__) <= ported, set(mod.__all__) - ported
    for n in missing:
        with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
            getattr(L, n)
    assert not hasattr(L, "__wrapped__")
    for n in ported:
        assert callable(getattr(L, n))


@pytest.mark.parametrize("name", FAMILIES)
def test_partition_rules_raise_naming_item_8(name):
    # the default partition rules came with the sharding tier: each
    # family's are the reference's, document and fingerprint
    assert set(tzoo.BUILDERS) == set(jzoo.BUILDERS) == set(FAMILIES)
    tm, jm = tzoo.build(name), jzoo.build(name)
    assert tm.sharding_rules == jm.sharding_rules
    assert tm.partition_rules().to_dict() == jm.partition_rules().to_dict()
    assert tm.partition_rules().fingerprint() \
        == jm.partition_rules().fingerprint()


def test_compiled_program_and_control_flow_raise_naming_their_items():
    # CompiledProgram and BuildStrategy are ported (item 8's data-parallel
    # step and GSPMD tier); a bf16 precision policy raises naming its item
    prog = fluid.framework.CompiledProgram(
        fluid.Program(), build_strategy=fluid.framework.BuildStrategy())
    assert prog.with_data_parallel(places=2)._is_data_parallel
    assert fluid.CompiledProgram is fluid.framework.CompiledProgram
    # item 8's rest is done: no message of the port names 8.2 or 8.5
    items = re.compile(r"item 8\.[25]\b")
    for path in [REPO / "chip_smoke.py",
                 *sorted((REPO / "paddle_tpu_torch").rglob("*.py"))]:
        assert not items.search(path.read_text()), path
    from paddle_tpu_torch.framework import compiler as tcompiler

    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        tcompiler.apply_precision_policy(lambda: None, "bfloat16")
    # the control-flow ops and the dataset loop run (the control-flow
    # slice of item 10); the elastic loop still raises naming its item
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 2])
        i = L.fill_constant([1], "float32", 0.0)
        three = L.fill_constant([1], "float32", 3.0)
        _, w = L.while_loop(lambda i, v: L.less_than(i, three),
                            lambda i, v: [i + 1.0, L.scale(v, scale=2.0)],
                            [i, x])
        loss = L.mean(L.fc(w, 1))
        fluid.optimizer.SGD(0.01).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 2), np.float32)}
    (out,) = exe.run(main.clone(for_test=True), feed=feed, fetch_list=[w],
                     scope=scope)
    assert np.array_equal(out, np.full((2, 2), 8.0, np.float32))
    last = exe.train_from_dataset(main, [feed] * 3, scope=scope,
                                  fetch_list=[loss], print_period=10 ** 6)
    assert np.isfinite(last[0]).all()
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        exe.train_from_dataset(main, [feed], scope=scope, elastic=object())


def test_callsite_names_the_caller_not_the_port():
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.data("x", [None, 3])
        L.relu(x)
    site = main.global_block().ops[0].callsite
    assert site is not None and "test_torch_static_program.py" in site
    assert tprogram._PKG_DIR.endswith("paddle_tpu_torch/")


def _operators(pkg):
    main = pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, pkg.Program()):
        x = pkg.data("x", [None, 3])
        y = pkg.data("y", [None, 3])
        _ = (x + y, x - y, x * y, x / y, x + 1.0, 1.0 + x, x - 2.0, 2.0 - x,
             x * 3.0, 3.0 * x, x / 4.0, -x, x @ y)
        tensor = pkg.layers.tensor
        for op in ("elementwise_max", "elementwise_min", "elementwise_pow",
                   "elementwise_mod", "elementwise_floordiv"):
            tensor.elementwise_op_with_scalar(x, 2.0, op)
            tensor.elementwise_op_with_scalar(x, 2.0, op, reverse=True)
            tensor.elementwise_op_with_scalar(x, y, op, reverse=True)
        tensor.elementwise_op_with_scalar(x, 2.0, "elementwise_div",
                                          reverse=True)
    return main


def test_variable_operator_sugar_uses_the_ported_ops():
    t = _operators(fluid)
    assert t.to_json() == _operators(jfluid).to_json()
    types = [op.type for op in t.global_block().ops]
    assert types[:13] == [
        "elementwise_add", "elementwise_sub", "elementwise_mul",
        "elementwise_div", "scale", "scale", "scale", "scale", "scale",
        "scale", "scale", "scale", "matmul"]
    assert "fill_constant" in types and "elementwise_mod" in types


def test_no_port_module_names_item_3_and_none_imports_jax():
    """Item 3 is done: no message of the port still names it.  The port
    and chip_smoke.py import neither jax nor paddle_tpu, also after
    building all eight families and their clip, decay and weight-norm
    programs."""
    for path in sorted((REPO / "paddle_tpu_torch").rglob("*.py")):
        assert "ROADMAP item 3" not in path.read_text(), path
    for path in [REPO / "chip_smoke.py",
                 *sorted((REPO / "paddle_tpu_torch").rglob("*.py"))]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            assert not {n.split(".")[0] for n in names} & {
                "jax", "jaxlib", "paddle_tpu"}, (path, names)
    code = (
        "import sys\n"
        "import paddle_tpu_torch as fluid\n"
        "from paddle_tpu_torch.models import static_zoo\n"
        "import paddle_tpu_torch.ops.rnn_ops\n"
        "static_zoo.build_all()\n"
        "with fluid.program_guard(fluid.Program(), fluid.Program()):\n"
        "    x = fluid.data('x', [None, 4])\n"
        "    h = fluid.layers.fc(x, 2, param_attr=fluid.WeightNormParamAttr("
        "dim=0, regularizer=fluid.regularizer.L1Decay(0.1)))\n"
        "    fluid.optimizer.Adagrad(0.1, grad_clip=fluid.clip."
        "GradientClipByGlobalNorm(1.0)).minimize(fluid.layers.mean(h))\n"
        "import paddle_tpu_torch.layers.control_flow\n"
        "import paddle_tpu_torch.layers.learning_rate_scheduler\n"
        "import paddle_tpu_torch.datasets, paddle_tpu_torch.dataset\n"
        "import paddle_tpu_torch.datasets.multislot\n"
        "import paddle_tpu_torch.incubate.data_generator\n"
        "import paddle_tpu_torch.resilience, paddle_tpu_torch.trainer_factory\n"
        "import paddle_tpu_torch.data_feed_desc\n"
        "with fluid.program_guard(fluid.Program(), fluid.Program()):\n"
        "    i = fluid.layers.fill_constant([1], 'int64', 0)\n"
        "    fluid.layers.cond(fluid.layers.less_than(i, i), lambda: i,\n"
        "                      lambda: i)\n"
        "    fluid.optimizer.Adam(fluid.layers.noam_decay(8, 2))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu', 'triton'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_port_module_names_item_9():
    """Item 9 is done: the serving runtime, bucketing, the watchdog, the
    breaker, retry, fault injection, the decode engine's per-token
    deadlines, request tracing, the flight recorder, the serving
    counters and the fleet tier are ported, and no message of the port
    or of chip_smoke.py names the item."""
    for path in [REPO / "chip_smoke.py",
                 *sorted((REPO / "paddle_tpu_torch").rglob("*.py"))]:
        assert not re.search(r"item 9\b", path.read_text()), path


@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.serving", "paddle_tpu_torch.monitor",
    "paddle_tpu_torch.resilience"])
def test_serving_tier_imports_neither_jax_nor_triton(module):
    """The serving tier's packages import neither jax, paddle_tpu nor
    triton, also after a runtime, a decode engine and a router are
    built."""
    code = (
        "import sys\n"
        f"import {module}\n"
        "import paddle_tpu_torch.serving as s, paddle_tpu_torch.monitor\n"
        "s.FleetRouter([], label='imp', auto_poll=False)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu', 'triton'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_port_module_names_item_6_or_item_5():
    """Items 6 (the conv path's rest, the recompute) and 5 (beam search)
    are done: no message of the port names them.  GPT MoE, and with it
    item 5's MoE decode, came with item 8's first part.  Item 8 is done
    too: the static data-parallel step (8.1), the GSPMD tier with the
    rule meshes of the sharding analyzer (8.2), the static DGC and
    pipeline optimizers (8.3), the parameter server (8.4) and an
    explicit device list (8.5); no message names them, the rule meshes'
    keys are made and a device list shorter than its mesh raises the
    reference's ValueError."""
    items = re.compile(r"item [56]\b|item 8\.[12345]\b")
    for path in [REPO / "chip_smoke.py",
                 *sorted((REPO / "paddle_tpu_torch").rglob("*.py"))]:
        assert not items.search(path.read_text()), path
    from paddle_tpu_torch.distributed import inprocess
    from paddle_tpu_torch.distributed import mesh as tmesh

    ranks = inprocess.local_meshes(axes={"dp": 1, "mp": 2}, device="cpu")
    assert tmesh.mesh_key(ranks)[:2] == (("dp", "mp"), (1, 2))
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.build_mesh(tp=2, devices=["cpu"])


def test_no_port_module_names_item_4_and_the_tier_imports_no_jax():
    """Item 4 (AMP and the fusion tier) is done: no message of the port
    still names it.  Its modules (amp/, analysis/, passes/, resilience/,
    ops/fused_ops.py) import neither jax, jaxlib nor paddle_tpu, also
    after the AMP rewrite and the fusion of every family and a run of
    the tier's Executor path."""
    item_4 = re.compile(r"item 4\b")
    for path in sorted((REPO / "paddle_tpu_torch").rglob("*.py")):
        assert not item_4.search(path.read_text()), path
    code = (
        "import sys\n"
        "import paddle_tpu_torch as fluid\n"
        "from paddle_tpu_torch import amp, analysis, passes, resilience\n"
        "from paddle_tpu_torch.ops import fused_ops\n"
        "from paddle_tpu_torch.models import static_zoo\n"
        "for name in sorted(static_zoo.BUILDERS):\n"
        "    m = static_zoo.build(name)\n"
        "    p = amp.rewrite_train_program(m.main.clone())\n"
        "    passes.fuse_program(p, fetch_names=[m.loss_name])\n"
        "fluid.set_flags({'FLAGS_amp': 'on', 'FLAGS_graph_opt_fuse': 'on'})\n"
        "m = static_zoo.build('gpt')\n"
        "exe = fluid.Executor(fluid.CPUPlace())\n"
        "sc = fluid.Scope()\n"
        "exe.run(m.startup, scope=sc)\n"
        "exe.run(m.main, feed=m.smoke_feed(2), fetch_list=m.fetches, "
        "scope=sc)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu', 'triton'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------------
# the Programs above, run against the JAX Executor
# ---------------------------------------------------------------------------

STEPS = 3
TOL = 1e-5


def _np_scope(scope):
    return {n: np.asarray(v) for n, v in scope.vars.items()
            if v is not None}


def _run_pair(jprogs, tprogs, feeds, fetches, sign_lr=None):
    """3 steps of the reference's (main, startup) and the port's from the
    reference's startup values; compares fetches and persistables and
    returns (port fetches per step, port persistables, startup)."""
    (jmain, jstart), (tmain, tstart) = jprogs, tprogs
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    start = _np_scope(jscope)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = interop.scope_from_numpy(start, fluid.Scope(), "cpu")
    got_all = []
    for i, feed in enumerate(feeds):
        want = jexe.run(jmain, feed=feed, fetch_list=fetches, scope=jscope)
        got = exe.run(tmain, feed=feed, fetch_list=fetches, scope=scope)
        for g, w, n in zip(got, want, fetches):
            assert g.shape == np.shape(w), (i, n)
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL,
                                       err_msg=f"step {i} fetch {n}")
        got_all.append(got)
    atol = TOL if sign_lr is None else 2 * sign_lr * len(feeds) + TOL
    got_state = interop.scope_to_numpy(scope)
    want_state = _np_scope(jscope)
    assert set(got_state) == set(want_state)
    for n, w in want_state.items():
        assert got_state[n].dtype == w.dtype, n
        np.testing.assert_allclose(got_state[n], w, atol=atol, rtol=TOL,
                                   err_msg=n)
        # the update in norm (the zoo's rule), which the sign rule's atol
        # cannot see
        d_ref = w.astype(np.float64) - start[n]
        d_port = got_state[n].astype(np.float64) - start[n]
        assert np.linalg.norm(d_port - d_ref) <= 0.1 * np.linalg.norm(
            d_ref), n
    return got_all, got_state, start


def _reg_feeds(seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((8, 6)).astype(np.float32),
             "y": rng.standard_normal((8, 1)).astype(np.float32)}
            for _ in range(STEPS)]


def _after_backward(main, op_type):
    """The outputs of the ops of `op_type` after the backward section."""
    pos = main.backward_sections[0].pos
    return [op.outputs["Out"][0] for op in main.global_block().ops[pos:]
            if op.type == op_type]


@pytest.mark.parametrize("name", list(CLIP_DECAY))
def test_regularizers_and_clips_run_as_the_reference(name):
    clip, _, _, opt = CLIP_DECAY[name]
    j = _clip_decay_program(jfluid, *CLIP_DECAY[name])
    t = _clip_decay_program(fluid, *CLIP_DECAY[name])
    fetches = [t[2].name]
    if clip is not None and clip[0] == "GradientClipByGlobalNorm":
        norm = _after_backward(t[0], "sqrt")[0]
        factor = _after_backward(t[0], "elementwise_div")[0]
        fetches += [norm, factor]
    elif clip is not None:
        kind = "clip" if clip[0] == "GradientClipByValue" else "clip_by_norm"
        fetches += ["fc_0.w_0@GRAD", _after_backward(t[0], kind)[0]]
    got, _, _ = _run_pair(j[:2], t[:2], _reg_feeds(), fetches,
                          sign_lr=0.1 if opt[0] == "Adagrad" else None)
    if clip is None:
        return
    for step in got:
        if clip[0] == "GradientClipByGlobalNorm":
            _, norm, factor = step
            # engaged: the factor is clip_norm / norm < 1
            assert norm.item() > clip[1][0]
            np.testing.assert_allclose(factor, clip[1][0] / norm,
                                       rtol=1e-6)
        else:
            _, raw, clipped = step
            assert not np.allclose(raw, clipped)
            if clip[0] == "GradientClipByValue":
                np.testing.assert_array_equal(
                    clipped, np.clip(raw, -clip[1][0], clip[1][0]))
            else:
                np.testing.assert_allclose(np.linalg.norm(clipped),
                                           clip[1][0], rtol=1e-5)


def test_global_clip_runs_as_the_reference():
    """set_gradient_clip reaches the optimizer; under SGD the update is
    the clipped gradient's."""
    progs = {}
    for pkg in (jfluid, fluid):
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(0.05))
        try:
            progs[pkg] = _clip_decay_program(pkg, None, None, None,
                                             ("SGD", (0.1,)))
        finally:
            pkg.clip.set_gradient_clip(None)
    factor = _after_backward(progs[fluid][0], "elementwise_div")[0]
    got, _, _ = _run_pair(progs[jfluid][:2], progs[fluid][:2], _reg_feeds(1),
                          [progs[fluid][2].name, factor])
    assert all(f.item() < 1.0 for _, f in got)


@pytest.mark.parametrize("dim", [None, 1, -2])
def test_weight_norm_runs_as_the_reference(dim):
    jprogs = _weight_norm_program(jfluid, dim)
    tprogs = _weight_norm_program(fluid, dim)
    feeds = [{"x": f["x"]} for f in _reg_feeds(2)]
    _, state, start = _run_pair(jprogs, tprogs, feeds, [])
    # the startup sets g to ||v||, so the first effective weight is v
    v = start["wn_v"]
    axes = tuple(a for a in range(2) if dim is None or a != dim % 2)
    np.testing.assert_allclose(
        start["wn_g"], np.sqrt((v * v).sum(axis=axes, keepdims=True)),
        rtol=1e-6)
    assert not np.allclose(state["wn_g"], start["wn_g"])


def test_fc_over_two_inputs_runs_as_the_reference():
    def build(pkg):
        main, startup = _two_input_fc(pkg)
        with pkg.program_guard(main, startup):
            out = main.global_block().var("fc_0.tmp_3")
            loss = pkg.layers.mean(out)
            pkg.optimizer.Momentum(0.1, 0.9).minimize(loss)
        return (main, startup), loss.name

    (jprogs, _), (tprogs, loss) = build(jfluid), build(fluid)
    rng = np.random.default_rng(3)
    feeds = [{"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((4, 5)).astype(np.float32)}
             for _ in range(STEPS)]
    _run_pair(jprogs, tprogs, feeds, [loss])


def test_variable_operators_run_as_the_reference():
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [None, 3])
            y = pkg.data("y", [None, 3])
            tensor = pkg.layers.tensor
            outs = [x + y, x - y, x * y, x / y, 1.0 + x, 2.0 - x, 3.0 * x,
                    x / 4.0, -x, x @ pkg.layers.transpose(y, [1, 0])]
            for op in ("elementwise_max", "elementwise_min",
                       "elementwise_pow", "elementwise_mod",
                       "elementwise_floordiv", "elementwise_div"):
                outs.append(tensor.elementwise_op_with_scalar(
                    x, 2.0, op, reverse=True))
                outs.append(tensor.elementwise_op_with_scalar(x, y, op))
        return (main, startup), [o.name for o in outs]

    (jprogs, names), (tprogs, tnames) = build(jfluid), build(fluid)
    assert names == tnames
    rng = np.random.default_rng(4)
    feed = {"x": (np.abs(rng.standard_normal((4, 3))) + 0.5).astype(
        np.float32),
        "y": (np.abs(rng.standard_normal((4, 3))) + 0.5).astype(np.float32)}
    _run_pair(jprogs, tprogs, [feed], names)


@pytest.mark.parametrize("weighted", [False, True])
def test_gradients_of_several_targets_run_as_the_reference(weighted):
    jmain, jstart, (jg,) = _several_targets(jfluid, weighted)
    tmain, tstart, (tg,) = _several_targets(fluid, weighted)
    x = np.random.default_rng(5).standard_normal((4, 5)).astype(np.float32)
    got, _, _ = _run_pair((jmain, jstart), (tmain, tstart), [{"x": x}],
                          [tg.name])
    assert got[0][0].shape == (4, 5)


@pytest.mark.parametrize("kind,args", INITIALIZERS)
def test_initializers_startup_runs(kind, args):
    """Each initializer's startup program on the port's Executor: the
    constant and numpy initializers give the reference's values; the
    random ones its shapes and dtypes, their range and moments, and the
    same values again from a generator of the same seed."""
    def make(pkg):
        cls = getattr(pkg.initializer, kind)
        if args is None:
            return cls(np.arange(24, dtype=np.float32).reshape(6, 4))
        return cls(*args)

    _, jstart = _build_fc(jfluid, make(jfluid))
    _, tstart = _build_fc(fluid, make(fluid))
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    want = _np_scope(jscope)

    def run():
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(tstart, scope=scope)
        return interop.scope_to_numpy(scope)

    got = run()
    assert set(got) == set(want) == {"fc_0.w_0", "fc_0.b_0"}
    np.testing.assert_array_equal(got["fc_0.b_0"], want["fc_0.b_0"])
    g, w = got["fc_0.w_0"], want["fc_0.w_0"]
    assert g.shape == w.shape == (6, 4) and g.dtype == w.dtype
    if kind in ("Constant", "NumpyArrayInitializer"):
        np.testing.assert_array_equal(g, w)
        return
    np.testing.assert_array_equal(run()["fc_0.w_0"], g)
    if kind == "Uniform":
        assert g.min() >= -0.5 and g.max() <= 0.5
    elif kind == "TruncatedNormal":
        assert np.all(np.abs(g - 0.1) <= 2 * 0.2 * (1 + 1e-2))
    elif kind == "Xavier":
        limit = np.sqrt(6.0 / (6 + 4))
        assert np.abs(g).max() <= limit
    # 24 draws: means within 4 standard errors of the reference's law
    std = {"Uniform": 1 / np.sqrt(3) * 0.5, "Normal": 0.02,
           "TruncatedNormal": 0.2 * 0.8796, "Xavier": np.sqrt(2.0 / 10),
           "MSRA": np.sqrt(2.0 / 6)}[kind]
    mean = 0.1 if kind == "TruncatedNormal" else 0.0
    assert abs(g.mean() - mean) <= 4 * std / np.sqrt(24)
    assert abs(w.mean() - mean) <= 4 * std / np.sqrt(24)
