"""The port's Program, builders and static optimizers against the JAX
package's.

Each ported static-zoo family (mlp, lenet, resnet, bert, gpt, word2vec)
is built by the port's builder and by the reference's, each in its own
`unique_name.guard()` (the builders open one): `Program.to_json()` of the
main and startup programs must be equal byte for byte, `from_json` of
either side must load in the other and serialize to the same bytes,
`clone(for_test=True)` and `_prune` must agree, and so must
`op_types()`.  No tolerance: the comparisons are of bytes.

Also here: the initializers' startup ops, `append_backward` /
`gradients` against the reference's, the optimizer names (the static
classes at the top level, the functional ones under `functional`), and
the NotImplementedError of every reference name the port does not have
yet, each naming a ROADMAP item.
"""

import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import static_zoo as jzoo
from paddle_tpu.optimizer import functional as jfunctional

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers as L
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.models import static_zoo as tzoo

FAMILIES = ("mlp", "lenet", "resnet", "bert", "gpt", "word2vec")


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


@pytest.mark.parametrize("kind,args", [
    ("Constant", (0.25,)), ("Uniform", (-0.5, 0.5, 3)),
    ("Normal", (0.0, 0.02, 1)), ("TruncatedNormal", (0.1, 0.2, 2)),
    ("Xavier", ()), ("MSRA", (False,)), ("NumpyArrayInitializer", None),
])
def test_initializers_emit_the_reference_startup_ops(kind, args):
    import numpy as np

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


def test_gradients_of_several_targets_raises_naming_its_item():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 5])
        a, b = L.mean(x), L.mean(L.relu(x))
        with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
            fluid.gradients([a, b], [x])


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
    ("Adagrad", "3"), ("LarsMomentum", "10"), ("RMSProp", "10"),
    ("Lamb", "10"), ("RecomputeOptimizer", "10"), ("ModelAverage", "10"),
])
def test_unported_optimizers_raise_naming_their_item(name, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        getattr(topt, name)(0.1)


def test_regularization_and_grad_clip_raise_naming_item_3():
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        topt.SGD(0.1, regularization=object())
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        topt.Adam(0.1, grad_clip=object())
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 5])
        loss = L.mean(L.fc(x, 2, param_attr=fluid.ParamAttr(
            regularizer=object())))
        with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
            topt.SGD(0.1).minimize(loss)


def test_unported_layer_names_raise_naming_their_items():
    ported = set(L.__all__)
    missing = sorted(n for n in dir(jfluid.layers)
                     if not n.startswith("_") and n not in ported
                     and callable(getattr(jfluid.layers, n)))
    assert len(missing) > 100
    for n in missing:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP item 3.*item 10"):
            getattr(L, n)
    assert not hasattr(L, "__wrapped__")
    for n in ported:
        assert callable(getattr(L, n))


@pytest.mark.parametrize("name", ["seq2seq", "wide_deep"])
def test_unported_families_raise_naming_item_3(name):
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        tzoo.build(name)
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        tzoo.build("mlp").partition_rules()


def test_compiled_program_and_control_flow_raise_naming_their_items():
    for cls in (fluid.framework.CompiledProgram,
                fluid.framework.BuildStrategy):
        with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
            cls(fluid.Program())
    main = fluid.Program()
    main.global_block().create_var(name="w")
    main.global_block().append_op("while_loop", inputs={},
                                  outputs={"Out": ["w"]})
    exe = fluid.Executor(fluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        exe.run(main, fetch_list=["w"], scope=fluid.Scope())
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        exe.train_from_dataset(main, None)
    with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
        L.fc([fluid.data("a", [None, 2]), fluid.data("b", [None, 2])], 3)


def test_callsite_names_the_caller_not_the_port():
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.data("x", [None, 3])
        L.relu(x)
    site = main.global_block().ops[0].callsite
    assert site is not None and "test_torch_static_program.py" in site
    assert tprogram._PKG_DIR.endswith("paddle_tpu_torch/")


def test_variable_operator_sugar_uses_the_ported_ops():
    main = fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main,
                                                        fluid.Program()):
        x = fluid.data("x", [None, 3])
        y = fluid.data("y", [None, 3])
        _ = (x + y, x + 1.0, 2.0 - x, x * 3.0, x / 4.0, -x, x @ y)
        with pytest.raises(NotImplementedError, match="ROADMAP item 3"):
            x * y
    assert [op.type for op in main.global_block().ops] == [
        "elementwise_add", "scale", "scale", "scale", "scale", "scale",
        "matmul"]
