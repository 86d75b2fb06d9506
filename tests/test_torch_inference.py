"""The port's Predictor, its load-time folds and its exported artifact
against the JAX package's.

- Predictor: for each static family (mlp, lenet, resnet, bert, gpt,
  seq2seq, wide_deep, word2vec) the `clone(for_test=True)` Program
  fetching the loss is saved by both packages (the reference's startup
  values in both scopes); on each directory the reference's `Predictor`
  and the port's (`place="cpu"`) agree within 1e-5 (atol = rtol; f32
  sums in another order).  The static GPT's forward to the logits, fused
  (`passes.fuse_program`) and AMP-rewritten then fused (bfloat16), is
  held the same way: f32 within 1e-5, bf16 within 3e-2 (bf16 activations
  rounded at other places by XLA and by torch).
- Folds: `passes.fold_inference` of each family's for_test Program gives
  the reference's Program (`to_json` byte-equal, the same op count) and
  folded parameters within 1e-6 (atol = rtol) of the reference's.
- Export: `save_compiled_inference_model` then `CompiledPredictor` on the
  CPU is within 1e-6 (atol = rtol) of `Predictor.run`, also when loaded
  in a fresh process that imports no model code.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import amp as jamp
from paddle_tpu import inference as jinf
from paddle_tpu import passes as jpasses
from paddle_tpu.models import static_zoo as jzoo

import paddle_tpu_torch as fluid
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import interop
from paddle_tpu_torch import passes as tpasses
from paddle_tpu_torch.models import static_zoo as tzoo
from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = list(tzoo.BUILDERS)
BATCH = 4
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _np_scope(scope):
    return {n: np.asarray(v) for n, v in scope.vars.items()
            if v is not None}


def _startup(startup):
    """The reference's startup values in a reference scope and, as numpy,
    in a port scope: (reference executor, its scope, port executor, its
    scope)."""
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(startup, scope=jscope)
    tscope = interop.scope_from_numpy(_np_scope(jscope), fluid.Scope(),
                                      device="cpu")
    return jexe, jscope, fluid.Executor("cpu"), tscope


def _save_both(tmp_path, jprog, tprog, feeds, fetches, jexe, jscope, texe,
               tscope):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(jdir, feeds, fetches, jexe,
                                       main_program=jprog)
    with fluid.scope_guard(tscope):
        fluid.io.save_inference_model(tdir, feeds, fetches, texe,
                                      main_program=tprog)
    return jdir, tdir


def _agree(dirs, feed, tol):
    for d in dirs:
        want = jinf.Predictor(d).run(feed)
        got = tinf.Predictor(d, place="cpu").run(feed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(
                g, np.asarray(w, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", FAMILIES)
def test_predictors_agree_on_every_family(name, tmp_path):
    jm, tm = jzoo.BUILDERS[name](), tzoo.BUILDERS[name]()
    jexe, jscope, texe, tscope = _startup(jm.startup)
    feeds = [n for n, _, _ in jm.feeds]
    dirs = _save_both(tmp_path, jm.main.clone(for_test=True),
                      tm.main.clone(for_test=True), feeds, jm.fetches,
                      jexe, jscope, texe, tscope)
    _agree(dirs, jm.smoke_feed(BATCH, seed=3), TOL["float32"])


def _gpt_forward(pkg_amp, pkg_passes, m, amp):
    """The static GPT's for_test forward to the logits, pruned; AMP-
    rewritten (bf16) when `amp`; then fused.  Returns (program,
    logits name)."""
    test = m.main.clone(for_test=True)
    logits = [op for op in test.global_block().ops
              if op.type == "softmax_with_cross_entropy"][0] \
        .inputs["Logits"][0]
    prog = test._prune([logits])
    if amp:
        pkg_amp.rewrite_program(prog)
    fused, _ = pkg_passes.fuse_program(prog, fetch_names=[logits])
    return fused, logits


class _amp_dtype:
    """FLAGS_amp_dtype set in both packages for one block."""

    def __init__(self, dtype):
        self.dtype = dtype

    def __enter__(self):
        self.old = (jfluid.get_flags("FLAGS_amp_dtype")["FLAGS_amp_dtype"],
                    fluid.get_flags("FLAGS_amp_dtype")["FLAGS_amp_dtype"])
        jfluid.set_flags({"FLAGS_amp_dtype": self.dtype})
        fluid.set_flags({"FLAGS_amp_dtype": self.dtype})

    def __exit__(self, *exc):
        jfluid.set_flags({"FLAGS_amp_dtype": self.old[0]})
        fluid.set_flags({"FLAGS_amp_dtype": self.old[1]})


@pytest.mark.parametrize("amp", [False, True])
def test_predictors_agree_on_the_fused_gpt(amp, tmp_path):
    jm, tm = jzoo.build_gpt(), tzoo.build_gpt()
    jexe, jscope, texe, tscope = _startup(jm.startup)
    with _amp_dtype("bfloat16"):
        jprog, logits = _gpt_forward(jamp, jpasses, jm, amp)
        tprog, _ = _gpt_forward(tamp, tpasses, tm, amp)
    assert tprog.to_json() == jprog.to_json()
    types = [op.type for op in tprog.global_block().ops]
    assert types.count("fused_attention") == 1
    assert types.count("fused_layer_norm") == 2
    assert ("cast" in types) == amp
    dirs = _save_both(tmp_path, jprog, tprog, ["ids"], [logits], jexe,
                      jscope, texe, tscope)
    feed = {"ids": jm.smoke_feed(BATCH, seed=5)["ids"]}
    _agree(dirs, feed, TOL["bfloat16" if amp else "float32"])


@pytest.fixture
def same_fold_ids(monkeypatch):
    """Both packages' const_fold name their constants from a process-wide
    counter (`<var>.folded_<n>`); start both at 0 so the names line up
    whatever folded before in this process."""
    import itertools

    from paddle_tpu.passes import common as jcommon
    from paddle_tpu_torch.passes import common as tcommon

    monkeypatch.setattr(jcommon, "_FOLD_ID", itertools.count())
    monkeypatch.setattr(tcommon, "_FOLD_ID", itertools.count())


@pytest.mark.parametrize("name", FAMILIES)
def test_fold_inference_is_the_references(name, same_fold_ids):
    jm, tm = jzoo.BUILDERS[name](), tzoo.BUILDERS[name]()
    _, jscope, _, _ = _startup(jm.startup)
    values = _np_scope(jscope)
    persist = {v.name for v in jm.main.list_vars() if v.persistable}
    params = {n: v for n, v in values.items() if n in persist}
    jprog, jparams, jrep = jpasses.fold_inference(
        jm.main.clone(for_test=True), dict(params),
        fetch_names=jm.fetches, record=False)
    tprog, tparams, trep = tpasses.fold_inference(
        tm.main.clone(for_test=True), dict(params),
        fetch_names=tm.fetches)
    assert tprog.to_json() == jprog.to_json()
    assert len(tprog.global_block().ops) == len(jprog.global_block().ops)
    assert (trep["before_ops"], trep["after_ops"]) == \
        (jrep["before_ops"], jrep["after_ops"])
    assert [r["name"] for r in trep["passes"]] == \
        [r["name"] for r in jrep["passes"]]
    assert set(tparams) == set(jparams)
    for n in jparams:
        np.testing.assert_allclose(np.asarray(tparams[n], np.float32),
                                   np.asarray(jparams[n], np.float32),
                                   atol=1e-6, rtol=1e-6, err_msg=n)


def test_fold_on_and_off_serve_the_same_outputs(tmp_path):
    """FLAGS_inference_fold folds the resnet family's batch norms at load
    time; both settings serve outputs within 1e-5."""
    jm = jzoo.build_resnet()
    jexe, jscope, texe, tscope = _startup(jm.startup)
    d, _ = _save_both(tmp_path, jm.main.clone(for_test=True),
                      tzoo.build_resnet().main.clone(for_test=True),
                      [n for n, _, _ in jm.feeds], jm.fetches, jexe, jscope,
                      texe, tscope)
    feed = jm.smoke_feed(BATCH, seed=9)
    outs, ops = [], []
    old = fluid.get_flags("FLAGS_inference_fold")["FLAGS_inference_fold"]
    try:
        for fold in (False, True):
            fluid.set_flags({"FLAGS_inference_fold": fold})
            p = tinf.Predictor(d, place="cpu")
            outs.append(p.run(feed))
            ops.append(len(p._program.global_block().ops))
            assert (p._fold_report is not None) == fold
    finally:
        fluid.set_flags({"FLAGS_inference_fold": old})
    assert ops[1] < ops[0]
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def _port_dir(tmp_path, name="mlp"):
    jm, tm = jzoo.BUILDERS[name](), tzoo.BUILDERS[name]()
    _, _, texe, tscope = _startup(jm.startup)
    d = str(tmp_path / "model")
    with fluid.scope_guard(tscope):
        fluid.io.save_inference_model(d, [n for n, _, _ in tm.feeds],
                                      tm.fetches, texe,
                                      main_program=tm.main.clone(
                                          for_test=True))
    return d, tm


@pytest.mark.parametrize("name", ["mlp", "gpt"])
def test_compiled_predictor_round_trip(name, tmp_path):
    d, tm = _port_dir(tmp_path, name)
    feed = tm.smoke_feed(BATCH, seed=2)
    want = tinf.Predictor(d, place="cpu").run(feed)
    path = tinf.save_compiled_inference_model(d, feed, place="cpu")
    assert os.path.basename(path) == "__compiled__.pt2"
    cp = tinf.CompiledPredictor(d)
    assert cp.get_input_names() == [n for n, _, _ in tm.feeds]
    assert [s for s, _ in cp.in_avals] == [feed[n].shape
                                           for n in cp.get_input_names()]
    for g, w in zip(cp.run(feed), want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)


def test_compiled_predictor_loads_without_model_code(tmp_path):
    d, tm = _port_dir(tmp_path)
    feed = tm.smoke_feed(BATCH, seed=4)
    want = tinf.Predictor(d, place="cpu").run(feed)
    tinf.save_compiled_inference_model(d, feed, place="cpu")
    np.savez(tmp_path / "feed.npz", **feed)
    code = (
        "import sys, numpy as np\n"
        "from paddle_tpu_torch.inference import CompiledPredictor\n"
        f"cp = CompiledPredictor({d!r})\n"
        f"feed = dict(np.load({str(tmp_path / 'feed.npz')!r}))\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, cp.run(feed)[0])\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'paddle_tpu_torch.models', 'jax', 'paddle_tpu.'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"), want[0],
                               atol=1e-6, rtol=1e-6)


def test_predictor_surface(tmp_path):
    d, tm = _port_dir(tmp_path, "lenet")
    p = tinf.Predictor(d, place="cpu")
    assert p.get_input_names() == [n for n, _, _ in tm.feeds]
    assert p.get_output_names() == list(tm.fetches)
    specs = p.feed_specs()
    for n, shape, dtype in tm.feeds:
        feat, dt = specs[n]
        assert feat == tuple(shape[1:])
        assert isinstance(dt, torch.dtype)
    with pytest.raises(KeyError, match="missing feed"):
        p.run({})
    feed = tm.smoke_feed(BATCH, seed=1)
    prepared = p.prepare_feed({n: torch.from_numpy(v)
                               for n, v in feed.items()})
    assert all(t.device.type == "cpu" for t in prepared.values())
    for a, b in zip(p.run(feed), p.run_eager(feed)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="one platform"):
        p.export_compiled(feed, str(tmp_path), platforms=["cpu", "cuda"])
    with pytest.raises(ValueError, match="not the predictor's device"):
        p.export_compiled(feed, str(tmp_path), platforms="cuda")


def test_bf16_fetch_comes_back_as_float32(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 4], dtype="bfloat16")
        out = fluid.layers.scale(x, scale=2.0)
    exe = fluid.Executor("cpu")
    d = str(tmp_path / "m")
    fluid.io.save_inference_model(d, ["x"], [out], exe, main_program=main)
    xb = np.arange(8, dtype=np.float32).reshape(2, 4)
    got = tinf.Predictor(d, place="cpu").run({"x": xb})[0]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, 2 * xb)
    with open(os.path.join(d, "__model__.json")) as f:
        assert json.load(f)["feed_names"] == ["x"]


def test_predictor_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the default device exists on this host")
    d, _ = _port_dir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.Predictor(d)


def _seeded(pkg, kind):
    """One seeded program per structural pass, built in `pkg` (the same
    code for both packages, so both record the same Program)."""
    L = pkg.layers
    with pkg.unique_name.guard():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.data("x", [None, 2, 4, 4])
            if kind == "const_fold":
                t = L.scale(L.fill_constant([4], "float32", 3.0), scale=2.0)
                out = L.elementwise_add(x, t)
            elif kind == "cse":
                out = L.elementwise_add(L.scale(x, scale=3.0),
                                        L.scale(x, scale=3.0))
            elif kind == "identity_elim":
                y = L.reshape(L.scale(x, scale=1.0), [-1, 2, 4, 4])
                out = L.relu(L.assign(y))
            elif kind == "fold_scale_chain":
                out = L.scale(L.scale(x, scale=2.0, bias=1.0), scale=3.0,
                              bias=-0.5)
            elif kind == "dce":
                L.relu(x)
                out = L.sigmoid(x)
            else:                               # fold_batch_norm
                c = L.conv2d(x, 3, 3, padding=1)
                out = L.relu(L.batch_norm(c))   # a fetched BN never folds
    return main.clone(for_test=True), startup, out.name


@pytest.mark.parametrize("kind", ["const_fold", "cse", "identity_elim",
                                  "fold_scale_chain", "dce",
                                  "fold_batch_norm"])
def test_structural_passes_are_the_references(kind, same_fold_ids):
    """optimize_program over a seeded program per pass: the reference's
    Program (to_json byte-equal, its op count and report), and the port
    Executor's run of the optimized Program (folded constants seeded)
    within 1e-6 of the unoptimized run and of the reference's."""
    jmain, jstart, name = _seeded(jfluid, kind)
    tmain, _, _ = _seeded(fluid, kind)
    jexe, jscope, texe, tscope = _startup(jstart)
    persist = {v.name for v in jmain.list_vars() if v.persistable}
    params = {n: v for n, v in _np_scope(jscope).items() if n in persist}
    jparams = dict(params)
    jopt, jrep = jpasses.optimize_program(jmain, fetch_names=[name],
                                          params=jparams, record=False)
    tparams = dict(params)
    topt, trep = tpasses.optimize_program(tmain, fetch_names=[name],
                                          params=tparams)
    assert topt.to_json() == jopt.to_json()
    assert trep["after_ops"] == jrep["after_ops"] < trep["before_ops"]
    xb = np.random.default_rng(8).standard_normal((3, 2, 4, 4)).astype(
        np.float32)
    import jax.numpy as jnp

    for n, v in jparams.items():             # the folded weights
        jscope.set_var(n, jnp.asarray(v))
    want = np.asarray(jexe.run(jopt, feed={"x": xb}, fetch_list=[name],
                               scope=jscope)[0])
    plain = texe.run(tmain, feed={"x": xb}, fetch_list=[name],
                     scope=tscope)[0]
    for n, v in tparams.items():
        tscope.set_var(n, torch.from_numpy(np.asarray(v)))
    got = texe.run(topt, feed={"x": xb}, fetch_list=[name],
                   scope=tscope)[0]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=1e-6)
