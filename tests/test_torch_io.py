"""The port's io (save/load of variables and inference models) against
the JAX package's, on the static zoo.

Per family (mlp, lenet, resnet, bert, gpt, seq2seq, wide_deep, word2vec)
the reference runs its startup program; its scope, read as numpy, seeds
the port's scope (`interop.scope_from_numpy`).  Each package saves the
family's `clone(for_test=True)` Program (fetching the loss) with
`io.save_inference_model`:
- the two `__model__.json` files are byte-equal, and so is every array
  inside the two `__params__.npz` files (the same names, the same `.npy`
  bytes);
- a directory saved by the reference loads into the port's Executor and
  fetches within 1e-5 (atol = rtol) of the reference's run of the same
  feed, and a directory saved by the port loads into the reference's
  Executor within the same tolerance (the same f32 math summed in
  another order).
A bfloat16 persistable is written as the same raw 2-byte words ('<V2')
by both packages and reads back into the port as the same bfloat16 bits.
"""

import io as _io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu.models import static_zoo as jzoo

import paddle_tpu_torch as fluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.models import static_zoo as tzoo

FAMILIES = list(tzoo.BUILDERS)
BATCH = 4
TOL = 1e-5


def _npy_payloads(path):
    """{array name: the bytes of its .npy inside the .npz}."""
    with zipfile.ZipFile(path) as zf:
        return {n[:-4]: zf.read(n) for n in zf.namelist()}


def _np_scope(scope):
    return {n: np.asarray(v) for n, v in scope.vars.items()
            if v is not None}


def _family(name):
    """(reference model, port model, reference scope, port scope seeded
    from it, reference executor, port executor)."""
    jm, tm = jzoo.BUILDERS[name](), tzoo.BUILDERS[name]()
    jexe, texe = jfluid.Executor(jfluid.CPUPlace()), fluid.Executor("cpu")
    jscope, tscope = jfluid.Scope(), fluid.Scope()
    jexe.run(jm.startup, scope=jscope)
    interop.scope_from_numpy(_np_scope(jscope), tscope, device="cpu")
    return jm, tm, jscope, tscope, jexe, texe


def _feeds(m):
    return [n for n, _, _ in m.feeds]


@pytest.mark.parametrize("name", FAMILIES)
def test_inference_model_files_are_the_references_bytes(name, tmp_path):
    jm, tm, jscope, tscope, jexe, texe = _family(name)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(jdir, _feeds(jm), jm.fetches, jexe,
                                       main_program=jm.main.clone(
                                           for_test=True))
    with fluid.scope_guard(tscope):
        fluid.io.save_inference_model(tdir, _feeds(tm), tm.fetches, texe,
                                      main_program=tm.main.clone(
                                          for_test=True))
    for f in ("__model__.json",):
        with open(os.path.join(jdir, f), "rb") as a, \
                open(os.path.join(tdir, f), "rb") as b:
            assert a.read() == b.read()
    want = _npy_payloads(os.path.join(jdir, "__params__.npz"))
    got = _npy_payloads(os.path.join(tdir, "__params__.npz"))
    assert list(got) == list(want)
    for n in want:
        assert got[n] == want[n], n


@pytest.mark.parametrize("name", FAMILIES)
def test_saved_models_cross_both_ways(name, tmp_path):
    jm, tm, jscope, tscope, jexe, texe = _family(name)
    feed = jm.smoke_feed(BATCH, seed=7)
    jtest = jm.main.clone(for_test=True)
    want = jexe.run(jtest, feed=feed, fetch_list=jm.fetches, scope=jscope)
    # the reference's directory into the port
    jdir = str(tmp_path / "jax")
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(jdir, _feeds(jm), jm.fetches, jexe,
                                       main_program=jtest)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        prog, feeds, fetches = fluid.io.load_inference_model(jdir, texe)
    assert feeds == _feeds(jm) and fetches == list(jm.fetches)
    got = texe.run(prog, feed=feed, fetch_list=fetches, scope=scope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL, rtol=TOL)
    # the port's directory into the reference
    tdir = str(tmp_path / "torch")
    with fluid.scope_guard(tscope):
        fluid.io.save_inference_model(tdir, _feeds(tm), tm.fetches, texe,
                                      main_program=tm.main.clone(
                                          for_test=True))
    jscope2 = jfluid.Scope()
    with jfluid.scope_guard(jscope2):
        jprog, jfeeds, jfetches = jfluid.io.load_inference_model(tdir, jexe)
    got = jexe.run(jprog, feed=feed, fetch_list=jfetches, scope=jscope2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=TOL,
                                   rtol=TOL)


def test_persistables_and_params_round_trip(tmp_path):
    """save_persistables / load_persistables, save_params / load_params,
    save_vars of named vars into a named file: the values come back
    exactly, on the executor's device, in the device dtype."""
    _, tm, _, tscope, _, texe = _family("mlp")
    before = {n: v.clone() for n, v in tscope.vars.items()}
    params = {v.name for v in tm.main.list_vars() if v.is_parameter}
    persist = {v.name for v in tm.main.list_vars() if v.persistable}
    with fluid.scope_guard(tscope):
        fluid.io.save_persistables(texe, str(tmp_path / "p"), tm.main)
        fluid.io.save_params(texe, str(tmp_path / "w"), tm.main)
        one = sorted(params)[0]
        fluid.io.save_vars(texe, str(tmp_path / "v"), tm.main, vars=[one],
                           filename="one.npz")
    with np.load(tmp_path / "p" / "__params__.npz") as d:
        assert set(d.files) == persist
    with np.load(tmp_path / "w" / "__params__.npz") as d:
        assert set(d.files) == params
    with np.load(tmp_path / "v" / "one.npz") as d:
        assert d.files == [one]
    for loader, sub, names in ((fluid.io.load_persistables, "p", persist),
                               (fluid.io.load_params, "w", params)):
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            loader(texe, str(tmp_path / sub), tm.main)
        assert set(scope.vars) == names
        for n in names:
            assert scope.vars[n].device.type == "cpu"
            assert torch.equal(scope.vars[n], before[n]), n


def test_bf16_persistable_is_the_references_words(tmp_path):
    """A bfloat16 persistable: both packages write the same '<V2' words,
    and the port reads either file back as the same bfloat16 bits."""
    import ml_dtypes

    vals = np.random.default_rng(0).standard_normal((5, 7)).astype(
        np.float32)
    progs = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            pkg.layers.create_parameter([5, 7], "bfloat16", name="w_bf16")
        progs.append(main)
    jscope, tscope = jfluid.Scope(), fluid.Scope()
    import jax.numpy as jnp

    jscope.set_var("w_bf16", jnp.asarray(vals.astype(ml_dtypes.bfloat16)))
    tscope.set_var("w_bf16", torch.from_numpy(vals).bfloat16())
    with jfluid.scope_guard(jscope):
        jfluid.io.save_persistables(jfluid.Executor(jfluid.CPUPlace()),
                                    str(tmp_path / "j"), progs[0])
    texe = fluid.Executor("cpu")
    with fluid.scope_guard(tscope):
        fluid.io.save_persistables(texe, str(tmp_path / "t"), progs[1])
    want = _npy_payloads(tmp_path / "j" / "__params__.npz")
    got = _npy_payloads(tmp_path / "t" / "__params__.npz")
    assert got == want
    assert b"'descr': '<V2'" in got["w_bf16"]
    for sub in ("j", "t"):
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            fluid.io.load_persistables(texe, str(tmp_path / sub), progs[1])
        t = scope.vars["w_bf16"]
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.view(torch.int16),
                           tscope.vars["w_bf16"].view(torch.int16))


def test_save_npz_is_np_savez_byte_for_byte():
    arrays = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
              "b": np.float32(1.5), "c": np.zeros((0, 4), np.float64),
              "d": np.array([True, False])}
    want, got = _io.BytesIO(), _io.BytesIO()
    np.savez(want, **arrays)
    interop.save_npz(got, arrays)
    assert got.getvalue() == want.getvalue()


def test_fleet_save_facades_write_the_io_files(tmp_path):
    _, tm, _, tscope, _, texe = _family("mlp")
    test = tm.main.clone(for_test=True)
    with fluid.scope_guard(tscope):
        tfleet.save_persistables(texe, str(tmp_path / "fp"), tm.main)
        fluid.io.save_persistables(texe, str(tmp_path / "ip"), tm.main)
        tfleet.save_inference_model(texe, str(tmp_path / "fm"), _feeds(tm),
                                    tm.fetches, test)
        fluid.io.save_inference_model(str(tmp_path / "im"), _feeds(tm),
                                      tm.fetches, texe, main_program=test)
    for a, b in (("fp", "ip"), ("fm", "im")):
        for f in sorted(os.listdir(tmp_path / b)):
            assert (tmp_path / a / f).read_bytes() == \
                (tmp_path / b / f).read_bytes()
    with open(tmp_path / "fm" / "__model__.json") as f:
        assert json.load(f)["fetch_names"] == list(tm.fetches)


def test_load_vars_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the default device exists on this host")
    with pytest.raises(RuntimeError, match="CUDA"):
        fluid.io.load_vars(None, "nowhere", fluid.Program())
