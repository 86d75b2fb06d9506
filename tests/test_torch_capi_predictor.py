"""The port's C inference API (`paddle_tpu_torch/csrc/predictor_capi.cpp`),
built with g++ and asked for the CPU, against the Python Predictor.

- the standalone demo program (PD_CAPI_DEMO_MAIN) on a model with a
  known weight: its first output is the Python Executor's (rtol 1e-5,
  the reference's test of its own C API);
- the shared library driven through ctypes from this process (the
  embedded interpreter is this one) on the lenet family's saved for_test
  Program with its real feeds: every output within 1e-6 (atol = rtol)
  of `inference.Predictor(place="cpu").run` (the Predictor folds the
  Program at load time, the C API runs it as saved);
- `PD_NewPredictor` with no device asks for `cuda` and, on a host
  without one, fails with the Python entry points' error.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import inference as tinf
from paddle_tpu_torch import native
from paddle_tpu_torch.models import static_zoo as tzoo
from torch_threads import torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++")


def test_capi_demo_matches_python(tmp_path):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 4])
        w = fluid.layers.create_parameter([4, 3], "float32", name="capi_w")
        out = fluid.layers.mul(x, w)
    exe = fluid.Executor("cpu")
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        scope.set_var("capi_w",
                      torch.arange(12, dtype=torch.float32).reshape(4, 3))
        d = str(tmp_path / "model")
        fluid.io.save_inference_model(d, ["x"], [out], exe,
                                      main_program=main)
        expect = exe.run(main, feed={"x": np.ones((1, 4), np.float32)},
                         fetch_list=[out])[0]
    binary = native.build_capi(tmp_path / "capi_demo", demo=True)
    env = dict(os.environ, PADDLE_TPU_TORCH_ROOT=REPO, PD_DEMO_FEED_DIM="4",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([binary, d, "cpu"], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=600)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    m = re.search(r"out\[0\] dims=(\d+) first=([-\d.]+)", r.stdout)
    assert m, r.stdout
    assert int(m.group(1)) == expect.ndim
    np.testing.assert_allclose(float(m.group(2)), expect.reshape(-1)[0],
                               rtol=1e-5)


def test_capi_library_matches_the_python_predictor(tmp_path):
    m = tzoo.build_lenet()
    exe = fluid.Executor("cpu")
    scope = fluid.Scope()
    d = str(tmp_path / "lenet")
    with fluid.scope_guard(scope):
        exe.run(m.startup)
        fluid.io.save_inference_model(d, [n for n, _, _ in m.feeds],
                                      m.fetches, exe,
                                      main_program=m.main.clone(
                                          for_test=True))
    feed = m.smoke_feed(4, seed=6)
    want = tinf.Predictor(d, place="cpu").run(feed)
    lib = native.capi_load(native.build_capi(tmp_path / "libcapi.so"))
    got = native.capi_run(lib, d, feed, "cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            native.capi_run(lib, d, feed, None)
