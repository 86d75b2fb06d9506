"""P1 and P2, the port's probes of K7's routine, and the port's probe tool,
against the JAX package's tools/fused_probe.py.

- The JAX tool's own Pallas kernels: its `PROBES["p4_conv_only"]` and
  `PROBES["p5_matmuls"]` sources are executed as they stand (loaded by
  path; the file is not edited), with JAX on the CPU, where their
  `pallas_call`s run in interpret mode at the tool's shapes ([8, 56, 56,
  64] and [8, 56, 56, 256] -> 64, bf16).  The port's plain P1/P2 take
  the same inputs, re-drawn from the same seed, and must agree within
  atol = rtol = 3e-2 (bf16: one rounding of a sum taken in another
  order may land one ulp away).
- The reference's building blocks at a small size: `_conv3x3` (both
  PADDLE_TPU_FUSED_CONV modes, im2col and taps, which the variable picks
  at trace time) and `_dot`, composed and jitted as the probes compose
  them, in float32 (2e-5: the same sums in another order) and bfloat16
  (3e-2), and exact inputs that pin the tap order, the zero padding, the
  relu and the residual.
- The port's tool: `python -m paddle_tpu_torch.tools.fused_probe --device
  cpu` runs the plain versions in its subprocesses and reports one JSON
  line per probe; it writes no log unless asked, and never the JAX
  tool's FUSED_PROBE.log.
- `test_p1_on_card` / `test_p2_on_card` hold the CUDA kernels against the
  plain versions on the card (f32 2e-5, bf16 3e-2); they skip here.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_bottleneck as JK

from paddle_tpu_torch.kernels import backend
from paddle_tpu_torch.kernels import fused_probe as FP
from paddle_tpu_torch.tools import fused_probe as TOOL
from torch_threads import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_fused_probe_tool", REPO / "tools" / "fused_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a, dtype):
    """A jax or numpy array -> torch tensor of `dtype` (exact for bf16
    values)."""
    return torch.from_numpy(np.array(jnp.asarray(a).astype(
        jnp.float32))).to(getattr(torch, dtype))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the JAX tool's own Pallas kernels
# ---------------------------------------------------------------------------

# probe -> the shapes its source draws with `mk`, in order (x first)
_TOOL_DRAWS = {"p4_conv_only": [(8, 56, 56, 64), (3, 3, 64, 64)],
               "p5_matmuls": [(8, 56, 56, 256), (256, 64), (64, 256)]}


@pytest.mark.parametrize("probe", ["p4_conv_only", "p5_matmuls"])
def test_plain_probe_matches_the_tool_pallas_kernel(probe):
    ns = {}
    exec(_jax_tool().PROBES[probe], ns)     # runs its pallas_call
    rng = np.random.default_rng(0)
    draws = [jnp.asarray(rng.standard_normal(s) * 0.2, jnp.bfloat16)
             for s in _TOOL_DRAWS[probe]]
    # the same inputs as the tool's: x is the first draw of its seed
    np.testing.assert_array_equal(_f32(draws[0]), _f32(ns["x"]))
    args = [_t(a, "bfloat16") for a in draws]
    fn = (FP.conv3x3_probe if probe == "p4_conv_only"
          else FP.matmul_chain_probe)
    got = fn(*args)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == tuple(ns["out"].shape)
    np.testing.assert_allclose(got.float().numpy(), _f32(ns["out"]),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


def test_tool_probes_match_the_reference_tool():
    """Same seven probes in the same order, each naming its kernel."""
    assert list(TOOL.ORDER) == list(_jax_tool().PROBES)
    assert set(TOOL.KERNEL) == set(TOOL.ORDER)
    assert TOOL.KERNEL["p4_conv_only"] == "probe_conv3x3"
    assert TOOL.KERNEL["p5_matmuls"] == "probe_matmuls"


# ---------------------------------------------------------------------------
# the reference's _conv3x3 and _dot at a small size
# ---------------------------------------------------------------------------

def _jax_p1(x, w2):
    t, h, w, cm = x.shape
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return JK._conv3x3(xp, w2, t, h, w, cm).astype(x.dtype).reshape(
        t, h, w, cm)


def _jax_p2(x, w1, w3):
    t, h, w, cin = x.shape
    xm = x.reshape(t * h * w, cin)
    h0 = jnp.maximum(JK._dot(xm, w1, ((1,), (0,))), 0.0).astype(x.dtype)
    c2 = JK._dot(h0, w3, ((1,), (0,)))
    return (c2 + xm.astype(jnp.float32)).astype(x.dtype).reshape(
        t, h, w, cin)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["im2col", "taps"])
def test_plain_p1_matches_reference_conv3x3(mode, dtype, monkeypatch):
    # read at trace time: a fresh jit of a fresh function traces anew
    monkeypatch.setenv("PADDLE_TPU_FUSED_CONV", mode)
    assert JK._conv_mode() == mode
    g = np.random.default_rng(3).standard_normal
    x, w2 = g((2, 8, 8, 16)), g((3, 3, 16, 16)) * 0.25
    jd = getattr(jnp, dtype)
    want = jax.jit(lambda a, b: _jax_p1(a, b))(jnp.asarray(x, jd),
                                              jnp.asarray(w2, jd))
    got = FP.conv3x3_probe(_t(jnp.asarray(x, jd), dtype),
                           _t(jnp.asarray(w2, jd), dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _f32(want),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_p2_matches_reference_dot_chain(dtype):
    g = np.random.default_rng(4).standard_normal
    x, w1, w3 = g((2, 8, 8, 32)), g((32, 16)) * 0.3, g((16, 32)) * 0.3
    jd = getattr(jnp, dtype)
    ja = [jnp.asarray(a, jd) for a in (x, w1, w3)]
    want = jax.jit(_jax_p2)(*ja)
    got = FP.matmul_chain_probe(*[_t(a, dtype) for a in ja])
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), _f32(want),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_probes_on_exact_inputs(dtype):
    """Inputs whose results are exact pin the semantics: P1's tap (0, 0)
    reads pixel (i - 1, j - 1) and the padding is zero; P2 rounds h0
    after the relu and adds x in f32 before its one rounding."""
    dt = getattr(torch, dtype)
    x = torch.arange(2 * 5 * 6 * 4, dtype=torch.float32).reshape(
        2, 5, 6, 4).remainder(7).to(dt)
    w2 = torch.zeros(3, 3, 4, 4, dtype=dt)
    w2[0, 0] = torch.eye(4, dtype=dt)
    y = FP.conv3x3_probe(x, w2)
    want = torch.zeros_like(x)
    want[:, 1:, 1:] = x[:, :-1, :-1]
    assert torch.equal(y, want)
    # P2: relu(x @ w1) with w1 = -I on the first channels is 0, so y == x
    w1 = -torch.eye(4, 2, dtype=dt)
    w3 = torch.ones(2, 4, dtype=dt)
    assert torch.equal(FP.matmul_chain_probe(x, w1, w3), x)
    # h0 = relu(x @ w1) = x[..., :2], so y = x + (x0 + x1)
    y2 = FP.matmul_chain_probe(x, -w1, w3)
    assert torch.equal(y2, (x.float() + x[..., :2].float().sum(
        -1, keepdim=True)).to(dt))
    # the residual is added before the one rounding: h0 = [1, 2^-8],
    # c2 = 1 + 2^-8, y = 256 + c2 = 257.00390625, which bf16 rounds to
    # 258; rounding c2 first (to 1.0, a tie to even) would give 256
    xr = torch.tensor([256.0, 0.0]).reshape(1, 1, 1, 2).to(dt)
    w1r = torch.tensor([[2.0 ** -8, 2.0 ** -16], [0.0, 0.0]]).to(dt)
    w3r = torch.tensor([[1.0, 0.0], [1.0, 0.0]]).to(dt)
    yr = FP.matmul_chain_probe(xr, w1r, w3r)
    assert float(yr[0, 0, 0, 0]) == float(torch.tensor(257.00390625).to(dt))
    assert float(yr[0, 0, 0, 0]) == (258.0 if dtype == "bfloat16"
                                     else 257.00390625)


def test_probe_wrappers_check_shapes_and_count_no_cpu_launch():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match=r"\[3, 3, 8, 8\]"):
        FP.conv3x3_probe(x, torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError, match=r"\[4, 8\]"):
        FP.matmul_chain_probe(x, torch.zeros(8, 4), torch.zeros(2, 8))
    with pytest.raises(TypeError, match="dtype"):
        FP.conv3x3_probe(x.half(), torch.zeros(3, 3, 8, 8).half())
    backend.reset_launches()
    FP.conv3x3_probe(x, torch.zeros(3, 3, 8, 8))
    FP.matmul_chain_probe(x, torch.zeros(8, 4), torch.zeros(4, 8))
    assert backend.LAUNCHES["probe_conv3x3"] == 0
    assert backend.LAUNCHES["probe_matmuls"] == 0
    text = (backend.CSRC / "fused_bottleneck.cu").read_text()
    for entry in FP._SIGS:
        assert f'extern "C" int {entry}' in text
    # P1 runs K7's forward path for its 3x3 (csrc/block_tc.cuh's conv3x3
    # on the tensor-core product), P2 K7's identity forward without the
    # halo, the 3x3 and the affines: two tensor-core products in K7's
    # forward layout at K7's one block per SM; no CUDA-core `gemm`
    assert '#include "block_tc.cuh"' in text
    assert "gemm" not in text
    body = {kernel: text.split(f"{kernel}(Geo g")[1].split("\n}\n")[0]
            for kernel in ("probe_conv3x3_kernel", "probe_matmuls_kernel")}
    assert "conv3x3<T, 1>(" in body["probe_conv3x3_kernel"]
    assert body["probe_matmuls_kernel"].count("product<T, false, true") == 2
    assert "fwd_layout<T, 1>(" in body["probe_matmuls_kernel"]
    assert "__launch_bounds__(kThreads, 1)\nprobe_matmuls_kernel" in text


# ---------------------------------------------------------------------------
# the port's tool
# ---------------------------------------------------------------------------

def _tool(*args):
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.fused_probe", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_tool_runs_the_probes_on_cpu(tmp_path):
    log = REPO / "FUSED_PROBE.log"
    before = log.read_bytes() if log.exists() else None
    mine = tmp_path / "probes.jsonl"
    r = _tool("--device", "cpu", "--log", str(mine), "p4_conv_only",
              "p5_matmuls")
    assert r.returncode == 0, r.stdout + r.stderr
    recs = [json.loads(line) for line in r.stdout.splitlines()]
    assert [rec["probe"] for rec in recs] == ["p4_conv_only", "p5_matmuls"]
    for rec, kernel, shape in zip(recs, ("probe_conv3x3", "probe_matmuls"),
                                  ([8, 56, 56, 64], [8, 56, 56, 256])):
        assert rec["rc"] == 0 and rec["kernel"] == kernel
        assert rec["launches"] == 0 and rec["ms"] is None   # plain, no card
        rep = json.loads(rec["out"][3:])
        assert rep["shape"] == shape == rep["out_shape"] and rep["finite"]
        assert rec["wall_s"] > 0
    assert [json.loads(line) for line in
            mine.read_text().splitlines()] == recs
    after = log.read_bytes() if log.exists() else None
    assert after == before


def test_tool_rejects_an_unknown_probe():
    r = _tool("--device", "cpu", "p4_conv_only", "p9_nothing")
    assert r.returncode == 2
    assert "unknown probe(s) p9_nothing" in r.stderr
    assert "p4_conv_only" in r.stderr and r.stdout == ""


def test_tool_fails_a_probe_that_cannot_reach_the_card():
    """On a host without a card the default device fails each probe with
    its process's error, and the tool exits 1."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the probe would reach it")
    r = _tool("p5_matmuls")
    assert r.returncode == 1
    rec = json.loads(r.stdout.splitlines()[0])
    assert rec["probe"] == "p5_matmuls" and rec["rc"] == 1
    assert "no CUDA device" in rec["stderr"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU "
                    "mode (chip_smoke.py runs them on the card)")


def _card_args(seed, shapes, dtype):
    g = np.random.default_rng(seed).standard_normal
    return [torch.from_numpy(g(s) * (0.2 if i else 1.0)).to(
        device="cuda", dtype=dtype) for i, s in enumerate(shapes)]


@pytest.mark.cuda
def test_p1_on_card():
    """P1 on the card against its plain version: f32 2e-5, bf16 3e-2, at
    a square, ragged 11 x 7 (H % TH != 0), ResNet-50's stage 1 (the tool's
    geometry in bf16) and Cm 4 in bf16 (no 16-byte groups: the
    element-wise loaders)."""
    _needs_card()
    backend.reset_launches()
    cases = [((2, 8, 8, 16), torch.float32), ((2, 11, 7, 32), torch.float32),
             ((2, 11, 7, 64), torch.float32), ((2, 11, 7, 64), torch.bfloat16),
             ((2, 56, 56, 64), torch.float32), ((8, 56, 56, 64), torch.bfloat16),
             ((2, 5, 6, 4), torch.bfloat16)]
    for shape, dt in cases:
        cm = shape[-1]
        x, w2 = _card_args(1, [shape, (3, 3, cm, cm)], dt)
        tol = TOL[str(dt).replace("torch.", "")]
        torch.testing.assert_close(FP.conv3x3_probe(x, w2),
                                   FP.conv3x3_probe_ref(x, w2), atol=tol,
                                   rtol=tol)
    torch.cuda.synchronize()
    assert backend.LAUNCHES["probe_conv3x3"] == len(cases)


@pytest.mark.cuda
def test_p2_on_card():
    """P2 on the card against its plain version: f32 2e-5, bf16 3e-2, at
    ResNet-50's stage-2 widths (28^2, 512 -> 128 -> 512), a ragged 11 x 7
    (H % TH != 0), the tool's stage-1 geometry and Cin 12 (no 16-byte
    groups: the element-wise loaders); at stage 1 in bf16 its tile rows
    and blocks per SM are K7's forward's."""
    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    _needs_card()
    backend.reset_launches()
    cases = [((2, 8, 8, 32), 16, torch.float32),
             ((2, 11, 7, 64), 32, torch.float32),
             ((2, 11, 7, 256), 64, torch.bfloat16),
             ((2, 28, 28, 512), 128, torch.float32),
             ((4, 28, 28, 512), 128, torch.bfloat16),
             ((8, 56, 56, 256), 64, torch.bfloat16),
             ((2, 5, 6, 12), 4, torch.bfloat16)]
    for shape, cm, dt in cases:
        cin = shape[-1]
        x, w1, w3 = _card_args(2, [shape, (cin, cm), (cm, cin)], dt)
        tol = TOL[str(dt).replace("torch.", "")]
        torch.testing.assert_close(FP.matmul_chain_probe(x, w1, w3),
                                   FP.matmul_chain_probe_ref(x, w1, w3),
                                   atol=tol, rtol=tol)
    torch.cuda.synchronize()
    assert backend.LAUNCHES["probe_matmuls"] == len(cases)
    ths, per_sm = FP.probe_tiles(56, 56, 64, torch.bfloat16)
    k7 = FB.block_plan(128, 56, 56, 256, 64, 256, False, torch.bfloat16)
    assert (ths[1], per_sm[1]) == (k7["tile_rows"][0], k7["per_sm"][0])
