"""Probe the fused ResNet kernels one at a time, each in its own process.

Counterpart of tools/fused_probe.py (the JAX package's bisect of the
fused-bottleneck kernels), with the same seven probes in the same order:

  p0_ln          K4, LayerNorm forward, x [256, 1024]
  p1_stem        K9, the stem tail forward, c [8, 112, 112, 64]
  p2_tiny        K7 forward at [2, 16, 16, 256], Cm 128
  p3_s1_t1       K7 forward at [2, 56, 56, 256], Cm 64, batch_tile=1
  p4_conv_only   P1, K7's 3x3 conv alone, x [8, 56, 56, 64]
  p5_matmuls     P2, K7's 1x1 chain and residual, x [8, 56, 56, 256] -> 64
  p6_s1_full     K7 forward at [8, 56, 56, 256], Cm 64

Usage:

    python -m paddle_tpu_torch.tools.fused_probe [--device cuda|cpu]
        [--log PATH] [probe ...]

Each probe runs in a subprocess with a 420 s timeout, so a hang or a
crash (a build, a launch) names its probe.  Before the clock starts the tool takes
an exclusive `flock` on paddle_tpu_chip.lock in the temporary directory
(/tmp unless TMPDIR says otherwise), the lock the JAX tool takes, so two
probe runs never share the card.  Inputs are bf16 draws of
`np.random.default_rng(0)` times 0.2, in the JAX tool's order.  On the
card (the default) each probe calls its kernel's launcher, fails unless
the kernel's count in `backend.LAUNCHES` rose, and times it with CUDA
events; `--device cpu` runs the plain versions (no kernel, no time).

One JSON line per probe goes to stdout: probe, rc, the subprocess's last
line, wall seconds, the kernel, its launches and its ms.  `--log`
appends the same lines to a file of the caller's choosing; by default
nothing is written (and never the JAX tool's FUSED_PROBE.log).  Exit
code 0 when every probe passed, 1 when one failed, 2 for an unknown
probe name.
"""

import argparse
import fcntl
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the LAUNCHES key of each probe's kernel, in the JAX tool's order
KERNEL = {"p0_ln": "layer_norm_fwd", "p1_stem": "fused_stem_tail_fwd",
          "p2_tiny": "fused_bottleneck_fwd",
          "p3_s1_t1": "fused_bottleneck_fwd",
          "p4_conv_only": "probe_conv3x3", "p5_matmuls": "probe_matmuls",
          "p6_s1_full": "fused_bottleneck_fwd"}
ORDER = tuple(KERNEL)
TIMEOUT_S = 420
TIMED_CALLS = 3


# ---------------------------------------------------------------------------
# the child: one probe
# ---------------------------------------------------------------------------

def _block_args(mk, n, hw, cin, cm):
    """x, the three weights and the six affines of an identity block,
    drawn in the JAX tool's order."""
    return [mk((n, hw, hw, cin)), mk((cin, cm)), mk((3, 3, cm, cm)),
            mk((cm, cin)), mk((cm,), 1.0), mk((cm,), 0.1), mk((cm,), 1.0),
            mk((cm,), 0.1), mk((cin,), 1.0), mk((cin,), 0.1)]


def probe_call(name, device):
    """(call, input shape) of probe `name`, inputs on `device`: the
    kernel's launcher on the card, its plain version on the CPU."""
    import numpy as np
    import torch

    from ..kernels import fused_bottleneck as FB
    from ..kernels import fused_probe as FP
    from ..kernels import layer_norm as LN

    rng = np.random.default_rng(0)
    cuda = torch.device(device).type == "cuda"

    def mk(shape, scale=0.2):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(
            device=device, dtype=torch.bfloat16)

    if name == "p0_ln":
        x, g, b = mk((256, 1024)), mk((1024,), 1.0), mk((1024,), 0.1)
        run = ((lambda: LN._launch(x, g, b, 1e-5)) if cuda
               else (lambda: LN.layer_norm_ref(x, g, b)))
    elif name == "p1_stem":
        x, a, b = mk((8, 112, 112, 64)), mk((64,), 1.0), mk((64,), 0.1)
        aff = torch.stack([a.float(), b.float()])
        run = ((lambda: FB._launch_stem_fwd(x, aff)) if cuda
               else (lambda: FB.fused_stem_tail_fwd_ref(x, aff)))
    elif name in ("p2_tiny", "p3_s1_t1", "p6_s1_full"):
        n, hw, cm = {"p2_tiny": (2, 16, 128), "p3_s1_t1": (2, 56, 64),
                     "p6_s1_full": (8, 56, 64)}[name]
        args = _block_args(mk, n, hw, 256, cm)
        x = args[0]
        tile = {"batch_tile": 1} if name == "p3_s1_t1" else {}
        run = lambda: FB.fused_bottleneck(*args, **tile)
    elif name == "p4_conv_only":
        x, w2 = mk((8, 56, 56, 64)), mk((3, 3, 64, 64))
        run = lambda: FP.conv3x3_probe(x, w2)
    elif name == "p5_matmuls":
        x, w1, w3 = mk((8, 56, 56, 256)), mk((256, 64)), mk((64, 256))
        run = lambda: FP.matmul_chain_probe(x, w1, w3)
    else:
        raise KeyError(name)
    return run, list(x.shape)


def run_probe(name, device):
    """Run probe `name` once (and, on the card, TIMED_CALLS more times
    between CUDA events).  Returns the child's report."""
    import torch

    from ..kernels import backend

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the card, or pass "
                           "--device cpu for the plain versions")
    run, shape = probe_call(name, device)
    key = KERNEL[name]
    backend.reset_launches()
    out = run()
    report = {"kernel": key, "shape": shape, "out_shape": list(out.shape),
              "finite": bool(torch.isfinite(out.float()).all())}
    if not report["finite"]:
        raise RuntimeError(f"{name}: non-finite output")
    if device == "cpu":
        report.update(launches=backend.LAUNCHES[key], ms=None)
        return report
    torch.cuda.synchronize()
    if backend.LAUNCHES[key] < 1:
        raise RuntimeError(f"{name}: {key} was not launched (the call ran "
                           "another route)")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_CALLS):
        run()
    end.record()
    torch.cuda.synchronize()
    report.update(launches=backend.LAUNCHES[key],
                  ms=start.elapsed_time(end) / TIMED_CALLS,
                  device_name=torch.cuda.get_device_name(0))
    return report


# ---------------------------------------------------------------------------
# the parent: one subprocess per probe
# ---------------------------------------------------------------------------

def _emit(obj, log):
    line = json.dumps(obj)
    print(line, flush=True)
    if log:
        with open(log, "a") as f:
            f.write(line + "\n")


def run(name, device, log):
    """Run probe `name` in a subprocess under the chip lock; emit its line
    and return it."""
    lock = os.path.join(tempfile.gettempdir(), "paddle_tpu_chip.lock")
    with open(lock, "w") as lockf:
        # the lock first, then the clock: a probe that waits for the card
        # does not count the wait against its timeout
        fcntl.flock(lockf, fcntl.LOCK_EX)
        t0 = time.time()
        cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.fused_probe",
               "--child", name, "--device", device]
        try:
            r = subprocess.run(cmd, timeout=TIMEOUT_S, capture_output=True,
                               text=True, cwd=REPO)
        except subprocess.TimeoutExpired:
            rec = {"probe": name, "rc": None,
                   "error": f"timeout {TIMEOUT_S}s", "kernel": KERNEL[name],
                   "launches": 0, "ms": None,
                   "wall_s": round(time.time() - t0, 1)}
            _emit(rec, log)
            return rec
    lines = r.stdout.strip().splitlines()
    last = lines[-1] if lines else ""
    rec = {"probe": name, "rc": r.returncode, "out": last,
           "stderr": r.stderr[-400:] if r.returncode else "",
           "wall_s": round(time.time() - t0, 1), "kernel": KERNEL[name],
           "launches": 0, "ms": None}
    if r.returncode == 0 and last.startswith("OK "):
        rep = json.loads(last[3:])
        rec.update(launches=rep["launches"], ms=rep["ms"])
    _emit(rec, log)
    return rec


def passed(rec, device):
    """A probe passes when its process exited 0 and, on the card, its
    kernel launched."""
    return rec["rc"] == 0 and (device == "cpu" or rec["launches"] > 0)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.fused_probe",
        description="Run the fused-kernel probes, one subprocess each.")
    ap.add_argument("probes", nargs="*", metavar="probe",
                    help=f"probes to run (default: all): {', '.join(ORDER)}")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--log", default=None,
                    help="append the JSON lines to this file")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        rep = run_probe(args.child, args.device)
        print("OK " + json.dumps(rep), flush=True)
        return 0
    unknown = [n for n in args.probes if n not in KERNEL]
    if unknown:
        print(f"fused_probe: unknown probe(s) {', '.join(unknown)}; known: "
              f"{', '.join(ORDER)}", file=sys.stderr)
        return 2
    recs = [run(n, args.device, args.log)
            for n in (args.probes or ORDER)]
    return 0 if all(passed(r, args.device) for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
