"""How tight a check of the ring is: chip_smoke.py's in-process ring on
K1-K3 ([4, 12, 4 x 512, 64] bf16, 4 shards, unit-scale inputs from a
seeded generator) with one hop's blocks mis-weighted on purpose, held
against K1-K3 on the whole sequence.

A delta raises the lse of every block merged at the first hop by delta
before `_combine_lse` merges it, which weights those blocks by e^delta
against the others.  For each delta and causal, one JSON line per
output (out, dq, dk, dv): max |err| over max |want|, the relative
Frobenius error, and whether each rule passes it: "old", allclose at
atol = rtol = 3e-2 (bf16's rule of chip_smoke.py's `compare`), and
"scaled", chip_smoke.py's `compare_scaled` (max |err| <= 2^-6 max |want|
and relative Frobenius error <= 2^-7).  delta 0 is the ring as it is.

Usage:

    python -m paddle_tpu_torch.tools.ring_probe [delta ...]

Default deltas 0, 0.01, 0.03, 0.1, 0.3.  Needs one card.  Exit code 0
when delta 0 passes both rules, 1 otherwise.
"""

import importlib
import json
import sys

import torch

SHAPE = (4, 12, 4 * 512, 64)
SHARDS = 4
DELTAS = (0.0, 0.01, 0.03, 0.1, 0.3)


def _rules(got, want):
    g, w = got.double(), want.double()
    ratio = ((g - w).abs().max() / w.abs().max()).item()
    rel = ((g - w).norm() / w.norm()).item()
    return {"max_err_over_max": ratio, "rel_frobenius": rel,
            "old": bool(torch.allclose(g, w, atol=3e-2, rtol=3e-2)),
            "scaled": ratio <= 2.0 ** -6 and rel <= 2.0 ** -7}


def run(deltas=DELTAS, shape=SHAPE, n=SHARDS, device="cuda", seed=7):
    """One record per (delta, causal, output).  On the CPU the flash
    blocks run their plain versions (small shapes, for the tests)."""
    ring = importlib.import_module(
        "paddle_tpu_torch.distributed.ring_attention")
    from ..kernels.flash_attention import flash_attention

    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    merge = ring._combine_lse
    recs = []
    for delta in deltas:
        calls = [0]

        def combine(acc, o_i, lse_i, delta=delta):
            # the merges run step-major, n per step: step 1 is the first
            # hop
            if n <= calls[0] % (n * n) < 2 * n:
                lse_i = lse_i + delta
            calls[0] += 1
            return merge(acc, o_i, lse_i)

        for causal in (False, True):
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            ring._combine_lse = combine
            try:
                out = ring.ring_attention_local(qg, kg, vg, n, causal,
                                                impl="flash")
            finally:
                ring._combine_lse = merge
            got = (out, *torch.autograd.grad(out, (qg, kg, vg), do))
            ref = flash_attention(qg, kg, vg, causal=causal)
            want = (ref, *torch.autograd.grad(ref, (qg, kg, vg), do))
            for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
                recs.append({"delta": delta, "causal": causal,
                             "output": name, **_rules(a, b)})
    return recs


def main(argv=None):
    args = list(argv if argv is not None else sys.argv[1:])
    if not torch.cuda.is_available():
        print("ring_probe: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from ..kernels import backend

    backend.build()
    deltas = tuple(float(a) for a in args) or DELTAS
    recs = run(deltas)
    for rec in recs:
        print(json.dumps(rec), flush=True)
    base = [r for r in recs if r["delta"] == 0.0]
    return 0 if all(r["old"] and r["scaled"] for r in base) else 1


if __name__ == "__main__":
    sys.exit(main())
