#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (paddle_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure makes the script exit non-zero without a result):

1. Card and build: print the card's name and power limit, turn TF32
   off, build the CUDA kernels (one nvcc per source, in parallel) and
   print the build time and the compiler's register/spill report.
2. Kernels: hold K1 (flash-attention forward, CUDA), K2/K3 (its
   backward, CUDA), K4/K5 (LayerNorm forward/backward, Triton), K6
   (flash decode, CUDA) and K7 (the fused ResNet bottleneck block,
   forward and backward, CUDA) against their plain PyTorch versions on
   the card, in float32 and bfloat16, and time the kernel, the plain
   version, one PyTorch library call computing the same function (a
   yardstick only; the port never calls it) and the bound (the larger
   of bytes over 3.35 TB/s and operations over the peak rate of the
   input type).  The backward kernels are checked both as raw launches
   and through their autograd Functions, at the train shapes
   (q [48, 12, 512, 64] causal, x [24576, 768]), at the serving shapes
   and non-causal at head_dim 128 and 256; their library yardstick is
   the backward of `F.scaled_dot_product_attention` / `F.layer_norm`,
   timed as `torch.autograd.grad(out, inputs, dout, retain_graph=True)`.
   K7 is checked at ResNet-50's four identity-block geometries (56^2
   256/64, 28^2 512/128, 14^2 1024/256, 7^2 2048/512) and its stage-1
   block-0 projection geometry (56^2, 64 -> 256, Cm 64), batch 2 in
   float32 and batch 128 (timed) in bfloat16; its yardstick is the
   cuDNN composition (three or four `F.conv2d` plus the elementwise
   tail, through autograd for the backward), several calls, not one.
3. GPT train path: the repo's headline training configuration
   (`bench.py` `bench_bert`: a GPT of BERT-base geometry, vocab 32768,
   hidden 768, 12 layers, 12 heads, max_seq_len 512, bfloat16) with
   seeded weights takes one warm-up step and 5 timed steps of
   `make_train_step(model, AdamW(1e-4))` on one seeded batch of 48 x
   512 tokens.  Printed: step ms, tokens/s, MFU (bench.py's FLOP count
   over 989 TFLOP/s), peak memory and a torch.profiler breakdown of one
   step.  Fails unless every loss is finite, the last loss is below the
   first, and every step launches exactly K1, K2, K3 x12 and K4, K5 x25.
4. ResNet-50 train path (`bench.py` `resnet50_time_config`, the
   `bench_resnet50_fused` row): ResNet-50, bfloat16, NHWC, ghost batch
   norm over 16 samples, `fused=True` under PADDLE_TPU_FUSED_SUBSET=id,
   seeded weights, one warm-up step and 5 timed steps of
   `make_train_step(model, Momentum(0.1, 0.9))` with the cross-entropy
   loss on one seeded batch of 128 x 3 x 224 x 224.  Printed: step ms,
   images/s, MFU (3 x 4.089e9 FLOP per image over 989 TFLOP/s, as
   bench.py), peak memory and a profile of one step.  Fails unless every
   loss is finite, the last loss is below the first, and every step
   launches K7 forward and backward exactly 12 times each.  The unfused
   step (`fused=False`, bench_resnet50's path, no port kernel) is timed
   the same way beside it as the yardstick.
5. Serving path: GPT-2 small (vocab 50304, hidden 768, 12 layers, 12
   heads) in bfloat16 with seeded random weights serves greedy
   `generate()` on 4 prompts of 256 tokens (128 new) and a
   continuous-batching `DecodeEngine` (8 slots, max_len 1024, buckets
   128/256/512) over 16 seeded requests.  The launch counts are zeroed
   just before and read just after; every kernel must have launched.  A
   torch.profiler window over 16 decode steps then says where a step's
   time goes.
6. Checks in float32: the train geometry at full width and depth 2
   (batch 2, seq 256) takes 3 AdamW steps on the card (kernels) and on
   the CPU (plain versions) from the same weights; the loss streams, the
   first step's grads and the params must agree.  A shallow NHWC
   ResNet-50 (full widths, one identity block per stage through K7)
   takes 2 Momentum steps at batch 8 x 128 x 128 on the card and on the
   CPU: losses, first-step grads, params and batch-norm buffers must
   agree (in norm per tensor, see `resnet_check`).  Then
   the card's GPT-2-small logits against the same model on the CPU for
   one 128-token prompt, and engine tokens against `generate()` for
   prompts whose length equals a bucket.  A token mismatch fails only if
   `generate()`'s top-2 logit margin at that step is above 1e-3
   relative (a real disagreement, not a near-tie).

The last lines are the kernels' JSON line (K1-K7, K7 as two rows,
each with its launches summed over the GPT train, ResNet and serving
paths), the card line and
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, H100 SXM
TOL = {"float32": 2e-5, "bfloat16": 3e-2}           # atol = rtol


def log(msg):
    print(msg, flush=True)


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def time_ms(fn, iters=20, flush=None, graph=True):
    """Mean device time of fn() in ms, from CUDA events around replays
    of a CUDA graph of the calls, so the host's launch gaps between
    small kernels are not counted.  Without `flush` the graph holds
    `iters` calls (inputs stay in L2, as for a producer's fresh output);
    with `flush` (a tensor larger than L2) it holds one call, L2 is
    overwritten before each replay and only the replay is timed.
    graph=False times `iters` plain calls between two events instead
    (for calls through autograd, at shapes where each call takes
    milliseconds and the launch gaps do not count)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if not graph:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters if flush is None else 1):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    if flush is None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dname(dt):
    return str(dt).replace("torch.", "")


def compare(name, got, want, dtype, failures):
    import torch

    tol = TOL[dtype]
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol) \
        and bool(torch.isfinite(got.float()).all())
    if not ok:
        failures.append(f"{name}: max_abs_err {err:.3e} > tol {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(failures):
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    # K1 ------------------------------------------------------------------
    k1_cases = [((48, 12, 512, 64), True), ((4, 12, 256, 64), True),
                ((1, 12, 512, 64), True), ((1, 4, 256, 128), False),
                ((1, 4, 256, 256), False)]
    for dt in (torch.bfloat16, torch.float32):
        for shape, causal in k1_cases:
            q, k, v = (rnd(shape, dt, 0.5) for _ in range(3))
            out, lse = FA.flash_attention_with_lse(q, k, v, causal=causal)
            ref, ref_lse = FA.flash_attention_ref(q, k, v, causal=causal)
            tag = f"K1 {list(shape)} causal={causal} {dname(dt)}"
            err = compare(tag, out, ref, dname(dt), failures)
            err_lse = compare(tag + " lse", lse, ref_lse, "float32",
                              failures)
            ms = time_ms(lambda: FA.flash_attention(q, k, v, causal))
            plain = time_ms(lambda: FA.flash_attention_ref(q, k, v, causal))
            lib = time_ms(lambda: TF.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
            b, h, s, d = shape
            pairs = s * (s + 1) / 2 if causal else s * s
            nbytes = 4 * b * h * s * d * q.element_size() + b * h * s * 4
            bms, by = bound(nbytes, 4 * b * h * pairs * d, dname(dt))
            log(f"{tag}: kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                f"{lib:.4f} bound_ms {bms:.5f} ({by}) max_err {err:.3e} "
                f"lse_err {err_lse:.3e}")
            if shape == (48, 12, 512, 64) and dt == torch.bfloat16:
                rows["flash_attention_fwd"] = dict(
                    name="K1 flash_attention_fwd", route="cuda",
                    source="paddle_tpu_torch/csrc/flash_attention.cu",
                    replaces="paddle_tpu/kernels/flash_attention.py:106",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib,
                    shape=f"q,k,v {list(shape)} causal bf16 (train step)")

    # K4 ------------------------------------------------------------------
    for dt in (torch.bfloat16, torch.float32):
        for n_rows, d in ((24576, 768), (1024, 768), (512, 768), (8, 768),
                          (300, 1024)):
            x = rnd((n_rows, d), dt)
            g, bta = rnd((d,), dt), rnd((d,), dt)
            y = LN.fused_layer_norm(x, g, bta)
            ref = LN.layer_norm_ref(x, g, bta)
            tag = f"K4 [{n_rows}, {d}] {dname(dt)}"
            err = compare(tag, y, ref, dname(dt), failures)
            ms = time_ms(lambda: LN.fused_layer_norm(x, g, bta))
            plain = time_ms(lambda: LN.layer_norm_ref(x, g, bta))
            lib = time_ms(lambda: TF.layer_norm(x, (d,), g, bta, 1e-5))
            nbytes = (2 * n_rows * d + 2 * d) * x.element_size()
            bms, by = bound(nbytes, 8 * n_rows * d, dname(dt))
            log(f"{tag}: kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                f"{lib:.4f} bound_ms {bms:.5f} ({by}) max_err {err:.3e}")
            if (n_rows, d) == (24576, 768) and dt == torch.bfloat16:
                rows["layer_norm_fwd"] = dict(
                    name="K4 layer_norm_fwd", route="triton",
                    source="paddle_tpu_torch/kernels/layer_norm.py",
                    replaces="paddle_tpu/kernels/layer_norm.py:45",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib,
                    shape="x [24576, 768] bf16 (train step)")

    # K6 ------------------------------------------------------------------
    k6_cases = [
        (4, 384, [320] * 4, "generate decode, cache 256+128"),
        (8, 1024, [1, 77, 512, 1024, 300, 640, 900, 129],
         "engine decode, ragged slots"),
    ]
    for dt in (torch.bfloat16, torch.float32):
        for b, t, lens, what in k6_cases:
            h, d = 12, 64
            q = rnd((b, h, 1, d), dt)
            k, v = rnd((b, h, t, d), dt), rnd((b, h, t, d), dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = FA.flash_decode(q, k, v, lengths)
            ref = FA.flash_decode_ref(q, k, v, lengths)
            tag = f"K6 q [{b}, {h}, 1, {d}] T={t} lengths={lens} {dname(dt)}"
            err = compare(tag, out, ref, dname(dt), failures)
            live = (torch.arange(t, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            ms = time_ms(lambda: FA.flash_decode(q, k, v, lengths),
                         flush=flush)
            plain = time_ms(lambda: FA.flash_decode_ref(q, k, v, lengths),
                            flush=flush)
            lib = time_ms(lambda: TF.scaled_dot_product_attention(
                q, k, v, attn_mask=live), flush=flush)
            n_live = h * sum(min(n, t) for n in lens)
            nbytes = (2 * n_live * d + 2 * b * h * d) * q.element_size() \
                + 4 * b
            bms, by = bound(nbytes, 4 * n_live * d, dname(dt))
            log(f"{tag}: kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                f"{lib:.4f} bound_ms {bms:.5f} ({by}) max_err {err:.3e} "
                f"(L2 flushed)")
            if b == 4 and dt == torch.bfloat16:
                rows["flash_decode"] = dict(
                    name="K6 flash_decode", route="cuda",
                    source="paddle_tpu_torch/csrc/flash_decode.cu",
                    replaces="paddle_tpu/kernels/flash_attention.py:379",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib,
                    shape=f"q [4, 12, 1, 64], cache T=384, lengths 320, "
                          "bf16 (generate decode)")
    flash_bwd_checks(rows, failures, rnd)
    layer_norm_bwd_checks(rows, failures, rnd)
    fused_bottleneck_checks(rows, failures, rnd)
    return rows


def flash_bwd_checks(rows, failures, rnd):
    """K2 (dq) and K3 (dk, dv): raw launches and the Function's backward
    against the plain backward, and their times."""
    import math

    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import flash_attention as FA

    cases = [((48, 12, 512, 64), True, "train step"),
             ((4, 12, 256, 64), True, "generate prefill"),
             ((1, 12, 512, 64), True, "prefill"),
             ((1, 4, 256, 128), False, "non-causal"),
             ((1, 4, 256, 256), False, "non-causal")]
    for dt in (torch.bfloat16, torch.float32):
        for shape, causal, what in cases:
            b, h, s, d = shape
            scale = 1.0 / math.sqrt(d)
            q, k, v, do = (rnd(shape, dt, 0.5) for _ in range(4))
            dlse = rnd(shape[:3], torch.float32, 0.5)
            out, lse = FA.flash_attention_ref(q, k, v, causal)
            delta = (do.float() * out.float()).sum(-1)
            args = (q, k, v, do, lse, delta, causal, scale)
            want = FA.flash_attention_bwd_ref(*args)
            tag = f"K2/K3 {list(shape)} causal={causal} {dname(dt)}"
            dq = FA._launch_bwd_dq(*args)
            dk, dv = FA._launch_bwd_dkv(*args)
            err_q = compare(tag + " dq", dq, want[0], dname(dt), failures)
            err_kv = max(compare(tag + " dk", dk, want[1], dname(dt),
                                 failures),
                         compare(tag + " dv", dv, want[2], dname(dt),
                                 failures))
            # through the autograd Function, with an lse cotangent
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            outs = FA.flash_attention_with_lse(*leaves, causal=causal)
            got = torch.autograd.grad(outs, leaves, (do, dlse))
            want_f = FA.flash_attention_bwd_ref(q, k, v, do, lse,
                                                delta - dlse, causal, scale)
            err_f = max(compare(f"{tag} Function d{n}", g, w, dname(dt),
                                failures)
                        for n, g, w in zip("qkv", got, want_f))
            del leaves, outs, got, want_f
            iters = 5 if b * h > 100 else 20
            ms_q = time_ms(lambda: FA._launch_bwd_dq(*args), iters)
            ms_kv = time_ms(lambda: FA._launch_bwd_dkv(*args), iters)
            plain = time_ms(lambda: FA.flash_attention_bwd_ref(*args), iters)
            lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
            lout = TF.scaled_dot_product_attention(lq, lk, lv,
                                                   is_causal=causal)
            lib = time_ms(lambda: torch.autograd.grad(
                lout, (lq, lk, lv), do, retain_graph=True), iters,
                graph=False)
            del lq, lk, lv, lout
            n = b * h * s
            pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
            elt = q.element_size()
            reads = 4 * n * d * elt + 2 * n * 4
            bq, byq = bound(reads + n * d * elt, 6 * pairs * d, dname(dt))
            bkv, bykv = bound(reads + 2 * n * d * elt, 8 * pairs * d,
                              dname(dt))
            log(f"{tag}: K2 kernel_ms {ms_q:.4f} bound_ms {bq:.5f} ({byq}) "
                f"max_err {err_q:.3e}; K3 kernel_ms {ms_kv:.4f} bound_ms "
                f"{bkv:.5f} ({bykv}) max_err {err_kv:.3e}; whole backward "
                f"plain_ms {plain:.4f} library_ms {lib:.4f}; Function "
                f"(with dlse) max_err {err_f:.3e} ({what})")
            if shape == (48, 12, 512, 64) and dt == torch.bfloat16:
                common = dict(route="cuda", plain_ms=plain, library_ms=lib,
                              source="paddle_tpu_torch/csrc/"
                                     "flash_attention_bwd.cu",
                              shape=f"q,k,v,do {list(shape)} causal bf16 "
                                    "(train step); plain and library: "
                                    "the whole backward")
                rows["flash_attention_bwd_dq"] = dict(
                    name="K2 flash_attention_bwd_dq",
                    replaces="paddle_tpu/kernels/flash_attention.py:203",
                    max_abs_err=max(err_q, err_f), ms=ms_q, bound_ms=bq,
                    bound_by=byq, **common)
                rows["flash_attention_bwd_dkv"] = dict(
                    name="K3 flash_attention_bwd_dkv",
                    replaces="paddle_tpu/kernels/flash_attention.py:242",
                    max_abs_err=max(err_kv, err_f), ms=ms_kv, bound_ms=bkv,
                    bound_by=bykv, **common)
            del q, k, v, do, out, lse, delta, args, want, dq, dk, dv
            torch.cuda.empty_cache()


def layer_norm_bwd_checks(rows, failures, rnd):
    """K5: raw launch and the Function's backward against the plain
    backward, and its time.  dgamma/dbeta are f32 sums over the rows,
    taken in another order: atol 2e-5 * sqrt(rows), rtol 2e-5."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import layer_norm as LN

    def compare_sum(name, got, want, n_rows, failures):
        err = (got.float() - want.float()).abs().max().item()
        atol = 2e-5 * n_rows ** 0.5
        if not torch.allclose(got.float(), want.float(), atol=atol,
                              rtol=2e-5):
            failures.append(f"{name}: max_abs_err {err:.3e} > atol {atol}")
        return err

    for dt in (torch.bfloat16, torch.float32):
        for n_rows, d in ((24576, 768), (1024, 768), (512, 768), (8, 768),
                          (300, 1024)):
            x, dy = rnd((n_rows, d), dt), rnd((n_rows, d), dt)
            g, bta = rnd((d,), dt), rnd((d,), dt)
            tag = f"K5 [{n_rows}, {d}] {dname(dt)}"
            dx, dg, db = LN._launch_bwd(x, g, dy, 1e-5)
            want = LN.layer_norm_bwd_ref(x, g, dy)
            err = compare(tag + " dx", dx, want[0], dname(dt), failures)
            err_s = max(compare_sum(tag + " dgamma", dg, want[1], n_rows,
                                    failures),
                        compare_sum(tag + " dbeta", db, want[2], n_rows,
                                    failures))
            leaves = [t.clone().requires_grad_() for t in (x, g, bta)]
            got = torch.autograd.grad(LN.fused_layer_norm(*leaves), leaves,
                                      dy)
            err_f = compare(tag + " Function dx", got[0], want[0], dname(dt),
                            failures)
            for name, a, w in (("dgamma", got[1], want[1]),
                               ("dbeta", got[2], want[2])):
                # the Function returns them in gamma's dtype
                if dt == torch.float32:
                    compare_sum(f"{tag} Function {name}", a, w, n_rows,
                                failures)
                else:
                    compare(f"{tag} Function {name}", a, w.to(dt),
                            dname(dt), failures)
            ms = time_ms(lambda: LN._launch_bwd(x, g, dy, 1e-5))
            plain = time_ms(lambda: LN.layer_norm_bwd_ref(x, g, dy))
            lx, lg, lb = (t.clone().requires_grad_() for t in (x, g, bta))
            lout = TF.layer_norm(lx, (d,), lg, lb, 1e-5)
            lib = time_ms(lambda: torch.autograd.grad(
                lout, (lx, lg, lb), dy, retain_graph=True), graph=False)
            elt = x.element_size()
            nbytes = (3 * n_rows * d + d) * elt + 2 * d * 4
            bms, by = bound(nbytes, 12 * n_rows * d, dname(dt))
            log(f"{tag}: kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                f"{lib:.4f} bound_ms {bms:.5f} ({by}) max_err dx "
                f"{err:.3e} dgamma/dbeta {err_s:.3e} Function {err_f:.3e}")
            if (n_rows, d) == (24576, 768) and dt == torch.bfloat16:
                rows["layer_norm_bwd"] = dict(
                    name="K5 layer_norm_bwd", route="triton",
                    source="paddle_tpu_torch/kernels/layer_norm.py",
                    replaces="paddle_tpu/kernels/layer_norm.py:60",
                    max_abs_err=max(err, err_f), ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib,
                    shape="x, dy [24576, 768] bf16 (train step); kernel_ms "
                          "includes the wrapper's two partial-sum "
                          "reductions")


# K7 at ResNet-50's four identity-block geometries and its stage-1 block-0
# projection geometry: (H = W, Cin, Cm, Cout, proj)
K7_GEOMETRIES = ((56, 256, 64, 256, False), (28, 512, 128, 512, False),
                 (14, 1024, 256, 1024, False), (7, 2048, 512, 2048, False),
                 (56, 64, 64, 256, True))


def compare_k7(name, got, want, dtype, rows, failures):
    """K7 against its plain version.  float32: atol = rtol = 2e-5, the
    weight and affine grads (f32 sums over the rows, added with atomics
    in any order) atol 2e-5 * sqrt(rows).  bfloat16: a relu mask whose
    pre-activation lies within one rounding of 0 can fall the other way
    on the card (f32 sums in another order, one bf16 ulp of h0 or h1),
    and each such flip moves one element of dx or one column of a weight
    grad by about |dy|; so at least 99% of the elements must lie within
    atol = rtol = 3e-2 (x sqrt(rows) for the sums) and the whole tensor
    within 1e-2 relative Frobenius error."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    tol = TOL[dtype]
    atol = tol * (rows ** 0.5 if rows > 1 else 1.0)
    finite = bool(torch.isfinite(got).all())
    if dtype == "float32":
        if not (finite and torch.allclose(got, want, atol=atol, rtol=tol)):
            failures.append(f"{name}: max_abs_err {err:.3e} > atol {atol}")
        return err
    bad = ((got - want).abs() > atol + tol * want.abs()).float().mean().item()
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    if not (finite and bad <= 1e-2 and rel <= 1e-2):
        failures.append(f"{name}: {bad:.2e} of elements outside atol "
                        f"{atol:.3g}, relative Frobenius error {rel:.2e}")
    return err


def k7_inputs(rnd, n, hw, cin, cm, cout, proj, dt):
    """Seeded K7 inputs at He-like scales, affines near (1, 0) rounded to
    the activation dtype (as the model casts them), and a cotangent."""
    import torch

    x = rnd((n, hw, hw, cin), dt)
    ws = [rnd((cin, cm), dt, cin ** -0.5),
          rnd((3, 3, cm, cm), dt, (9 * cm) ** -0.5),
          rnd((cm, cout), dt, cm ** -0.5)]
    if proj:
        ws.append(rnd((cin, cout), dt, cin ** -0.5))
    widths = [cm] * 4 + [cout] * (4 if proj else 2)
    affs = [(rnd((c,), torch.float32, 0.3) + (1.0 if i % 2 == 0 else 0.0)
             ).to(dt) for i, c in enumerate(widths)]
    return x, ws, affs, rnd((n, hw, hw, cout), dt)


def k7_composition(x, ws, affs, proj):
    """The cuDNN composition of a bottleneck block: three (four)
    F.conv2d on channels-last views plus the elementwise tail, the
    library yardstick of K7 (several calls, not one)."""
    import torch
    import torch.nn.functional as TF

    def conv(t, w_oihw, pad=0):
        return TF.conv2d(t, w_oihw, padding=pad)

    def aff(t, a, b):
        return t * a[None, :, None, None] + b[None, :, None, None]

    xc = x.permute(0, 3, 1, 2)
    w1 = ws[0].t()[:, :, None, None]
    w2 = ws[1].permute(3, 2, 0, 1)
    w3 = ws[2].t()[:, :, None, None]
    h0 = torch.relu(aff(conv(xc, w1), affs[0], affs[1]))
    h1 = torch.relu(aff(conv(h0, w2, 1), affs[2], affs[3]))
    s = (aff(conv(xc, ws[3].t()[:, :, None, None]), affs[6], affs[7])
         if proj else xc)
    return torch.relu(aff(conv(h1, w3), affs[4], affs[5]) + s)


def fused_bottleneck_checks(rows, failures, rnd):
    """K7 forward and backward: raw launches and through the autograd
    Functions against the plain versions, in float32 (batch 2) and
    bfloat16 (batch 128, timed), at every geometry above."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    for dt, n in ((torch.float32, 2), (torch.bfloat16, 128)):
        for hw, cin, cm, cout, proj in K7_GEOMETRIES:
            d = dname(dt)
            x, ws, affs, dy = k7_inputs(rnd, n, hw, cin, cm, cout, proj, dt)
            w4 = ws[3] if proj else None
            aff = FB._pack_affines(affs, cout)
            tag = (f"K7 {hw}^2 {cin}/{cm}/{cout} {'proj' if proj else 'id'} "
                   f"n={n} {d}")
            rows_n = n * hw * hw
            y = FB._launch_fwd(x, *ws[:3], w4, aff, proj)
            y_ref = FB.fused_bottleneck_fwd_ref(x, *ws[:3], w4, aff, proj)
            err_f = compare_k7(tag + " y", y, y_ref, d, 1, failures)
            got = FB._launch_bwd(x, dy, *ws[:3], w4, aff, proj)
            want = FB.fused_bottleneck_bwd_ref(x, dy, *ws[:3], w4, aff, proj)
            err_b = compare_k7(tag + " dx", got[0], want[0], d, 1, failures)
            for name, g, w in zip(("dw1", "dw2", "dw3", "dw4", "daff"),
                                  got[1:], want[1:]):
                if g is not None:
                    err_b = max(err_b, compare_k7(f"{tag} {name}", g, w, d,
                                                  rows_n, failures))
            # through the Function: y and every grad, in the primals' dtype
            fn = FB.fused_bottleneck_proj if proj else FB.fused_bottleneck
            leaves = [t.clone().requires_grad_() for t in [x] + ws + affs]
            out = fn(*leaves)
            err_fy = compare_k7(tag + " Function y", out, y_ref, d, 1,
                                failures)
            grads = torch.autograd.grad(out, leaves, dy)
            err_fg = 0.0
            cmw = [want[0], *want[1:4]] + ([want[4]] if proj else [])
            daff = want[5]
            cmw += [daff[0, :cm], daff[1, :cm], daff[2, :cm], daff[3, :cm],
                    daff[4], daff[5]] + ([daff[6], daff[7]] if proj else [])
            for i, (g, w) in enumerate(zip(grads, cmw)):
                if g.dtype != leaves[i].dtype:
                    failures.append(f"{tag} Function grad {i} dtype {g.dtype}")
                err_fg = max(err_fg, compare_k7(
                    f"{tag} Function grad {i}", g, w.to(g.dtype), d,
                    1 if i == 0 else rows_n, failures))
            del leaves, out, grads, got, want, cmw
            msg = (f"{tag}: max_err fwd {err_f:.3e} bwd {err_b:.3e} "
                   f"Function y {err_fy:.3e} grads {err_fg:.3e}")
            if dt == torch.bfloat16:
                timed = k7_times(x, ws, affs, aff, dy, proj, n, hw, cin, cm,
                                 cout)
                msg += "; " + " ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                       else f"{k} {v}"
                                       for k, v in timed.items())
                if not proj and hw == 56:
                    common = dict(route="cuda",
                                  source="paddle_tpu_torch/csrc/"
                                         "fused_bottleneck.cu")
                    shape = (f"x [128, 56, 56, 256], Cm 64 (stage 1 identity "
                             "block) bf16")
                    rows["fused_bottleneck_fwd"] = dict(
                        name="K7 fused_bottleneck_fwd",
                        replaces="paddle_tpu/kernels/fused_bottleneck.py:180",
                        max_abs_err=max(err_f, err_fy), ms=timed["fwd_ms"],
                        plain_ms=timed["plain_fwd_ms"],
                        bound_ms=timed["fwd_bound_ms"],
                        bound_by=timed["fwd_bound_by"],
                        library_ms=timed["cudnn_fwd_ms"], shape=shape
                        + "; library: the cuDNN composition (3 convs + "
                          "elementwise), not one call", **common)
                    rows["fused_bottleneck_bwd"] = dict(
                        name="K7 fused_bottleneck_bwd",
                        replaces="paddle_tpu/kernels/fused_bottleneck.py:205",
                        max_abs_err=max(err_b, err_fg), ms=timed["bwd_ms"],
                        plain_ms=timed["plain_bwd_ms"],
                        bound_ms=timed["bwd_bound_ms"],
                        bound_by=timed["bwd_bound_by"],
                        library_ms=timed["cudnn_bwd_ms"], shape=shape
                        + "; kernel_ms is both backward kernels and the "
                          "wrapper's zeroed grad buffers; library: the cuDNN "
                          "composition's backward", **common)
            log(msg)
            del x, ws, affs, dy, aff, y, y_ref
            torch.cuda.empty_cache()


def k7_times(x, ws, affs, aff, dy, proj, n, hw, cin, cm, cout):
    """Device ms of K7 forward and backward, the plain versions and the
    cuDNN composition (forward, and backward through autograd), and the
    bounds: forward 2 R (Cin Cm + 9 Cm^2 + Cm Cout [+ Cin Cout]) FLOP
    against x, the weights, the affines and y; backward 3x those FLOP
    (the recompute and two products per conv) against x, dy, the
    weights and affines read and dx, the f32 weight and affine grads
    written."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    w4 = ws[3] if proj else None
    out = {}
    out["fwd_ms"] = time_ms(lambda: FB._launch_fwd(x, *ws[:3], w4, aff,
                                                   proj), 5, graph=False)
    out["bwd_ms"] = time_ms(lambda: FB._launch_bwd(x, dy, *ws[:3], w4, aff,
                                                   proj), 5, graph=False)
    out["plain_fwd_ms"] = time_ms(lambda: FB.fused_bottleneck_fwd_ref(
        x, *ws[:3], w4, aff, proj), 3, graph=False)
    out["plain_bwd_ms"] = time_ms(lambda: FB.fused_bottleneck_bwd_ref(
        x, dy, *ws[:3], w4, aff, proj), 3, graph=False)
    leaves = [t.clone().requires_grad_() for t in [x] + ws + affs]
    with torch.no_grad():
        out["cudnn_fwd_ms"] = time_ms(lambda: k7_composition(
            leaves[0], leaves[1:1 + len(ws)], leaves[1 + len(ws):], proj), 5,
            graph=False)
    lout = k7_composition(leaves[0], leaves[1:1 + len(ws)],
                          leaves[1 + len(ws):], proj)
    ldy = dy.permute(0, 3, 1, 2)
    out["cudnn_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        lout, leaves, ldy, retain_graph=True), 5, graph=False)
    del lout, leaves
    r = n * hw * hw
    elt = x.element_size()
    flops = 2.0 * r * (cin * cm + 9 * cm * cm + cm * cout
                       + (cin * cout if proj else 0))
    wbytes = sum(w.numel() for w in ws) * elt + aff.numel() * 4
    fb, fby = bound(r * (cin + cout) * elt + wbytes, flops, "bfloat16")
    bb, bby = bound(r * (2 * cin + cout) * elt + wbytes
                    + (sum(w.numel() for w in ws) + aff.numel()) * 4,
                    3 * flops, "bfloat16")
    out.update(fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb,
               bwd_bound_by=bby, gflop_fwd=flops / 1e9)
    return out


# ---------------------------------------------------------------------------
# phase 3: the train path
# ---------------------------------------------------------------------------

TRAIN_LAUNCHES = {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
                  "flash_attention_bwd_dkv": 12, "layer_norm_fwd": 25,
                  "layer_norm_bwd": 25}
H100_BF16_FLOPS = 989e12


def train_phase(failures):
    """bench.py's headline configuration (bench_bert): BERT-base geometry
    GPT in bf16, batch 48 x seq 512, AdamW(1e-4), through the port's
    make_train_step."""
    import torch

    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                    num_heads=12, max_seq_len=512, dtype="bfloat16")
    batch, seq, steps = 48, 512, 5
    model = GPT(cfg, device="cuda", generator=make_generator(0))
    opt = AdamW(1e-4)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                        dtype=torch.int32, device="cuda")
    y = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                        dtype=torch.int32, device="cuda")
    n_dense = sum(p.numel() for n, p in model.named_parameters()
                  if "wpe" not in n)                 # includes tied wte head
    tokens = batch * seq
    flops = (6.0 * n_dense + 12.0 * cfg.num_layers * cfg.hidden_size * seq) \
        * tokens
    log(f"train: BERT-base-geometry GPT bf16, {n_dense} dense parameters, "
        f"batch {batch} x seq {seq}, {flops:.4e} FLOP per step")

    t0 = time.perf_counter()
    state, loss = step(state, x, y)         # warm-up: Triton JIT, cuBLAS
    losses = [float(loss)]
    log(f"train warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"loss {losses[0]:.6f}")
    torch.cuda.reset_peak_memory_stats()

    backend.reset_launches()
    step_ms = []
    for i in range(steps):
        before = dict(backend.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        losses.append(float(loss))           # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        made = {n: c - before.get(n, 0) for n, c in backend.LAUNCHES.items()}
        made = {n: c for n, c in made.items() if c}
        if made != TRAIN_LAUNCHES:
            failures.append(f"train step {i} launches {made} != "
                            f"{TRAIN_LAUNCHES}")
    launches = dict(backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    mean_ms = sum(step_ms) / steps
    log(f"train: {steps} steps, step ms {[round(t, 3) for t in step_ms]}, "
        f"mean {mean_ms:.3f} ms, min {min(step_ms):.3f} ms; tokens/s "
        f"{tokens / (mean_ms / 1e3):.1f}; MFU {flops / (mean_ms / 1e3) / H100_BF16_FLOPS:.4f} "
        f"(bench.py FLOP count over 989 TFLOP/s bf16, mean step); peak "
        f"memory {peak / 2 ** 30:.3f} GiB")
    log(f"train losses {losses}")
    log(f"train path launches ({steps} steps): {launches}")
    if not all(np.isfinite(losses)):
        failures.append(f"train losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        failures.append(f"train loss did not fall: {losses}")
    for name in TRAIN_LAUNCHES:
        if launches.get(name, 0) < 1:
            failures.append(f"{name} never launched on the train path")
    profile_train_step(step, state, (x, y), mean_ms)
    del model, state, step
    torch.cuda.empty_cache()
    return launches


def profile_train_step(step, state, batch, host_ms, label="train"):
    """Where a train step's time goes: device time per step and the
    busiest kernels (torch.profiler, kernel events only), against the
    step's host-clock time measured without the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, *batch)
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(r[0] for r in rows) / 1e3
    log(f"{label} step profile: host {host_ms:.3f} ms/step (mean, no "
        f"profiler), device {device_ms:.3f} ms/step, device busy "
        f"{device_ms / host_ms:.1%}; {sum(r[1] for r in rows)} kernel "
        f"launches")
    for us, count, key in sorted(rows, reverse=True)[:14]:
        log(f"  {us / 1e3:9.4f} ms  {us / device_ms / 10:5.1f}%  "
            f"{count:5d}x  {key[:90]}")


# ---------------------------------------------------------------------------
# phase 4: the ResNet-50 train path
# ---------------------------------------------------------------------------

RESNET50_FWD_FLOPS_224 = 4.089e9       # bench.py's per-image forward count
RESNET_LAUNCHES = {"fused_bottleneck_fwd": 12, "fused_bottleneck_bwd": 12}


def resnet_run(fused, failures, steps=5, batch=128):
    """bench.py `resnet50_time_config` (bench_resnet50_fused with fused,
    bench_resnet50 without): ResNet-50 bf16 NHWC, ghost batch norm over
    16 samples, Momentum(0.1, 0.9), cross-entropy, one seeded batch of
    128 x 3 x 224 x 224 repeated; one warm-up step and `steps` timed
    ones.  Returns (launches over the timed steps, mean step ms)."""
    import torch

    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer import Momentum

    label = "resnet fused" if fused else "resnet unfused"
    model = resnet50(dtype="bfloat16", data_format="NHWC",
                     bn_stats_sample=16, fused=fused, device="cuda",
                     generator=make_generator(0))
    n_fused = sum(b._fused for b in model.blocks)
    if n_fused != (12 if fused else 0):
        failures.append(f"{label}: {n_fused} fused blocks")
    opt = Momentum(0.1, 0.9)
    state = init_train_state(model, opt)
    step = make_train_step(
        model, opt, loss_fn=lambda m, a, b: F.cross_entropy(m(a), b).mean())
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((batch, 3, 224, 224)),
                        dtype=torch.bfloat16, device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, (batch,)), dtype=torch.int32,
                        device="cuda")
    t0 = time.perf_counter()
    state, loss = step(state, x, y)
    losses = [float(loss)]
    log(f"{label} warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"loss {losses[0]:.6f}")
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    step_ms = []
    for i in range(steps):
        before = dict(backend.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        made = {k: c - before.get(k, 0) for k, c in backend.LAUNCHES.items()}
        made = {k: c for k, c in made.items() if c}
        want = RESNET_LAUNCHES if fused else {}
        if made != want:
            failures.append(f"{label} step {i} launches {made} != {want}")
    launches = dict(backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    mean_ms = sum(step_ms) / steps
    mfu = 3.0 * RESNET50_FWD_FLOPS_224 * batch / (mean_ms / 1e3) \
        / H100_BF16_FLOPS
    log(f"{label}: {steps} steps, step ms {[round(t, 3) for t in step_ms]}, "
        f"mean {mean_ms:.3f} ms, min {min(step_ms):.3f} ms; images/s "
        f"{batch / (mean_ms / 1e3):.1f}; MFU {mfu:.4f} (bench.py: 3 x "
        f"4.089e9 FLOP per image over 989 TFLOP/s bf16, mean step); peak "
        f"memory {peak / 2 ** 30:.3f} GiB")
    log(f"{label} losses {losses}; launches ({steps} steps): {launches}")
    if not all(np.isfinite(losses)):
        failures.append(f"{label} losses not finite: {losses}")
    # the falling loss is the fused path's check; the unfused step is
    # the yardstick of its time
    if fused and not losses[-1] < losses[0]:
        failures.append(f"{label} loss did not fall: {losses}")
    profile_train_step(step, state, (x, y), mean_ms, label=label)
    del model, state, step
    torch.cuda.empty_cache()
    return launches, mean_ms


def resnet_phase(failures):
    """The fused step (K7 on the 12 identity blocks, subset `id`) and
    the unfused step beside it, in one call on one card."""
    import os

    os.environ["PADDLE_TPU_FUSED_SUBSET"] = "id"
    launches, fused_ms = resnet_run(True, failures)
    for name in RESNET_LAUNCHES:
        if launches.get(name, 0) < 1:
            failures.append(f"{name} never launched on the ResNet path")
    _, unfused_ms = resnet_run(False, failures)
    log(f"resnet: fused (K7, subset id) {fused_ms:.3f} ms/step against "
        f"unfused {unfused_ms:.3f} ms/step ({unfused_ms / fused_ms:.3f}x)")
    return launches


# ---------------------------------------------------------------------------
# phase 5: the serving path
# ---------------------------------------------------------------------------

def path_phase(failures):
    import torch

    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import generate as G
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = GPTConfig(dtype="bfloat16")
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda", generator=make_generator(0)).eval()
    log(f"GPT-2 small bf16 built in {time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 256), dtype=np.int32)
    # engine requests, drawn before the timed window
    lens = rng.integers(100, 513, size=16)
    news = rng.integers(16, 97, size=16)
    reqs = [(rng.integers(0, cfg.vocab_size, size=int(n), dtype=np.int32),
             int(m)) for n, m in zip(lens, news)]

    # warm-up at the same shapes (cuBLAS heuristics, Triton's compile)
    G.generate(model, prompts, max_new_tokens=2)
    torch.cuda.synchronize()

    backend.reset_launches()
    # a. generate(): 1 prefill (S=256 -> K1) + 127 decode steps over a
    #    384-deep cache (-> K6), every LayerNorm through K4
    t0 = time.perf_counter()
    out = G.generate(model, prompts, max_new_tokens=128)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    after_gen = dict(backend.LAUNCHES)
    log(f"generate: 4 x (256 + 128) tokens in {gen_s:.3f} s "
        f"({4 * 128 / gen_s:.1f} new tokens/s); launches {after_gen}")
    if tuple(out.shape) != (4, 128) or out.dtype != torch.int32 \
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        failures.append(f"generate output {tuple(out.shape)} {out.dtype} "
                        "out of range")
    want = {"flash_attention_fwd": 12, "layer_norm_fwd": 25 * 128,
            "flash_decode": 12 * 127}
    if after_gen != want:
        failures.append(f"generate launches {after_gen} != {want} "
                        "(K1 x12, K4 x25 per prefill; K6 x12, K4 x25 per "
                        "decode step)")

    # b. the continuous-batching engine
    t0 = time.perf_counter()
    eng = DecodeEngine(model, config=DecodeConfig(
        slots=8, max_len=1024, buckets=(128, 256, 512), label="smoke"))
    log(f"engine prewarmed {eng.prewarmed} programs in "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        t0 = time.perf_counter()
        futs = [eng.submit(p, m) for p, m in reqs]
        results = [f.result(timeout=600) for f in futs]
        serve_s = time.perf_counter() - t0
    finally:
        eng.close()
    summary = eng.summary()
    dec = summary["decode"]
    log(f"engine: {len(reqs)} requests in {serve_s:.3f} s; tokens/s "
        f"{dec.get('tokens_per_s')}; ttft p50 "
        f"{dec.get('ttft', {}).get('p50_ms')} ms; inter-token p50 "
        f"{dec.get('token_latency', {}).get('p50_ms')} ms; occupancy "
        f"{dec.get('slot_occupancy_mean')}")
    log("engine summary: " + json.dumps(summary, sort_keys=True))
    for (p, m), got in zip(reqs, results):
        if len(got) != m or got.min() < 0 or got.max() >= cfg.vocab_size:
            failures.append(f"engine output for prompt {len(p)} / {m} new "
                            f"is {got.shape} or out of range")
    if summary["outcomes"]["completed"] != len(reqs):
        failures.append(f"engine outcomes {summary['outcomes']}")

    # c. every kernel of the path launched in this window
    launches = dict(backend.LAUNCHES)
    log(f"path launches (generate + engine): {launches}")
    for name in ("flash_attention_fwd", "layer_norm_fwd", "flash_decode"):
        if launches.get(name, 0) < 1:
            failures.append(f"{name} never launched on the main path")
    params = G.build_decode_params(model)
    with torch.inference_mode():
        cache = G.init_cache(params.cfg, 4, 384, device="cuda")
        logits = G.prefill(params, torch.as_tensor(prompts, device="cuda"),
                           cache)
    if tuple(logits.shape) != (4, cfg.vocab_size) \
            or not bool(torch.isfinite(logits.float()).all()):
        failures.append("prefill logits not finite or misshapen")
    profile_decode(params, cache, logits)
    del model, eng
    torch.cuda.empty_cache()
    return launches


def profile_decode(params, cache, logits, steps=16):
    """Where a generate() decode step's time goes: host time per step
    (timed without the profiler), device time per step and the busiest
    kernels (torch.profiler, kernel events only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import generate as G

    token = torch.argmax(logits, dim=-1).to(torch.int32)

    def run(first):
        tok = token
        for i in range(steps):
            tok = torch.argmax(G.decode_step(params, tok, cache, first + i),
                               dim=-1).to(torch.int32)
        torch.cuda.synchronize()

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(256)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(256 + steps)
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(r[0] for r in rows) / 1e3 / steps
    log(f"decode step profile (batch 4, cache 384, {steps} steps): host "
        f"{host_ms:.3f} ms/step, device {device_ms:.3f} ms/step, device "
        f"busy {device_ms / host_ms:.1%}")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {us / 1e3 / steps:8.4f} ms/step  {count / steps:5.1f}/step  "
            f"{key[:90]}")


# ---------------------------------------------------------------------------
# phase 6: float32 checks
# ---------------------------------------------------------------------------

def _margin(logits):
    """Relative gap between the two largest logits of one row."""
    top1, top2 = logits.float().topk(2).values.tolist()
    return (top1 - top2) / max(abs(top1), 1e-6)


def train_check(failures, steps=3, lr=1e-4):
    """The train geometry at full width (vocab 32768, hidden 768, 12
    heads) and depth 2, f32, batch 2 x seq 256: first-step grads and 3
    AdamW steps on the card (kernels) against the CPU (plain versions)
    from the same weights.  Tolerances: loss 1e-4 relative; grads 1e-3
    of each tensor's max |grad| (floored at 1e-4 of the largest grad of
    all); params atol 2 * lr * steps + 1e-5
    (Adam's first updates are about lr * sign(g), so a grad element near
    0 that the two devices round to opposite signs moves that element by
    up to 2 lr per step)."""
    import torch

    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import load_param_dict, make_generator
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=2,
                    num_heads=12, max_seq_len=512)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 256), dtype=np.int32)
    labels = np.roll(ids, -1, axis=1)
    runs, start = {}, None
    for dev in ("cuda", "cpu"):
        model = GPT(cfg, device=dev, generator=make_generator(2))
        if start is None:
            start = {n: p.detach().cpu().clone()
                     for n, p in model.named_parameters()}
        else:
            load_param_dict(model, start)
        x = torch.as_tensor(ids, device=dev)
        y = torch.as_tensor(labels, device=dev)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(model.loss(x, y),
                                    list(model.parameters()))
        grads = {n: g.cpu() for n, g in zip(names, grads)}
        opt = AdamW(lr)
        state = init_train_state(model, opt)
        step = make_train_step(model, opt)
        losses = []
        for _ in range(steps):
            state, loss = step(state, x, y)
            losses.append(float(loss))
        runs[dev] = dict(grads=grads, losses=losses,
                         params={n: p.detach().cpu()
                                 for n, p in state.params.items()})
    card, cpu = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
    # each tensor's error against its own scale, floored at 1e-4 of the
    # largest grad: the k_proj biases get an analytically zero grad (a
    # bias on every key shifts a softmax row by a constant), so their
    # grads are rounding noise on both devices
    top = max(g.abs().max().item() for g in cpu["grads"].values())
    grad_err, grad_worst = max(
        ((card["grads"][n] - g).abs().max().item()
         / max(g.abs().max().item(), 1e-4 * top), n)
        for n, g in cpu["grads"].items())
    atol = 2 * lr * steps + 1e-5
    param_err = max((card["params"][n] - p).abs().max().item()
                    for n, p in cpu["params"].items())
    log(f"f32 train check (vocab 32768, hidden 768, 2 layers, batch 2 x "
        f"256, {steps} AdamW({lr}) steps), card vs CPU: losses card "
        f"{card['losses']} CPU {cpu['losses']} (max rel err "
        f"{loss_err:.3e}); first-step grads max err / scale "
        f"{grad_err:.3e} ({grad_worst}); params max abs err "
        f"{param_err:.3e} (atol "
        f"{atol:.1e})")
    if not loss_err <= 1e-4:
        failures.append(f"train check losses differ: {loss_err:.3e} > 1e-4")
    if not grad_err <= 1e-3:
        failures.append(f"train check grads differ: {grad_err:.3e} > 1e-3 "
                        "of scale")
    if not param_err <= atol:
        failures.append(f"train check params differ: {param_err:.3e} > "
                        f"{atol:.1e}")
    if not card["losses"][-1] < card["losses"][0]:
        failures.append(f"train check loss did not fall: {card['losses']}")
    del runs, card, cpu
    torch.cuda.empty_cache()


def _rel(a, b, floor=0.0):
    """||a - b|| / max(||b||, floor)."""
    return (a - b).norm().item() / max(b.norm().item(), floor, 1e-30)


def resnet_check(failures, steps=2, lr=1e-5):
    """A shallow NHWC ResNet-50 (full widths, depths [2, 2, 2, 2]: one
    identity block per stage, all four through K7 under subset `id`),
    f32, batch 8 x 3 x 128 x 128, ghost batch norm over 4 samples: the
    first step's grads and 2 Momentum steps on the card (kernels) against
    the CPU (plain versions) from the same weights.

    At random init this net is steep (one step of lr 1e-5 moves the loss
    from 7.63 to 7.37) and its conv-weight grads are sums that batch norm
    nearly cancels, so f32 rounding alone moves them by up to about 1% of
    a tensor's norm (against a float64 copy of the same net on the CPU).
    A relu mask within a rounding of 0
    that falls the other way on the card re-routes one element's
    gradient on top of that.  The lr is small enough that the second step
    does not amplify the first step's difference (at lr 1e-3 it grows
    ~10x).  Held: the first loss 1e-4 relative, the second 1e-3; per
    tensor, ||card - cpu|| <= 5e-2 max(||cpu||, 1e-2 max over tensors)
    for the first step's grads and for the params' update after 2 steps;
    the batch-norm buffers 1e-3 relative in norm."""
    import os

    import torch

    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import (
        functional as F, functional_call_with_state, load_param_dict,
        make_generator,
    )
    from paddle_tpu_torch.optimizer import Momentum

    os.environ["PADDLE_TPU_FUSED_SUBSET"] = "id"
    loss_fn = lambda m, a, b: F.cross_entropy(m(a), b).mean()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 3, 128, 128)).astype(np.float32)
    y = rng.integers(0, 1000, (8,)).astype(np.int32)
    runs, start = {}, None
    for dev in ("cuda", "cpu"):
        model = ResNet(BottleneckBlock, [2, 2, 2, 2], data_format="NHWC",
                       fused=True, device=dev, generator=make_generator(3))
        for m in model.modules():
            if hasattr(m, "_stats_sample"):
                m._stats_sample = 4
        if start is None:
            start = {n: p.detach().cpu().clone()
                     for n, p in model.named_parameters()}
        else:
            load_param_dict(model, start)
        xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
        params = dict(model.named_parameters())
        names = list(params)
        loss, _ = functional_call_with_state(
            model, params, dict(model.named_buffers()), xt, yt,
            _method=loss_fn)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        grads = {n: g.cpu() for n, g in zip(names, grads)}
        opt = Momentum(lr, 0.9)
        state = init_train_state(model, opt)
        step = make_train_step(model, opt, loss_fn=loss_fn)
        backend.reset_launches()
        losses = []
        for _ in range(steps):
            state, loss = step(state, xt, yt)
            losses.append(float(loss))
        if dev == "cuda" and dict(backend.LAUNCHES) != {
                "fused_bottleneck_fwd": 4 * steps,
                "fused_bottleneck_bwd": 4 * steps}:
            failures.append(f"resnet check launches {dict(backend.LAUNCHES)}")
        runs[dev] = dict(
            grads=grads, losses=losses,
            params={n: p.detach().cpu() for n, p in state.params.items()},
            buffers={n: b.cpu() for n, b in state.buffers.items()})
    card, cpu = runs["cuda"], runs["cpu"]
    first_err = abs(card["losses"][0] - cpu["losses"][0]) \
        / abs(cpu["losses"][0])
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
    top = max(g.norm().item() for g in cpu["grads"].values())
    grad_err, grad_worst = max((_rel(card["grads"][n], g, 1e-2 * top), n)
                               for n, g in cpu["grads"].items())
    grad_max, max_worst = max(
        ((card["grads"][n] - g).abs().max().item() / g.abs().max().item(),
         n) for n, g in cpu["grads"].items())
    update = {n: p - start[n] for n, p in cpu["params"].items()}
    top_update = max(u.norm().item() for u in update.values())
    param_err, param_worst = max(
        (_rel(card["params"][n] - start[n], u, 1e-2 * top_update), n)
        for n, u in update.items())
    buf_err, buf_worst = max((_rel(card["buffers"][n], b), n)
                             for n, b in cpu["buffers"].items())
    log(f"f32 ResNet check (ResNet-50 widths, depths [2, 2, 2, 2], NHWC, "
        f"4 K7 blocks, batch 8 x 128 x 128, ghost batch 4, {steps} "
        f"Momentum({lr}) steps), card vs CPU: losses card {card['losses']} "
        f"CPU {cpu['losses']} (rel err first {first_err:.3e}, max "
        f"{loss_err:.3e}); first-step "
        f"grads: worst relative norm error {grad_err:.3e} ({grad_worst}), "
        f"worst max error / max |grad| {grad_max:.3e} ({max_worst}); "
        f"params: worst ||card - cpu|| / ||update|| {param_err:.3e} "
        f"({param_worst}); buffers: worst relative norm error "
        f"{buf_err:.3e} ({buf_worst})")
    if not (first_err <= 1e-4 and loss_err <= 1e-3):
        failures.append(f"resnet check losses differ: first {first_err:.3e}"
                        f", max {loss_err:.3e}")
    if not grad_err <= 5e-2:
        failures.append(f"resnet check grads differ: {grad_err:.3e}")
    if not param_err <= 5e-2:
        failures.append(f"resnet check params differ: {param_err:.3e}")
    if not buf_err <= 1e-3:
        failures.append(f"resnet check buffers differ: {buf_err:.3e}")
    del runs, card, cpu
    torch.cuda.empty_cache()


def check_phase(failures):
    import torch

    train_check(failures)
    resnet_check(failures)

    from paddle_tpu_torch.models import generate as G
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import load_param_dict, make_generator
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = GPTConfig()
    model = GPT(cfg, device="cuda", generator=make_generator(1)).eval()
    rng = np.random.default_rng(1)

    # card (kernels) against CPU (plain versions), same weights
    ids = rng.integers(0, cfg.vocab_size, size=(1, 128), dtype=np.int32)
    cpu = GPT(cfg, device="cpu", generator=make_generator(1)).eval()
    load_param_dict(cpu, {n: p.detach().cpu()
                          for n, p in model.named_parameters()})
    with torch.inference_mode():
        card_logits = model(torch.as_tensor(ids, device="cuda")).cpu()
        cpu_logits = cpu(torch.as_tensor(ids))
    err = (card_logits - cpu_logits).abs().max().item()
    scale = cpu_logits.abs().max().item()
    log(f"f32 GPT-2 small logits, card vs CPU, [1, 128]: max_abs_err "
        f"{err:.3e} (max |logit| {scale:.3e})")
    if not err <= 1e-3 * scale:
        failures.append(f"card vs CPU logits differ: {err:.3e} > "
                        f"1e-3 * {scale:.3e}")
    del cpu

    # engine against generate(): prompt lengths equal a bucket and
    # prompt + new is a multiple of 128, so both go through K1 and K6
    cases = [(128, 128), (256, 128), (128, 256), (256, 256)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
               for n, _ in cases]
    eng = DecodeEngine(model, config=DecodeConfig(
        slots=4, max_len=512, buckets=(128, 256), label="parity"))
    try:
        futs = [eng.submit(p, m) for p, (_, m) in zip(prompts, cases)]
        got = [f.result(timeout=600) for f in futs]
    finally:
        eng.close()
    params = G.build_decode_params(model)
    for p, (n, m), tokens in zip(prompts, cases, got):
        ref = G.generate(params, p[None], m).cpu().numpy()[0]
        if np.array_equal(tokens, ref):
            log(f"f32 engine == generate() for prompt {n}, {m} new: "
                "token-exact")
            continue
        step = int(np.argmax(tokens != ref))
        # generate()'s logits at that step, teacher-forced on its tokens
        with torch.inference_mode():
            cache = G.init_cache(params.cfg, 1, n + m, device="cuda")
            logits = G.prefill(params, torch.as_tensor(p[None],
                                                       device="cuda"), cache)
            for i in range(step):
                logits = G.decode_step(
                    params, torch.as_tensor(ref[i:i + 1], device="cuda"),
                    cache, n + i)
        margin = _margin(logits[0])
        log(f"f32 engine != generate() for prompt {n}, {m} new: first "
            f"mismatch at step {step}; generate()'s top-2 margin "
            f"{margin:.3e} relative")
        if margin > 1e-3:
            failures.append(f"engine/generate disagree at step {step} "
                            f"with margin {margin:.3e} > 1e-3")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.kernels import backend
    except ImportError as e:
        print(f"chip_smoke: the paddle_tpu_torch package is missing ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 3

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} capability "
        f"{torch.cuda.get_device_capability(0)} hopper {backend.is_hopper()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    backend.build()
    log(f"kernel build (nvcc, {len(backend.SOURCES)} sources in parallel): "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in backend.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    failures = []
    phases = (("kernels", kernel_phase), ("train", train_phase),
              ("resnet", resnet_phase), ("path", path_phase),
              ("checks", check_phase))
    results = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            results[name] = fn(failures)
        except Exception as e:  # noqa: BLE001 - report the phase, fail
            import traceback

            traceback.print_exc()
            failures.append(f"phase {name} raised {type(e).__name__}: {e}")
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1

    rows = results["kernels"]
    kernels = []
    for key in ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv", "layer_norm_fwd",
                "layer_norm_bwd", "flash_decode", "fused_bottleneck_fwd",
                "fused_bottleneck_bwd"):
        row = dict(rows[key])
        # launches on the main paths: the 5 timed GPT train steps, the 5
        # timed fused ResNet-50 steps and the serving run (generate +
        # engine)
        row["launches"] = sum(results[p].get(key, 0)
                              for p in ("train", "resnet", "path"))
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
