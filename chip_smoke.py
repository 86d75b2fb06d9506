#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (paddle_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure makes the script exit non-zero without a result):

1. Card and build: print the card's name and power limit, turn TF32
   off, build the CUDA kernels (one nvcc per source, in parallel) and
   print the build time and the compiler's register/spill report.
2. Kernels: hold K1 (flash-attention forward, CUDA), K2/K3 (its
   backward, CUDA), K4/K5 (LayerNorm forward/backward, Triton) and K6
   (flash decode, CUDA) against their plain PyTorch versions on the
   card, in float32 and bfloat16, and time the kernel, the plain
   version, one PyTorch library call computing the same function (a
   yardstick only; the port never calls it) and the bound (the larger
   of bytes over 3.35 TB/s and operations over the peak rate of the
   input type).  The backward kernels are checked both as raw launches
   and through their autograd Functions, at the train shapes
   (q [48, 12, 512, 64] causal, x [24576, 768]), at the serving shapes
   and non-causal at head_dim 128 and 256; their library yardstick is
   the backward of `F.scaled_dot_product_attention` / `F.layer_norm`,
   timed as `torch.autograd.grad(out, inputs, dout, retain_graph=True)`.
3. Train path: the repo's headline training configuration
   (`bench.py` `bench_bert`: a GPT of BERT-base geometry, vocab 32768,
   hidden 768, 12 layers, 12 heads, max_seq_len 512, bfloat16) with
   seeded weights takes one warm-up step and 5 timed steps of
   `make_train_step(model, AdamW(1e-4))` on one seeded batch of 48 x
   512 tokens.  Printed: step ms, tokens/s, MFU (bench.py's FLOP count
   over 989 TFLOP/s), peak memory and a torch.profiler breakdown of one
   step.  Fails unless every loss is finite, the last loss is below the
   first, and every step launches exactly K1, K2, K3 x12 and K4, K5 x25.
4. Serving path: GPT-2 small (vocab 50304, hidden 768, 12 layers, 12
   heads) in bfloat16 with seeded random weights serves greedy
   `generate()` on 4 prompts of 256 tokens (128 new) and a
   continuous-batching `DecodeEngine` (8 slots, max_len 1024, buckets
   128/256/512) over 16 seeded requests.  The launch counts are zeroed
   just before and read just after; every kernel must have launched.  A
   torch.profiler window over 16 decode steps then says where a step's
   time goes.
5. Checks in float32: the train geometry at full width and depth 2
   (batch 2, seq 256) takes 3 AdamW steps on the card (kernels) and on
   the CPU (plain versions) from the same weights; the loss streams, the
   first step's grads and the params must agree.  Then the card's
   GPT-2-small logits against the same model on the CPU for one
   128-token prompt, and engine tokens against `generate()` for prompts
   whose length equals a bucket.  A token mismatch fails only if
   `generate()`'s top-2 logit margin at that step is above 1e-3
   relative (a real disagreement, not a near-tie).

The last lines are the kernels' JSON line (K1-K6, each with its launches
on the train and serving paths), the card line and
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


def profile_train_step(step, state, batch, host_ms):
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
    log(f"train step profile: host {host_ms:.3f} ms/step (mean, no "
        f"profiler), device {device_ms:.3f} ms/step, device busy "
        f"{device_ms / host_ms:.1%}; {sum(r[1] for r in rows)} kernel "
        f"launches")
    for us, count, key in sorted(rows, reverse=True)[:14]:
        log(f"  {us / 1e3:9.4f} ms  {us / device_ms / 10:5.1f}%  "
            f"{count:5d}x  {key[:90]}")


# ---------------------------------------------------------------------------
# phase 4: the serving path
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
# phase 5: float32 checks
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


def check_phase(failures):
    import torch

    train_check(failures)

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
              ("path", path_phase), ("checks", check_phase))
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
                "layer_norm_bwd", "flash_decode"):
        row = dict(rows[key])
        # launches on the main paths: the 5 timed train steps plus the
        # serving run (generate + engine)
        row["launches"] = (results["train"].get(key, 0)
                           + results["path"].get(key, 0))
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
