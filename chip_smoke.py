#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (paddle_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure makes the script exit non-zero without a result):

1. Card and build: print the card's name and power limit, turn TF32
   off, build the CUDA kernels (one nvcc per source, in parallel) and
   print the build time and the compiler's register/spill report.
1b. SASS: `cuobjdump -sass` of K7's, K8's, K1's, K2/K3's and P1/P2's
   libraries; every bf16 K7 and K8 kernel that runs a product, the bf16
   K1, K2 and K3 kernels at each head dim, and bf16 P1 and P2 must hold
   tensor-core instructions (HMMA / HGMMA); the f32
   K1-K3 counts are printed as read (0 expected); the float16 forms of
   K1, K2 and K3 must hold them too, at each head dim.  K1's,
   K2's and
   K3's registers and spills per head dim from the ptxas report, the
   bf16 ones not spilling at head dim 64, and P1's and P2's, the bf16
   ones not spilling; K7's and K6's printed as read.
2. Kernels: hold K1 (flash-attention forward, CUDA), K2/K3 (its
   backward, CUDA), K4 (LayerNorm forward, Triton), K5 (its backward,
   CUDA; K4 at K4_SHAPES and K4_MORE_SHAPES, K5 in
   `layer_norm_bwd_checks`: K5_SHAPES and K5_MORE_SHAPES, the
   plan model, bitwise repeats, a NaN's footprint, a team-size sweep,
   occupancy), K6
   (flash decode, CUDA), K7 (the fused ResNet bottleneck block), K8
   (the stride-2 transition block) and K9 (the stem's batch-norm, relu
   and max-pool tail), each forward and backward in CUDA (K10 is held
   in phase 5, on the DGC state it runs on), against their
   plain PyTorch versions on
   the card, in float32 and bfloat16, and time the kernel, the plain
   version, one PyTorch library call computing the same function (a
   yardstick only; the port never calls it) and the bound (the larger
   of bytes over 3.35 TB/s and operations over the peak rate of the
   input type).  The backward kernels are checked both as raw launches
   and through their autograd Functions, at the train shapes
   (q [48, 12, 512, 64] causal, x [24576, 768]), at the serving shapes
   and non-causal at head_dim 128 and 256; K1-K3 also non-causal at the
   static GPT's attention, [8, 12, 512, 64], bf16 and f32 (inputs from a
   generator of their own: `flash_static_checks`); their library
   yardstick is
   the backward of `F.scaled_dot_product_attention` / `F.layer_norm`,
   timed as `torch.autograd.grad(out, inputs, dout, retain_graph=True)`.
   bf16 K1, K2 and K3 run on the tensor cores: `flash_precision` holds
   each of O, lse, dQ, dK, dV at the train shape and non-causal at head
   dims 128 and 256 to at most 1.5x the error of the rounding model (the
   plain versions with the reference's bf16 roundings of p and ds)
   against float64 products, and names the rule by which they sum (in
   the mma itself).  The float16 forms (`float16_checks`, inputs
   from generators of their own): K1, K2 and K3 at the train shape and at
   the static GPT's [8, 12, 512, 64] against their rounding model (p and
   ds rounded to float16 where the reference rounds them) at one float16
   ulp (2^-10; lse 2e-5), timed beside their plain versions, SDPA in
   float16 and their bounds (the static GPT's shape gives the kernels
   line's K1-K3 float16 rows), and held against float64 products at 1.5x
   the model's error; K4 at [4096, 768] and [24576, 768], K5 at
   [4096, 768] (gamma in float32 and in float16) and K6 at the generate
   decode shape in float16 against their plain versions.
   K6 (one launch split over the cache, `flash_attention.decode_plan`)
   is timed with L2 flushed at the generate decode shape (q [4, 12, 1,
   64], T 384, lengths 320; also at head dims 128 and 256), the engine's
   ragged [8, 12, 1, 64] over T 1024, one row over T 2048 (length 2000)
   and batch 32 over T 1024, each with its chunk, splits and blocks and
   bitwise equal over two calls; in bf16 again at planner targets of 1,
   2, 4 and 8 blocks per SM; then untimed at lengths 0, 1, the chunk
   boundary +-1, T and past T, and two geometries back to back.
   K7 is checked at ResNet-50's four identity-block geometries (56^2
   256/64, 28^2 512/128, 14^2 1024/256, 7^2 2048/512) and its stage-1
   block-0 projection geometry (56^2, 64 -> 256, Cm 64), batch 2 in
   float32 and batch 128 (timed, its backward split B1/B2/W/R by
   torch.profiler) in bfloat16, each with its launch plan; its yardstick
   is the cuDNN composition (three or four `F.conv2d` plus the
   elementwise tail, through autograd for the backward), several calls,
   not one.  In bf16 its error against float64 products may not exceed
   1.5x the plain version's unless the relu masks it chose account for
   the excess, and dW1-4 must be bitwise equal over two runs
   (`block_numerics`; at the projection geometry the same gate must
   fail two lower-precision controls); its times are summed over the 13
   launches of a full-fused step.
   K8 is checked the same way at ResNet-50's three transitions (56^2
   256 -> 512 Cm 128, 28^2 512 -> 1024 Cm 256, 14^2 1024 -> 2048 Cm
   512), with its launch plan printed (tile pixels, blocks, K slices of
   the weight-gradient GEMMs, scratch MB), and at ragged shapes (Cin,
   Cout not multiples of 16, Ho Wo not a multiple of 16, odd batch; and
   channels that are no multiple of 8, the element-wise loaders); its
   yardstick is the composition with the stride-2 3x3 and 1x1 convs.
   In bf16 its error against float64 products may not exceed 1.5x the
   plain version's at the transitions unless its relu masks account for
   the excess (`block_numerics`), and at the small
   tests' weight scale it must be that of a model of the tensor core's
   sums (`k8_precision`).  K9 is
   checked at the stem's [2 | 128, 112, 112, 64] in float32 | bfloat16
   on random and tie-heavy inputs (y and dc exactly, da/db within the
   tolerance and bitwise over two calls, raw and through `_StemTail`),
   raw at [2, 128, 128, 64] (the kernel has no side limit) and at
   ragged geometries and tilings (`stem_ragged`), each line with the
   backward's plan (`stem_plan`); at the stem in bf16 the backward is
   timed at each of K9_TILINGS (`k9_plan_sweep`); its yardstick is
   `F.max_pool2d(F.relu(c * a + b), 3, 2, 1)` (first-wins gradient).
   The f32 K7/K8 checks name their near-ties (`tools/near_ties.py`):
   relu inputs within the measured card noise of 0, counted on each
   line with the comparisons that needed them; what fails elementwise
   must lie in their footprint (the weight grads then in norm).
2b. Probes: P1 (K7's 3x3 conv alone) and P2 (its 1x1 chain and
   residual) against their plain versions at ResNet-50's stage-1
   geometry (56^2, Cin 256, Cm 64), f32 at batch 2 (2e-5) and bf16 at
   batches 8 and 128 (3e-2), from a generator of their own; at batch
   128 their times beside the plain versions, a library yardstick
   (`F.conv2d` channels-last; `relu(x @ w1) @ w3 + x`) and the bound;
   K7's stage-1 identity forward on the same x and weights beside them,
   split three ways: P1 (the 3x3), P2 (the 1x1 chain and the residual)
   and K7 - P1 - P2 (the halo's h0 product, the affines and the rest);
   both probes run K7's pieces at K7's forward tile rows and blocks per
   SM, checked at batch 128; each plan's tile rows and blocks per SM;
   then `python -m paddle_tpu_torch.tools.fused_probe`
   (all seven probes, each in its subprocess), failing unless every
   probe exits 0 having launched its kernel.
3. GPT train path: the repo's headline training configuration
   (`bench.py` `bench_bert`: a GPT of BERT-base geometry, vocab 32768,
   hidden 768, 12 layers, 12 heads, max_seq_len 512, bfloat16) with
   seeded weights takes one warm-up step and 5 timed steps of
   `make_train_step(model, AdamW(1e-4))` on one seeded batch of 48 x
   512 tokens.  Printed: step ms, tokens/s, MFU (bench.py's FLOP count
   over 989 TFLOP/s), peak memory and a torch.profiler breakdown of one
   step.  Fails unless every loss is finite, the last loss is below the
   first, every step launches exactly K1, K2, K3 x12 and K4, K5 x25, and
   each of the profiled step's 25 LayerNorm backwards (autograd nodes
   `_LayerNormBackward`) launches exactly one kernel, K5's.
4. ResNet-50 train path (`bench.py` `resnet50_time_config`, the
   `bench_resnet50_fused` row): ResNet-50, bfloat16, NHWC, ghost batch
   norm over 16 samples, `fused=True`, seeded weights, one warm-up step
   and 5 timed steps of `make_train_step(model, Momentum(0.1, 0.9))`
   with the cross-entropy loss on one seeded batch of 128 x 3 x 224 x
   224, in three runs: the full fused program (PADDLE_TPU_FUSED_SUBSET
   empty: 16 fused blocks and the fused stem), the `id` subset (the 12
   identity blocks) and unfused (`fused=False`, bench_resnet50's path,
   no port kernel, the yardstick).  Printed per run: step ms, images/s,
   MFU (3 x 4.089e9 FLOP per image over 989 TFLOP/s, as bench.py), peak
   memory and a profile of one step; then the three step times on one
   line.  Fails unless every loss is finite, the fused runs' last loss
   is below their first, and every step launches exactly K7 forward and
   backward 13 times, K8 3 times and K9 once (full) or K7 12 times
   (`id`).
5. DGC path (the data-parallel tier): the same ResNet-50 (bf16, NHWC,
   ghost batch norm over 16, batch 128, seeded weights) on the per-conv
   path (`fused=False`) through `fleet.make_train_step(model,
   Momentum(0.1, 0.9), loss, strategy)` on the one-rank NCCL group of
   `init_parallel_env()` (destroyed at the end of the phase), one
   warm-up and 3 timed steps each: DGC (sparsity 0.999, rampup 0) with
   FLAGS_use_pallas_dgc_topk on (the threshold from K10, launched
   exactly 161 times per step, once per trainable tensor), DGC with
   torch.topk, and the dense DataParallelTrainStep.  Printed per run:
   step ms, images/s, peak memory, launches and a profile of one step.
   Then K10 against its plain version, counts exactly equal, on the 322
   u and v tensors of the DGC state and on synthetic inputs (n = 1, n =
   65,537, all zeros, negative zeros, values on the edges, the largest
   tensor's 2,359,296 elements, f32 and bf16; and explicit edges:
   unsorted, with NaN, +-inf, +-0 and duplicates, sorted duplicates,
   all equal, all NaN, over values with NaN, +-inf and -0), its
   threshold (on the DGC path's edges) inside the
   reference's bracket (at least k kept, at most the elements within
   one bin of the exact k-th |v|); K10's time at the largest tensor
   beside its bound, its plain version and torch.topk(|v|, 2359), and
   over the 161 tensors of a step; and 3 f32 DGC steps of a shallow
   ResNet-50 (depths [1, 1, 1, 1], 64 x 64, batch 8, sparsity 0.99) on
   the card (K10) against the CPU (plain version), held as the ResNet
   check below holds its net, with every mask difference explained by
   the two sides' thresholds and their v's noise (`dgc_check`), and the
   same steps with K10's plain version on the card giving K10's masks.
6. Serving path: GPT-2 small (vocab 50304, hidden 768, 12 layers, 12
   heads) in bfloat16 with seeded random weights serves greedy
   `generate()` on 4 prompts of 256 tokens (128 new) and a
   continuous-batching `DecodeEngine` (8 slots, max_len 1024, buckets
   128/256/512) over 16 seeded requests.  The launch counts are zeroed
   just before and read just after; every kernel must have launched.  A
   torch.profiler window over 16 decode steps then says where a step's
   time goes, K6's device ms per step among it.
7. Static-graph path: the static zoo's GPT at BERT-base widths
   (`static_zoo.build_gpt(t=512, d=768, heads=12, vocab=32768)`, one
   transformer layer, float32) through
   `Executor.run` on the card: its startup, one warm-up and 5 timed Adam
   steps at batch 8, ids and targets uniform over the vocab
   (`static_feed`).  Printed: host ms per step, device
   ms per step and the top kernels (torch.profiler over 2 steps),
   kernels and Executor ops per step, peak memory.  Fails unless every
   loss is finite and each step launches exactly K4 and K5 twice (its
   two layer_norm ops).  The same GPT with FLAGS_amp and
   FLAGS_graph_opt_fuse on (`static_run(amp=True)`): the Executor runs
   its AMP-rewritten and fused substitute, which must carry one
   fused_attention computing in bfloat16, one fused_bias_act and two
   fused_layer_norm ops; each step must launch exactly K1, K2 and K3
   once and K4 and K5 twice (STATIC_AMP_LAUNCHES); the same readings,
   device ms by family (products, K1-K5, copies and casts) and by
   Executor op type, and one line against the plain run.  The same GPT
   again, built while
   `clip.set_gradient_clip(GradientClipByGlobalNorm(1.0))` is set
   (`static_clip_run`): the same steps, launches and readings, and each
   step's global norm and clip factor, the factor held against
   min(1, 1 / norm) recomputed from the fetched `@GRAD`s.  Then the
   static Wide&Deep at the CTR widths of bench.py's `bench_wide_deep`
   (`build_wide_deep(fields=26, vocab=1_000_000, dense=13)`, Adagrad,
   batch 8192, ids uniform over the vocab; `static_wide_deep_run`):
   samples/s, host and device ms, kernels a step, peak memory; fails on
   a non-finite loss.  Then card against CPU in float32
   (`static_check`): 3 steps of mlp, lenet, resnet, bert, gpt, seq2seq,
   wide_deep and word2vec at zoo size (batch 8), of two small programs
   with the regularizers and the gradient clips (`clip_decay`,
   `clip_value`: each clip shown to engage), and of
   `build_gpt(t=128, d=768, heads=12, vocab=1024)` at batch 2 (K4/K5 on
   the card, their plain versions on the CPU), plain and with the fusion
   tier on (K1-K3 in f32 too), from the same startup
   values; fetches within 1e-4 relative at the first step and 1e-3
   after, persistables per tensor in norm, and each persistable's update
   within 0.1 of the CPU's in norm (an Adam or Adagrad parameter's
   element by element, where only elements whose gradient lies near 0
   on the measured card-vs-CPU difference may be off).  Then the same
   GPT with AMP and fusion (`static_amp_check`: K1-K3 in bf16, K4/K5):
   losses within 3e-2 relative, each persistable's update within 0.1 of
   the CPU's in norm.  The same GPT with AMP in float16 and fusion
   (`static_run(amp=True, amp_dtype="float16")`, 3 timed steps): its
   fused_attention computes in float16 and each step launches K1-K3's
   float16 forms once and K4, K5 (f32: the residual stream stays f32)
   twice (STATIC_AMP_F16_LAUNCHES).
7b. IO, checkpoints, readers and the Predictor (`io_phase`): the
   static GPT at BERT-base widths, its for_test forward to the logits
   fused (and, once more, AMP-rewritten to bf16 first), saved with
   `io.save_inference_model` and served from disk by
   `inference.Predictor` on `cuda` at batch 8 (every run launches K1 once
   and K4 twice; held against `Executor.run` of the unfused for_test
   Program at 1e-4 / 3e-2 relative; host and device ms per run, peak
   memory); the f32 directory exported with `torch.export`
   (`save_compiled_inference_model`) and served by a `CompiledPredictor`
   (the same launches, within 1e-6 of the Predictor) and through the C
   API (`paddle_tpu_torch/csrc/predictor_capi.cpp`, g++, ctypes;
   bitwise equal to `Executor.run`); the static ResNet family through
   the Predictor with FLAGS_inference_fold off and on (op counts, 1e-4);
   resume equal to the uninterrupted run, bitwise (losses, parameters,
   moments, the generator): the dygraph GPT of phase 3 at depth 2 with
   dropout through `checkpoint.save_checkpoint` / `load_checkpoint`, and
   the static GPT with Adam through `io.save_persistables` /
   `load_persistables`, with save and load seconds and bytes; the static
   GPT's steps fed from numpy, from `DataLoader.from_generator` ->
   `device_prefetch(size=2)` and from `ShmBatchLoader` (2 forked workers)
   -> `device_prefetch`, losses bitwise equal, host ms per step, and the
   overlap of the prefetch's host-to-device copies with the step's
   kernels from a torch.profiler trace (printed, not gated).
8. Checks in float32: the train geometry at full width and depth 2
   (batch 2, seq 256) takes 3 AdamW steps on the card (kernels) and on
   the CPU (plain versions) from the same weights; the loss streams, the
   first step's grads and the params must agree.  The same with
   `make_train_step(amp=True)` (bf16 products, f32 master params):
   losses within 3e-2, each param's update within 0.1 of the CPU's in
   norm.  One `amp.make_amp_train_step` step of an MLP under float16
   autocast and a 2**100 loss scale must overflow, count one bad step
   and commit nothing.  A shallow NHWC
   ResNet-50 (full widths, depths [2, 2, 2, 2], the full fused program:
   K9, the projection K7, three K8 and four identity K7) takes 2
   Momentum steps at batch 8 x 128 x 128 on the card and on the CPU:
   losses, first-step grads, params and batch-norm buffers must agree
   (in norm per tensor, see `resnet_check`).  Then
   the card's GPT-2-small logits against the same model on the CPU for
   one 128-token prompt, and engine tokens against `generate()` for
   prompts whose length equals a bucket.  A token mismatch fails only if
   `generate()`'s top-2 logit margin at that step is above 1e-3
   relative (a real disagreement, not a near-tie).

`python3 chip_smoke.py compare [--parts P,...] TREE [TREE ...]` instead
times, for each tree in turn and in a process of its own (TREE a
directory holding a paddle_tpu_torch package, e.g. `.` and an unpacked
parent commit), the parts named (all by default): `k7`, K7 in bf16 at
batch 128 at its five geometries and summed over a full-fused step;
`train`, the GPT train step of phase 3 (host ms, device ms, K1, K2,
K3 and K5 per step from its profile, its kernel count and the kernels
of each LayerNorm backward); `ln`, the tree's `_launch_bwd` (K5) at
[24576, 768] bf16, in L2 and L2 flushed; `resnet`, the full fused and `id`
ResNet-50 steps of phase 4 with their profiles; `probes`, P1, P2 and
K7's stage-1 forward of phase 2b; `decode`, the decode-step profile of
phase 6 (host and device ms per step, K6's share); `stem`, K9 forward
and backward at the stem (bf16 batch 128) with the backward's plan;
`dgc`, the DGC step with K10 of phase 5 (host ms, device ms and K10's
share per step), K10 at the largest tensor and over the step's 161
tensors; `static`, the static GPT step of phase 7 (host and device ms
per step, kernels per step; trees that have the static path): two
versions compared in turns on one card.

The last lines are the kernels' JSON line (18 rows: K1-K10, K1-K3 in
float16, K7, K8 and K9 as two rows each, P1, P2; every row with its
launches summed over the GPT train, the two fused ResNet runs, the
serving paths, the timed steps of the static GPT's four runs (plain,
AMP + fusion, clipped, AMP float16 + fusion), the io phase's Predictor
and CompiledPredictor runs and the probe tool's runs, K10's over the
DGC run with K10, P1's and P2's over the probe tool's), the card line
and {"ok": true, "device": {...}}.
"""

import contextlib
import json
import math
import re
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12,  # dense, H100 SXM
            "float32": 67e12}
# atol = rtol; float16 is held to the rounding model (or a plain version
# with one rounding) at one float16 ulp, 2^-10 relative (bf16's rule
# against its model, 2^-7, scaled to float16's mantissa)
TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 2 ** -10}


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
    milliseconds and the launch gaps do not count).  The warm-up calls
    run on the stream the graph captures on, as PyTorch's CUDA-graph
    notes advise, so what a wrapper sets up once per stream (K6's
    counters) is not captured into the graph."""
    import torch

    main = torch.cuda.current_stream()
    stream = _capture_stream() if graph else main
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
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
    with torch.cuda.graph(graph, stream=stream):
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


_STREAMS = []


def _capture_stream():
    """One side stream for every graph capture of `time_ms`."""
    import torch

    if not _STREAMS:
        _STREAMS.append(torch.cuda.Stream())
    return _STREAMS[0]


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
# phase 1b: tensor-core instructions in the built libraries
# ---------------------------------------------------------------------------

# per library, the kernels whose bf16 instantiations must hold HMMA: K7's
# (csrc/fused_block.cu) and K8's (csrc/fused_down.cu) that run a product,
# most of them the pieces both share (csrc/block_tc.cuh), K1's, K2's and
# K3's tensor-core kernels (each at every head dim) and P1 and P2 (K7's
# conv3x3 and 1x1 products in csrc/fused_bottleneck.cu)
K7_MMA_KERNELS = ("block_fwd_kernel", "block_bwd1_kernel",
                  "block_bwd2_kernel", "wgrad_kernel")
MMA_KERNELS = {
    "fused_block": K7_MMA_KERNELS,
    "fused_down": ("block_fwd_kernel", "block_bwd1_kernel",
                   "down_bwd2_kernel", "wgrad_kernel"),
    "flash_attention": ("flash_fwd_mma_kernel",),
    "flash_attention_bwd": ("flash_bwd_dq_mma_kernel",
                            "flash_bwd_dkv_mma_kernel"),
    "fused_bottleneck": ("probe_conv3x3_kernel", "probe_matmuls_kernel"),
}
# K1, K2 and K3 in f32 (exact scalar kernels): counts printed as read (0
# expected)
SCALAR_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                  "flash_bwd_dkv_kernel")


def sass_counts(lib_name, failures):
    """{function: HMMA/HGMMA count} of one built library's
    `cuobjdump -sass`, each function's first such instruction printed."""
    import re
    import shutil
    from pathlib import Path

    from paddle_tpu_torch.kernels import backend

    lib = backend.lib_path(lib_name)
    tool = shutil.which("cuobjdump") or str(
        Path(backend.nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        failures.append(f"cuobjdump -sass {lib.name} exit {out.returncode}: "
                        f"{out.stderr[-500:]}")
        return {}
    counts, first, name = {}, {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
            continue
        if name and re.search(r"\bHG?MMA\.", line):
            counts[name] += 1
            first.setdefault(name, " ".join(line.split()))
    for name, c in sorted(counts.items()):
        log(f"sass {lib.name} {name}: {c} HMMA/HGMMA; first: "
            f"{first.get(name, '-')}")
    return counts


def sass_phase(failures):
    """`cuobjdump -sass` of K7's, K8's, K1's, K2/K3's and P1/P2's
    libraries: the HMMA / HGMMA count of every kernel.  Fails unless each
    bf16 K7 and K8 kernel that runs a product, the bf16 K1, K2 and K3
    kernels at each head dim, and bf16 P1 and P2 hold one; the f32 K1-K3
    run on the CUDA cores (exact f32 FMAs), as do the f32 instantiations
    and the slice sum, and their counts are printed as read.  Then K1's,
    K2's and K3's registers and spills from the build log (fails if a
    bf16 one spills at head dim 64), P1's and P2's (fails if a bf16 one
    spills), K7's and K6's (printed as read)."""
    from paddle_tpu_torch.kernels.flash_attention import HEAD_DIMS

    counts = {}
    for lib_name, kernels in MMA_KERNELS.items():
        got = sass_counts(lib_name, failures)
        counts.update(got)
        for kernel in kernels:
            bf16 = [n for n in got if kernel in n and "nv_bfloat16" in n]
            want = len(HEAD_DIMS) if kernel.startswith("flash") else 1
            if len(bf16) < want or not all(got[n] for n in bf16):
                failures.append(f"sass: bf16 {kernel} has no tensor-core "
                                f"instruction ({[got[n] for n in bf16]})")
            if kernel.startswith("flash"):
                # the float16 forms of K1-K3 (`mma.sync ... .f16.f16`)
                f16 = [n for n in got if kernel + "I6__half" in n]
                log(f"sass {kernel} float16: "
                    f"{sorted(got[n] for n in f16)} HMMA/HGMMA in "
                    f"{len(f16)} instantiations")
                if len(f16) < want or not all(got[n] for n in f16):
                    failures.append(f"sass: float16 {kernel} has no "
                                    f"tensor-core instruction "
                                    f"({[got[n] for n in f16]})")
    for kernel in SCALAR_KERNELS:
        found = {n: c for n, c in counts.items() if kernel + "I" in n}
        log(f"sass {kernel} (CUDA cores: f32 K1-K3): "
            f"{sorted(found.values())} HMMA/HGMMA in {len(found)} "
            "instantiations")
    for kernel in K7_MMA_KERNELS:
        for name, use in ptxas_find("fused_block", kernel):
            log(f"ptxas fused_block {name}: {use.get('registers')} regs, "
                f"spill {use.get('spill_stores')}/{use.get('spill_loads')} B")
    for lib_name in ("flash_attention", "flash_attention_bwd"):
        for kernel, d in ((k, d) for k in MMA_KERNELS[lib_name]
                          for d in HEAD_DIMS):
            for name, use in ptxas_find(
                    lib_name, f"{kernel}I(13__nv_bfloat16|6__half)Li{d}E"):
                kind = "bf16" if "bfloat16" in name else "float16"
                log(f"ptxas {kernel}<{d}> ({kind}): {use_text(use)}")
                if d == 64 and (use.get("spill_stores")
                                or use.get("spill_loads")):
                    failures.append(f"{kernel}<64> spills: {use}")
    for kernel in MMA_KERNELS["fused_bottleneck"]:
        for name, use in ptxas_find("fused_bottleneck", kernel):
            bf16 = "nv_bfloat16" in name
            log(f"ptxas {kernel} ({'bf16' if bf16 else 'f32'}): "
                f"{use_text(use)}")
            if bf16 and (use.get("spill_stores") or use.get("spill_loads")):
                failures.append(f"{kernel} (bf16) spills: {use}")
    for name, use in ptxas_find("flash_decode", "flash_decode_kernel"):
        log(f"ptxas flash_decode {name}: {use_text(use)}")
    return counts


def ptxas_usage(lib_name, kernel, d):
    """{registers, spill_stores, spill_loads} of `kernel` at head dim d
    from the ptxas report in backend.BUILD_LOG, or None when this run did
    not build the library."""
    # the tensor-core kernels are templates over the 16-bit type too
    found = ptxas_find(lib_name, f"{kernel}I(13__nv_bfloat16)?Li{d}E")
    return found[0][1] if found else None


def ptxas_find(lib_name, pattern):
    """[(mangled name, {registers, spill_stores, spill_loads})] of the
    entry functions whose mangled name matches `pattern`, from the ptxas
    report in backend.BUILD_LOG (empty when this run did not build the
    library)."""
    import re

    from paddle_tpu_torch.kernels import backend

    want = re.compile(pattern)
    found, cur = {}, None
    for line in backend.BUILD_LOG.get(lib_name, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w.$]+)", line)
        if m:
            cur = m.group(1) if want.search(m.group(1)) else None
            if cur:
                found.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[cur]["spill_stores"], found[cur]["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[cur]["registers"] = int(m.group(1))
    return sorted(found.items())


def use_text(use):
    if not use:
        return "ptxas n/a"
    return (f"{use.get('registers')} regs, spill {use.get('spill_stores')}/"
            f"{use.get('spill_loads')} B")


def usage_text(lib_name, kernel, d):
    return use_text(ptxas_usage(lib_name, kernel, d))


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
            use = (usage_text("flash_attention", "flash_fwd_mma_kernel", d)
                   if dt == torch.bfloat16 else
                   usage_text("flash_attention", "flash_fwd_kernel", d))
            log(f"{tag}: kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                f"{lib:.4f} bound_ms {bms:.5f} ({by}) max_err {err:.3e} "
                f"lse_err {err_lse:.3e}; {use}")
            if shape == (48, 12, 512, 64) and dt == torch.bfloat16:
                rows["flash_attention_fwd"] = dict(
                    name="K1 flash_attention_fwd", route="cuda",
                    source="paddle_tpu_torch/csrc/flash_attention.cu",
                    replaces="paddle_tpu/kernels/flash_attention.py:106",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib,
                    shape=f"q,k,v {list(shape)} causal bf16 (train step)")

    # K4 ------------------------------------------------------------------
    gen4 = torch.Generator(device="cuda").manual_seed(4)

    def own4(shape, dt):
        return torch.randn(shape, generator=gen4, device="cuda").to(dt)

    for dt in (torch.bfloat16, torch.float32):
        for n_rows, d in K4_SHAPES + K4_MORE_SHAPES:
            draw = rnd if (n_rows, d) in K4_SHAPES else own4
            x = draw((n_rows, d), dt)
            g, bta = draw((d,), dt), draw((d,), dt)
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
    rows["flash_decode"] = k6_checks(failures, rnd, flush)
    flash_bwd_checks(rows, failures, rnd)
    flash_static_checks(failures)
    flash_precision(failures)
    float16_checks(rows, failures, flush)
    layer_norm_bwd_checks(rows, failures, rnd)
    fused_bottleneck_checks(rows, failures, rnd)
    fused_bottleneck_down_checks(rows, failures, rnd)
    stem_tail_checks(rows, failures, rnd)
    return rows


# K4's checks: (rows, D).  K4_SHAPES draw from the kernel phase's
# generator in the order earlier versions of this script drew them, so
# the checks after them keep their inputs; K4_MORE_SHAPES draw from a
# generator of their own: [4096, 768], the static GPT's LayerNorm rows
K4_SHAPES = ((24576, 768), (1024, 768), (512, 768), (8, 768), (300, 1024))
K4_MORE_SHAPES = ((4096, 768),)


# K6's timed cases: (batch, heads, head dim, cache depth T, lengths,
# what); the first two draw from the kernel phase's generator, the others
# from their own, so every later check keeps the draws of earlier runs
K6_CASES = (
    (4, 12, 64, 384, [320] * 4, "generate decode, cache 256+128"),
    (8, 12, 64, 1024, [1, 77, 512, 1024, 300, 640, 900, 129],
     "engine decode, ragged slots"),
    (4, 12, 128, 384, [320] * 4, "head dim 128"),
    (4, 12, 256, 384, [320] * 4, "head dim 256"),
    (1, 12, 64, 2048, [2000], "one row, long cache"),
    (32, 12, 64, 1024, [(37 * i) % 1024 + 1 for i in range(32)],
     "batch 32, ragged"),
)


def k6_checks(failures, rnd, flush):
    """K6 against its plain version at K6_CASES in bf16 and f32, two
    calls bitwise equal, timed with L2 flushed beside its plain version,
    SDPA with the live mask (the yardstick) and the bytes bound, with its
    plan (chunk, splits, blocks); then untimed at lengths 0, 1, the chunk
    boundary +-1, T and past T, and at two geometries of other (b*h, S)
    back to back, the first again bitwise.  Returns the kernel table's
    row (the generate decode shape in bf16)."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import flash_attention as FA

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(16)

    def own(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    row = None
    for dt in (torch.bfloat16, torch.float32):
        for i, (b, h, d, t, lens, what) in enumerate(K6_CASES):
            r = rnd if i < 2 else own
            q = r((b, h, 1, d), dt)
            k, v = r((b, h, t, d), dt), r((b, h, t, d), dt)
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            out = FA.flash_decode(q, k, v, lengths)
            ref = FA.flash_decode_ref(q, k, v, lengths)
            tag = f"K6 q [{b}, {h}, 1, {d}] T={t} {what} {dname(dt)}"
            err = compare(tag, out, ref, dname(dt), failures)
            if not torch.equal(out, FA.flash_decode(q, k, v, lengths)):
                failures.append(f"{tag}: two calls differ")
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
            chunk, splits = FA.decode_plan(b * h, t, sms)
            log(f"{tag}: kernel_ms {ms:.4f} plain_ms {plain:.4f} library_ms "
                f"{lib:.4f} (SDPA) bound_ms {bms:.5f} ({by}) max_err "
                f"{err:.3e}; chunk {chunk}, S {splits}, {b * h * splits} "
                f"blocks on {sms} SMs; {ms / bms:.1f}x bound, "
                f"{ms / lib:.2f}x SDPA (L2 flushed)")
            if dt == torch.bfloat16 and i == 0:
                row = dict(
                    name="K6 flash_decode", route="cuda",
                    source="paddle_tpu_torch/csrc/flash_decode.cu",
                    replaces="paddle_tpu/kernels/flash_attention.py:379",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib,
                    shape=f"q [4, 12, 1, 64], cache T=384, lengths 320, "
                          f"bf16 (generate decode); chunk {chunk}, S "
                          f"{splits}")
    k6_plan_sweep(own, flush, sms)
    k6_edges(failures, sms)
    return row


def k6_plan_sweep(rnd, flush, sms, targets=(1, 2, 4, 8)):
    """K6's time in bf16 at K6_CASES (L2 flushed) with the planner's
    blocks-per-SM target (flash_attention.DECODE_BLOCKS_PER_SM) at each
    of `targets`, the default restored after."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as FA

    default = FA.DECODE_BLOCKS_PER_SM
    try:
        for b, h, d, t, lens, what in K6_CASES:
            q = rnd((b, h, 1, d), torch.bfloat16)
            k, v = (rnd((b, h, t, d), torch.bfloat16) for _ in range(2))
            n = torch.tensor(lens, dtype=torch.int32, device="cuda")
            got = []
            for per in targets:
                FA.DECODE_BLOCKS_PER_SM = per
                ms = time_ms(lambda: FA.flash_decode(q, k, v, n), flush=flush)
                chunk, splits = FA.decode_plan(b * h, t, sms)
                got.append(f"{per}/SM chunk {chunk} S {splits} {ms:.4f}")
            log(f"K6 plan sweep q [{b}, {h}, 1, {d}] T={t} {what} bf16 "
                f"(ms, L2 flushed): " + "; ".join(got))
    finally:
        FA.DECODE_BLOCKS_PER_SM = default


def k6_edges(failures, sms):
    """K6 at lengths 0, 1, the 64-key chunk boundary +-1, two chunks + 1,
    T and past T (T 256, S 4), D 64/128/256, f32 and bf16, against its
    plain version, the empty row exactly 0; then two geometries of other
    (b*h, S) back to back and the first again, bitwise."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)

    def rnd(shape, dt):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    lens = torch.tensor([0, 1, 63, 64, 65, 129, 256, 265], dtype=torch.int32,
                        device=dev)
    for dt in (torch.bfloat16, torch.float32):
        for d in (64, 128, 256):
            q, k, v = (rnd((8, 2, s, d), dt) for s in (1, 256, 256))
            out = FA.flash_decode(q, k, v, lens)
            tag = f"K6 edges q [8, 2, 1, {d}] T=256 {dname(dt)}"
            err = compare(tag, out, FA.flash_decode_ref(q, k, v, lens),
                          dname(dt), failures)
            if float(out[0].abs().max()) != 0.0:
                failures.append(f"{tag}: length 0 gives {out[0]}")
            log(f"{tag}: lengths {lens.tolist()}, S "
                f"{FA.decode_plan(16, 256, sms)[1]}: max_err {err:.3e}")
        runs = []
        for b, t in ((2, 384), (4, 1024), (2, 384)):
            g = torch.Generator(device=dev).manual_seed(b)
            q, k = (torch.randn(s, generator=g, device=dev).to(dt)
                    for s in ((b, 3, 1, 64), (b, 3, t, 64)))
            n = torch.tensor([t - 1, 70, 0, t][:b], dtype=torch.int32,
                             device=dev)
            runs.append(FA.flash_decode(q, k, k, n))
        if not torch.equal(runs[0], runs[2]):
            failures.append(f"K6 {dname(dt)}: a call at S "
                            f"{FA.decode_plan(6, 384, sms)[1]} after one at S "
                            f"{FA.decode_plan(12, 1024, sms)[1]} differs")


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
            use_kv = (usage_text("flash_attention_bwd",
                                 "flash_bwd_dkv_mma_kernel", d)
                      if dt == torch.bfloat16 else
                      usage_text("flash_attention_bwd", "flash_bwd_dkv_kernel",
                                 d))
            use_q = usage_text("flash_attention_bwd",
                               "flash_bwd_dq_mma_kernel"
                               if dt == torch.bfloat16 else
                               "flash_bwd_dq_kernel", d)
            log(f"{tag}: K2 kernel_ms {ms_q:.4f} bound_ms {bq:.5f} ({byq}) "
                f"max_err {err_q:.3e} ({use_q}); K3 kernel_ms {ms_kv:.4f} "
                f"bound_ms {bkv:.5f} ({bykv}) max_err {err_kv:.3e} "
                f"({use_kv}); whole backward "
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


# the attention shape of the static GPT (`STATIC_GPT`, batch 8), which
# its fused_attention hands K1-K3 under the fusion tier; drawn from a
# generator of its own, so every earlier check keeps its inputs
FLASH_STATIC = (8, 12, 512, 64)


def flash_static_checks(failures):
    """K1 (out, lse), K2 (dq) and K3 (dk, dv) at FLASH_STATIC, non-causal,
    bf16 and f32, against their plain versions, with their times."""
    import math

    import torch

    from paddle_tpu_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(16)
    shape = FLASH_STATIC
    scale = 1.0 / math.sqrt(shape[-1])
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, do = ((torch.randn(shape, generator=gen, device="cuda")
                        * 0.5).to(dt) for _ in range(4))
        tag = f"K1-K3 static GPT {list(shape)} causal=False {dname(dt)}"
        out, lse = FA.flash_attention_with_lse(q, k, v, causal=False)
        ref, ref_lse = FA.flash_attention_ref(q, k, v, causal=False)
        err = max(compare(tag + " out", out, ref, dname(dt), failures),
                  compare(tag + " lse", lse, ref_lse, "float32", failures))
        delta = (do.float() * ref.float()).sum(-1)
        args = (q, k, v, do, ref_lse, delta, False, scale)
        want = FA.flash_attention_bwd_ref(*args)
        err_q = compare(tag + " dq", FA._launch_bwd_dq(*args), want[0],
                        dname(dt), failures)
        dk, dv = FA._launch_bwd_dkv(*args)
        err_kv = max(compare(tag + " dk", dk, want[1], dname(dt), failures),
                     compare(tag + " dv", dv, want[2], dname(dt), failures))
        ms = time_ms(lambda: FA.flash_attention(q, k, v, False))
        ms_q = time_ms(lambda: FA._launch_bwd_dq(*args))
        ms_kv = time_ms(lambda: FA._launch_bwd_dkv(*args))
        log(f"{tag}: K1 kernel_ms {ms:.4f} max_err {err:.3e}; K2 kernel_ms "
            f"{ms_q:.4f} max_err {err_q:.3e}; K3 kernel_ms {ms_kv:.4f} "
            f"max_err {err_kv:.3e}")
        del q, k, v, do, out, lse, ref, ref_lse, delta, args, want, dk, dv
    torch.cuda.empty_cache()


# the train shape of K1-K3, and the head dims of the non-causal checks
FLASH_TRAIN = ((48, 12, 512, 64), True)
FLASH_PRECISION_CASES = (FLASH_TRAIN, ((1, 4, 256, 128), False),
                         ((1, 4, 256, 256), False))
FLASH_OUTPUTS = ("O", "lse", "dQ", "dK", "dV")
FLASH_MODEL_RATIO = 1.5


def flash_inputs(shape, seed, dtype=None):
    """q, k, v, dO (`dtype`, bf16 by default; scale 0.5) from a generator
    of their own, so the draws of the other checks do not move."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (
        (torch.randn(shape, generator=gen, device="cuda") * 0.5).to(
            dtype or torch.bfloat16) for _ in range(4))
    return q, k, v, do


def flash_outs(q, k, v, do, causal, lse, delta, how, rt=None):
    """O, lse (K1) and dQ (K2), dK, dV (K3) of one route: "kernel" (K1,
    then K2 and K3 on the given lse and delta), or the plain versions
    with p and ds rounded to `rt` (bf16 by default) where the reference
    rounds them (the rounding model) at the inputs' own precision (pass
    float64 inputs for float64 products), or without the rounding
    ("plain")."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as FA

    scale = 1.0 / (q.shape[-1] ** 0.5)
    if how == "kernel":
        out, l = FA._launch_fwd(q, k, v, causal, scale)
        dq = FA._launch_bwd_dq(q, k, v, do, lse, delta, causal, scale)
        dk, dv = FA._launch_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        return out, l, dq, dk, dv
    rt = None if how == "plain" else (rt or torch.bfloat16)
    out, l = FA.flash_attention_ref(q, k, v, causal, scale, round_to=rt)
    dq, dk, dv = FA.flash_attention_bwd_ref(q, k, v, do, lse, delta, causal,
                                            scale, round_to=rt)
    return out, l, dq, dk, dv


def flash_errs(q, k, v, do, causal):
    """rel Frobenius error against float64 products (the plain versions
    computed in float64 on the same 16-bit inputs, lse and delta, p and
    ds unrounded) of the kernel, the rounding model (p and ds rounded to
    the inputs' dtype) in f32 and the plain f32 version, per output
    (FLASH_OUTPUTS).  The model is no copy of the kernel's roundings: it
    rounds p against the row's final max, K1 against the running max of
    its 64-key tiles."""
    import torch

    from paddle_tpu_torch.kernels import flash_attention as FA

    out, lse = FA.flash_attention_ref(q, k, v, causal)
    delta = (do.float() * out.float()).sum(-1)
    p64 = flash_outs(*(t.double() for t in (q, k, v, do)), causal, lse,
                     delta, "plain")
    errs = {}
    for how in ("kernel", "model", "plain"):
        got = flash_outs(q, k, v, do, causal, lse, delta, how, q.dtype)
        errs[how] = [rel_err(a, b) for a, b in zip(got, p64)]
        del got
    del p64
    torch.cuda.empty_cache()
    return errs


def flash_precision(failures, cases=FLASH_PRECISION_CASES, dtype=None,
                    seed=100):
    """16-bit K1, K2 and K3 (bf16 by default) against float64 products at
    `cases` (the train shape and non-causal at head dims 128 and 256):
    fails where the kernel's error on any output exceeds
    FLASH_MODEL_RATIO x the rounding model's (the plain versions with the
    reference's roundings of p and ds to the inputs' dtype, in f32).
    K1's O, K2's dQ and K3's dK, dV accumulate in the mma itself over the
    key (K1, K2) or query (K3) tiles; the line names that rule."""
    for i, (shape, causal) in enumerate(cases):
        q, k, v, do = flash_inputs(shape, seed + i, dtype)
        errs = flash_errs(q, k, v, do, causal)
        ratios = [a / max(b, 1e-30) for a, b in zip(errs["kernel"],
                                                     errs["model"])]
        tag = (f"flash_precision {list(shape)} causal={causal} "
               f"{dname(q.dtype)}")
        for name, r, a, b in zip(FLASH_OUTPUTS, ratios, errs["kernel"],
                                 errs["model"]):
            if r > FLASH_MODEL_RATIO:
                failures.append(f"{tag} {name}: kernel error against "
                                f"float64 products {a:.3e} > "
                                f"{FLASH_MODEL_RATIO} x the rounding "
                                f"model's {b:.3e}")
        worst = max(range(len(ratios)), key=ratios.__getitem__)
        parts = [f"{how}-p64 [" + " ".join(
            f"{n} {e:.3e}" for n, e in zip(FLASH_OUTPUTS, v)) + "]"
            for how, v in errs.items()]
        log(f"{tag}: rel Frobenius {' '.join(parts)}; kernel / model "
            f"worst {FLASH_OUTPUTS[worst]} {ratios[worst]:.3f}; sums "
            "(O, dQ, dK, dV) accumulated in the mma")
        del q, k, v, do


# the float16 forms of K1-K3: held at the train shape and at the
# static GPT's attention, the shape the float16 AMP run of phase 7 gives
# them; K4, K5 and K6 in float16 at the static GPT's LayerNorm rows and
# the generate decode shape
FLASH_F16_CASES = (FLASH_TRAIN, (FLASH_STATIC, False))
K4_F16_SHAPES = ((4096, 768), (24576, 768))


def float16_checks(rows, failures, flush):
    """The float16 forms, from generators of their own: K1 (out,
    lse), K2 (dq) and K3 (dk, dv) at FLASH_F16_CASES against their
    rounding model (p and ds rounded to float16 where the reference
    rounds them) at one float16 ulp (2^-10; lse 2e-5), with the error
    against the plain unrounded versions printed; their times beside the
    plain versions, `F.scaled_dot_product_attention` in float16 (forward;
    its whole backward for K2/K3) and the bound; their error against
    float64 products at most FLASH_MODEL_RATIO x the model's
    (`flash_precision` in float16).  The rows at the static GPT's
    attention go into the kernels line as K1-K3 float16.  Then K4 at
    K4_F16_SHAPES, K5 at [4096, 768] (gamma and the sums in float32 and
    in float16) and K6 at the generate decode shape against their plain
    versions (2^-10; K5's dgamma/dbeta atol 2e-5 sqrt(rows), rtol 2^-10),
    with their times."""
    import math

    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import flash_attention as FA
    from paddle_tpu_torch.kernels import layer_norm as LN

    f16 = torch.float16
    for i, (shape, causal) in enumerate(FLASH_F16_CASES):
        b, h, s, d = shape
        scale = 1.0 / math.sqrt(d)
        q, k, v, do = flash_inputs(shape, 170 + i, f16)
        tag = f"K1-K3 {list(shape)} causal={causal} float16"
        out, lse = FA._launch_fwd(q, k, v, causal, scale)
        mo, ml = FA.flash_attention_ref(q, k, v, causal, scale, round_to=f16)
        po, pl = FA.flash_attention_ref(q, k, v, causal, scale)
        err = max(compare(tag + " out", out, mo, "float16", failures),
                  compare(tag + " lse", lse, ml, "float32", failures))
        delta = (do.float() * po.float()).sum(-1)
        args = (q, k, v, do, pl, delta, causal, scale)
        model = FA.flash_attention_bwd_ref(*args, round_to=f16)
        plain = FA.flash_attention_bwd_ref(*args)
        dq = FA._launch_bwd_dq(*args)
        dk, dv = FA._launch_bwd_dkv(*args)
        err_q = compare(tag + " dq", dq, model[0], "float16", failures)
        err_kv = max(compare(tag + " dk", dk, model[1], "float16", failures),
                     compare(tag + " dv", dv, model[2], "float16", failures))
        vs_plain = [float((a.float() - w.float()).abs().max())
                    for a, w in zip((out, dq, dk, dv), (po, *plain))]
        iters = 5 if b * h > 100 else 20
        ms = time_ms(lambda: FA.flash_attention(q, k, v, causal))
        plain_ms = time_ms(lambda: FA.flash_attention_ref(q, k, v, causal))
        lib = time_ms(lambda: TF.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        ms_q = time_ms(lambda: FA._launch_bwd_dq(*args), iters)
        ms_kv = time_ms(lambda: FA._launch_bwd_dkv(*args), iters)
        plain_b = time_ms(lambda: FA.flash_attention_bwd_ref(*args), iters)
        lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
        lout = TF.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
        lib_b = time_ms(lambda: torch.autograd.grad(
            lout, (lq, lk, lv), do, retain_graph=True), iters, graph=False)
        del lq, lk, lv, lout
        n = b * h * s
        pairs = b * h * (s * (s + 1) / 2 if causal else s * s)
        reads = 4 * n * d * 2 + 2 * n * 4
        b1, by1 = bound(3 * n * d * 2 + n * d * 2 + n * 4, 4 * pairs * d,
                        "float16")
        bq, byq = bound(reads + n * d * 2, 6 * pairs * d, "float16")
        bkv, bykv = bound(reads + 2 * n * d * 2, 8 * pairs * d, "float16")
        log(f"{tag}: K1 kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
            f"library_ms {lib:.4f} (SDPA float16) bound_ms {b1:.5f} ({by1}) "
            f"max_err vs model {err:.3e}; K2 kernel_ms {ms_q:.4f} bound_ms "
            f"{bq:.5f} ({byq}) max_err {err_q:.3e}; K3 kernel_ms "
            f"{ms_kv:.4f} bound_ms {bkv:.5f} ({bykv}) max_err {err_kv:.3e}; "
            f"whole backward plain_ms {plain_b:.4f} library_ms {lib_b:.4f} "
            f"(SDPA float16); max abs vs the unrounded plain versions (O, "
            f"dQ, dK, dV) {' '.join(f'{e:.3e}' for e in vs_plain)}")
        if (shape, causal) == (FLASH_STATIC, False):
            what = (f"q,k,v {list(shape)} non-causal float16 (the static "
                    "GPT's attention under FLAGS_amp_dtype=float16)")
            rows["flash_attention_fwd:float16"] = dict(
                name="K1 flash_attention_fwd float16", route="cuda",
                source="paddle_tpu_torch/csrc/flash_attention.cu",
                replaces="paddle_tpu/kernels/flash_attention.py:106",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b1,
                bound_by=by1, library_ms=lib, shape=what)
            common = dict(route="cuda", plain_ms=plain_b, library_ms=lib_b,
                          source="paddle_tpu_torch/csrc/"
                                 "flash_attention_bwd.cu",
                          shape=what + "; plain and library: the whole "
                                       "backward")
            rows["flash_attention_bwd_dq:float16"] = dict(
                name="K2 flash_attention_bwd_dq float16",
                replaces="paddle_tpu/kernels/flash_attention.py:203",
                max_abs_err=err_q, ms=ms_q, bound_ms=bq, bound_by=byq,
                **common)
            rows["flash_attention_bwd_dkv:float16"] = dict(
                name="K3 flash_attention_bwd_dkv float16",
                replaces="paddle_tpu/kernels/flash_attention.py:242",
                max_abs_err=err_kv, ms=ms_kv, bound_ms=bkv, bound_by=bykv,
                **common)
        del q, k, v, do, out, lse, mo, ml, po, pl, delta, args, model, plain
        del dq, dk, dv
        torch.cuda.empty_cache()
    flash_precision(failures, FLASH_F16_CASES, f16, seed=180)

    gen = torch.Generator(device="cuda").manual_seed(190)

    def own(shape, dt=f16):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    for n_rows, d in K4_F16_SHAPES:
        x, g, bta = own((n_rows, d)), own((d,)), own((d,))
        tag = f"K4 [{n_rows}, {d}] float16"
        err = compare(tag, LN.fused_layer_norm(x, g, bta),
                      LN.layer_norm_ref(x, g, bta), "float16", failures)
        ms = time_ms(lambda: LN.fused_layer_norm(x, g, bta))
        lib = time_ms(lambda: TF.layer_norm(x, (d,), g, bta, 1e-5))
        bms, by = bound((2 * n_rows * d + 2 * d) * 2, 8 * n_rows * d,
                        "float16")
        log(f"{tag}: kernel_ms {ms:.4f} library_ms {lib:.4f} bound_ms "
            f"{bms:.5f} ({by}) max_err {err:.3e}")
    n_rows, d = 4096, 768
    x, dy = own((n_rows, d)), own((n_rows, d))
    for gdt in (torch.float32, f16):
        g = own((d,), gdt)
        dx, dg, db = LN._launch_bwd(x, g, dy, 1e-5, gdt)
        rx, rg, rb = LN.layer_norm_bwd_ref(x, g, dy)
        tag = f"K5 [{n_rows}, {d}] float16, gamma {dname(gdt)}"
        err = compare(tag + " dx", dx, rx, "float16", failures)
        atol = 2e-5 * math.sqrt(n_rows)
        rtol = TOL["float16"] if gdt == f16 else 1e-6
        for name, got, want in (("dgamma", dg, rg), ("dbeta", db, rb)):
            e = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), atol=atol,
                                  rtol=rtol):
                failures.append(f"{tag} {name}: max_abs_err {e:.3e} > "
                                f"atol {atol:.3e} rtol {rtol:g}")
            err = max(err, e)
        ms = time_ms(lambda: LN._launch_bwd(x, g, dy, 1e-5, gdt))
        log(f"{tag}: kernel_ms {ms:.4f} max_err {err:.3e} "
            f"(dgamma/dbeta in {dname(gdt)})")
    q, kc = own((4, 12, 1, 64)), own((4, 12, 384, 64))
    lens = torch.full((4,), 320, dtype=torch.int32, device="cuda")
    err = compare("K6 [4, 12, 1, 64] T 384 float16",
                  FA.flash_decode(q, kc, kc, lens),
                  FA.flash_decode_ref(q, kc, kc, lens), "float16", failures)
    ms = time_ms(lambda: FA.flash_decode(q, kc, kc, lens), flush=flush)
    log(f"K6 [4, 12, 1, 64] T 384 len 320 float16: kernel_ms {ms:.4f} "
        f"(L2 flushed) max_err {err:.3e}")
    torch.cuda.empty_cache()


# K5's checks: (rows, D).  The train step's [24576, 768] (timed, the JSON
# row, the plan sweep); the serving widths; 300 x 1024 (several warps per
# row in f32).  These draw from the kernel phase's generator in the order
# earlier versions of this script drew them, so the checks after them keep
# their inputs; K5_MORE_SHAPES draw from a generator of their own: D 128
# (half a warp idle in bf16); D 4096 (4 or 8 warps per row); rows 1, 7 and
# 5, fewer than a block's 8 warps; 6272 and 8320 (the wide kernel in f32,
# both; 8 warps per row in bf16 at 6272); 4096 x 768, the static GPT's
# LayerNorm rows
K5_SHAPES = ((24576, 768), (1024, 768), (512, 768), (8, 768), (300, 1024))
K5_MORE_SHAPES = ((4096, 128), (1024, 4096), (1, 768), (7, 768), (5, 768),
                  (64, 6272), (64, 8320), (4096, 768))


def ln_plan_text(plan):
    return (f"plan: {plan.warps_per_row} warps/row, "
            f"{plan.vecs_per_thread or 'wide'} vectors/thread, "
            f"{plan.warps_per_block} warps/block, {plan.blocks} blocks, "
            f"{plan.stages} stages, G {plan.group} x {plan.groups} groups")


def layer_norm_bwd_checks(rows, failures, rnd):
    """K5 (csrc/layer_norm_bwd.cu) at K5_SHAPES and K5_MORE_SHAPES, f32 and
    bf16: the raw
    launch against the plain backward (dx 2e-5 / 3e-2; dgamma/dbeta, f32
    sums over the rows in another order, atol 2e-5 * sqrt(rows), rtol
    2e-5), against the plan model `_ln_bwd_plan_model` run on the card
    (the same order of sums: dgamma/dbeta atol 1e-6 * sqrt(rows), rtol
    1e-6, a few ulps: the kernel contracts products into FMAs), bitwise
    equal over two calls; through the Function (dx bitwise the raw one,
    dgamma/dbeta in gamma's dtype, one launch); a NaN in one element of dy
    confined to its row of dx and its column of dgamma/dbeta; each line
    with its plan and times.  Then each instantiation's ptxas registers
    and spills, the occupancy of every plan run against the blocks per SM
    it counts on, and at [24576, 768] bf16 the time at each team size."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.kernels import layer_norm as LN

    sms = backend.sm_count(torch.device("cuda"))

    def compare_sum(name, got, want, n_rows, failures, atol=2e-5, rtol=2e-5):
        err = (got.float() - want.float()).abs().max().item()
        atol = atol * n_rows ** 0.5
        if not torch.allclose(got.float(), want.float(), atol=atol,
                              rtol=rtol):
            failures.append(f"{name}: max_abs_err {err:.3e} > atol {atol}")
        return err

    gen = torch.Generator(device="cuda").manual_seed(5)

    def own(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    used = set()
    for dt in (torch.bfloat16, torch.float32):
        for n_rows, d in K5_SHAPES + K5_MORE_SHAPES:
            draw = rnd if (n_rows, d) in K5_SHAPES else own
            x, dy = draw((n_rows, d), dt), draw((n_rows, d), dt)
            g, bta = draw((d,), dt), draw((d,), dt)
            plan = LN.ln_bwd_plan(n_rows, d, dt, sms)
            used.add((dt, plan.vecs_per_thread, plan.smem))
            tag = f"K5 [{n_rows}, {d}] {dname(dt)}"
            dx, dg, db = LN._launch_bwd(x, g, dy, 1e-5)
            again = LN._launch_bwd(x, g, dy, 1e-5)
            want = LN.layer_norm_bwd_ref(x, g, dy)
            model = LN._ln_bwd_plan_model(x, g, dy, plan)
            err = compare(tag + " dx", dx, want[0], dname(dt), failures)
            err_s = max(compare_sum(tag + " dgamma", dg, want[1], n_rows,
                                    failures),
                        compare_sum(tag + " dbeta", db, want[2], n_rows,
                                    failures))
            err_m = max(compare_sum(f"{tag} {name} vs model", a, w, n_rows,
                                    failures, 1e-6, 1e-6)
                        for name, a, w in (("dgamma", dg, model[1]),
                                           ("dbeta", db, model[2])))
            if not (torch.equal(dg, again[1]) and torch.equal(db, again[2])):
                failures.append(f"{tag}: dgamma/dbeta differ over two calls")
            leaves = [t.clone().requires_grad_() for t in (x, g, bta)]
            y = LN.fused_layer_norm(*leaves)
            before = backend.LAUNCHES["layer_norm_bwd"]
            got = torch.autograd.grad(y, leaves, dy)
            made = backend.LAUNCHES["layer_norm_bwd"] - before
            if made != 1:
                failures.append(f"{tag}: the Function's backward launched "
                                f"K5 {made} times")
            if not torch.equal(got[0], dx):
                failures.append(f"{tag}: the Function's dx is not the raw "
                                "launch's")
            for name, a, w in (("dgamma", got[1], dg), ("dbeta", got[2], db)):
                if a.dtype != dt or not torch.equal(a, w.to(dt)):
                    failures.append(f"{tag} Function {name}: not the raw "
                                    f"launch's sum in {dt} ({a.dtype})")
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
                f"{err:.3e} dgamma/dbeta {err_s:.3e} vs model {err_m:.3e}; "
                f"{ln_plan_text(plan)}")
            if (n_rows, d) == (24576, 768) and dt == torch.bfloat16:
                rows["layer_norm_bwd"] = dict(
                    name="K5 layer_norm_bwd", route="cuda",
                    source="paddle_tpu_torch/csrc/layer_norm_bwd.cu",
                    replaces="paddle_tpu/kernels/layer_norm.py:60",
                    max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=lib,
                    shape="x, dy [24576, 768] bf16 (train step)")
                for w in (1, 2, 4, 8):
                    p_w = LN.ln_bwd_plan(n_rows, d, dt, sms, warps_per_row=w)
                    used.add((dt, p_w.vecs_per_thread, p_w.smem))
                    ms_w = time_ms(lambda: LN._launch_bwd(
                        x, g, dy, 1e-5, plan=p_w))
                    log(f"{tag} sweep: kernel_ms {ms_w:.4f} "
                        f"({bms / ms_w:.1%} of the bound); "
                        f"{ln_plan_text(p_w)}")
            if (n_rows, d) == (1024, 768):
                ln_nan_check(tag, x, g, dy, failures)
            del x, dy, got, leaves, y, lout, lx, lg, lb, model, want
    for name, use in ptxas_find("layer_norm_bwd", "ln_bwd"):
        log(f"ptxas layer_norm_bwd {name}: {use_text(use)}")
    for dt, nv, smem in sorted(used, key=str):
        occ = LN.ln_bwd_occupancy(dt, nv, smem)
        want = LN.LN_BWD_BLOCKS_PER_SM[dt][nv]
        log(f"K5 occupancy {dname(dt)} {nv or 'wide'} vectors/thread, smem "
            f"{smem} B: {occ} blocks/SM (plan counts on {want})")
        if occ < want:
            failures.append(f"K5 {dname(dt)} nv {nv}: {occ} blocks per SM "
                            f"resident, the plan counts on {want}")


def ln_nan_check(tag, x, g, dy, failures):
    """A NaN in dy[row 17, column 100] must make row 17 of dx and column 100
    of dgamma/dbeta NaN and nothing else, as in the plain version."""
    import torch

    from paddle_tpu_torch.kernels import layer_norm as LN

    dy = dy.clone()
    dy[17, 100] = float("nan")
    got = LN._launch_bwd(x, g, dy, 1e-5)
    want = LN.layer_norm_bwd_ref(x, g, dy)
    same = all(torch.equal(torch.isnan(a), torch.isnan(w))
               for a, w in zip(got, want))
    counts = [int(torch.isnan(a).sum()) for a in got]
    log(f"{tag} NaN in dy[17, 100]: NaN counts dx/dgamma/dbeta {counts}, "
        f"pattern as plain {same}")
    if not same or counts != [x.shape[1], 1, 1]:
        failures.append(f"{tag}: a NaN in dy[17, 100] gave NaN counts "
                        f"{counts} (plain's pattern: {same})")


# K7 at ResNet-50's four identity-block geometries and its stage-1 block-0
# projection geometry: (H = W, Cin, Cm, Cout, proj)
K7_GEOMETRIES = ((56, 256, 64, 256, False), (28, 512, 128, 512, False),
                 (14, 1024, 256, 1024, False), (7, 2048, 512, 2048, False),
                 (56, 64, 64, 256, True))


def compare_k7(name, got, want, dtype, rows, failures, ties=None,
               kind="sum"):
    """K7 against its plain version.  float32: `near_ties.hold`, atol =
    rtol = 2e-5 (the weight and affine grads, f32 sums over the rows
    added with atomics in any order, atol 2e-5 * sqrt(rows)); where that
    fails, only inside the footprint of a near-tie `ties` names (a relu
    input within the measured rounding noise of 0, whose mask may fall
    the other way on the card), the weight and affine grads then within
    1e-2 relative Frobenius error.  bfloat16: a relu mask whose
    pre-activation lies within one rounding of 0 can fall the other way
    on the card (f32 sums in another order, one bf16 ulp of h0 or h1),
    and each such flip moves one element of dx or one column of a weight
    grad by about |dy|; so at least 99% of the elements must lie within
    atol = rtol = 3e-2 (x sqrt(rows) for the sums) and the whole tensor
    within 1e-2 relative Frobenius error."""
    import torch

    from paddle_tpu_torch.tools import near_ties as NT

    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    tol = TOL[dtype]
    atol = tol * (rows ** 0.5 if rows > 1 else 1.0)
    finite = bool(torch.isfinite(got).all())
    if dtype == "float32":
        why = NT.hold(got, want, ties, kind, rows)
        if why:
            failures.append(f"{name}: {why}")
        return err
    bad = ((got - want).abs() > atol + tol * want.abs()).float().mean().item()
    rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
    if not (finite and bad <= 1e-2 and rel <= 1e-2):
        failures.append(f"{name}: {bad:.2e} of elements outside atol "
                        f"{atol:.3g}, relative Frobenius error {rel:.2e}")
    return err


def k7_inputs(rnd, n, hw, cin, cm, cout, proj, dt, w=None):
    """Seeded K7 inputs at He-like scales, affines near (1, 0) rounded to
    the activation dtype (as the model casts them), and a cotangent; the
    sides are hw x hw, or hw x w."""
    import torch

    w = hw if w is None else w
    x = rnd((n, hw, w, cin), dt)
    ws = [rnd((cin, cm), dt, cin ** -0.5),
          rnd((3, 3, cm, cm), dt, (9 * cm) ** -0.5),
          rnd((cm, cout), dt, cm ** -0.5)]
    if proj:
        ws.append(rnd((cin, cout), dt, cin ** -0.5))
    widths = [cm] * 4 + [cout] * (4 if proj else 2)
    affs = [(rnd((c,), torch.float32, 0.3) + (1.0 if i % 2 == 0 else 0.0)
             ).to(dt) for i, c in enumerate(widths)]
    return x, ws, affs, rnd((n, hw, w, cout), dt)


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
    bfloat16 (batch 128, timed by `k7_bf16_times`), at every geometry
    above, each with its launch plan (`block_plan`); in bfloat16 also its
    error against float64 products and the repeatability of dW1-4
    (`block_numerics`), and the forward and backward summed over a
    full-fused step."""
    import torch

    for geo in K7_GEOMETRIES:
        hw, cin, cm, cout, proj = geo
        x, ws, affs, dy = k7_inputs(rnd, 2, hw, cin, cm, cout, proj,
                                    torch.float32)
        log(k7_check(geo, x, ws, affs, dy, failures)[0])
        del x, ws, affs, dy
    errs, secs = {}, []

    def check(geo, x, ws, affs, aff, dy):
        text, errs[geo] = k7_check(geo, x, ws, affs, dy, failures)
        t0 = time.perf_counter()
        text += "; " + block_numerics("proj" if geo[4] else "id", x, dy, ws,
                                      aff, geo[2], failures,
                                      k7_tag(geo, x), controls=geo[4])
        secs.append(time.perf_counter() - t0)
        return text

    timed = k7_bf16_times(rnd, failures, check)
    log(f"K7 block_numerics: {sum(secs):.1f} s over the five geometries "
        f"(" + " ".join(f"{t:.1f}" for t in secs) + ")")
    geo = K7_GEOMETRIES[0]
    t, (err_f, err_fy, err_b, err_fg) = timed[geo], errs[geo]
    common = dict(route="cuda", source="paddle_tpu_torch/csrc/fused_block.cu")
    shape = "x [128, 56, 56, 256], Cm 64 (stage 1 identity block) bf16"
    rows["fused_bottleneck_fwd"] = dict(
        name="K7 fused_bottleneck_fwd",
        replaces="paddle_tpu/kernels/fused_bottleneck.py:180",
        max_abs_err=max(err_f, err_fy), ms=t["fwd_ms"],
        plain_ms=t["plain_fwd_ms"], bound_ms=t["fwd_bound_ms"],
        bound_by=t["fwd_bound_by"], library_ms=t["cudnn_fwd_ms"],
        shape=shape + "; library: the cuDNN composition (3 convs + "
                      "elementwise), not one call", **common)
    rows["fused_bottleneck_bwd"] = dict(
        name="K7 fused_bottleneck_bwd",
        replaces="paddle_tpu/kernels/fused_bottleneck.py:205",
        max_abs_err=max(err_b, err_fg), ms=t["bwd_ms"],
        plain_ms=t["plain_bwd_ms"], bound_ms=t["bwd_bound_ms"],
        bound_by=t["bwd_bound_by"], library_ms=t["cudnn_bwd_ms"],
        shape=shape + "; kernel_ms is the four backward kernels (B1, B2, "
                      "the weight-gradient GEMM and its slice sum) and the "
                      "wrapper's buffers; library: the cuDNN composition's "
                      "backward", **common)


def k7_tag(geo, x):
    hw, cin, cm, cout, proj = geo
    return (f"K7 {hw}^2 {cin}/{cm}/{cout} {'proj' if proj else 'id'} "
            f"n={x.shape[0]} {dname(x.dtype)}")


def k7_check(geo, x, ws, affs, dy, failures):
    """K7 at one geometry: raw launches and through the autograd Function
    against the plain versions (`compare_k7`; f32 with its near-ties).
    Returns the line's text (tag, plan, errors) and the max errors of the
    forward, the Function's y, the backward and the Function's grads."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB
    from paddle_tpu_torch.tools import near_ties as NT

    hw, cin, cm, cout, proj = geo
    dt, n = x.dtype, x.shape[0]
    d = dname(dt)
    w4 = ws[3] if proj else None
    aff = FB._pack_affines(affs, cout)
    tag = k7_tag(geo, x)
    rows_n = n * hw * hw
    plan = FB.block_plan(n, hw, hw, cin, cm, cout, proj, dt)
    y = FB._launch_fwd(x, *ws[:3], w4, aff, proj)
    y_ref = FB.fused_bottleneck_fwd_ref(x, *ws[:3], w4, aff, proj)
    ties = (NT.NearTies(x, *ws[:3], w4, aff, proj, False, y, y_ref)
            if dt == torch.float32 else None)
    err_f = compare_k7(tag + " y", y, y_ref, d, 1, failures, ties, "y")
    got = FB._launch_bwd(x, dy, *ws[:3], w4, aff, proj)
    want = FB.fused_bottleneck_bwd_ref(x, dy, *ws[:3], w4, aff, proj)
    err_b = compare_k7(tag + " dx", got[0], want[0], d, 1, failures, ties,
                       "dx")
    for name, g, w in zip(("dw1", "dw2", "dw3", "dw4", "daff"), got[1:],
                          want[1:]):
        if g is not None:
            err_b = max(err_b, compare_k7(f"{tag} {name}", g, w, d, rows_n,
                                          failures, ties))
    # through the Function: y and every grad, in the primals' dtype
    fn = FB.fused_bottleneck_proj if proj else FB.fused_bottleneck
    leaves = [t.clone().requires_grad_() for t in [x] + ws + affs]
    out = fn(*leaves)
    err_fy = compare_k7(tag + " Function y", out, y_ref, d, 1, failures,
                        ties, "y")
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
            1 if i == 0 else rows_n, failures, ties,
            "dx" if i == 0 else "sum"))
    msg = (f"{tag}: {plan_text(plan)}; max_err fwd {err_f:.3e} bwd "
           f"{err_b:.3e} Function y {err_fy:.3e} grads {err_fg:.3e}")
    if ties is not None:
        msg += f"; {ties}"
    return msg, (err_f, err_fy, err_b, err_fg)


def k7_bf16_times(rnd, failures, check=None):
    """K7 at each geometry in bfloat16, batch 128, inputs drawn from
    `rnd`: `check(geo, x, ws, affs, aff, dy)` (default: y and dx against
    the plain versions; only the launchers, so that `compare` can run it
    on an older package) gives the start of the geometry's line, then
    `k7_times`; finally K7's forward and backward summed over the 13
    launches of a full-fused ResNet-50 step.  Returns each geometry's
    times."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    def check_y_dx(geo, x, ws, affs, aff, dy):
        hw, cin, cm, cout, proj = geo
        args = list(ws[:3]) + [ws[3] if proj else None]
        tag = k7_tag(geo, x)
        compare_k7(tag + " y", FB._launch_fwd(x, *args, aff, proj),
                   FB.fused_bottleneck_fwd_ref(x, *args, aff, proj),
                   "bfloat16", 1, failures)
        compare_k7(tag + " dx", FB._launch_bwd(x, dy, *args, aff, proj)[0],
                   FB.fused_bottleneck_bwd_ref(x, dy, *args, aff, proj)[0],
                   "bfloat16", 1, failures)
        return tag

    step, out = {"fwd_ms": 0.0, "bwd_ms": 0.0}, {}
    for geo in K7_GEOMETRIES:
        hw, cin, cm, cout, proj = geo
        x, ws, affs, dy = k7_inputs(rnd, 128, hw, cin, cm, cout, proj,
                                    torch.bfloat16)
        aff = FB._pack_affines(affs, cout)
        text = (check or check_y_dx)(geo, x, ws, affs, aff, dy)
        out[geo] = k7_times(x, ws, affs, aff, dy, proj, 128, hw, cin, cm,
                            cout)
        add_step(step, out[geo], proj, hw)
        log(f"{text}; {timed_text(out[geo])}")
        del x, ws, affs, dy, aff
        torch.cuda.empty_cache()
    log(step_text(step))
    return out


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
    out["bwd_split_ms"] = bwd_split(
        lambda: FB._launch_bwd(x, dy, *ws[:3], w4, aff, proj),
        "block_bwd2_kernel")
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


def plan_text(plan):
    """One line of a K7 / K8 launch plan (`block_plan`, `down_plan`)."""
    return (f"plan tile px fwd/B1/B2 {plan['tile_px']} blocks "
            f"{plan['blocks']} per SM {plan['per_sm']} smem {plan['smem']} "
            f"dW1-4 K slices {plan['slices']} ({plan['wgrad_items']} items, "
            f"{plan['partials']} f32 partials) scratch "
            f"{plan['scratch_mb']:.1f} MB")


# K8 at ResNet-50's three stride-2 transitions: (H = W, Cin, Cm, Cout)
K8_GEOMETRIES = ((56, 256, 128, 512), (28, 512, 256, 1024),
                 (14, 1024, 512, 2048))
# block_numerics: on the caller's draw the kernel's error against float64
# products may exceed the plain f32 version's by at most this factor on
# each output ...
K8_P64_RATIO = 1.5
# ... unless the relu masks account for the excess: every mask the kernel
# set otherwise than the float64 products is a near-tie, |u| <= TIE_BF16
# of the sum of the magnitudes of u's terms (each term's bf16 operand one
# rounding step off moves u by at most that much), such flips are at
# most FLIP_SHARE_MAX of the relu inputs, and with each side's masks
# imposed on the float64 products the ratio holds
TIE_BF16 = 2.0 ** -7
FLIP_SHARE_MAX = 2e-5
# k8_precision: the kernel's error against float64 products is the tensor
# core model's within this relative band on each output, and its y is the
# model's in all but this share of the elements
K8_MODEL_BAND = 0.1
K8_MODEL_Y_OFF = 1e-4
# K8 at ragged shapes, f32 and bf16, untimed: (N, H, W, Cin, Cm, Cout)
K8_RAGGED = ((3, 10, 10, 24, 16, 40), (3, 6, 10, 6, 4, 10),
             (8, 28, 28, 512, 256, 1024))


def k8_composition(x, ws, affs):
    """The cuDNN composition of a transition block: a 1x1 conv, a
    stride-2 3x3 conv, a 1x1 conv and a stride-2 1x1 shortcut conv on
    channels-last views plus the elementwise tail (K8's yardstick;
    several calls, not one)."""
    import torch
    import torch.nn.functional as TF

    def aff(t, a, b):
        return t * a[None, :, None, None] + b[None, :, None, None]

    def w1x1(w):
        return w.t()[:, :, None, None]

    xc = x.permute(0, 3, 1, 2)
    h0 = torch.relu(aff(TF.conv2d(xc, w1x1(ws[0])), affs[0], affs[1]))
    h1 = torch.relu(aff(TF.conv2d(h0, ws[1].permute(3, 2, 0, 1), stride=2,
                                  padding=1), affs[2], affs[3]))
    s = aff(TF.conv2d(xc, w1x1(ws[3]), stride=2), affs[6], affs[7])
    return torch.relu(aff(TF.conv2d(h1, w1x1(ws[2])), affs[4], affs[5]) + s)


def fused_bottleneck_down_checks(rows, failures, rnd):
    """K8 forward and backward: raw launches and through `_FusedDown`
    against the plain versions, in float32 (batch 2) and bfloat16 (batch
    128, timed), at the three transition geometries, then untimed at the
    ragged shapes; the launch plan is printed per geometry.  The
    transitions take their inputs from `rnd` in the order of the first
    K8 checks; the ragged shapes draw from a generator of their own, so
    that the checks after these see the same draws."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB
    from paddle_tpu_torch.tools import near_ties as NT

    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd_ragged(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dt)

    cases = [(dt, n, hw, hw, cin, cm, cout, rnd)
             for dt, n in ((torch.float32, 2), (torch.bfloat16, 128))
             for hw, cin, cm, cout in K8_GEOMETRIES]
    cases += [(dt, *shape, rnd_ragged) for shape in K8_RAGGED
              for dt in (torch.float32, torch.bfloat16)]
    for dt, n, hh, hw, cin, cm, cout, draw in cases:
        d = dname(dt)
        x, ws, affs, _ = k7_inputs(draw, n, hh, cin, cm, cout, True, dt, hw)
        dy = draw((n, hh // 2, hw // 2, cout), dt)
        aff = FB._pack_affines(affs, cout)
        tag = f"K8 {hh}x{hw} {cin}/{cm}/{cout} n={n} {d}"
        rows_n = n * (hh // 2) * (hw // 2)
        plan = FB.down_plan(n, hh, hw, cin, cm, cout, dt)
        y = FB._launch_down_fwd(x, *ws, aff)
        y_ref = FB.fused_bottleneck_down_fwd_ref(x, *ws, aff)
        ties = (NT.NearTies(x, *ws, aff, True, True, y, y_ref)
                if dt == torch.float32 else None)
        err_f = compare_k7(tag + " y", y, y_ref, d, 1, failures, ties,
                           "y")
        got = FB._launch_down_bwd(x, dy, *ws, aff)
        want = FB.fused_bottleneck_down_bwd_ref(x, dy, *ws, aff)
        err_b = compare_k7(tag + " dx", got[0], want[0], d, 1, failures,
                           ties, "dx")
        for name, g, w in zip(("dw1", "dw2", "dw3", "dw4", "daff"),
                              got[1:], want[1:]):
            err_b = max(err_b, compare_k7(f"{tag} {name}", g, w, d,
                                          rows_n, failures, ties))
        leaves = [t.clone().requires_grad_() for t in [x] + ws + affs]
        out = FB.fused_bottleneck_down(*leaves)
        err_fy = compare_k7(tag + " Function y", out, y_ref, d, 1,
                            failures, ties, "y")
        grads = torch.autograd.grad(out, leaves, dy)
        daff = want[5]
        cmw = list(want[:5]) + [daff[0, :cm], daff[1, :cm],
                                daff[2, :cm], daff[3, :cm]] + [
            daff[i] for i in range(4, 8)]
        err_fg = 0.0
        for i, (g, w) in enumerate(zip(grads, cmw)):
            if g.dtype != leaves[i].dtype:
                failures.append(f"{tag} Function grad {i} dtype {g.dtype}")
            err_fg = max(err_fg, compare_k7(
                f"{tag} Function grad {i}", g, w.to(g.dtype), d,
                1 if i == 0 else rows_n, failures, ties,
                "dx" if i == 0 else "sum"))
        del leaves, out, grads, got, want, cmw
        msg = (f"{tag}: {plan_text(plan)}; max_err fwd {err_f:.3e} bwd "
               f"{err_b:.3e} Function y {err_fy:.3e} grads {err_fg:.3e}")
        if ties is not None:
            msg += f"; {ties}"
        if dt == torch.bfloat16 and n == 128:
            msg += "; " + block_numerics("down", x, dy, ws, aff, cm,
                                         failures, tag)
            timed = k8_times(x, ws, affs, aff, dy, n, hw, cin, cm, cout)
            msg += "; " + timed_text(timed)
            if hw == 56:
                common = dict(route="cuda",
                              source="paddle_tpu_torch/csrc/"
                                     "fused_down.cu")
                shape = ("x [128, 56, 56, 256] -> [128, 28, 28, 512], Cm "
                         "128 (stage-2 transition) bf16")
                rows["fused_bottleneck_down_fwd"] = dict(
                    name="K8 fused_bottleneck_down_fwd",
                    replaces="paddle_tpu/kernels/fused_bottleneck.py:499",
                    max_abs_err=max(err_f, err_fy), ms=timed["fwd_ms"],
                    plain_ms=timed["plain_fwd_ms"],
                    bound_ms=timed["fwd_bound_ms"],
                    bound_by=timed["fwd_bound_by"],
                    library_ms=timed["cudnn_fwd_ms"], shape=shape
                    + "; library: the cuDNN composition (4 convs + "
                      "elementwise), not one call", **common)
                rows["fused_bottleneck_down_bwd"] = dict(
                    name="K8 fused_bottleneck_down_bwd",
                    replaces="paddle_tpu/kernels/fused_bottleneck.py:526",
                    max_abs_err=max(err_b, err_fg), ms=timed["bwd_ms"],
                    plain_ms=timed["plain_bwd_ms"],
                    bound_ms=timed["bwd_bound_ms"],
                    bound_by=timed["bwd_bound_by"],
                    library_ms=timed["cudnn_bwd_ms"], shape=shape
                    + "; kernel_ms is the four backward kernels (B1, "
                      "B2, the weight-gradient GEMM and its slice sum) "
                      "and the wrapper's buffers; library: the cuDNN "
                      "composition's backward", **common)
        log(msg)
        del x, ws, affs, dy, aff, y, y_ref
        torch.cuda.empty_cache()
    for seed in (6, 7):
        log(k8_precision(failures, seed))


def k8_times(x, ws, affs, aff, dy, n, hw, cin, cm, cout):
    """Device ms of K8 forward and backward, the plain versions and the
    cuDNN composition, and the bounds: forward 2 R_out (4 Cin Cm + 9 Cm^2
    + Cm Cout + Cin Cout) FLOP against x, the weights, the affines and y;
    backward 3x those FLOP against x, dy, the weights and affines read
    and dx, the f32 weight and affine grads written."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    out = {}
    out["fwd_ms"] = time_ms(lambda: FB._launch_down_fwd(x, *ws, aff), 5,
                            graph=False)
    out["bwd_ms"] = time_ms(lambda: FB._launch_down_bwd(x, dy, *ws, aff), 5,
                            graph=False)
    out["bwd_split_ms"] = bwd_split(
        lambda: FB._launch_down_bwd(x, dy, *ws, aff), "down_bwd2_kernel")
    out["plain_fwd_ms"] = time_ms(lambda: FB.fused_bottleneck_down_fwd_ref(
        x, *ws, aff), 3, graph=False)
    out["plain_bwd_ms"] = time_ms(lambda: FB.fused_bottleneck_down_bwd_ref(
        x, dy, *ws, aff), 3, graph=False)
    leaves = [t.clone().requires_grad_() for t in [x] + ws + affs]
    with torch.no_grad():
        out["cudnn_fwd_ms"] = time_ms(lambda: k8_composition(
            leaves[0], leaves[1:5], leaves[5:]), 5, graph=False)
    lout = k8_composition(leaves[0], leaves[1:5], leaves[5:])
    ldy = dy.permute(0, 3, 1, 2)
    out["cudnn_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        lout, leaves, ldy, retain_graph=True), 5, graph=False)
    del lout, leaves
    r_out = n * (hw // 2) ** 2
    elt = x.element_size()
    flops = 2.0 * r_out * (4 * cin * cm + 9 * cm * cm + cm * cout
                           + cin * cout)
    wn = sum(w.numel() for w in ws)
    wbytes = wn * elt + aff.numel() * 4
    xbytes = n * hw * hw * cin * elt
    ybytes = r_out * cout * elt
    fb, fby = bound(xbytes + ybytes + wbytes, flops, "bfloat16")
    bb, bby = bound(2 * xbytes + ybytes + wbytes + (wn + aff.numel()) * 4,
                    3 * flops, "bfloat16")
    out.update(fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb,
               bwd_bound_by=bby, gflop_fwd=flops / 1e9)
    return out


K8_OUTPUTS = ("y", "dx", "dw1", "dw2", "dw3", "dw4", "daff")


def block_names(kind):
    """The outputs `block_outs` gives for K7 ("id", "proj") or K8
    ("down"), in order; the identity block has no dW4."""
    return tuple(n for n in K8_OUTPUTS if kind != "id" or n != "dw4")


def block_outs(kind, x, dy, ws, aff, cm, dot=None, masks=None, keep=None):
    """K7's (kind "id" or "proj") or K8's ("down") y, dx, dW1-4 (the
    identity block: dW1-3) and its affine-grad rows (8; the identity
    block: 6): the kernel's with `dot` "kernel", else the plain
    version's with its products taken by `dot` (None: its own f32
    `_dot`) and its relu masks `masks` (None: its own); `keep` receives
    the backward's h0, h1, dc0, dc1, dc2, dc4 (`_launch_bwd`)."""
    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    kernel = dot == "kernel"
    kw = dict(keep=keep) if kernel else dict(masks=masks, keep=keep)
    if kind == "down":
        fwd = FB._launch_down_fwd if kernel else \
            FB.fused_bottleneck_down_fwd_ref
        bwd = FB._launch_down_bwd if kernel else \
            FB.fused_bottleneck_down_bwd_ref
        args = list(ws)
    else:
        proj = kind == "proj"
        f7 = FB._launch_fwd if kernel else FB.fused_bottleneck_fwd_ref
        b7 = FB._launch_bwd if kernel else FB.fused_bottleneck_bwd_ref

        def fwd(*a):
            return f7(*a, proj)

        def bwd(*a, **kw):
            return b7(*a, proj, **kw)

        args = list(ws[:3]) + [ws[3] if proj else None]
    own = FB._dot
    FB._dot = (None if kernel else dot) or own
    try:
        y = fwd(x, *args, aff)
        dx, dw1, dw2, dw3, dw4, daff = bwd(x, dy, *args, aff, **kw)
    finally:
        FB._dot = own
    outs = [y, dx, dw1, dw2, dw3] + ([] if kind == "id" else [dw4])
    rows = [daff[i, :cm] if i < 4 else daff[i]
            for i in range(6 if kind == "id" else 8)]
    return outs, rows


def relu_inputs(kind, x, ws, aff, dot=None):
    """The three relu inputs u0, u1, pre of K7 (kind "id", "proj") or K8
    ("down") and the sums of the magnitudes of their terms
    (`near_ties.preactivations`), with the products taken by `dot`
    (None: the plain version's f32), each pair [R, C]."""
    from paddle_tpu_torch.tools import near_ties as NT

    own = NT._dot
    NT._dot = dot or own
    try:
        got = NT.preactivations(x, *ws[:3], ws[3] if kind != "id" else None,
                                aff, kind != "id", kind == "down")
    finally:
        NT._dot = own
    return [(u.reshape(-1, u.shape[-1]), m.reshape(-1, m.shape[-1]))
            for u, m in got]


def dot64(a, b):
    """The plain version's products in float64, rounded once to f32."""
    return (a.double() @ b.double()).float()


def rel_err(a, b):
    """Relative Frobenius error of a against b, in float64."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def block_errs(outs, ref):
    """rel_err of each output of `block_outs` against ref's (the affine
    grads: the worst of the rows), in `block_names` order."""
    errs = [rel_err(a, b) for a, b in zip(outs[0], ref[0])]
    errs.append(max(rel_err(a, b) for a, b in zip(outs[1], ref[1])))
    return errs


def relu_masks(kind, x, dy, ws, aff, cm, dot=None):
    """`block_outs` with the relu masks its backward chose, read from what
    it keeps (the kernel's scratch, or the plain version's): h0 > 0, h1 >
    0 and dc2 != 0 (pre's mask shows only where dy is nonzero); and the
    elements where dc0 or dc1 pass a gradient though h0 or h1 is 0 (none,
    when the backward masked with the same u0, u1 it rounded to h0,
    h1)."""
    keep = []
    outs = block_outs(kind, x, dy, ws, aff, cm, dot, keep=keep)
    h0, h1, dc0, dc1, dc2 = keep[:5]
    masks = [h0 > 0, h1 > 0, dc2 != 0]
    stray = int(((dc0 != 0) & ~masks[0]).sum()
                + ((dc1 != 0) & ~masks[1]).sum())
    return outs, masks, stray


class Precision:
    """The reference side of `block_numerics` on one draw: the plain f32
    version's outputs and masks, and those of the plain version with
    float64 products (p64), with p64's relu inputs and their sums of
    |terms|."""

    def __init__(self, kind, x, dy, ws, aff, cm):
        self.args = (kind, x, dy, ws, aff, cm)
        self.names = block_names(kind)
        self.plain, self.plain_masks, _ = relu_masks(*self.args)
        self.p64 = block_outs(*self.args, dot64)
        self.p64_in = relu_inputs(kind, x, ws, aff, dot64)
        self.dy_nonzero = dy.reshape(-1, dy.shape[-1]) != 0
        self.plain_err = block_errs(self.plain, self.p64)
        self.plain_flips = self.flips(self.plain_masks)
        self.plain_matched = block_errs(self.plain, block_outs(
            *self.args, dot64, self.plain_masks))

    def flips(self, masks):
        """Per relu (u0, u1, pre): the elements where `masks` differ from
        p64's u > 0 (pre's where dy is nonzero), and the largest |u| /
        sum|terms| among them."""
        out = []
        for r, (m, (u, s)) in enumerate(zip(masks, self.p64_in)):
            flip = m != (u > 0)
            if r == 2:
                flip &= self.dy_nonzero
            n = int(flip.sum())
            out.append((n, float((u.abs() / s.clamp_min(1e-30))[flip].max())
                        if n else 0.0))
        return out

    def gate(self, outs, masks):
        """The outputs on which `outs` (relu masks `masks`) fail, each
        with why, and the line's text: the errors against p64 with p64's
        masks and with each side's own, and the mask flips."""
        err = block_errs(outs, self.p64)
        matched = block_errs(outs, block_outs(*self.args, dot64, masks))
        flips = self.flips(masks)
        share = (sum(n for n, _ in flips)
                 / sum(u.numel() for u, _ in self.p64_in))
        worst = max(w for _, w in flips)
        foot = None
        if worst > TIE_BF16:
            foot = (f"a flipped mask at |u| {worst:.2e} of its sum of "
                    f"|terms| > {TIE_BF16:g}")
        elif share > FLIP_SHARE_MAX:
            foot = (f"flipped masks {share:.2e} of the relu inputs > "
                    f"{FLIP_SHARE_MAX:g}")
        bad = []
        for name, k, p, km, pm in zip(self.names, err, self.plain_err,
                                      matched, self.plain_matched):
            if k <= K8_P64_RATIO * p:
                continue
            why = (f"error against float64 products {k:.2e} > "
                   f"{K8_P64_RATIO} x the plain version's {p:.2e}")
            if foot:
                bad.append((name, f"{why}; {foot}"))
            elif km > K8_P64_RATIO * pm:
                bad.append((name, f"{why}; with each side's relu masks "
                            f"{km:.2e} > {K8_P64_RATIO} x {pm:.2e}"))

        def errs(v):
            return " ".join(f"{n} {e:.2e}" for n, e in zip(self.names, v))

        def flip_text(f):
            return " ".join(f"{r} {n} ({w:.1e})" for r, (n, w) in
                            zip(("u0", "u1", "pre"), f))

        return bad, (
            f"against p64 [{errs(err)}] plain [{errs(self.plain_err)}]; "
            f"own masks [{errs(matched)}] plain "
            f"[{errs(self.plain_matched)}]; masks off p64's (worst "
            f"|u|/sum|terms|) [{flip_text(flips)}] plain "
            f"[{flip_text(self.plain_flips)}], share {share:.1e}")


def block_numerics(kind, x, dy, ws, aff, cm, failures, tag, controls=False):
    """K7's (kind "id", "proj") or K8's ("down") bf16 precision on the
    caller's draw of x and dy: per output (y, dx, dW1-4, the affine
    grads: the worst of the rows) the relative Frobenius error against
    the plain version with float64 products (p64), for the kernel and
    for the plain f32 version.  An output fails where the kernel's
    exceeds K8_P64_RATIO times the plain version's, unless the relu
    masks account for the excess (TIE_BF16, FLIP_SHARE_MAX): each
    side's masks (`relu_masks`: for the kernel read from its scratch)
    are imposed on p64, and the ratio must then hold.  Also fails where
    the kernel passes a gradient through a relu whose output it kept as
    0, where a second run gives dW1-4 that are not bitwise equal (the
    slice sums are taken in a fixed order), and, with `controls`, where
    the gate passes the plain version on one of CONTROLS' lower-precision
    sums."""
    import torch

    t0 = time.perf_counter()
    kern, masks, stray = relu_masks(kind, x, dy, ws, aff, cm, "kernel")
    again = block_outs(kind, x, dy, ws, aff, cm, "kernel")
    same = all(torch.equal(a, b) for a, b in zip(kern[0][2:], again[0][2:]))
    del again
    if not same:
        failures.append(f"{tag}: dW1-4 differ between two runs")
    if stray:
        failures.append(f"{tag}: dc0 or dc1 nonzero at {stray} elements "
                        "where the kernel's h0 or h1 is 0")
    ref = Precision(kind, x, dy, ws, aff, cm)
    bad, text = ref.gate(kern, masks)
    failures += [f"{tag} {name}: kernel {why}" for name, why in bad]
    text = f"precision kernel {text}; dW1-4 bitwise repeatable {same}"
    for name, dot in (CONTROLS if controls else ()):
        cbad, ctext = ref.gate(*relu_masks(kind, x, dy, ws, aff, cm, dot)[:2])
        if not cbad:
            failures.append(f"{tag}: the precision gate passes the control "
                            f"{name}")
        text += (f"; control {name}: fails on "
                 f"[{' '.join(n for n, _ in cbad)}] {ctext}")
    return text + f"; {time.perf_counter() - t0:.1f} s"


def hmma_dot(toward_zero, accumulate=False):
    """A model of the sums of `pt::tc::product` (csrc/mma.cuh) for the
    plain version's products: each 16-deep group of K summed exactly
    (float64), rounded to f32 as one mma returns it (toward zero, or to
    nearest), and the groups added in K order in f32.  With
    `accumulate`, the mma's own accumulation instead: each group added
    exactly to the running f32 sum and the result rounded so."""
    import torch

    def dot(a, b):
        a, b = a.double(), b.double()
        acc = torch.zeros(a.shape[0], b.shape[1], device=a.device)
        for k0 in range(0, a.shape[1], 16):
            s = a[:, k0:k0 + 16] @ b[k0:k0 + 16]
            if accumulate:
                s = s + acc.double()
            f = s.float()
            if toward_zero:
                f = torch.where(f.double().abs() > s.abs(),
                                torch.nextafter(f, torch.zeros_like(f)), f)
            acc = f if accumulate else acc + f
        return acc

    return dot


def dot_bf16(a, b):
    """The plain version's products with each sum rounded to bf16."""
    import torch

    return torch.matmul(a.float(), b.float()).to(torch.bfloat16).float()


# block_numerics' controls: the plain version on sums of lower precision,
# which its gate must fail
CONTROLS = (("bf16 sums", dot_bf16),
            ("the mma's own accumulation", hmma_dot(True, accumulate=True)))


def k8_precision(failures, seed):
    """K8 in bf16 at the stage-3 transition (28^2 512 -> 1024, Cm 256),
    batch 8, on the inputs of the small tests' scales (test_torch_fused_
    down_stem.py `_down_args(seed, ...)`: x 0.5, weights 0.2, affines 1
    + 0.3 N and 0.1 N; dy from a generator seeded 1), where the
    activations reach the hundreds (at seed 6, the cuda-marked test's
    first draw, the kernel's error against float64 products (p64)
    exceeds the plain f32 version's).  Prints that
    error for the kernel, the plain version and the plain version on
    two models of the tensor core's sums (`hmma_dot`: rz toward zero, rn
    to nearest), per output, and the share of y's elements bitwise
    equal to the kernel's.  Fails unless the kernel's error is the rz
    model's within K8_MODEL_BAND on every output and its y is the rz
    model's in all but K8_MODEL_Y_OFF of the elements: the gap is then
    the tensor core's arithmetic, not the kernel's indexing."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    n, hw, cin, cm, cout = 8, 28, 512, 256, 1024
    g = np.random.default_rng(seed).standard_normal
    arrs = [g((n, hw, hw, cin)) * 0.5, g((cin, cm)) * 0.2,
            g((3, 3, cm, cm)) * 0.2, g((cm, cout)) * 0.2,
            g((cin, cout)) * 0.2]
    for c in (cm, cm, cout, cout):
        arrs += [g(c) * 0.3 + 1, g(c) * 0.1]
    x, *ws = [torch.from_numpy(a.astype(np.float32)).to("cuda",
                                                        torch.bfloat16)
              for a in arrs]
    ws, affs = ws[:4], ws[4:]
    aff = FB._pack_affines(affs, cout)
    dy = torch.randn((n, hw // 2, hw // 2, cout), device="cuda",
                     dtype=torch.bfloat16,
                     generator=torch.Generator(device="cuda").manual_seed(1))
    p64 = block_outs("down", x, dy, ws, aff, cm, dot64)
    runs = {k: block_outs("down", x, dy, ws, aff, cm, d) for k, d in (
        ("kernel", "kernel"), ("plain", None), ("rz", hmma_dot(True)),
        ("rn", hmma_dot(False)))}
    errs = {k: block_errs(v, p64) for k, v in runs.items()}
    y = runs["kernel"][0][0]
    off = {k: torch.ne(v[0][0], y).float().mean().item()
           for k, v in runs.items() if k != "kernel"}
    tag = f"K8 28x28 512/256/1024 n={n} bfloat16 weights 0.2 seed {seed}"
    for name, k, rz in zip(K8_OUTPUTS, errs["kernel"], errs["rz"]):
        if abs(k - rz) > K8_MODEL_BAND * rz:
            failures.append(f"{tag} {name}: kernel error against p64 "
                            f"{k:.3e}, the rz model's {rz:.3e}")
    if off["rz"] > K8_MODEL_Y_OFF:
        failures.append(f"{tag}: y differs from the rz model's in "
                        f"{off['rz']:.2e} of the elements")
    parts = [f"{k}-p64 [" + " ".join(f"{n} {e:.3e}" for n, e in
                                     zip(K8_OUTPUTS, v)) + "]"
             for k, v in errs.items()]
    return (f"{tag}: rel Frobenius {' '.join(parts)}; y elements off the "
            "kernel's: " + " ".join(f"{k} {v:.2e}" for k, v in off.items()))


def bwd_split(run, b2):
    """Device ms of one K7 or K8 backward, `run()`, by kernel
    (torch.profiler): B1, B2 (the kernel named `b2`), the weight-gradient
    GEMM (W), its slice sum (R) and the rest (the wrapper's zeroed affine
    grads)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    parts = {"B1": 0.0, "B2": 0.0, "W": 0.0, "R": 0.0, "rest": 0.0}
    names = {"block_bwd1_kernel": "B1", b2: "B2", "wgrad_kernel": "W",
             "wsum_kernel": "R"}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.self_device_time_total <= 0:
            continue
        part = next((v for k, v in names.items() if k in e.key), "rest")
        parts[part] += e.self_device_time_total / 1e3
    return "/".join(f"{k} {v:.4f}" for k, v in parts.items())


def stem_inputs(rnd, shape, dt, ties):
    """K9 inputs: c (random, or drawn from the levels -1, 0, 1, 2 with a =
    1, b = 0 so most windows hold exact ties, at the max and at 0), the
    f32 affine [2, C] and a cotangent."""
    import torch

    cm = shape[-1]
    dev = torch.device("cuda")
    if ties:
        c = (torch.floor(rnd(shape, torch.float32) * 1.2).clamp(-1, 2)
             ).to(dt)
        aff = torch.stack([torch.ones(cm, device=dev),
                           torch.zeros(cm, device=dev)])
    else:
        c = rnd(shape, dt)
        aff = torch.stack([rnd((cm,), torch.float32, 0.3) + 1.0,
                           rnd((cm,), torch.float32, 0.1)])
    n, h, w, _ = shape
    return c, aff, rnd((n, h // 2, w // 2, cm), dt)


def stem_tail_checks(rows, failures, rnd):
    """K9 forward and backward against the plain versions: y and dc
    exactly, da/db within the tolerance (f32 sums over the rows, atol tol
    * sqrt(rows)) and bitwise equal over two calls, at the ResNet-50
    stem's shape in f32 (batch 2) and bf16 (batch 128, timed, with the
    backward's plan and a sweep of its tilings), on random and tie-heavy
    inputs, through `_StemTail` as well; the raw kernel at a side above
    112 (the public function takes the composition there); then
    `stem_ragged` (their own generator, so later checks keep their
    draws)."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    cases = [((2, 112, 112, 64), torch.float32, False),
             ((2, 112, 112, 64), torch.float32, True),
             ((128, 112, 112, 64), torch.bfloat16, False),
             ((128, 112, 112, 64), torch.bfloat16, True),
             ((2, 128, 128, 64), torch.float32, False),
             ((2, 128, 128, 64), torch.bfloat16, True)]
    for shape, dt, ties in cases:
        d = dname(dt)
        n, h, w, cm = shape
        rows_n = n * h * w
        tag = f"K9 {list(shape)} {'ties' if ties else 'random'} {d}"
        c, aff, dy = stem_inputs(rnd, shape, dt, ties)
        msg, err_a = stem_check(tag, c, aff, dy, failures)
        if h <= FB._STEM_SIDE_LIMIT:
            leaves = [c.clone().requires_grad_(),
                      aff[0].to(dt).requires_grad_(),
                      aff[1].to(dt).requires_grad_()]
            out = FB.fused_stem_tail(*leaves)
            faff = torch.stack([leaves[1].detach().float(),
                                leaves[2].detach().float()])
            want_y = FB.fused_stem_tail_fwd_ref(c, faff)
            want_dc, want_daff = FB.fused_stem_tail_bwd_ref(c, dy, faff)
            if not torch.equal(out, want_y):
                failures.append(f"{tag} Function y: not exact")
            got = torch.autograd.grad(out, leaves, dy)
            err_fn = compare_k7(tag + " Function dc", got[0], want_dc, d, 1,
                                failures)
            for g, wv, nm in ((got[1], want_daff[0], "da"),
                              (got[2], want_daff[1], "db")):
                if g.dtype != dt:
                    failures.append(f"{tag} Function {nm} dtype {g.dtype}")
                err_fn = max(err_fn, compare_k7(
                    f"{tag} Function {nm}", g, wv.to(dt), d, rows_n,
                    failures))
            msg += f"; Function max_err {err_fn:.3e}"
            del leaves, out, got
        if dt == torch.bfloat16 and not ties and h == 112:
            timed = k9_times(c, aff, dy)
            msg += "; " + timed_text(timed)
            k9_plan_sweep(c, aff, dy)
            common = dict(route="cuda",
                          source="paddle_tpu_torch/csrc/fused_stem_tail.cu",
                          shape="c [128, 112, 112, 64] -> [128, 56, 56, 64] "
                                "bf16 (ResNet-50 stem); library: "
                                "F.max_pool2d(F.relu(c * a + b), 3, 2, 1), "
                                "a first-wins yardstick, not one call")
            rows["fused_stem_tail_fwd"] = dict(
                name="K9 fused_stem_tail_fwd",
                replaces="paddle_tpu/kernels/fused_bottleneck.py:761",
                max_abs_err=0.0, ms=timed["fwd_ms"],
                plain_ms=timed["plain_fwd_ms"],
                bound_ms=timed["fwd_bound_ms"],
                bound_by=timed["fwd_bound_by"],
                library_ms=timed["library_fwd_ms"], **common)
            rows["fused_stem_tail_bwd"] = dict(
                name="K9 fused_stem_tail_bwd",
                replaces="paddle_tpu/kernels/fused_bottleneck.py:775",
                max_abs_err=err_a, ms=timed["bwd_ms"],
                plain_ms=timed["plain_bwd_ms"],
                bound_ms=timed["bwd_bound_ms"],
                bound_by=timed["bwd_bound_by"],
                library_ms=timed["library_bwd_ms"], **common)
        log(msg)
        del c, aff, dy
        torch.cuda.empty_cache()
    stem_ragged(failures)


def stem_text(plan):
    return (f"plan R {plan['rows']} x Q {plan['cols']} windows x "
            f"{plan['chans']} channels, {plan['grid']} blocks "
            f"({plan['blocks_per_sm']} per SM, {plan['smem']} B shared), "
            f"{plan['tiles']} tiles x {plan['groups']} channel groups")


def stem_check(tag, c, aff, dy, failures, tiling=None):
    """One K9 check on the card: y and dc bitwise the plain versions',
    da/db within atol 2e-5 * sqrt(rows) (f32 sums in another order) and
    bitwise equal over two calls.  Returns (the line's text, the da/db
    error; dc's is 0 when it passes)."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    n, h, w, _ = c.shape
    y = FB._launch_stem_fwd(c, aff)
    if not torch.equal(y, FB.fused_stem_tail_fwd_ref(c, aff)):
        failures.append(f"{tag} y: not exact")
    dc, daff = FB._launch_stem_bwd(c, dy, aff, tiling)
    dc2, daff2 = FB._launch_stem_bwd(c, dy, aff, tiling)
    dc_ref, daff_ref = FB.fused_stem_tail_bwd_ref(c, dy, aff)
    err = (dc.float() - dc_ref.float()).abs().max().item()
    if not torch.equal(dc, dc_ref):
        failures.append(f"{tag} dc: not exact, max_abs_err {err:.3e}")
    if not (torch.equal(dc, dc2) and torch.equal(daff, daff2)):
        failures.append(f"{tag}: dc or da/db differ over two calls")
    err_a = compare_k7(tag + " da/db", daff, daff_ref, "float32", n * h * w,
                       failures)
    plan = FB.stem_plan(c.shape, c.dtype, tiling)
    return (f"{tag}: y exact; dc exact; da/db max_err {err_a:.3e}, bitwise "
            f"over two calls; {stem_text(plan)}", err_a)


# K9 backward tilings timed at the stem (bf16): (window rows, window
# columns, 16-byte channel vectors per block), each within 4 R Q vecs <=
# 2048 own vectors
K9_TILINGS = ((8, 14, 4), (4, 28, 4), (8, 28, 2), (4, 14, 8), (16, 14, 2),
              (2, 56, 4), (4, 56, 2), (4, 14, 4), (2, 28, 4), (16, 28, 1))


def k9_plan_sweep(c, aff, dy):
    """K9 backward's device ms at each of K9_TILINGS on the stem's
    inputs, with each plan; the default (STEM_BWD_TILING) is the first."""
    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    for tiling in K9_TILINGS:
        ms = time_ms(lambda: FB._launch_stem_bwd(c, dy, aff, tiling))
        log(f"K9 bwd plan sweep {tiling}: {ms:.4f} ms; "
            f"{stem_text(FB.stem_plan(c.shape, c.dtype, tiling))}")


# K9's ragged geometries: (shape, dtype, tiling); the tiles do not divide
# Ho or Wo, Ho = 1, Wo = 1, C = 16 and 64, several tilings
K9_RAGGED = (((4, 16, 12, 16), "float32", None),
             ((3, 2, 2, 16), "bfloat16", None),
             ((2, 2, 30, 64), "bfloat16", (1, 4, 2)),
             ((2, 30, 2, 64), "float32", (4, 1, 8)),
             ((5, 22, 18, 64), "bfloat16", (4, 4, 4)),
             ((2, 26, 118, 64), "bfloat16", None),
             ((3, 18, 34, 16), "float32", (2, 5, 4)),
             ((7, 112, 112, 64), "bfloat16", (3, 10, 8)))


def stem_ragged(failures):
    """K9 at K9_RAGGED, random and tie-heavy, from a generator of their
    own: `stem_check` each."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(9)

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dt)

    for shape, d, tiling in K9_RAGGED:
        for ties in (False, True):
            c, aff, dy = stem_inputs(rnd, shape, getattr(torch, d), ties)
            log(stem_check(f"K9 ragged {list(shape)} tiling {tiling} "
                           f"{'ties' if ties else 'random'} {d}", c, aff,
                           dy, failures, tiling)[0])


def k9_times(c, aff, dy):
    """Device ms of K9 forward and backward (one launch each), the plain
    versions and the yardstick max-pool of the
    relu'd affine (its backward through autograd), and the bounds: bytes
    c + y (forward), c + dy + dc (backward); operations 3 per element of
    c and 8 per element of y (forward: the affine, the relu, the window
    max), 11 per element of c and 8 per element of y (backward: the
    recomputed forward, the equality routing over 2.25 windows on
    average, the mask, dc and the da/db sums)."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    out = {}
    out["fwd_ms"] = time_ms(lambda: FB._launch_stem_fwd(c, aff))
    out["bwd_ms"] = time_ms(lambda: FB._launch_stem_bwd(c, dy, aff))
    out["plain_fwd_ms"] = time_ms(lambda: FB.fused_stem_tail_fwd_ref(c, aff),
                                  3, graph=False)
    out["plain_bwd_ms"] = time_ms(
        lambda: FB.fused_stem_tail_bwd_ref(c, dy, aff), 3, graph=False)
    a = aff[0].to(c.dtype)[None, :, None, None]
    b = aff[1].to(c.dtype)[None, :, None, None]
    lc = c.permute(0, 3, 1, 2).clone().requires_grad_()

    def lib():
        return TF.max_pool2d(torch.relu(lc * a + b), 3, 2, 1)

    with torch.no_grad():
        out["library_fwd_ms"] = time_ms(lib, 5, graph=False)
    lout = lib()
    ldy = dy.permute(0, 3, 1, 2)
    out["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        lout, lc, ldy, retain_graph=True), 5, graph=False)
    del lout, lc
    n_c, n_y = c.numel(), dy.numel()
    elt = c.element_size()
    fb, fby = bound((n_c + n_y) * elt + aff.numel() * 4,
                    3.0 * n_c + 8.0 * n_y, "bfloat16")
    bb, bby = bound((2 * n_c + n_y) * elt + aff.numel() * 12,
                    11.0 * n_c + 8.0 * n_y, "bfloat16")
    out.update(fwd_bound_ms=fb, fwd_bound_by=fby, bwd_bound_ms=bb,
               bwd_bound_by=bby)
    return out


# ---------------------------------------------------------------------------
# phase 2b: the probes P1 and P2, K7 beside them, the port's probe tool
# ---------------------------------------------------------------------------

def probes_phase(failures):
    """P1 (K7's 3x3 conv alone) and P2 (its 1x1 chain) against their
    plain versions on the card, in f32 at batch 2 and bf16 at the tool's
    batch 8 and ResNet-50's batch 128 (ResNet-50 stage 1: 56^2, Cin 256,
    Cm 64), and at a ragged 11 x 7 in both dtypes; their times beside
    the plain versions, a library yardstick and the bound; K7's stage-1
    identity forward on the same x, w1, w2, w3 beside them, each with the
    routine it runs on; then the port's probe tool, all seven probes,
    each of which must exit 0 having launched its kernel.
    The inputs come from a generator of their own, so the kernel phase's
    draws are those of earlier runs."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB
    from paddle_tpu_torch.kernels import fused_probe as FP

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    hw, cin, cm = 56, 256, 64

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    rows, out = {}, {}
    # 11 x 7: a ragged geometry, whose last tile of rows is partial for
    # both probes (P1's halo fill and output rows past H)
    for dt, n, h, w in ((torch.float32, 2, 11, 7),
                        (torch.bfloat16, 2, 11, 7),
                        (torch.float32, 2, hw, hw),
                        (torch.bfloat16, 8, hw, hw),
                        (torch.bfloat16, 128, hw, hw)):
        d = dname(dt)
        x1 = rnd((n, h, w, cm), dt)
        w2 = rnd((3, 3, cm, cm), dt, (9 * cm) ** -0.5)
        x2 = rnd((n, h, w, cin), dt)
        w1 = rnd((cin, cm), dt, cin ** -0.5)
        w3 = rnd((cm, cin), dt, cm ** -0.5)
        err1 = compare(f"P1 x [{n}, {h}, {w}, {cm}] {d}",
                       FP.conv3x3_probe(x1, w2),
                       FP.conv3x3_probe_ref(x1, w2), d, failures)
        err2 = compare(f"P2 x [{n}, {h}, {w}, {cin}] Cm {cm} {d}",
                       FP.matmul_chain_probe(x2, w1, w3),
                       FP.matmul_chain_probe_ref(x2, w1, w3), d, failures)
        ths, blocks = FP.probe_tiles(h, w, cm, dt)
        k7 = FB.block_plan(n, h, w, cin, cm, cin, False, dt)
        log(f"P1 [{n}, {h}, {w}, {cm}] {d}: max_err {err1:.3e}; P2 "
            f"[{n}, {h}, {w}, {cin}] -> {cm} {d}: max_err {err2:.3e}; "
            f"tile rows (K7 forward, P1, P2) "
            f"{(k7['tile_rows'][0], *ths)}, blocks per SM "
            f"{(k7['per_sm'][0], *blocks)}")
        if h != hw and not all(t and h % t for t in ths):
            failures.append(f"P1/P2 [{n}, {h}, {w}]: tile rows {ths} leave "
                            "no partial tile")
        if n == 128 and (ths[0] != k7["tile_rows"][0]
                         or (ths[1], blocks[1]) != (k7["tile_rows"][0],
                                                    k7["per_sm"][0])):
            # K7 - P1 - P2 splits K7's forward only at one tiling
            failures.append(f"P1/P2 [{n}, {h}, {w}] {d}: tile rows {ths}, "
                            f"P2 blocks per SM {blocks[1]}; K7's forward "
                            f"{k7['tile_rows'][0]}, {k7['per_sm'][0]}")
        if n == 128:
            out = probe_times(x1, w2, x2, w1, w3, rnd)
            common = dict(route="cuda",
                          source="paddle_tpu_torch/csrc/fused_bottleneck.cu")
            rows["probe_conv3x3"] = dict(
                name="P1 probe_conv3x3", replaces="tools/fused_probe.py:88",
                max_abs_err=err1, ms=out["p1_ms"], plain_ms=out["p1_plain"],
                bound_ms=out["p1_bound"], bound_by=out["p1_by"],
                library_ms=out["p1_lib"], shape="x [128, 56, 56, 64], w2 "
                "[3, 3, 64, 64] bf16 (ResNet-50 stage 1); library: "
                "F.conv2d, channels-last", **common)
            rows["probe_matmuls"] = dict(
                name="P2 probe_matmuls", replaces="tools/fused_probe.py:114",
                max_abs_err=err2, ms=out["p2_ms"], plain_ms=out["p2_plain"],
                bound_ms=out["p2_bound"], bound_by=out["p2_by"],
                library_ms=out["p2_lib"], shape="x [128, 56, 56, 256] -> 64 "
                "-> 256 bf16 (ResNet-50 stage 1); library: relu(x @ w1) @ "
                "w3 + x, two cuBLAS products", **common)
        del x1, w2, x2, w1, w3
    torch.cuda.empty_cache()
    return {"rows": rows, "tool": probe_tool(failures)}


def probe_times(x1, w2, x2, w1, w3, rnd):
    """Device ms at batch 128 bf16 of P1 and P2, their plain versions,
    their library yardsticks and bounds, and the K7 stage-1 identity
    forward on the same x2, w1, w2, w3 (affines near (1, 0)), split three
    ways: P1 (K7's conv3x3), P2 (K7's 1x1 products with the residual on
    the own pixels) and K7 - P1 - P2 (the halo's h0 product, the affines
    and the rest).  Both probes run K7's pieces at K7's forward tile rows
    and blocks per SM (probes_phase checks them)."""
    import torch
    import torch.nn.functional as TF

    from paddle_tpu_torch.kernels import fused_bottleneck as FB
    from paddle_tpu_torch.kernels import fused_probe as FP

    n, hw, _, cm = x1.shape
    cin = x2.shape[-1]
    r, elt = n * hw * hw, x1.element_size()
    o = {}
    o["p1_ms"] = time_ms(lambda: FP.conv3x3_probe(x1, w2), 10, graph=False)
    o["p2_ms"] = time_ms(lambda: FP.matmul_chain_probe(x2, w1, w3), 10,
                         graph=False)
    o["p1_plain"] = time_ms(lambda: FP.conv3x3_probe_ref(x1, w2), 3,
                            graph=False)
    o["p2_plain"] = time_ms(lambda: FP.matmul_chain_probe_ref(x2, w1, w3),
                            3, graph=False)
    xc = x1.permute(0, 3, 1, 2)                       # channels-last view
    w_oihw = w2.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x2d = x2.reshape(r, cin)
    with torch.no_grad():
        o["p1_lib"] = time_ms(lambda: TF.conv2d(xc, w_oihw, padding=1), 10,
                              graph=False)
        o["p2_lib"] = time_ms(lambda: torch.relu(x2d @ w1).to(
            torch.bfloat16) @ w3 + x2d, 10, graph=False)
    o["p1_bound"], o["p1_by"] = bound(
        2 * x1.numel() * elt + w2.numel() * elt, 2.0 * r * 9 * cm * cm,
        "bfloat16")
    o["p2_bound"], o["p2_by"] = bound(
        2 * x2.numel() * elt + (w1.numel() + w3.numel()) * elt,
        2.0 * r * 2 * cin * cm, "bfloat16")
    affs = [(rnd((c,), torch.float32, 0.3) + (1.0 if i % 2 == 0 else 0.0)
             ).to(x2.dtype) for i, c in enumerate([cm] * 4 + [cin] * 2)]
    aff = FB._pack_affines(affs, cin)
    o["k7_ms"] = time_ms(lambda: FB._launch_fwd(x2, w1, w2, w3, None, aff,
                                                False), 10, graph=False)
    log(f"P1 [{n}, {hw}, {hw}, {cm}] bf16: kernel_ms {o['p1_ms']:.4f} "
        f"plain_ms {o['p1_plain']:.4f} library_ms {o['p1_lib']:.4f} "
        f"bound_ms {o['p1_bound']:.5f} ({o['p1_by']})")
    log(f"P2 [{n}, {hw}, {hw}, {cin}] -> {cm} bf16: kernel_ms "
        f"{o['p2_ms']:.4f} plain_ms {o['p2_plain']:.4f} library_ms "
        f"{o['p2_lib']:.4f} bound_ms {o['p2_bound']:.5f} ({o['p2_by']})")
    k7_flop = 2.0 * r * (2 * cin * cm + 9 * cm * cm)
    p1_flop = 2.0 * r * 9 * cm * cm
    p2_flop = 2.0 * r * 2 * cin * cm
    rest = o["k7_ms"] - o["p1_ms"] - o["p2_ms"]
    log(f"K7 split three ways, stage-1 identity forward [{n}, {hw}, {hw}, "
        f"{cin}] Cm {cm} bf16: K7 {o['k7_ms']:.4f} ms "
        f"({k7_flop / o['k7_ms'] / 1e9:.2f} TFLOP/s without its halo) = "
        f"P1 (the 3x3) {o['p1_ms']:.4f} ms "
        f"({p1_flop / o['p1_ms'] / 1e9:.2f} TFLOP/s, "
        f"{o['p1_ms'] / o['k7_ms']:.1%}) + P2 (the 1x1 chain and the "
        f"residual) {o['p2_ms']:.4f} ms "
        f"({p2_flop / o['p2_ms'] / 1e9:.2f} TFLOP/s, "
        f"{o['p2_ms'] / o['k7_ms']:.1%}) + the rest (the halo's h0 "
        f"product, the affines) {rest:.4f} ms ({rest / o['k7_ms']:.1%})")
    return o


def probe_tool(failures):
    """`python -m paddle_tpu_torch.tools.fused_probe`, all seven probes in
    their subprocesses; each must exit 0 having launched its kernel.
    Returns the launches each kernel made, summed over the probes."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.tools.fused_probe"], cwd=repo,
                       capture_output=True, text=True, timeout=900)
    recs = [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]
    launches = {}
    for rec in recs:
        log(f"probe tool {rec['probe']}: rc {rec['rc']} kernel "
            f"{rec['kernel']} launches {rec['launches']} ms {rec['ms']} "
            f"wall {rec['wall_s']} s")
        if rec["rc"] != 0 or rec["launches"] < 1:
            failures.append(f"probe tool {rec['probe']}: rc {rec['rc']}, "
                            f"{rec['launches']} launches of "
                            f"{rec['kernel']}: {rec.get('stderr', '')}")
        launches[rec["kernel"]] = (launches.get(rec["kernel"], 0)
                                   + rec["launches"])
    if r.returncode != 0 or len(recs) != 7:
        failures.append(f"probe tool: exit {r.returncode}, {len(recs)} of 7 "
                        f"probes reported: {r.stderr[-400:]}")
    log(f"probe tool: {time.perf_counter() - t0:.1f} s, launches {launches}")
    return launches


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
    make_train_step.  Fails unless the profiled step's 25 LayerNorm
    backwards launch exactly one kernel each, K5's.  Returns the launches
    of its timed steps."""
    gpt = train_run(failures)
    ln = gpt["profile"]["ln_bwd"]
    if len(ln) != TRAIN_LAUNCHES["layer_norm_bwd"] or any(
            len(k) != 1 or not re.search(r"ln_bwd(_wide)?_kernel", k[0])
            for k in ln):
        failures.append(f"train step: a LayerNorm backward is not exactly "
                        f"one K5 kernel: {ln}")
    return gpt["launches"]


def train_run(failures):
    """The train phase's run: {launches, step_ms (host, mean), profile
    (`profile_train_step`'s device ms per step and per kernel family)}."""
    import torch

    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW

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
    prof = profile_train_step(step, state, (x, y), mean_ms)
    ln = prof["ln_bwd"]
    log(f"train step: {prof['kernels']} kernels; {len(ln)} LayerNorm "
        f"backwards, kernels each {sorted({len(k) for k in ln})}: "
        f"{sorted({n[:40] for k in ln for n in k})}")
    del model, state, step
    torch.cuda.empty_cache()
    return dict(launches=launches, step_ms=mean_ms, profile=prof)


def profile_train_step(step, state, batch, host_ms, label="train", steps=1,
                       families=()):
    """Where a train step's time goes: device time per step and the
    busiest kernels (torch.profiler over `steps` steps, kernel events
    only), against the step's host-clock time measured without the
    profiler.  Returns {"device": ms, "kernels": launches, family: ms}
    per step (KERNEL_FAMILIES and `families` found in the window) and
    "ln_bwd", the kernels of each LayerNorm backward in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(state, *batch)
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total / steps,
             e.count / steps if steps > 1 else e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(r[0] for r in rows) / 1e3
    log(f"{label} step profile ({steps} step{'s' * (steps > 1)}): host "
        f"{host_ms:.3f} ms/step (mean, no profiler), device "
        f"{device_ms:.3f} ms/step, device busy {device_ms / host_ms:.1%}; "
        f"{sum(r[1] for r in rows):g} kernel launches per step")
    for us, count, key in sorted(rows, reverse=True)[:14]:
        log(f"  {us / 1e3:9.4f} ms  {us / device_ms / 10:5.1f}%  "
            f"{count:7g}x  {key[:90]}")
    shares = []
    found = {"device": device_ms, "kernels": sum(r[1] for r in rows),
             "ln_bwd": ln_backward_kernels(prof)}
    for fam, pattern in KERNEL_FAMILIES + tuple(families):
        ms = sum(r[0] for r in rows if re.search(pattern, r[2])) / 1e3
        if ms:
            found[fam] = ms
            shares.append(f"{fam} {ms:.3f} ms ({ms / device_ms:.1%})")
    if shares:
        log(f"{label} step device time by kernel: " + ", ".join(shares))
    return found


def ln_backward_kernels(prof):
    """The device kernels each LayerNorm backward (an autograd node
    `_LayerNormBackward` of the profile) launched, itself and through the
    ops under it: [[kernel name, ...] per node]."""
    def kernels(evt):
        return [k.name for k in evt.kernels] + [
            n for c in evt.cpu_children for n in kernels(c)]

    return [kernels(e) for e in prof.events()
            if e.name == "_LayerNormBackward"]


# device time of a step by the port's kernels: K1, K2, K3 (the scalar or
# the tensor-core kernel), K4, K5 (its CUDA kernels, or the Triton kernel
# of earlier trees without the sums beside it), K7 (the stride-1 block:
# its former CUDA-core kernels, or the stride-1 instances of
# csrc/block_tc.cuh and K7's B2), K8 (the stride-2 instances and K8's B2,
# or its former kernels), the slice sums both share, K9 (profiler keys
# print template arguments as "<T, 1, ...>")
KERNEL_FAMILIES = (
    ("K1", r"flash_fwd_(mma_)?kernel"),
    ("K2", r"flash_bwd_dq_(mma_)?kernel"),
    ("K3", r"flash_bwd_dkv_(mma_)?kernel"),
    ("K4", r"_ln_fwd_kernel"),
    ("K5", r"ln_bwd(_wide)?_kernel"),
    ("K7", r"bottleneck_(fwd|bwd1|bwd2)_kernel|block_(fwd|bwd1)_kernel<[^,]+,"
           r" 1,|block_bwd2_kernel|wgrad_kernel<[^,]+, 1>"),
    ("K8", r"down_(fwd|bwd1|bwd2|wgrad|wsum)_kernel|block_(fwd|bwd1)_kernel"
           r"<[^,]+, 2,|wgrad_kernel<[^,]+, 2>"),
    ("slice sums (K7, K8)", r"(?<!down_)wsum_kernel"),
    ("K9", r"stem_(fwd|bwd|sum)_kernel"),
    ("K10", r"count_ge_kernel"),
)


# more families for the static path's steps: the products (cuBLAS and
# CUTLASS kernels; the top kernels' names say which are bf16), and the
# dtype-converting and plain copies (the AMP casts run as
# `direct_copy_kernel`s)
STATIC_FAMILIES_MORE = (
    ("products", r"gemm|nvjet|xmma|cutlass|cublas"),
    ("copies and casts", r"direct_copy|copy_kernel"),
)


# ---------------------------------------------------------------------------
# phase 4: the ResNet-50 train path
# ---------------------------------------------------------------------------

RESNET50_FWD_FLOPS_224 = 4.089e9       # bench.py's per-image forward count
# per step: the full fused program (PADDLE_TPU_FUSED_SUBSET empty: K7 on
# the 12 identity blocks and the stage-1 projection block, K8 on the 3
# transitions, K9 on the stem), the `id` subset, the unfused step
RESNET_LAUNCHES = {
    "full": {"fused_bottleneck_fwd": 13, "fused_bottleneck_bwd": 13,
             "fused_bottleneck_down_fwd": 3, "fused_bottleneck_down_bwd": 3,
             "fused_stem_tail_fwd": 1, "fused_stem_tail_bwd": 1},
    "id": {"fused_bottleneck_fwd": 12, "fused_bottleneck_bwd": 12},
    "unfused": {},
}
RESNET_FUSED_BLOCKS = {"full": 16, "id": 12, "unfused": 0}


def resnet_run(mode, failures, steps=5, batch=128):
    """bench.py `resnet50_time_config` (bench_resnet50_fused with fused,
    under the subset of `mode`; bench_resnet50 unfused): ResNet-50 bf16
    NHWC, ghost batch norm over 16 samples, Momentum(0.1, 0.9),
    cross-entropy, one seeded batch of 128 x 3 x 224 x 224 repeated; one
    warm-up step and `steps` timed ones.  Returns (launches over the
    timed steps, mean step ms)."""
    import os

    import torch

    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import Momentum

    fused = mode != "unfused"
    label = f"resnet {mode}"
    os.environ["PADDLE_TPU_FUSED_SUBSET"] = "id" if mode == "id" else ""
    model = resnet50(dtype="bfloat16", data_format="NHWC",
                     bn_stats_sample=16, fused=fused, device="cuda",
                     generator=make_generator(0))
    n_fused = sum(b._fused for b in model.blocks)
    if n_fused != RESNET_FUSED_BLOCKS[mode] \
            or model._fused_stem != (mode == "full"):
        failures.append(f"{label}: {n_fused} fused blocks, fused stem "
                        f"{model._fused_stem}")
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
        want = RESNET_LAUNCHES[mode]
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
    # the yardstick of its time.  Momentum(0.1, 0.9) on one repeated
    # batch overshoots from the third step on (the unfused step too:
    # 7.5 -> 5.4 -> 7.47 at the fifth), so the check is the first two
    # steps' fall (7.5 -> ~5.8 -> ~5.35 in every run); the last loss
    # against the first passed or failed on run-to-run noise
    if fused and not losses[2] < losses[1] < losses[0]:
        failures.append(f"{label} loss did not fall over the first two "
                        f"steps: {losses}")
    profile_train_step(step, state, (x, y), mean_ms, label=label)
    del model, state, step
    torch.cuda.empty_cache()
    return launches, mean_ms, peak


def resnet_phase(failures):
    """The full fused step (`resnet50_time_config(fused=True)` with the
    subset unset: K7 x13, K8 x3, K9), the `id` step (K7 on the 12
    identity blocks) and the unfused step, in one call on one card.
    Returns the launches of the two fused runs' timed steps, summed."""
    import collections

    launches = collections.Counter()
    step_ms, peak = {}, {}
    for mode in ("full", "id", "unfused"):
        made, step_ms[mode], peak[mode] = resnet_run(mode, failures)
        launches.update(made)
    for name in RESNET_LAUNCHES["full"]:
        if launches.get(name, 0) < 1:
            failures.append(f"{name} never launched on the ResNet path")
    log(f"resnet step ms (peak memory GiB): full (K7 x13, K8 x3, K9) "
        f"{step_ms['full']:.3f} ({peak['full'] / 2 ** 30:.3f}), id (K7 x12) "
        f"{step_ms['id']:.3f} ({peak['id'] / 2 ** 30:.3f}), unfused "
        f"{step_ms['unfused']:.3f} ({peak['unfused'] / 2 ** 30:.3f})")
    return dict(launches)


# ---------------------------------------------------------------------------
# phase 5: the data-parallel tier's DGC train path (K10)
# ---------------------------------------------------------------------------

RESNET50_TRAINABLE = 161          # trainable tensors of ResNet-50
K10_LARGEST = 2359296             # its largest: stage 4's 3x3 conv, 512^2 x 9


def dgc_run(mode, failures, steps=3, batch=128):
    """ResNet-50 (bf16, NHWC, ghost batch norm over 16, the per-conv path)
    through `fleet.make_train_step(model, Momentum(0.1, 0.9), loss,
    strategy)` on the one-rank NCCL group: DGC (sparsity 0.999, rampup 0)
    with K10 (`mode` "k10", FLAGS_use_pallas_dgc_topk on) or with
    torch.topk ("topk"), or the dense DataParallelTrainStep ("dense").
    One warm-up step and `steps` timed ones on one seeded batch.  Returns
    (launches over the timed steps, mean step ms, the step, its profile
    from `profile_train_step`)."""
    import torch

    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import Momentum

    label = f"dgc {mode}"
    model = resnet50(dtype="bfloat16", data_format="NHWC",
                     bn_stats_sample=16, fused=False, device="cuda",
                     generator=make_generator(0))
    strategy = fleet.DistributedStrategy()
    strategy.use_dgc = mode != "dense"
    strategy.dgc_sparsity = 0.999
    strategy.dgc_rampup_begin_step = 0
    opt = fleet.distributed_optimizer(Momentum(0.1, 0.9), strategy)
    step = fleet.make_train_step(
        model, opt, lambda m, a, b: F.cross_entropy(m(a), b).mean())
    flags.set_flags({"FLAGS_use_pallas_dgc_topk": mode == "k10"})
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((batch, 3, 224, 224)),
                        dtype=torch.bfloat16, device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, (batch,)), dtype=torch.int32,
                        device="cuda")
    want = {"topk_threshold": RESNET50_TRAINABLE} if mode == "k10" else {}
    try:
        t0 = time.perf_counter()
        losses = [float(step(x, y))]
        log(f"{label} warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} "
            f"ms, loss {losses[0]:.6f}")
        torch.cuda.reset_peak_memory_stats()
        backend.reset_launches()
        step_ms = []
        for i in range(steps):
            before = dict(backend.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(x, y)
            losses.append(float(loss))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            made = {k: c - before.get(k, 0)
                    for k, c in backend.LAUNCHES.items()}
            made = {k: c for k, c in made.items() if c}
            if made != want:
                failures.append(f"{label} step {i} launches {made} != "
                                f"{want}")
        launches = dict(backend.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        mean_ms = sum(step_ms) / steps
        log(f"{label}: {steps} steps, step ms "
            f"{[round(t, 3) for t in step_ms]}, mean {mean_ms:.3f} ms; "
            f"images/s {batch / (mean_ms / 1e3):.1f}; peak memory "
            f"{peak / 2 ** 30:.3f} GiB; launches ({steps} steps): "
            f"{launches}; losses {losses}")
        if not all(np.isfinite(losses)):
            failures.append(f"{label} losses not finite: {losses}")
        prof = profile_train_step(lambda _s, *b: step(*b), None, (x, y),
                                  mean_ms, label=label)
    finally:
        flags.set_flags({"FLAGS_use_pallas_dgc_topk": False})
    del model, x, y
    return launches, mean_ms, step, prof


def k10_synthetic(rnd):
    """K10's synthetic inputs: (name, tensor, k, edges); edges None for
    the DGC path's (`_edges` of the tensor's max), else explicit edges:
    unsorted, with duplicates, NaN, +-inf and +-0, all equal, all NaN."""
    import torch

    from paddle_tpu_torch.kernels import topk_threshold as K

    out = []
    gen = torch.Generator().manual_seed(12)
    frac = torch.from_numpy(K.EDGE_FRACTIONS)
    for dt in (torch.float32, torch.bfloat16):
        d = dname(dt)
        big = rnd((K10_LARGEST,), dt)
        out += [(f"n=1 {d}", rnd((1,), dt), 1, None),
                (f"n=65537 {d}", rnd((65537,), dt), 66, None),
                (f"all zeros {d}", torch.zeros(4099, dtype=dt,
                                               device="cuda"), 4, None),
                (f"negative zeros {d}", -torch.zeros(4099, dtype=dt,
                                                     device="cuda"), 4, None),
                (f"largest [{K10_LARGEST}] {d}", big, 2359, None)]
        # values drawn from the edges of their own histogram (max 1),
        # both signs
        idx = torch.randint(0, K.NUM_EDGES, (70001,), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(1))
        on = frac.to("cuda")[idx]
        on[0] = 1.0
        sign = torch.where(idx % 2 == 0, 1.0, -1.0).to(dt)
        # f32: exactly on the edges; bf16: rounded next to them
        out.append((f"on the edges {d}", (on.to(dt) * sign), 70, None))
        # explicit edges over values with NaN, +-inf and -0 among them
        v = rnd((70001,), dt)
        v[::977] = float("nan")
        v[5], v[6], v[7] = float("inf"), -float("inf"), -0.0
        shuffled = frac[torch.randperm(K.NUM_EDGES, generator=gen)] * 3.0
        odd = shuffled.clone()
        odd[:8] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                                -0.0, 0.0, 1.5, 1.5, float("nan")])
        dup = torch.sort(torch.tensor([0.0, 0.5, 1.0, 2.0])[torch.randint(
            0, 4, (K.NUM_EDGES,), generator=gen)]).values
        for what, e in (("unsorted", shuffled), ("NaN, +-inf, +-0, dup", odd),
                        ("sorted duplicates", dup),
                        ("all equal", torch.full((K.NUM_EDGES,), 0.75)),
                        ("all NaN", torch.full((K.NUM_EDGES,),
                                               float("nan")))):
            out.append((f"{what} edges {d}", v, 0, e.to("cuda")))
        out.append((f"unsorted edges, largest {d}", big, 0,
                    shuffled.to("cuda")))
    return out


def k10_check(name, v, k, failures, edges=None):
    """K10 against the plain version on one tensor: the counts exactly
    equal; with the DGC path's edges (`edges` None) its threshold keeps at
    least k elements and at most those within one bin of the exact k-th
    |v|.  Returns the largest count difference (0 when right)."""
    import torch

    from paddle_tpu_torch.kernels import topk_threshold as K

    flat = v.reshape(-1)
    vmax = torch.linalg.vector_norm(flat, float("inf")).float()
    dgc = edges is None
    if dgc:
        edges = K._edges(vmax)
    got = K.count_ge_histogram(flat, edges)
    want = K.count_ge_histogram_ref(flat, edges)
    err = (got - want).abs().max().item()
    if err != 0:
        failures.append(f"K10 {name}: counts differ by up to {err}")
    if not dgc:
        return err
    a = flat.float().abs()
    t = K.topk_threshold(flat, k)
    kept = int((a >= t).sum())
    kth = torch.topk(a, k).values[-1]
    near = int((a >= kth - vmax / (K.NUM_EDGES - 1)).sum())
    if not k <= kept <= near:
        failures.append(f"K10 {name}: threshold keeps {kept}, outside "
                        f"[{k}, {near}]")
    return err


def k10_times(v, state_v):
    """Device ms of K10 at ResNet-50's largest tensor (bf16), its plain
    version and torch.topk(|v|, k) (the flag-off path's call), and K10
    over the 161 v tensors of a step (one CUDA graph of the launches);
    bounds: one read of v (each element once, bf16) plus the edges and
    counts, and 8 compares per element (a binary search over the sorted
    edges), float32 rate."""
    import torch

    from paddle_tpu_torch.kernels import topk_threshold as K

    vmax = torch.linalg.vector_norm(v, float("inf")).float()
    edges = K._edges(vmax)
    tensors = list(state_v.values())
    edge_list = [K._edges(torch.linalg.vector_norm(t, float("inf"))
                          .float()) for t in tensors]
    out = {"ms": time_ms(lambda: K.count_ge_histogram(v, edges)),
           "plain_ms": time_ms(lambda: K.count_ge_histogram_ref(v, edges),
                               graph=False),
           "library_ms": time_ms(
               lambda: torch.topk(v.abs().reshape(-1), 2359), graph=False),
           "step_ms": time_ms(lambda: [K.count_ge_histogram(t, e) for t, e
                                       in zip(tensors, edge_list)], 3)}
    extra = 2 * K.NUM_EDGES * 4
    out["bound_ms"], out["bound_by"] = bound(
        v.numel() * v.element_size() + extra, 8.0 * v.numel(), "float32")
    n_all = sum(t.numel() for t in tensors)
    out["step_bytes"] = n_all * 2 + len(tensors) * extra
    out["step_bound_ms"], _ = bound(out["step_bytes"], 8.0 * n_all,
                                    "float32")
    return out


def _k10_pick(v, k):
    """K10's pick for v: (threshold, edge index), from the plain counts
    on the CPU, which equal K10's exactly."""
    import torch

    from paddle_tpu_torch.kernels import topk_threshold as K

    flat = v.reshape(-1)
    edges = K._edges(torch.linalg.vector_norm(flat, float("inf")).float())
    counts = K.count_ge_histogram_ref(flat, edges)
    idx = int(torch.nonzero(counts >= k).max())
    return float(edges[idx]), idx


def _dgc_run(dev, plain, x, y, start, steps, lr, sparsity, failures):
    """`steps` f32 DGC steps of the shallow ResNet-50 on `dev` from the
    weights `start` (None: the seed's, returned), with K10 or (`plain`)
    its plain version; records each step's v and mask per tensor."""
    import torch

    import torch.distributed as dist

    from paddle_tpu_torch.distributed import strategies
    from paddle_tpu_torch.distributed.mesh import Mesh
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.kernels import topk_threshold as K
    from paddle_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from paddle_tpu_torch.nn import (
        functional as F, load_param_dict, make_generator,
    )

    model = ResNet(BottleneckBlock, [1, 1, 1, 1], data_format="NHWC",
                   device=dev, generator=make_generator(4))
    if start is None:
        start = {n: p.detach().cpu().clone()
                 for n, p in model.named_parameters()}
    else:
        load_param_dict(model, start)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    masks = []
    real_mask, real_count = strategies.dgc_topk_mask, K.count_ge_histogram

    def recording(v, s):
        m = real_mask(v, s)
        # copies: the step clears the sent slots of v in place
        masks[-1][names[len(masks[-1])]] = (
            v.detach().to("cpu", torch.float32, copy=True),
            m.detach().to("cpu", torch.float32, copy=True))
        return m

    # the card runs on the NCCL group of the phase, the CPU on a gloo
    # group over the same one rank
    mesh = (None if dev == "cuda" else Mesh(
        dist.new_group(backend="gloo"), 1, 0, torch.device("cpu")))
    loss_fn = lambda m, a, b: F.cross_entropy(m(a), b).mean()
    step = strategies.DGCTrainStep(model, loss_fn, mesh, lr=lr,
                                   momentum=0.9, sparsity=sparsity)
    strategies.dgc_topk_mask = recording
    if plain:
        K.count_ge_histogram = (
            lambda a, e, block=None: K.count_ge_histogram_ref(a, e))
    backend.reset_launches()
    losses = []
    try:
        for _ in range(steps):
            masks.append({})
            losses.append(float(step(torch.as_tensor(x),
                                     torch.as_tensor(y))))
    finally:
        strategies.dgc_topk_mask, K.count_ge_histogram = (real_mask,
                                                          real_count)
    want = {} if plain or dev == "cpu" else {
        "topk_threshold": steps * len(names)}
    if dict(backend.LAUNCHES) != want:
        failures.append(f"dgc check ({dev}, plain {plain}) launches "
                        f"{dict(backend.LAUNCHES)} != {want}")
    return start, dict(
        losses=losses, masks=masks,
        params={n: p.detach().cpu() for n, p in model.named_parameters()},
        u={n: t.cpu() for n, t in step._state[0].items()},
        v={n: t.cpu() for n, t in step._state[1].items()})


def _hold_dgc_masks(card, cpu, sparsity, failures, rtol=1e-4):
    """The card's DGC masks against the CPU's, step by step.  Each
    side's mask must be exactly what K10's pick on its own v gives.
    Where the two masks differ, each element must be explained:

    - carried: its mask differed at an earlier step, so its u and v were
      cleared on one side only and it has its own v on each side since;
    - else its |v| must lie between the two sides' thresholds on both
      sides, give or take the tensor's own card-vs-CPU noise: the
      largest |v card - v CPU| over the elements whose masks agree.
      The thresholds differ as the two v do: their max (which scales
      the edges) and their counts move with the noise.
    - At step 0 (v = the grads) at most one element per tensor may
      differ, within `rtol` of the card's threshold (the repo's near-tie
      rule).  Later the noise grows (u and v add up grads that batch
      norm nearly cancels), and so does the number of elements it
      carries across a threshold.

    Anything else fails.  Returns (the mask elements that differed per
    step, name -> every element that ever differed)."""
    import torch

    flipped, differ = {}, []
    for t, (mc, mh) in enumerate(zip(card["masks"], cpu["masks"])):
        differ.append(0)
        for n, (vc, m_c) in mc.items():
            vh, m_h = mh[n]
            k = max(1, int(round(vc.numel() * (1.0 - sparsity))))
            (tc, ic), (th, ih) = _k10_pick(vc, k), _k10_pick(vh, k)
            vc, vh = vc.reshape(-1), vh.reshape(-1)
            ac, ah = vc.abs(), vh.abs()
            m_c, m_h = m_c.reshape(-1) > 0, m_h.reshape(-1) > 0
            for side, m, a, thr in (("card", m_c, ac, tc),
                                    ("CPU", m_h, ah, th)):
                if not torch.equal(m, a >= thr):
                    failures.append(f"dgc check step {t} {n}: the {side}'s "
                                    "mask is not |v| >= its threshold")
            diff = torch.nonzero(m_c != m_h).reshape(-1)
            if not diff.numel():
                continue
            differ[-1] += diff.numel()
            before = flipped.setdefault(n, set())
            rest = torch.tensor([i for i in diff.tolist()
                                 if i not in before], dtype=torch.long)
            agree = torch.ones(vc.numel(), dtype=torch.bool)
            agree[diff] = False
            agree[list(before)] = False
            noise = float((vc - vh)[agree].abs().max()) if agree.any() \
                else 0.0
            lo, hi = min(tc, th) - noise, max(tc, th) + noise
            out = max([0.0] + [float(torch.maximum(lo - a, a - hi).max())
                               for a in (ac[rest], ah[rest]) if a.numel()])
            ok = out <= 0.0
            if t == 0:
                ok = ok and rest.numel() <= 1 and bool(torch.allclose(
                    ac[rest], torch.full_like(ac[rest], tc), rtol=rtol,
                    atol=0.0))
            scale = max(tc, th, 1e-30)
            log(f"dgc check step {t} {n} [{vc.numel()}, k {k}]: masks "
                f"differ in {diff.numel()} ({diff.numel() - rest.numel()} "
                f"carried); edges card {ic} ({tc:.6e}) CPU {ih} "
                f"({th:.6e}); noise {noise / scale:.3e} of the threshold, "
                f"the farthest element {out / scale:.3e} "
                f"outside the band: {'explained' if ok else 'UNEXPLAINED'}")
            if not ok:
                failures.append(
                    f"dgc check step {t} {n}: {rest.numel()} mask elements "
                    f"differ beyond carry-over and the noise (edges {ic} "
                    f"vs {ih}, {out / scale:.3e} outside the band)")
            before.update(diff.tolist())
    return differ, flipped


def dgc_check(failures, steps=3, lr=1e-5, sparsity=0.99):
    """f32 DGC steps, card against CPU: a shallow ResNet-50 (full widths,
    depths [1, 1, 1, 1], NHWC, the per-conv path), batch 8 x 3 x 64 x
    64, `steps` DGC steps (sparsity 0.99, Momentum(lr, 0.9)) with K10 on
    the card and its plain version on the CPU, from the same weights.
    Held as `resnet_check` holds the ResNet: the first loss 1e-4
    relative, the others 1e-3; per tensor ||card - cpu|| <= 5e-2 max(
    ||cpu||, 1e-2 of the largest) for u, v and the params' update.  The
    masks are held at every step by `_hold_dgc_masks`: this net's v
    differ between the card and the CPU in f32 noise that grows with the
    steps (u and v add up conv-weight grads that batch norm nearly
    cancels, see `resnet_check`), so an element near a threshold can
    fall the other way; the elements whose masks differed are left out
    of the norms.  A witness that the differences come from v and not
    from K10, on the card with cuDNN deterministic: the same steps with
    K10's plain version in its place must give exactly K10's masks
    wherever their v are bitwise equal, and its
    differences from the CPU are printed beside K10's."""
    import torch

    from paddle_tpu_torch import flags

    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 3, 64, 64)).astype(np.float32)
    y = rng.integers(0, 1000, (8,)).astype(np.int32)
    runs, start = {}, None
    flags.set_flags({"FLAGS_use_pallas_dgc_topk": True})
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, dev, plain in (("card", "cuda", False),
                                 ("card plain", "cuda", True),
                                 ("cpu", "cpu", False)):
            start, runs[name] = _dgc_run(dev, plain, x, y, start, steps, lr,
                                         sparsity, failures)
    finally:
        flags.set_flags({"FLAGS_use_pallas_dgc_topk": False})
        torch.backends.cudnn.deterministic = deterministic
    card, witness, cpu = runs["card"], runs["card plain"], runs["cpu"]
    same_v, same_mask = 0, 0
    for t, (mk, mp) in enumerate(zip(card["masks"], witness["masks"])):
        for n, (v, m) in mk.items():
            if torch.equal(v, mp[n][0]):
                same_v += 1
                if torch.equal(m, mp[n][1]):
                    same_mask += 1
                else:
                    failures.append(f"dgc check step {t} {n}: K10 and its "
                                    "plain version give other masks on "
                                    "the same v")
    differ, flipped = _hold_dgc_masks(card, cpu, sparsity, failures)
    plain_differ = [sum(int((m != mh[n][1]).sum()) for n, (_, m) in
                        mp.items())
                    for mp, mh in zip(witness["masks"], cpu["masks"])]
    log(f"dgc check witness (K10's plain version on the card): bitwise "
        f"equal v in {same_v} of {steps * len(card['masks'][0])} "
        f"(step, tensor) pairs, equal masks in {same_mask} of them")

    def rel(a, b, n, floor):
        keep = torch.ones(b.numel(), dtype=torch.bool)
        keep[list(flipped.get(n, ()))] = False
        return _rel(a.reshape(-1)[keep], b.reshape(-1)[keep], floor)

    errs = {}
    for what in ("u", "v"):
        top = max(t.norm().item() for t in cpu[what].values())
        errs[what] = max((rel(card[what][n], t, n, 1e-2 * top), n)
                         for n, t in cpu[what].items())
    update = {n: p - start[n] for n, p in cpu["params"].items()}
    top = max(u.norm().item() for u in update.values())
    errs["update"] = max((rel(card["params"][n] - start[n], u, n, 1e-2 * top),
                          n) for n, u in update.items())
    first = abs(card["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(card["losses"], cpu["losses"]))
    log(f"f32 DGC check (ResNet-50 widths, depths [1, 1, 1, 1], NHWC, "
        f"per-conv, batch 8 x 64 x 64, {steps} DGC steps, sparsity "
        f"{sparsity}, Momentum({lr}, 0.9), K10 on the card, plain on the "
        f"CPU): losses card {card['losses']} CPU {cpu['losses']} (rel err "
        f"first {first:.3e}, max {worst:.3e}); worst relative norm error "
        f"u {errs['u'][0]:.3e} ({errs['u'][1]}), v {errs['v'][0]:.3e} "
        f"({errs['v'][1]}), update {errs['update'][0]:.3e} "
        f"({errs['update'][1]}); mask elements that differ from the CPU's, "
        f"per step: K10 {differ}, its plain version on the card "
        f"{plain_differ} (left out of the norms)")
    if not (first <= 1e-4 and worst <= 1e-3):
        failures.append(f"dgc check losses differ: first {first:.3e}, max "
                        f"{worst:.3e}")
    for what, (err, n) in errs.items():
        if not err <= 5e-2:
            failures.append(f"dgc check {what} differs: {err:.3e} ({n})")
    del runs, card, cpu, witness
    torch.cuda.empty_cache()


def dgc_phase(failures):
    """The DGC ResNet-50 step on one H100 through fleet.make_train_step:
    with K10, with torch.topk and the dense step (one NCCL group of one
    rank, destroyed at the end); then K10 against its plain version on
    the DGC state's 322 u and v tensors and on synthetic inputs, its
    times, and the f32 card-vs-CPU DGC check.  Returns the launches of
    the K10 run's timed steps and the K10 row."""
    import torch

    from paddle_tpu_torch.distributed import env

    env.init_parallel_env()
    try:
        step_ms = {}
        launches, step_ms["k10"], step, _ = dgc_run("k10", failures)
        state = {"u": step._state[0], "v": step._state[1]}
        del step
        torch.cuda.empty_cache()
        for mode in ("topk", "dense"):
            _, step_ms[mode], _, _ = dgc_run(mode, failures)
            torch.cuda.empty_cache()
        log(f"dgc step ms: DGC with K10 {step_ms['k10']:.3f}, DGC with "
            f"torch.topk {step_ms['topk']:.3f}, dense DP "
            f"{step_ms['dense']:.3f}")
        if launches.get("topk_threshold", 0) < 1:
            failures.append("topk_threshold never launched on the DGC path")

        errs = []
        for what, tensors in state.items():
            for n, t in tensors.items():
                k = max(1, int(round(t.numel() * 0.001)))
                errs.append(k10_check(f"{what} {n}", t, k, failures))
        log(f"K10 on the DGC state's {sum(map(len, state.values()))} u and "
            f"v tensors (bf16): counts equal the plain version's exactly: "
            f"{max(errs) == 0}")
        gen = torch.Generator(device="cuda").manual_seed(10)
        rnd = lambda shape, dt: torch.randn(shape, generator=gen,
                                            device="cuda").to(dt)
        for name, v, k, edges in k10_synthetic(rnd):
            errs.append(k10_check(name, v, k, failures, edges))
            log(f"K10 {name}: counts equal: {errs[-1] == 0}")
        largest = max(state["v"].values(), key=lambda t: t.numel())
        timed = k10_times(largest, state["v"])
        log(f"K10 [{K10_LARGEST}] bf16 (DGC v of stage 4's 3x3 conv): "
            f"kernel_ms {timed['ms']:.4f} plain_ms {timed['plain_ms']:.4f} "
            f"library_ms (torch.topk(|v|, 2359)) {timed['library_ms']:.4f} "
            f"bound_ms {timed['bound_ms']:.5f} ({timed['bound_by']}); the "
            f"161 v tensors of a step: {timed['step_ms']:.4f} ms, bound "
            f"{timed['step_bound_ms']:.5f} ms "
            f"({timed['step_bytes'] / 1e6:.1f} MB)")
        row = dict(name="K10 topk_threshold", route="cuda",
                   source="paddle_tpu_torch/csrc/topk_threshold.cu",
                   replaces="paddle_tpu/kernels/topk_threshold.py:35",
                   max_abs_err=max(errs), ms=timed["ms"],
                   plain_ms=timed["plain_ms"], bound_ms=timed["bound_ms"],
                   bound_by=timed["bound_by"],
                   library_ms=timed["library_ms"],
                   shape=f"v [{K10_LARGEST}] bf16 (ResNet-50 DGC, stage 4 "
                         "3x3 conv); library: torch.topk(|v|, 2359)")
        del state, largest
        torch.cuda.empty_cache()
        dgc_check(failures)
    finally:
        env.destroy_parallel_env()
    return {"launches": launches, "row": row}


# ---------------------------------------------------------------------------
# phase 6: the serving path
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
    params, cache, logits = decode_prefill(model, prompts)
    if tuple(logits.shape) != (4, cfg.vocab_size) \
            or not bool(torch.isfinite(logits.float()).all()):
        failures.append("prefill logits not finite or misshapen")
    profile_decode(params, cache, logits)
    del model, eng
    torch.cuda.empty_cache()
    return launches


def profile_decode(params, cache, logits, steps=16):
    """Where a generate() decode step's time goes: host time per step
    (timed without the profiler), device time per step, K6's device time
    and launches per step and the busiest kernels (torch.profiler,
    kernel events only).  Returns {host, device, k6} ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import generate as G

    token = torch.argmax(logits, dim=-1).to(torch.int32)

    def run(first, n=steps):
        tok = token
        for i in range(n):
            tok = torch.argmax(G.decode_step(params, tok, cache, first + i),
                               dim=-1).to(torch.int32)
        torch.cuda.synchronize()

    with torch.inference_mode():
        run(256, 4)                      # warm-up
        t0 = time.perf_counter()
        run(260)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(260 + steps)
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(r[0] for r in rows) / 1e3 / steps
    k6 = [r for r in rows if "flash_decode_kernel" in r[2]]
    k6_ms = sum(r[0] for r in k6) / 1e3 / steps
    log(f"decode step profile (batch 4, cache 384, {steps} steps): host "
        f"{host_ms:.3f} ms/step, device {device_ms:.3f} ms/step, device "
        f"busy {device_ms / host_ms:.1%}; K6 {k6_ms:.4f} ms/step "
        f"({sum(r[1] for r in k6) / steps:.1f} launches/step, "
        f"{k6_ms / device_ms:.1%} of the device time)")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        log(f"  {us / 1e3 / steps:8.4f} ms/step  {count / steps:5.1f}/step  "
            f"{key[:90]}")
    return {"host": host_ms, "device": device_ms, "k6": k6_ms}


# ---------------------------------------------------------------------------
# phase 7: float32 checks
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
    from paddle_tpu_torch.optimizer.functional import AdamW

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
    cpu_run = dict(cpu, start=start)
    del runs, card, cpu
    torch.cuda.empty_cache()
    return cpu_run


def amp_train_check(failures, f32_cpu, steps=3, lr=1e-4):
    """`make_train_step(amp=True)` on the train check's GPT (vocab 32768,
    hidden 768, 2 layers, f32 master params, the same weights, batch and
    AdamW(lr)): `steps` steps on the card (bf16 products, K1-K5) against
    the CPU (plain versions), from the train check's start weights
    (`f32_cpu`, whose f32 losses are logged beside).  Losses within 3e-2
    relative; each param's update within STATIC_UPDATE_RTOL of the
    CPU's in norm, but the k_proj biases (their gradient is 0 in exact
    arithmetic)."""
    import torch

    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import load_param_dict, make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=2,
                    num_heads=12, max_seq_len=512)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 256), dtype=np.int32)
    labels = np.roll(ids, -1, axis=1)
    start = f32_cpu["start"]
    runs = {}
    for dev in ("cuda", "cpu"):
        model = GPT(cfg, device=dev, generator=make_generator(2))
        load_param_dict(model, start)
        x = torch.as_tensor(ids, device=dev)
        y = torch.as_tensor(labels, device=dev)
        opt = AdamW(lr)
        state = init_train_state(model, opt)
        step = make_train_step(model, opt, amp=True)
        losses = []
        for _ in range(steps):
            state, loss = step(state, x, y)
            losses.append(float(loss))
        runs[dev] = dict(losses=losses, params={
            n: p.detach().cpu().numpy() for n, p in state.params.items()})
        del model, state
    card, cpu = runs["cuda"], runs["cpu"]
    start_np = {n: t.numpy() for n, t in start.items()}
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
    worst, worst_name = update_error(
        start_np, card["params"], cpu["params"],
        [n for n in cpu["params"] if "k_proj.bias" in n])
    log(f"amp train check (make_train_step(amp=True), vocab 32768, hidden "
        f"768, 2 layers, batch 2 x 256, {steps} AdamW({lr}) steps), card vs "
        f"CPU: losses card {card['losses']} CPU {cpu['losses']} (f32 CPU "
        f"{f32_cpu['losses']}), max rel err {loss_err:.3e}; worst update "
        f"||d_card - d_cpu|| / (0.1 ||d_cpu||) {worst:.3e} ({worst_name})")
    if not loss_err <= 3e-2:
        failures.append(f"amp train check losses differ: {loss_err:.3e} > "
                        f"3e-2")
    if not worst <= 1.0:
        failures.append(f"amp train check: update of {worst_name} off by "
                        f"{worst:.3e} of its bound")
    torch.cuda.empty_cache()


def amp_overflow_check(failures):
    """One `amp.make_amp_train_step` step with FLAGS_amp_dtype=float16
    and init_scale 2**100 on the card: an MLP (768 -> 3072 gelu -> 10, f32
    master params) whose cross-entropy runs under `auto_cast` (float16
    products), batch 256.  The loss scaled by 2**100 overflows float16 in
    the backward, so the step must report grads_finite False, count one
    bad step (the scale unchanged: decr_every 2) and commit nothing:
    params and optimizer state bitwise as they were.  (An MLP: the flash
    kernels have no float16 version.)"""
    import torch

    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW

    sub = dict(device="cuda", generator=make_generator(3))
    model = nn.Sequential(nn.Linear(768, 3072, act="gelu", **sub),
                          nn.Linear(3072, 10, **sub))
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((256, 768), dtype=np.float32),
                        device="cuda")
    y = torch.as_tensor(rng.integers(0, 10, (256, 1)), device="cuda")

    def loss_fn(m, xb, yb):
        with amp.auto_cast():
            return F.cross_entropy(m(xb), yb)

    with tier_flags(amp_dtype="float16"):
        step, make_state = amp.make_amp_train_step(
            model, AdamW(1e-4), loss_fn, init_scale=2.0 ** 100)
        ts, sc = make_state()
        before = {n: p.clone() for n, p in ts.params.items()}
        moments = {n: {k: v.clone() for k, v in st.items()}
                   for n, st in ts.opt_state.items() if n != "__step__"}
        (ts, sc), loss, finite = step((ts, sc), x, y)
    kept = all(torch.equal(ts.params[n], p) for n, p in before.items()) \
        and all(torch.equal(ts.opt_state[n][k], v)
                for n, st in moments.items() for k, v in st.items())
    log(f"amp overflow check (float16, init_scale 2**100): loss "
        f"{float(loss):.6f}, grads_finite {bool(finite)}, scale "
        f"{float(sc['scale']):.3e}, bad_steps {int(sc['bad_steps'])}, "
        f"good_steps {int(sc['good_steps'])}, params and moments kept "
        f"{kept}, optimizer step {int(ts.opt_state['__step__'])}")
    if bool(finite) or int(sc["bad_steps"]) != 1 or not kept \
            or float(sc["scale"]) != 2.0 ** 100 \
            or int(ts.opt_state["__step__"]) != 0:
        failures.append("amp overflow check: the 2**100-scaled float16 "
                        "step did not overflow and commit nothing")
    del model, ts, before, moments
    torch.cuda.empty_cache()


def _rel(a, b, floor=0.0):
    """||a - b|| / max(||b||, floor)."""
    return (a - b).norm().item() / max(b.norm().item(), floor, 1e-30)


def resnet_check(failures, steps=2, lr=1e-5):
    """A shallow NHWC ResNet-50 (full widths, depths [2, 2, 2, 2], the
    full fused program: the stem tail through K9, the stage-1 projection
    block and one identity block per stage through K7, the three
    transitions through K8),
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
    from paddle_tpu_torch.optimizer.functional import Momentum

    os.environ["PADDLE_TPU_FUSED_SUBSET"] = ""
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
        want = {"fused_bottleneck_fwd": 5 * steps,
                "fused_bottleneck_bwd": 5 * steps,
                "fused_bottleneck_down_fwd": 3 * steps,
                "fused_bottleneck_down_bwd": 3 * steps,
                "fused_stem_tail_fwd": steps, "fused_stem_tail_bwd": steps}
        if dev == "cuda" and dict(backend.LAUNCHES) != want:
            failures.append(f"resnet check launches {dict(backend.LAUNCHES)}"
                            f" != {want}")
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
        f"full fused program: K9, 5 K7 and 3 K8 blocks, batch 8 x 128 x "
        f"128, ghost batch 4, {steps} "
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


# ---------------------------------------------------------------------------
# phase 7: the static-graph path (Program -> Executor -> static zoo)
# ---------------------------------------------------------------------------

STATIC_GPT = dict(t=512, d=768, heads=12, vocab=32768)   # bench.py:169-174
STATIC_LAUNCHES = {"layer_norm_fwd": 2, "layer_norm_bwd": 2}   # per step
# per step of the same GPT with FLAGS_amp and FLAGS_graph_opt_fuse on: its
# fused_attention on K1 forward and K2/K3 backward (non-causal [8, 12,
# 512, 64] bf16), its two fused_layer_norm ops on K4/K5
STATIC_AMP_LAUNCHES = {"flash_attention_fwd": 1, "flash_attention_bwd_dq": 1,
                       "flash_attention_bwd_dkv": 1, "layer_norm_fwd": 2,
                       "layer_norm_bwd": 2}
# the fused ops the substitute of the static GPT carries (the counts of
# the reference's tests/test_fuse.py for its gpt family)
STATIC_AMP_FUSED = {"fused_attention": 1, "fused_bias_act": 1,
                    "fused_layer_norm": 2}
# ... and under FLAGS_amp_dtype=float16: K1-K3 in their float16
# form; the two LayerNorms still see f32 (the residual stream stays f32)
STATIC_AMP_F16_LAUNCHES = dict(
    STATIC_AMP_LAUNCHES, **{k + ":float16": 1 for k in (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")})
STATIC_AMP_F16_STEPS = 3
# bench.py:697-704 (`bench_wide_deep`): 26 sparse fields over 1e6 ids, 13
# dense features, batch 8192
STATIC_WIDE_DEEP = dict(fields=26, vocab=1_000_000, dense=13)
STATIC_WIDE_DEEP_BATCH = 8192
# the card-vs-CPU families: name -> (builder kwargs, batch, lr, an update
# about lr * sign(g) early on: Adam, Adagrad)
STATIC_FAMILIES = (
    ("mlp", {}, 8, 0.01, False),
    ("lenet", {}, 8, 1e-3, True),
    ("resnet", {}, 8, 0.01, False),
    ("bert", {}, 8, 1e-3, True),
    ("gpt", {}, 8, 1e-3, True),
    ("seq2seq", {}, 8, 1e-3, True),
    ("wide_deep", {}, 8, 0.05, True),
    ("word2vec", {}, 8, 0.05, False),
    ("clip_decay", {}, 8, 0.05, False),
    ("clip_value", {}, 8, 0.1, False),
    ("gpt", dict(t=128, d=768, heads=12, vocab=1024), 2, 1e-3, True),
    # the fusion tier alone (FLAGS_graph_opt_fuse on, AMP off): K1-K3's
    # f32 path inside the Executor
    ("gpt", dict(t=128, d=768, heads=12, vocab=1024), 2, 1e-3, True,
     "fuse"),
)
# the AMP + fused static GPT held card against CPU (`static_amp_check`)
STATIC_AMP_CHECK = (dict(t=128, d=768, heads=12, vocab=1024), 2, 1e-3)
STATIC_AMP_LOSS_RTOL = 3e-2


STATIC_UPDATE_RTOL = 0.1
# the attention's key bias in the bert and gpt builders, and its moments:
# softmax(q.(k + b)) does not depend on b
STATIC_ZERO_GRAD = ("fc_1.b_0", "fc_1.b_0_adam_0_moment1",
                    "fc_1.b_0_adam_0_moment2")


ADAM_NEAR = 100.0
# at most this share of the Adam parameters' elements with a gradient
# may be near zero: a wrong gradient, or a trajectory gone astray, makes
# every element "near" (its difference as large as the gradient itself)
ADAM_NEAR_SHARE = 0.25


def near_zero_grad(g_card, g_cpu):
    """Where the CPU's gradient lies within ADAM_NEAR times the two
    devices' difference of 0 (and the two differ): Adam's update there
    may take either sign."""
    g_card = np.asarray(g_card, np.float64)
    g_cpu = np.asarray(g_cpu, np.float64)
    diff = np.abs(g_card - g_cpu)
    return (diff > 0) & (np.abs(g_cpu) <= ADAM_NEAR * diff)


def adam_update_check(card, cpu, start, near, lr_steps):
    """An Adam or Adagrad parameter's update (its value less `start`) on
    the card against the CPU's, element by element, except where `near`
    (a near-zero gradient at some step):
    |d_card - d_cpu| <= STATIC_UPDATE_RTOL |d_cpu| + 0.01 lr_steps.
    Returns (worst ratio to that bound off `near`, elements over it,
    elements over it off `near`)."""
    d_cpu = cpu.astype(np.float64) - start
    d_card = card.astype(np.float64) - start
    ratio = np.abs(d_card - d_cpu) / (STATIC_UPDATE_RTOL * np.abs(d_cpu)
                                      + 0.01 * lr_steps)
    over = ratio > 1.0
    rest = ratio[~near]
    return (float(rest.max()) if rest.size else 0.0, int(over.sum()),
            int((over & ~near).sum()))


def after_backward(main, op_type):
    """The outputs of the ops of `op_type` after a Program's first
    backward section (the clip and decay ops, then the updates)."""
    pos = main.backward_sections[0].pos
    return [op.outputs["Out"][0] for op in main.global_block().ops[pos:]
            if op.type == op_type]


def clip_decay_model(clip_norm=0.05):
    """A small regression Program of the ported builders: an fc whose
    weight carries its own `ParamAttr(regularizer=L1Decay(1e-3))`, a
    second fc over two inputs (the `sum` op), `Momentum(0.05, 0.9)` with
    `regularization=L2Decay(1e-3)` and `GradientClipByGlobalNorm` at
    `clip_norm`, below the global norm these feeds give (the fetched
    factor shows it engage).  Fetches the loss and the clip factor."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.models.static_zoo import StaticModel

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 16])
        z = fluid.data("z", [None, 4])
        y = fluid.data("y", [None, 1])
        h = L.fc(x, 32, act="tanh", param_attr=fluid.ParamAttr(
            regularizer=fluid.regularizer.L1Decay(1e-3)))
        pred = L.fc([h, z], 1)
        loss = L.mean(L.square_error_cost(pred, y))
        fluid.optimizer.Momentum(
            0.05, 0.9, regularization=fluid.regularizer.L2Decay(1e-3),
            grad_clip=fluid.clip.GradientClipByGlobalNorm(
                clip_norm)).minimize(loss)
    factor = after_backward(main, "elementwise_div")[0]
    return StaticModel("clip_decay", main, startup,
                       [("x", (None, 16), "float32"),
                        ("z", (None, 4), "float32"),
                        ("y", (None, 1), "float32")],
                       [loss.name, factor], loss_name=loss.name)


def clip_value_model(clip_max=0.02):
    """A small classifier Program: an fc whose weight carries
    `ParamAttr(regularizer=L1Decay(1e-3))`, softmax cross entropy, `SGD`
    with `GradientClipByValue(clip_max)`.  Fetches the loss, that
    weight's raw gradient and its clipped one."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L
    from paddle_tpu_torch.models.static_zoo import StaticModel

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 12])
        label = fluid.data("label", [None, 1], dtype="int64")
        h = L.fc(x, 10, param_attr=fluid.ParamAttr(
            regularizer=fluid.regularizer.L1Decay(1e-3)))
        loss = L.mean(L.softmax_with_cross_entropy(h, label))
        fluid.optimizer.SGD(0.1, grad_clip=fluid.clip.GradientClipByValue(
            clip_max)).minimize(loss)
    clipped = after_backward(main, "clip")[0]
    return StaticModel("clip_value", main, startup,
                       [("x", (None, 12), "float32"),
                        ("label", (None, 1), "int64")],
                       [loss.name, "fc_0.w_0@GRAD", clipped],
                       loss_name=loss.name)


def clip_factor_engaged(fetched):
    """clip_decay: the global-norm clip's factor is below 1."""
    f = float(np.asarray(fetched[1]).reshape(-1)[0])
    return None if f < 1.0 else f"clip factor {f} not below 1"


def clip_value_engaged(fetched, clip_max=0.02):
    """clip_value: the clipped gradient is the raw one clipped to
    [-clip_max, clip_max], and differs from it."""
    raw, clipped = np.asarray(fetched[1]), np.asarray(fetched[2])
    if np.array_equal(raw, clipped):
        return "the value clip left the gradient as it was"
    if not np.array_equal(clipped, np.clip(raw, -clip_max, clip_max)):
        return "the value clip's output is not the clipped gradient"
    return None


# the card-vs-CPU programs built here: name -> (builder, the check that
# its clip engaged, on each step's fetches of both devices)
STATIC_PROGRAMS = {"clip_decay": (clip_decay_model, clip_factor_engaged),
                   "clip_value": (clip_value_model, clip_value_engaged)}


def static_feed(m, vocab, batch, seed):
    """A feed for the static GPT `m`: ids and targets uniform over
    [0, vocab), from a numpy generator seeded with `seed`."""
    rng = np.random.default_rng(seed)
    return {name: rng.integers(0, vocab, shape).astype(np.int64)
            for name, shape in m.smoke_feed_shapes(batch).items()}


@contextlib.contextmanager
def tier_flags(amp="off", fuse="off", **more):
    """FLAGS_amp and FLAGS_graph_opt_fuse (and any `more` flags) set for
    the block, restored after it."""
    import paddle_tpu_torch as fluid

    names = {"FLAGS_amp": amp, "FLAGS_graph_opt_fuse": fuse,
             **{"FLAGS_" + k: v for k, v in more.items()}}
    entry = fluid.get_flags(list(names))
    fluid.set_flags(names)
    try:
        yield
    finally:
        fluid.set_flags(entry)


def executor_op_profile(run, label):
    """Device ms of one step by Executor op type: each op's run wrapped in
    a `record_function` range (the forward ops and the updates; the
    backward runs in `torch.autograd.grad`, outside every range, and is
    the rest of the step).  Returns {op type: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.framework import executor as ex

    inner = ex.run_op

    def traced(op, env, generator):
        with record_function("op::" + op.type):
            return inner(op, env, generator)

    ex.run_op = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    finally:
        ex.run_op = inner
    # the ranges' host-side events: the device time of the kernels each
    # launched (the profiler also shows a range as a device-side
    # annotation spanning its kernels and the gaps between them; those,
    # keyed alike, are left out)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    by_type = {}
    for e in prof.events():
        if e.name.startswith("op::") and e.device_type == cpu:
            by_type[e.name[4:]] = (by_type.get(e.name[4:], 0.0)
                                   + e.device_time_total / 1e3)
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == cuda
                and not e.key.startswith("op::")) / 1e3
    top = sorted(by_type.items(), key=lambda kv: -kv[1])
    log(f"{label} device ms by Executor op type (one step): "
        + ", ".join(f"{t} {ms:.3f}" for t, ms in top[:12])
        + f"; in op ranges {sum(by_type.values()):.3f} of {total:.3f} ms, "
        f"the rest (the backward in torch.autograd.grad) "
        f"{total - sum(by_type.values()):.3f}")
    return by_type


def static_run(failures, steps=5, clip_norm=None, amp=False,
               amp_dtype="bfloat16"):
    """The static GPT at BERT-base widths (`static_zoo.build_gpt(512, 768,
    12, 32768)`, one transformer layer, float32) through `Executor.run`
    on the card: startup, one warm-up and `steps` timed Adam steps at
    batch 8 on `static_feed` (ids and targets uniform over the vocab;
    `smoke_feed` draws them from {0, 1}, traffic no user sends: its
    embedding backward scatters every row onto two).  Fails unless every
    loss is finite and each
    step launches exactly K4 and K5 twice (its two layer_norm ops) and no
    other kernel of the port.  With `clip_norm`, the GPT is built while
    `clip.set_gradient_clip(GradientClipByGlobalNorm(clip_norm))` is set
    (reset after), and each step also fetches the clip's global norm and
    factor (`static_clip_check`).  With `amp`, the same GPT and steps
    with FLAGS_amp and FLAGS_graph_opt_fuse "on" (restored after): the
    Executor runs the AMP-rewritten and fused substitute, which must
    carry STATIC_AMP_FUSED (its fused_attention computing in bfloat16),
    and each step must launch exactly STATIC_AMP_LAUNCHES; it also logs
    the substitute's casts and the step's device ms by Executor op type.
    With `amp_dtype` "float16" (FLAGS_amp_dtype) the fused_attention
    computes in float16 and each step must launch
    STATIC_AMP_F16_LAUNCHES: K1-K3's float16 forms.
    Returns {launches, host_ms, profile, ops, peak}."""
    if amp:
        with tier_flags(amp="on", fuse="on", amp_dtype=amp_dtype):
            return _static_run(failures, steps, clip_norm, amp, amp_dtype)
    return _static_run(failures, steps, clip_norm, amp, amp_dtype)


def _static_run(failures, steps, clip_norm, amp, amp_dtype="bfloat16"):
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import static_zoo

    label = ("static amp" if amp else "static") if clip_norm is None \
        else "static clipped"
    want_launches = STATIC_AMP_LAUNCHES if amp else STATIC_LAUNCHES
    if amp and amp_dtype == "float16":
        label, want_launches = "static amp float16", STATIC_AMP_F16_LAUNCHES
    if clip_norm is None:
        m = static_zoo.build_gpt(**STATIC_GPT)
    else:
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(clip_norm))
        try:
            m = static_zoo.build_gpt(**STATIC_GPT)
        finally:
            fluid.clip.set_gradient_clip(None)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    n_params = sum(p.numel() for n, p in scope.vars.items()
                   if n in {v.name for v in m.main.all_parameters()})
    feed = static_feed(m, STATIC_GPT["vocab"], batch=8, seed=0)
    program = m.main
    if amp:
        program = exe._resolve_train_optimized(m.main, list(m.fetches),
                                               True, True)
        types = [op.type for op in program.global_block().ops]
        fused = {t: types.count(t) for t in STATIC_AMP_FUSED}
        attn = [op for op in program.global_block().ops
                if op.type == "fused_attention"]
        casts = types.count("cast")
        log(f"{label}: substitute of {len(m.main.global_block().ops)} ops "
            f"-> {len(types)} ops: {casts} casts, fused {fused}, "
            f"fused_attention attrs {[a.attrs for a in attn]}")
        if fused != STATIC_AMP_FUSED or any(
                a.attrs.get("compute_dtype") != amp_dtype for a in attn):
            failures.append(f"{label}: substitute carries {fused}, "
                            f"fused_attention compute dtypes "
                            f"{[a.attrs.get('compute_dtype') for a in attn]}"
                            f" != {STATIC_AMP_FUSED}, {amp_dtype}")
    ops = len(exe._live_ops(program, m.fetches))
    log(f"{label}: gpt {STATIC_GPT} "
        f"{f'AMP {amp_dtype} + fusion' if amp else 'f32'}"
        f" through Executor.run, batch 8, "
        f"{n_params} parameters, {ops} ops per step "
        f"({sum(op.type == 'adam' for op in m.main.global_block().ops)} "
        f"Adam updates)")
    fetches = list(m.fetches)
    if clip_norm is not None:
        fetches += [after_backward(m.main, "sqrt")[0],
                    after_backward(m.main, "elementwise_div")[0]]

    def run():
        return exe.run(m.main, feed=feed, fetch_list=fetches, scope=scope)

    def scalars(out):
        return [float(np.asarray(v).reshape(-1)[0]) for v in out]

    t0 = time.perf_counter()
    outs = [scalars(run())]
    log(f"{label} warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"loss {outs[0][0]:.6f}")
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    step_ms = []
    for i in range(steps):
        before = dict(backend.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(scalars(run()))          # the fetch waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        made = {n: c - before.get(n, 0) for n, c in backend.LAUNCHES.items()}
        made = {n: c for n, c in made.items() if c}
        if made != want_launches:
            failures.append(f"{label} step {i} launches {made} != "
                            f"{want_launches}")
    launches = dict(backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    host_ms = sum(step_ms) / steps
    losses = [o[0] for o in outs]
    log(f"{label}: {steps} steps, step ms "
        f"{[round(t, 3) for t in step_ms]}, mean {host_ms:.3f} ms (host "
        f"clock, fetch included), min {min(step_ms):.3f} ms; peak memory "
        f"{peak / 2 ** 30:.3f} GiB")
    log(f"{label} losses {losses}")
    if clip_norm is not None:
        log(f"{label} global norm per step {[o[1] for o in outs]}, clip "
            f"factor per step {[o[2] for o in outs]}")
        for i, (_, norm, factor) in enumerate(outs):
            want = min(1.0, clip_norm / norm)
            if not abs(factor - want) <= 1e-6 * want:
                failures.append(f"{label} step {i}: clip factor {factor} "
                                f"!= min(1, {clip_norm} / {norm})")
    log(f"{label} path launches ({steps} steps): {launches}")
    if not all(np.isfinite(losses)):
        failures.append(f"{label} losses not finite: {losses}")
    if clip_norm is not None:
        static_clip_check(m, exe, scope, feed, fetches, clip_norm, failures)
    prof = profile_train_step(lambda _: run(), None, (), host_ms,
                              label=label, steps=2,
                              families=STATIC_FAMILIES_MORE)
    log(f"{label} step: {prof['kernels']:.1f} kernels and {ops} Executor "
        f"ops per step; {len(prof['ln_bwd']) / 2:.1f} LayerNorm backwards "
        f"per step, kernels each {sorted({len(k) for k in prof['ln_bwd']})}")
    if amp:
        prof["by_op"] = executor_op_profile(run, label)
    del scope, exe
    torch.cuda.empty_cache()
    return dict(launches=launches, host_ms=host_ms, profile=prof, ops=ops,
                peak=peak)


def static_clip_check(m, exe, scope, feed, fetches, clip_norm, failures):
    """One more step of the clipped static GPT (after the timed ones)
    that also fetches every parameter's `@GRAD` as a tensor on the card:
    the global norm recomputed from them in float64 must match the
    fetched one within 1e-5 relative (f32 sums of 57.5 M squares in
    another order), and the fetched factor min(1, clip_norm / norm)."""
    import torch

    params = [v.name for v in m.main.all_parameters()]
    out = exe.run(m.main, feed=feed,
                  fetch_list=fetches + [n + "@GRAD" for n in params],
                  scope=scope, return_numpy=False)
    norm, factor = (float(v.reshape(-1)[0]) for v in out[1:3])
    recomputed = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                               for g in out[3:]))
    want = min(1.0, clip_norm / recomputed)
    log(f"static clipped check: global norm {norm:.6f} fetched, "
        f"{recomputed:.6f} recomputed from {len(params)} @GRADs; factor "
        f"{factor:.8f}, min(1, {clip_norm} / norm) {want:.8f}; the clip "
        f"{'engaged' if want < 1 else 'did not engage'}")
    if not abs(norm - recomputed) <= 1e-5 * recomputed:
        failures.append(f"static clipped: global norm {norm} != "
                        f"{recomputed} recomputed from the @GRADs")
    if not abs(factor - want) <= 1e-5 * want:
        failures.append(f"static clipped: clip factor {factor} != "
                        f"min(1, {clip_norm} / {recomputed})")


def static_wide_deep_run(failures, steps=5):
    """The static Wide&Deep at the CTR widths of bench.py's
    `bench_wide_deep` (`static_zoo.build_wide_deep(fields=26,
    vocab=1_000_000, dense=13)`: an embedding table of 1e6 x 8, the zoo's
    own Adagrad(0.05)) through `Executor.run` on the card at batch 8192:
    ids uniform over [0, 1e6), dense features standard normal, labels
    from {0, 1}, all from a numpy seed; startup, one warm-up and `steps`
    timed steps.  Logs samples/s, host and device ms, kernels and
    Executor ops a step, peak memory; fails on a non-finite loss or a
    launch of any kernel of the port (the path has none).  Returns
    {host_ms, profile, ops, peak}."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import static_zoo

    batch = STATIC_WIDE_DEEP_BATCH
    m = static_zoo.build_wide_deep(**STATIC_WIDE_DEEP)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    n_params = sum(p.numel() for n, p in scope.vars.items()
                   if n in {v.name for v in m.main.all_parameters()})
    rng = np.random.default_rng(0)
    feed = {"ids": rng.integers(0, STATIC_WIDE_DEEP["vocab"],
                                (batch, STATIC_WIDE_DEEP["fields"])),
            "dense": rng.standard_normal(
                (batch, STATIC_WIDE_DEEP["dense"])).astype(np.float32),
            "label": rng.integers(0, 2, (batch, 1)).astype(np.float32)}
    ops = len(exe._live_ops(m.main, m.fetches))
    log(f"static wide_deep: {STATIC_WIDE_DEEP} f32 through Executor.run, "
        f"batch {batch}, {n_params} parameters, {ops} ops per step "
        f"({sum(op.type == 'adagrad' for op in m.main.global_block().ops)}"
        f" Adagrad updates)")

    def run():
        return exe.run(m.main, feed=feed, fetch_list=m.fetches,
                       scope=scope)[0]

    t0 = time.perf_counter()
    losses = [float(run())]
    log(f"static wide_deep warm-up step: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, loss {losses[0]:.6f}")
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(run()))          # the fetch waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    made = {n: c for n, c in backend.LAUNCHES.items() if c}
    if made:
        failures.append(f"static wide_deep launched kernels of the port: "
                        f"{made}")
    peak = torch.cuda.max_memory_allocated()
    host_ms = sum(step_ms) / steps
    median = float(np.median(step_ms))
    log(f"static wide_deep: {steps} steps, step ms "
        f"{[round(t, 3) for t in step_ms]}, mean {host_ms:.3f} ms (host "
        f"clock, fetch included), median {median:.3f}, min "
        f"{min(step_ms):.3f} ms; {batch / host_ms * 1e3:.0f} samples/s at "
        f"the mean, {batch / median * 1e3:.0f} at the median; peak memory "
        f"{peak / 2 ** 30:.3f} GiB")
    log(f"static wide_deep losses {losses}")
    if not all(np.isfinite(losses)):
        failures.append(f"static wide_deep losses not finite: {losses}")
    prof = profile_train_step(lambda _: run(), None, (), host_ms,
                              label="static wide_deep", steps=2)
    log(f"static wide_deep step: {prof['kernels']:.1f} kernels and {ops} "
        f"Executor ops per step")
    del scope, exe
    torch.cuda.empty_cache()
    return dict(host_ms=host_ms, profile=prof, ops=ops, peak=peak)


def static_check(failures, steps=3):
    """Card against CPU, float32, `steps` steps of each STATIC_FAMILIES
    entry from the same startup values (run on the CPU and copied to the
    card with `interop.scope_from_numpy`); the D-768 GPT runs K4/K5 on
    the card and their plain versions on the CPU.  Fetches: the first
    step within 1e-4 relative, later ones 1e-3; persistables per tensor
    in norm, ||card - CPU|| <= 1e-3 ||CPU|| + atol sqrt(n), atol 1e-5
    (SGD, Momentum) or 2 lr steps + 1e-5 (Adam, whose first updates are
    about lr * sign(g): an element whose grad the two devices round to
    opposite signs moves by up to 2 lr a step), as `train_check` holds
    the dygraph GPT's params; and each persistable's update over the
    steps (its value less the startup value) against the CPU's, in norm:
    ||d_card - d_cpu|| <= 0.1 ||d_cpu||, 0 where the CPU's is 0, which
    the bound above, twice a whole Adam update, cannot see.

    An Adam or Adagrad parameter is held element by element instead (see
    `adam_update_check`), since the update of either jumps at a zero
    gradient (the first is about lr * sign(g)):
    which near-zero grads the card rounds to the other sign varies
    between runs (on an H100, lenet's first conv, 150 elements, read
    0.018 and 0.80 of the norm rule in two runs, and 2 elements off in a
    third).  Each step fetches every Adam parameter's `@GRAD` on both
    devices; an element is near zero if at some step the CPU's gradient
    lies within ADAM_NEAR times the two devices' difference of 0, and at
    most ADAM_NEAR_SHARE of the elements with a gradient may be.  Every
    other element's update must agree, |d_card - d_cpu| <= 0.1 |d_cpu| +
    0.01 lr steps, so a parameter left without its update, or updated
    wrongly, fails; the moments, continuous in the gradients, keep the
    norm rule, which holds the gradients themselves.  The update checks
    skip the attention's key bias and its moments (STATIC_ZERO_GRAD):
    its gradient is 0 in exact arithmetic, and each device's rounding
    noise gets an Adam update of its own."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import static_zoo

    for name, kw, batch, lr, adam, *tier in STATIC_FAMILIES:
        with tier_flags(fuse="on" if tier else "off"):
            _static_family_check(failures, name, kw, batch, lr, adam,
                                 bool(tier), steps)
    torch.cuda.empty_cache()


def _static_family_check(failures, name, kw, batch, lr, adam, fused, steps):
    """One STATIC_FAMILIES entry of `static_check`."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import static_zoo

    build_fn, engaged = STATIC_PROGRAMS[name] \
        if name in STATIC_PROGRAMS else (static_zoo.BUILDERS[name], None)
    m = build_fn(**kw)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_scope = fluid.Scope()
    cpu_exe.run(m.startup, scope=cpu_scope)
    card_exe = fluid.Executor()
    start = interop.scope_to_numpy(cpu_scope)
    card_scope = interop.scope_from_numpy(start, fluid.Scope(), "cuda")
    params = {v.name for v in m.main.all_parameters()}
    held = sorted(params - set(STATIC_ZERO_GRAD)) if adam else []
    grads = [n + "@GRAD" for n in held]
    near = {n: np.zeros(start[n].shape, bool) for n in held}
    live = {n: np.zeros(start[n].shape, bool) for n in held}
    fetch_err = []
    backend.reset_launches()
    for i in range(steps):
        feed = m.smoke_feed(batch=batch, seed=i)
        got = card_exe.run(m.main, feed=feed,
                           fetch_list=m.fetches + grads, scope=card_scope)
        want = cpu_exe.run(m.main, feed=feed,
                           fetch_list=m.fetches + grads, scope=cpu_scope)
        k = len(m.fetches)
        err = max(float(np.abs(g - w).max()
                        / max(np.abs(w).max(), 1e-6))
                  for g, w in zip(got[:k], want[:k]))
        fetch_err.append(err)
        if not err <= (1e-4 if i == 0 else 1e-3):
            failures.append(f"static check {name} {kw} step {i}: "
                            f"fetches differ by {err:.3e} relative")
        for n, g, w in zip(held, got[k:], want[k:]):
            near[n] |= near_zero_grad(g, w)
            live[n] |= (g != 0) | (w != 0)
        for side, fetched in (("card", got), ("CPU", want)):
            bad = engaged(fetched) if engaged else None
            if bad:
                failures.append(f"static check {name} step {i} "
                                f"({side}): {bad}")
    # the D-768 GPT's two layer_norm ops take K4/K5 on the card, and
    # fused, its fused_attention K1-K3 (f32, seq 128, head dim 64); the
    # zoo-size families (D 32) take the eager composition
    d = kw.get("d")
    want = ({n: c * steps for n, c in (STATIC_AMP_LAUNCHES if fused
                                        else STATIC_LAUNCHES).items()}
            if d is not None and d % 128 == 0 else {})
    if dict(backend.LAUNCHES) != want:
        failures.append(f"static check {name} {kw}: launches "
                        f"{dict(backend.LAUNCHES)} != {want}")
    atol = (2 * lr * steps if adam else 0.0) + 1e-5
    card = interop.scope_to_numpy(card_scope)
    cpu = interop.scope_to_numpy(cpu_scope)
    worst, worst_name = 0.0, None
    for n, w in cpu.items():
        d = float(np.linalg.norm((card[n] - w).ravel().astype(np.float64)))
        bound = (1e-3 * float(np.linalg.norm(w.ravel().astype(np.float64)))
                 + atol * np.sqrt(w.size))
        if d / bound > worst:
            worst, worst_name = d / bound, n
    upd, upd_name = update_error(start, card, cpu,
                                 set(STATIC_ZERO_GRAD) | set(near))
    elem, elem_name, n_near, n_off, n_bad = 0.0, None, 0, 0, 0
    n_live = sum(int(v.sum()) for v in live.values())
    for n in held:
        r, off, bad = adam_update_check(card[n], cpu[n], start[n],
                                        near[n], lr * steps)
        n_near += int(near[n].sum())
        n_off += off
        n_bad += bad
        if r > elem:
            elem, elem_name = r, n
    log(f"f32 static check {name} {kw or ''}{' fused' if fused else ''} "
        f"batch {batch}, {steps} "
        f"steps, card vs CPU: fetch rel err per step "
        f"{[f'{e:.2e}' for e in fetch_err]}; {len(cpu)} persistables, "
        f"worst ||d|| / bound {worst:.3e} ({worst_name}; atol "
        f"{atol:.1e}); worst update ||d_card - d_cpu|| / (0.1 "
        f"||d_cpu||) {upd:.3e} ({upd_name}); Adam or Adagrad "
        f"parameters: "
        f"{n_near} of {n_live} elements with a gradient near zero, "
        f"{n_off} updates off by > "
        f"their bound, {n_bad} of them not near zero, worst other "
        f"element / bound {elem:.3e} ({elem_name}); launches "
        f"{dict(backend.LAUNCHES)}")
    if not upd <= 1.0:
        failures.append(f"static check {name} {kw}: update of "
                        f"{upd_name} off by {upd:.3e} of its bound")
    if n_bad or not elem <= 1.0:
        failures.append(f"static check {name} {kw}: {n_bad} Adam or "
                        f"Adagrad parameter elements with a gradient "
                        f"away from "
                        f"0 updated off their bound (worst {elem:.3e}, "
                        f"{elem_name})")
    if n_near > ADAM_NEAR_SHARE * n_live:
        failures.append(f"static check {name} {kw}: {n_near} of "
                        f"{n_live} Adam or Adagrad parameter elements "
                        f"with a "
                        f"gradient near zero, more than "
                        f"{ADAM_NEAR_SHARE}")
    if set(card) != set(cpu):
        failures.append(f"static check {name}: persistables differ "
                        f"{sorted(set(card) ^ set(cpu))}")
    if not worst <= 1.0:
        failures.append(f"static check {name} {kw}: persistable "
                        f"{worst_name} off by {worst:.3e} of its bound")
    del card_scope, cpu_scope


def update_error(start, card, cpu, skip=()):
    """The worst ||d_card - d_cpu|| / (STATIC_UPDATE_RTOL ||d_cpu||) over
    the tensors of `cpu` in `card` and not in `skip`, d being a tensor's
    value less its `start` (0 where d_cpu is 0): (ratio, name)."""
    worst, worst_name = 0.0, None
    for n, w in cpu.items():
        if n in skip or n not in card:
            continue
        d_cpu = (np.asarray(w, np.float64) - start[n]).ravel()
        d_card = (np.asarray(card[n], np.float64) - start[n]).ravel()
        off = float(np.linalg.norm(d_card - d_cpu))
        ref = STATIC_UPDATE_RTOL * float(np.linalg.norm(d_cpu))
        r = off / ref if ref else (0.0 if off == 0 else np.inf)
        if r > worst:
            worst, worst_name = r, n
    return worst, worst_name


def static_amp_check(failures, steps=3):
    """Card against CPU, the static GPT of STATIC_AMP_CHECK
    (`build_gpt(128, 768, 12, 1024)`, batch 2 of `smoke_feed`, Adam) with
    FLAGS_amp and FLAGS_graph_opt_fuse on, `steps` steps from the same
    startup values: on the card its fused_attention runs K1-K3 in bf16
    and its fused_layer_norm ops K4/K5, on the CPU their plain versions
    and the eager composition.  The losses within 3e-2 relative; each
    persistable's update (its value less the startup value) within
    STATIC_UPDATE_RTOL of the CPU's in norm, over all its elements, but
    the attention's key bias and its moments (a gradient 0 in exact
    arithmetic).  Logs the measured errors."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import static_zoo

    kw, batch, lr = STATIC_AMP_CHECK
    m = static_zoo.build_gpt(**kw)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    cpu_exe.run(m.startup, scope=scope)
    start = interop.scope_to_numpy(scope)
    runs = {}
    for side, dev in (("card", "cuda"), ("cpu", "cpu")):
        exe = fluid.Executor() if dev == "cuda" else cpu_exe
        sc = interop.scope_from_numpy(start, fluid.Scope(), dev)
        backend.reset_launches()
        with tier_flags(amp="on", fuse="on"):
            losses = [float(np.asarray(exe.run(
                m.main, feed=m.smoke_feed(batch=batch, seed=i),
                fetch_list=m.fetches, scope=sc)[0]).reshape(-1)[0])
                for i in range(steps)]
        runs[side] = dict(losses=losses, state=interop.scope_to_numpy(sc),
                          launches=dict(backend.LAUNCHES))
        del sc
    card, cpu = runs["card"], runs["cpu"]
    want = {n: c * steps for n, c in STATIC_AMP_LAUNCHES.items()}
    if card["launches"] != want:
        failures.append(f"static amp check: card launches "
                        f"{card['launches']} != {want}")
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
    worst, worst_name = update_error(start, card["state"], cpu["state"],
                                     STATIC_ZERO_GRAD)
    log(f"static amp check {kw} batch {batch}, {steps} Adam({lr}) steps, "
        f"AMP bf16 + fusion, card vs CPU: losses card {card['losses']} CPU "
        f"{cpu['losses']}, max rel err "
        f"{loss_err:.3e}; worst update ||d_card - d_cpu|| / (0.1 "
        f"||d_cpu||) {worst:.3e} ({worst_name}); card launches "
        f"{card['launches']}")
    if not loss_err <= STATIC_AMP_LOSS_RTOL:
        failures.append(f"static amp check: losses differ by "
                        f"{loss_err:.3e} > {STATIC_AMP_LOSS_RTOL}")
    if not worst <= 1.0:
        failures.append(f"static amp check: update of {worst_name} off by "
                        f"{worst:.3e} of its bound")
    if not all(np.isfinite(card["losses"])):
        failures.append(f"static amp check: card losses {card['losses']}")
    torch.cuda.empty_cache()


def static_phase(failures):
    """Phase 7: the static GPT's run (`static_run`), the same GPT with AMP
    and the fusion tier (`static_run(amp=True)`, compared with the plain
    run on one line), the same GPT under the global-norm clip
    (`static_run(clip_norm=1.0)`), the same GPT with AMP in float16 and
    the fusion tier (K1-K3's float16 forms; STATIC_AMP_F16_STEPS steps),
    the static Wide&Deep at CTR widths (`static_wide_deep_run`), then the
    card-vs-CPU checks of the static families (`static_check`) and of the
    AMP tier (`static_amp_check`).  Returns the launches of the timed
    steps of the four GPT runs."""
    out = static_run(failures)
    amp = static_run(failures, amp=True)
    plain, fast = out["profile"], amp["profile"]
    log(f"static amp vs plain (the same call): host ms {amp['host_ms']:.3f}"
        f" vs {out['host_ms']:.3f}; device ms {fast['device']:.3f} vs "
        f"{plain['device']:.3f}; kernels {fast['kernels']:g} vs "
        f"{plain['kernels']:g}; Executor ops {amp['ops']} vs {out['ops']}; "
        f"peak {amp['peak'] / 2 ** 30:.3f} vs {out['peak'] / 2 ** 30:.3f} "
        f"GiB; products {fast.get('products', 0):.3f} vs "
        f"{plain.get('products', 0):.3f} ms; K1-K3 "
        f"{sum(fast.get(k, 0) for k in ('K1', 'K2', 'K3')):.3f} ms; K4/K5 "
        f"{fast.get('K4', 0) + fast.get('K5', 0):.3f} vs "
        f"{plain.get('K4', 0) + plain.get('K5', 0):.3f} ms; copies and casts "
        f"{fast.get('copies and casts', 0):.3f} vs "
        f"{plain.get('copies and casts', 0):.3f} ms; Adam ops "
        f"{fast['by_op'].get('adam', 0):.3f} ms, cast ops (forward) "
        f"{fast['by_op'].get('cast', 0):.3f} ms")
    clipped = static_run(failures, clip_norm=1.0)
    amp16 = static_run(failures, steps=STATIC_AMP_F16_STEPS, amp=True,
                       amp_dtype="float16")
    log(f"static amp float16 vs bfloat16 (the same call): host ms "
        f"{amp16['host_ms']:.3f} vs {amp['host_ms']:.3f}; device ms "
        f"{amp16['profile']['device']:.3f} vs {fast['device']:.3f}")
    static_wide_deep_run(failures)
    static_check(failures)
    static_amp_check(failures)
    runs = (out, amp, clipped, amp16)
    return {n: sum(r["launches"].get(n, 0) for r in runs)
            for r0 in runs for n in r0["launches"]}


# ---------------------------------------------------------------------------
# phase 7b: IO, checkpoints, readers and the Predictor
# ---------------------------------------------------------------------------

IO_BATCH = 8
IO_RUNS = 5
# per Predictor.run / CompiledPredictor.run of the fused static GPT: K1 for
# its fused_attention, K4 for its two fused_layer_norm ops
IO_PREDICTOR_LAUNCHES = {"flash_attention_fwd": 1, "layer_norm_fwd": 2}
IO_F32_RTOL = 1e-4          # Predictor f32 vs Executor.run, relative
IO_BF16_RTOL = 3e-2         # Predictor bf16 vs Executor.run (f32), relative
IO_COMPILED_RTOL = 1e-6     # CompiledPredictor vs Predictor, relative
IO_FOLD_RTOL = 1e-4         # FLAGS_inference_fold on vs off, relative
# the dygraph GPT of phase 3 at depth 2 with dropout on, for resume
IO_RESUME_GPT = dict(vocab_size=32768, hidden_size=768, num_layers=2,
                     num_heads=12, max_seq_len=512, dtype="bfloat16",
                     dropout=0.1)
IO_RESUME_BATCH = 8
IO_LOADER_STEPS = 6


def rel_max(a, b):
    """max |a - b| over max |b| (numpy)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(path) for f in fs)


def io_phase(failures):
    """Phase 7b, `io`: the port's IO, checkpoints, readers and
    the Predictor on the card.

    - `io_serve`: the static GPT at BERT-base widths (STATIC_GPT), its
      for_test forward to the logits pruned and fused
      (`passes.fuse_program`), once as built (f32) and once AMP-rewritten
      to bf16 first (`amp.rewrite_program`), each saved with
      `io.save_inference_model` and served from disk by
      `inference.Predictor` on `cuda` at batch IO_BATCH: held against the
      same device's `Executor.run` of the unfused for_test Program at
      IO_F32_RTOL / IO_BF16_RTOL relative; every timed run launches
      exactly IO_PREDICTOR_LAUNCHES (K1 once, K4 twice); host ms and
      device ms per run (torch.profiler), peak memory.  The f32 directory
      exported (`save_compiled_inference_model`, `torch.export`) and
      served by a `CompiledPredictor` loaded from the artifact: the same
      launches, outputs within IO_COMPILED_RTOL of `Predictor.run` (says
      whether bitwise), host ms beside the eager Predictor's.  The f32
      directory through the C API (`paddle_tpu_torch/csrc/
      predictor_capi.cpp` built with g++, driven through ctypes on
      `cuda`): its outputs equal to `Executor.run` of the loaded Program
      bitwise and to `Predictor.run` within IO_COMPILED_RTOL.
    - `io_fold`: the static ResNet family's for_test Program through the
      Predictor with FLAGS_inference_fold off and on: op counts, outputs
      within IO_FOLD_RTOL.
    - `io_resume`: the dygraph GPT of phase 3 at depth 2 with dropout on
      (IO_RESUME_GPT): 3 steps, `checkpoint.save_checkpoint`, 3 more; a
      fresh state `load_checkpoint`-ed takes the same 3 steps: losses,
      every parameter and moment and the generator's state bitwise
      equal.  The same for the static GPT with Adam through
      `io.save_persistables` / `load_persistables`.  Save and load
      seconds and bytes on disk.
    - `io_loaders`: the static GPT's Adam steps fed three ways from the
      same start: numpy dicts, `DataLoader.from_generator` ->
      `device_prefetch(size=2)` on `cuda`, `ShmBatchLoader` (2 forked
      workers, after the parent's CUDA context exists) ->
      `device_prefetch`: losses bitwise equal across the three, host ms
      per step each; the overlap of the side stream's host-to-device
      copies with the main stream's kernels in a torch.profiler trace of
      the prefetched run (printed, not gated).
    Returns the launches of the Predictor's and CompiledPredictor's timed
    runs."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        launches = io_serve(failures, tmp)
        io_fold(failures, tmp)
        io_resume(failures, tmp)
        io_static_resume(failures, tmp)
        io_loaders(failures, tmp)
    return launches


def _timed_runs(run, label, failures, want_launches):
    """Two warm-up calls of run() (the first pinned fetch buffers: a run's
    outputs are still held while the next one allocates), then IO_RUNS
    timed calls: each must launch `want_launches`; returns (host ms per
    run, the mean; launches; the last outputs)."""
    import torch

    from paddle_tpu_torch.kernels import backend

    for _ in range(2):
        run()
    backend.reset_launches()
    host, outs = [], None
    for i in range(IO_RUNS):
        before = dict(backend.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = run()                    # numpy out: waits for the card
        host.append((time.perf_counter() - t0) * 1e3)
        made = {n: c - before.get(n, 0) for n, c in backend.LAUNCHES.items()}
        made = {n: c for n, c in made.items() if c}
        if made != want_launches:
            failures.append(f"{label} run {i} launches {made} != "
                            f"{want_launches}")
    log(f"{label}: {IO_RUNS} runs, host ms {[round(t, 3) for t in host]}, "
        f"mean {sum(host) / len(host):.3f}, median "
        f"{sorted(host)[len(host) // 2]:.3f}")
    return sum(host) / len(host), dict(backend.LAUNCHES), outs


def io_serve(failures, tmp):
    import os

    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, inference, native, passes
    from paddle_tpu_torch.models import static_zoo

    m = static_zoo.build_gpt(**STATIC_GPT)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    test = m.main.clone(for_test=True)
    logits = [op for op in test.global_block().ops
              if op.type == "softmax_with_cross_entropy"][0].inputs[
        "Logits"][0]
    ids = static_feed(m, STATIC_GPT["vocab"], IO_BATCH, seed=17)["ids"]
    feed = {"ids": ids}
    ref = exe.run(test, feed=feed, fetch_list=[logits], scope=scope)[0]
    dirs, launches = {}, {}
    for kind in ("float32", "bfloat16"):
        prog = test._prune([logits])
        if kind == "bfloat16":
            with tier_flags(amp="off", fuse="off", amp_dtype="bfloat16"):
                amp.rewrite_program(prog)
        fused, rep = passes.fuse_program(prog, fetch_names=[logits])
        types = [op.type for op in fused.global_block().ops]
        d = dirs[kind] = os.path.join(tmp, f"gpt_{kind}")
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["ids"], [logits], exe,
                                          main_program=fused)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p = inference.Predictor(d)
        load_s = time.perf_counter() - t0
        label = f"io predictor {kind}"
        log(f"{label}: fused program {len(types)} ops ({rep['before_ops']} "
            f"before fusion; fused_attention {types.count('fused_attention')}"
            f", fused_layer_norm {types.count('fused_layer_norm')}, casts "
            f"{types.count('cast')}), served {len(p._program.global_block().ops)}"
            f" ops after the load-time folds; save {save_s:.3f} s, "
            f"{dir_bytes(d)} bytes on disk; load {load_s:.3f} s")
        out = p.run(feed)[0]            # warm-up: Triton JIT, cuBLAS
        del out
        torch.cuda.reset_peak_memory_stats()
        host, made, outs = _timed_runs(lambda: p.run(feed), label, failures,
                                       IO_PREDICTOR_LAUNCHES)
        for n, c in made.items():
            launches[n] = launches.get(n, 0) + c
        peak = torch.cuda.max_memory_allocated()
        err = rel_max(outs[0], ref)
        tol = IO_F32_RTOL if kind == "float32" else IO_BF16_RTOL
        prof = profile_train_step(lambda _: p.run(feed), None, (), host,
                                  label=label, steps=2)
        log(f"{label}: logits {list(outs[0].shape)}, rel err vs Executor.run of "
            f"the unfused for_test Program {err:.3e} (tol {tol}); host "
            f"{host:.3f} ms, device {prof['device']:.3f} ms per run; peak "
            f"{peak / 2 ** 30:.3f} GiB; {card_line()}")
        if not np.isfinite(outs[0]).all() or err > tol:
            failures.append(f"{label}: rel err {err:.3e} > {tol} or not "
                            "finite")
        if kind == "float32":
            p32, out32, host32 = p, outs[0], host
    # the exported artifact of the f32 directory
    t0 = time.perf_counter()
    path = inference.save_compiled_inference_model(dirs["float32"], feed)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cp = inference.CompiledPredictor(path)
    cload_s = time.perf_counter() - t0
    label = "io compiled predictor float32"
    host, made, outs = _timed_runs(lambda: cp.run(feed), label, failures,
                                   IO_PREDICTOR_LAUNCHES)
    for n, c in made.items():
        launches[n] = launches.get(n, 0) + c
    err = rel_max(outs[0], out32)
    same = bool(np.array_equal(outs[0], out32))
    log(f"{label}: export {export_s:.3f} s ({os.path.getsize(path)} bytes), "
        f"load {cload_s:.3f} s; rel err vs Predictor.run {err:.3e} "
        f"(bitwise {same}); host {host:.3f} ms per run vs the eager "
        f"Predictor's {host32:.3f}; {card_line()}")
    if err > IO_COMPILED_RTOL:
        failures.append(f"{label}: rel err {err:.3e} > {IO_COMPILED_RTOL}")
    del cp
    # the C API on the f32 directory
    t0 = time.perf_counter()
    lib = native.capi_load(native.build_capi(os.path.join(tmp,
                                                          "libcapi.so")))
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = native.capi_run(lib, dirs["float32"], feed, "cuda")[0]
    capi_ms = (time.perf_counter() - t0) * 1e3
    loaded = fluid.Scope()
    with fluid.scope_guard(loaded):
        prog, _, fetches = fluid.io.load_inference_model(dirs["float32"], exe)
    direct = exe.run(prog, feed=feed, fetch_list=fetches, scope=loaded)[0]
    err = rel_max(got, out32)
    log(f"io C API float32: g++ {build_s:.1f} s; one PD_NewPredictor + "
        f"PD_Run {capi_ms:.1f} ms; bitwise equal to Executor.run of the "
        f"loaded Program {bool(np.array_equal(got, direct))}; rel err vs "
        f"Predictor.run {err:.3e} (bitwise {bool(np.array_equal(got, out32))})")
    if not np.array_equal(got, direct) or err > IO_COMPILED_RTOL:
        failures.append(f"io C API: outputs differ from the Python paths "
                        f"(rel err vs Predictor {err:.3e})")
    log(f"io path launches (Predictor f32 and bf16, CompiledPredictor, "
        f"{IO_RUNS} runs each): {launches}")
    del p32, scope, exe
    torch.cuda.empty_cache()
    return launches


def io_fold(failures, tmp):
    import os

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import static_zoo

    m = static_zoo.build_resnet()
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    d = os.path.join(tmp, "resnet")
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, [n for n, _, _ in m.feeds],
                                      m.fetches, exe,
                                      main_program=m.main.clone(
                                          for_test=True))
    feed = m.smoke_feed(IO_BATCH, seed=11)
    outs, ops = {}, {}
    for fold in (False, True):
        with tier_flags(amp="off", fuse="off", inference_fold=fold):
            p = inference.Predictor(d)
            outs[fold] = p.run(feed)
            ops[fold] = len(p._program.global_block().ops)
    err = max(rel_max(a, b) for a, b in zip(outs[True], outs[False]))
    log(f"io fold (static resnet, batch {IO_BATCH}): ops {ops[False]} -> "
        f"{ops[True]} with FLAGS_inference_fold; rel err {err:.3e} (tol "
        f"{IO_FOLD_RTOL})")
    if err > IO_FOLD_RTOL or ops[True] >= ops[False]:
        failures.append(f"io fold: rel err {err:.3e} or ops {ops}")


def _flat_equal(a, b):
    """[keys whose leaves differ] between two states (bitwise; a
    generator by its state)."""
    import torch

    from paddle_tpu_torch.checkpoint import flatten_with_path

    fa, fb = flatten_with_path(a), flatten_with_path(b)
    if [k for k, _ in fa] != [k for k, _ in fb]:
        return ["<structure>"]
    bad = []
    for (k, x), (_, y) in zip(fa, fb):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if not (x.dtype == y.dtype and torch.equal(x, y)):
            bad.append(k)
    return bad


def io_resume(failures, tmp):
    import os

    import torch

    from paddle_tpu_torch import checkpoint
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW

    cfg = GPTConfig(**IO_RESUME_GPT)
    rng = np.random.default_rng(23)
    batches = [tuple(torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (IO_RESUME_BATCH, cfg.max_seq_len)),
        dtype=torch.int32, device="cuda") for _ in range(2))
        for _ in range(6)]

    def fresh(seed):
        model = GPT(cfg, device="cuda", generator=make_generator(seed))
        opt = AdamW(1e-4)
        return (init_train_state(model, opt, rng_seed=5),
                make_train_step(model, opt))

    state, step = fresh(0)
    for b in batches[:3]:
        state, _ = step(state, *b)
    d = os.path.join(tmp, "ckpt")
    torch.cuda.synchronize()
    path = checkpoint.save_checkpoint(d, state, 3)
    save_s = checkpoint.save_checkpoint.last_seconds
    losses = []
    for b in batches[3:]:
        state, loss = step(state, *b)
        losses.append(loss)
    tmpl, step2 = fresh(1)
    resumed, at = checkpoint.load_checkpoint(d, tmpl)
    load_s = checkpoint.load_checkpoint.last_seconds
    again = []
    for b in batches[3:]:
        resumed, loss = step2(resumed, *b)
        again.append(loss)
    same_losses = at == 3 and all(torch.equal(a, b)
                                  for a, b in zip(losses, again))
    bad = _flat_equal(resumed, state)
    log(f"io resume (dygraph GPT {IO_RESUME_GPT}, batch {IO_RESUME_BATCH}, "
        f"AdamW): save {save_s:.3f} s, load {load_s:.3f} s, "
        f"{dir_bytes(path)} bytes on disk; losses after the save "
        f"{[float(x) for x in losses]}, resumed {[float(x) for x in again]};"
        f" bitwise equal: losses {same_losses}, state leaves differing "
        f"{len(bad)} of {len(checkpoint.flatten_with_path(state))}"
        f"{' ' + str(bad[:5]) if bad else ''}; {card_line()}")
    if not same_losses or bad:
        failures.append(f"io resume: not bitwise equal to the uninterrupted "
                        f"run (losses {same_losses}, leaves {bad[:5]})")
    del state, resumed, tmpl, step, step2
    torch.cuda.empty_cache()


def io_static_resume(failures, tmp):
    import os

    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import static_zoo

    m = static_zoo.build_gpt(**STATIC_GPT)
    exe = fluid.Executor()
    feeds = [static_feed(m, STATIC_GPT["vocab"], IO_BATCH, seed=40 + i)
             for i in range(6)]

    def run(scope, fs):
        return [exe.run(m.main, feed=f, fetch_list=m.fetches,
                        scope=scope)[0] for f in fs]

    a = fluid.Scope()
    exe.run(m.startup, scope=a)
    run(a, feeds[:3])
    d = os.path.join(tmp, "persistables")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fluid.scope_guard(a):
        fluid.io.save_persistables(exe, d, m.main)
    save_s = time.perf_counter() - t0
    want = run(a, feeds[3:])
    b = fluid.Scope()
    t0 = time.perf_counter()
    with fluid.scope_guard(b):
        fluid.io.load_persistables(exe, d, m.main)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = run(b, feeds[3:])
    same = all(np.array_equal(x, y) for x, y in zip(got, want))
    bad = [n for n in a.vars if not torch.equal(a.vars[n], b.vars[n])]
    log(f"io static resume (static GPT {STATIC_GPT}, Adam, batch "
        f"{IO_BATCH}): save_persistables {save_s:.3f} s, load_persistables "
        f"{load_s:.3f} s, {dir_bytes(d)} bytes on disk; losses "
        f"{[float(x) for x in want]}, resumed {[float(x) for x in got]}; "
        f"bitwise equal: losses {same}, persistables differing {len(bad)} of"
        f" {len(a.vars)}; {card_line()}")
    if not same or bad or set(a.vars) != set(b.vars):
        failures.append(f"io static resume: not bitwise (losses {same}, "
                        f"persistables {bad[:5]})")
    del a, b
    torch.cuda.empty_cache()


def io_loaders(failures, tmp):
    import json
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import static_zoo
    from paddle_tpu_torch.reader import device_prefetch
    from paddle_tpu_torch.reader.shm import ShmBatchLoader

    m = static_zoo.build_gpt(**STATIC_GPT)
    exe = fluid.Executor()
    start = fluid.Scope()
    exe.run(m.startup, scope=start)
    batches = [static_feed(m, STATIC_GPT["vocab"], IO_BATCH, seed=60 + i)
               for i in range(IO_LOADER_STEPS)]

    def reader():
        for bt in batches:
            yield bt

    def way(name):
        if name == "numpy":
            return iter(batches)
        if name == "DataLoader":
            loader = fluid.DataLoader.from_generator(
                feed_list=list(batches[0]), capacity=4)
            loader.set_batch_generator(reader)
            return device_prefetch(loader, size=2)
        return device_prefetch(ShmBatchLoader(reader, num_workers=2), size=2)

    def train(name):
        """The steps fed one way, the losses kept on the card (no sync
        per step, so the host runs ahead and a prefetched copy can meet
        the step before it): (losses, host ms per step to enqueue it,
        wall ms per step with the final sync)."""
        scope = fluid.Scope()
        for n, v in start.vars.items():
            scope.set_var(n, v.clone())
        losses, host, ends = [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for feed in way(name):
            losses.append(exe.run(m.main, feed=feed, fetch_list=m.fetches,
                                  scope=scope, return_numpy=False)[0])
            ends.append(time.perf_counter())
            host.append((ends[-1] - t0) * 1e3)
            t0 = ends[-1]
        torch.cuda.synchronize()
        # from the end of the first step (the loader's start-up) to the
        # last step's completion
        wall = (time.perf_counter() - ends[0]) * 1e3 / (len(losses) - 1)
        return [x.cpu().numpy() for x in losses], host, wall

    results = {}
    for name in ("numpy", "DataLoader", "ShmBatchLoader"):
        train(name)                             # warm-up
        results[name] = train(name)
    base = results["numpy"][0]
    same = {n: len(r[0]) == len(base) and all(
        np.array_equal(a, b) for a, b in zip(r[0], base))
        for n, r in results.items()}
    for n, (losses, host, wall) in results.items():
        log(f"io loaders {n}: {len(losses)} static GPT Adam steps, host ms "
            f"per step to enqueue {[round(t, 3) for t in host]} (mean "
            f"{sum(host[1:]) / max(len(host) - 1, 1):.3f} after the first),"
            f" wall ms per step after the first {wall:.3f} (the last "
            f"step's sync included);"
            f" losses bitwise equal to the numpy feed's {same[n]}")
    if not all(same.values()):
        failures.append(f"io loaders: losses differ across feeds {same}")
    # where the prefetched copies ran: a trace of the DataLoader way
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train("DataLoader")
        torch.cuda.synchronize()
    trace = os.path.join(tmp, "io_loader_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    copies = [(e["ts"], e["ts"] + e.get("dur", 0), e["args"].get("stream"))
              for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    kernels = [(e["ts"], e["ts"] + e.get("dur", 0), e["args"].get("stream"))
               for e in events if e.get("cat") == "kernel"]
    overlap, hit = 0.0, 0
    for c0, c1, cs in copies:
        o = sum(max(0.0, min(c1, k1) - max(c0, k0))
                for k0, k1, ks in kernels if ks != cs)
        overlap += min(o, c1 - c0)
        hit += o > 0
    streams = sorted({str(s) for _, _, s in copies})
    log(f"io loaders DataLoader -> device_prefetch(size=2) trace: "
        f"{len(copies)} host-to-device copies on streams "
        f"{streams}, {hit} of them overlapping kernels of another stream, "
        f"{overlap:.1f} of {sum(c1 - c0 for c0, c1, _ in copies):.1f} us "
        f"of copy time overlapped; {card_line()}")
    del start
    torch.cuda.empty_cache()


def check_phase(failures):
    import torch

    f32_cpu = train_check(failures)
    amp_train_check(failures, f32_cpu)
    amp_overflow_check(failures)
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


# launches of each K7 geometry (side, projection) in one full-fused
# ResNet-50 step
K7_STEP_LAUNCHES = {(56, False): 2, (28, False): 3, (14, False): 5,
                    (7, False): 2, (56, True): 1}


def add_step(step, timed, proj, hw):
    """Adds one geometry's K7 times, times its launches in a full-fused
    step, to `step`."""
    k = K7_STEP_LAUNCHES[hw, proj]
    for key in step:
        step[key] += k * timed[key]


def step_text(step):
    return (f"K7 per full-fused ResNet-50 step (13 launches, bf16 batch "
            f"128): fwd {step['fwd_ms']:.3f} ms, bwd {step['bwd_ms']:.3f} "
            f"ms, sum {step['fwd_ms'] + step['bwd_ms']:.3f} ms")


def timed_text(timed):
    return " ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in timed.items())


COMPARE_PARTS = ("k7", "train", "ln", "resnet", "probes", "decode", "stem",
                 "dgc", "static")


def decode_prefill(model, prompts):
    """`model`'s decode params and a 384-deep cache after the prefill of
    `prompts` [4, 256]: (params, cache, logits)."""
    import torch

    from paddle_tpu_torch.models import generate as G

    params = G.build_decode_params(model)
    with torch.inference_mode():
        cache = G.init_cache(params.cfg, 4, 384, device="cuda")
        logits = G.prefill(params, torch.as_tensor(prompts, device="cuda"),
                           cache)
    return params, cache, logits


def decode_run():
    """Phase 6's model and prompts (GPT-2 small in bf16, seeded), then
    `profile_decode`: its {host, device, k6} ms per step."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import make_generator

    cfg = GPTConfig(dtype="bfloat16")
    model = GPT(cfg, device="cuda", generator=make_generator(0)).eval()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 256), dtype=np.int32)
    return profile_decode(*decode_prefill(model, prompts))


def compare_one(tree, parts=COMPARE_PARTS):
    """`compare` for one tree: its package (`tree`/paddle_tpu_torch) built
    and run by this script's `k7_bf16_times`, `train_run` (the GPT train
    step: host and device ms, K2 and K5 per step), `ln_compare` (K5),
    `resnet_run` (full fused and
    `id`), `probes_phase`'s timing (P1, P2 and K7's stage-1 forward),
    `decode_run` (the decode step and K6's share), `stem_compare` (K9)
    and `dgc_compare` (K10 and the DGC step), those of `parts`."""
    sys.path.insert(0, tree)
    import torch

    from paddle_tpu_torch.kernels import backend

    log(f"compare {tree}: package {backend.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend.build()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dt)

    failures = []
    if "k7" in parts:
        k7_bf16_times(rnd, failures)
    if "train" in parts:
        gpt = train_run(failures)
        prof = gpt["profile"]
        log(f"compare {tree} train: step {gpt['step_ms']:.3f} ms (host, "
            f"mean of 5), device {prof['device']:.3f} ms, K2 "
            f"{prof.get('K2', 0):.3f} ms per step (12 launches), K5 "
            f"{prof.get('K5', 0):.3f} (25 launches), K1 "
            f"{prof.get('K1', 0):.3f}, K3 {prof.get('K3', 0):.3f}; "
            f"{prof['kernels']} kernels, per LayerNorm backward "
            f"{sorted({len(k) for k in prof['ln_bwd']})}")
    if "ln" in parts:
        ln_compare(tree, rnd)
    if "resnet" in parts:
        for mode in ("full", "id"):
            _, ms, peak = resnet_run(mode, failures)
            log(f"compare {tree} resnet {mode}: step {ms:.3f} ms, peak "
                f"{peak / 2 ** 30:.3f} GiB")
    if "probes" in parts:
        hw, cin, cm = 56, 256, 64
        dt = torch.bfloat16
        x1 = rnd((128, hw, hw, cm), dt)
        w2 = rnd((3, 3, cm, cm), dt, (9 * cm) ** -0.5)
        x2 = rnd((128, hw, hw, cin), dt)
        w1 = rnd((cin, cm), dt, cin ** -0.5)
        w3 = rnd((cm, cin), dt, cm ** -0.5)
        o = probe_times(x1, w2, x2, w1, w3, rnd)
        log(f"compare {tree} probes: K7 {o['k7_ms']:.4f} ms, P1 "
            f"{o['p1_ms']:.4f}, P2 {o['p2_ms']:.4f}, K7 - P1 - P2 "
            f"{o['k7_ms'] - o['p1_ms'] - o['p2_ms']:.4f}")
        del x1, w2, x2, w1, w3
        torch.cuda.empty_cache()
    if "decode" in parts:
        o = decode_run()
        log(f"compare {tree} decode: host {o['host']:.3f} ms/step, device "
            f"{o['device']:.3f}, K6 {o['k6']:.4f} ms/step")
    if "stem" in parts:
        stem_compare(tree, rnd)
    if "dgc" in parts:
        dgc_compare(tree, failures)
    if "static" in parts:
        o = static_run(failures)
        log(f"compare {tree} static: step {o['host_ms']:.3f} ms (host, "
            f"mean of 5), device {o['profile']['device']:.3f} ms per step, "
            f"{o['profile']['kernels']:.1f} kernels per step")
    for f in failures:
        log(f"compare {tree} FAIL: {f}")
    return 1 if failures else 0


def ln_compare(tree, rnd):
    """`compare`'s ln part: the tree's `_launch_bwd` (K5 and whatever the
    tree's wrapper launches beside it) at the train step's [24576, 768]
    bf16, inputs in L2 and L2 flushed."""
    import torch

    from paddle_tpu_torch.kernels import layer_norm as LN

    x, dy = rnd((24576, 768), torch.bfloat16), rnd((24576, 768),
                                                  torch.bfloat16)
    g = rnd((768,), torch.bfloat16)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    ms = time_ms(lambda: LN._launch_bwd(x, g, dy, 1e-5))
    cold = time_ms(lambda: LN._launch_bwd(x, g, dy, 1e-5), flush=flush)
    log(f"compare {tree} ln: K5 [24576, 768] bf16 {ms:.4f} ms, L2 flushed "
        f"{cold:.4f} ms")


def stem_compare(tree, rnd):
    """`compare`'s stem part: K9 forward and backward at the stem (bf16
    batch 128, random) with the backward's plan where the tree has one."""
    import torch

    from paddle_tpu_torch.kernels import fused_bottleneck as FB

    c, aff, dy = stem_inputs(rnd, (128, 112, 112, 64), torch.bfloat16, False)
    timed = k9_times(c, aff, dy)
    plan = (stem_text(FB.stem_plan(c.shape, c.dtype))
            if hasattr(FB, "stem_plan") else "no plan")
    log(f"compare {tree} stem: K9 fwd {timed['fwd_ms']:.4f} ms, bwd "
        f"{timed['bwd_ms']:.4f} ms (bound {timed['bwd_bound_ms']:.4f}, "
        f"library {timed['library_bwd_ms']:.4f}); {plan}")


def dgc_compare(tree, failures):
    """`compare`'s dgc part: the DGC ResNet-50 step with K10 (phase 5's
    `dgc_run`: host ms, device ms and K10's share from its profile), then
    K10 at the largest tensor and over the step's 161 v tensors."""
    from paddle_tpu_torch.distributed import env

    env.init_parallel_env()
    try:
        _, host_ms, step, prof = dgc_run("k10", failures)
        state_v = step._state[1]
        largest = max(state_v.values(), key=lambda t: t.numel())
        timed = k10_times(largest, state_v)
        log(f"compare {tree} dgc: K10 [{K10_LARGEST}] {timed['ms']:.4f} ms, "
            f"the 161 tensors {timed['step_ms']:.4f} ms; DGC step with K10 "
            f"host {host_ms:.3f} ms, device {prof['device']:.3f} ms, K10 "
            f"{prof.get('K10', 0):.4f} ms per step")
    finally:
        env.destroy_parallel_env()


def compare_main(args):
    """`python3 chip_smoke.py compare [--parts P,...] TREE [TREE ...]`:
    the trees (each a directory holding a paddle_tpu_torch package: this
    checkout's `.`, an unpacked parent commit) in the order given, each
    in a process of its own, so that two versions are timed in turns on
    one card (parent, change, change, parent); `parts` of
    COMPARE_PARTS, all by default."""
    parts = ",".join(COMPARE_PARTS)
    if args[:1] == ["--parts"]:
        parts, args = args[1], args[2:]
    unknown = set(parts.split(",")) - set(COMPARE_PARTS)
    if unknown or not args:
        print(f"chip_smoke compare: parts {sorted(unknown)} not in "
              f"{COMPARE_PARTS}, or no tree", file=sys.stderr)
        return 2
    log(f"card: {card_line()}")
    rc = 0
    for tree in args:
        rc |= subprocess.run([sys.executable, __file__, "compare-one",
                              tree, parts]).returncode
    return rc


# the phases whose timed runs are the main paths: their launch counts go
# into the kernels line
MAIN_PATHS = ("train", "resnet", "path", "static", "io")


def main():
    if sys.argv[1:2] == ["compare"]:
        return compare_main(sys.argv[2:])
    if sys.argv[1:2] == ["compare-one"]:
        return compare_one(sys.argv[2], sys.argv[3].split(","))
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
    phases = (("sass", sass_phase), ("kernels", kernel_phase),
              ("probes", probes_phase),
              ("train", train_phase),
              ("resnet", resnet_phase), ("dgc", dgc_phase),
              ("path", path_phase), ("static", static_phase),
              ("io", io_phase), ("checks", check_phase))
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
                "flash_attention_bwd_dkv", "flash_attention_fwd:float16",
                "flash_attention_bwd_dq:float16",
                "flash_attention_bwd_dkv:float16", "layer_norm_fwd",
                "layer_norm_bwd", "flash_decode", "fused_bottleneck_fwd",
                "fused_bottleneck_bwd", "fused_bottleneck_down_fwd",
                "fused_bottleneck_down_bwd", "fused_stem_tail_fwd",
                "fused_stem_tail_bwd"):
        row = dict(rows[key])
        # launches on the main paths: the 5 timed GPT train steps, the 5
        # timed steps of each fused ResNet-50 run (full and `id`), the
        # serving run (generate + engine), the timed steps of each static
        # GPT run, plain, AMP + fusion (K1-K5), clipped (K4, K5) and AMP
        # float16 + fusion (K1-K3 float16, K4, K5), the io phase's
        # Predictor and CompiledPredictor runs (K1, K4), and the probe
        # tool's runs (K4, K7 and K9 forward)
        row["launches"] = sum(results[p].get(key, 0)
                              for p in MAIN_PATHS) \
            + results["probes"]["tool"].get(key, 0)
        kernels.append(row)
    # K10: the 3 timed DGC steps of ResNet-50 with the flag on
    kernels.append(dict(results["dgc"]["row"], launches=results["dgc"][
        "launches"].get("topk_threshold", 0)))
    # P1, P2: their probes' runs in the port's probe tool
    for key in ("probe_conv3x3", "probe_matmuls"):
        kernels.append(dict(results["probes"]["rows"][key],
                            launches=results["probes"]["tool"].get(key, 0)))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
