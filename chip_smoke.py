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
7c. The rest of the model zoo and recompute (`zoo_phase`):
   BERT-base pretraining at full width (`BertForPretraining(
   bert_base_config(dtype="bfloat16"))`: vocab 30522, hidden 768, 12
   layers, FFN 3072), batch 32 x 512, AdamW(1e-4), default dropout 0.1,
   token types and an all-ones attention mask: one warm-up and 3 timed
   steps, each launching K4 and K5 exactly 26 times (every LayerNorm;
   the mask and the dropout keep attention eager, as on the reference's
   TPU); host and device ms, kernels per step, peak memory, samples/s;
   then its eval forward (`make_eval_step`) without a mask (K1 exactly
   12 times, K4 26) and with the mask (no K1); K4 and K5 at BERT's
   epsilon 1e-12 (rows of variance 1e-8) against their plain versions.
   BERT at full width, depth 2, f32, seq 128, batch 2, no dropout and no
   mask (K1-K5): first-step grads and 3 AdamW steps, card vs CPU, at the
   train check's tolerances.  SE-ResNeXt-50 32x4d, NCHW bf16, batch 64 x
   224^2, Momentum(0.1, 0.9): 3 timed steps (no kernel of the port:
   grouped convs are cuDNN's); f32 at depths (1, 1, 1, 1), 64^2, batch
   4, 2 steps card vs CPU at the ResNet check's tolerances.  Recompute:
   ResNet-50 bf16 NHWC batch 128 unfused with remat False, True and
   "conv_outs" (step ms, peak memory; "conv_outs" must peak below
   False); the ResNet check's f32 net, unfused and full fused, with
   "conv_outs" against False on the card; the static GPT with
   `RecomputeOptimizer(Adam)` (checkpoints at the embedding's and the
   block's outputs) against plain Adam, 3 steps, peak memory of each.
   Beam search on GPT-2 small bf16, batch 4, beam 4, prompt 128, 32 new
   tokens: ms per token step, K1 x12, K4 x25 per prefill or step, K6
   x12 per step exactly, device ms and K6's share; beam 1 against
   `generate()` (the engine check's near-tie rule); f32 at depth 2, 8
   tokens, card vs CPU (sequences equal unless the CPU's K-th/(K+1)-th
   candidate gap is <= 1e-3 relative, scores 1e-4).  LeNet, MLP,
   Word2Vec, Wide&Deep and Seq2Seq, f32: 2 steps card vs CPU, losses
   1e-4 relative; Seq2Seq's greedy and beam decodes token-equal.
7d. Expert and sequence parallelism (`moe_phase`): bench.py's GPT
   (vocab 32768, hidden 768, 12 layers, 12 heads, seq 512, bf16) with 8
   experts, top-2, capacity 1.25, aux 0.01 (`MOE_TRAIN`) through
   `make_train_step(model, AdamW(1e-4))` at batch 16 x 512: one warm-up
   and 3 timed steps, each launching K1-K3 x12 and K4, K5 x25 exactly;
   host and device ms, tokens/s, peak memory, the (token, choice) pairs
   that capacity dropped per layer and the profile's f32 GEMM share.
   GPT-2 small widths with 8 experts, bf16: generate() on 4 prompts of
   256 with 128 new (K1 x12, K4 x25 per prefill; K6 x12, K4 x25 per
   decode step, exactly), the engine over 16 requests (8 slots, max_len
   1024, buckets 128/256/512), beam search at beam 4 (batch 4, prompt
   128, 32 new), tokens/s, ms per decode step and K6's share.  The ring
   loop with the in-process hop over 4 shards at [4, 12, 4 x 512, 64]
   bf16, causal and not (K1, K2, K3 once per past or diagonal block):
   output and dq/dk/dv against K1-K3 on the whole sequence and against
   the ring's composition at bf16's rule scaled to each tensor
   (compare_scaled), its device ms beside K1's.
   f32 checks: the MoE GPT at full width, depth 2, batch 2 x 256, first
   grads and 3 AdamW steps card vs CPU at the train check's tolerances
   (a routing choice that differs fails), greedy tokens card vs CPU
   and engine vs generate() (the top-2 margin rule).  On a one-rank
   NCCL group: ring_attention at sp = 1 against K1, sharded_moe_ffn and
   moe_ffn_shardmap at ep = 1 against moe_ffn, and one
   make_sharded_train_step(dp=1, ep=1) step against make_train_step.
7e. Tensor and pipeline parallelism (`parallel_phase`) at bench.py's GPT
   widths (vocab 32768, hidden 768, 12 layers, 12 heads, seq 512, bf16,
   AdamW(1e-4), batch 16 x 512), W > 1 in one process: both ranks'
   shards on the card, a thread a rank, the collectives in memory
   (`inprocess.local_meshes`), through the same shard and schedule code
   as the multi-process path.  (a) make_sharded_train_step at tp = 2
   (K1-K3 on each rank's [16, 6, 512, 64] local heads): the first
   step's loss (compare_scaled) and every rank's grads against the
   unsharded step's, held as each one's relative error against the f32
   grads of the same weights (at most 1.5x the unsharded bf16 step's;
   a key bias, 0 in exact arithmetic, near 0), every rank's params
   after the first update against make_train_step's (`_hold_update`),
   the second step's loss against make_train_step's, then 3 timed
   steps (host ms, tokens/s, peak memory, one profiled step) launching
   exactly K1-K3 x24 and K4, K5 x50 each.  (b) build_gpt_pipeline at
   pp = 2 with 4 microbatches, each stage recomputed in the backward,
   then the interleaved schedule at V = 2 (4 chunks of 3 blocks): loss
   and every grad against the unpipelined model's by the same rule,
   every rank's params after one AdamW update against
   make_train_step's, 3 timed steps (forward, backward, AdamW)
   launching exactly K1 x96, K2, K3 x48, K4 x194 and K5 x98 each.  (c)
   On a one-rank NCCL group: the sharded step with zero1,
   fsdp_rules(), accum_steps=2 and a global-norm clip, and
   build_gpt_pipeline at pp = 1, each bitwise make_train_step's
   (losses, params, moments; loss and grads).  At dp = 1 ZeRO-1 and
   FSDP split nothing: (c) holds the step's plumbing, accumulation and
   the clip; (e) runs them split.  (d) f32 at full width, depth 2,
   batch 2 x 256: the tp = 2 step and the pp = 2 pipeline take 3 AdamW
   steps on the card and on the CPU, held to train_check's tolerances.
   (e) ZeRO-1 and FSDP at dp = 2 in one process, depth 2, batch 4 x
   512, accum_steps=2 and an engaged global-norm clip: zero1=True
   bitwise the replicated step, fsdp_rules() (every param's dim 0 over
   dp) the replicated step's first loss bitwise and its updates by
   `_hold_update`, the replicated step's first update against
   make_train_step's on the whole batch by the same rule.
7f. The static Executor's data-parallel tier, the static DGC optimizer
   and the parameter server's data plane (`collective_phase`).  (a) The
   static GPT of phase 7 (`build_gpt(512, 768, 12, 32768)`, batch 8 of
   `static_feed`, Adam(1e-3), FLAGS_amp and FLAGS_graph_opt_fuse on, so
   K1-K5 run) through `CompiledProgram(main).with_data_parallel()` on a
   one-rank NCCL group (W = 1) and with places=2 (two ranks in this
   process, 4 rows each), against the plain Executor.run from the same
   startup: first losses (the mean of the fetch) within 3e-2 and first
   updates within 0.1 in norm of the plain run's, each timed step
   launching exactly W x the plain step's K1-K5, the buckets of
   `last_sync_stats()` ceil(grad bytes / FLAGS_dp_bucket_bytes) per
   dtype, and FLAGS_dp_bucket_bytes=0 giving a W = 2 step bitwise the
   bucketed one; host and device ms, tokens/s, peak memory, collectives
   and bucket bytes per step.  (b) The f32 static GPT at zoo size
   (`build_gpt(128, 768, 12, 1024)`, batch 4) with DGCMomentumOptimizer
   (rampup at step 1, sparsity [0.75, 0.99], a local clip norm), 3 steps
   at W = 2 in one process, card against CPU: losses, params, U, V and
   velocities by the f32 static checks' rules, the step-1 masks exact
   but for named near-ties (`_hold_static_dgc_masks`).  (c) A Downpour
   CTR loop: Wide&Deep at bench.py's CTR widths (26 slots over 1e6 ids,
   13 dense, batch 8192) with its 8-wide embedding transpiled onto two
   PSServers on localhost threads (`ShardedPSClient`), the dense step on
   the card: 20 pull -> step -> push steps, every pull bitwise an
   in-process table's, the loss falling; pull, H2D, device, D2H and push
   ms per step.
7g. The GSPMD runtime tier and the static analysis tier (`spmd_phase`).
   (a) The static GPT of phase 7 (`build_gpt(512, 768, 12, 32768)`,
   batch 8 of `static_feed`, Adam(1e-3), FLAGS_amp and
   FLAGS_graph_opt_fuse on) under its default Megatron rules with
   `with_sharding_rules(..., execute=True)` as four ranks in this
   process {dp=2, mp=2}, and as {dp=1, mp=2}, against the plain
   Executor.run and `with_data_parallel(places=2)` from the same
   startup and feeds: 3 losses within 3e-2 and first updates within 0.1
   in norm of the plain run's (the key bias left out); each rank's
   fc_0-fc_5 and embedding blocks and their Adam moments of the plan's
   shapes; the executed all-reduces and bytes equal to the plan's
   `collective_table()`; K1-K3 on 6 heads a rank; each timed step
   launching exactly what the plan's fused ops imply (ranks x K1-K3 per
   fused attention, ranks x K4/K5 per fused LayerNorm); host and device
   ms, tokens/s, peak memory, each rank's state bytes against the
   plan's, and the collectives and bytes a step.  (b) The reference's
   five pillars (bench.py's tp_runtime_smoke) on zoo BERT in f32,
   {dp=2, mp=2}, 3 steps, card and CPU: losses allclose to the dp-only
   run and to the CPU's (rtol 2e-3, atol 2e-5), executed collectives
   equal to the plan's, each sharded leaf's blocks 1/mp of it, each
   rank's resident state within 25% of the plan's per-shard figure and
   below the dp run's, and the TP checkpoint restored bitwise onto a
   {dp=4} run.  (c) FLAGS_static_check=error over the eight zoo models
   under their default rules on their AMP + fused substitutes, one
   step each on the card, none raising; `python -m
   paddle_tpu_torch.tools.program_lint --all-models --sharding-rules
   default` exiting 0.
7h. The hardened serving tier (`serving_phase`): (a) `ServingRuntime`
   over the saved fused bf16 static GPT of phase 7b, buckets 1/2/4/8, 64
   requests of 1-3 rows from 4 client threads: each result bitwise
   equal to `Predictor.run` at the bucket it rode (read from its
   trace) and within `compare_scaled` of an unbatched run (the largest
   difference printed); p50/p99, batches per bucket, host and device ms
   per batch; requests == sum of outcomes, one `serving.bucket_compile`
   per bucket, K1 and K4 launched.  (b) The hardened `DecodeEngine` on
   GPT-2 small bf16 (8 slots, max_len 1024, buckets 128/256/512) over
   phase 6's 16 requests against `generate()` (the engine check's
   near-tie rule at bf16's 2^-6), tokens/s and host ms per dispatch,
   the dispatch thread's cost (`_dispatch_costs`); a transient at
   `decode.step` retried with the tokens unchanged, a per-token budget
   expired by a slowed step, a stall giving `stalled`, a broken engine
   and a flight dump naming the request, a threshold-1 breaker failing
   fast; requests == sum of outcomes each time, K6 launched.  (c) A
   `ModelRegistry` -> two `ReplicaServer`s -> `FleetRouter` fleet on the
   card: the second replica imports the first's `.pt2` cache with 0
   warm-ups, 32 requests with v2 rolled out mid-stream and 0 dropped,
   one replica killed and its traffic failed over, the fleet ledger's
   requests == sum of outcomes.
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
per step, kernels per step; trees that have the static path); `bert`,
the BERT-base pretraining step of phase 7c (host and device ms, K4 and
K5 ms and launches per step); `beam`, phase 7c's beam search (ms per
token step, device ms and K6's share; `bert` and `beam` on trees that
have the zoo): two versions compared in turns on one card.

The last lines are the kernels' JSON line (18 rows: K1-K10, K1-K3 in
float16, K7, K8 and K9 as two rows each, P1, P2; every row with its
launches summed over the GPT train, the two fused ResNet runs, the
serving paths, the timed steps of the static GPT's four runs (plain,
AMP + fusion, clipped, AMP float16 + fusion), the io phase's Predictor
and CompiledPredictor runs, the zoo phase's timed BERT steps, its
unmasked eval forward and its timed beam search, the moe phase's MoE
train steps, MoE serving runs and ring runs, the parallel phase's timed
tp = 2, pp = 2 and V = 2 steps, the collective phase's timed W = 1 and
W = 2 data-parallel steps, the serving phase's runtime, engines and
fleet, and the probe tool's runs, K10's over
the DGC run with K10, P1's and P2's over the probe tool's), the card
line and {"ok": true, "device": {...}}.
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


def compare_scaled(name, got, want, failures, frac=2.0 ** -6,
                   rel=2.0 ** -7):
    """bf16's rule scaled to the tensor, so that it stays tight where the
    values are small: max |got - want| <= frac x max |want| (2 to 4 bf16
    ulps of the largest value) and relative Frobenius error <= rel (a
    few bf16 roundings, each about 2^-9 / sqrt(3)).  Returns (max abs
    err, its limit, relative Frobenius err)."""
    import torch

    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    tol = frac * w.abs().max().item()
    rerr = rel_err(got, want)
    if not (err <= tol and rerr <= rel and bool(torch.isfinite(g).all())):
        failures.append(f"{name}: max_abs_err {err:.3e} (limit {frac:g} x "
                        f"max |want| = {tol:.3e}), relative Frobenius err "
                        f"{rerr:.3e} (limit {rel:g})")
    return err, tol, rerr


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
    the CPU (plain versions) from the same weights; the card's run again
    under remat="conv_outs" (the grads through its tape), held to the
    same rules against the CPU's plain run.

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
    from paddle_tpu_torch.models.remat import ConvOutsTape
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
    for dev, remat in (("cuda", False), ("cuda", "conv_outs"),
                       ("cpu", False)):
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
        with (ConvOutsTape().recording() if remat
              else contextlib.nullcontext()):
            loss, _ = functional_call_with_state(
                model, params, dict(model.named_buffers()), xt, yt,
                _method=loss_fn)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        grads = {n: g.cpu() for n, g in zip(names, grads)}
        opt = Momentum(lr, 0.9)
        state = init_train_state(model, opt)
        step = make_train_step(model, opt, loss_fn=loss_fn, remat=remat)
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
        runs[dev, remat] = dict(
            grads=grads, losses=losses, start=start,
            params={n: p.detach().cpu() for n, p in state.params.items()},
            buffers={n: b.cpu() for n, b in state.buffers.items()})
    card, cpu = runs["cuda", False], runs["cpu", False]
    # the card's step under remat="conv_outs" (K7, K8, K9 kept whole, the
    # rest replayed by the tape) against the CPU's plain step
    _hold_resnet_rules("f32 ResNet check, remat='conv_outs'",
                       runs["cuda", "conv_outs"], cpu, failures,
                       names=("card conv_outs", "CPU False"))
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


# ---------------------------------------------------------------------------
# phase 7c: the rest of the model zoo and recompute
# ---------------------------------------------------------------------------

# BERT-base pretraining (`BertForPretraining(bert_base_config(dtype=
# "bfloat16"))`): every LayerNorm (2 per encoder layer, the embeddings',
# the MLM transform's) is K4 forward and K5 backward; the all-ones
# attention mask of a pretraining batch (and the default dropout) keeps
# attention on the eager path, as the reference's on the TPU
ZOO_BERT_BATCH, ZOO_BERT_SEQ = 32, 512
ZOO_BERT_LAUNCHES = {"layer_norm_fwd": 26, "layer_norm_bwd": 26}
# its eval forward without a mask: K1 in each of the 12 layers
ZOO_BERT_EVAL_LAUNCHES = {"flash_attention_fwd": 12, "layer_norm_fwd": 26}
ZOO_BERT_EVAL_MASKED = {"layer_norm_fwd": 26}
ZOO_SE_BATCH = 64
ZOO_REMAT_BATCH = 128
# beam search on GPT-2 small (phase 6's serving model): batch 4, beam 4,
# prompt 128, 32 new tokens; K1 and K4 in the prefill, K4 and K6 in each
# of the 31 decode steps over B * beam rows
ZOO_BEAM = dict(batch=4, beam=4, prompt=128, new=32)
ZOO_BEAM_LAUNCHES = {"flash_attention_fwd": 12, "layer_norm_fwd": 25 * 32,
                     "flash_decode": 12 * 31}


def zoo_phase(failures):
    """The rest of the model zoo and recompute (see the module docstring,
    phase 7c).  Returns the launches of its main paths: the timed BERT
    train steps, the BERT eval forwards and the timed beam search."""
    import collections

    launches = collections.Counter()
    bert = zoo_bert_run(failures)
    launches.update(bert["launches"])
    launches.update(zoo_bert_eval(failures, bert.pop("model")))
    zoo_ln_eps_check(failures)
    zoo_bert_check(failures)
    zoo_se_resnext_run(failures)
    zoo_se_resnext_check(failures)
    zoo_remat_runs(failures)
    zoo_remat_check(failures)
    zoo_static_recompute(failures)
    beam = zoo_beam_run(failures)
    launches.update(beam["launches"])
    zoo_beam_checks(failures, beam.pop("model"))
    zoo_small_checks(failures)
    return dict(launches)


def _bert_batch(cfg, batch, seq, device, seed=0):
    """A pretraining batch: ids uniform over the vocab, 15% of positions
    labelled for the MLM loss, NSP labels, token types (the second half
    segment B) and an all-ones attention mask."""
    import torch

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (batch, seq))
    mlm = np.where(rng.random((batch, seq)) < 0.15, ids, -100)
    nsp = rng.integers(0, 2, (batch,))
    tt = np.repeat((np.arange(seq) >= seq // 2)[None], batch, 0)
    mask = np.ones((batch, seq))
    return tuple(torch.as_tensor(a, dtype=torch.int32, device=device)
                 for a in (ids, mlm, nsp, tt, mask))


def _timed_steps(step, state, batch, steps, label, want, failures):
    """One warm-up and `steps` timed steps; each must launch `want`.
    Returns (state, losses, step ms, launches over the timed steps,
    peak bytes)."""
    import torch

    from paddle_tpu_torch.kernels import backend

    t0 = time.perf_counter()
    state, loss = step(state, *batch)
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
        state, loss = step(state, *batch)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        made = {n: c - before.get(n, 0) for n, c in backend.LAUNCHES.items()}
        made = {n: c for n, c in made.items() if c}
        if want is not None and made != want:
            failures.append(f"{label} step {i} launches {made} != {want}")
    if not all(np.isfinite(losses)):
        failures.append(f"{label} losses not finite: {losses}")
    return (state, losses, step_ms, dict(backend.LAUNCHES),
            torch.cuda.max_memory_allocated())


def zoo_bert_run(failures, steps=3, profile=True):
    """BERT-base pretraining at full width: `BertForPretraining(
    bert_base_config(dtype="bfloat16"))` (vocab 30522, hidden 768, 12
    layers, 12 heads, FFN 3072), batch 32 x 512, `AdamW(1e-4)`, default
    dropout 0.1, token types and an all-ones mask; one warm-up and
    `steps` timed steps of `make_train_step`, each launching K4 and K5 26
    times.  Returns {launches, host_ms, profile, peak, model}."""
    import torch

    from paddle_tpu_torch.models.bert import (
        BertForPretraining, bert_base_config,
    )
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW

    cfg = bert_base_config(dtype="bfloat16")
    t0 = time.perf_counter()
    model = BertForPretraining(cfg, device="cuda",
                               generator=make_generator(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"zoo bert: BERT-base bf16 built in {time.perf_counter() - t0:.1f} "
        f"s, {n_params} parameters, batch {ZOO_BERT_BATCH} x "
        f"{ZOO_BERT_SEQ}, AdamW(1e-4), dropout "
        f"{cfg.hidden_dropout_prob}, all-ones attention mask")
    opt = AdamW(1e-4)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    batch = _bert_batch(cfg, ZOO_BERT_BATCH, ZOO_BERT_SEQ, "cuda")
    state, losses, step_ms, launches, peak = _timed_steps(
        step, state, batch, steps, "zoo bert", ZOO_BERT_LAUNCHES, failures)
    host_ms = sum(step_ms) / steps
    per_step = {n: c / steps for n, c in launches.items()}
    log(f"zoo bert: {steps} steps, step ms {[round(t, 3) for t in step_ms]},"
        f" mean {host_ms:.3f} ms (host clock); samples/s "
        f"{ZOO_BERT_BATCH / (host_ms / 1e3):.1f}, tokens/s "
        f"{ZOO_BERT_BATCH * ZOO_BERT_SEQ / (host_ms / 1e3):.1f}; peak "
        f"memory {peak / 2 ** 30:.3f} GiB; launches per step {per_step}; "
        f"losses {losses}")
    prof = None
    if profile:
        prof = profile_train_step(step, state, batch, host_ms,
                                  label="zoo bert",
                                  families=STATIC_FAMILIES_MORE)
        log(f"zoo bert step: {prof['kernels']:g} kernels, "
            f"{len(prof['ln_bwd'])} LayerNorm backwards, kernels each "
            f"{sorted({len(k) for k in prof['ln_bwd']})}")
    del state, step
    torch.cuda.empty_cache()
    return dict(launches=launches, host_ms=host_ms, profile=prof, peak=peak,
                model=model)


def zoo_bert_eval(failures, model):
    """`make_eval_step` of zoo_bert_run's model: the forward without a mask
    (K1 in each layer, K4 at each LayerNorm) and with the all-ones mask
    (no K1: the eager attention), once each after a warm-up.  Returns
    the unmasked forward's launches."""
    import torch

    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models.train import make_eval_step
    from paddle_tpu_torch.nn import buffer_dict, param_dict

    cfg = model.bert.cfg
    ids, _, _, tt, mask = _bert_batch(cfg, ZOO_BERT_BATCH, ZOO_BERT_SEQ,
                                      "cuda", seed=1)
    ev = make_eval_step(model)
    params, bufs = param_dict(model), buffer_dict(model)
    out = {}
    for label, args, want in (
            ("unmasked", (ids, tt), ZOO_BERT_EVAL_LAUNCHES),
            ("masked", (ids, tt, mask), ZOO_BERT_EVAL_MASKED)):
        ev(params, bufs, *args)
        torch.cuda.synchronize()
        backend.reset_launches()
        t0 = time.perf_counter()
        logits, nsp = ev(params, bufs, *args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        made = {n: c for n, c in backend.LAUNCHES.items() if c}
        log(f"zoo bert eval forward {label}: {ms:.3f} ms (host), launches "
            f"{made}, logits {tuple(logits.shape)}")
        if made != want:
            failures.append(f"zoo bert eval {label} launches {made} != "
                            f"{want}")
        if not bool(torch.isfinite(logits.float()).all()):
            failures.append(f"zoo bert eval {label}: logits not finite")
        out[label] = made
    del model
    torch.cuda.empty_cache()
    return out["unmasked"]


def zoo_ln_eps_check(failures):
    """K4 and K5 take the layer's epsilon: at BERT's 1e-12 on rows of
    variance 1e-8, where 1e-5 would change y by ~40%, the kernels agree
    with their plain versions at 1e-12 and not at 1e-5."""
    import torch

    from paddle_tpu_torch.kernels import layer_norm as LN

    gen = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((4096, 768), generator=gen, device="cuda") * 1e-4
    g = torch.randn((768,), generator=gen, device="cuda")
    b = torch.randn((768,), generator=gen, device="cuda")
    dy = torch.randn((4096, 768), generator=gen, device="cuda")
    y = LN._launch(x, g, b, 1e-12)
    dx = LN._launch_bwd(x, g, dy, 1e-12)[0]
    errs = {}
    for eps in (1e-12, 1e-5):
        errs[eps] = (
            (y - LN.layer_norm_ref(x, g, b, eps)).abs().max().item(),
            (dx - LN.layer_norm_bwd_ref(x, g, dy, eps)[0]).abs().max().item()
            / LN.layer_norm_bwd_ref(x, g, dy, eps)[0].abs().max().item())
    log(f"zoo LayerNorm epsilon: K4 y / K5 dx max err against the plain "
        f"versions at eps 1e-12 {errs[1e-12][0]:.3e} / {errs[1e-12][1]:.3e}"
        f" (relative), at eps 1e-5 {errs[1e-5][0]:.3e} / "
        f"{errs[1e-5][1]:.3e}")
    if not (errs[1e-12][0] <= 1e-4 and errs[1e-12][1] <= 1e-4
            and errs[1e-5][0] > 1e-2):
        failures.append(f"K4/K5 epsilon: {errs}")


def _card_cpu_runs(make, batches, opt_fn, loss_fn=None, grads=True):
    """The same model on the card and on the CPU from the card's initial
    weights (and buffers): the first batch's grads (`grads`), then one
    `make_train_step` step per batch.  Returns {dev: {losses, grads,
    params, buffers, start}}."""
    import torch

    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import (
        functional_call_with_state, load_param_dict,
    )

    runs, start, start_bufs = {}, None, None
    for dev in ("cuda", "cpu"):
        model = make(dev)
        if start is None:
            start = {n: p.detach().cpu().clone()
                     for n, p in model.named_parameters()}
            start_bufs = {n: b.cpu().clone()
                          for n, b in model.named_buffers()}
        else:
            load_param_dict(model, start)
            with torch.no_grad():
                for n, b in model.named_buffers():
                    b.copy_(start_bufs[n])
        fn = loss_fn or (lambda m, *b: m.loss(*b))
        out = {}
        if grads:
            params = dict(model.named_parameters())
            batch = [torch.as_tensor(a, device=dev) for a in batches[0]]
            loss, _ = functional_call_with_state(
                model, params, {n: b.clone() for n, b in
                                model.named_buffers()}, *batch, _method=fn)
            gs = torch.autograd.grad(loss, list(params.values()),
                                     allow_unused=True)
            out["grads"] = {n: (torch.zeros_like(p) if g is None else g).cpu()
                            for (n, p), g in zip(params.items(), gs)}
        opt = opt_fn()
        state = init_train_state(model, opt)
        step = make_train_step(model, opt, loss_fn=fn)
        losses = []
        for b in batches:
            state, loss = step(state, *[torch.as_tensor(a, device=dev)
                                        for a in b])
            losses.append(float(loss))
        out.update(losses=losses,
                   params={n: p.detach().cpu()
                           for n, p in state.params.items()},
                   buffers={n: b.cpu() for n, b in state.buffers.items()},
                   start=start)
        runs[dev] = out
        del model, state, step
    torch.cuda.empty_cache()
    return runs


def _hold_resnet_rules(label, card, cpu, failures, names=("card", "CPU")):
    """resnet_check's tolerances for run `card` against run `cpu`: the
    first loss 1e-4 relative, the rest 1e-3; per tensor ||card - cpu|| <=
    5e-2 max(||cpu||, 1e-2 of the largest) for the first batch's grads and
    for each param's update; buffers 1e-3 relative in norm."""
    first = abs(card["losses"][0] - cpu["losses"][0]) / abs(cpu["losses"][0])
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(card["losses"], cpu["losses"]))
    top = max(g.norm().item() for g in cpu["grads"].values())
    grad_err, grad_n = max((_rel(card["grads"][n], g, 1e-2 * top), n)
                           for n, g in cpu["grads"].items())
    start = cpu["start"]
    upd = {n: p - start[n] for n, p in cpu["params"].items()}
    top_u = max(u.norm().item() for u in upd.values())
    par_err, par_n = max((_rel(card["params"][n] - start[n], u,
                               1e-2 * top_u), n) for n, u in upd.items())
    buf_err = max([_rel(card["buffers"][n], b)
                   for n, b in cpu["buffers"].items()] or [0.0])
    log(f"{label}, {names[0]} vs {names[1]}: losses {names[0]} "
        f"{card['losses']} {names[1]} {cpu['losses']} (rel err first "
        f"{first:.3e}, max {worst:.3e}); "
        f"grads worst {grad_err:.3e} ({grad_n}); updates worst "
        f"{par_err:.3e} ({par_n}); buffers worst {buf_err:.3e}")
    if not (first <= 1e-4 and worst <= 1e-3 and grad_err <= 5e-2
            and par_err <= 5e-2 and buf_err <= 1e-3):
        failures.append(f"{label}: losses {first:.3e} / {worst:.3e}, grads "
                        f"{grad_err:.3e}, updates {par_err:.3e}, buffers "
                        f"{buf_err:.3e}")


def _hold_train_rules(label, card, cpu, lr, failures):
    """train_check's tolerances for run `card` against run `cpu`: losses
    1e-4 relative; first-step grads 1e-3 of each tensor's max |grad|
    (floored at 1e-4 of the largest); params atol 2 lr steps + 1e-5."""
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
    top = max(g.abs().max().item() for g in cpu["grads"].values())
    grad_err, grad_n = max(
        ((card["grads"][n] - g).abs().max().item()
         / max(g.abs().max().item(), 1e-4 * top), n)
        for n, g in cpu["grads"].items())
    atol = 2 * lr * len(cpu["losses"]) + 1e-5
    par_err = max((card["params"][n] - p).abs().max().item()
                  for n, p in cpu["params"].items())
    log(f"{label}, card vs CPU: losses card {card['losses']} CPU "
        f"{cpu['losses']} (max rel err {loss_err:.3e}); first-step grads "
        f"max err / scale {grad_err:.3e} ({grad_n}); params max abs err "
        f"{par_err:.3e} (atol {atol:.1e})")
    if not (loss_err <= 1e-4 and grad_err <= 1e-3 and par_err <= atol):
        failures.append(f"{label}: losses {loss_err:.3e}, grads "
                        f"{grad_err:.3e}, params {par_err:.3e}")


def zoo_bert_check(failures, steps=3, lr=1e-4):
    """BERT at full width (vocab 30522, hidden 768, 12 heads, FFN 3072),
    depth 2, f32, seq 128, batch 2, dropout 0, no mask (so the card runs
    K1-K5): first-step grads and 3 AdamW steps on the card against the
    CPU (plain versions) from the same weights, at train_check's
    tolerances."""
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models.bert import (
        BertForPretraining, bert_base_config,
    )
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW

    cfg = bert_base_config(num_hidden_layers=2, hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0)
    batches = [tuple(t.numpy() for t in _bert_batch(cfg, 2, 128, "cpu",
                                                    seed=s))[:4]
               for s in range(steps)]
    backend.reset_launches()
    runs = _card_cpu_runs(
        lambda dev: BertForPretraining(cfg, device=dev,
                                       generator=make_generator(5)),
        batches, lambda: AdamW(lr))
    made = {n: c for n, c in backend.LAUNCHES.items() if c}
    log(f"zoo bert check launches (card: one grad pass, {steps} steps): "
        f"{made}")
    for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv", "layer_norm_fwd", "layer_norm_bwd"):
        if made.get(k, 0) < 1:
            failures.append(f"zoo bert check: {k} never launched")
    _hold_train_rules(f"f32 BERT check (full width, depth 2, batch 2 x 128,"
                      f" {steps} AdamW({lr}) steps)", runs["cuda"],
                      runs["cpu"], lr, failures)


def _ce_loss(m, x, y):
    from paddle_tpu_torch.nn import functional as F

    return F.cross_entropy(m(x), y)


def zoo_se_resnext_run(failures, steps=3):
    """SE-ResNeXt-50 32x4d (`SEResNeXt()`), NCHW bf16, batch 64 x 3 x 224
    x 224, Momentum(0.1, 0.9): one warm-up and `steps` timed steps.  Its
    grouped convs are cuDNN's and its SE gates eager: no kernel of the
    port launches.  Returns {host_ms, profile, peak}."""
    import torch

    from paddle_tpu_torch.models.resnet import SEResNeXt
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import Momentum

    model = SEResNeXt(dtype="bfloat16", device="cuda",
                      generator=make_generator(0))
    opt = Momentum(0.1, 0.9)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt, loss_fn=_ce_loss)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((ZOO_SE_BATCH, 3, 224, 224)),
                        dtype=torch.bfloat16, device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, (ZOO_SE_BATCH,)),
                        dtype=torch.int32, device="cuda")
    state, losses, step_ms, launches, peak = _timed_steps(
        step, state, (x, y), steps, "zoo se_resnext", {}, failures)
    host_ms = sum(step_ms) / steps
    log(f"zoo se_resnext: SE-ResNeXt-50 32x4d bf16 NCHW, "
        f"{sum(p.numel() for p in model.parameters())} parameters, batch "
        f"{ZOO_SE_BATCH}: step ms {[round(t, 3) for t in step_ms]}, mean "
        f"{host_ms:.3f} ms; images/s {ZOO_SE_BATCH / (host_ms / 1e3):.1f}; "
        f"peak memory {peak / 2 ** 30:.3f} GiB; losses {losses}; launches "
        f"{launches}")
    prof = profile_train_step(step, state, (x, y), host_ms,
                              label="zoo se_resnext",
                              families=(("convs", r"conv|cudnn|xmma|"
                                         r"sm90_|implicit"),))
    del model, state, step
    torch.cuda.empty_cache()
    return dict(host_ms=host_ms, profile=prof, peak=peak)


def zoo_se_resnext_check(failures, steps=2, lr=1e-5):
    """SE-ResNeXt f32 at depths (1, 1, 1, 1), 64 x 64, batch 4: first-step
    grads and 2 Momentum steps, card against CPU, at resnet_check's
    tolerances."""
    from paddle_tpu_torch.models.resnet import SEResNeXt
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import Momentum

    rng = np.random.default_rng(6)
    batches = [(rng.standard_normal((4, 3, 64, 64)).astype(np.float32),
                rng.integers(0, 1000, (4,)).astype(np.int32))] * steps
    runs = _card_cpu_runs(
        lambda dev: SEResNeXt(depths=(1, 1, 1, 1), device=dev,
                              generator=make_generator(6)),
        batches, lambda: Momentum(lr, 0.9), loss_fn=_ce_loss)
    _hold_resnet_rules(f"f32 SE-ResNeXt check (depths (1, 1, 1, 1), batch 4"
                       f" x 64 x 64, {steps} Momentum({lr}) steps)",
                       runs["cuda"], runs["cpu"], failures)


def zoo_remat_runs(failures, steps=2):
    """ResNet-50 bf16 NHWC, batch 128, unfused (bench.py:213's program:
    ghost batch norm over 16, Momentum(0.1, 0.9)) with remat False, True
    and "conv_outs": one warm-up and `steps` timed steps each, their
    step ms and peak memory, and the profile of a False and a
    "conv_outs" step; "conv_outs" must peak below False."""
    import os

    import torch

    from paddle_tpu_torch.models.resnet import resnet50
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import Momentum

    os.environ["PADDLE_TPU_FUSED_SUBSET"] = ""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((ZOO_REMAT_BATCH, 3, 224, 224)),
                        dtype=torch.bfloat16, device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, (ZOO_REMAT_BATCH,)),
                        dtype=torch.int32, device="cuda")
    out = {}
    for remat in (False, True, "conv_outs"):
        model = resnet50(dtype="bfloat16", data_format="NHWC",
                         bn_stats_sample=16, device="cuda",
                         generator=make_generator(0))
        opt = Momentum(0.1, 0.9)
        state = init_train_state(model, opt)
        step = make_train_step(model, opt, loss_fn=_ce_loss, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state, losses, step_ms, _, peak = _timed_steps(
            step, state, (x, y), steps, f"zoo remat={remat!r}", {},
            failures)
        out[remat] = (sum(step_ms) / steps, peak, peak - base, losses)
        if remat is not True:
            # where the tape's time goes: host against device per step
            profile_train_step(step, state, (x, y), out[remat][0],
                               label=f"zoo remat={remat!r}")
        del model, state, step
        torch.cuda.empty_cache()
    log("zoo remat (ResNet-50 bf16 NHWC unfused, batch 128): " + "; ".join(
        f"remat={k!r} step {ms:.3f} ms, peak {pk / 2 ** 30:.3f} GiB "
        f"({act / 2 ** 30:.3f} above the state), losses "
        f"{[round(l, 5) for l in ls]}"
        for k, (ms, pk, act, ls) in out.items()))
    if not out["conv_outs"][1] < out[False][1]:
        failures.append(f"remat='conv_outs' peak {out['conv_outs'][1]} not "
                        f"below remat=False's {out[False][1]}")
    return out


def zoo_remat_check(failures, steps=2, lr=1e-5):
    """resnet_check's shallow f32 ResNet-50 (full widths, depths [2, 2, 2,
    2], NHWC, batch 8 x 128 x 128, ghost batch 4) on the card, unfused
    and on the full fused program (K9, K7, K8: their Functions keep what
    they save): remat="conv_outs" against remat=False, the first step's
    update over -lr (the grads: Momentum starts from zero velocity) and
    2 steps, at resnet_check's tolerances."""
    import os

    import torch

    from paddle_tpu_torch.models.resnet import BottleneckBlock, ResNet
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import load_param_dict, make_generator
    from paddle_tpu_torch.optimizer.functional import Momentum

    os.environ["PADDLE_TPU_FUSED_SUBSET"] = ""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((8, 3, 128, 128)),
                        dtype=torch.float32, device="cuda")
    y = torch.as_tensor(rng.integers(0, 1000, (8,)), dtype=torch.int32,
                        device="cuda")
    for fused in (False, True):
        runs, start = {}, None
        for remat in (False, "conv_outs"):
            model = ResNet(BottleneckBlock, [2, 2, 2, 2], data_format="NHWC",
                           fused=fused, device="cuda",
                           generator=make_generator(3))
            for m in model.modules():
                if hasattr(m, "_stats_sample"):
                    m._stats_sample = 4
            if start is None:
                start = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
            else:
                load_param_dict(model, start)
            opt = Momentum(lr, 0.9)
            state = init_train_state(model, opt)
            step = make_train_step(model, opt, loss_fn=_ce_loss, remat=remat)
            losses, first = [], None
            for i in range(steps):
                state, loss = step(state, x, y)
                losses.append(float(loss))
                if i == 0:
                    first = {n: ((start[n] - p) / lr).cpu()
                             for n, p in state.params.items()}
            runs[remat] = dict(
                losses=losses, grads=first,
                params={n: p.detach().cpu() for n, p in state.params.items()},
                buffers={n: b.cpu() for n, b in state.buffers.items()},
                start={n: p.cpu() for n, p in start.items()})
            del model, state, step
        kind = "full fused" if fused else "unfused"
        _hold_resnet_rules(f"f32 remat on the card, ResNet depths [2, 2, 2, "
                           f"2] {kind}", runs["conv_outs"], runs[False],
                           failures, names=("conv_outs", "False"))
    torch.cuda.empty_cache()


def zoo_static_recompute(failures, steps=3):
    """The static GPT of phase 7 (`build_gpt(512, 768, 12, 32768)`'s
    layers) with `RecomputeOptimizer(Adam(1e-3))`, checkpoints at the
    embedding's and the transformer block's outputs, against the same
    Program with plain Adam: 3 steps at batch 8 from the same startup
    values on the card, losses within 1e-4 relative and each
    persistable within 1e-3 of its norm + (2 lr steps + 1e-5) sqrt(n);
    peak memory of each."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import static_zoo

    t, d, heads, vocab = (STATIC_GPT[k] for k in ("t", "d", "heads",
                                                  "vocab"))

    def build(recompute):
        L = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        with fluid.unique_name.guard():
            with fluid.program_guard(main, startup):
                ids = fluid.data("ids", [None, t], dtype="int64")
                targets = fluid.data("targets", [None, t, 1], dtype="int64")
                emb = L.embedding(ids, size=(vocab, d))
                x = static_zoo._transformer_layer(emb, d, heads, t)
                logits = L.fc(x, vocab, num_flatten_dims=2)
                loss = L.mean(L.softmax_with_cross_entropy(logits, targets))
                opt = fluid.optimizer.Adam(1e-3)
                if recompute:
                    opt = fluid.optimizer.RecomputeOptimizer(opt)
                    opt._set_checkpoints([emb, x])
                opt.minimize(loss)
        return main, startup, loss

    rng = np.random.default_rng(0)
    feed = {"ids": rng.integers(0, vocab, (8, t)),
            "targets": rng.integers(0, vocab, (8, t, 1))}
    start, res = None, {}
    for recompute in (False, True):
        main, startup, loss = build(recompute)
        exe = fluid.Executor()
        scope = fluid.Scope()
        if start is None:
            exe.run(startup, scope=scope)
            start = interop.scope_to_numpy(scope)
        else:
            scope = interop.scope_from_numpy(start, scope, "cuda")
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        backend.reset_launches()
        t0 = time.perf_counter()
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(steps)]
        ms = (time.perf_counter() - t0) * 1e3 / steps
        res[recompute] = dict(losses=losses, ms=ms,
                              peak=torch.cuda.max_memory_allocated(),
                              launches={n: c for n, c in
                                        backend.LAUNCHES.items() if c},
                              scope=interop.scope_to_numpy(scope))
        del exe, scope
        torch.cuda.empty_cache()
    a, b = res[False], res[True]
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                       a["losses"]))
    atol = 2 * 1e-3 * (steps + 1) + 1e-5
    par_err, par_n = max(
        (float(np.linalg.norm(b["scope"][n] - v))
         / (1e-3 * float(np.linalg.norm(v)) + atol * np.sqrt(v.size)), n)
        for n, v in a["scope"].items())
    log(f"zoo static recompute (the static GPT, {steps} Adam steps, batch "
        f"8): losses plain {a['losses']} recompute {b['losses']} (max rel "
        f"err {loss_err:.3e}); persistables worst {par_err:.3f} of the rule "
        f"({par_n}); step ms plain {a['ms']:.3f} recompute {b['ms']:.3f} "
        f"(host); peak memory plain {a['peak'] / 2 ** 30:.3f} GiB, "
        f"recompute {b['peak'] / 2 ** 30:.3f} GiB; launches plain "
        f"{a['launches']} recompute {b['launches']}")
    if not (loss_err <= 1e-4 and par_err <= 1.0):
        failures.append(f"static recompute: losses {loss_err:.3e}, "
                        f"persistables {par_err:.3f} of the rule")


def zoo_beam_run(failures, profile=True):
    """Beam search on GPT-2 small (phase 6's serving model, bf16): batch
    4, beam 4, prompt 128, 32 new tokens; a warm-up, then one timed run
    launching ZOO_BEAM_LAUNCHES exactly.  Returns {launches, ms per token
    step, profile}."""
    import torch

    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import generate as G
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import make_generator

    cfg = GPTConfig(dtype="bfloat16")
    model = GPT(cfg, device="cuda", generator=make_generator(0)).eval()
    b, k, s, new = (ZOO_BEAM[n] for n in ("batch", "beam", "prompt", "new"))
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)
    G.beam_search(model, prompts, k, 4)
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    seqs, scores = G.beam_search(model, prompts, k, new)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = {n: c for n, c in backend.LAUNCHES.items() if c}
    step_ms = total_ms / new
    log(f"zoo beam search (GPT-2 small bf16, batch {b}, beam {k}, prompt "
        f"{s}, {new} new): {total_ms:.3f} ms, {step_ms:.3f} ms per token "
        f"step (prefill included), {b * new / (total_ms / 1e3):.1f} best-"
        f"beam tokens/s; launches {launches}; best scores "
        f"{scores[:, 0].tolist()}")
    if launches != ZOO_BEAM_LAUNCHES:
        failures.append(f"zoo beam launches {launches} != "
                        f"{ZOO_BEAM_LAUNCHES}")
    if tuple(seqs.shape) != (b, k, new) or int(seqs.min()) < 0 \
            or int(seqs.max()) >= cfg.vocab_size \
            or not bool(torch.isfinite(scores).all()) \
            or not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        failures.append(f"zoo beam output {tuple(seqs.shape)} out of range,"
                        " not finite or not sorted")
    prof = beam_profile(model, prompts, k, new) if profile else None
    return dict(launches=launches, step_ms=step_ms, profile=prof,
                model=model)


def beam_profile(model, prompts, beam, new):
    """Device ms of one beam search and K6's share (torch.profiler),
    per token step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import generate as G

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        G.beam_search(model, prompts, beam, new)
        torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device = sum(r[0] for r in rows) / 1e3 / new
    k6 = sum(r[0] for r in rows if "flash_decode_kernel" in r[2]) / 1e3 / new
    log(f"zoo beam profile: device {device:.3f} ms per token step, K6 "
        f"{k6:.4f} ms ({k6 / device:.1%})")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        log(f"  {us / 1e3 / new:8.4f} ms/step  {count / new:6.1f}/step  "
            f"{key[:90]}")
    return {"device": device, "k6": k6}


def _beam_margin(params, prompts, beam, new):
    """The smallest relative gap, over the steps of a CPU beam search,
    between the K-th and the (K+1)-th candidate: a near-tie there may
    pick another beam on another device."""
    import torch

    from paddle_tpu_torch.models import generate as G

    gaps = []
    real = G._beam_update

    def watch(logp, finished, logits, eos_id):
        total = logp[..., None] + torch.log_softmax(logits.float(), dim=-1)
        v = torch.sort(total.reshape(total.shape[0], -1), dim=-1,
                       descending=True).values
        gaps.append(((v[:, beam - 1] - v[:, beam])
                     / v[:, beam - 1].abs().clamp(min=1e-6)).min().item())
        return real(logp, finished, logits, eos_id)

    G._beam_update = watch
    try:
        G.beam_search(params, prompts, beam, new)
    finally:
        G._beam_update = real
    return min(gaps)


def zoo_beam_checks(failures, model):
    """Beam 1 against `generate()`'s greedy tokens on zoo_beam_run's model
    (bf16), and an f32 GPT-2-small-width model at depth 2: 8 tokens, beam
    4, batch 2, card against CPU.  Tokens must agree unless a near-tie
    (relative top-2 margin <= 1e-3; for the beams, between the K-th and
    the (K+1)-th candidate) explains the first difference; scores 1e-4
    relative."""
    import torch

    from paddle_tpu_torch.models import generate as G
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import load_param_dict, make_generator

    prompts = np.random.default_rng(8).integers(
        0, model.cfg.vocab_size, (2, 128), dtype=np.int32)
    beam1, _ = G.beam_search(model, prompts, 1, 16)
    greedy = G.generate(model, prompts, 16)
    same = torch.equal(beam1[:, 0], greedy)
    log(f"zoo beam 1 vs generate() (bf16, 2 x 128, 16 new): "
        f"{'token-exact' if same else 'differ'}")
    if not same:
        row = int(torch.nonzero((beam1[:, 0] != greedy).any(1))[0])
        i = int(torch.nonzero(beam1[row, 0] != greedy[row])[0])
        params = G.build_decode_params(model)
        with torch.inference_mode():
            cache = G.init_cache(params.cfg, 1, 128 + 16, device="cuda")
            logits = G.prefill(params, torch.as_tensor(
                prompts[row:row + 1], device="cuda"), cache)
            for j in range(i):
                logits = G.decode_step(params, greedy[row, j:j + 1], cache,
                                       128 + j)
        margin = _margin(logits[0])
        log(f"zoo beam 1 vs generate(): row {row} first differs at step "
            f"{i}, generate()'s top-2 margin {margin:.3e}")
        if margin > 1e-3:
            failures.append(f"beam 1 != greedy at step {i} with margin "
                            f"{margin:.3e} > 1e-3")
    del model
    torch.cuda.empty_cache()

    cfg = GPTConfig(num_layers=2)
    card = GPT(cfg, device="cuda", generator=make_generator(9)).eval()
    cpu = GPT(cfg, device="cpu", generator=make_generator(9)).eval()
    load_param_dict(cpu, {n: p.detach().cpu()
                          for n, p in card.named_parameters()})
    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 128),
                                                dtype=np.int32)
    cseq, csc = G.beam_search(card, prompts, 4, 8)
    tseq, tsc = G.beam_search(cpu, prompts, 4, 8)
    same = torch.equal(cseq.cpu(), tseq)
    score_err = ((csc.cpu() - tsc).abs() / tsc.abs()).max().item()
    log(f"zoo beam f32 (depth 2, 2 x 128, beam 4, 8 new), card vs CPU: "
        f"sequences {'equal' if same else 'differ'}, scores max rel err "
        f"{score_err:.3e}")
    if not same:
        margin = _beam_margin(G.build_decode_params(cpu), prompts, 4, 8)
        log(f"zoo beam f32: the CPU run's smallest K-th/(K+1)-th candidate "
            f"gap {margin:.3e}")
        if margin > 1e-3:
            failures.append(f"f32 beam search card != CPU with candidate "
                            f"gap {margin:.3e} > 1e-3")
    elif not score_err <= 1e-4:
        failures.append(f"f32 beam scores differ: {score_err:.3e} > 1e-4")
    del card, cpu
    torch.cuda.empty_cache()


def zoo_small_checks(failures, steps=2):
    """LeNet, MLP, Word2Vec, Wide&Deep and Seq2Seq, f32, at the reference
    tests' sizes: 2 train steps each on the card and on the CPU from the
    same weights, losses within 1e-4 relative; Seq2Seq's greedy and beam
    decodes token-equal."""
    import torch

    from paddle_tpu_torch.models.lenet import LeNet
    from paddle_tpu_torch.models.mlp import MLP
    from paddle_tpu_torch.models.seq2seq import Seq2Seq, Seq2SeqConfig
    from paddle_tpu_torch.models.wide_deep import WideDeep
    from paddle_tpu_torch.models.word2vec import Word2Vec
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import Momentum

    rng = np.random.default_rng(10)
    s2s_cfg = Seq2SeqConfig()
    src = rng.integers(2, s2s_cfg.src_vocab, (4, 12)).astype(np.int32)
    tgt = rng.integers(2, s2s_cfg.tgt_vocab, (4, 9)).astype(np.int32)
    src_len = np.array([12, 9, 5, 1], np.int32)
    cases = {
        "lenet": (lambda d: LeNet(device=d, generator=make_generator(1)),
                  _ce_loss,
                  (rng.standard_normal((8, 1, 28, 28)).astype(np.float32),
                   rng.integers(0, 10, (8,)).astype(np.int32))),
        "mlp": (lambda d: MLP(784, device=d, generator=make_generator(2)),
                _ce_loss,
                (rng.standard_normal((16, 784)).astype(np.float32),
                 rng.integers(0, 10, (16,)).astype(np.int32))),
        "word2vec": (lambda d: Word2Vec(1000, device=d,
                                        generator=make_generator(3)), None,
                     (rng.integers(0, 1000, (16, 4)).astype(np.int32),
                      rng.integers(0, 1000, (16,)).astype(np.int32))),
        "wide_deep": (lambda d: WideDeep(device=d,
                                         generator=make_generator(4)), None,
                      (rng.integers(-2 ** 31, 2 ** 31 - 1, (16, 26),
                                    dtype=np.int64).astype(np.int32),
                       rng.standard_normal((16, 13)).astype(np.float32),
                       rng.integers(0, 2, (16,)).astype(np.float32))),
        "seq2seq": (lambda d: Seq2Seq(s2s_cfg, device=d,
                                      generator=make_generator(5)), None,
                    (src, tgt[:, :-1], tgt[:, 1:], src_len)),
    }
    for name, (make, loss_fn, batch) in cases.items():
        runs = _card_cpu_runs(make, [batch] * steps,
                              lambda: Momentum(0.05, 0.9), loss_fn=loss_fn,
                              grads=False)
        card, cpu = runs["cuda"]["losses"], runs["cpu"]["losses"]
        err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        log(f"zoo {name} f32, card vs CPU: losses card {card} CPU {cpu} "
            f"(max rel err {err:.3e})")
        if not err <= 1e-4:
            failures.append(f"zoo {name}: losses differ by {err:.3e}")
    models = {d: Seq2Seq(s2s_cfg, device=d, generator=make_generator(5))
              for d in ("cuda", "cpu")}
    models["cpu"].load_state_dict({k: v.cpu() for k, v in
                                   models["cuda"].state_dict().items()})
    out = {}
    for d, m in models.items():
        s, sl = torch.as_tensor(src, device=d), torch.as_tensor(src_len,
                                                                device=d)
        out[d] = (m.greedy_decode(s, 10, sl).cpu(),
                  m.beam_search_decode(s, 10, 4, sl)[0].cpu())
    same = [torch.equal(a, b) for a, b in zip(out["cuda"], out["cpu"])]
    log(f"zoo seq2seq decodes, card vs CPU: greedy "
        f"{'equal' if same[0] else 'differ'}, beam 4 "
        f"{'equal' if same[1] else 'differ'}")
    if not all(same):
        failures.append("zoo seq2seq decodes differ between card and CPU")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7d: expert and sequence parallelism
# ---------------------------------------------------------------------------

# bench.py's GPT (vocab 32768, hidden 768, 12 layers, 12 heads, seq 512,
# bf16) with Switch-Base-8's 8 experts, top-2, capacity 1.25, aux 0.01
MOE_TRAIN = dict(vocab_size=32768, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=512, dtype="bfloat16",
                 num_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
                 moe_aux_weight=0.01)
MOE_TRAIN_BATCH = 16
MOE_RING = (4, 12, 4 * 512, 64)    # [B, H, S, D] bf16, 4 shards of 512
MOE_RING_SHARDS = 4


def moe_phase(failures):
    """Expert and sequence parallelism (see the module docstring, phase
    7d).  Returns the launches of its main paths: the timed MoE train
    steps, the MoE serving runs (generate, engine, beam search) and the
    ring runs on K1-K3."""
    import collections

    launches = collections.Counter()
    launches.update(moe_train_run(failures))
    launches.update(moe_serve_run(failures))
    launches.update(moe_ring_run(failures))
    moe_f32_checks(failures)
    moe_group_checks(failures)
    return dict(launches)


def _moe_router_inputs(model, x):
    """The router input of every MoE layer in one no-grad forward of
    `model` on ids x: [N, D] tensors."""
    import torch

    seen = []
    hooks = [blk.moe.register_forward_hook(
        lambda m, args, out: seen.append(args[0].detach().reshape(
            -1, args[0].shape[-1]))) for blk in model.blocks]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def moe_train_run(failures, steps=3):
    """MOE_TRAIN through make_train_step(model, AdamW(1e-4)) at batch 16 x
    512: one warm-up and `steps` timed steps, each launching K1-K3 x12
    and K4, K5 x25 exactly; host ms, device ms, tokens/s, peak memory,
    the tokens that capacity dropped per layer and the profile's f32
    GEMM share (the expert products and the router)."""
    import torch

    from paddle_tpu_torch.distributed import moe
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW

    cfg = GPTConfig(**MOE_TRAIN)
    batch, seq = MOE_TRAIN_BATCH, cfg.max_seq_len
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda", generator=make_generator(0))
    n_all = sum(p.numel() for p in model.parameters())
    n_exp = sum(p.numel() for n, p in model.named_parameters()
                if n.endswith(("moe.w1", "moe.w2")))
    tokens = batch * seq
    e, d, k = cfg.num_experts, cfg.hidden_size, cfg.moe_top_k
    cap = moe.capacity(tokens, e, k, cfg.moe_capacity_factor)
    expert_flops = 3 * 4.0 * e * cap * d * 4 * d * cfg.num_layers
    log(f"moe train: GPT {cfg.num_layers} x {d}, {e} experts top-{k}, "
        f"capacity {cap} slots per expert, bf16, {n_all} parameters "
        f"({n_exp} in experts), built in {time.perf_counter() - t0:.1f} s; "
        f"batch {batch} x {seq}; f32 expert products "
        f"{expert_flops:.4e} FLOP per step (forward + backward), "
        f"{expert_flops / PEAK_OPS['float32'] * 1e3:.1f} ms at 67 TFLOP/s")
    opt = AdamW(1e-4)
    state = init_train_state(model, opt)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                        dtype=torch.int32, device="cuda")
    y = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                        dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    state, loss = step(state, x, y)
    losses = [float(loss)]
    log(f"moe train warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} "
        f"ms, loss {losses[0]:.6f}")
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
        made = {n: c - before.get(n, 0) for n, c in backend.LAUNCHES.items()}
        made = {n: c for n, c in made.items() if c}
        if made != TRAIN_LAUNCHES:
            failures.append(f"moe train step {i} launches {made} != "
                            f"{TRAIN_LAUNCHES}")
    launches = dict(backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    mean_ms = sum(step_ms) / steps
    log(f"moe train: {steps} steps, step ms {[round(t, 3) for t in step_ms]}"
        f", mean {mean_ms:.3f} ms; tokens/s {tokens / (mean_ms / 1e3):.1f}; "
        f"peak memory {peak / 2 ** 30:.3f} GiB; losses {losses}")
    if not all(np.isfinite(losses)):
        failures.append(f"moe train losses not finite: {losses}")
    dropped = []
    for h, blk in zip(_moe_router_inputs(model, x), model.blocks):
        r = moe._route(h, blk.moe.wg.detach(), k, cfg.moe_capacity_factor)
        dropped.append(int(sum(int((~kp).sum()) for kp in r.keep)))
    log(f"moe train: (token, choice) pairs dropped by capacity per layer, "
        f"of {tokens * k}: {dropped}")
    prof = profile_train_step(
        step, state, (x, y), mean_ms, label="moe train",
        families=(("f32 GEMM (expert products, router)",
                   r"sgemm|f32f32"),))
    del model, state, step
    torch.cuda.empty_cache()
    return launches


def moe_serve_run(failures):
    """GPT-2 small widths, bf16, 8 experts top-2: generate() on 4 prompts
    of 256 with 128 new tokens (prompt + new a multiple of 128, so that
    K6 serves each step), the engine over 16 requests (8 slots, max_len
    1024, buckets 128/256/512) and beam search at beam 4 (batch 4, prompt
    128, 32 new); exact launches per prefill (K1 x12, K4 x25) and decode
    step (K6 x12, K4 x25); tokens/s, ms per decode step and K6's
    share."""
    import torch

    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import generate as G
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = GPTConfig(dtype="bfloat16", num_experts=8)
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda", generator=make_generator(3)).eval()
    log(f"moe serve: GPT-2 small widths, 8 experts top-2, bf16, built in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 256), dtype=np.int32)
    lens = rng.integers(100, 513, size=16)
    news = rng.integers(16, 97, size=16)
    reqs = [(rng.integers(0, cfg.vocab_size, size=int(n), dtype=np.int32),
             int(m)) for n, m in zip(lens, news)]
    G.generate(model, prompts, max_new_tokens=2)        # warm-up
    torch.cuda.synchronize()
    launches = {}

    backend.reset_launches()
    t0 = time.perf_counter()
    out = G.generate(model, prompts, max_new_tokens=128)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    made = dict(backend.LAUNCHES)
    log(f"moe generate: 4 x (256 + 128) tokens in {gen_s:.3f} s "
        f"({4 * 128 / gen_s:.1f} new tokens/s); launches {made}")
    want = {"flash_attention_fwd": 12, "layer_norm_fwd": 25 * 128,
            "flash_decode": 12 * 127}
    if made != want:
        failures.append(f"moe generate launches {made} != {want}")
    if tuple(out.shape) != (4, 128) or int(out.min()) < 0 \
            or int(out.max()) >= cfg.vocab_size:
        failures.append(f"moe generate output {tuple(out.shape)} out of "
                        "range")
    _add(launches, made)

    backend.reset_launches()
    eng = DecodeEngine(model, config=DecodeConfig(
        slots=8, max_len=1024, buckets=(128, 256, 512), label="moe"))
    try:
        t0 = time.perf_counter()
        futs = [eng.submit(p, m) for p, m in reqs]
        results = [f.result(timeout=600) for f in futs]
        serve_s = time.perf_counter() - t0
    finally:
        eng.close()
    dec = eng.summary()["decode"]
    made = dict(backend.LAUNCHES)
    log(f"moe engine: {len(reqs)} requests in {serve_s:.3f} s; tokens/s "
        f"{dec.get('tokens_per_s')}; ttft p50 "
        f"{dec.get('ttft', {}).get('p50_ms')} ms; inter-token p50 "
        f"{dec.get('token_latency', {}).get('p50_ms')} ms; launches "
        f"(prewarm included) {made}")
    for (p, m), got in zip(reqs, results):
        if len(got) != m or got.min() < 0 or got.max() >= cfg.vocab_size:
            failures.append(f"moe engine output for prompt {len(p)} / {m} "
                            "out of range")
    for name in ("flash_attention_fwd", "layer_norm_fwd", "flash_decode"):
        if made.get(name, 0) < 1:
            failures.append(f"moe engine: {name} never launched")
    _add(launches, made)

    zb = ZOO_BEAM
    bprompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (zb["batch"], zb["prompt"])),
                               dtype=torch.int32, device="cuda")
    G.beam_search(model, bprompts, zb["beam"], 2)       # warm-up
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    seqs, scores = G.beam_search(model, bprompts, zb["beam"], zb["new"])
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    made = dict(backend.LAUNCHES)
    log(f"moe beam search: batch {zb['batch']}, beam {zb['beam']}, prompt "
        f"{zb['prompt']}, {zb['new']} new in {beam_s:.3f} s "
        f"({beam_s / zb['new'] * 1e3:.2f} ms per token step); launches "
        f"{made}")
    if made != ZOO_BEAM_LAUNCHES:
        failures.append(f"moe beam launches {made} != {ZOO_BEAM_LAUNCHES}")
    if not bool(torch.isfinite(scores).all()):
        failures.append("moe beam scores not finite")
    _add(launches, made)

    params, cache, logits = decode_prefill(model, prompts)
    prof = profile_decode(params, cache, logits)
    log(f"moe decode step: host {prof['host']:.3f} ms, device "
        f"{prof['device']:.3f} ms, K6 {prof['k6']:.4f} ms "
        f"({prof['k6'] / prof['device']:.1%} of the device time)")
    del model, eng, params, cache
    torch.cuda.empty_cache()
    return launches


def _add(total, made):
    for n, c in made.items():
        total[n] = total.get(n, 0) + c


def moe_ring_run(failures):
    """The ring loop with the in-process hop over 4 shards at MOE_RING
    bf16, causal and not: flash blocks (K1 forward, K2 and K3 backward,
    the future blocks skipped), exact launch counts, held against K1-K3
    on the whole sequence and against the ring's composition ("xla") at
    bf16's rule scaled to each tensor (compare_scaled); the ring's
    device ms beside K1's on the whole sequence, forward and forward +
    backward."""
    import torch

    from paddle_tpu_torch.distributed.ring_attention import (
        ring_attention_local,
    )
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.kernels.flash_attention import flash_attention

    n = MOE_RING_SHARDS
    gen = torch.Generator(device="cuda").manual_seed(7)
    # unit-scale inputs: logits q.k / 8 of spread 1, so the weights are
    # far from uniform and a mis-weighted block moves the output (one
    # hop's blocks weighted by e^0.03 fail compare_scaled; the old
    # allclose at 3e-2 let e^0.1 through)
    q, k, v, do = (torch.randn(MOE_RING, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    launches = {}
    for causal in (False, True):
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        backend.reset_launches()
        out = ring_attention_local(qg, kg, vg, n, causal)
        grads = torch.autograd.grad(out, (qg, kg, vg), do)
        torch.cuda.synchronize()
        made = dict(backend.LAUNCHES)
        blocks = n * (n + 1) // 2 if causal else n * n
        want = {"flash_attention_fwd": blocks,
                "flash_attention_bwd_dq": blocks,
                "flash_attention_bwd_dkv": blocks}
        if made != want:
            failures.append(f"ring causal={causal} launches {made} != {want}")
        _add(launches, made)
        ref = flash_attention(qg, kg, vg, causal=causal)
        ref_g = torch.autograd.grad(ref, (qg, kg, vg), do)
        plain = ring_attention_local(qg, kg, vg, n, causal, impl="xla")
        plain_g = torch.autograd.grad(plain, (qg, kg, vg), do)
        errs = []
        for name, got, a, b in zip(("out", "dq", "dk", "dv"),
                                   (out, *grads), (ref, *ref_g),
                                   (plain, *plain_g)):
            errs.append((name,
                         compare_scaled(f"ring causal={causal} {name} vs "
                                        "K1-K3", got, a, failures),
                         compare_scaled(f"ring causal={causal} {name} vs "
                                        "the composition", got, b,
                                        failures)))
        def fb(fn):
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            return lambda: torch.autograd.grad(fn(qg, kg, vg), (qg, kg, vg),
                                               do)

        fwd = {"ring": lambda: ring_attention_local(q, k, v, n, causal),
               "K1": lambda: flash_attention(q, k, v, causal=causal)}
        fwd_bwd = {"ring": fb(lambda a, b, c: ring_attention_local(
                       a, b, c, n, causal)),
                   "K1-K3": fb(lambda a, b, c: flash_attention(
                       a, b, c, causal=causal))}
        # the forward from CUDA-graph replays (the host's launch gaps
        # left out); forward + backward (autograd) between plain events
        times = ([(f"forward {nm}", time_ms(fn, iters=10))
                  for nm, fn in fwd.items()]
                 + [(f"forward + backward {nm}", time_ms(fn, iters=10,
                                                         graph=False))
                    for nm, fn in fwd_bwd.items()])
        log(f"ring attention {list(MOE_RING)} bf16, {n} in-process shards, "
            f"causal={causal}: launches {made}; max abs err (limit 2^-6 x "
            f"max |want|; relative Frobenius err, limit 2^-7) vs K1-K3 on "
            f"the whole "
            f"sequence / vs the composition "
            + ", ".join(f"{nm} {a[0]:.3e} ({a[1]:.3e}; {a[2]:.3e}) / "
                        f"{b[0]:.3e} ({b[1]:.3e}; {b[2]:.3e})"
                        for nm, a, b in errs)
            + "; device ms per call (forward: graph replays; forward + "
            "backward: plain calls between events, launch gaps included): "
            + ", ".join(f"{nm} {t:.3f}" for nm, t in times))
    torch.cuda.empty_cache()
    return launches


def _routing_flips(card_inputs, cpu_inputs, model_cpu, cfg):
    """Tokens whose expert choices differ between the card's and the
    CPU's first forward, [(layer, token, the CPU's smallest gap between
    neighbouring router probabilities among its top k + 1)], and that
    gap's least value over every token and layer."""
    import torch

    from paddle_tpu_torch.distributed import moe

    flips, least = [], float("inf")
    for layer, (hc, hp, blk) in enumerate(zip(card_inputs, cpu_inputs,
                                               model_cpu.blocks)):
        wg = blk.moe.wg.detach()
        rc = moe._route(hc.cpu(), wg, cfg.moe_top_k, cfg.moe_capacity_factor)
        rp = moe._route(hp, wg, cfg.moe_top_k, cfg.moe_capacity_factor)
        diff = torch.zeros(hp.shape[0], dtype=torch.bool)
        for a, b in zip(rc.idx, rp.idx):
            diff |= a != b
        probs = rp.probs.detach().sort(dim=-1, descending=True).values
        gaps = (probs[:, :cfg.moe_top_k] - probs[:, 1:cfg.moe_top_k + 1])
        least = min(least, float(gaps.min()))
        for t in diff.nonzero()[:, 0].tolist():
            flips.append((layer, t, float(gaps[t].min())))
    return flips, least


def _teacher_margin(params, prompt, ref, step, dev):
    """generate()'s top-2 logit margin at `step`, teacher-forced on its
    tokens `ref`."""
    import torch

    from paddle_tpu_torch.models import generate as G

    n = prompt.shape[-1]
    with torch.inference_mode():
        cache = G.init_cache(params.cfg, 1, n + len(ref), device=dev)
        logits = G.prefill(params, torch.as_tensor(prompt[None], device=dev),
                           cache)
        for i in range(step):
            logits = G.decode_step(params, torch.as_tensor(
                ref[i:i + 1], device=dev), cache, n + i)
    return _margin(logits[0])


def moe_f32_checks(failures, steps=3, lr=1e-4):
    """The MoE GPT at full width (vocab 32768, hidden 768, 12 heads, 8
    experts), depth 2, f32, batch 2 x seq 256: first-step grads and 3
    AdamW steps, card vs CPU, at the train check's tolerances; a routing
    choice that differs between the two first forwards fails the check
    (a flipped token's expert output changes every later token's path,
    so nothing downstream could be held; the smallest router gap of the
    CPU's run is logged to show how far the data lies from a tie).  Then
    greedy
    tokens (drop-free capacity 4.0: the prefill and the engine route the
    same), card vs CPU and engine vs generate() on the card: a token may
    differ only where the reference run's top-2 logit margin is <= 1e-3
    relative."""
    import torch

    from paddle_tpu_torch.models import generate as G
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import load_param_dict, make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=2,
                    num_heads=12, max_seq_len=512, num_experts=8)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, size=(2, 256), dtype=np.int32)
    labels = np.roll(ids, -1, axis=1)
    make = lambda dev: GPT(cfg, device=dev, generator=make_generator(4))
    runs = _card_cpu_runs(make, [(ids, labels)] * steps, lambda: AdamW(lr))
    card_m, cpu_m = make("cuda"), make("cpu")
    load_param_dict(card_m, runs["cpu"]["start"])
    load_param_dict(cpu_m, runs["cpu"]["start"])
    flips, least = _routing_flips(
        _moe_router_inputs(card_m, torch.as_tensor(ids, device="cuda")),
        _moe_router_inputs(cpu_m, torch.as_tensor(ids)), cpu_m, cfg)
    label = (f"f32 MoE GPT check (full width, 8 experts, depth 2, batch 2 x "
             f"256, {steps} AdamW({lr}) steps)")
    log(f"{label}: routing choices that differ, card vs CPU (layer, token, "
        f"CPU's smallest top-{cfg.moe_top_k + 1} probability gap): {flips}; "
        f"the CPU's smallest such gap over all tokens {least:.3e}")
    if flips:
        failures.append(f"{label}: routing differs between card and CPU: "
                        f"{flips}")
    _hold_train_rules(label, runs["cuda"], runs["cpu"], lr, failures)
    del runs, card_m, cpu_m

    dcfg = GPTConfig(**{**cfg.__dict__, "moe_capacity_factor": 4.0})
    models = {d: GPT(dcfg, device=d, generator=make_generator(5)).eval()
              for d in ("cuda", "cpu")}
    load_param_dict(models["cpu"], {n: p.detach().cpu() for n, p in
                                    models["cuda"].named_parameters()})
    prompts = rng.integers(0, cfg.vocab_size, size=(2, 128), dtype=np.int32)
    new = 16
    params = {d: G.build_decode_params(m) for d, m in models.items()}
    toks = {d: G.generate(params[d], prompts, new).cpu().numpy()
            for d in models}
    eng = DecodeEngine(models["cuda"], config=DecodeConfig(
        slots=2, max_len=256, buckets=(128,), label="moe_parity"))
    try:
        futs = [eng.submit(p, new) for p in prompts]
        eng_toks = [f.result(timeout=600) for f in futs]
    finally:
        eng.close()
    cases = [("card vs CPU", toks["cuda"][i], toks["cpu"][i], "cpu", i)
             for i in range(2)] + [
        ("engine vs generate() on the card", eng_toks[i], toks["cuda"][i],
         "cuda", i) for i in range(2)]
    for what, got, ref, dev, i in cases:
        if np.array_equal(got, ref):
            log(f"f32 MoE greedy tokens, {what}, prompt {i}: token-exact "
                f"({new} new)")
            continue
        step = int(np.argmax(got != ref))
        margin = _teacher_margin(params[dev], prompts[i], ref, step, dev)
        log(f"f32 MoE greedy tokens, {what}, prompt {i}: first mismatch at "
            f"step {step}, top-2 margin {margin:.3e} relative")
        if margin > 1e-3:
            failures.append(f"MoE greedy tokens {what} differ at step {step} "
                            f"with margin {margin:.3e} > 1e-3")
    del models, params, eng
    torch.cuda.empty_cache()


def moe_group_checks(failures):
    """The real group path on a one-rank NCCL group (every axis of size
    1): ring_attention at sp = 1 against K1, sharded_moe_ffn and
    moe_ffn_shardmap at ep = 1 against moe_ffn, and one
    make_sharded_train_step(dp=1, ep=1) step against make_train_step
    from the same weights; the group is destroyed at the end."""
    import torch

    from paddle_tpu_torch.distributed import env, moe, sharded
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.distributed.ring_attention import ring_attention
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import load_param_dict, make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW

    env.init_parallel_env()
    try:
        mesh = build_mesh(dp=1, sp=1, ep=1)
        gen = torch.Generator(device="cuda").manual_seed(8)
        q, k, v = (torch.randn((2, 12, 512, 64), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        got = ring_attention(q, k, v, "sp", causal=True, mesh=mesh)
        err_r = compare_scaled("ring at sp = 1 (NCCL) vs K1", got,
                               flash_attention(q, k, v, causal=True),
                               failures)[0]
        p = moe.init_moe_params(gen, 8, 768, 3072)
        x = torch.randn((512, 768), generator=gen, device="cuda")
        want, aux = moe.moe_ffn(p, x)
        sp = moe.shard_moe_params(p, mesh)
        err_m = [compare(f"{name} at ep = 1 (NCCL) vs moe_ffn", y, want,
                         "float32", failures)
                 for name, (y, _) in (
                     ("sharded_moe_ffn", moe.sharded_moe_ffn(sp, x, mesh)),
                     ("moe_ffn_shardmap",
                      moe.moe_ffn_shardmap(sp, x, mesh=mesh)))]
        cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=2,
                        num_heads=12, max_seq_len=512, num_experts=8)
        a = GPT(cfg, device="cuda", generator=make_generator(6))
        b = GPT(cfg, device="cuda", generator=make_generator(6))
        load_param_dict(b, {n: t.detach() for n, t in a.named_parameters()})
        rng = np.random.default_rng(6)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                              dtype=torch.int32, device="cuda")
        lab = torch.roll(ids, -1, 1)
        step, st = sharded.make_sharded_train_step(a, AdamW(1e-4), mesh)
        st, l1 = step(st, *sharded.shard_batch(mesh, ids, lab))
        rst = init_train_state(b, AdamW(1e-4))
        rst, l2 = make_train_step(b, AdamW(1e-4))(rst, ids, lab)
        err_s = max((st.params[n] - t).abs().max().item()
                    for n, t in rst.params.items())
        log(f"one-rank NCCL group (dp = sp = ep = 1): ring vs K1 max abs err "
            f"{err_r:.3e}; sharded_moe_ffn / moe_ffn_shardmap vs moe_ffn "
            f"{err_m[0]:.3e} / {err_m[1]:.3e}; sharded step loss "
            f"{float(l1):.6f} vs make_train_step {float(l2):.6f}, params max "
            f"abs err {err_s:.3e}")
        if not (abs(float(l1) - float(l2)) <= 1e-5 * abs(float(l2))
                and err_s <= 1e-6):
            failures.append(f"sharded step at dp = ep = 1 differs from "
                            f"make_train_step: losses {float(l1)} / "
                            f"{float(l2)}, params {err_s:.3e}")
        del a, b, st, rst
    finally:
        env.destroy_parallel_env()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7e: tensor and pipeline parallelism
# ---------------------------------------------------------------------------

# bench.py's GPT (bench.py:169-174): vocab 32768, hidden 768, 12 layers,
# 12 heads, seq 512, bf16, AdamW(1e-4), batch 16 x 512
PAR_CFG = dict(vocab_size=32768, hidden_size=768, num_layers=12,
               num_heads=12, max_seq_len=512, dtype="bfloat16")
PAR_BATCH = 16
PAR_MICRO = 4
# K1-K5 launches of one step of both in-process ranks, from the code:
# tp = 2: each rank's 12 blocks on its 6 local heads, 25 LayerNorms;
# pp = 2 (and V = 2): each rank's 6 blocks x 4 microbatches, each stage
# recomputed in the backward (K1, K4 twice), plus the head's LayerNorm
# on every pp rank
PAR_TP_LAUNCHES = {"flash_attention_fwd": 24, "flash_attention_bwd_dq": 24,
                   "flash_attention_bwd_dkv": 24, "layer_norm_fwd": 50,
                   "layer_norm_bwd": 50}
PAR_PP_LAUNCHES = {"flash_attention_fwd": 96, "flash_attention_bwd_dq": 48,
                   "flash_attention_bwd_dkv": 48, "layer_norm_fwd": 194,
                   "layer_norm_bwd": 98}


def parallel_phase(failures):
    """Tensor and pipeline parallelism at bench.py's GPT widths (see the
    module docstring, phase 7e).  W > 1 runs in one process, both ranks'
    shards on the card (`inprocess.local_meshes`: a thread a rank, the
    collectives in memory).  Returns the launches of its main paths:
    the timed tp = 2 steps and the timed pipeline steps (pp = 2, V =
    1 and 2)."""
    import collections

    launches = collections.Counter()
    launches.update(parallel_tp_run(failures))
    launches.update(parallel_pp_run(failures, interleave=1))
    launches.update(parallel_pp_run(failures, interleave=2))
    parallel_group_checks(failures)
    parallel_f32_checks(failures)
    parallel_dp_checks(failures)
    return dict(launches)


def _hold_zero_grad(label, name, got, grads, failures):
    """A key bias's grad is 0 in exact arithmetic (softmax does not see a
    shift of a query's scores): hold it near 0, at most 2^-4 of the same
    layer's query bias grad, not elementwise.  The bf16 noise reads up
    to 3.6e-2 (about 1/28) of it on the H100; a fault in dK reads 0.86
    and more (`tools/kbias_probe.py`: D left out of dS; the causal mask
    left out of dK's P, 11 and more).  Returns the ratio when `name` is a
    key bias, else None."""
    if not name.endswith("k_proj.bias"):
        return None
    top = grads[name.replace("k_proj", "q_proj")].float().abs().max().item()
    big = got.float().abs().max().item()
    if not big <= 2.0 ** -4 * top:
        failures.append(f"{label}: max |grad| {big:.3e} > 2^-4 x the query "
                        f"bias's {top:.3e} (0 in exact arithmetic)")
    return big / max(top, 1e-30)


def _hold_update(label, before, got, want_before, want, failures,
                 least=0.9):
    """A parallel step's first AdamW update against make_train_step's from
    the same weights.  AdamW's first step moves an element by about lr
    against the sign of its grad, which a bf16 param takes as 0 or one
    ulp, so the update is held by its direction: of the elements that
    either step moved, at least `least` must have moved the same way (a
    missing update reads 0, a negated one 0, another rank's block about
    1/2; the grads' bf16 noise flips the few elements whose grad is near
    0).  Returns the agreement (1.0 where neither moved)."""
    import torch

    dg = torch.sign(got.float() - before.float())
    dw = torch.sign(want.float() - want_before.float())
    moved = (dg != 0) | (dw != 0)
    n = int(moved.sum())
    if n == 0:
        return 1.0
    agree = int(((dg == dw) & moved).sum()) / n
    if not agree >= least:
        failures.append(f"{label}: the update moves {agree:.4f} of its "
                        f"{n} moved elements as make_train_step's does "
                        f"(< {least})")
    return agree


def _ref_updates(model, opt, x, y, steps, accum_steps=1):
    """make_train_step's first `steps` steps from the model's weights:
    (its params before, its params after the first step, the losses)."""
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )

    st = init_train_state(model, opt)
    step = make_train_step(model, opt, accum_steps=accum_steps)
    before = {n: t.detach().clone() for n, t in st.params.items()}
    after, losses = None, []
    for _ in range(steps):
        st, loss = step(st, x, y)
        losses.append(float(loss))
        if after is None:
            after = {n: t.detach().clone() for n, t in st.params.items()}
    return before, after, losses


def _par_batch(vocab, batch, seq, device, seed=0):
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.integers(0, vocab, (batch, seq)),
                                 dtype=torch.int32, device=device)
                 for _ in range(2))


def _made(before):
    from paddle_tpu_torch.kernels import backend

    made = {n: c - before.get(n, 0) for n, c in backend.LAUNCHES.items()}
    return {n: c for n, c in made.items() if c}


def _timed_local(label, run, steps, want, tokens, failures):
    """`steps` timed calls of run() (one step of every in-process rank):
    host ms each, exact K1-K5 launches per step, peak memory, then one
    profiled step.  Returns (launches, mean host ms)."""
    import torch

    from paddle_tpu_torch.kernels import backend

    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    step_ms, losses = [], []
    for i in range(steps):
        before = dict(backend.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(run())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        made = _made(before)
        if made != want:
            failures.append(f"{label} step {i} launches {made} != {want}")
    launches = dict(backend.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    mean_ms = sum(step_ms) / steps
    log(f"{label}: {steps} steps, host ms {[round(t, 3) for t in step_ms]}, "
        f"mean {mean_ms:.3f}; tokens/s {tokens / (mean_ms / 1e3):.1f}; peak "
        f"memory {peak / 2 ** 30:.3f} GiB (both ranks); losses {losses}; "
        f"K1-K5 per step {want}")
    if not all(np.isfinite(losses)):
        failures.append(f"{label} losses not finite: {losses}")
    profile_train_step(lambda *a: run(), None, (), mean_ms, label=label)
    return launches, mean_ms


def _rank_models(cfg, meshes, seed=0):
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import make_generator

    return [GPT(GPTConfig(**cfg), device=m.device,
                generator=make_generator(seed)) for m in meshes]


def _ref_loss_grads(cfg, x, y, seed=0):
    """The unsharded model's loss and grads on the card (what
    make_train_step's step differentiates), and the same in f32 from the
    same (upcast) weights: (model, loss, grads, f32 grads)."""
    import torch

    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import load_param_dict, make_generator

    def loss_grads(model):
        params = dict(model.named_parameters())
        loss = model.loss(x, y)
        return loss.detach(), dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    model = GPT(GPTConfig(**cfg), device=x.device,
                generator=make_generator(seed))
    loss, grads = loss_grads(model)
    wide = GPT(GPTConfig(**dict(cfg, dtype="float32")), device=x.device,
               generator=make_generator(seed))
    load_param_dict(wide, {n: p.detach().float()
                           for n, p in model.named_parameters()})
    _, grads32 = loss_grads(wide)
    del wide
    return model, loss, grads, grads32


def _hold_grad(label, got, want, want32, failures):
    """A parallel grad of bf16 against the unsharded step's: its relative
    Frobenius error against the f32 grads of the same weights may not
    exceed 1.5x the unsharded bf16 grad's own (at random init a grad is
    a sum of many cancelling terms, so bf16's rounding shows far above
    2^-7 in both: the summation order of the split, not a fault, is
    what differs).  Returns (error, the unsharded's)."""
    e, e_ref = rel_err(got, want32), rel_err(want, want32)
    if not (e <= 1.5 * e_ref + 1e-5 and bool(torch_isfinite(got))):
        failures.append(f"{label}: relative Frobenius error vs f32 {e:.3e} > "
                        f"1.5 x the unsharded bf16 step's {e_ref:.3e}")
    return e, e_ref


def torch_isfinite(t):
    import torch

    return torch.isfinite(t.float()).all()


def parallel_tp_run(failures, steps=3):
    """(a) make_sharded_train_step at tp = 2 in one process: K1-K3 on
    each rank's [16, 6, 512, 64] local heads; the first step's loss and
    every rank's grads held to the unsharded model's on the card, every
    rank's params after the first update to make_train_step's, the
    second step's loss to make_train_step's; then `steps` timed steps."""
    import torch

    from paddle_tpu_torch.distributed import inprocess, sharded
    from paddle_tpu_torch.optimizer.functional import AdamW

    x, y = _par_batch(PAR_CFG["vocab_size"], PAR_BATCH, 512, "cuda")
    ref, want_loss, want, want32 = _ref_loss_grads(PAR_CFG, x, y)
    ref_before, ref_after, ref_losses = _ref_updates(ref, AdamW(1e-4), x, y,
                                                     steps=2)
    del ref
    torch.cuda.empty_cache()
    meshes = inprocess.local_meshes(tp=2, device="cuda")
    models = _rank_models(PAR_CFG, meshes)
    parts = [sharded.make_sharded_train_step(m, AdamW(1e-4), mesh,
                                             sharded.gpt_rules())
             for m, mesh in zip(models, meshes)]
    steps_ = [p[0] for p in parts]
    states = [p[1] for p in parts]
    batches = [sharded.shard_batch(mesh, x, y) for mesh in meshes]
    # the first step by its parts: every rank's grads before the update
    outs = inprocess.run_ranks(meshes, lambda r, m: steps_[r].forward(
        states[r], batches[r], states[r].buffers))
    grads = inprocess.joint_grad([o[0] for o in outs], [o[1] for o in outs])
    worst, kbias = (0.0, 0.0, ""), 0.0
    for r, (mesh, st, s) in enumerate(zip(meshes, states, steps_)):
        compare_scaled(f"tp = 2 rank {r} loss vs unsharded",
                       outs[r][0].detach().reshape(1),
                       want_loss.reshape(1), failures)
        got = dict(zip(st.params, grads[r]))
        for n, g in got.items():
            zero = _hold_zero_grad(f"tp = 2 rank {r} grad {n}", n, g, got,
                                   failures)
            if zero is not None:
                kbias = max(kbias, zero)
                continue
            blk = [sharded.local_block(mesh, s.param_specs[n], w[n])
                   for w in (want, want32)]
            e, e_ref = _hold_grad(f"tp = 2 rank {r} grad {n}", g, *blk,
                                  failures)
            worst = max(worst, (e / max(e_ref, 1e-30), e, f"{n} rank {r}"))
    inits = [{n: t.detach().clone() for n, t in st.params.items()}
             for st in states]
    for r in range(2):
        steps_[r].finish(states[r], [outs[r][0].detach()],
                         dict(zip(states[r].params, grads[r])),
                         outs[r][2])
    least = (1.0, "")
    for r, (mesh, st, s) in enumerate(zip(meshes, states, steps_)):
        for n, t in st.params.items():
            if n.endswith("k_proj.bias"):
                continue
            b0, w1 = (sharded.local_block(mesh, s.param_specs[n], d[n])
                      for d in (ref_before, ref_after))
            a = _hold_update(f"tp = 2 rank {r} update {n}", inits[r][n], t,
                             b0, w1, failures)
            least = min(least, (a, f"{n} rank {r}"))
    del inits, ref_before, ref_after
    loss2 = sharded.run_local_step(steps_, states, batches)
    states = [o[0] for o in loss2]
    log(f"parallel tp = 2 (in-process, bench.py's GPT bf16, batch "
        f"{PAR_BATCH} x 512): first loss {float(outs[0][0].detach()):.6f} vs "
        f"unsharded {float(want_loss):.6f}; grads vs f32: worst ratio to the "
        f"unsharded bf16 step's error {worst[0]:.3f} ({worst[2]}, "
        f"{worst[1]:.3e}); key bias grads at most {kbias:.4e} of the query "
        f"bias's; first update vs make_train_step's: least direction "
        f"agreement {least[0]:.6f} ({least[1]}); second step loss "
        f"{float(loss2[0][1]):.6f} vs make_train_step {ref_losses[1]:.6f}")
    compare_scaled("tp = 2 second-step loss vs make_train_step",
                   loss2[0][1].reshape(1).float(),
                   torch.tensor([ref_losses[1]], device="cuda"), failures)
    del outs, grads, want, want32
    torch.cuda.empty_cache()

    def run():
        nonlocal states
        res = sharded.run_local_step(steps_, states, batches)
        states = [o[0] for o in res]
        return float(res[0][1])

    launches, _ = _timed_local("parallel tp = 2 train", run, steps,
                               PAR_TP_LAUNCHES, PAR_BATCH * 512, failures)
    del models, parts, steps_, states
    torch.cuda.empty_cache()
    return launches


def _pipeline_ranks(cfg, meshes, micro, interleave, seed=0):
    from paddle_tpu_torch.distributed import pipeline

    fns, params = [], []
    for m, mesh in zip(_rank_models(cfg, meshes, seed), meshes):
        f, p = pipeline.build_gpt_pipeline(m, mesh, micro,
                                           interleave=interleave)
        fns.append(f)
        params.append(p)
    return fns, params


def _pipeline_grads(meshes, fns, params, x, y):
    """Every rank's loss and grads ({(group, name): grad}) of one
    in-process pipeline forward and one joint backward."""
    from paddle_tpu_torch.distributed import inprocess

    def fwd(r, mesh):
        leaves = {g: {n: t.detach().requires_grad_()
                      for n, t in params[r][g].items()} for g in params[r]}
        return fns[r](leaves, x, y), leaves

    outs = inprocess.run_ranks(meshes, fwd)
    keys = [[(g, n) for g in o[1] for n in o[1][g]] for o in outs]
    flat = [[o[1][g][n] for g, n in k] for o, k in zip(outs, keys)]
    grads = inprocess.joint_grad([o[0] for o in outs], flat)
    return ([o[0].detach() for o in outs],
            [dict(zip(k, gs)) for k, gs in zip(keys, grads)])


def _stage_layers(r, n_layers, stages, interleave):
    """[(row index in rank r's stage leaves, layer)]: gpipe rows [per],
    interleaved rows [v, per] (chunk v*S + r)."""
    per = n_layers // (stages * interleave)
    if interleave == 1:
        return [((k,), r * per + k) for k in range(per)]
    return [((v, k), (v * stages + r) * per + k)
            for v in range(interleave) for k in range(per)]


def parallel_pp_run(failures, interleave=1, steps=3):
    """(b) build_gpt_pipeline at pp = 2 with 4 microbatches in one
    process (interleave 2: 4 chunks of 3 blocks); the loss and every
    stage's, the embedding's and the head's grads held to the
    unpipelined model's, every rank's params after one AdamW(1e-4)
    update to make_train_step's; then `steps` timed steps (forward,
    backward, AdamW(1e-4) on each rank's params)."""
    import torch

    from paddle_tpu_torch.distributed import inprocess
    from paddle_tpu_torch.optimizer.functional import AdamW

    label = f"parallel pp = 2{'' if interleave == 1 else ', V = 2'}"
    x, y = _par_batch(PAR_CFG["vocab_size"], PAR_BATCH, 512, "cuda")
    ref, want_loss, want, want32 = _ref_loss_grads(PAR_CFG, x, y)
    ref_before, ref_after, _ = _ref_updates(ref, AdamW(1e-4), x, y, steps=1)
    del ref
    torch.cuda.empty_cache()
    meshes = inprocess.local_meshes(pp=2, device="cuda")
    fns, params = _pipeline_ranks(PAR_CFG, meshes, PAR_MICRO, interleave)
    losses, grads = _pipeline_grads(meshes, fns, params, x, y)
    worst, kbias = (0.0, 0.0, ""), 0.0
    for r in range(2):
        compare_scaled(f"{label} rank {r} loss vs unpipelined",
                       losses[r].reshape(1).float(),
                       want_loss.reshape(1).float(), failures)
        for (g, n), gr in grads[r].items():
            if g == "stages":
                for idx, layer in _stage_layers(r, 12, 2, interleave):
                    got = gr[idx]
                    name = f"blocks.{layer}.{n}"
                    zero = _hold_zero_grad(f"{label} grad {name}", name, got, {
                        name.replace("k_proj", "q_proj"): grads[r][(
                            g, n.replace("k_proj", "q_proj"))][idx]},
                        failures)
                    if zero is not None:
                        kbias = max(kbias, zero)
                        continue
                    e, e_ref = _hold_grad(f"{label} grad {name}", got,
                                          want[name], want32[name], failures)
                    worst = max(worst, (e / max(e_ref, 1e-30), e, name))
            else:
                e, e_ref = _hold_grad(f"{label} rank {r} grad {n}", gr,
                                      want[n], want32[n], failures)
                worst = max(worst, (e / max(e_ref, 1e-30), e,
                                    f"{n} rank {r}"))
    del want, want32
    opts = [AdamW(1e-4) for _ in meshes]
    flat = [{f"{g}/{n}": t for g in p for n, t in p[g].items()}
            for p in params]
    ostates = [o.init(f) for o, f in zip(opts, flat)]

    def update(gs):
        def upd(r, mesh):
            g = {f"{k[0]}/{k[1]}": v for k, v in gs[r].items()}
            opts[r].update(flat[r], g, ostates[r], inplace=True)

        inprocess.run_ranks(meshes, upd)

    # the first update from the checked grads, held to make_train_step's
    inits = [{k: t.detach().clone() for k, t in f.items()} for f in flat]
    update(grads)
    least = (1.0, "")
    for r in range(2):
        for key, t in flat[r].items():
            g, n = key.split("/", 1)
            if g == "stages":
                pairs = [(t[idx], inits[r][key][idx], f"blocks.{layer}.{n}")
                         for idx, layer in _stage_layers(r, 12, 2,
                                                         interleave)]
            else:
                pairs = [(t, inits[r][key], n)]
            for got, before, name in pairs:
                if name.endswith("k_proj.bias"):
                    continue
                a = _hold_update(f"{label} rank {r} update {name}", before,
                                 got, ref_before[name], ref_after[name],
                                 failures)
                least = min(least, (a, f"{name} rank {r}"))
    del grads, inits, ref_before, ref_after
    log(f"{label} (in-process, {PAR_MICRO} microbatches, bench.py's GPT "
        f"bf16, batch {PAR_BATCH} x 512): loss {float(losses[0]):.6f} vs "
        f"unpipelined {float(want_loss):.6f}; grads vs f32: worst ratio to "
        f"the unpipelined bf16 step's error {worst[0]:.3f} ({worst[2]}, "
        f"{worst[1]:.3e}); key bias grads at most {kbias:.4e} of the query "
        f"bias's; first update vs make_train_step's: least direction "
        f"agreement {least[0]:.6f} ({least[1]})")
    torch.cuda.empty_cache()

    def run():
        ls, gs = _pipeline_grads(meshes, fns, params, x, y)
        update(gs)
        return float(ls[0])

    launches, _ = _timed_local(f"{label} train", run, steps,
                               PAR_PP_LAUNCHES, PAR_BATCH * 512, failures)
    del fns, params, flat, ostates
    torch.cuda.empty_cache()
    return launches


def parallel_group_checks(failures):
    """(c) the multi-process path on a one-rank NCCL group: the sharded
    step with zero1, fsdp_rules(), accum_steps=2 and a global-norm clip,
    and build_gpt_pipeline at pp = 1 (one microbatch), each held bitwise
    against make_train_step (accum_steps=2, the same clip) from the same
    weights: bench.py's widths at depth 2, bf16, batch 4 x 512.  At dp =
    1 ZeRO-1 and FSDP split nothing (`parallel_dp_checks` runs them
    split)."""
    import torch

    from paddle_tpu_torch.distributed import env, pipeline, sharded
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.models.train import (
        init_train_state, make_train_step,
    )
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW, global_norm_clip

    cfg = dict(PAR_CFG, num_layers=2)
    env.init_parallel_env()
    try:
        mesh = build_mesh(dp=1, tp=1, sp=1, pp=1)
        x, y = _par_batch(cfg["vocab_size"], 4, 512, "cuda", seed=5)

        def model():
            return GPT(GPTConfig(**cfg), device="cuda",
                       generator=make_generator(7))

        def opt():
            return AdamW(1e-4, grad_clip=global_norm_clip(1.0))

        a, b = model(), model()
        step, st = sharded.make_sharded_train_step(
            a, opt(), mesh, sharded.gpt_rules() + sharded.fsdp_rules(),
            zero1=True, accum_steps=2)
        rst = init_train_state(b, opt())
        rstep = make_train_step(b, opt(), accum_steps=2)
        same = True
        for i in range(2):
            st, l1 = step(st, *sharded.shard_batch(mesh, x, y))
            rst, l2 = rstep(rst, x, y)
            same &= torch.equal(l1, l2)
        same_p = all(torch.equal(st.params[n], t)
                     for n, t in rst.params.items())
        same_m = all(torch.equal(st.opt_state[n][k], v)
                     for n, s in rst.opt_state.items() if n != "__step__"
                     for k, v in s.items())
        log(f"one-rank NCCL group, sharded step (zero1, fsdp_rules, "
            f"accum_steps 2, global-norm clip 1.0) vs make_train_step, 2 "
            f"steps: losses bitwise {same}, params bitwise {same_p}, "
            f"moments bitwise {same_m}")
        if not (same and same_p and same_m):
            failures.append("sharded step at W = 1 (NCCL) is not bitwise "
                            "make_train_step's")
        del a, b, st, rst
        c = model()
        fn, p = pipeline.build_gpt_pipeline(c, mesh, 1)
        loss, grads = pipeline.value_and_grad(fn, mesh)(p, x, y)
        d = model()
        params = dict(d.named_parameters())
        ref = d.loss(x, y)
        want = dict(zip(params, torch.autograd.grad(ref, list(
            params.values()))))
        ok = torch.equal(loss, ref.detach())
        for n, g in grads["stages"].items():
            ok &= all(torch.equal(g[k], want[f"blocks.{k}.{n}"])
                      for k in range(2))
        for grp in ("emb", "head"):
            ok &= all(torch.equal(g, want[n])
                      for n, g in grads[grp].items())
        log(f"one-rank NCCL group, build_gpt_pipeline at pp = 1 vs the "
            f"model's loss and grads: bitwise {ok} (loss {float(loss):.6f})")
        if not ok:
            failures.append("pipeline at pp = 1 (NCCL) is not bitwise the "
                            "model's loss and grads")
        del c, d, p, grads, want
    finally:
        env.destroy_parallel_env()
    torch.cuda.empty_cache()


def parallel_dp_checks(failures, clip=0.1):
    """(e) ZeRO-1 and FSDP on the card: make_sharded_train_step at dp = 2
    in one process, bench.py's widths at depth 2, bf16, batch 4 x 512,
    accum_steps=2, AdamW(1e-4) with a global-norm clip at `clip`
    (engaged: checked against the whole batch's grad norm), 2 steps from
    the same weights: `gpt_rules()` replicated (A), with zero1=True (B),
    and `fsdp_rules()` (every param's dim 0 over dp, gathered where its
    module runs) with zero1=True (C).  B is held bitwise A (losses and
    params: the reductions are the same, AdamW elementwise).  C's first
    loss is held bitwise A's, and its params after each step, A's
    blocks, by the direction of their updates (`_hold_update`): C sums a
    grad over dp in each microbatch and then over the microbatches, A
    the other way round, so their bf16 grads differ in rounding.  A's
    first update is held to make_train_step's (accum_steps=2, the same
    clip) on the whole batch by the same rule."""
    import torch

    from paddle_tpu_torch.distributed import inprocess, sharded
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.optimizer.functional import AdamW, global_norm_clip

    cfg = dict(PAR_CFG, num_layers=2)
    x, y = _par_batch(cfg["vocab_size"], 4, 512, "cuda", seed=6)

    def model():
        return GPT(GPTConfig(**cfg), device="cuda",
                   generator=make_generator(8))

    def opt():
        return AdamW(1e-4, grad_clip=global_norm_clip(clip))

    m = model()
    ps = dict(m.named_parameters())
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in
                          torch.autograd.grad(m.loss(x, y),
                                              list(ps.values())))).item()
    if not norm > 2 * clip:
        failures.append(f"dp = 2 checks: the grad norm {norm:.4e} does not "
                        f"engage the clip at {clip}")
    ref_before, ref_after, ref_losses = _ref_updates(m, opt(), x, y, steps=1,
                                                     accum_steps=2)
    del m, ps

    def run(rules, zero1):
        meshes = inprocess.local_meshes(dp=2, device="cuda")
        parts = [sharded.make_sharded_train_step(model(), opt(), mesh, rules,
                                                 zero1=zero1, accum_steps=2)
                 for mesh in meshes]
        steps_ = [p[0] for p in parts]
        states = [p[1] for p in parts]
        batches = [sharded.shard_batch(mesh, x, y) for mesh in meshes]
        losses, params = [], []
        for _ in range(2):
            res = sharded.run_local_step(steps_, states, batches)
            states = [o[0] for o in res]
            losses.append([o[1].detach().clone() for o in res])
            params.append([{n: t.detach().clone()
                            for n, t in st.params.items()} for st in states])
        return meshes, steps_, states, losses, params

    a_meshes, _, _, a_loss, a_par = run(sharded.gpt_rules(), False)
    least = (1.0, "")
    for n, t in a_par[0][0].items():
        if n.endswith("k_proj.bias"):
            continue
        agree = _hold_update(f"dp = 2 rank 0 update {n}", ref_before[n], t,
                             ref_before[n], ref_after[n], failures)
        least = min(least, (agree, n))
    compare_scaled("dp = 2 first loss vs make_train_step",
                   a_loss[0][0].reshape(1).float(),
                   torch.tensor([ref_losses[0]], device="cuda"), failures)
    del ref_after
    _, b_steps, b_states, b_loss, b_par = run(sharded.gpt_rules(), True)
    same_b = all(torch.equal(lb, la) for i in range(2)
                 for lb, la in zip(b_loss[i], a_loss[i]))
    same_b &= all(torch.equal(t, a_par[i][r][n]) for i in range(2)
                  for r in range(2) for n, t in b_par[i][r].items())
    n_zero1 = len(b_steps[0].zero1_params)
    m1 = b_states[0].opt_state["wte.weight"]["Moment1"]
    split_b = n_zero1 > 0 and m1.shape[0] == cfg["vocab_size"] // 2
    del b_steps, b_states, b_par, m1
    c_meshes, c_steps, _, c_loss, c_par = run(sharded.fsdp_rules(), True)
    n_fsdp = len(c_steps[0].fsdp)
    peak = [s.fsdp_peak_bytes for s in c_steps]
    first_c = all(torch.equal(lc, la)
                  for lc, la in zip(c_loss[0], a_loss[0]))
    split_c = n_fsdp == len(a_par[0][0])
    least_c = (1.0, "")
    for r, mesh in enumerate(c_meshes):
        for n in a_par[0][0]:
            spec = c_steps[r].param_specs[n]
            split_c &= c_par[0][r][n].shape[0] * 2 == ref_before[n].shape[0]
            if n.endswith("k_proj.bias"):
                continue
            b0 = sharded.local_block(mesh, spec, ref_before[n])
            for i in range(2):
                agree = _hold_update(
                    f"dp = 2 FSDP step {i} rank {r} update {n}", b0,
                    c_par[i][r][n], b0,
                    sharded.local_block(mesh, spec, a_par[i][r][n]),
                    failures)
                least_c = min(least_c, (agree, f"{n} rank {r} step {i}"))
    total = sum(t.numel() * t.element_size() for t in a_par[0][0].values())
    log(f"dp = 2 (in-process, bench.py's widths at depth 2, bf16, batch 4 x "
        f"512, accum_steps 2, global-norm clip {clip} against a grad norm of "
        f"{norm:.4e}): replicated first update vs make_train_step's: least "
        f"direction agreement {least[0]:.6f} ({least[1]}); zero1 "
        f"({n_zero1} params' moments split over dp: {split_b}) bitwise the "
        f"replicated step over 2 steps: {same_b}; fsdp_rules ({n_fsdp} params "
        f"split over dp: {split_c}): first loss bitwise {first_c}, updates "
        f"vs the replicated step's: least direction agreement "
        f"{least_c[0]:.6f} ({least_c[1]}); gathered params' peak {peak} "
        f"bytes of the model's {total} (in one process the backward keeps "
        f"them)")
    if not (same_b and split_b):
        failures.append("dp = 2: the zero1 step is not bitwise the "
                        "replicated step's, or split no moment")
    if not (first_c and split_c):
        failures.append(f"dp = 2: the FSDP step's first loss is not the "
                        f"replicated step's ({first_c}) or it split not "
                        f"every param ({split_c})")
    del a_par, c_par, c_steps, ref_before
    torch.cuda.empty_cache()


def parallel_f32_checks(failures, steps=3, lr=1e-4):
    """(d) f32 at bench.py's widths, depth 2, batch 2 x 256: the tp = 2
    sharded step and the pp = 2 pipeline (2 microbatches), 3 AdamW steps
    each in one process on the card and on the CPU, held to
    train_check's tolerances (`_hold_train_rules`)."""
    import torch

    from paddle_tpu_torch.distributed import inprocess, sharded
    from paddle_tpu_torch.optimizer.functional import AdamW

    cfg = dict(PAR_CFG, num_layers=2, dtype="float32")
    batches = [_par_batch(cfg["vocab_size"], 2, 256, "cpu", seed=20 + i)
               for i in range(steps)]
    runs = {"tp": {}, "pp": {}}
    for dev in ("cuda", "cpu"):
        b = [tuple(t.to(dev) for t in bb) for bb in batches]
        meshes = inprocess.local_meshes(tp=2, device=dev)
        parts = [sharded.make_sharded_train_step(m, AdamW(lr), mesh,
                                                 sharded.gpt_rules())
                 for m, mesh in zip(_rank_models(cfg, meshes), meshes)]
        steps_ = [p[0] for p in parts]
        states = [p[1] for p in parts]
        shards = [[sharded.shard_batch(mesh, *bb) for mesh in meshes]
                  for bb in b]
        outs = inprocess.run_ranks(meshes, lambda r, m: steps_[r].forward(
            states[r], shards[0][r], states[r].buffers))
        gs = inprocess.joint_grad([o[0] for o in outs],
                                  [o[1] for o in outs])
        grads = {f"{n} rank {r}": g.detach().cpu()
                 for r in range(2) for n, g in zip(states[r].params, gs[r])}
        del outs, gs
        losses = []
        for i in range(steps):
            res = sharded.run_local_step(steps_, states, shards[i])
            states = [o[0] for o in res]
            losses.append(float(res[0][1]))
        runs["tp"][dev] = dict(losses=losses, grads=grads, params={
            f"{n} rank {r}": t.detach().cpu()
            for r in range(2) for n, t in states[r].params.items()})
        del parts, steps_, states
        meshes = inprocess.local_meshes(pp=2, device=dev)
        fns, params = _pipeline_ranks(cfg, meshes, 2, 1)
        opts = [AdamW(lr) for _ in meshes]
        flat = [{f"{g}/{n}": t for g in p for n, t in p[g].items()}
                for p in params]
        ostates = [o.init(f) for o, f in zip(opts, flat)]
        losses, first = [], None
        for i in range(steps):
            ls, gs = _pipeline_grads(meshes, fns, params, *b[i])
            if first is None:
                first = {f"{k[0]}/{k[1]} rank {r}": v.detach().cpu()
                         for r in range(2) for k, v in gs[r].items()}
            for r in range(2):
                opts[r].update(flat[r], {f"{k[0]}/{k[1]}": v
                                         for k, v in gs[r].items()},
                               ostates[r], inplace=True)
            losses.append(float(ls[0]))
        runs["pp"][dev] = dict(losses=losses, grads=first, params={
            f"{k} rank {r}": t.detach().cpu()
            for r in range(2) for k, t in flat[r].items()})
        del fns, params, flat, ostates
        torch.cuda.empty_cache()
    for name in ("tp", "pp"):
        _hold_train_rules(f"f32 {name} = 2 (in-process, depth 2, batch 2 x "
                          f"256)", runs[name]["cuda"], runs[name]["cpu"], lr,
                          failures)


# ---------------------------------------------------------------------------
# phase 7f: the static Executor's data-parallel tier, the static DGC
# optimizer and the parameter server's data plane
# ---------------------------------------------------------------------------

COLL_BATCH = 8          # the static GPT's batch of phase 7 (static_run)
COLL_STEPS = 5          # timed steps of each data-parallel run
# (b): the zoo-size f32 static GPT of the static checks, its batch (2
# rows a rank at W = 2) and steps, and the DGC optimizer it trains with
COLL_DGC = (dict(t=128, d=768, heads=12, vocab=1024), 4, 3)
COLL_DGC_OPT = dict(learning_rate=1e-3, momentum=0.9, rampup_begin_step=1,
                    sparsity=[0.75, 0.99], local_grad_clip_norm=1.0,
                    num_trainers=2)
# a DGC mask element that differs between card and CPU at the first DGC
# step must be a near-tie: its |v| within this of the threshold on both
DGC_NEAR_RTOL = 1e-4
# (c): bench.py:697-704's Wide&Deep CTR widths (26 sparse slots over 1e6
# ids, 13 dense features, batch 8192) with 8-wide embedding rows held by
# two parameter servers
COLL_CTR = dict(fields=26, vocab=1_000_000, dense=13, dim=8)
COLL_CTR_BATCH = 8192
COLL_CTR_STEPS = 20


def collective_phase(failures):
    """Phase 7f (see the module docstring): (a) the static GPT under
    `with_data_parallel` at W = 1 (NCCL) and W = 2 (in one process)
    against the plain Executor.run, (b) the f32 zoo-size GPT with
    DGCMomentumOptimizer at W = 2, card against CPU, (c) a Downpour CTR
    loop over two parameter servers.  Returns the launches of (a)'s
    timed data-parallel steps."""
    launches = collective_dp_run(failures)
    collective_dgc_check(failures)
    collective_ctr_run(failures)
    return launches


def collective_dp_run(failures):
    """(a) The static GPT of phase 7 (`build_gpt(512, 768, 12, 32768)`,
    batch 8 of `static_feed`, Adam(1e-3)) with FLAGS_amp and
    FLAGS_graph_opt_fuse on, from one startup: the plain Executor.run,
    then `CompiledProgram(main).with_data_parallel()` on a one-rank NCCL
    group (W = 1) and with places=2 (two ranks in this process, 4 rows
    each), a warm-up step and COLL_STEPS timed steps each.  Each dp
    run's first loss (the mean of its fetch) within STATIC_AMP_LOSS_RTOL
    of the plain run's and its first update within STATIC_UPDATE_RTOL
    in norm (`update_error`, the key bias left out); each timed step
    launching exactly W x STATIC_AMP_LAUNCHES; the buckets of
    `last_sync_stats()` ceil(grad bytes / FLAGS_dp_bucket_bytes) per
    dtype; and one W = 2 step with FLAGS_dp_bucket_bytes=0 bitwise the
    bucketed one (loss and every persistable).  Logs host and device ms,
    tokens/s, peak memory, collectives and bucket bytes per step."""
    import collections

    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.distributed import inprocess
    from paddle_tpu_torch.distributed.env import (
        destroy_parallel_env, init_parallel_env,
    )
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import static_zoo
    from paddle_tpu_torch.transpiler import collective as coll

    m = static_zoo.build_gpt(**STATIC_GPT)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    start = dict(scope.vars)
    start_np = interop.scope_to_numpy(scope)
    feed = static_feed(m, STATIC_GPT["vocab"], batch=COLL_BATCH, seed=0)
    tokens = COLL_BATCH * STATIC_GPT["t"]
    bucket = int(fluid.get_flags("dp_bucket_bytes")["FLAGS_dp_bucket_bytes"])
    launches = collections.Counter()

    def first_step(program):
        """One step from the startup values: (loss, state)."""
        sc = fluid.Scope()
        sc.vars.update({n: v.clone() for n, v in start.items()})
        out = exe.run(program, feed=feed, fetch_list=[m.loss_name],
                      scope=sc, return_numpy=False)[0]
        return float(out.float().mean()), sc

    def timed(label, program, width):
        loss0, sc = first_step(program)
        first = interop.scope_to_numpy(sc)
        stats = coll.last_sync_stats() if width else {}

        def step():
            return exe.run(program, feed=feed, fetch_list=[m.loss_name],
                           scope=sc, return_numpy=False)[0]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        backend.reset_launches()
        want = {n: c * max(width, 1) for n, c in STATIC_AMP_LAUNCHES.items()}
        step_ms, losses = [], [loss0]
        for i in range(COLL_STEPS):
            before = dict(backend.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step().float().mean()))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            made = {n: c - before.get(n, 0)
                    for n, c in backend.LAUNCHES.items()}
            made = {n: c for n, c in made.items() if c}
            if made != want:
                failures.append(f"{label} step {i} launches {made} != "
                                f"{want}")
        if width:
            launches.update(backend.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        host_ms = sum(step_ms) / len(step_ms)
        prof = profile_train_step(lambda _: step(), None, (), host_ms,
                                  label=label, steps=2)
        log(f"{label}: step ms {[round(t, 3) for t in step_ms]}, mean "
            f"{host_ms:.3f} ms (host clock, fetch included), device "
            f"{prof['device']:.3f} ms, {tokens / host_ms * 1e3:.0f} "
            f"tokens/s, peak memory {peak / 2 ** 30:.3f} GiB; losses "
            f"{losses}")
        if stats:
            log(f"{label}: per step {stats['psums']} all_reduces "
                f"({stats['mode']}, {stats['buckets']} buckets of "
                f"FLAGS_dp_bucket_bytes {stats['bucket_bytes']}) over "
                f"{stats['grads']} grads, {stats['total_bytes']} grad bytes "
                f"(bucket bytes "
                f"{sorted({b['bytes'] for b in stats['plan']})})")
        if not all(np.isfinite(losses)):
            failures.append(f"{label} losses not finite: {losses}")
        del sc
        return dict(loss0=loss0, first=first, stats=stats, host_ms=host_ms,
                    device=prof["device"], peak=peak)

    def hold(label, got, plain):
        err = abs(got["loss0"] - plain["loss0"]) / abs(plain["loss0"])
        worst, worst_name = update_error(start_np, got["first"],
                                         plain["first"], STATIC_ZERO_GRAD)
        same = all(np.array_equal(got["first"][n], plain["first"][n])
                   for n in plain["first"])
        log(f"{label} vs the plain run: first loss {got['loss0']:.6f} vs "
            f"{plain['loss0']:.6f} (rel err {err:.3e}); worst first update "
            f"||d_dp - d_plain|| / (0.1 ||d_plain||) {worst:.3e} "
            f"({worst_name}); state bitwise the plain run's: {same}")
        if not err <= STATIC_AMP_LOSS_RTOL:
            failures.append(f"{label}: first loss off the plain run's by "
                            f"{err:.3e} > {STATIC_AMP_LOSS_RTOL}")
        if not worst <= 1.0:
            failures.append(f"{label}: first update of {worst_name} off "
                            f"the plain run's by {worst:.3e} of its bound")
        stats = got["stats"]
        by_dtype = collections.Counter()
        for b in stats["plan"]:
            by_dtype[b["dtype"]] += b["bytes"]
        want = {dt: -(-nbytes // bucket) for dt, nbytes in by_dtype.items()}
        have = collections.Counter(b["dtype"] for b in stats["plan"])
        if dict(have) != want or stats["buckets"] != sum(want.values()) \
                or stats["psums"] != stats["buckets"]:
            failures.append(f"{label}: buckets {dict(have)} (psums "
                            f"{stats['psums']}) != ceil(grad bytes / "
                            f"{bucket}) {want}")

    # the step's gradients (the AMP substitute keeps f32 master params)
    grads = {n: torch.ones_like(start[n])
             for n in m.main.backward_sections[0].param_names}
    with tier_flags(amp="on", fuse="on"):
        plain = timed("collective plain static gpt", m.main, 0)
        init_parallel_env()
        try:
            w1 = timed("collective dp W=1 (NCCL)", fluid.CompiledProgram(
                m.main).with_data_parallel(loss_name=m.loss_name), 1)
            hold("collective dp W=1 (NCCL)", w1, plain)
            sync_times("W=1 (NCCL)", grads, [build_mesh(dp=1)])
        finally:
            destroy_parallel_env()
        sync_times("W=2 (in one process)", grads,
                   inprocess.local_meshes(dp=2))
        prog2 = fluid.CompiledProgram(m.main).with_data_parallel(
            loss_name=m.loss_name, places=2)
        w2 = timed("collective dp W=2 (in one process)", prog2, 2)
        hold("collective dp W=2 (in one process)", w2, plain)
        with tier_flags(amp="on", fuse="on", dp_bucket_bytes=0):
            loss0, sc = first_step(prog2)
            per_grad = coll.last_sync_stats()
            state = interop.scope_to_numpy(sc)
        same = loss0 == w2["loss0"] and all(
            np.array_equal(state[n], w2["first"][n]) for n in w2["first"])
        log(f"collective dp W=2, FLAGS_dp_bucket_bytes=0: "
            f"{per_grad['psums']} all_reduces ({per_grad['mode']}) against "
            f"{w2['stats']['psums']} bucketed; loss and state bitwise the "
            f"bucketed step's: {same}")
        if not same or per_grad["mode"] != "per_grad":
            failures.append("collective dp W=2: the per-gradient step is "
                            "not bitwise the bucketed one")
    log(f"collective dp vs plain (the same call): host ms W=1 "
        f"{w1['host_ms']:.3f}, W=2 {w2['host_ms']:.3f}, plain "
        f"{plain['host_ms']:.3f}; device ms {w1['device']:.3f}, "
        f"{w2['device']:.3f}, {plain['device']:.3f}")
    del start
    torch.cuda.empty_cache()
    return dict(launches)


# phase 7g: the GSPMD tier on the static GPT of phase 7 ((a)), zoo BERT
# in f32 ((b), the reference's five pillars) and the lint ((c))
SPMD_TP = {"dp": 2, "mp": 2}
SPMD_STEPS = 3            # steps of each run held against the plain run
SPMD_TIMED = 3            # timed steps of each GSPMD run
SPMD_RTOL, SPMD_ATOL = 2e-3, 2e-5   # bench.py:1856's yardstick (pillar 1)
SPMD_MEM_RTOL = 0.25                # pillar 4
SPMD_BERT_LR = 1e-3                 # the zoo BERT's Adam
# an AMP first update is held off the elements whose plain-run grad lies
# within this many times the two runs' difference of 0: its grad known to
# STATIC_UPDATE_RTOL / 2 (AMP_NEAR of tests/test_torch_fuse.py)
SPMD_NEAR = 2 / STATIC_UPDATE_RTOL
SPMD_SHARDED = ("fc_0.w_0", "fc_1.w_0", "fc_2.w_0", "fc_3.w_0", "fc_4.w_0",
                "fc_5.w_0", "embedding_0.w_0", "fc_0.b_0", "fc_4.b_0")


def spmd_phase(failures):
    """Phase 7g (see the module docstring): (a) the static GPT under its
    default rules on four in-process ranks, (b) the five pillars on zoo
    BERT, (c) the lint over the zoo.  Returns the launches of (a)'s timed
    GSPMD steps."""
    launches = spmd_gpt_run(failures)
    spmd_bert_pillars(failures)
    spmd_lint(failures)
    return launches


def _spmd_plan(exe):
    """The ShardingPlan the executor lowered last."""
    return list(exe._spmd_plans.values())[-1][1]


def _record_heads(fn):
    """A K1-K3 launcher that keeps the head count of each launch (the
    ranks launch from threads of their own; list appends are atomic)."""
    heads = []

    def wrapped(q, *args):
        heads.append(q.shape[1])
        return fn(q, *args)

    return wrapped, heads


def _rank_state(scope):
    """{rank: bytes of the blocks it holds} over a GSPMD scope."""
    state = {}
    for v in scope.vars.values():
        for r, t in v.shards.items():
            state[r] = state.get(r, 0) + t.numel() * t.element_size()
    return state


def spmd_gpt_run(failures, gpt=STATIC_GPT, batch=COLL_BATCH, device=None):
    """(a) of phase 7g.  `device` None runs on the card (the phase); the
    CPU serves a rehearsal at small `gpt` widths."""
    import collections

    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.analysis import sharding as sh
    from paddle_tpu_torch.framework.executor import Executor
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.models import static_zoo
    from paddle_tpu_torch.transpiler import collective as coll

    card = device is None
    m = static_zoo.build_gpt(**gpt)
    exe = fluid.Executor(device)
    scope = fluid.Scope()
    exe.run(m.startup, scope=scope)
    start = dict(scope.vars)
    start_np = interop.scope_to_numpy(scope)
    feeds = [static_feed(m, gpt["vocab"], batch=batch, seed=i)
             for i in range(SPMD_STEPS + SPMD_TIMED)]
    tokens = batch * gpt["t"]
    rules = m.partition_rules()
    launches = collections.Counter()

    def sync():
        if card:
            torch.cuda.synchronize()

    params = m.main.backward_sections[0].param_names
    grad_names = [n + "@GRAD" for n in params]

    def run(label, program, timed=False):
        sc = fluid.Scope()
        sc.vars.update({n: v.clone() for n, v in start.items()})
        losses, first, grads = [], None, None
        for i in range(SPMD_STEPS):
            out = exe.run(program, feed=feeds[i], fetch_list=[
                m.loss_name, *(grad_names if i == 0 else ())],
                scope=sc, return_numpy=False)
            losses.append(float(out[0].float().mean()))
            if i == 0:
                first = interop.scope_to_numpy(sc)
                # a data-parallel fetch of rank >= 1 comes back
                # concatenated over the dp ranks, which hold the same
                # synced grad: the first block is it
                grads = {n: g.float().cpu().numpy()[:start_np[n].shape[0]]
                         for n, g in zip(params, out[1:])}
        res = dict(losses=losses, first=first, grads=grads, scope=sc)
        if not timed:
            return res
        plan = _spmd_plan(exe)
        world = math.prod(plan.mesh_axes.values())
        fused = collections.Counter(
            op.type for op in plan.program.global_block().ops)
        want = {k: fused["fused_attention"] * world for k in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")}
        want.update({k: fused["fused_layer_norm"] * world
                     for k in ("layer_norm_fwd", "layer_norm_bwd")})
        if card:
            torch.cuda.reset_peak_memory_stats()
        backend.reset_launches()
        step_ms, timed_losses = [], []
        for i in range(SPMD_STEPS, SPMD_STEPS + SPMD_TIMED):
            before = dict(backend.LAUNCHES)
            sync()
            t0 = time.perf_counter()
            out = exe.run(program, feed=feeds[i], fetch_list=[m.loss_name],
                          scope=sc, return_numpy=False)[0]
            timed_losses.append(float(out.float().mean()))
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            made = {n: c - before.get(n, 0)
                    for n, c in backend.LAUNCHES.items()}
            made = {n: c for n, c in made.items() if c}
            if card and made != want:
                failures.append(f"{label} step {i} launches {made} != "
                                f"{want} (the plan's fused ops x {world} "
                                f"ranks)")
        launches.update(backend.LAUNCHES)
        host_ms = sum(step_ms) / len(step_ms)
        model = coll.last_sync_stats()["model"]
        peak = torch.cuda.max_memory_allocated() if card else 0
        device_ms = float("nan")
        if card:
            feed = feeds[-1]

            def step(_):
                return exe.run(program, feed=feed, fetch_list=[m.loss_name],
                               scope=sc, return_numpy=False)[0]

            device_ms = profile_train_step(step, None, (), host_ms,
                                           label=label, steps=2)["device"]
            # K1-K3 on a rank's heads: the launches of one step
            fwd, heads_f = _record_heads(fa._launch_fwd)
            dq, heads_q = _record_heads(fa._launch_bwd_dq)
            dkv, heads_k = _record_heads(fa._launch_bwd_dkv)
            saved = fa._launch_fwd, fa._launch_bwd_dq, fa._launch_bwd_dkv
            fa._launch_fwd, fa._launch_bwd_dq, fa._launch_bwd_dkv = \
                fwd, dq, dkv
            try:
                step(None)
            finally:
                fa._launch_fwd, fa._launch_bwd_dq, fa._launch_bwd_dkv = saved
            local = gpt["heads"] // plan.mesh_axes.get("mp", 1)
            heads = sorted(set(heads_f + heads_q + heads_k))
            log(f"{label}: K1/K2/K3 launches of one step on "
                f"{len(heads_f)}/{len(heads_q)}/{len(heads_k)} head blocks "
                f"of {heads} heads (a rank's: {local})")
            if heads != [local] or len(heads_f) != want[
                    "flash_attention_fwd"]:
                failures.append(f"{label}: K1-K3 ran on {heads} heads, "
                                f"not a rank's {local}")
        state = _rank_state(sc)
        log(f"{label}: step ms {[round(t, 3) for t in step_ms]}, mean "
            f"{host_ms:.3f} ms (host clock, fetch included), device "
            f"{device_ms:.3f} ms, {tokens / host_ms * 1e3:.0f} tokens/s, "
            f"peak memory {peak / 2 ** 30:.3f} GiB; each rank's state "
            f"{sorted(set(state.values()))} bytes against the plan's "
            f"{plan.memory['state_bytes']} (replicated "
            f"{sum(t.numel() * t.element_size() for t in start.values())}); "
            f"executed a step: {model['psums']} all-reduces over "
            f"{model['axes']}, {model['total_bytes']} bytes "
            f"({[r['var'] for r in model['records']]}); losses "
            f"{losses + timed_losses}")
        if not all(np.isfinite(timed_losses)):
            failures.append(f"{label}: timed losses not finite: "
                            f"{timed_losses}")
        res.update(plan=plan, host_ms=host_ms, model=model,
                   device=device_ms, peak=peak, state=state)
        return res

    def hold(label, got, plain):
        """Losses within STATIC_AMP_LOSS_RTOL; the first update within
        STATIC_UPDATE_RTOL in norm: the optimizer state over every
        element (`update_error`), each param over the elements whose
        plain-run grad lies beyond SPMD_NEAR times the two runs'
        difference of 0 (bf16 grads take near-zero elements to either
        sign, and Adam's first update is lr times that sign), no more
        than ADAM_NEAR_SHARE of them near zero."""
        errs = [abs(a - b) / abs(b)
                for a, b in zip(got["losses"], plain["losses"])]
        worst, worst_name = update_error(
            start_np, got["first"], plain["first"],
            STATIC_ZERO_GRAD + tuple(params))
        near_n = total = 0
        for n in params:
            if n in STATIC_ZERO_GRAD:
                continue
            g_got = np.asarray(got["grads"][n], np.float64)
            g_plain = np.asarray(plain["grads"][n], np.float64)
            diff = np.abs(g_got - g_plain)
            near = (diff > 0) & (np.abs(g_plain) <= SPMD_NEAR * diff)
            near_n += int(near.sum())
            total += near.size
            keep = ~near.ravel()
            r, _ = update_error(
                {n: start_np[n].ravel()[keep]},
                {n: got["first"][n].ravel()[keep]},
                {n: plain["first"][n].ravel()[keep]})
            if r > worst:
                worst, worst_name = r, n
        log(f"{label} vs the plain run: losses {got['losses']} vs "
            f"{plain['losses']} (rel err {max(errs):.3e}); worst first "
            f"update ||d - d_plain|| / (0.1 ||d_plain||) {worst:.3e} "
            f"({worst_name}), {near_n} of {total} param elements with a "
            f"near-zero grad left out")
        if near_n > ADAM_NEAR_SHARE * total:
            failures.append(f"{label}: {near_n} of {total} param elements "
                            f"with a near-zero grad")
        if not max(errs) <= STATIC_AMP_LOSS_RTOL:
            failures.append(f"{label}: losses off the plain run's by "
                            f"{max(errs):.3e} > {STATIC_AMP_LOSS_RTOL}")
        if not worst <= 1.0:
            failures.append(f"{label}: first update of {worst_name} off "
                            f"the plain run's by {worst:.3e} of its bound")
        if not all(np.isfinite(got["losses"])):
            failures.append(f"{label}: losses not finite: {got['losses']}")

    def shards(label, got):
        plan, sc = got["plan"], got["scope"]
        rows = {r["var"]: r for r in plan.per_var_table()}
        coords = {a: (0, s) for a, s in plan.mesh_axes.items()}
        bad = []
        for name in SPMD_SHARDED:
            for n in (name, f"{name}_adam_0_moment1",
                      f"{name}_adam_0_moment2"):
                v = sc.find_var(n)
                spec = sh.ShardSpec(rows[n]["partition_spec"] or None)
                want = tuple(sh.local_slice(
                    torch.empty(v.shape, device="meta"), spec,
                    coords).shape)
                for r, t in v.shards.items():
                    if tuple(t.shape) != want \
                            or rows[n]["spec"] != rows[name]["spec"]:
                        bad.append((n, r, tuple(t.shape), want))
        table = plan.collective_table().get(("all_reduce", ("mp",)), {})
        model = got["model"]
        log(f"{label}: {len(SPMD_SHARDED)} sharded params and their "
            f"moments of the plan's shapes: {not bad}; executed "
            f"{model['psums']} all-reduces / {model['total_bytes']} bytes, "
            f"planned {table.get('count')} / {table.get('bytes')}")
        if bad:
            failures.append(f"{label}: blocks off the plan's shapes: "
                            f"{bad[:4]}")
        if model["psums"] != table.get("count") \
                or model["total_bytes"] != table.get("bytes") \
                or model["axes"] != ["mp"]:
            failures.append(f"{label}: executed {model['psums']} / "
                            f"{model['total_bytes']} over {model['axes']} "
                            f"!= the plan's {table}")
        if set(got["state"].values()) != {plan.memory["state_bytes"]}:
            failures.append(f"{label}: rank state bytes {got['state']} != "
                            f"the plan's {plan.memory['state_bytes']}")

    with tier_flags(amp="on", fuse="on"):
        plain = run("spmd plain static gpt", m.main)
        dp2 = run("spmd dp W=2", fluid.CompiledProgram(
            m.main).with_data_parallel(loss_name=m.loss_name, places=2))
        hold("spmd dp W=2", dp2, plain)
        del dp2
        sub = Executor._resolve_train_optimized(m.main, [m.loss_name],
                                                True, True)
        for label, mesh in (("spmd {dp=2, mp=2}", SPMD_TP),
                            ("spmd {dp=1, mp=2}", {"dp": 1, "mp": 2})):
            r = sh.PartitionRules.from_dict(dict(rules.to_dict(),
                                                 mesh=mesh))
            got = run(label, fluid.CompiledProgram(m.main)
                      .with_sharding_rules(r, execute=True), timed=True)
            hold(label, got, plain)
            shards(label, got)
            if got["plan"].program is not sub:
                failures.append(f"{label}: the plan is not the AMP + fused "
                                f"substitute's")
            del got
    del start
    if card:
        torch.cuda.empty_cache()
    return dict(launches)


def spmd_bert_pillars(failures, device=None):
    """(b) of phase 7g: bench.py's five pillars (tp_runtime_smoke) on zoo
    BERT in f32 under {dp=2, mp=2}, card and CPU."""
    import tempfile

    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import checkpoint, interop
    from paddle_tpu_torch.analysis import sharding as sh
    from paddle_tpu_torch.models import static_zoo
    from paddle_tpu_torch.transpiler import collective as coll

    m = static_zoo.build("bert")
    rules = m.partition_rules()
    cpu = fluid.Executor(fluid.CPUPlace())
    sc = fluid.Scope()
    cpu.run(m.startup, scope=sc)
    start = interop.scope_to_numpy(sc)
    feeds = [m.smoke_feed(8, seed=i) for i in range(SPMD_STEPS + 1)]
    card = fluid.Executor(device)
    dev = "cuda" if device is None else device

    def run(exe, d, program):
        scope = interop.scope_from_numpy(start, fluid.Scope(), d)
        losses = [float(np.mean(exe.run(program, feed=f,
                                        fetch_list=[m.loss_name],
                                        scope=scope)[0]))
                  for f in feeds[:SPMD_STEPS]]
        return losses, scope, coll.last_sync_stats().get("model")

    def tp():
        return fluid.CompiledProgram(m.main).with_sharding_rules(
            rules, execute=True)

    tp_card = run(card, dev, tp())
    plan = _spmd_plan(card)
    tp_cpu = run(cpu, "cpu", tp())
    dp_card = run(card, dev, fluid.CompiledProgram(m.main).with_data_parallel(
        loss_name=m.loss_name, places=2))
    checks = {}
    checks["1 losses"] = bool(np.allclose(tp_card[0], dp_card[0],
                                          rtol=SPMD_RTOL, atol=SPMD_ATOL)
                              and np.allclose(tp_card[0], tp_cpu[0],
                                              rtol=SPMD_RTOL, atol=SPMD_ATOL))
    got_np = interop.scope_to_numpy(tp_card[1])
    cpu_np = interop.scope_to_numpy(tp_cpu[1])
    # the f32 static card-vs-CPU rule for Adam (an element whose grad
    # lies at 0 may take either sign of lr a step): atol 2 lr steps + 1e-5
    atol = 2 * SPMD_BERT_LR * SPMD_STEPS + 1e-5
    worst = max(float(np.max(np.abs(got_np[n] - w) - 1e-5 * np.abs(w)))
                for n, w in cpu_np.items())
    checks["1 params card vs CPU"] = worst <= atol
    table = plan.collective_table()[("all_reduce", ("mp",))]
    model = tp_card[2]
    checks["2 collectives"] = (model["psums"] == table["count"]
                               and model["total_bytes"] == table["bytes"]
                               and tp_cpu[2]["psums"] == table["count"])
    placed = []
    for row in plan.per_var_table():
        if "mp" not in row["partition_spec"]:
            continue
        v = tp_card[1].find_var(row["var"])
        placed.append(all(t.numel() * t.element_size() * 2
                          == row["full_bytes"] for t in v.shards.values()))
    checks["3 placement"] = bool(placed) and all(placed)
    resident = _rank_state(tp_card[1])
    dp_state = sum(t.numel() * t.element_size()
                   for t in dp_card[1].vars.values())
    est = plan.memory["state_bytes"]
    checks["4 memory"] = all(
        abs(b - est) <= SPMD_MEM_RTOL * est and b < dp_state
        for b in resident.values())
    with tempfile.TemporaryDirectory() as tmp:
        state = dict(tp_card[1].vars)
        checkpoint.save_checkpoint(tmp, state, SPMD_STEPS)
        topo = checkpoint.load_topology(tmp)
        template = interop.scope_from_numpy(start, fluid.Scope(), dev)
        restored, _ = checkpoint.restore_resharded(tmp, dict(template.vars))
        bitwise = all(torch.equal(restored[n], v.full())
                      for n, v in state.items())
        dp4 = fluid.Scope()
        dp4.vars.update(restored)
        a = card.run(fluid.CompiledProgram(m.main).with_sharding_rules(
            sh.PartitionRules([(".*", [])], {"dp": 4}), execute=True),
            feed=feeds[-1], fetch_list=[m.loss_name], scope=dp4)[0]
        b = card.run(tp(), feed=feeds[-1], fetch_list=[m.loss_name],
                     scope=tp_card[1])[0]
    checks["5 checkpoint"] = (bitwise and topo.get("mesh") == SPMD_TP
                              and bool(np.allclose(np.mean(a), np.mean(b),
                                                   rtol=SPMD_RTOL,
                                                   atol=SPMD_ATOL)))
    log(f"spmd bert pillars: losses tp card {tp_card[0]}, tp CPU "
        f"{tp_cpu[0]}, dp card {dp_card[0]}; params card vs CPU worst "
        f"excess {worst:.3e} (atol {atol:.3e}); executed "
        f"{model['psums']} all-reduces / {model['total_bytes']} bytes, "
        f"planned {table['count']} / {table['bytes']}; {len(placed)} "
        f"sharded leaves; rank state bytes {sorted(set(resident.values()))}"
        f" against the plan's {est} and the dp run's {dp_state}; "
        f"checkpoint mesh {topo.get('mesh')}, restored bitwise {bitwise}, "
        f"next loss on {{dp=4}} {float(np.mean(a)):.6f} vs "
        f"{float(np.mean(b)):.6f}; checks {checks}")
    for k, ok in checks.items():
        if not ok:
            failures.append(f"spmd bert pillar {k} failed")


def spmd_lint(failures, device=None):
    """(c) of phase 7g: FLAGS_static_check=error over the zoo's AMP +
    fused substitutes under their default rules, one step each; the lint
    CLI over the zoo."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.analysis import ProgramLintError
    from paddle_tpu_torch.models import static_zoo

    seen = {}
    with tier_flags(amp="on", fuse="on", static_check="error"):
        for name in sorted(static_zoo.BUILDERS):
            m = static_zoo.build(name)
            exe = fluid.Executor(device)
            scope = fluid.Scope()
            exe.run(m.startup, scope=scope)
            prog = fluid.CompiledProgram(m.main).with_sharding_rules(
                m.partition_rules())
            try:
                out = exe.run(prog, feed=m.smoke_feed(8),
                              fetch_list=m.fetches, scope=scope)
                seen[name] = bool(np.all(np.isfinite(out[0])))
            except ProgramLintError as e:
                failures.append(f"spmd lint: {name} raised {e}")
                seen[name] = False
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.program_lint",
         "--all-models", "--sharding-rules", "default"],
        capture_output=True, text=True, timeout=300)
    log(f"spmd lint: FLAGS_static_check=error over the zoo's AMP + fused "
        f"substitutes, one step each, finite: {seen}; program_lint "
        f"--all-models --sharding-rules default: rc {cli.returncode} "
        f"({time.perf_counter() - t0:.1f} s)")
    if cli.returncode != 0:
        failures.append(f"spmd lint: the CLI exited {cli.returncode}: "
                        f"{cli.stdout[-2000:]}{cli.stderr[-2000:]}")
    if not all(seen.values()):
        failures.append(f"spmd lint: non-finite or failed steps {seen}")


def sync_times(label, grads, meshes, reps=5):
    """The gradient sync alone (`sync_gradients` on `grads`, one step's
    shapes, every rank of `meshes` at once), bucketed and per gradient:
    host ms per sync (ends in a sync of the card) and device ms (CUDA
    events around the same calls)."""
    import torch

    from paddle_tpu_torch.distributed import inprocess
    from paddle_tpu_torch.transpiler import collective as coll

    out = {}
    for bucket in (None, 0):
        def run(r, mesh):
            for _ in range(reps):
                coll.sync_gradients(grads, "dp", bucket_bytes=bucket,
                                    mesh=mesh)

        def all_ranks():
            if len(meshes) == 1:
                run(0, meshes[0])
            else:
                inprocess.run_ranks(meshes, run)

        all_ranks()                      # warm-up
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        all_ranks()
        end.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / reps
        stats = coll.last_sync_stats()
        out[stats["mode"]] = (host, start.elapsed_time(end) / reps,
                              stats["psums"])
    nbytes = sum(g.numel() * g.element_size() for g in grads.values())
    log(f"collective sync alone {label}, {nbytes} grad bytes: "
        + "; ".join(f"{mode} {n} all_reduces: host {h:.3f} ms, device "
                    f"{d:.3f} ms a sync ({h / n:.4f} host ms an all_reduce)"
                    for mode, (h, d, n) in out.items()))
    return out


@contextlib.contextmanager
def _static_optimizer(make):
    """Every static_zoo builder called inside trains with `make()` (a
    static optimizer) instead of its own."""
    from paddle_tpu_torch.models import static_zoo

    tail = static_zoo._train_tail
    static_zoo._train_tail = lambda loss, _: tail(loss, make())
    try:
        yield
    finally:
        static_zoo._train_tail = tail


def _dgc_sparsity(step, opt=COLL_DGC_OPT):
    """The sparsity of the dgc op at `step` (its warm-up walk, rampup_step
    1), None before the rampup."""
    begin, levels = opt["rampup_begin_step"], opt["sparsity"]
    if step < begin:
        return None
    prog = min(max(float(step - begin), 0.0), 1.0)
    return levels[min(int(prog * len(levels)), len(levels) - 1)]


def collective_dgc_check(failures):
    """(b) The f32 static GPT of COLL_DGC (`build_gpt(128, 768, 12,
    1024)`) trained by DGCMomentumOptimizer (COLL_DGC_OPT: rampup at step
    1, sparsity [0.75, 0.99], a local clip norm) as a data-parallel
    CompiledProgram at W = 2 in one process, card against CPU, from the
    same startup values, 3 steps.  Held by the f32 static checks' rules
    (`static_check`): the first loss within 1e-4 relative, later 1e-3;
    every persistable (params, U, V, velocities) in norm within 1e-3
    relative + 1e-5 sqrt(n), each update within 0.1 of the CPU's in
    norm.  The masks (the elements each dgc op ships) from the fetched
    GradOut and V: at the first DGC step equal, except near-ties (|v|
    within DGC_NEAR_RTOL of the threshold on both sides), later steps
    also an element carried from an earlier difference or inside the
    two thresholds' band widened by the tensor's noise.  K4 and K5 run
    each rank's two LayerNorms: 4 launches each a step."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import interop
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import static_zoo

    kw, batch, steps = COLL_DGC
    with _static_optimizer(lambda: fluid.optimizer.DGCMomentumOptimizer(
            **COLL_DGC_OPT)):
        m = static_zoo.build_gpt(**kw)
    dgc = [op for op in m.main.global_block().ops if op.type == "dgc"]
    outs = [op.outputs["GradOut"][0] for op in dgc]
    vnames = [op.inputs["V"][0] for op in dgc]
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    cpu_exe.run(m.startup, scope=scope)
    start = interop.scope_to_numpy(scope)
    runs = {}
    for side, dev in (("card", "cuda"), ("cpu", "cpu")):
        exe = fluid.Executor() if dev == "cuda" else cpu_exe
        sc = interop.scope_from_numpy(start, fluid.Scope(), dev)
        prog = fluid.CompiledProgram(m.main).with_data_parallel(
            loss_name=m.loss_name, places=2)
        backend.reset_launches()
        losses, vs, masks = [], [], []
        for i in range(steps):
            got = exe.run(prog, feed=static_feed(m, kw["vocab"], batch, i),
                          fetch_list=[m.loss_name] + outs, scope=sc)
            losses.append(float(got[0]))
            state = interop.scope_to_numpy(sc)
            # each rank's GradOut is the same (the grads are synced): the
            # [2n, ...] fetch is two copies
            # v before the mask: shipped in GradOut, kept in V; the mask
            # is what ships (nonzero; before the rampup nothing does)
            on = _dgc_sparsity(i) is not None
            v, mk = {}, {}
            for v_name, g in zip(vnames, got[1:]):
                g = g[:g.shape[0] // 2]
                v[v_name] = torch.from_numpy(g + state[v_name])
                mk[v_name] = torch.from_numpy((g != 0) & on)
            vs.append(v)
            masks.append(mk)
        runs[side] = dict(losses=losses, state=interop.scope_to_numpy(sc),
                          vs=vs, masks=masks,
                          launches=dict(backend.LAUNCHES))
        del sc
    card, cpu = runs["card"], runs["cpu"]
    want = {"layer_norm_fwd": 4 * steps, "layer_norm_bwd": 4 * steps}
    if card["launches"] != want:
        failures.append(f"collective dgc: card launches {card['launches']} "
                        f"!= {want}")
    loss_err = [abs(a - b) / abs(b) for a, b in zip(card["losses"],
                                                     cpu["losses"])]
    worst, worst_name = 0.0, None
    for n, w in cpu["state"].items():
        d = float(np.linalg.norm((card["state"][n] - w).ravel().astype(
            np.float64)))
        bound = (1e-3 * float(np.linalg.norm(w.ravel().astype(np.float64)))
                 + 1e-5 * np.sqrt(w.size))
        if d / bound > worst:
            worst, worst_name = d / bound, n
    # the attention's key bias (STATIC_ZERO_GRAD) and its velocity: a
    # gradient 0 in exact arithmetic, each device's noise moving it
    skip = {n for n in cpu["state"] if n.split("_dgc")[0] in STATIC_ZERO_GRAD}
    upd, upd_name = update_error(start, card["state"], cpu["state"], skip)
    differ = _hold_static_dgc_masks(card, cpu, failures)
    shipped = [sum(int(mk.sum()) for mk in step.values())
               for step in card["masks"]]
    log(f"collective dgc {kw} batch {batch}, W=2, {steps} "
        f"DGCMomentumOptimizer steps ({len(dgc)} dgc ops, sparsity "
        f"{COLL_DGC_OPT['sparsity']} from step "
        f"{COLL_DGC_OPT['rampup_begin_step']}), card vs CPU: losses card "
        f"{card['losses']} CPU {cpu['losses']}, rel err "
        f"{[f'{e:.2e}' for e in loss_err]}; worst persistable ||d|| / bound "
        f"{worst:.3e} ({worst_name}); worst update / bound {upd:.3e} "
        f"({upd_name}); elements shipped per step {shipped}; mask elements "
        f"differing per step {differ}; card launches {card['launches']}")
    if not all(e <= (1e-4 if i == 0 else 1e-3)
               for i, e in enumerate(loss_err)):
        failures.append(f"collective dgc: losses differ by {loss_err}")
    if not worst <= 1.0:
        failures.append(f"collective dgc: persistable {worst_name} off by "
                        f"{worst:.3e} of its bound")
    if not upd <= 1.0:
        failures.append(f"collective dgc: update of {upd_name} off by "
                        f"{upd:.3e} of its bound")
    if not (shipped[0] == 0 and all(0 < s for s in shipped[1:])):
        failures.append(f"collective dgc: elements shipped per step "
                        f"{shipped}: none before the rampup, some after")


def _hold_static_dgc_masks(card, cpu, failures):
    """The static DGC masks of (b), card against CPU, step by step (the
    rule of `_hold_dgc_masks` with the exact thresholds of the static dgc
    op: the k-th largest |v| on each side).  Returns the mask elements
    that differed per step."""
    import torch

    flipped, differ = {}, []
    for t, (mc, mh) in enumerate(zip(card["masks"], cpu["masks"])):
        differ.append(0)
        s = _dgc_sparsity(t)
        if s is None:
            continue
        for n, m_c in mc.items():
            m_h = mh[n].reshape(-1)
            m_c = m_c.reshape(-1)
            ac = card["vs"][t][n].reshape(-1).abs()
            ah = cpu["vs"][t][n].reshape(-1).abs()
            k = min(max(int(round(ac.numel() * (1.0 - s))), 1), ac.numel())
            tc = float(torch.kthvalue(ac, ac.numel() - k + 1).values)
            th = float(torch.kthvalue(ah, ah.numel() - k + 1).values)
            for side, mk, a, thr in (("card", m_c, ac, tc),
                                     ("CPU", m_h, ah, th)):
                if not torch.equal(mk, (a >= thr) & (a > 0)):
                    failures.append(f"collective dgc step {t} {n}: the "
                                    f"{side}'s mask is not 0 < |v| >= the "
                                    f"k-th largest |v|")
            diff = torch.nonzero(m_c != m_h).reshape(-1)
            if not diff.numel():
                continue
            differ[-1] += diff.numel()
            before = flipped.setdefault(n, set())
            rest = torch.tensor([i for i in diff.tolist()
                                 if i not in before], dtype=torch.long)
            first = not any(_dgc_sparsity(u) is not None for u in range(t))
            if first:
                ok = bool(((ac[rest] - tc).abs() <= DGC_NEAR_RTOL * tc).all()
                          and ((ah[rest] - th).abs()
                               <= DGC_NEAR_RTOL * th).all())
            else:
                agree = torch.ones(ac.numel(), dtype=torch.bool)
                agree[diff] = False
                agree[list(before)] = False
                vc = card["vs"][t][n].reshape(-1)
                vh = cpu["vs"][t][n].reshape(-1)
                noise = float((vc - vh)[agree].abs().max()) \
                    if agree.any() else 0.0
                lo, hi = min(tc, th) - noise, max(tc, th) + noise
                ok = all(bool(((a >= lo) & (a <= hi)).all())
                         for a in (ac[rest], ah[rest]))
            log(f"collective dgc step {t} {n} [{ac.numel()}, k {k}]: masks "
                f"differ in {diff.numel()} ({diff.numel() - rest.numel()} "
                f"carried); thresholds card {tc:.6e} CPU {th:.6e}: "
                f"{'explained' if ok else 'UNEXPLAINED'}")
            if not ok:
                failures.append(f"collective dgc step {t} {n}: "
                                f"{rest.numel()} mask elements differ "
                                f"beyond near-ties, carry-over and noise")
            before.update(diff.tolist())
    return differ


def ctr_model(fields, vocab, dense, dim):
    """static_zoo's Wide&Deep with its embedding `is_sparse` (the table
    the DistributeTranspiler moves to the parameter servers): (main,
    startup, loss name)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers as L

    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.data("ids", [None, fields], dtype="int64")
        den = fluid.data("dense", [None, dense])
        label = fluid.data("label", [None, 1])
        emb = L.embedding(ids, size=(vocab, dim), is_sparse=True)
        deep_in = L.concat([L.reshape(emb, shape=[-1, fields * dim]), den],
                           axis=1)
        deep = L.fc(L.fc(deep_in, 32, act="relu"), 16, act="relu")
        logit = L.elementwise_add(L.fc(deep, 1), L.fc(den, 1))
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        fluid.optimizer.Adagrad(0.05).minimize(loss)
    return main, startup, loss.name


def collective_ctr_run(failures):
    """(c) A Downpour CTR loop: `ctr_model` at COLL_CTR widths,
    transpiled onto two PSServers (localhost threads, adagrad shards of
    dim 8, both seeded 0) through the transpiler's ShardedPSClient; the
    dense step on the card.  COLL_CTR_STEPS steps over a pool of 4
    batches of COLL_CTR_BATCH (ids uniform over the vocab; the label set
    by the first id's parity and the dense features' sum): pull over
    TCP, H2D, the step (fetching the lookup output's @GRAD), D2H, push
    over TCP.  Every pull must equal bitwise the pull of an in-process
    table (`SparseEmbedding` over two native shards seeded 0, pushed the
    same grads), and the loss must fall (the mean of the last 4 steps
    below the first 4's).  Logs pull, H2D, device, D2H and push ms per
    step."""
    import torch

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.transpiler import (DistributeTranspiler,
                                             DistributeTranspilerConfig)

    c = COLL_CTR
    main, startup, loss = ctr_model(**c)
    servers = [ps.PSServer(dim=c["dim"], optimizer="adagrad", lr=0.05,
                           seed=0).start() for _ in range(2)]
    try:
        cfg = DistributeTranspilerConfig()
        cfg.ps_lr, cfg.device = 0.05, "cpu"
        t = DistributeTranspiler(cfg)
        t.transpile(0, program=main, startup_program=startup,
                    pservers=",".join(f"127.0.0.1:{s.port}"
                                      for s in servers))
        table = t.tables[0]
        emb = main._ps_sparse_config[0]["emb_var"]
        mirror = ps.SparseEmbedding(c["dim"], clients=[
            ps._make_shard(c["dim"], optimizer="adagrad", lr=0.05, seed=0)
            for _ in range(2)], device="cpu")
        exe = fluid.Executor()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.default_rng(0)
        pool = []
        for _ in range(4):
            ids = rng.integers(0, c["vocab"], (COLL_CTR_BATCH, c["fields"]))
            den = rng.normal(size=(COLL_CTR_BATCH, c["dense"])).astype(
                np.float32)
            label = (ids[:, :1] % 2 == 0) ^ (den.sum(1, keepdims=True) > 0)
            pool.append((ids, torch.from_numpy(den),
                         torch.from_numpy(label.astype(np.float32))))
        dev = exe.device
        ms = {k: [] for k in ("pull", "H2D", "device", "D2H", "push")}
        losses, mismatched = [], 0
        for i in range(COLL_CTR_STEPS):
            ids, den, label = pool[i % 4]
            t0 = time.perf_counter()
            rows = table.pull(ids)
            t1 = time.perf_counter()
            mismatched += int(not torch.equal(rows, mirror.pull(ids)))
            t2 = time.perf_counter()
            feed = {emb: rows.to(dev), "dense": den.to(dev),
                    "label": label.to(dev)}
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            out = exe.run(main, feed=feed, fetch_list=[loss, emb + "@GRAD"],
                          scope=scope, return_numpy=False)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            grad = out[1].cpu()
            losses.append(float(out[0]))
            t5 = time.perf_counter()
            table.push(ids, grad)
            t6 = time.perf_counter()
            mirror.push(ids, grad)
            for k, a, b in (("pull", t0, t1), ("H2D", t2, t3),
                            ("device", t3, t4), ("D2H", t4, t5),
                            ("push", t5, t6)):
                ms[k].append((b - a) * 1e3)
        t.client.close()
    finally:
        for s in servers:
            s.stop()
    # the first pass over the pool makes each id's row in its shard (a
    # generator seeded per id); later steps find them
    first = {k: sum(v[:4]) / 4 for k, v in ms.items()}
    later = {k: sum(v[4:]) / len(v[4:]) for k, v in ms.items()}
    log(f"collective ctr {c} batch {COLL_CTR_BATCH}, {COLL_CTR_STEPS} "
        f"pull -> step -> push steps over 2 TCP parameter servers: ms per "
        f"step (mean of steps 4-{COLL_CTR_STEPS - 1}, the rows there) "
        + ", ".join(f"{k} {v:.3f}" for k, v in later.items())
        + "; steps 0-3 (rows made on first pull) "
        + ", ".join(f"{k} {v:.3f}" for k, v in first.items())
        + f"; {COLL_CTR_BATCH * c['fields']} ids a step; losses "
        f"{[round(x, 5) for x in losses]}; pulls unequal to the in-process "
        f"table's: {mismatched}")
    if mismatched:
        failures.append(f"collective ctr: {mismatched} pulls over TCP "
                        f"differ from the in-process table's")
    if not np.mean(losses[-4:]) < np.mean(losses[:4]):
        failures.append(f"collective ctr: the loss did not fall: {losses}")
    if not all(np.isfinite(losses)):
        failures.append(f"collective ctr: losses not finite: {losses}")


# ---------------------------------------------------------------------------
# phase 9: the hardened serving tier
# ---------------------------------------------------------------------------

# ServingRuntime part: buckets, requests, rows per request, client threads
SERVE_BUCKETS = (1, 2, 4, 8)
SERVE_REQUESTS = 64
SERVE_CLIENTS = 4
# the fleet: its buckets and requests
FLEET_BUCKETS = (1, 2)
FLEET_REQUESTS = 32
# the engine check's near-tie rule in bf16: the logits are bf16, one ulp
# 2^-8 relative at the top logit, and the engine's 8-slot products round
# otherwise than generate()'s one-row ones, so a first difference where
# generate()'s top-2 logits lie within 4 ulps (2^-6, compare_scaled's
# frac) is a near-tie
ENGINE_BF16_TIE = 2.0 ** -6


def serving_phase(failures):
    """Phase 9, `serving`: the hardened serving tier on the card.

    a. `ServingRuntime` over the saved, fused bf16 static GPT
       (STATIC_GPT, as `io_serve` saves it), buckets SERVE_BUCKETS, with
       telemetry and request tracing on: SERVE_REQUESTS requests of 1-3
       rows from SERVE_CLIENTS client threads.  Each result is held
       bitwise against `Predictor.run` of its rows zero-padded to the
       bucket it rode (read from its trace), and with `compare_scaled`
       against an unbatched `Predictor.run`; the largest unbatched
       difference is printed.  p50/p99 latency, batches per bucket, host
       and device ms per batch at buckets 1 and 8; requests == sum of
       outcomes, `serving.bucket_compile` == the bucket count, K1 and K4
       launched.
    b. The hardened `DecodeEngine` on GPT-2 small bf16 (8 slots, max_len
       1024, buckets 128/256/512): the path phase's 16 requests,
       token-exact against `generate()` (the engine check's near-tie
       rule), its tokens/s and host ms per step and the cost of a
       dispatch thread; a transient armed at `decode.step` retried with
       the tokens unchanged; a per-token budget that a slowed step
       expires; a stalled step past `watchdog_stall_s` giving `stalled`
       outcomes, a broken engine and a flight dump on disk naming the
       stalled request; a threshold-1 breaker opened by a failed
       dispatch and failing fast.  requests == sum of outcomes in every
       run; K6 launched.
    c. The fleet: a `ModelRegistry` publishes the same fused bf16 GPT
       with the greedy next-token `argmax` appended (its [rows, 512] ids
       cross HTTP as JSON; the logits would be 64 MiB of JSON a row) as
       v1 and v2; two in-process `ReplicaServer`s on the card behind a
       `FleetRouter`.  The first replica warms v1 and writes its
       per-bucket `.pt2` cache; the second imports it with 0 bucket
       warm-ups.  FLEET_REQUESTS requests from 2 clients; v2 is rolled
       out mid-stream with 0 dropped; one replica is killed and its
       traffic fails over; requests == sum of outcomes in the fleet
       ledger, requests/s through the router.

    Returns the launches of the driven runs (the reference runs that
    check them are not counted)."""
    import tempfile

    import torch

    from paddle_tpu_torch import flags, monitor
    from paddle_tpu_torch.kernels import backend

    launches = {}
    old_dir = flags.flag("flight_recorder_dir")
    with tempfile.TemporaryDirectory() as tmp:
        flags.set_flags({"flight_recorder_dir": tmp + "/flight"})
        try:
            dirs = _serving_gpt_dirs(tmp)
            for part in (serving_runtime_part, serving_engine_part,
                         serving_fleet_part):
                backend.reset_launches()
                t0 = time.perf_counter()
                _add(launches, part(failures, tmp, dirs))
                log(f"serving {part.__name__}: "
                    f"{time.perf_counter() - t0:.1f} s")
        finally:
            flags.set_flags({"flight_recorder_dir": old_dir,
                             "request_tracing": False})
            monitor.disable()
            monitor.reset()
            monitor.flight_recorder.get().clear()
    log(f"serving launches (runtime, engine, fleet): {launches}")
    torch.cuda.empty_cache()
    return launches


def _serving_gpt_dirs(tmp):
    """The static GPT (STATIC_GPT) fused and AMP-rewritten to bf16 as
    `io_serve` saves it: {"logits": its directory, "argmax": the same
    program with the next-token argmax appended, saved with a second set
    of weights too ("argmax_v2")}."""
    import os

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import amp, passes
    from paddle_tpu_torch.models import static_zoo

    m = static_zoo.build_gpt(**STATIC_GPT)
    dirs = {}
    for seed, names in ((0, ("logits", "argmax")), (1, ("argmax_v2",))):
        scope = fluid.Scope()
        with tier_flags(global_seed=seed):
            exe = fluid.Executor()      # its generator: FLAGS_global_seed
            exe.run(m.startup, scope=scope)
        test = m.main.clone(for_test=True)
        logits = [op for op in test.global_block().ops
                  if op.type == "softmax_with_cross_entropy"][0].inputs[
            "Logits"][0]
        prog = test._prune([logits])
        with tier_flags(amp="off", fuse="off", amp_dtype="bfloat16"):
            amp.rewrite_program(prog)
        fused, _ = passes.fuse_program(prog, fetch_names=[logits])
        for name in names:
            fetch = logits
            if name != "logits":
                with fluid.program_guard(fused, fluid.Program()):
                    fetch = fluid.layers.argmax(
                        fused.global_block().var(logits), axis=-1)
            dirs[name] = os.path.join(tmp, f"serve_{name}")
            with fluid.scope_guard(scope):
                fluid.io.save_inference_model(dirs[name], ["ids"], [fetch],
                                              exe, main_program=fused)
    return dirs


def _trace_buckets(label):
    """{trace_id: the bucket the request rode} from the runtime's
    retained request traces (their batch_join annotation)."""
    from paddle_tpu_torch.monitor import tracing

    out = {}
    for tree in tracing.get().retained_trees(label):
        for s in tree["spans"]:
            for _ts, text in s.get("annotations") or ():
                m = re.match(r"batch_join bucket=(\d+)", text)
                if m:
                    out[tree["trace_id"]] = int(m.group(1))
    return out


def _batch_profile(rt, bucket, feed):
    """Host ms (wall, the host copy included) and device ms (kernels and
    copies, torch.profiler) of one dispatch of `feed` padded to
    `bucket`, as the runtime's batcher makes it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    d = rt.dispatcher
    prepared, _ = d.prepare(feed)
    merged, _ = d.merge([prepared], bucket)
    d.dispatch(merged, bucket)                        # warm
    t0 = time.perf_counter()
    d.dispatch(merged, bucket)
    host = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        d.dispatch(merged, bucket)
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device = sum(us for us, _ in rows) / 1e3
    copy = sum(us for us, k in rows if "Memcpy" in k) / 1e3
    return host, device, copy


def serving_runtime_part(failures, tmp, dirs):
    import threading

    import torch

    from paddle_tpu_torch import flags, monitor
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.monitor import tracing
    from paddle_tpu_torch.serving import ServingRuntime

    flags.set_flags({"request_tracing": True, "trace_sample": 1.0})
    monitor.reset()
    monitor.enable()
    pred = Predictor(dirs["logits"])
    label = "serve_gpt"
    rng = np.random.default_rng(23)
    vocab, t = STATIC_GPT["vocab"], STATIC_GPT["t"]
    feeds = [{"ids": rng.integers(0, vocab, (int(r), t)).astype(np.int64)}
             for r in rng.integers(1, 4, SERVE_REQUESTS)]
    tids = [f"{i + 1:032x}" for i in range(SERVE_REQUESTS)]
    results = [None] * SERVE_REQUESTS
    errors = []
    t0 = time.perf_counter()
    rt = ServingRuntime(pred, buckets=list(SERVE_BUCKETS),
                        max_batch_size=SERVE_BUCKETS[-1],
                        batch_window_s=0.002, label=label)
    warm_s = time.perf_counter() - t0

    def client(k):
        for i in range(k, SERVE_REQUESTS, SERVE_CLIENTS):
            try:
                results[i] = rt.run(feeds[i], timeout=300,
                                    traceparent=f"00-{tids[i]}-"
                                                f"{i + 1:016x}-01")
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    rt.close()
    made = dict(backend.LAUNCHES)
    s = rt.summary()
    counters = monitor.snapshot()["counters"]
    lat = s.get("latency") or {}
    log(f"serving runtime: fused bf16 static GPT {STATIC_GPT}, buckets "
        f"{list(SERVE_BUCKETS)} warmed in {warm_s:.2f} s "
        f"({rt.prewarmed} buckets); {SERVE_REQUESTS} requests "
        f"({sum(len(f['ids']) for f in feeds)} rows) from {SERVE_CLIENTS} "
        f"clients in {wall:.3f} s ({SERVE_REQUESTS / wall:.1f} req/s); "
        f"latency p50 {lat.get('p50_ms')} ms p99 {lat.get('p99_ms')} ms; "
        f"batches {s['batches']} per bucket {s['buckets']}, padded rows "
        f"{s['padded_rows']}; outcomes {s['outcomes']}; launches {made}; "
        f"{card_line()}")
    if errors:
        failures.append(f"serving runtime: {errors[:3]}")
    if s["requests"] != sum(s["outcomes"].values()) \
            or s["outcomes"]["completed"] != SERVE_REQUESTS:
        failures.append(f"serving runtime ledger: requests {s['requests']}"
                        f", outcomes {s['outcomes']}")
    if counters.get("serving.bucket_compile") != len(SERVE_BUCKETS):
        failures.append(f"serving.bucket_compile "
                        f"{counters.get('serving.bucket_compile')} != "
                        f"{len(SERVE_BUCKETS)}")
    for name in ("flash_attention_fwd", "layer_norm_fwd"):
        if made.get(name, 0) < 1:
            failures.append(f"serving runtime: {name} never launched")
    buckets = _trace_buckets(label)
    worst, same = 0.0, 0
    for i, (feed, got) in enumerate(zip(feeds, results)):
        if got is None:
            continue
        rows = len(feed["ids"])
        bucket = buckets.get(tids[i])
        if bucket is None:
            failures.append(f"serving runtime: request {i} has no "
                            "batch_join in its trace")
            continue
        pad = np.zeros((bucket - rows, t), np.int64)
        ref = pred.run({"ids": np.concatenate([feed["ids"], pad])})[0][:rows]
        if np.array_equal(got[0], ref):
            same += 1
        else:
            failures.append(f"serving runtime: request {i} ({rows} rows, "
                            f"bucket {bucket}) differs from Predictor.run "
                            "at the same bucket")
        alone = pred.run(feed)[0]
        # held on the card: the logits are 64 MiB a row
        err, _, _ = compare_scaled(f"serving runtime request {i} vs "
                                   "unbatched",
                                   torch.from_numpy(got[0]).cuda(),
                                   torch.from_numpy(alone).cuda(), failures)
        worst = max(worst, err)
        results[i] = None
    log(f"serving runtime: {same} of {SERVE_REQUESTS} results bitwise equal "
        f"to Predictor.run of their rows at their bucket; largest "
        f"batched-vs-unbatched difference {worst:.6e} (compare_scaled)")
    for bucket in (1, SERVE_BUCKETS[-1]):
        host, device, copy = _batch_profile(rt, bucket, feeds[0])
        log(f"serving runtime batch at bucket {bucket}: host {host:.3f} ms "
            f"(wall, the logits' copy to the host included), device "
            f"{device:.3f} ms (of which copies {copy:.3f} ms)")
    tracing.get().reset()
    flags.set_flags({"request_tracing": False})
    monitor.disable()
    del pred, rt
    return made


def _engine_cfg(**kw):
    from paddle_tpu_torch.serving import DecodeConfig

    kw.setdefault("slots", 8)
    kw.setdefault("max_len", 1024)
    kw.setdefault("buckets", (128, 256, 512))
    return DecodeConfig(**kw)


def _ledger_ok(name, s, failures):
    if s["requests"] != sum(s["outcomes"].values()) or s["pending"]:
        failures.append(f"{name}: requests {s['requests']} != sum of "
                        f"outcomes {s['outcomes']}")


def serving_engine_part(failures, tmp, dirs):
    import json as _json
    import os
    import threading

    import torch

    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.models import generate as G
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.nn import make_generator
    from paddle_tpu_torch.resilience import RetryPolicy, faultinject
    from paddle_tpu_torch.serving import (DecodeEngine, DeadlineExceeded,
                                          EngineBrokenError, WatchdogStall)

    cfg = GPTConfig(dtype="bfloat16")
    model = GPT(cfg, device="cuda", generator=make_generator(0)).eval()
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab_size, size=(4, 256), dtype=np.int32)
    lens = rng.integers(100, 513, size=16)
    news = rng.integers(16, 97, size=16)
    reqs = [(rng.integers(0, cfg.vocab_size, size=int(n), dtype=np.int32),
             int(m)) for n, m in zip(lens, news)]
    made = {}

    # 1. normal traffic with this PR's defaults
    backend.reset_launches()
    eng = DecodeEngine(model, config=_engine_cfg(label="hard"))
    try:
        t0 = time.perf_counter()
        futs = [eng.submit(p, m) for p, m in reqs]
        base = [f.result(timeout=600) for f in futs]
        serve_s = time.perf_counter() - t0
    finally:
        eng.close()
    _add(made, dict(backend.LAUNCHES))
    s = eng.summary()
    dec = s["decode"]
    _ledger_ok("hardened engine", s, failures)
    step_ms = serve_s * 1e3 / max(1, dec["decode_steps"]
                                  + dec["prefill_steps"])
    n_thr = 200
    t0 = time.perf_counter()
    for _ in range(n_thr):
        th = threading.Thread(target=lambda: None)
        th.start()
        th.join()
    thread_ms = (time.perf_counter() - t0) * 1e3 / n_thr
    log(f"hardened engine: {len(reqs)} requests in {serve_s:.3f} s; "
        f"tokens/s {dec.get('tokens_per_s')}; {dec['decode_steps']} decode "
        f"+ {dec['prefill_steps']} prefill dispatches, {step_ms:.3f} ms "
        f"host per dispatch; a dispatch thread costs {thread_ms:.4f} ms "
        f"({thread_ms / step_ms:.2%} of a dispatch); ttft p50 "
        f"{dec.get('ttft', {}).get('p50_ms')} ms; inter-token p50 "
        f"{dec.get('token_latency', {}).get('p50_ms')} ms; launches "
        f"{dict(backend.LAUNCHES)}; {card_line()}")
    if backend.LAUNCHES.get("flash_decode", 0) < 1:
        failures.append("hardened engine: flash_decode never launched")
    params = G.build_decode_params(model)
    exact, margins = 0, []
    for (p, m), tokens in zip(reqs, base):
        ref = G.generate(params, p[None], m).cpu().numpy()[0]
        if np.array_equal(tokens, ref):
            exact += 1
            continue
        step = int(np.argmax(tokens != ref))
        margin = _teacher_margin(params, p, ref, step, "cuda")
        margins.append(margin)
        if margin > ENGINE_BF16_TIE:
            failures.append(f"hardened engine/generate disagree at step "
                            f"{step} with margin {margin:.3e} > "
                            f"{ENGINE_BF16_TIE:.3e}")
    _dispatch_costs(model)
    log(f"hardened engine vs generate() (bf16): {exact} of {len(reqs)} "
        f"token-exact" + (
            f"; the others first differ where generate()'s top-2 logits "
            f"lie within {max(margins):.3e} relative of each other "
            f"(near-tie limit {ENGINE_BF16_TIE:.3e}; "
            f"{sum(m == 0.0 for m in margins)} exact ties)"
            if margins else ""))

    # 2. a transient at decode.step, retried: the same tokens
    backend.reset_launches()
    eng = DecodeEngine(model, config=_engine_cfg(
        label="hard_retry", retry_policy=RetryPolicy(
            max_retries=2, base_delay=0.001, seed=0)))
    faultinject.arm(transient_at_step=-1, transient_times=1)
    try:
        futs = [eng.submit(p, m) for p, m in reqs[:4]]
        got = [f.result(timeout=600) for f in futs]
    finally:
        faultinject.disarm()
        eng.close()
    _add(made, dict(backend.LAUNCHES))
    s = eng.summary()
    _ledger_ok("engine transient", s, failures)
    same = all(np.array_equal(a, b) for a, b in zip(got, base[:4]))
    log(f"engine transient at decode.step: retries "
        f"{s['dispatch_retries']}, outcomes {s['outcomes']}, tokens equal "
        f"to the unfaulted run {same}")
    if s["dispatch_retries"] != 1 or not same:
        failures.append(f"engine transient: retries {s['dispatch_retries']}"
                        f", tokens same {same}")

    # 3. a per-token budget that a slowed step expires
    backend.reset_launches()
    eng = DecodeEngine(model, config=_engine_cfg(label="hard_budget"))
    faultinject.arm(stall_points={"decode.step": (3, 0.3)})
    try:
        tight = eng.submit(reqs[0][0], 32, token_budget_s=0.1)
        loose = eng.submit(reqs[1][0], 8)
        err = tight.exception(timeout=600)
        loose.result(timeout=600)
    finally:
        faultinject.disarm()
        eng.close()
    _add(made, dict(backend.LAUNCHES))
    s = eng.summary()
    _ledger_ok("engine budget", s, failures)
    log(f"engine per-token budget 0.1 s, a 0.3 s step at dispatch 3: "
        f"{type(err).__name__}: {err}; outcomes {s['outcomes']}")
    if not isinstance(err, DeadlineExceeded) \
            or s["outcomes"]["expired"] != 1:
        failures.append(f"engine budget: {err!r}, outcomes {s['outcomes']}")

    # 4. a stalled step: stalled, broken, a flight dump naming it
    backend.reset_launches()
    monitor.flight_recorder.get().clear()
    hang = threading.Event()
    eng = DecodeEngine(model, config=_engine_cfg(
        label="hard_stall", watchdog_stall_s=0.5, watchdog_poll_s=0.05,
        retry_policy=None))
    faultinject.arm(stall_points={"decode.step": (2, hang)})
    try:
        futs = [eng.submit(p, m) for p, m in reqs[:3]]
        errs = [f.exception(timeout=600) for f in futs]
        try:
            eng.submit(reqs[3][0], 4)
            refused = False
        except EngineBrokenError:
            refused = True
    finally:
        hang.set()
        faultinject.disarm()
        eng.close()
    _add(made, dict(backend.LAUNCHES))
    s = eng.summary()
    _ledger_ok("engine stall", s, failures)
    path = monitor.flight_recorder.get().last_dump
    stall_ev = []
    if path and os.path.exists(path):
        with open(path) as f:
            stall_ev = [r for r in map(_json.loads, f)
                        if r.get("event") == "serving_stall"]
    named = stall_ev[0] if stall_ev else {}
    size = os.path.getsize(path) if path and os.path.exists(path) else 0
    log(f"engine stall past 0.5 s at dispatch 2: outcomes {s['outcomes']}, "
        f"watchdog stalls {s['watchdog_stalls']}, new work refused "
        f"{refused}; flight dump {path} ({size} bytes) names op "
        f"{named.get('op')} rid {named.get('rid')} request_ids "
        f"{named.get('request_ids')}")
    if not (s["outcomes"]["stalled"] >= 1 and refused and stall_ev
            and any(isinstance(e, WatchdogStall) for e in errs)
            and (named.get("rid") or named.get("request_ids"))):
        failures.append(f"engine stall: outcomes {s['outcomes']}, refused "
                        f"{refused}, dump {path}, event {named}")

    # 5. a failed dispatch opens a threshold-1 breaker: fail fast
    backend.reset_launches()
    eng = DecodeEngine(model, config=_engine_cfg(
        label="hard_breaker", retry_policy=None, breaker_threshold=1,
        prewarm=False))
    faultinject.arm(transient_at_step=-1, transient_times=1)
    try:
        futs = [eng.submit(p, m) for p, m in reqs[:2]]
        errs = [f.exception(timeout=600) for f in futs]
    finally:
        faultinject.disarm()
    fast = not eng.breaker.allow()
    try:
        eng.submit(reqs[2][0], 4)
        refused = False
    except EngineBrokenError:
        refused = True
    eng.close()
    s = eng.summary()
    _ledger_ok("engine breaker", s, failures)
    log(f"engine breaker (threshold 1): state {s['breaker']['state']}, "
        f"fails fast {fast}, refuses new work {refused}, outcomes "
        f"{s['outcomes']}")
    if s["breaker"]["state"] != "open" or not fast or not refused \
            or s["outcomes"]["failed"] != 1:
        failures.append(f"engine breaker: {s['breaker']['state']}, "
                        f"outcomes {s['outcomes']}")
    del model, params, eng
    torch.cuda.empty_cache()
    return made


def _dispatch_costs(model, steps=48):
    """Host ms per decode step of the engine's 8-slot step (cache 1024,
    320 positions filled, the host copy of its tokens included) as the
    engine could dispatch it: on the calling thread; on a fresh thread
    per step; on one long-lived worker thread; the caller waiting for
    each either blocked or polling every 2 ms (the reference's waiter)
    or 20 ms.  Returns {mode: ms per step}."""
    import queue
    import threading

    import torch

    from paddle_tpu_torch.models import generate as G
    from paddle_tpu_torch.serving import decode as D

    params = G.build_decode_params(model)
    dev = G.params_device(params)
    state = D._fresh_state(params.cfg, 8, 1024, dev)
    temps, gens = [0.0] * 8, [None] * 8
    kill = np.zeros(8, bool)

    def one():
        with torch.inference_mode():
            nxt, was, still = D._decode_step_impl(
                state, params, temps, gens,
                kill=torch.from_numpy(kill).to(dev))
            torch.stack([nxt, was.to(torch.int32),
                         still.to(torch.int32)]).cpu()

    jobs = queue.SimpleQueue()

    def worker():
        while True:
            fn, done = jobs.get()
            if fn is None:
                return
            fn()
            done.set()

    wt = threading.Thread(target=worker, daemon=True)
    wt.start()

    def run(mode):
        where, poll = mode.split(" ")[0].split("/")
        done = threading.Event()
        if where == "caller":
            one()
            return
        if where == "thread":
            def body():
                one()
                done.set()

            threading.Thread(target=body, daemon=True).start()
        else:
            jobs.put((one, done))
        timeout = None if poll == "block" else float(poll) / 1e3
        while not done.wait(timeout=timeout):
            pass

    out = {}
    for mode in ("caller/block", "thread/2", "thread/block", "worker/2",
                 "worker/block", "worker/20", "caller/block again"):
        with torch.inference_mode():
            state["pos"].fill_(320)
            state["active"].fill_(True)
            state["stop"].fill_(1023)
        for _ in range(4):
            run(mode)
        t0 = time.perf_counter()
        for _ in range(steps):
            run(mode)
        out[mode] = (time.perf_counter() - t0) * 1e3 / steps
    jobs.put((None, None))
    wt.join()
    log("engine dispatch cost, host ms per 8-slot decode step (cache 1024, "
        "the token copy included; modes: where the step runs / how the "
        "caller waits): " + ", ".join(f"{k} {v:.3f}" for k, v in out.items())
        + f"; {card_line()}")
    return out


def serving_fleet_part(failures, tmp, dirs):
    import os
    import threading

    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.kernels import backend
    from paddle_tpu_torch.serving import (FleetRouter, ModelRegistry,
                                          ReplicaServer)

    monitor.reset()
    monitor.enable()
    reg = ModelRegistry(os.path.join(tmp, "registry"))
    v1, v2 = reg.publish(dirs["argmax"]), reg.publish(dirs["argmax_v2"])
    reg.set_current(v1)
    kw = {"max_batch_size": FLEET_BUCKETS[-1],
          "buckets": list(FLEET_BUCKETS), "batch_window_s": 0.002}
    t0 = time.perf_counter()
    warm = ReplicaServer(reg, name="r0", config_kw=dict(kw))
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = ReplicaServer(reg, name="r1", config_kw=dict(kw))
    cold_s = time.perf_counter() - t0
    reps = [warm, cold]
    kind = warm.host.device_kind
    log(f"fleet: v{v1} warmed on r0 in {warm_s:.2f} s "
        f"({warm.host.bucket_compiles} bucket warm-ups, "
        f"{warm.host.aot_exported} .pt2 written to "
        f"{os.path.relpath(reg.aot_dir(v1, kind), reg.root)}); r1 "
        f"imported {cold.host.aot_imported} in {cold_s:.2f} s with "
        f"{cold.host.bucket_compiles} bucket warm-ups")
    if cold.host.bucket_compiles != 0 or cold.host.aot_imported \
            != len(FLEET_BUCKETS):
        failures.append(f"fleet: the cold replica warmed "
                        f"{cold.host.bucket_compiles} buckets, imported "
                        f"{cold.host.aot_imported}")
    router = FleetRouter([(s.host.name, "127.0.0.1", s.port) for s in reps],
                         label="fleet_smoke", auto_poll=False,
                         request_timeout_s=120.0)
    rng = np.random.default_rng(29)
    vocab, t = STATIC_GPT["vocab"], STATIC_GPT["t"]
    feeds = [{"ids": rng.integers(0, vocab, (1, t)).astype(np.int64)}
             for _ in range(FLEET_REQUESTS)]
    outs = [None] * FLEET_REQUESTS
    errors = []
    sent = [0]
    lock = threading.Lock()
    # the last quarter waits for the kill, so that it meets a dead replica
    killed = threading.Event()

    def client(k):
        for i in range(k, FLEET_REQUESTS, 2):
            if i >= 3 * FLEET_REQUESTS // 4:
                killed.wait()
            try:
                outs[i] = router.run(feeds[i])
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            with lock:
                sent[0] += 1

    threads = [threading.Thread(target=client, args=(k,)) for k in (0, 1)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    while sent[0] < FLEET_REQUESTS // 4:
        time.sleep(0.005)
    t_roll = time.perf_counter()
    router.roll(v2)                        # hot swap mid-stream
    roll_s = time.perf_counter() - t_roll
    during = sent[0] - FLEET_REQUESTS // 4
    warm.kill()                            # its traffic fails over
    killed.set()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    made = dict(backend.LAUNCHES)
    router.poll_once()
    ledger = router.fleet_ledger()
    router.close()
    for s in reps:
        s.close()
    r = ledger["router"]
    log(f"fleet: {FLEET_REQUESTS} requests through the router in "
        f"{wall:.3f} s ({FLEET_REQUESTS / wall:.2f} req/s); v{v2} rolled "
        f"out in {roll_s:.2f} s with about {during} requests served during "
        f"it; r0 killed: failovers {ledger['failovers']}, "
        f"router outcomes {r['outcomes']}, attempts {ledger['attempts']}, "
        f"merged ledger requests {ledger['merged']['requests']} resolved "
        f"{ledger['merged']['resolved']} unaccounted "
        f"{ledger['merged']['unaccounted']}; launches {made}; "
        f"{card_line()}")
    if errors:
        failures.append(f"fleet: {errors[:3]}")
    dropped = r["requests"] - r["outcomes"].get("completed", 0)
    if dropped or r["requests"] != sum(r["outcomes"].values()) \
            or ledger["failovers"] < 1 \
            or ledger["merged"]["unaccounted"] != 0:
        failures.append(f"fleet: dropped {dropped}, ledger {r}, failovers "
                        f"{ledger['failovers']}")
    # each answer is a version's greedy next tokens
    preds = {v: Predictor(reg.version_dir(v)) for v in (v1, v2)}
    agree = 0
    for feed, out in zip(feeds, outs):
        if out is None:
            continue
        got = np.asarray(out[0], np.int64)
        if any(np.mean(got == p.run(feed)[0]) >= 0.99
               for p in preds.values()):
            agree += 1
    log(f"fleet: {agree} of {FLEET_REQUESTS} answers equal a version's "
        f"Predictor.run (>= 99% of the {t} next-token ids)")
    if agree != FLEET_REQUESTS:
        failures.append(f"fleet: {FLEET_REQUESTS - agree} answers match no "
                        "version")
    for name in ("flash_attention_fwd", "layer_norm_fwd"):
        if made.get(name, 0) < 1:
            failures.append(f"fleet: {name} never launched")
    monitor.disable()
    return made


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
        margin = _teacher_margin(params, p, ref, step, "cuda")
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
                 "dgc", "static", "bert", "beam")


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
    if "bert" in parts:
        o = zoo_bert_run(failures)
        prof = o["profile"]
        per = {n: c / 3 for n, c in o["launches"].items()}
        log(f"compare {tree} bert: step {o['host_ms']:.3f} ms (host, mean "
            f"of 3), device {prof['device']:.3f} ms, K4 "
            f"{prof.get('K4', 0):.4f} ms and K5 {prof.get('K5', 0):.4f} ms "
            f"per step; launches per step {per}")
        del o
    if "beam" in parts:
        o = zoo_beam_run(failures)
        prof = o["profile"]
        log(f"compare {tree} beam: {o['step_ms']:.3f} ms per token step "
            f"(host), device {prof['device']:.3f} ms, K6 {prof['k6']:.4f} "
            f"ms ({prof['k6'] / prof['device']:.1%}) per token step")
        del o
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
MAIN_PATHS = ("train", "resnet", "path", "static", "io", "zoo", "moe",
              "parallel", "collective", "spmd", "serving")


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
              ("io", io_phase), ("zoo", zoo_phase), ("moe", moe_phase),
              ("parallel", parallel_phase),
              ("collective", collective_phase), ("spmd", spmd_phase),
              ("serving", serving_phase), ("checks", check_phase))
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
        # Predictor and CompiledPredictor runs (K1, K4), the zoo phase's
        # BERT steps (K4, K5), BERT eval forward (K1, K4) and beam search
        # (K1, K4, K6), the moe phase's MoE train steps (K1-K5), MoE
        # serving runs (K1, K4, K6) and ring runs (K1-K3), the parallel
        # phase's timed tp = 2, pp = 2 and V = 2 steps (K1-K5), the
        # collective phase's timed data-parallel steps at W = 1 and 2
        # (K1-K5), the spmd phase's timed GSPMD steps at {dp=2, mp=2} and
        # {dp=1, mp=2} (K1-K5), the serving phase's runtime, engines and
        # fleet (K1, K4, K6), and the probe tool's runs (K4, K7 and K9
        # forward)
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
