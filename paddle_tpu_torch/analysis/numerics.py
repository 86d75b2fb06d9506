"""Static dtype-flow / AMP-safety analysis — the PT4xx family (port of
paddle_tpu/analysis/numerics.py).

AMP rewrites a train program's dtypes: a program run under the train
tier goes through a dtype-rewriting pass whose failure modes — a numerically
fragile op landing in low precision, a broken fp32 master-weight chain,
silent cast churn — are invisible until loss curves diverge.  The
reference stack prevented this class of bug with curated per-op lists
(contrib/mixed_precision/fp16_lists.py) applied at rewrite time; this
module is the VERIFIER side of that contract (verifier pass 7): it
re-derives the compute dtype of every op in the program the executor
actually dispatches — following AMP-inserted casts, the fusion tier's
recorded ``compute_dtype``, and the reference's promotion semantics —
and proves the result numerically safe BEFORE a single run.

Diagnostics (see diagnostics.py for the full table):

- **PT401** error — an op of the fragile family (softmax / exp / log /
  loss; the AMP black-list family) resolves to bf16/fp16 compute.
- **PT402** error — an optimizer update whose param or accumulator
  state is not fp32: the master-weight chain is broken and small
  updates round to zero.
- **PT403** warning — cast churn: low-precision identity casts,
  duplicate casts of one value to the same dtype, and down-up round
  trips with no compute between, each priced in bytes.  The flagged
  identity/duplicate kinds are casts the structural pipeline
  (identity_elim / cse) also removes.  (The converse is
  deliberately not total: AMP's ``_amp_inserted`` pins and fp32→fp32
  identity casts are canonical, never flagged, even though
  identity_elim would delete the no-ops among them.)
- **PT404** warning — an accumulating reduction (sum/mean/cumsum
  family) in low precision over more elements than
  ``FLAGS_numerics_reduce_elems``: past ~2^mantissa same-magnitude
  additions the low-precision sum stagnates.
- **PT405** warning — fp16 training without loss scaling: between the
  anomaly guard's finite-check sample points, fp16 grads can overflow
  silently (bf16 is exempt — fp32 exponent range).
- **PT406** warning — fusion near-miss: a ``passes/fuse.py`` pattern
  almost matched but a NAMED guard blocked it (multi-consumer
  intermediate, section boundary, shared cast, protected var, ...);
  the matchers' shared explain mode records which guard fired on
  which op.
- **PT407** warning — feed/fetch dtype drift vs the declared VarDesc:
  the executor inserts an implicit hot-path cast every step.

Numerics classification registry: every registered kernel op type
carries exactly one class — WHITE (MXU-bound, low precision by
design), BLACK (fragile: PT401/PT404), NEUTRAL (dtype-preserving /
follows inputs), or OPAQUE (no float dtype-flow semantics: quant
emulation, collectives, RNN mega-kernels, detection assignment).  The
table is the reference's, unchanged: the port's registry is a subset of
the reference's, and the class of an op not registered here is never
read.

Pure ProgramDesc analysis: no run, no device.
"""

from .. import flags
from ..ops.registry import _OPS
from . import facts
from .diagnostics import Diagnostic

__all__ = ["WHITE", "BLACK", "NEUTRAL", "OPAQUE", "LOW_PRECISION",
           "ACCUM_REDUCTIONS", "numerics_class", "classification",
           "NumericsAnalysis", "analyze"]

LOW_PRECISION = frozenset(("bfloat16", "float16"))
_FLOAT_DTYPES = frozenset(("float16", "bfloat16", "float32", "float64"))

# ---------------------------------------------------------------------------
# the numerics classification registry (audited against ops.registry)
# ---------------------------------------------------------------------------

# WHITE — MXU-bound matmul/conv kernels: computing in the AMP dtype is
# the point (fp32 accumulation happens inside the unit).
WHITE = frozenset((
    "bilinear_tensor_product", "conv2d", "conv2d_fusion",
    "conv2d_inception_fusion", "conv2d_transpose", "conv3d",
    "conv3d_transpose", "conv_shift", "deformable_conv",
    "deformable_conv_v1", "depthwise_conv2d",
    "depthwise_conv2d_transpose", "dot", "fc", "fsp",
    "fused_attention", "fused_bottleneck",
    "fused_fc_elementwise_layernorm", "fusion_repeated_fc_relu",
    "fusion_seqexpand_concat_fc", "fusion_squared_mat_sub",
    "match_matrix_tensor", "matmul", "mul", "multihead_matmul",
    "row_conv", "sequence_conv", "tree_conv", "var_conv_2d",
))

# BLACK — numerically fragile in low precision: transcendentals whose
# value range exceeds the format (exp/sinh/cosh), log-space ops where
# bf16's 8-bit mantissa destroys small offsets (log/log1p/softplus/
# CRF/CTC), softmax and every loss built on it, squared-distance
# losses, and the accumulating reductions (the ACCUM_REDUCTIONS subset
# below, which get the size-gated PT404 instead of the flat PT401).
BLACK = frozenset((
    "bce_loss", "bpr_loss", "center_loss", "cos_sim", "cosh",
    "cross_entropy", "cross_entropy2", "cumsum", "exp",
    "hierarchical_sigmoid", "hinge_loss", "huber_loss", "kldiv_loss",
    "l1_norm", "linear_chain_crf", "log", "log10", "log1p", "log2",
    "log_loss", "log_softmax", "logsigmoid", "margin_rank_loss",
    "mean", "modified_huber_loss", "nce", "norm", "npair_loss",
    "p_norm", "rank_loss", "reduce_mean", "reduce_sum",
    "sample_logits", "sequence_softmax",
    "sigmoid_cross_entropy_with_logits", "sigmoid_focal_loss", "sinh",
    "smooth_l1_loss", "softmax", "softmax_with_cross_entropy",
    "softplus", "square", "square_error_cost", "squared_l2_distance",
    "squared_l2_norm", "sum", "teacher_student_sigmoid_loss",
    "warpctc",
))

# BLACK members that are accumulating reductions: fragile only past an
# element-count threshold (a bf16 sum of 32 values is fine; of 100k it
# stagnates at ~2^8 ulps) — they lint PT404-with-size, never PT401.
ACCUM_REDUCTIONS = frozenset((
    "cumsum", "mean", "reduce_mean", "reduce_sum", "sum",
))

# OPAQUE — no float dtype-flow semantics to analyze: quantization
# emulation (intentionally lossy int8), collectives/transport, RNN
# mega-kernels (the AMP unsupported list already refuses them), decode/
# metric ops, and the detection pipeline's index-heavy assignment ops.
OPAQUE = frozenset((
    "dequantize", "dequantize_abs_max", "dequantize_log",
    "fake_channel_wise_dequantize_max_abs",
    "fake_channel_wise_quantize_abs_max", "fake_dequantize_max_abs",
    "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_quantize_dequantize_moving_average_abs_max",
    "fake_quantize_moving_average_abs_max",
    "fake_quantize_range_abs_max", "moving_average_abs_max_scale",
    "quantize", "quantized_matmul", "requantize",
    "allreduce", "broadcast", "c_allgather", "c_allreduce_max",
    "c_allreduce_min", "c_allreduce_prod", "c_allreduce_sum",
    "c_broadcast", "c_comm_init", "c_reducescatter",
    "c_sync_calc_stream", "c_sync_comm_stream", "get_places", "print",
    "seed",
    "attention_lstm", "fused_embedding_fc_lstm", "fusion_gru",
    "fusion_lstm", "gru", "gru_unit", "lstm", "lstm_unit", "lstmp",
    "accuracy", "auc", "beam_search", "beam_search_decode",
    "chunk_eval", "crf_decoding", "ctc_align", "detection_map",
    "edit_distance", "mean_iou", "positive_negative_pair",
    "precision_recall",
    "anchor_generator", "bipartite_match", "box_clip", "box_coder",
    "box_decoder_and_assign", "collect_fpn_proposals",
    "density_prior_box", "distribute_fpn_proposals",
    "generate_mask_labels", "generate_proposal_labels",
    "generate_proposals", "iou_similarity", "locality_aware_nms",
    "mine_hard_examples", "multiclass_nms", "multiclass_nms2",
    "polygon_box_transform", "prior_box", "retinanet_detection_output",
    "retinanet_target_assign", "rpn_target_assign", "target_assign",
    "yolo_box", "yolov3_loss",
))

# NEUTRAL — dtype-preserving / follows-inputs ops: activations,
# elementwise arithmetic, shape/index/structural ops, normalization
# layers (their kernels keep the stat math sane), pooling, RNG,
# comparisons, optimizer updates (PT402 checks their STATE dtypes),
# and the non-matmul fused epilogues.
NEUTRAL = frozenset((
    "abs", "acos", "adadelta", "adagrad", "adagrad_sparse", "adam",
    "adamax", "adamw", "add_position_encoding", "affine_channel",
    "affine_grid", "arg_max", "arg_min", "argsort", "asin",
    "assign", "assign_value", "atan", "average_accumulates",
    "batch_norm", "bilinear_interp", "cast", "ceil", "clip",
    "clip_by_norm", "concat", "cos", "crop", "crop_tensor", "cvm",
    "data_norm", "decayed_adagrad", "deformable_psroi_pooling",
    "dgc", "dgc_clip_by_norm", "dgc_momentum", "diag", "diag_v2",
    "dpsgd", "dropout", "elementwise_add", "elementwise_div",
    "elementwise_floordiv", "elementwise_max", "elementwise_min",
    "elementwise_mod", "elementwise_mul", "elementwise_pow",
    "elementwise_sub", "elu", "equal", "erf", "expand", "expand_as",
    "expand_v2", "eye", "fill", "fill_any_like", "fill_constant",
    "fill_constant_batch_size_like", "fill_zeros_like",
    "fill_zeros_like2", "filter_by_instag", "flatten", "flatten2",
    "flatten_contiguous_range", "flip", "floor", "ftrl",
    "fused_batch_norm_act", "fused_bias_act", "fused_bn_activation",
    "fused_elemwise_activation",
    "fused_embedding_eltwise_layernorm", "fused_embedding_seq_pool",
    "fused_layer_norm", "fusion_seqconv_eltadd_relu",
    "fusion_seqpool_concat", "fusion_seqpool_cvm_concat",
    "fusion_transpose_flatten_concat", "gather", "gather_nd",
    "gather_tree", "gaussian_random",
    "gaussian_random_batch_size_like", "gelu",
    "get_tensor_from_selected_rows", "greater_equal",
    "greater_than", "grid_sampler", "group_norm", "hard_shrink",
    "hard_sigmoid", "hard_swish", "hash", "im2sequence",
    "increment", "index_select", "instance_norm", "interpolate",
    "is_empty", "isfinite", "isfinite_v2", "isinf_v2", "isnan_v2",
    "kron", "label_smooth", "lamb", "lars_momentum", "layer_norm",
    "leaky_relu", "less_equal", "less_than", "linear_warmup_lr",
    "linspace", "lod_rank_table", "lod_reset", "logical_and",
    "logical_not", "logical_or", "logical_xor", "lookup_table",
    "lookup_table_dequant", "lookup_table_v2", "lrn",
    "masked_select", "max_pool2d_with_index",
    "max_pool3d_with_index", "max_sequence_len", "maximum",
    "maxout", "merge_ids", "merge_selected_rows", "meshgrid",
    "minimum", "minus", "mish", "momentum", "multiplex",
    "nearest_interp", "not_equal", "one_hot", "one_hot_v2", "pad",
    "pad2d", "pad_constant_like", "partial_concat", "partial_sum",
    "piecewise_decay_lr", "pixel_shuffle", "pool2d", "pool3d",
    "pow", "prelu", "proximal_adagrad", "proximal_gd", "prroi_pool",
    "psroi_pool", "pyramid_hash", "randint", "random_crop",
    "randperm", "range", "reciprocal", "reduce_all", "reduce_any",
    "reduce_max", "reduce_min", "reduce_prod", "relu", "relu6",
    "reorder_by_rank", "reshape", "reshape2", "reverse", "rmsprop",
    "roi_align", "roi_perspective_transform", "roi_pool", "roll",
    "round", "rsqrt", "sampling_id", "scale", "scatter",
    "scatter_nd_add", "selu", "sequence_concat",
    "sequence_enumerate", "sequence_erase", "sequence_expand",
    "sequence_expand_as", "sequence_mask", "sequence_pad",
    "sequence_pool", "sequence_reshape", "sequence_reverse",
    "sequence_scatter", "sequence_slice",
    "sequence_topk_avg_pooling", "sequence_unpad", "sgd",
    "sgd_sparse", "shape", "shard_index", "shrink_memory",
    "shuffle_batch", "shuffle_channel", "sigmoid", "sign", "silu",
    "similarity_focus", "sin", "size", "slice", "softshrink",
    "softsign", "space_to_depth", "spectral_norm", "split",
    "split_ids", "spp", "sqrt", "squeeze", "squeeze2", "stack",
    "strided_slice", "swish", "sync_batch_norm", "tan", "tanh",
    "tanh_shrink", "temporal_shift", "tensor_array_to_tensor",
    "thresholded_relu", "tile", "top_k", "top_k_v2", "trace",
    "transpose", "transpose2", "tril_triu", "trilinear_interp",
    "truncated_gaussian_random", "unbind", "unfold",
    "uniform_random", "uniform_random_batch_size_like", "unique",
    "unique_with_counts", "unpool", "unsqueeze", "unsqueeze2",
    "unstack", "where", "where_index",
))


def classification():
    """{op_type: class} over the whole partition (audit surface)."""
    out = {}
    for cls, names in (("white", WHITE), ("black", BLACK),
                       ("neutral", NEUTRAL), ("opaque", OPAQUE)):
        for n in names:
            out[n] = cls
    return out


def numerics_class(op_type):
    """The numerics class of one op type, or None when unclassified
    (the registry-drift audit keeps None unreachable for registered
    kernels)."""
    if op_type in WHITE:
        return "white"
    if op_type in BLACK:
        return "black"
    if op_type in NEUTRAL:
        return "neutral"
    if op_type in OPAQUE:
        return "opaque"
    return None


# ---------------------------------------------------------------------------
# dtype lattice helpers
# ---------------------------------------------------------------------------

_ITEMSIZE = {"float16": 2, "bfloat16": 2, "float32": 4, "float64": 8}


def _dt(x):
    """Normalize a dtype spelling (string, numpy/torch dtype, None)."""
    if x is None:
        return None
    s = str(x)
    for name in ("bfloat16", "float16", "float32", "float64"):
        if s.endswith(name):
            return name
    return s


def _is_float(dt):
    return dt in _FLOAT_DTYPES


def _promote(dts):
    """Promotion (the reference's) over the float members of `dts`: f64 > f32 > the
    single low dtype; mixing bf16 with fp16 promotes to f32.  None when
    no float operand (nothing to analyze)."""
    f = [d for d in dts if _is_float(d)]
    if not f:
        return None
    if "float64" in f:
        return "float64"
    if "float32" in f:
        return "float32"
    low = set(f)
    if len(low) > 1:
        return "float32"
    return f[0]


def _numel(shape):
    """Element count over the KNOWN dims (symbolic batch counts as 1 —
    a lower bound, so thresholds never false-positive on batch size)."""
    if shape is None:
        return None
    n = 1
    for d in shape:
        if d is not None:
            n *= int(d)
    return n


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

class NumericsAnalysis:
    """One dtype-flow run over one program: PT4xx diagnostics, the
    per-var compute-dtype environment, cast-churn accounting, and the
    fusion near-miss records that fed PT406."""

    def __init__(self, program, program_key=None):
        self.program = program
        self.program_key = program_key
        self.diagnostics = []
        self.compute = {}          # var name -> runtime compute dtype
        self.casts_total = 0
        self.churn = []            # churn records (kind, op_index, ...)
        self.churn_bytes = 0
        # churn casts the STRUCTURAL pipeline would remove (identity →
        # identity_elim, duplicate → cse); round trips survive it
        self.churn_removable = 0
        self.near_misses = []
        self.low_precision_ops = 0

    def diag(self, code, message, op=None, op_index=None, var=None,
             callsite=None):
        self.diagnostics.append(Diagnostic(
            code, message,
            op_type=None if op is None else op.type,
            op_index=op_index,
            callsite=(callsite if callsite is not None else
                      (None if op is None
                       else getattr(op, "callsite", None))),
            var=var))

    def near_miss_guards(self):
        """{guard name: count} over the PT406 records — the telemetry
        breakout (top blocking guards per program key)."""
        out = {}
        for nm in self.near_misses:
            g = nm.get("guard") or "?"
            out[g] = out.get(g, 0) + 1
        return dict(sorted(out.items(), key=lambda kv: (-kv[1], kv[0])))

    def by_code(self):
        out = {}
        for d in self.diagnostics:
            out[d.code] = out.get(d.code, 0) + 1
        return dict(sorted(out.items()))

    def to_record(self):
        return {
            "kind": "numerics",
            "key": self.program_key,
            "codes": self.by_code(),
            "casts": self.casts_total,
            "churn_casts": len(self.churn),
            "churn_removable": self.churn_removable,
            "churn_bytes": self.churn_bytes,
            "low_precision_ops": self.low_precision_ops,
            "near_miss_guards": self.near_miss_guards(),
        }

    def render(self):
        lines = [f"numerics analysis: {len(self.diagnostics)} "
                 f"finding(s), {self.low_precision_ops} low-precision "
                 f"op(s), {self.casts_total} cast(s) "
                 f"({len(self.churn)} churn, {self.churn_bytes} bytes)"]
        for d in self.diagnostics:
            lines.append("  " + d.render())
        for nm in self.near_misses:
            lines.append(
                f"  near-miss {nm['pattern']}: guard '{nm['guard']}' "
                f"at op #{nm.get('guard_op_index')} — {nm['detail']}")
        return "\n".join(lines)


def _optimizer_state_slots(op):
    """Input slots holding optimizer STATE: Param plus every slot with
    a matching ``<slot>Out`` output (Moment/Velocity/Beta1Pow/... —
    the accumulator chain an fp32 master copy must cover)."""
    slots = []
    for slot in op.inputs:
        if slot == "Param" or (slot + "Out") in op.outputs:
            slots.append(slot)
    return slots


def analyze(program, fetch_names=None, feed_names=(), specs=None,
            near_misses=None, program_key=None):
    """THE static numerics analysis: dtype-flow propagation →
    PT401/402/404 fragility checks → PT403 churn accounting → PT405
    loss-scaling check → PT406 near-miss explanation → PT407 feed/
    fetch drift.  Run it against the substitute program the executor
    dispatches (``Executor._resolve_train_optimized`` /
    ``tools/program_lint.py --amp --fuse``) — the pristine source has
    no casts to analyze.

    `specs` is the facts.infer_specs result when the caller already
    paid for it (verifier pass 3); `near_misses` overrides the records
    ``passes.fuse_program`` left on ``program._fusion_near_misses``.
    """
    a = NumericsAnalysis(program, program_key=program_key)
    blk = program.global_block()
    ops = list(blk.ops)
    feed_names = set(feed_names or ())
    if specs is None:
        specs = facts.infer_specs(program, feed_names=feed_names)
    declared = {}
    for b in program.blocks:
        for n, v in b.vars.items():
            declared.setdefault(n, v)
    persist = {n for n, v in declared.items() if v.persistable}
    # the SAME WAW definition the graph passes' legality checks use —
    # a cast this analysis calls removable must be one cse/
    # identity_elim may actually remove
    multi = facts.multi_written_names(
        ops, set(feed_names) | persist
        | {n for n, v in declared.items() if v.is_data})
    sections = ([] if program._is_test
                else list(program.backward_sections))
    fetch = set(fetch_names or ())
    threshold = int(flags.flag("numerics_reduce_elems"))
    control_flow = facts.control_flow_types()

    # backward segment of each op (casts produced in one segment are
    # invisible to another — churn dedup must respect the boundary,
    # exactly like amp._insert_casts' per-segment memo and the cse
    # pass's segment scoping; facts.backward_segments is the single
    # definition all three share)
    seg_of = facts.backward_segments(len(ops), sections)

    rt = a.compute      # var name -> runtime compute dtype (or None)
    for n, v in declared.items():
        if v.persistable or v.is_data or n in feed_names:
            rt[n] = _dt(getattr(v, "dtype", None))
    section_at = {}
    for bs in sections:
        section_at.setdefault(bs.pos, []).append(bs)

    def _spec_dt(name):
        s = specs.get(name)
        return _dt(getattr(s, "dtype", None))

    def _bytes_of(name, dt):
        s = specs.get(name)
        n = _numel(getattr(s, "shape", None))
        if n is None:
            return 0
        return n * _ITEMSIZE.get(dt or "", 4)

    # cast provenance for round-trip detection: cast-output name ->
    # (ultimate source name, source dtype, producing cast index chain)
    cast_origin = {}
    seen_casts = {}      # (segment, source name, target dtype) -> idx
    churn_groups = {}    # aggregate one PT403 per (kind, var) group

    def _note_churn(kind, op, i, var, dt, removable, why):
        bts = _bytes_of(var, dt)
        a.churn.append({"kind": kind, "op_index": i, "var": var,
                        "bytes": bts, "removable": removable})
        a.churn_bytes += bts
        if removable:
            a.churn_removable += 1
        key = (kind, var)
        if key in churn_groups:
            return
        churn_groups[key] = True
        a.diag("PT403",
               f"cast churn ({kind}): {why} — {bts} bytes recast per "
               f"step", op=op, op_index=i, var=var)

    for i, op in enumerate(ops):
        for bs in section_at.get(i, ()):
            for p in bs.param_names:
                # grads come back from value_and_grad over the fp32
                # master params — the executor's documented contract
                rt[facts.grad_name(p)] = rt.get(p, "float32")
        if op.type in control_flow or op.type not in _OPS:
            for n in op.output_names():
                rt[n] = _spec_dt(n)
            continue
        in_dts = [rt.get(n, _spec_dt(n)) for n in op.input_names()]
        compute = _promote(in_dts)

        if op.type == "cast":
            x = op.inputs["X"][0]
            to = _dt(op.attrs.get("out_dtype") or op.attrs.get("dtype"))
            out = op.outputs["Out"][0]
            a.casts_total += 1
            src = rt.get(x, _spec_dt(x))
            guarded = (out in fetch or out in persist or out in multi
                       or x in multi)
            # AMP-inserted casts are REQUIRED static pins (the rewrite
            # cannot know the runtime dtype and an identity cast costs
            # nothing) — they are never churn.  Likewise identity
            # UP-casts to fp32 act as dtype assertions; only a
            # redundant LOW-precision identity the user (or a broken
            # pass) wrote is churn.
            amp_pin = bool(op.attrs.get("_amp_inserted"))
            if src is not None and src == to and not amp_pin \
                    and to in LOW_PRECISION and not guarded:
                _note_churn("identity", op, i, x, to, True,
                            f"'{x}' is already {src}; this cast is a "
                            f"no-op (identity_elim removes it)")
            else:
                key = (seg_of[i], x, to)
                first = seen_casts.get(key)
                if first is not None and not guarded:
                    _note_churn(
                        "duplicate", op, i, x, to, True,
                        f"'{x}' was already cast to {to} at op "
                        f"#{first} in this segment (cse removes the "
                        f"duplicate)")
                else:
                    seen_casts.setdefault(key, i)
            origin = cast_origin.get(x)
            if origin is not None and origin[1] == to \
                    and src in LOW_PRECISION and not guarded:
                # down-up round trip with no compute in between: the
                # low-precision hop destroyed mantissa bits for nothing
                _note_churn(
                    "round_trip", op, i, origin[0], to, False,
                    f"'{origin[0]}' ({origin[1]}) was cast down to "
                    f"{src} at op #{origin[2]} and straight back up "
                    f"here; the round trip costs two casts and "
                    f"{16 if src == 'bfloat16' else 13} of fp32's 24 "
                    f"mantissa bits")
            base = cast_origin.get(x, (x, src, i))
            cast_origin[out] = (base[0], base[1], i)
            rt[out] = to
            continue

        cls = numerics_class(op.type)
        if cls == "opaque":
            for n in op.output_names():
                rt[n] = _spec_dt(n)
            continue

        fused_dt = _dt(op.attrs.get("compute_dtype")) \
            if "compute_dtype" in op.attrs else None
        if fused_dt in LOW_PRECISION:
            compute = fused_dt
        low = compute in LOW_PRECISION
        if low:
            a.low_precision_ops += 1

        if cls == "black" and low:
            if op.type in ACCUM_REDUCTIONS:
                x = op.inputs.get("X", [None])[0]
                s = specs.get(x) if x else None
                n_in = _numel(getattr(s, "shape", None))
                outs = op.output_names()
                s_out = specs.get(outs[0]) if outs else None
                n_out = _numel(getattr(s_out, "shape", None))
                acc = (n_in // max(n_out, 1)
                       if n_in is not None and n_out else n_in)
                if acc is not None and threshold > 0 \
                        and acc >= threshold:
                    a.diag(
                        "PT404",
                        f"overflow-prone accumulation: '{op.type}' "
                        f"sums ~{acc} elements per output in "
                        f"{compute} (>= FLAGS_numerics_reduce_elems="
                        f"{threshold}); past ~2^mantissa additions "
                        f"the low-precision sum stagnates — keep the "
                        f"reduction fp32", op=op, op_index=i,
                        var=x)
            else:
                a.diag(
                    "PT401",
                    f"numerically fragile op '{op.type}' (AMP "
                    f"black-list family) computes in {compute}; its "
                    f"value range/mantissa demands fp32 — add it to "
                    f"the AMP black list or cast its inputs up",
                    op=op, op_index=i)

        opdef = _OPS.get(op.type)
        if opdef is not None and opdef.stateful \
                and "Param" in op.inputs:
            for slot in _optimizer_state_slots(op):
                for n in op.inputs.get(slot, ()):
                    dt = rt.get(n, _spec_dt(n))
                    if dt in LOW_PRECISION:
                        a.diag(
                            "PT402",
                            f"optimizer '{op.type}' updates "
                            f"{slot}='{n}' held in {dt}: the fp32 "
                            f"master copy is lost — small updates "
                            f"round to zero and training silently "
                            f"stalls", op=op, op_index=i, var=n)

        # propagation: float outputs take the promoted compute dtype
        # (the fusion tier's recorded compute_dtype wins), non-float
        # outputs (masks, indices, markers) keep their rule dtype
        out_dt = fused_dt or compute
        for n in op.output_names():
            sdt = _spec_dt(n)
            if out_dt is not None and (sdt is None or _is_float(sdt)):
                rt[n] = out_dt
            else:
                rt[n] = sdt

    # ---- PT405: fp16 training without loss scaling --------------------
    fp16_in_play = any(dt == "float16" for dt in rt.values())
    if fp16_in_play and sections and not program._is_test:
        produced_by = {}
        for i, op in enumerate(ops):
            for n in op.output_names():
                produced_by[n] = (i, op)
        for bs in sections:
            prod = produced_by.get(bs.loss_name)
            scaled = (prod is not None and prod[1].type == "scale"
                      and float(prod[1].attrs.get("scale", 1.0)) != 1.0)
            if not scaled:
                op = None if prod is None else prod[1]
                a.diag(
                    "PT405",
                    f"fp16 compute reaches loss '{bs.loss_name}' "
                    f"without loss scaling: between the anomaly "
                    f"guard's finite-check sample points, fp16 grads "
                    f"can overflow silently — wrap the optimizer in "
                    f"amp.decorate (bf16 needs none: fp32 exponent "
                    f"range)", op=op,
                    op_index=None if prod is None else prod[0],
                    var=bs.loss_name)
                break

    # ---- PT406: fusion near-miss explanations -------------------------
    if near_misses is None:
        near_misses = getattr(program, "_fusion_near_misses", None)
    for nm in near_misses or ():
        a.near_misses.append(dict(nm))
        a.diag(
            "PT406",
            f"fusion near-miss: pattern '{nm.get('pattern')}' almost "
            f"matched (anchor '{nm.get('anchor_type')}' at op "
            f"#{nm.get('anchor_index')}) but guard "
            f"'{nm.get('guard')}' blocked it: {nm.get('detail')}",
            op_index=nm.get("anchor_index"),
            var=nm.get("var"),
            callsite=nm.get("callsite"))

    # ---- PT407: feed/fetch dtype drift vs the declared VarDesc --------
    for f in sorted(fetch):
        v = declared.get(f)
        if v is None:
            continue
        decl = _dt(getattr(v, "dtype", None))
        got = rt.get(f)
        if _is_float(decl) and _is_float(got) and decl != got:
            a.diag(
                "PT407",
                f"fetch '{f}' computes in {got} but its VarDesc "
                f"declares {decl}: the executor casts it on the hot "
                f"path every step — re-declare the var or pin the "
                f"producing op's dtype", var=f,
                callsite=getattr(v, "callsite", None))
    low_feeds = [n for n in sorted(feed_names)
                 if _dt(getattr(declared.get(n), "dtype", None))
                 in LOW_PRECISION]
    feed_consumers = {n: [] for n in low_feeds}
    if low_feeds:
        for i, op in enumerate(ops):
            for n in op.input_names():
                if n in feed_consumers:
                    feed_consumers[n].append((i, op))
    for n in low_feeds:
        decl = _dt(declared[n].dtype)
        # a low-precision feed that EVERY consumer immediately casts
        # back up: the declared VarDesc forces a pointless down-up hop
        # through the feed path.  One native low-precision consumer
        # means the declaration is doing real work — no lint.
        consumers = feed_consumers[n]
        up_casts = [i for i, op in consumers
                    if op.type == "cast"
                    and _dt(op.attrs.get("out_dtype")) == "float32"]
        if consumers and len(up_casts) == len(consumers):
            a.diag(
                "PT407",
                f"feed '{n}' is declared {decl} but every consumer "
                f"(first: op #{up_casts[0]}) casts it straight back "
                f"to float32: feed it fp32 and let AMP place the "
                f"down-cast where compute wants it",
                op=ops[up_casts[0]], op_index=up_casts[0], var=n)
    return a
