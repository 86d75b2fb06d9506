"""Global flag registry (port of paddle_tpu/flags.py).

Only the flags that ported slices read are declared.  Semantics are the
reference's: `declare_flag` reads an ``FLAGS_<name>`` environment
override at import, `set_flags`/`get_flags` accept names with or
without the ``FLAGS_`` prefix, and unknown names raise KeyError.
"""

import os
import tempfile

_REGISTRY = {}


class _Flag:
    __slots__ = ("name", "default", "value", "type", "help")

    def __init__(self, name, default, help_str):
        self.name = name
        self.default = default
        self.value = default
        self.type = type(default)
        self.help = help_str


def _coerce(flag, value):
    if flag.type is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    return flag.type(value)


def declare_flag(name, default, help_str=""):
    """Declare a global flag. Env var ``FLAGS_<name>`` overrides the default."""
    flag = _Flag(name, default, help_str)
    env = os.environ.get("FLAGS_" + name)
    if env is not None:
        flag.value = _coerce(flag, env)
    _REGISTRY[name] = flag
    return flag


def _key(name):
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _REGISTRY:
        raise KeyError(f"unknown flag: {name}")
    return key


def set_flags(flags_dict):
    """Set flags at runtime. Parity: ``fluid.set_flags``."""
    for name, value in flags_dict.items():
        flag = _REGISTRY[_key(name)]
        flag.value = _coerce(flag, value)


def get_flags(names):
    """Read current flag values. Accepts a name or list of names."""
    if isinstance(names, str):
        names = [names]
    return {"FLAGS_" + _key(n): _REGISTRY[_key(n)].value for n in names}


def flag(name):
    """Fast internal accessor for a single flag value."""
    return _REGISTRY[name].value


# Decode serving (serving/decode.py DecodeConfig defaults).
declare_flag("serving_queue_depth", 64,
             "Serving admission control: max queued requests before "
             "enqueue rejects with backpressure (QueueFullError).")
declare_flag("decode_slots", 8,
             "Continuous-batching decode engine: number of concurrent "
             "sequence slots one decode step carries.")
declare_flag("decode_max_len", 2048,
             "Decode engine KV-cache depth per slot (prompt + generated "
             "tokens must fit).")
declare_flag("decode_token_budget_s", 0.0,
             "Default per-TOKEN deadline budget for decode requests: "
             "each token (including the first, i.e. TTFT) must arrive "
             "within this many seconds of the previous one or the "
             "request is shed/expired into the outcome ledger "
             "(0 = no budget unless the request carries one).")

# The hardened serving runtime (serving/runtime.py ServingConfig).
declare_flag("serving_deadline_s", 0.0,
             "Default per-request deadline budget in seconds "
             "(0 = no deadline unless the request carries one).")
declare_flag("serving_watchdog_stall_s", 30.0,
             "Hang watchdog: a serving dispatch in flight longer than "
             "this triggers a flight-recorder dump and escalates per "
             "watchdog_policy.")

# Always-on flight recorder (monitor/flight_recorder.py): a bounded
# ring of recent step records and recovery events that writes a
# post-mortem JSONL + chrome trace on crash, unhandled exception,
# exhausted retries or a serving stall.  0 disables all of it.  The dumps
# land in the reference's directory name under the process's temp dir
# (/tmp/paddle_tpu_flight unless TMPDIR says otherwise).
declare_flag("flight_recorder", True,
             "Keep the always-on post-mortem ring buffer recording.")
declare_flag("flight_recorder_steps", 256,
             "How many recent step records the flight recorder keeps.")
declare_flag("flight_recorder_dir",
             os.path.join(tempfile.gettempdir(), "paddle_tpu_flight"),
             "Directory flight-recorder post-mortem dumps land in.")

# Request-scoped tracing (monitor/tracing.py): per-request span trees
# through the serving tier with exact tail-latency attribution.  Off by
# default and gate-free when off.
declare_flag("request_tracing", False,
             "Record a span tree (queue / dispatch / retry / stall / "
             "prefill / decode) for every serving request; attribution "
             "tables and SLO accounting derive exactly from the spans.")
declare_flag("trace_sample", 1.0,
             "Head-sampling rate for retaining FULL span trees of "
             "non-violating requests (0.0..1.0).  SLO violators are "
             "always retained regardless; per-request attribution "
             "component rows are always recorded.")
declare_flag("serving_slo_ms", 0.0,
             "End-to-end latency SLO per request in milliseconds: a "
             "completed request slower than this counts as an SLO "
             "violation (slo_violations counter + burn-rate gauge on "
             "/metrics, violator trees always retained).  0 = no SLO.")
declare_flag("trace_buffer", 512,
             "Capacity of the retained full-span-tree ring per serving "
             "label (violators + head-sampled); oldest trees fall out "
             "and are counted in trees_dropped.")

# Live Prometheus exporter (monitor/exporter.py).  0 = off.
declare_flag("metrics_port", 0,
             "Serve /metrics and /healthz on this port (0 = off).")
declare_flag("metrics_host", "127.0.0.1",
             "Bind address for the metrics exporter.  Loopback by "
             "default; set 0.0.0.0 deliberately to let a fleet-level "
             "Prometheus reach it.")

# Telemetry JSONL rotation (monitor/jsonl_writer.py).
declare_flag("telemetry_max_mb", 512,
             "Rotate the telemetry JSONL when the active segment "
             "passes this many MiB (0 = never rotate).")
declare_flag("telemetry_keep", 3,
             "How many rotated telemetry JSONL segments to keep "
             "(beyond the active one).")

# Fleet serving tier (serving/fleet.py router + replicas).
declare_flag("fleet_health_poll_s", 0.5,
             "FleetRouter health-poll interval in seconds (0 = no "
             "background polling; call poll_once() manually).")
declare_flag("fleet_failover_attempts", 2,
             "How many ADDITIONAL replicas a request may fail over to "
             "after its first attempt fails with a transient/"
             "preemption-classified error.  Deadline and fatal "
             "failures never fail over.")
declare_flag("fleet_request_timeout_s", 30.0,
             "Socket timeout for one router->replica request hop.")

# Max pooling (ops/nn_ops.py pool2d).
declare_flag("maxpool_mask_bwd", False,
             "The reference's recompute-mask max-pool backward.  Its tie "
             "semantics (the first maximum of each window in row-major "
             "order gets the gradient) are torch's max-pool gradient's, so "
             "in the port both values give the same op.")

# DGC top-k selection (distributed/strategies.py dgc_topk_mask).
declare_flag("use_pallas_dgc_topk", False,
             "Route DGC top-k gradient selection through the histogram "
             "threshold kernel K10 (kernels/topk_threshold.py) instead of "
             "torch.topk (approximate: keeps >= k elements).")

# Static-graph executor (framework/executor.py).
declare_flag("global_seed", 0,
             "Seed of the Executor's generator, which the random init ops "
             "(uniform_random) and dropout draw from.")

# AMP and the fusion tier (amp/, passes/, Executor._train_tier_modes).
# "train" (the default of the two tier flags) fires only in the dataset
# train loop, train_from_dataset, which is not ported yet (ROADMAP item
# 10): until it is, a bare Executor.run with the defaults runs the
# program as built.  "on" covers every Executor.run of a train program;
# "off" never applies the tier.
declare_flag("amp_dtype", "bfloat16", "Low-precision dtype used by AMP.")
declare_flag("graph_opt_fuse", "train",
             "Fusion pass tier: off | train (dataset train loop only) "
             "| on (every executor-run train program).")
declare_flag("graph_opt_fuse_disable", "",
             "Comma-separated fusion pass names to skip (e.g. "
             "'fuse_attention'); see passes.FUSION_PIPELINE.")
declare_flag("amp", "train",
             "Automatic mixed precision for train programs: off | train "
             "(dataset train loop only) | on (every executor-run train "
             "program).")

# The structural passes (passes/common.py, passes/fold.py) and the
# Predictor's load-time folds (inference.py).  The Executor's
# FLAGS_graph_opt substitution is ROADMAP item 10; `optimize_program`
# reads the disable list below.
declare_flag("graph_opt_disable", "",
             "Comma-separated pass names to skip in optimize_program "
             "(e.g. 'cse,dce'); see passes.DEFAULT_PIPELINE.")
declare_flag("inference_fold", True,
             "Fold conv/fc+batch_norm and scale chains when loading "
             "inference models (Predictor).")

# The static data-parallel step (framework/compiler.py CompiledProgram,
# transpiler/collective.py sync_gradients): gradients are flattened per
# dtype in reverse production order and all-reduced in fixed-capacity
# buckets, one collective per bucket instead of one per gradient (the
# PyTorch-DDP bucketing design).  The mean is elementwise, so the bucketed
# sync equals the per-gradient one bitwise; 0 gives one all_reduce per
# gradient.
declare_flag("dp_bucket_bytes", 4 << 20,
             "Capacity in bytes of one flattened dp gradient-sync "
             "bucket (0 = one all_reduce per gradient).")

# The matmul precision of a CompiledProgram's runs
# (framework/compiler.py resolve_precision / apply_precision_policy):
# "float32" and "highest" turn TF32 off for matmuls and cuDNN,
# "tensorfloat32" turns it on; "" keeps torch's settings.  "bfloat16"
# (a bf16 policy for every product) is ROADMAP item 10.
declare_flag("conv_matmul_precision", "",
             "Default matmul/conv precision for compiled steps "
             "('', 'bfloat16', 'tensorfloat32', 'float32', 'highest').")

# The static Program verifier (analysis/verifier.py): lint every program
# before the Executor runs its first op — shape/dtype inference,
# use-before-def, dead code, aliasing hazards, distributed
# misconfigurations, the sharding (PT3xx) and numerics (PT4xx) passes —
# with results cached per (program, _version), so the steady state pays
# one flag read.  "off" (the default) skips the verifier; "warn" emits a
# ProgramLintWarning once per program version; "error" raises
# ProgramLintError before any op when a PT1xx/PT3xx/PT4xx error is found.
declare_flag("static_check", "off",
             "Static program verification before the run: "
             "off | warn | error.")

# The sharding analyzer (analysis/sharding.py): a parameter the partition
# rules leave replicated above this many bytes lints as PT302 (the giant
# embedding the rule set forgot to shard).  0 disables the check.
declare_flag("replicated_param_bytes", 64 << 20,
             "PT302 threshold: lint a replicated parameter larger "
             "than this many bytes (0 = off).")

# The numerics analyzer (analysis/numerics.py): an accumulating
# reduction (sum/mean/cumsum family) running in bf16/fp16 over at least
# this many elements per output lints as PT404.  0 disables the check.
declare_flag("numerics_reduce_elems", 65536,
             "PT404 threshold: lint a low-precision accumulating "
             "reduction over this many elements per output (0 = off).")
