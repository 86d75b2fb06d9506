"""Global flag registry (port of paddle_tpu/flags.py).

Only the flags that ported slices read are declared.  Semantics are the
reference's: `declare_flag` reads an ``FLAGS_<name>`` environment
override at import, `set_flags`/`get_flags` accept names with or
without the ``FLAGS_`` prefix, and unknown names raise KeyError.
"""

import os

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
             "Default per-token deadline budget for decode requests "
             "(0 = none).  The port does not enforce budgets yet: a "
             "non-zero value makes DecodeConfig raise.")

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
