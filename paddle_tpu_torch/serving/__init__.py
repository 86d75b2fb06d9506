"""paddle_tpu_torch.serving — the hardened serving tier (port of
paddle_tpu/serving).

- `ServingRuntime` (runtime.py): dynamic micro-batching into pre-warmed
  padded bucket shapes (bucketing.py), admission control (bounded
  queue, per-request deadlines), a circuit breaker with jittered retry
  and a degraded mode, and a hang watchdog with a flight-recorder
  post-mortem, over a `Predictor` / `CompiledPredictor`.
- `DecodeEngine` (decode.py): the slot-based continuous-batching decode
  engine on the same hardening stack, with per-TOKEN deadline budgets.
- The fleet: `ModelRegistry` (registry.py, versioned artifacts plus the
  per-bucket `.pt2` AOT cache), `ModelHost` / `ReplicaServer`
  (replica.py, zero-drop hot swap behind HTTP) and `FleetRouter`
  (fleet.py, health gating, per-replica breakers, classified failover,
  the merged fleet ledger).

Observability: exact p50/p99 latency, queue-depth/in-flight gauges,
`resilience.*` counters, request span trees, `monitor.serving_table()`
and kind="serving" records on the telemetry stream and in flight dumps.
Everything runs on the card unless the caller passes a CPU place.
"""

from .bucketing import (BucketDispatcher, default_buckets,  # noqa: F401
                        pick_bucket)
from .decode import (DecodeConfig, DecodeEngine,            # noqa: F401
                     EngineBrokenError, default_prompt_buckets)
from .fleet import (FleetRouter, NoReplicaAvailable,        # noqa: F401
                    ReplicaHandle, ReplicaRequestError,
                    ReplicaUnavailable, router_table)
from .registry import ModelRegistry, RegistryError          # noqa: F401
from .replica import ModelHost, ReplicaServer               # noqa: F401
from .runtime import (DeadlineExceeded, QueueFullError,     # noqa: F401
                      ServingClosedError, ServingConfig,
                      ServingFuture, ServingRuntime)
from .stats import DecodeStats, ServingStats, serving_table  # noqa: F401
from .watchdog import HangWatchdog, WatchdogStall           # noqa: F401

__all__ = [
    "ServingRuntime", "ServingConfig", "ServingFuture",
    "DecodeEngine", "DecodeConfig", "DecodeStats",
    "EngineBrokenError", "default_prompt_buckets",
    "QueueFullError", "ServingClosedError", "DeadlineExceeded",
    "WatchdogStall", "HangWatchdog", "ServingStats", "serving_table",
    "BucketDispatcher", "default_buckets", "pick_bucket",
    "FleetRouter", "ReplicaHandle", "NoReplicaAvailable",
    "ReplicaUnavailable", "ReplicaRequestError", "router_table",
    "ModelRegistry", "RegistryError", "ModelHost", "ReplicaServer",
]
