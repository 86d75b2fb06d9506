"""paddle_tpu_torch.monitor — runtime telemetry (port of the half of
paddle_tpu/monitor/ that the serving tier needs).

- **Counters and gauges** (`registry.py`): one process-wide registry
  every layer reports into while telemetry is enabled.
- **JSONL stream** (`jsonl_writer.py`): with `enable(jsonl_path=...)`,
  every kind="serving" / "trace" / "fleet_serving" record is also
  appended there as one rank-stamped JSON line.
- **Request tracing** (`tracing.py`), the **flight recorder**
  (`flight_recorder.py`, always on, independent of `enable`) and the
  merged Chrome trace (`trace.py`).
- **The live exporter** (`exporter.py`): /metrics and /healthz, started
  by `enable()` and by the serving runtimes iff FLAGS_metrics_port says
  so.

The step session, compile ledger, per-op and memory profiles, the fleet
skew probe and the goodput ledger are ROADMAP item 10: `snapshot()`
carries the counters, the serving table and the tracing summaries.

Usage::

    from paddle_tpu_torch import monitor
    monitor.enable(jsonl_path="telemetry.jsonl")
    ... serve ...
    snap = monitor.snapshot()        # json.dump-safe
    monitor.disable()

Telemetry off (the default) costs the dispatch path one boolean check.
"""

import threading
import time as _time

from .jsonl_writer import JsonlWriter, read_jsonl
from .registry import Counter, Gauge, MetricsRegistry
from . import flight_recorder  # noqa: F401  — installs crash hooks
from . import exporter  # noqa: F401
from . import tracing  # noqa: F401

__all__ = [
    "enable", "disable", "is_enabled", "snapshot", "reset",
    "counter", "gauge", "jsonl_path", "merged_trace_events",
    "flight_recorder", "flight_dump",
    "serving_table", "record_serving", "serving_records",
    "tracing", "record_trace", "trace_records",
    "record_fleet_serving", "fleet_serving_records", "exporter",
    "MetricsRegistry", "JsonlWriter", "read_jsonl", "Counter", "Gauge",
]

# process-global registry: every layer reports into the same place
_registry = MetricsRegistry()
_enabled = False
_writer = None
_writer_lock = threading.Lock()
# kind="serving" records from the serving runtimes and decode engines
_serving_records = []
# kind="trace" records from request tracing: each retained span tree
_trace_records = []
# kind="fleet_serving" records from the fleet router: the merged
# router+replica outcome ledger, failover counts, per-replica health
_fleet_serving_records = []


def _emit(record):
    with _writer_lock:
        w = _writer
    if w is not None:
        w.emit(record)


def enable(jsonl_path=None):
    """Turn telemetry on.  With `jsonl_path`, every record is also
    appended there as one JSON line (`read_jsonl` parses it back —
    rank-stamped and size-cap-rotated per the FLAGS_telemetry_* policy).
    Also starts the live /metrics exporter iff FLAGS_metrics_port says
    so (never raising)."""
    global _enabled, _writer
    if jsonl_path is not None:
        with _writer_lock:
            old, _writer = _writer, JsonlWriter(jsonl_path)
        if old is not None:
            old.close()
    _enabled = True
    exporter.ensure_started()


def disable():
    """Stop recording (recorded data stays readable until `reset`).
    Also detaches the JSONL writer: a later `enable()` without a
    `jsonl_path` records in-process only."""
    global _enabled, _writer
    _enabled = False
    with _writer_lock:
        old, _writer = _writer, None
    if old is not None:
        old.close()


def is_enabled():
    return _enabled


def reset():
    """Drop all recorded telemetry: every counter/gauge (in place — held
    handles stay valid), the kept records and the trace store.  The
    flight recorder's ring is NOT cleared: it is an independent
    always-on post-mortem window (flight_recorder.get().clear())."""
    _registry.reset()
    del _serving_records[:]
    del _fleet_serving_records[:]
    del _trace_records[:]
    tracing.get().reset()


# -- recording entry points ----------------------------------------------

def counter(name):
    return _registry.counter(name)


def gauge(name):
    return _registry.gauge(name)


def record_serving(record):
    """Write one kind="serving" record (a ServingStats.to_record() dict)
    onto the telemetry JSONL stream and keep it addressable in-process
    (serving_records()).  A no-op while telemetry is off."""
    if not _enabled or not record:
        return None
    _serving_records.append(dict(record))
    _emit(record)
    return record


def serving_records():
    """kind="serving" records seen since enable()/reset(), newest last."""
    return list(_serving_records)


def record_trace(record):
    """Write one kind="trace" record (a retained request span tree from
    tracing.py) onto the JSONL stream and keep it in-process
    (trace_records()).  The TraceStore itself is gate-free like the
    serving ledger — this is only the JSONL/export mirror."""
    if not _enabled or not record:
        return None
    _trace_records.append(dict(record))
    _emit(record)
    return record


def trace_records():
    """kind="trace" records seen since enable()/reset(), newest last."""
    return list(_trace_records)


def record_fleet_serving(record):
    """Write one kind="fleet_serving" record (the FleetRouter's merged
    outcome ledger + per-replica health/version/breaker view) onto the
    JSONL stream and keep it in-process (fleet_serving_records()).  A
    no-op while telemetry is off — the router's registered ServingStats
    still carries the live ledger."""
    if not _enabled or not record:
        return None
    record = dict(record)
    record.setdefault("kind", "fleet_serving")
    record.setdefault("ts_us", _time.perf_counter_ns() / 1000.0)
    record.setdefault("wall_time", _time.time())
    _fleet_serving_records.append(record)
    _emit(record)
    return record


def fleet_serving_records():
    """kind="fleet_serving" records seen since enable()/reset(), newest
    last."""
    return list(_fleet_serving_records)


def serving_table():
    """One summary row per live ServingRuntime / DecodeEngine / router —
    request outcomes, exact p50/p99 latency, bucket mix, queue/in-flight
    gauges, breaker state + transitions, watchdog stalls.  Works with
    telemetry off: the serving stats ledger is gate-free."""
    from ..serving import stats as _serving_stats

    return _serving_stats.serving_table()


# -- reading --------------------------------------------------------------

def jsonl_path():
    with _writer_lock:
        return _writer.path if _writer is not None else None


def flight_dump(reason="manual"):
    """Force a flight-recorder post-mortem dump now; returns the JSONL
    path (None when the recorder is disabled)."""
    return flight_recorder.dump(reason)


def snapshot():
    """Point-in-time telemetry snapshot — json.dump-safe: the full
    counter/gauge registry, the serving table and the request-tracing
    summaries."""
    out = {}
    out.update(_registry.snapshot())
    serving = serving_table()
    if serving:
        out["serving"] = serving
    store = tracing.get()
    tr = [s for s in (store.summary(lb) for lb in store.labels())
          if s is not None]
    if tr:
        out["tracing"] = tr
    return out


def merged_trace_events(host_events=()):
    """The unified trace event list: the given host spans plus the gauge
    time-series tracks and the retained request-trace trees."""
    from .trace import merged_trace_events as _merge

    return _merge(list(host_events), gauge_series=_registry.gauge_series(),
                  trace_trees=tracing.get().retained_trees())
