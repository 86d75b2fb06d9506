"""Always-on flight recorder (port of
paddle_tpu/monitor/flight_recorder.py).

The resilience layer *recovers* from faults; this module *explains*
them.  While a process is healthy the recorder costs almost nothing —
a fixed-size ring of the last K step records, recent compile events,
and recovery events (each one dict append, no I/O, no syncs) — and the
moment a run dies it writes a post-mortem:

- ``flight_<host>_p<rank>_<pid>.jsonl``      — meta (reason/time, the
  fleet rank tag — N ranks dumping into one shared directory never
  collide), the full counter/gauge registry snapshot plus the
  recorder's own (telemetry-gate-free) event counters, the serving
  records, the retained request traces, compile events, recovery
  events, and the last K step records.
- ``flight_<host>_p<rank>_<pid>.trace.json`` — the same window as a
  chrome trace (monitor/trace.py), so the final seconds open in
  Perfetto.

Dump triggers, wired through the resilience taxonomy paths:

- **unhandled exception** — a ``sys.excepthook`` wrapper (chains to the
  previous hook; SystemExit excluded).
- **escalations** — ``RetriesExhausted`` dumps in retry.py and the
  serving watchdog dumps on a stall: these are usually caught by
  the caller, so waiting for the excepthook would lose the window.
- **injected crash** — ``faultinject.crash_point`` dumps before raising
  InjectedCrash (the SIGKILL stand-in; a real SIGKILL can't dump, the
  simulation records what the kill interrupted).
- **OOM** — ``dump_oom(exc)`` writes a ``kind="oom"`` record with the
  requested bytes parsed from the error (torch's "Tried to allocate
  2.00 GiB" as well as the reference's shapes) and the card's own
  allocator stats (``torch.cuda.memory_stats`` under the reference's
  keys ``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit``).
  The reference also writes its allocator's pprof capture alongside;
  torch has no counterpart, so the port does not (ROADMAP §3).
- **atexit backstop** — if a severe event was recorded but nothing
  dumped since (error swallowed, then sys.exit), the exit handler
  writes the dump; clean exits write nothing.

FLAGS_flight_recorder=0 turns the whole machinery off;
FLAGS_flight_recorder_steps sizes the ring;
FLAGS_flight_recorder_dir places the dumps.
"""

import atexit
import collections
import json
import os
import re
import sys
import threading
import time

from .. import flags

__all__ = ["FlightRecorder", "get", "dump", "dump_oom", "note_event",
           "install_hooks"]


# requested-bytes extraction from OOM messages — the reference
# runtime's two shapes, "... to allocate 123456 bytes" and "Attempting
# to allocate 1.91G[iB]", and torch's "Tried to allocate 2.00 GiB"
_OOM_BYTES_RES = (
    re.compile(r"allocat\w*[^\d]{0,40}?([\d][\d,]*)\s*bytes",
               re.IGNORECASE),
    re.compile(r"allocat\w*[^\d]{0,40}?([\d][\d,]*(?:\.\d+)?)\s*"
               r"([KMGT])i?B?\b", re.IGNORECASE),
)
_UNIT = {"K": 2 ** 10, "M": 2 ** 20, "G": 2 ** 30, "T": 2 ** 40}


def _parse_requested_bytes(msg):
    """Bytes the failed allocation asked for, parsed from the error
    text; None when the message carries no recognizable size."""
    if not msg:
        return None
    for pat in _OOM_BYTES_RES:
        m = pat.search(msg)
        if m:
            n = float(m.group(1).replace(",", ""))
            if m.lastindex and m.lastindex >= 2:
                n *= _UNIT[m.group(2).upper()]
            return int(n)
    return None


def _device_memory_stats():
    """Per-card allocator stats under the reference's keys
    (bytes_in_use / peak_bytes_in_use / bytes_limit), {} when no card
    has been initialised in this process (a CPU place) — a post-mortem
    never initialises CUDA just to read it."""
    out = {}
    try:
        import torch

        if not torch.cuda.is_available() or \
                not torch.cuda.is_initialized():
            return {}
        for i in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats(i)
            _free, total = torch.cuda.mem_get_info(i)
            out[str(i)] = {
                "bytes_in_use": int(s.get("allocated_bytes.all.current",
                                          0)),
                "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak",
                                               0)),
                "bytes_reserved": int(s.get("reserved_bytes.all.current",
                                            0)),
                "bytes_limit": int(total),
            }
    except Exception:
        return {}
    return out


class FlightRecorder:
    """Bounded post-mortem ring: steps + compiles + recovery events."""

    def __init__(self, capacity=None):
        # None -> follow FLAGS_flight_recorder live (fluid.set_flags at
        # runtime works); a bool set via the property pins it
        self._enabled_override = None
        cap = int(capacity or flags.flag("flight_recorder_steps"))
        self._lock = threading.Lock()
        self._steps = collections.deque(maxlen=cap)
        self._compiles = collections.deque(maxlen=64)
        self._events = collections.deque(maxlen=128)
        # telemetry-gate-free counters: resilience counters in the
        # monitor registry only move while monitor.is_enabled(); a
        # post-mortem must count recovery events even with telemetry off
        self._counters = {}
        self._last_op_table = None
        self._last_mem_profile = None
        self._last_lints = {}
        self._last_serving = {}
        self._last_oom = None
        self._step_seq = 0
        self._last_step_ns = None
        self._dirty = None        # severe-event reason awaiting a dump
        self._last_dump = None

    @property
    def enabled(self):
        """Live view of FLAGS_flight_recorder (so a runtime
        fluid.set_flags({"FLAGS_flight_recorder": 0}) really disables
        recording AND dumps), unless explicitly pinned by assignment."""
        if self._enabled_override is not None:
            return self._enabled_override
        return bool(flags.flag("flight_recorder"))

    @enabled.setter
    def enabled(self, value):
        self._enabled_override = bool(value)

    # -- recording (hot path: keep allocation-only) ---------------------
    def note_step(self, record=None, host_dispatch_us=None, warmup=False):
        """One executor step.  With telemetry on, `record` is the
        MetricsSession's own dict (shared, not copied); otherwise a
        minimal record is built here — the only steady-state cost the
        recorder adds to a telemetry-off run."""
        if not self.enabled:
            return
        with self._lock:
            self._step_seq += 1
            now_ns = time.perf_counter_ns()
            if record is None:
                record = {"kind": "step", "step": self._step_seq,
                          "ts_us": now_ns / 1e3}
                if self._last_step_ns is not None:
                    record["step_time_s"] = (now_ns - self._last_step_ns) \
                        / 1e9
                if host_dispatch_us is not None:
                    record["host_dispatch_us"] = round(host_dispatch_us, 1)
                if warmup:
                    record["warmup"] = True
            self._last_step_ns = now_ns
            self._steps.append(record)

    def note_compile(self, event):
        """Mirror one compile-ledger event (full cost/memory analysis
        attached) into the ring."""
        if not self.enabled:
            return
        with self._lock:
            self._compiles.append(event)

    def note_compile_marker(self, key):
        """Timestamp-only recompile marker for telemetry-off runs."""
        if not self.enabled:
            return
        self.note_compile({"kind": "compile", "key": key,
                           "ts_us": time.perf_counter_ns() / 1e3,
                           "wall_time": time.time(),
                           "compile_ms": 0.0, "source": "marker"})

    def note_event(self, kind, severe=False, **fields):
        """One recovery/diagnostic event (anomaly, retry, rollback,
        injection, preemption).  severe=True arms the atexit backstop:
        the process should not exit without a dump after this."""
        if not self.enabled:
            return
        ev = {"kind": "event", "event": kind,
              "ts_us": time.perf_counter_ns() / 1e3,
              "wall_time": time.time()}
        ev.update(fields)
        with self._lock:
            self._events.append(ev)
            self._counters[kind] = self._counters.get(kind, 0) + 1
            if severe:
                self._dirty = kind

    def note_op_table(self, split):
        """Latest per-op attribution (the op_profile.static_split
        structure: totals/scopes/unattributed) — the 'what was the
        step made of' section of a post-mortem."""
        if not self.enabled:
            return
        with self._lock:
            self._last_op_table = split

    def note_mem_profile(self, profile):
        """Latest peak-memory attribution (the mem_profile structure:
        peak/timeline/scopes/classes/top_buffers) — the 'what was
        resident at the peak' section an OOM post-mortem writes."""
        if not self.enabled:
            return
        with self._lock:
            self._last_mem_profile = profile

    def note_lint(self, record):
        """Latest static-verifier result per program key (the
        kind="lint" record shape of LintResult.to_record()) — a
        post-mortem of a program that failed validation should say
        WHAT the verifier saw, not just that it ran."""
        if not self.enabled or not record:
            return
        with self._lock:
            self._last_lints[record.get("key")] = dict(record)

    def note_serving(self, record):
        """Latest serving-runtime summary per label (the
        kind="serving" record shape of ServingStats.to_record()) — the
        'what was the serving path doing' section of a post-mortem.
        The serving watchdog refreshes it right before a stall dump so
        the dump carries the current outcome ledger, exact latency
        percentiles and breaker state."""
        if not self.enabled or not record:
            return
        with self._lock:
            self._last_serving[record.get("key")] = dict(record)

    def note_oom(self, exc):
        """Record one memory-exhaustion event: the error text, the
        requested bytes parsed from it and the card allocator's own
        stats (requested-vs-device).  Arms the atexit backstop
        (severe)."""
        if not self.enabled:
            return
        self.note_event("oom", severe=True,
                        error=f"{type(exc).__name__}: {exc}"[:200])
        rec = {"kind": "oom",
               "error": f"{type(exc).__name__}: {exc}"[:2000],
               "ts_us": time.perf_counter_ns() / 1e3,
               "wall_time": time.time()}
        req = _parse_requested_bytes(str(exc))
        if req is not None:
            rec["requested_bytes"] = req
        device = _device_memory_stats()
        if device:
            rec["device_memory"] = device
        with self._lock:
            self._last_oom = rec

    def dump_oom(self, exc, directory=None):
        """OOM post-mortem: capture the memory forensics (note_oom)
        and dump — called BEFORE re-raising an out-of-memory error so
        the run's last act is explaining its own death.  Returns the dump
        path (None when disabled)."""
        if not self.enabled:
            return None
        self.note_oom(exc)
        return self.dump(f"oom:{type(exc).__name__}", directory)

    # -- reading --------------------------------------------------------
    def snapshot(self):
        with self._lock:
            return {
                "steps": list(self._steps),
                "compiles": list(self._compiles),
                "events": list(self._events),
                "counters": dict(self._counters),
                "op_table": self._last_op_table,
                "mem_profile": self._last_mem_profile,
                "lints": list(self._last_lints.values()),
                "serving": list(self._last_serving.values()),
                "oom": self._last_oom,
                "step_seq": self._step_seq,
            }

    def clear(self):
        with self._lock:
            self._steps.clear()
            self._compiles.clear()
            self._events.clear()
            self._counters.clear()
            self._last_op_table = None
            self._last_mem_profile = None
            self._last_lints.clear()
            self._last_serving.clear()
            self._last_oom = None
            self._step_seq = 0
            self._last_step_ns = None
            self._dirty = None
            self._last_dump = None

    # -- the post-mortem ------------------------------------------------
    def dump(self, reason, directory=None):
        """Write the JSONL + chrome-trace pair; returns the JSONL path
        (None when disabled).  Never raises: a post-mortem writer that
        can kill the process it is explaining is worse than none."""
        if not self.enabled:
            return None
        try:
            return self._dump(reason, directory)
        except Exception as e:  # noqa: BLE001
            try:
                print(f"[paddle_tpu_torch.flight_recorder] dump failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
            except Exception:
                pass
            return None

    def _dump(self, reason, directory=None):
        directory = directory or flags.flag("flight_recorder_dir")
        os.makedirs(directory, exist_ok=True)
        snap = self.snapshot()
        from .jsonl_writer import _json_default

        # stable per-process paths: successive dumps overwrite with the
        # newer (larger) window — "a single post-mortem", not a spray.
        # The fleet identity is IN the filename: N ranks
        # dumping into one shared directory never interleave ambiguously
        # (pids alone can collide across hosts).
        from .rank import rank_tag

        rank = rank_tag()
        base = os.path.join(
            directory,
            f"flight_{rank.get('host', 'localhost')}"
            f"_p{rank.get('process_index', 0)}_{os.getpid()}")
        jsonl_path = base + ".jsonl"
        trace_path = base + ".trace.json"
        registry = {}
        try:
            from .. import monitor

            registry = monitor._registry.snapshot()
        except Exception:
            pass
        lines = [{"kind": "meta", "reason": reason,
                  "wall_time": time.time(), "pid": os.getpid(),
                  "argv": list(sys.argv), "step_seq": snap["step_seq"],
                  **rank},
                 {"kind": "counters", "registry": registry,
                  "recorder": snap["counters"]}]
        if snap["op_table"]:
            # SAME record shape as the telemetry JSONL's op_profile
            # lines (top-level totals/scopes/unattributed), so
            # a report reads a dump
            # exactly like a live stream
            lines.append({"kind": "op_profile", **snap["op_table"]})
        if snap["mem_profile"]:
            # likewise one kind="mem_profile" line: peak table +
            # live-bytes timeline, identical to the telemetry stream's
            lines.append({"kind": "mem_profile", **snap["mem_profile"]})
        for lint in snap.get("lints") or ():
            # one kind="lint" line per program key, identical to the
            # telemetry stream's — telemetry_report's lint section
            # reads a dump exactly like a live stream
            lines.append(lint)
        for serving in snap.get("serving") or ():
            # likewise one kind="serving" line per runtime label —
            # outcome ledger, exact latency percentiles, breaker state
            lines.append(serving)
        try:
            # request tracing: the retained span trees as
            # kind="trace" lines — identical to the telemetry stream's,
            # so telemetry_report's tracing section reads a dump like a
            # live stream.  A stall dump therefore NAMES the wedged
            # requests' traces: the stall event's meta carries their
            # trace_ids, and the trees/active listing here carries the
            # spans recorded up to the wedge.
            from . import tracing

            store = tracing.get()
            for tree in store.retained_trees():
                lines.append(tree)
            active = store.active_traces()
            if active:
                lines.append({"kind": "trace_active",
                              "wall_time": time.time(),
                              "active": active})
        except Exception:
            pass
        if snap["oom"]:
            lines.append(snap["oom"])
        lines.extend(snap["events"])
        lines.extend(snap["compiles"])
        lines.extend(snap["steps"])
        tmp = jsonl_path + ".tmp"
        with open(tmp, "w") as f:
            for rec in lines:
                f.write(json.dumps(rec, sort_keys=True,
                                   default=_json_default) + "\n")
        os.replace(tmp, jsonl_path)
        try:
            self._write_trace(trace_path, snap)
        except Exception:
            trace_path = None
        with self._lock:
            self._dirty = None
            self._last_dump = jsonl_path
        print(f"[paddle_tpu_torch.flight_recorder] {reason}: post-mortem at "
              f"{jsonl_path}" + (f" + {trace_path}" if trace_path else ""),
              file=sys.stderr)
        return jsonl_path

    def _write_trace(self, path, snap):
        from .trace import merged_trace_events

        # the port has no host-span profiler yet: the trace carries the
        # step, compile, gauge and request tracks
        host_events = []
        gauge_series = {}
        try:
            from .. import monitor

            # the gauge histories (live-bytes watermark, checkpoint
            # wall-time, backoff) are exactly the pre-crash signal a
            # post-mortem wants — same tracks as the live export
            gauge_series = monitor._registry.gauge_series()
        except Exception:
            pass
        trace_trees = []
        try:
            from . import tracing

            # retained request span trees ride the post-mortem chrome
            # trace as pid-2 tracks, same clock as the host spans
            trace_trees = tracing.get().retained_trees()
        except Exception:
            pass
        events = merged_trace_events(host_events,
                                     step_records=snap["steps"],
                                     compile_events=snap["compiles"],
                                     gauge_series=gauge_series,
                                     trace_trees=trace_trees)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f)

    @property
    def last_dump(self):
        return self._last_dump


_RECORDER = FlightRecorder()


def get():
    return _RECORDER


def dump(reason, directory=None):
    return _RECORDER.dump(reason, directory)


def dump_oom(exc, directory=None):
    return _RECORDER.dump_oom(exc, directory)


def note_event(kind, severe=False, **fields):
    _RECORDER.note_event(kind, severe=severe, **fields)


# -- process hooks ------------------------------------------------------

_hooks_installed = False
_prev_excepthook = None


def _excepthook(exc_type, exc, tb):
    if exc_type is not SystemExit:
        _RECORDER.dump(f"unhandled:{exc_type.__name__}")
    (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)


def _atexit_dump():
    with _RECORDER._lock:
        dirty = _RECORDER._dirty
    if dirty:
        _RECORDER.dump(f"atexit:{dirty}")


def install_hooks():
    """Install the excepthook wrapper + atexit backstop (idempotent).
    Installed even when FLAGS_flight_recorder=0 at import: the hooks
    re-check `enabled` when they fire, so a runtime re-enable still
    gets its post-mortem."""
    global _hooks_installed, _prev_excepthook
    if _hooks_installed:
        return
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    atexit.register(_atexit_dump)
    _hooks_installed = True


install_hooks()
