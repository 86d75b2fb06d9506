"""Unified chrome trace — host spans, step spans, counters (port
of paddle_tpu/monitor/trace.py).

One Perfetto/chrome://tracing load shows, on a shared timeline:

  pid 0 ("host")       RecordEvent spans, one track per recording thread
  pid 1 ("train steps") step-boundary spans + compile spans
  pid 1 counter tracks  examples/s, cache hit/miss, live bytes
  pid 2 ("requests")    per-request serving span trees:
                        one track per retained trace, span nesting =
                        the trace's parent/child structure, per-token
                        progress as instant events

All timestamps are the profiler's span clock (perf_counter μs), so the
tracks align without cross-clock skew — request tracing stamps spans
with the same perf_counter_ns clock.  The flight recorder's dumps carry
`merged_trace_events`; this module only builds the event list.
"""

__all__ = ["merged_trace_events", "host_span_events",
           "request_trace_events"]

_HOST_PID = 0
_STEP_PID = 1
_REQUEST_PID = 2
_STEP_TID = 0
_COMPILE_TID = 1


def host_span_events(events):
    """RecordEvent spans -> trace rows.
    Each row carries the real recording-thread id so producer-thread
    spans (train_from_dataset prefetch) get their own track."""
    return [
        {"name": e["name"], "ph": "X", "ts": e["ts"], "dur": e["dur"],
         "pid": _HOST_PID, "tid": e.get("tid", e.get("depth", 0)),
         "cat": "host", "args": {"depth": e.get("depth", 0)}}
        for e in events
    ]


def _metadata_events(host_events):
    # fleet identity on every process block: rank streams
    # written into a shared dir stay attributable, and a multi-process
    # merge can remap pids per rank.
    # Single-process process NAMES are unchanged; the rank rides in
    # the metadata args (plus a "rankN:" prefix once there IS a fleet).
    from .rank import rank_info

    prefix = ""
    info = rank_info()
    rank = {"host": info["host"], "process_index": info["process_index"]}
    if info.get("process_count", 1) > 1:
        prefix = f"rank{info['process_index']}:"
    out = [
        {"name": "process_name", "ph": "M", "pid": _HOST_PID,
         "args": {"name": prefix + "host", **rank}},
        {"name": "process_name", "ph": "M", "pid": _STEP_PID,
         "args": {"name": prefix + "train steps", **rank}},
        {"name": "thread_name", "ph": "M", "pid": _STEP_PID,
         "tid": _STEP_TID, "args": {"name": "steps"}},
        {"name": "thread_name", "ph": "M", "pid": _STEP_PID,
         "tid": _COMPILE_TID, "args": {"name": "compiles"}},
    ]
    for tid in sorted({e.get("tid", 0) for e in host_events}):
        out.append({"name": "thread_name", "ph": "M", "pid": _HOST_PID,
                    "tid": tid, "args": {"name": f"thread-{tid}"}})
    return out


def _gauge_events(gauge_series):
    """Gauge histories -> one chrome counter track per gauge
    (checkpoint wall-time, live-bytes watermarks, backoff delays...),
    alongside the sampled-counter tracks.  Non-numeric gauge values
    are skipped — Perfetto counters are numbers."""
    out = []
    for name, samples in sorted(gauge_series.items()):
        arg = name.rsplit(".", 1)[-1]
        for ts, v in samples:
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            out.append({"name": name, "ph": "C", "ts": ts,
                        "pid": _STEP_PID, "args": {arg: v}})
    return out


def _step_events(records):
    """Step records -> one X span per step + counter samples at each
    step boundary."""
    out = []
    for r in records:
        dur_us = r.get("step_time_s", 0.0) * 1e6 * r.get("steps", 1)
        start = r["ts_us"] - dur_us
        args = {"step": r.get("step")}
        for k in ("examples", "host_dispatch_us", "feed_bytes",
                  "fetch_bytes", "steps", "label"):
            if r.get(k) is not None:
                args[k] = r[k]
        out.append({"name": "step", "ph": "X", "ts": start,
                    "dur": dur_us, "pid": _STEP_PID, "tid": _STEP_TID,
                    "cat": "step", "args": args})
        # counter tracks: one sample per step end
        if r.get("examples_per_sec") is not None:
            out.append({"name": "examples/s", "ph": "C", "ts": r["ts_us"],
                        "pid": _STEP_PID,
                        "args": {"examples/s": r["examples_per_sec"]}})
        counters = r.get("counters") or {}
        cache = {}
        hits = counters.get("run_plan.hit", 0) \
            + counters.get("compiled_step.hit", 0)
        misses = counters.get("run_plan.miss", 0) \
            + counters.get("compiled_step.miss", 0)
        if hits or misses:
            cache = {"hit": hits, "miss": misses}
            out.append({"name": "cache", "ph": "C", "ts": r["ts_us"],
                        "pid": _STEP_PID, "args": cache})
        # recovery-event track: only emitted once any resilience
        # counter has fired, so fault-free runs keep a clean trace
        resil = {k.split(".", 1)[1]: v for k, v in counters.items()
                 if k.startswith("resilience.")}
        if any(resil.values()):
            out.append({"name": "resilience", "ph": "C", "ts": r["ts_us"],
                        "pid": _STEP_PID, "args": resil})
    return out


def _compile_events(events):
    out = []
    for e in events:
        dur_us = e["compile_ms"] * 1e3
        args = {"key": e["key"]}
        for k in ("flops", "bytes_accessed", "trace_ms", "source"):
            if e.get(k) is not None:
                args[k] = e[k]
        if e.get("memory"):
            args.update(e["memory"])
        out.append({"name": "xla_compile", "ph": "X",
                    "ts": e["ts_us"] - dur_us, "dur": dur_us,
                    "pid": _STEP_PID, "tid": _COMPILE_TID,
                    "cat": "compile", "args": args})
        # live-bytes watermark: NOT rebuilt here from e["memory"] — the
        # compile ledger already feeds compile_ledger.live_bytes() into
        # the "compile.live_bytes" gauge at record time, and that
        # gauge's history IS the counter track (_gauge_events).  One
        # definition, one sample stream: the chrome track and the
        # gauge cannot drift.
        mem_prof = e.get("mem_profile")
        if mem_prof and mem_prof.get("timeline"):
            # live-bytes-over-PROGRAM timeline (mem_profile): the x
            # axis is program position, mapped 1 μs per point from the
            # compile's end so the curve sits next to its compile span
            for i, (_pos, b) in enumerate(mem_prof["timeline"]):
                out.append({"name": "hbm_live_bytes", "ph": "C",
                            "ts": e["ts_us"] + i, "pid": _STEP_PID,
                            "args": {"bytes": b}})
    return out


def request_trace_events(trace_trees):
    """Retained request span trees (monitor/tracing.py tree dicts) ->
    pid-2 tracks: one tid per trace, each span an X event at its tree
    depth's natural nesting, each annotation an instant event.  Span
    timestamps are already perf_counter ns, converted to the trace
    clock's μs here."""
    out = []
    for tid, tree in enumerate(trace_trees):
        name = "%s %s%s" % (
            tree.get("outcome", "?"), tree.get("trace_id", "")[:8],
            " VIOLATION" if tree.get("violation") else "")
        out.append({"name": "thread_name", "ph": "M",
                    "pid": _REQUEST_PID, "tid": tid,
                    "args": {"name": name}})
        for s in tree.get("spans", ()):
            if s.get("start_ns") is None or s.get("end_ns") is None:
                continue
            args = {"trace_id": tree.get("trace_id"),
                    "rid": tree.get("rid"),
                    "depth": s.get("depth", 0)}
            if s.get("category"):
                args["category"] = s["category"]
            if s.get("outcome"):
                args["outcome"] = s["outcome"]
            args.update(s.get("attrs") or {})
            out.append({"name": s["name"], "ph": "X",
                        "ts": s["start_ns"] / 1e3,
                        "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                        "pid": _REQUEST_PID, "tid": tid,
                        "cat": "request", "args": args})
            for ts_ns, text in (s.get("annotations") or ()):
                out.append({"name": text, "ph": "i", "ts": ts_ns / 1e3,
                            "pid": _REQUEST_PID, "tid": tid, "s": "t",
                            "cat": "request",
                            "args": {"span": s["name"]}})
    if out:
        out.insert(0, {"name": "process_name", "ph": "M",
                       "pid": _REQUEST_PID,
                       "args": {"name": "requests"}})
    return out


def merged_trace_events(host_events, step_records=None,
                        compile_events=None, gauge_series=None,
                        trace_trees=None):
    """The full merged event list: metadata + host spans + step spans +
    compile spans + counter tracks (sampled counters AND gauge
    time-series) + per-request serving trace tracks."""
    step_records = step_records or []
    compile_events = compile_events or []
    out = _metadata_events(host_events)
    out.extend(host_span_events(host_events))
    out.extend(_step_events(step_records))
    out.extend(_compile_events(compile_events))
    if gauge_series:
        out.extend(_gauge_events(gauge_series))
    if trace_trees:
        out.extend(request_trace_events(trace_trees))
    return out
