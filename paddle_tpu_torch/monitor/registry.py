"""Counters/gauges registry — the storage layer of the telemetry
subsystem (port of paddle_tpu/monitor/registry.py).

Parity role: the reference's profiler aggregates (Event tables in
platform/profiler.cc) and the monitor counters its DeviceTracer keeps;
here the registry is the single machine-readable home every layer
(executor dispatch, compile ledger, bench rows) reports into, so two
perf PRs can never disagree about what "cache hit rate" means.

Thread-safe: train_from_dataset's producer thread and the main thread
both bump counters; one registry-wide lock covers the tiny critical
sections (a dict lookup + float add — contention is not a concern at
per-step granularity).
"""

import collections
import threading
import time

__all__ = ["Counter", "Gauge", "MetricsRegistry"]

# per-gauge history depth: enough to draw a counter track over the
# recent past without ever growing with run length
_GAUGE_SAMPLES = 512


class Counter:
    """Monotone accumulator (events, bytes, cache hits)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name, lock):
        self.name = name
        self._value = 0
        self._lock = lock

    def add(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge:
    """Last-write-wins sample (examples/s, live bytes, dp width).

    Every `set` also lands in a bounded (ts_us, value) history — the
    time-series the merged chrome trace renders as a counter track
    (checkpoint wall-time, live-bytes watermarks...), timestamped on
    the profiler's perf_counter clock so the samples align with the
    host spans."""

    __slots__ = ("name", "_value", "_lock", "_samples")

    def __init__(self, name, lock):
        self.name = name
        self._value = None
        self._lock = lock
        self._samples = collections.deque(maxlen=_GAUGE_SAMPLES)

    def set(self, v):
        with self._lock:
            self._value = v
            self._samples.append((time.perf_counter_ns() / 1e3, v))

    @property
    def value(self):
        return self._value

    def samples(self):
        with self._lock:
            return list(self._samples)


class MetricsRegistry:
    """Named counters + gauges with a point-in-time snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}

    def counter(self, name):
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self._lock)
        return c

    def gauge(self, name):
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self._lock)
        return g

    def snapshot(self):
        """{"counters": {name: value}, "gauges": {name: value}} — plain
        scalars only, safe to json.dump."""
        with self._lock:
            return {
                "counters": {n: c._value for n, c in self._counters.items()},
                "gauges": {n: g._value for n, g in self._gauges.items()
                           if g._value is not None},
            }

    def gauge_series(self):
        """{name: [(ts_us, value), ...]} for every gauge with history —
        the input of the merged trace's gauge counter tracks."""
        with self._lock:
            gauges = list(self._gauges.values())
        out = {}
        for g in gauges:
            samples = g.samples()
            if samples:
                out[g.name] = samples
        return out

    def reset(self):
        """Zero every counter and clear every gauge IN PLACE — handles
        held by call sites (executor module-level counter refs) stay
        valid, mirroring the profiler's clear-in-place event lists."""
        with self._lock:
            for c in self._counters.values():
                c._value = 0
            for g in self._gauges.values():
                g._value = None
                g._samples.clear()
