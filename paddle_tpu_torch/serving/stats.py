"""Serving observability: exact latency percentiles + outcome ledger
(port of paddle_tpu/serving/stats.py).

Every request that enters a ServingRuntime ends in EXACTLY one of the
outcome buckets below — completed, shed (deadline expired in queue),
expired (deadline passed in flight), rejected (backpressure at
enqueue), failed (classified dispatch error), stalled (watchdog
escalation), cancelled (runtime closed) — so `requests ==
sum(outcomes)` is an invariant the chaos smoke asserts: a serving
runtime that silently loses a request has failed at its one job.

Latency percentiles are EXACT nearest-rank over the recorded samples
(bounded ring, default 8192): `p(q) = sorted[ceil(q*n)-1]`.  No
histogram buckets, no interpolation — the smoke row recomputes p99
from the raw samples and asserts equality with the table's number.

WINDOW SEMANTICS: the sample rings are bounded (`deque(maxlen=8192)`),
so under long traffic the oldest samples fall out — percentiles are
exact over the NEWEST <= 8192 samples, a sliding window, not the full
run.  Evictions are counted (`samples_dropped` in the latency tables
and the serving record), so a reader can tell a complete distribution
from a windowed one instead of being silently lied to.  The outcome
LEDGER is never windowed — counts are cumulative forever.

Counters are double-booked like the flight recorder's: gate-free local
fields (the serving table must work with telemetry off) plus
`resilience.*`/`serving.*` monitor counters while telemetry is on.
"""

import collections
import math
import threading
import weakref

__all__ = ["ServingStats", "DecodeStats", "exact_percentile",
           "serving_table", "all_stats", "OUTCOMES"]

_SAMPLE_CAP = 8192

# live runtimes' stats, keyed by label — what monitor.serving_table()
# reads.  Weak values: a dropped runtime leaves the table (its final
# numbers persist in the telemetry JSONL / flight dump it emitted).
_REGISTRY = weakref.WeakValueDictionary()
_registry_lock = threading.Lock()


def exact_percentile(sorted_samples, q):
    """Nearest-rank percentile: the smallest recorded sample >= q of
    the distribution — an ACTUAL sample, never an interpolation, so
    re-deriving it from the raw samples is equality, not allclose."""
    n = len(sorted_samples)
    if not n:
        return None
    rank = max(1, math.ceil(q * n))
    return sorted_samples[min(n, rank) - 1]


def _mon():
    from .. import monitor

    return monitor


OUTCOMES = ("completed", "shed", "expired", "rejected", "failed",
            "stalled", "cancelled")


class ServingStats:
    """One runtime's gate-free outcome ledger + latency samples."""

    def __init__(self, label="serving", register=True):
        self.label = label
        self._lock = threading.Lock()
        self._outcomes = {k: 0 for k in OUTCOMES}
        self.requests = 0
        self.batches = 0
        self.padded_rows = 0
        self.dispatched_rows = 0
        self.degraded = 0
        self.retries = 0
        self.watchdog_stalls = 0
        self.cancel_retries = 0
        self._samples = collections.deque(maxlen=_SAMPLE_CAP)
        self.samples_dropped = 0      # ring evictions (window honesty)
        self._buckets = {}            # bucket size -> dispatch count
        self._breaker = None          # CircuitBreaker, set by runtime
        self._watchdog = None         # HangWatchdog, set by watchdog
        self.queue_depth = 0
        self.in_flight = 0
        if register:
            with _registry_lock:
                _REGISTRY[label] = self

    def attach_breaker(self, breaker):
        self._breaker = breaker

    def attach_watchdog(self, watchdog):
        """Back-link set by HangWatchdog so the summary (and /healthz)
        can see a CURRENTLY-wedged dispatch, not just the stall count
        it left behind."""
        self._watchdog = weakref.ref(watchdog)

    # -- recording ------------------------------------------------------
    def note_admitted(self, depth):
        with self._lock:
            self.requests += 1
            self.queue_depth = depth
        mon = _mon()
        if mon.is_enabled():
            mon.counter("serving.requests").add(1)
            mon.gauge("serving.queue_depth").set(depth)

    def note_queue_depth(self, depth):
        with self._lock:
            self.queue_depth = depth
        mon = _mon()
        if mon.is_enabled():
            mon.gauge("serving.queue_depth").set(depth)

    def note_in_flight(self, n):
        with self._lock:
            self.in_flight = n
        mon = _mon()
        if mon.is_enabled():
            mon.gauge("serving.in_flight").set(n)

    def note_outcome(self, outcome, latency_s=None):
        """Terminal state of one request.  `rejected` requests never
        counted as admitted, so they increment `requests` here — the
        invariant stays sum(outcomes) == requests."""
        with self._lock:
            self._outcomes[outcome] += 1
            if outcome == "rejected":
                self.requests += 1
            if latency_s is not None:
                if len(self._samples) == self._samples.maxlen:
                    self.samples_dropped += 1
                self._samples.append(float(latency_s))
        mon = _mon()
        if mon.is_enabled():
            name = {"completed": "serving.completed",
                    "shed": "resilience.serving_shed",
                    "expired": "resilience.serving_expired",
                    "rejected": "resilience.serving_rejected",
                    "failed": "resilience.serving_failed",
                    "stalled": "resilience.serving_stalled",
                    "cancelled": "resilience.serving_cancelled"}[outcome]
            mon.counter(name).add(1)

    def note_batch(self, bucket, rows, degraded=False):
        """One dispatched batch.  bucket=None means the dispatch went
        through a NON-bucketed path (the degraded eager interpreter):
        it counts as a batch but must not invent a bucket key in the
        bucket-mix observability."""
        with self._lock:
            self.batches += 1
            self.dispatched_rows += rows
            if bucket is not None:
                self.padded_rows += max(0, bucket - rows)
                self._buckets[bucket] = self._buckets.get(bucket, 0) + 1
            if degraded:
                self.degraded += 1
        mon = _mon()
        if mon.is_enabled():
            mon.counter("serving.batches").add(1)
            if bucket is not None:
                mon.counter(f"serving.bucket_{bucket}").add(1)
            if degraded:
                mon.counter("resilience.serving_degraded").add(1)

    def note_retry(self):
        with self._lock:
            self.retries += 1

    def note_watchdog_stall(self):
        with self._lock:
            self.watchdog_stalls += 1
        mon = _mon()
        if mon.is_enabled():
            mon.counter("resilience.watchdog_stalls").add(1)

    def note_cancel_retry(self):
        with self._lock:
            self.cancel_retries += 1
        mon = _mon()
        if mon.is_enabled():
            mon.counter("resilience.watchdog_cancel_retry").add(1)

    # -- reading --------------------------------------------------------
    def samples(self):
        with self._lock:
            return list(self._samples)

    def latency(self):
        """Exact latency stats over the recorded end-to-end samples —
        the newest <= maxlen window (see module docstring); the
        `samples_dropped` field counts what the window evicted."""
        with self._lock:
            dropped = self.samples_dropped
            s = sorted(self._samples)
        if not s:
            return None
        out = {
            "count": len(s),
            "mean_ms": round(sum(s) / len(s) * 1e3, 3),
            "p50_ms": round(exact_percentile(s, 0.50) * 1e3, 3),
            "p99_ms": round(exact_percentile(s, 0.99) * 1e3, 3),
            "max_ms": round(s[-1] * 1e3, 3),
        }
        if dropped:
            out["samples_dropped"] = dropped
        return out

    def summary(self):
        """json-safe serving-table row: outcomes, invariant check,
        latency percentiles, bucket mix, breaker + watchdog state."""
        with self._lock:
            outcomes = dict(self._outcomes)
            out = {
                "key": self.label,
                "requests": self.requests,
                "outcomes": outcomes,
                "resolved": sum(outcomes.values()),
                "pending": self.requests - sum(outcomes.values()),
                "batches": self.batches,
                "dispatched_rows": self.dispatched_rows,
                "padded_rows": self.padded_rows,
                "buckets": {str(k): v
                            for k, v in sorted(self._buckets.items())},
                "degraded_batches": self.degraded,
                "dispatch_retries": self.retries,
                "watchdog_stalls": self.watchdog_stalls,
                "cancel_retries": self.cancel_retries,
                "queue_depth": self.queue_depth,
                "in_flight": self.in_flight,
            }
        lat = self.latency()
        if lat:
            out["latency"] = lat
        if self._breaker is not None:
            out["breaker"] = self._breaker.summary()
        wd = self._watchdog() if self._watchdog is not None else None
        if wd is not None:
            out["stalled_in_flight"] = wd.stalled_now()
        return out

    def to_record(self):
        """The kind="serving" telemetry record — one line on the JSONL
        stream / flight dump, same shape the report tool parses."""
        rec = {"kind": "serving"}
        rec.update(self.summary())
        return rec


class DecodeStats(ServingStats):
    """The decode engine's ledger: everything ServingStats keeps (the
    outcome invariant, end-to-end latency samples, breaker/watchdog
    links) plus the token-level series continuous batching is judged
    by — tokens/s, time-to-first-token, inter-token latency, slot
    occupancy, prefill-vs-decode step split.

    TTFT and per-token latencies ride the SAME exact nearest-rank
    percentile machinery as request latency (bounded sample rings,
    `exact_percentile`) — no new estimator, so the smoke row can
    recompute any published percentile from the raw samples and assert
    equality."""

    def __init__(self, label="decode", slots=0, register=True):
        super().__init__(label, register=register)
        self.slots = int(slots)
        self.tokens_total = 0
        self.prefill_steps = 0
        self.decode_steps = 0
        self._occupancy_sum = 0.0      # sum of active/slots per step
        self._ttft = collections.deque(maxlen=_SAMPLE_CAP)
        self.ttft_dropped = 0
        self._tok_lat = collections.deque(maxlen=_SAMPLE_CAP)
        self.tok_lat_dropped = 0
        self._first_t = None           # first/last token wall-clock
        self._last_t = None            # (engine clock) for tokens/s

    # -- recording ------------------------------------------------------
    def note_prefill(self, ttft_s=None, now=None):
        """One prefill dispatch; ttft_s is the submitting request's
        enqueue->first-token latency."""
        with self._lock:
            self.prefill_steps += 1
            if ttft_s is not None:
                if len(self._ttft) == self._ttft.maxlen:
                    self.ttft_dropped += 1
                self._ttft.append(float(ttft_s))
            if now is not None:
                if self._first_t is None:
                    self._first_t = now
                self._last_t = now
        mon = _mon()
        if mon.is_enabled():
            mon.counter("serving.decode_prefills").add(1)

    def note_decode_step(self, active, emitted, now=None):
        """One decode-step dispatch: `active` slots were live going in,
        `emitted` tokens landed on live requests coming out."""
        with self._lock:
            self.decode_steps += 1
            self.tokens_total += int(emitted)
            if self.slots:
                self._occupancy_sum += active / self.slots
            if now is not None:
                if self._first_t is None:
                    self._first_t = now
                self._last_t = now
        mon = _mon()
        if mon.is_enabled():
            mon.counter("serving.decode_steps").add(1)
            mon.counter("serving.decode_tokens").add(int(emitted))
            if self.slots:
                mon.gauge("serving.decode_active_slots").set(active)

    def note_token_latency(self, latency_s):
        with self._lock:
            if len(self._tok_lat) == self._tok_lat.maxlen:
                self.tok_lat_dropped += 1
            self._tok_lat.append(float(latency_s))

    # -- reading --------------------------------------------------------
    def _percentiles(self, ring, dropped=0):
        s = sorted(ring)
        if not s:
            return None
        out = {
            "count": len(s),
            "mean_ms": round(sum(s) / len(s) * 1e3, 3),
            "p50_ms": round(exact_percentile(s, 0.50) * 1e3, 3),
            "p99_ms": round(exact_percentile(s, 0.99) * 1e3, 3),
            "max_ms": round(s[-1] * 1e3, 3),
        }
        if dropped:
            out["samples_dropped"] = dropped
        return out

    def ttft_samples(self):
        with self._lock:
            return list(self._ttft)

    def token_latency_samples(self):
        with self._lock:
            return list(self._tok_lat)

    def decode_summary(self):
        with self._lock:
            steps = self.decode_steps
            out = {
                "slots": self.slots,
                "tokens_total": self.tokens_total,
                "prefill_steps": self.prefill_steps,
                "decode_steps": steps,
                "slot_occupancy_mean": (
                    round(self._occupancy_sum / steps, 4) if steps
                    and self.slots else None),
            }
            span = (self._last_t - self._first_t
                    if self._first_t is not None
                    and self._last_t is not None else None)
            ttft_ring = list(self._ttft)
            ttft_dropped = self.ttft_dropped
            tok_ring = list(self._tok_lat)
            tok_dropped = self.tok_lat_dropped
        if span and span > 0:
            out["tokens_per_s"] = round(out["tokens_total"] / span, 2)
        ttft = self._percentiles(ttft_ring, dropped=ttft_dropped)
        if ttft:
            out["ttft"] = ttft
        tok = self._percentiles(tok_ring, dropped=tok_dropped)
        if tok:
            out["token_latency"] = tok
        return out

    def summary(self):
        out = super().summary()
        out["decode"] = self.decode_summary()
        return out


def all_stats():
    with _registry_lock:
        return dict(_REGISTRY)


def serving_table():
    """One summary row per live ServingRuntime (newest state, exact
    percentiles) — what monitor.serving_table() returns and
    snapshot()["serving"] embeds."""
    return [s.summary() for s in all_stats().values()]
