"""ServingRuntime — the hardened request path over Predictor /
CompiledPredictor (port of paddle_tpu/serving/runtime.py).

A bare `Predictor.run` is a synchronous call: one slow dispatch stalls
every caller, overload queues without bound, and a hang produces no
forensics.  This runtime wraps the same engines in the four layers a
"serve heavy traffic" path needs:

1. **Dynamic micro-batching** (bucketing.py): concurrent requests
   coalesce into a small set of pre-warmed padded bucket shapes; no
   recompile storm, padding sliced off before results leave.
2. **Admission control**: a bounded queue with per-request deadlines —
   budget expired in queue => shed with a classified DeadlineExceeded;
   queue full => enqueue rejects with QueueFullError (backpressure).
   Overload degrades to bounded latency, never unbounded queueing.
3. **Circuit breaker + jittered retry** (resilience/breaker.py +
   retry.py): transients are retried with backoff; N consecutive
   classified failures open the breaker, which then fails fast and
   serves through the degraded path (smallest bucket or the eager
   interpreter) until a half-open probe heals it.
4. **Hang watchdog** (watchdog.py): any dispatch in flight past the
   stall threshold triggers a flight-recorder dump with the batch's
   metadata, then escalates per policy — fail the batch with a
   classified WatchdogStall, or abandon the wedged call and retry.

Every request ends in exactly one classified outcome (stats.py keeps
the ledger), latencies are exact-percentile, and with
FLAGS_request_tracing on every request carries a span tree
(monitor/tracing.py).

On the card each dispatch runs on a worker thread, as the reference's
does.  That thread enters `torch.no_grad` and pins the predictor's CUDA
device itself (both are per thread), and copies the outputs to the host
before it returns, so an error or a stall is charged to the batch that
caused it.  A stalled call cannot be cancelled: its thread is abandoned
and may still hold the card while `cancel_retry` re-dispatches; a late
result never resolves a future twice (ServingFuture is set once).  The
breaker's degraded mode runs the same interpreter on the same device.

Usage::

    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.serving import ServingRuntime
    rt = ServingRuntime(Predictor(model_dir), max_batch_size=8,
                        default_deadline_s=0.5)
    fut = rt.submit({"x": batch})          # non-blocking
    outs = fut.result()                    # or rt.run(feed) to block
    rt.close()
"""

import threading
import time
from collections import deque

import numpy as np

from .. import flags
from ..resilience import faultinject
from ..resilience.breaker import CircuitBreaker, CircuitOpenError
from ..resilience.retry import RetryPolicy, call_with_retry
from ..resilience.taxonomy import DeadlineExceeded
from .bucketing import BucketDispatcher, pick_bucket
from .stats import ServingStats
from .watchdog import (WAIT_POLL_S, DispatchWorker, HangWatchdog,
                       WatchdogStall)

__all__ = ["ServingConfig", "ServingRuntime", "ServingFuture",
           "QueueFullError", "ServingClosedError", "WatchdogStall",
           "DeadlineExceeded"]

_DEFAULT_RETRY = object()


class QueueFullError(RuntimeError):
    """Admission control rejected the request: the bounded queue is at
    depth.  This is BACKPRESSURE — the caller should shed or slow
    down; retrying immediately is exactly wrong, so the taxonomy
    classifies it fatal."""


class ServingClosedError(RuntimeError):
    """The runtime is closed (or closing); the request was not (or can
    no longer be) served."""


class ServingConfig:
    """Knobs for one runtime.  Flag-backed defaults so a fleet can
    retune without code changes; everything injectable for tests."""

    def __init__(self, max_batch_size=8, buckets=None,
                 max_queue_depth=None, default_deadline_s=None,
                 batch_window_s=0.002, retry_policy=_DEFAULT_RETRY,
                 breaker_threshold=5, breaker_cooldown_s=5.0,
                 watchdog_stall_s=None, watchdog_poll_s=None,
                 watchdog_policy="raise", degraded_mode="eager",
                 prewarm=True, label="serving", clock=time.monotonic):
        self.max_batch_size = int(max_batch_size)
        self.buckets = buckets
        self.max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None
            else flags.flag("serving_queue_depth"))
        if default_deadline_s is None:
            default_deadline_s = flags.flag("serving_deadline_s") or None
        self.default_deadline_s = default_deadline_s
        self.batch_window_s = float(batch_window_s)
        if retry_policy is _DEFAULT_RETRY:
            retry_policy = RetryPolicy(max_retries=2, base_delay=0.02,
                                       max_delay=0.5, seed=0)
        self.retry_policy = retry_policy          # None disables retry
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.watchdog_stall_s = float(
            watchdog_stall_s if watchdog_stall_s is not None
            else flags.flag("serving_watchdog_stall_s"))
        self.watchdog_poll_s = watchdog_poll_s
        if watchdog_policy not in ("raise", "cancel_retry"):
            raise ValueError("watchdog_policy must be 'raise' or "
                             "'cancel_retry'")
        self.watchdog_policy = watchdog_policy
        if degraded_mode not in ("eager", "smallest_bucket", "fail"):
            raise ValueError("degraded_mode must be 'eager', "
                             "'smallest_bucket' or 'fail'")
        self.degraded_mode = degraded_mode
        self.prewarm = bool(prewarm)
        self.label = label
        self.clock = clock


class ServingFuture:
    """Resolution handle for one submitted request: exactly one of
    result/exception, set once, visible to any thread."""

    __slots__ = ("_event", "_result", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error = None

    def _set_result(self, value):
        if self._event.is_set():
            return False
        self._result = value
        self._event.set()
        return True

    def _set_exception(self, exc):
        if self._event.is_set():
            return False
        self._error = exc
        self._event.set()
        return True

    def done(self):
        return self._event.is_set()

    def exception(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("serving request not resolved yet")
        return self._error

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("serving request not resolved yet")
        if self._error is not None:
            raise self._error
        return self._result


class _Request:
    __slots__ = ("prepared", "rows", "enqueue_t",
                 "deadline", "budget_s", "future", "rid", "trace",
                 "qspan")

    def __init__(self, prepared, rows, enqueue_t, deadline, budget_s,
                 rid, trace=None):
        self.prepared = prepared
        self.rows = rows
        self.enqueue_t = enqueue_t
        self.deadline = deadline
        self.budget_s = budget_s
        self.future = ServingFuture()
        self.rid = rid
        # request-scoped trace context (monitor/tracing.py); None when
        # FLAGS_request_tracing is off — every touch downstream guards
        # on that None, so the off path is one attribute read
        self.trace = trace
        self.qspan = None

    def expired(self, now):
        return self.deadline is not None and now >= self.deadline


def _fr():
    from ..monitor import flight_recorder

    return flight_recorder


def _tracing():
    from ..monitor import tracing

    return tracing


def _mon():
    from .. import monitor

    return monitor


class ServingRuntime:
    """See module docstring.  `auto_start=False` keeps the batcher
    thread off so tests drive batching deterministically through
    `process_once()`."""

    def __init__(self, predictor, config=None, auto_start=True, **kw):
        self.config = cfg = config or ServingConfig(**kw)
        if config is not None and kw:
            raise TypeError("pass either config= or keyword knobs, "
                            "not both")
        self.dispatcher = BucketDispatcher(
            predictor, buckets=cfg.buckets,
            max_batch=cfg.max_batch_size, label=cfg.label)
        self.stats = ServingStats(cfg.label)
        self.breaker = CircuitBreaker(
            failure_threshold=cfg.breaker_threshold,
            cooldown_s=cfg.breaker_cooldown_s, clock=cfg.clock,
            name=cfg.label)
        self.stats.attach_breaker(self.breaker)
        self.watchdog = HangWatchdog(
            cfg.watchdog_stall_s, poll_s=cfg.watchdog_poll_s,
            clock=cfg.clock, stats=self.stats, label=cfg.label,
            pre_dump=self._note_serving, on_poll=self.sweep_expired)
        self._worker = DispatchWorker(cfg.label)
        self._queue = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._batcher = None
        self._rid = 0
        # every admitted-but-unresolved request, queued OR in flight —
        # close() fails whatever is left here, so no future can stay
        # pending past shutdown even with the batcher wedged
        self._live = set()
        self.prewarmed = self.dispatcher.prewarm() if cfg.prewarm else 0
        # the predictor's load-time graph-optimizer report (conv+BN
        # folds, identity collapses — FLAGS_inference_fold), surfaced
        # on the runtime.  NOT re-recorded into the pass ledger: the
        # Predictor already emitted the kind="pass_pipeline" record at
        # load time, and a second key would double-count the same fold
        # work in telemetry_report's Passes section.
        self.fold_report = getattr(predictor, "_fold_report", None)
        if auto_start:
            self.start()

    # -- lifecycle ------------------------------------------------------
    def start(self):
        # live /metrics exporter: serving shares the same
        # session-entry hook training uses — a no-op unless
        # FLAGS_metrics_port says otherwise, never on the hot path
        from ..monitor import exporter

        exporter.ensure_started()
        self.watchdog.start()
        if self._batcher is None:
            self._batcher = threading.Thread(
                target=self._batcher_loop,
                name=f"{self.config.label}-batcher", daemon=True)
            self._batcher.start()

    def close(self, timeout=10.0):
        """Stop admission, drain what the deadline math still allows,
        fail the rest with ServingClosedError, emit the final
        kind="serving" telemetry record."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        t = self._batcher
        if t is not None:
            t.join(timeout=timeout)
        self.watchdog.stop()
        self._worker.abandon()
        # anything still unresolved — queued OR in flight behind a
        # wedged dispatch the join timed out on — fails classified,
        # never silently dropped.  Failing an in-flight request also
        # unblocks its waiter loop (it exits once every future is
        # done), so the wedged batcher thread winds down too.
        with self._cond:
            self._queue.clear()
            leftovers = list(self._live)
        for req in leftovers:
            self._resolve_error(
                req, ServingClosedError("serving runtime closed"),
                "cancelled")
        self._note_serving()
        self.emit_telemetry()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- admission ------------------------------------------------------
    def submit(self, feed, deadline_s=None, traceparent=None):
        """Enqueue one request; returns a ServingFuture.  Raises
        synchronously on validation errors (bad feed), backpressure
        (QueueFullError) and a closed runtime — admission failures are
        the CALLER's bug or the CALLER's signal to back off, so they
        never consume queue budget.

        `traceparent` is an optional W3C trace-context header from the
        external caller; with FLAGS_request_tracing on, the request's
        span tree joins that trace instead of starting a fresh one."""
        if self._closed:
            raise ServingClosedError("serving runtime closed")
        prepared, rows = self.dispatcher.prepare(feed)
        budget = deadline_s if deadline_s is not None \
            else self.config.default_deadline_s
        now = self.config.clock()
        # None when tracing is off: start_request is the only flag
        # probe on the submit path, and the dispatch path never probes
        trace = _tracing().get().start_request(
            f"serving.request/{self.config.label}",
            label=self.config.label, traceparent=traceparent,
            attrs={"rows": rows})
        with self._cond:
            if self._closed:
                if trace is not None:
                    trace.finish("cancelled")
                raise ServingClosedError("serving runtime closed")
            if len(self._queue) >= self.config.max_queue_depth:
                self.stats.note_outcome("rejected")
                if trace is not None:
                    trace.annotate(trace.root, "rejected: queue full",
                                   depth=len(self._queue))
                    trace.finish("rejected")
                _fr().note_event("serving_rejected",
                                 label=self.config.label,
                                 depth=len(self._queue))
                raise QueueFullError(
                    f"serving queue at max depth "
                    f"{self.config.max_queue_depth}; request rejected "
                    f"(backpressure — shed load or slow down)")
            self._rid += 1
            req = _Request(prepared, rows, now,
                           now + budget if budget else None, budget,
                           self._rid, trace=trace)
            if trace is not None:
                trace.rid = req.rid
                req.qspan = trace.child("queue", "queue")
            self._queue.append(req)
            self._live.add(req)
            # counted INSIDE the lock: a dispatch resolving this
            # request on another thread must never observe
            # sum(outcomes) > requests in a concurrent snapshot
            self.stats.note_admitted(len(self._queue))
            self._cond.notify()
        return req.future

    def run(self, feed, deadline_s=None, timeout=None,
            traceparent=None):
        """Blocking convenience: submit + result."""
        return self.submit(feed, deadline_s=deadline_s,
                           traceparent=traceparent).result(
            timeout=timeout)

    # -- batching -------------------------------------------------------
    def _batcher_loop(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(0.05)
                if self._closed and not self._queue:
                    return
            try:
                self.process_once()
            except Exception as e:  # noqa: BLE001 — must not die
                _fr().note_event("serving_batcher_error", severe=True,
                                 error=f"{type(e).__name__}: {e}"[:200])

    def _pop_batch_locked(self, now, batch, rows, shed):
        """Move queue head into `batch` while it fits the largest
        bucket, shedding expired requests as they surface."""
        while self._queue:
            r = self._queue[0]
            if r.expired(now):
                self._queue.popleft()
                shed.append(r)
                continue
            if rows + r.rows > self.dispatcher.max_rows:
                break
            self._queue.popleft()
            batch.append(r)
            rows += r.rows
        return rows

    def process_once(self):
        """Form and dispatch ONE batch (the batcher thread's body;
        callable directly in tests with auto_start=False).  Returns
        the number of requests resolved by this call."""
        cfg = self.config
        now = cfg.clock()
        batch, shed = [], []
        with self._cond:
            rows = self._pop_batch_locked(now, batch, 0, shed)
            # coalescing window: once ONE request is in hand, wait up
            # to batch_window_s for peers to share the dispatch —
            # bounded, so a lone request never waits long
            window_end = now + cfg.batch_window_s
            while (batch and cfg.batch_window_s > 0
                   and rows < self.dispatcher.max_rows
                   and not self._closed):
                remaining = window_end - cfg.clock()
                if remaining <= 0:
                    break
                if not self._queue:
                    self._cond.wait(remaining)
                if self._queue:
                    rows = self._pop_batch_locked(cfg.clock(), batch,
                                                  rows, shed)
                else:
                    break
            depth = len(self._queue)
        self.stats.note_queue_depth(depth)
        for r in shed:
            elapsed = cfg.clock() - r.enqueue_t
            self._resolve_error(
                r, DeadlineExceeded(
                    f"request deadline exceeded after "
                    f"{elapsed * 1e3:.1f}ms in queue "
                    f"(budget {r.budget_s * 1e3:.1f}ms); shed before "
                    f"dispatch", elapsed_s=elapsed,
                    budget_s=r.budget_s),
                "shed")
        if not batch:
            return len(shed)
        try:
            self._dispatch_batch(batch, rows)
        except Exception as e:  # noqa: BLE001
            # an unexpected error OUTSIDE the guarded dispatch (merge,
            # bucket math, a bug) must still resolve every popped
            # request classified — a request the runtime holds and
            # never answers is the one failure mode worse than any
            # other
            for r in batch:
                self._resolve_error(r, e, "failed")
            _fr().note_event("serving_batch_error", severe=True,
                             label=self.config.label,
                             error=f"{type(e).__name__}: {e}"[:200])
        return len(shed) + len(batch)

    def sweep_expired(self):
        """Shed every QUEUED request whose deadline has passed.  Runs
        on the watchdog's poll tick (and is callable directly), so
        budget expiry is enforced even while the batcher thread is
        wedged inside a stalled dispatch — bounded latency must not
        depend on the component most likely to be stuck."""
        now = self.config.clock()
        expired = []
        with self._cond:
            if not self._queue:
                return 0
            keep = deque()
            for r in self._queue:
                (expired if r.expired(now) else keep).append(r)
            if expired:
                self._queue = keep
        for r in expired:
            elapsed = now - r.enqueue_t
            self._resolve_error(
                r, DeadlineExceeded(
                    f"request deadline exceeded after "
                    f"{elapsed * 1e3:.1f}ms in queue (budget "
                    f"{r.budget_s * 1e3:.1f}ms); shed before dispatch",
                    elapsed_s=elapsed, budget_s=r.budget_s),
                "shed")
        if expired:
            self.stats.note_queue_depth(len(self._queue))
        return len(expired)

    # -- resolution helpers ---------------------------------------------
    def _resolve_ok(self, req, outs):
        if not req.future._set_result([np.asarray(o) for o in outs]):
            return False
        self._live.discard(req)
        now = self.config.clock()
        self.stats.note_outcome("completed",
                                latency_s=now - req.enqueue_t)
        self._finish_trace(req, "completed")
        return True

    def _resolve_error(self, req, exc, outcome):
        if not req.future._set_exception(exc):
            return False
        self._live.discard(req)
        self.stats.note_outcome(outcome)
        self._finish_trace(req, outcome)
        return True

    def _finish_trace(self, req, outcome):
        """Close the request's span tree with its ledger outcome.
        Called ONLY from the two _resolve_* terminal points (which are
        idempotent), so the trace-outcome multiset reconciles with the
        outcome ledger by construction."""
        if req.trace is not None:
            req.trace.finish(outcome)

    def _note_serving(self):
        fr = _fr()
        if fr.get().enabled:
            fr.get().note_serving(self.stats.to_record())

    def emit_telemetry(self):
        """Write the current kind="serving" record onto the telemetry
        JSONL stream (no-op while telemetry is off).  With request
        tracing on, the record carries the label's attribution/SLO
        summary."""
        rec = self.stats.to_record()
        store = _tracing().get()
        if store.enabled:
            s = store.summary(self.config.label)
            if s is not None:
                rec["tracing"] = s
        return _mon().record_serving(rec)

    # -- dispatch -------------------------------------------------------
    def _dispatch_batch(self, batch, rows):
        bucket = pick_bucket(self.dispatcher.buckets, rows)
        for r in batch:
            if r.trace is not None:
                r.trace.end(r.qspan)
                r.trace.annotate(r.trace.root, "batch_join",
                                 bucket=bucket, rows=rows,
                                 requests=len(batch))
        if not self.breaker.allow():
            self._degraded_serve(batch)
            return
        merged, slices = self.dispatcher.merge(
            [r.prepared for r in batch], bucket)
        meta = {"bucket": bucket, "rows": rows,
                "requests": len(batch),
                "request_ids": [r.rid for r in batch]}
        tids = [r.trace.trace_id for r in batch if r.trace is not None]
        if tids:
            # carried in the watchdog meta: a stall escalation's
            # flight dump names the wedged requests' traces
            meta["trace_ids"] = tids
        outcome = self._dispatch_guarded(merged, bucket, batch, slices,
                                         meta, final_attempt=False)
        if outcome == "cancel_retry":
            # abandon the wedged call (it cannot be cancelled, only
            # stopped being waited for) and give the SAME batch one
            # fresh dispatch; a second stall fails classified
            self.stats.note_cancel_retry()
            _fr().note_event("serving_cancel_retry",
                             label=self.config.label, **meta)
            live = [r for r in batch if not r.future.done()]
            if not live:
                self.breaker.release_probe()
                return
            merged, slices = self.dispatcher.merge(
                [r.prepared for r in live], bucket)
            outcome = self._dispatch_guarded(merged, bucket, live,
                                             slices, meta,
                                             final_attempt=True)
        if outcome == "abandoned":
            # no verdict reached the breaker (every waiter expired
            # mid-flight): a consumed half-open probe token must not
            # wedge the breaker — hand it back
            self.breaker.release_probe()

    def _dispatch_guarded(self, merged, bucket, batch, slices, meta,
                          final_attempt):
        """One watched dispatch attempt: retry envelope inside, breaker
        accounting + deadline enforcement + watchdog escalation
        outside.  Returns "ok" | "failed" | "stalled" | "cancel_retry"
        | "abandoned"."""
        cfg = self.config
        token, stalled = self.watchdog.track(meta)
        # per-request dispatch-attempt spans (None-trace requests pay
        # one attribute read and are skipped — the gate-free contract)
        attempt = 2 if final_attempt else 1
        tspans = [(r, r.trace.child(f"dispatch/b{bucket}", "dispatch",
                                    attrs={"bucket": bucket,
                                           "attempt": attempt}))
                  for r in batch if r.trace is not None]
        rspans = {}

        def _close_attempt(outcome, category=None):
            for r, ds in tspans:
                sp = rspans.pop(r, None)
                if sp is not None:
                    r.trace.end(sp)
                if ds is not None:
                    if category is not None:
                        r.trace.recategorize(ds, category)
                    r.trace.end(ds, outcome=outcome)

        def _note_retry(*_a):
            self.stats.note_retry()
            # the remainder of this attempt (backoff + re-dispatch) is
            # retry-caused latency: charge it to "retry", one level
            # under the dispatch span
            for r, ds in tspans:
                if ds is None:
                    continue
                prev = rspans.pop(r, None)
                if prev is not None:
                    r.trace.end(prev)
                sp = r.trace.child("retry", "retry", parent=ds)
                if sp is not None:
                    rspans[r] = sp

        def call():
            feeds = faultinject.on_step_feed(merged) \
                if faultinject.is_armed() else merged

            def _dispatch():
                if faultinject.is_armed():
                    faultinject.check_transient()
                    faultinject.stall_point("serving.dispatch")
                return self.dispatcher.dispatch(feeds, bucket)

            if cfg.retry_policy is not None:
                return call_with_retry(_dispatch, cfg.retry_policy,
                                       on_retry=_note_retry)
            return _dispatch()

        done, box = self._worker.submit(call)
        try:
            while not done.wait(timeout=WAIT_POLL_S):
                now = cfg.clock()
                for r in batch:
                    if not r.future.done() and r.expired(now):
                        elapsed = now - r.enqueue_t
                        self._resolve_error(
                            r, DeadlineExceeded(
                                f"request deadline exceeded after "
                                f"{elapsed * 1e3:.1f}ms (budget "
                                f"{r.budget_s * 1e3:.1f}ms) with the "
                                f"dispatch still in flight",
                                elapsed_s=elapsed,
                                budget_s=r.budget_s),
                            "expired")
                if all(r.future.done() for r in batch):
                    # nobody is waiting for this result anymore: leave
                    # the call to finish on its own thread
                    self._worker.abandon()
                    _close_attempt("abandoned")
                    return "abandoned"
                if stalled.is_set():
                    if cfg.watchdog_policy == "cancel_retry" \
                            and not final_attempt:
                        # the wedged attempt's wall time is STALL, not
                        # dispatch — the fresh attempt gets its own
                        # span on the SAME trace; the fresh attempt runs
                        # on a fresh worker thread
                        self._worker.abandon()
                        _close_attempt("cancel_retry", category="stall")
                        return "cancel_retry"
                    stall = WatchdogStall(
                        f"serving dispatch watchdog stall: batch "
                        f"(bucket {bucket}, {meta['rows']} rows) in "
                        f"flight > {cfg.watchdog_stall_s}s")
                    self.breaker.note_failure(stall)
                    self._worker.abandon()
                    _close_attempt("stalled", category="stall")
                    for r in batch:
                        self._resolve_error(r, stall, "stalled")
                    return "stalled"
        finally:
            self.watchdog.untrack(token)
        if "error" in box:
            e = box["error"]
            self.breaker.note_failure(e)
            self._note_serving()
            _fr().note_event(
                "serving_dispatch_failed", label=cfg.label,
                error=f"{type(e).__name__}: {e}"[:200], **{
                    k: v for k, v in meta.items()
                    if k not in ("request_ids", "trace_ids")})
            _close_attempt("failed")
            for r in batch:
                self._resolve_error(r, e, "failed")
            return "failed"
        self.breaker.note_success()
        self.stats.note_batch(bucket, meta["rows"])
        _close_attempt("ok")
        for r, outs in zip(batch, self.dispatcher.split(box["out"],
                                                        slices)):
            self._resolve_ok(r, outs)
        return "ok"

    # -- degraded mode --------------------------------------------------
    def _degraded_serve(self, batch):
        """Breaker-open path: serve each request individually through
        the configured fallback — the eager interpreter (shares nothing
        with the compiled path) or the smallest fitting bucket — or
        fail fast when degraded_mode='fail'.  Deadlines still hold."""
        cfg = self.config
        mode = cfg.degraded_mode
        if mode == "eager" and not self.dispatcher.eager_available:
            mode = "smallest_bucket"
        for req in batch:
            if req.future.done():
                continue
            if req.trace is not None:
                req.trace.annotate(req.trace.root, "breaker_open",
                                   mode=mode)
            now = cfg.clock()
            if req.expired(now):
                elapsed = now - req.enqueue_t
                self._resolve_error(
                    req, DeadlineExceeded(
                        f"request deadline exceeded after "
                        f"{elapsed * 1e3:.1f}ms (breaker open)",
                        elapsed_s=elapsed, budget_s=req.budget_s),
                    "shed")
                continue
            if mode == "fail":
                self._resolve_error(
                    req, CircuitOpenError(
                        f"serving circuit breaker open after "
                        f"{self.breaker.failure_threshold} consecutive "
                        f"failures; degraded_mode='fail' — failing "
                        f"fast"),
                    "failed")
                continue
            dspan = req.trace.child(f"degraded/{mode}", "degraded") \
                if req.trace is not None else None
            try:
                if mode == "eager":
                    outs = self.dispatcher.dispatch_eager(req.prepared)
                    self.stats.note_batch(None, req.rows,
                                          degraded=True)
                else:
                    bucket = pick_bucket(self.dispatcher.buckets,
                                         req.rows)
                    merged, slices = self.dispatcher.merge(
                        [req.prepared], bucket)
                    outs = self.dispatcher.split(
                        self.dispatcher.dispatch(merged, bucket),
                        slices)[0]
                    self.stats.note_batch(bucket, req.rows,
                                          degraded=True)
                if dspan is not None:
                    req.trace.end(dspan, outcome="ok")
                self._resolve_ok(req, outs)
            except Exception as e:  # noqa: BLE001
                if dspan is not None:
                    req.trace.end(dspan, outcome="failed")
                self._resolve_error(req, e, "failed")

    # -- reading --------------------------------------------------------
    def summary(self):
        return self.stats.summary()
